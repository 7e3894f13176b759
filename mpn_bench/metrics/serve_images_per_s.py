"""Frames whose person lists reached the client in the window, over the
window's seconds (host clock; the window ends when its last batch is back)."""


def read(ctx):
    return ctx["images"] / ctx["window_s"]
