"""Images of the train steps run in the window, over the window's seconds
(host clock; the window ends on a synchronise)."""


def read(ctx):
    return ctx["images"] / ctx["window_s"]
