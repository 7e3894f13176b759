"""Set-up: process start to the first timed step or batch (host clock)."""


def read(ctx):
    return ctx["setup_s"]
