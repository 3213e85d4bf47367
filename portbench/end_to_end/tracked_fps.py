"""Frames tracked per second: the frames handed in during the window and
tracked, over the window's seconds (from the first hand-in to the return
of the flush that finishes the last)."""


def read(ctx):
    return ctx.frames / ctx.window_s
