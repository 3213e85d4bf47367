"""Host ms per call of `GMMLocSystem.step` outside the spans opened inside
it (dispatch, drain, flush's drains): the program's `system/step:self`
total over `system/step`'s count in the window."""


def read(ctx):
    n = ctx.timers.get("system/step", (0, 0.0))[0]
    if not n or "system/step:self" not in ctx.timers:
        return None
    return 1e3 * ctx.timers["system/step:self"][1] / n
