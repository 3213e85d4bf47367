"""Host ms per call of `GMMLocSystem.step`, timed inside the call: the
program's `system/step` span over the window, its total over its count
(the harness's `system.step_ms` times the same calls from outside)."""


def read(ctx):
    n, total = ctx.timers.get("system/step", (0, 0.0))
    return 1e3 * total / n if n else None
