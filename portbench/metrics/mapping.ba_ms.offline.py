"""Host ms per local BA solve inline on the frame path (the program's
`loc/ba` timer over the window; the solve reads its LM results back, so
the host clock holds its device time). Offline configurations only."""


def read(ctx):
    if ctx.online:
        return None
    n, total = ctx.timers.get("loc/ba", (0, 0.0))
    return 1e3 * total / n if n else None
