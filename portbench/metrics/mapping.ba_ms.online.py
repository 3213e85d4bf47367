"""Host ms per local BA solve on the mapper thread (the program's
`loc/ba` timer over the window). Online configurations only."""


def read(ctx):
    if not ctx.online:
        return None
    n, total = ctx.timers.get("loc/ba", (0, 0.0))
    return 1e3 * total / n if n else None
