"""Share (%) of the window's front-end passes replayed from the program's
CUDA graph: the program's `frontend/replay` spans over its
`frontend/dispatch` spans. A program that records no `frontend/replay`
span has nothing to read."""


def read(ctx):
    n_dispatch = ctx.timers.get("frontend/dispatch", (0, 0.0))[0]
    n_replay = ctx.timers.get("frontend/replay", (0, 0.0))[0]
    if not n_dispatch or not n_replay:
        return None
    return 100.0 * n_replay / n_dispatch
