"""Host ms per frame in which the front end's thread was charged no CPU
inside `ImageFrontend.dispatch` and `complete`: the program's
`frontend/dispatch:offcpu` and `frontend/complete:offcpu` totals over
the window, each over its span's count. Uncharged time is GIL wait,
blocking and preemption, and on a host that charges no CPU for the
system calls it traps (a gVisor sandbox) also the work of the CUDA
launches: an upper bound on the GIL wait, not a reading of it."""

TAGS = ("frontend/dispatch", "frontend/complete")


def read(ctx):
    if not all(ctx.timers.get(t, (0, 0.0))[0] and t + ":offcpu" in ctx.timers for t in TAGS):
        return None
    return 1e3 * sum(ctx.timers[t + ":offcpu"][1] / ctx.timers[t][0] for t in TAGS)
