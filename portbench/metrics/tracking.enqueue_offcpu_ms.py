"""Host ms per tracked frame in which the chained track step's thread was
charged no CPU while it built and enqueued its work: the `:offcpu`
totals of the program's `track/chain_prep`, `track/chain_enqueue`,
`track/fused_prep` and `track/fused_enqueue` spans over the window, per
frame tracked in the window (`tracking.enqueue_ms` is their wall time).
Uncharged time is GIL wait, blocking and preemption, and on a host that
charges no CPU for the system calls it traps (a gVisor sandbox) also the
work of the CUDA launches: an upper bound on the GIL wait, not a
reading of it."""

TAGS = tuple(t + ":offcpu" for t in ("track/chain_prep", "track/chain_enqueue",
                                     "track/fused_prep", "track/fused_enqueue"))


def read(ctx):
    if ctx.frames == 0 or not any(t in ctx.timers for t in TAGS):
        return None
    return 1e3 * sum(ctx.timers.get(t, (0, 0.0))[1] for t in TAGS) / ctx.frames
