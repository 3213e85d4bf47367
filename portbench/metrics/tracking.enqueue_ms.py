"""Host ms per tracked frame that the chained track step takes to build
and enqueue its work: the program's timers `track/chain_prep`,
`track/chain_enqueue`, `track/fused_prep` and `track/fused_enqueue` over
the window, per frame tracked in the window."""

TAGS = ("track/chain_prep", "track/chain_enqueue", "track/fused_prep", "track/fused_enqueue")


def read(ctx):
    total = sum(ctx.timers.get(t, (0, 0.0))[1] for t in TAGS)
    if ctx.frames == 0 or not any(t in ctx.timers for t in TAGS):
        return None
    return 1e3 * total / ctx.frames
