"""Share (%) of the window's completed frames whose pose solve kept GMM
anchors (`tracker.dbg["n_anchors"] > 0`, read after each step as the
port's `_AnchorLog` reads it)."""


def read(ctx):
    a = ctx.anchors
    return 100.0 * sum(1 for n in a if n > 0) / len(a) if a else None
