"""Host ms per relocalization: the program's `reloc/relocalize` span (the
BoW query, then per candidate keyframe the K3 matching, the K1 pose solve
and the prior map's check; the calls read their results back, so the
host clock holds their device work) over its count in the window."""


def read(ctx):
    n, total = ctx.timers.get("reloc/relocalize", (0, 0.0))
    return 1e3 * total / n if n else None
