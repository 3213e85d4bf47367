"""95th percentile (nearest rank) over the window's tracked frames of the
time from the frame's hand-in to the entry (`ImageFrontend.dispatch`, or
`GMMLocSystem.step` for feature frames) to the return of the call after
which its tracked pose can be read on the host."""

from portbench import arith


def read(ctx):
    return arith.percentile(ctx.latency_s, 95) * 1e3 if ctx.latency_s else None
