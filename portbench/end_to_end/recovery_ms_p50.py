"""Median over the window's camera dropouts of the time to re-anchor:
from the hand-in of the first lit frame after the dropout to the return
of the call after which the first pose after it can be read (the system
has recorded it in its trajectory). A median, not a 95th percentile: a
window holds a dozen dropouts, whose 95th percentile is their maximum."""

import statistics


def read(ctx):
    return statistics.median(ctx.recovery_s) * 1e3 if ctx.recovery_s else None
