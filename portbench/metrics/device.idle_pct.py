"""Share (%) of the traced window in which no operation ran on the card,
on any stream: one minus the union of the device intervals (the
tracker's and the mapper's streams together) over the window."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
