"""K4's (`csrc/fast_nms.cu`) share of its roofline (%): its least time,
the bytes of its stacked stereo atlas read once and its scores written
once at the card's HBM rate (`peaks.fast_nms_bound_s`), times its
launches in the trace, over its device time there."""

from portbench import peaks


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    n, s = 0, 0.0
    for name, (cnt, sec) in tr["kernels"].items():
        if "fast_nms_kernel" in name:
            n, s = n + cnt, s + sec
    if n == 0 or s <= 0:
        return None
    return 100.0 * n * peaks.fast_nms_bound_s(ctx.config) / s
