"""Device ms per tracked frame in the four hand kernels K1-K4: their
kernels by name in the profiler trace, over the frames handed in while
the trace ran (the window's last seconds)."""

KERNELS = ("pose_solve_kernel", "hamming_kernel", "fast_nms_kernel")


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.trace_frames == 0:
        return None
    total = sum(s for name, (n, s) in tr["kernels"].items() if any(k in name for k in KERNELS))
    return 1e3 * total / ctx.trace_frames if total > 0 else None
