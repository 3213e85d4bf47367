"""Host ms per frame in the ORB front end, timed inside the calls: the
program's `frontend/dispatch` and `frontend/complete` spans over the
window, each one's total over its own count (the window completes one
pair more than it dispatches: the warm-up's last). The harness's
`frontend.ms_per_frame` times the same calls from outside."""

TAGS = ("frontend/dispatch", "frontend/complete")


def read(ctx):
    if not all(ctx.timers.get(t, (0, 0.0))[0] for t in TAGS):
        return None
    return 1e3 * sum(ctx.timers[t][1] / ctx.timers[t][0] for t in TAGS)
