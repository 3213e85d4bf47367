"""Host ms per call of `GMMLocSystem.step` (the harness's span around
each call), mean over the window's calls."""


def read(ctx):
    spans = ctx.spans.get("step") or []
    return 1e3 * sum(spans) / len(spans) if spans else None
