"""Host ms per frame in the ORB front end: the harness's span around
`ImageFrontend.dispatch` plus the one around `complete`, over the
window's frames."""


def read(ctx):
    spans = ctx.spans.get("frontend") or []
    return 1e3 * sum(spans) / len(spans) if spans else None
