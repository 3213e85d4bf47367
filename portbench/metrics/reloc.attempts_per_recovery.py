"""Candidate keyframes tried per recovery: the count of the program's
`reloc/attempt` span over the window (on dark frames too, where every
attempt fails) over the relocalizations that re-anchored the system in
the window."""


def read(ctx):
    if not ctx.recoveries:
        return None
    return ctx.timers.get("reloc/attempt", (0, 0.0))[0] / ctx.recoveries
