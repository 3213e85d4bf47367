"""Host ms per tracked frame spent mapping keyframes inline on the frame
path (association, triangulation, fusion, local BA): the program's
`system/map_keyframe` span total over the window, per frame tracked in
the window. Offline configurations only (online, the span only queues
the keyframe for the mapper thread)."""


def read(ctx):
    if ctx.online or ctx.frames == 0 or "system/map_keyframe" not in ctx.timers:
        return None
    return 1e3 * ctx.timers["system/map_keyframe"][1] / ctx.frames
