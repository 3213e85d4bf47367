"""Seconds from the harness's start to the window's: imports, the card's
initialisation, the kernels' build or load, the inputs made from the seed,
the map, the system, the program's prewarm and the warm-up frames."""


def read(ctx):
    return ctx.setup_s
