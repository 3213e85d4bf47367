"""RMSE (cm) of the camera centres of every tracked frame of the run (the
system's exported trajectory after it stopped) against the ground truth,
after the upstream protocol's alignment (Umeyama with scale)."""


def read(ctx):
    return ctx.ate_rmse_m * 100.0 if ctx.ate_rmse_m is not None else None
