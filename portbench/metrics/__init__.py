"""One reader per per-layer metric, in a file named after the metric.

`read(ctx)` takes the run's readings (`run.Readings`: the window's
frames, the harness's spans, the program's timer table over the window,
the anchors per frame, the device trace) and returns the metric's value,
or None when the run has nothing to read for it (the harness then leaves
the metric out of its line).
"""
