"""One reader per end-to-end metric, in a file named after the metric:
`read(ctx)` takes the run's readings (`run.Readings`) and returns the
metric's value. The harness takes these numbers itself, on the host's
clock."""
