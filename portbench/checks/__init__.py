"""The comparisons that decide `correct`, one module per stage.

Each module captures a sample, drawn from the seed, of one stage's calls
in the measured window (`install`), and after the window recomputes them
with the plain reference (`portbench/reference`) and returns its numbers
(`numbers`), each with its limit in `LIMITS`. `numbers(..., control=name)`
puts the reference at a lower precision in the program's place: one of
the module's `CONTROLS`, which have to fail (the first is the one a
`--control` run uses; a stage of integers has none).
"""
