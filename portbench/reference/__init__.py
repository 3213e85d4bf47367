"""The benchmark's plain reference: frozen copies of the port's plain
PyTorch versions of the stages the checks recompute (the ORB front end,
the pose solves, the local BA, the Hamming matrix), run on the CPU.

Imports nothing of the program: every module here imports only torch,
numpy and each other. The stages take the program's inputs to them (the
images; a solve's problem) and work out the rest again, in float32 for
the front end and in float64 for the solvers.
"""
