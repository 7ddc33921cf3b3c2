"""Plain PyTorch reference of the benchmark's cells.

It rebuilds everything from the seeded sensor coordinates and signals:
the eq. 1 weights and the Laplacian (``graph``), the lambda-max rule, the
SGWT bank and its eq. 8 coefficients, the eq. 9/11 recurrence and its
adjoint (``cheb``), and FISTA (``fista``). It runs in float64, or, as the
control, in float32 with every Laplacian product rounded to TF32. It
imports nothing of the program.
"""
