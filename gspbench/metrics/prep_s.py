"""Graph prep seconds: the host clock around the program's graph build
(eq. 1 weights, Laplacian, lambda-max, coefficients) and
``prepare_backend``, ending in a synchronise."""


def read(ctx):
    return ctx.prep_s
