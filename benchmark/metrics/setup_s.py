"""setup_s: seconds from the process's start to the window's start:
imports, the inputs drawn from the seed, the program's preparation, the
kernels' build or load, and the warm-up of the cell's shapes."""


def read(ctx):
    return ctx.setup_s
