"""Set-up: process start to the end of the warm-up, the first unit of the
window's traffic next (loading, the scene and its BVH and tables, the first
launch's build of the kernels, the warm-up)."""


def read(ctx):
    return ctx.setup_s
