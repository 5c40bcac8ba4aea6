"""From the process's start to the window's: imports, weights drawn on the
device, the request pool, the kernels' build or load, the warm-up calls."""


def read(ctx):
    return ctx["setup_s"]
