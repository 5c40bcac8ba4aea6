"""CUDA kernels a group: the device trace's kernels (copies and fills left
out) in the traced window, over its groups."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["groups"]:
        return None
    w0, w1 = tr.window
    return len([k for k in tr.kernels() if w0 <= k.start < w1]) / ctx["groups"]
