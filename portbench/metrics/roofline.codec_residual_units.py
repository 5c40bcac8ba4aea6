"""The codec residual units' share of their roofline: the least time of
every unit of the traced groups (one encode and two decodes a row; the k7
and 1x1 convolutions at 989 TFLOP/s, or activations, weights, biases and
alphas at 3.35 TB/s, whichever is longer, unit by unit) over the device
time of the kernels that do them, matched by name."""

KERNELS = ("res_unit",)


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    device_s = tr.device_seconds(KERNELS)
    if device_s <= 0:
        return None
    f = ctx["flops"]
    return 100.0 * ctx["groups"] * f.residual_unit_bound_s(ctx["cfg"], ctx["group_shape"]) / device_s
