"""The DiT self-attention's share of its roofline: the least time its work
could take on the chip (norm, RoPE and attention at the cell's (B, T, 16,
128) for every layer of every evaluation of the traced groups: operations
at 989 TFLOP/s or bytes at 3.35 TB/s, whichever is longer) over the device
time of the kernels that do it, matched by name."""

KERNELS = ("fused_glue_attention", "flash_attention")


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    device_s = tr.device_seconds(KERNELS)
    if device_s <= 0:
        return None
    f = ctx["flops"]
    ops, nbytes = f.self_attention_work(ctx["cfg"], ctx["group_shape"])
    return 100.0 * ctx["groups"] * f.bound_s(ops, nbytes) / device_s
