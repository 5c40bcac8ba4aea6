"""The model step's share of the chip's bf16 peak: the model operations of
the traced groups (codec encode, T5, the vision tower, 32 DiT evaluations,
two codec decodes; portbench/harness/flops.py) over the traced window's
seconds times 989 TFLOP/s."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * ctx["group_flops"] / (tr.window_s * ctx["flops"].PEAK_BF16)
