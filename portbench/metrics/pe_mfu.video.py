"""The PE-Core tower's share of the chip's bf16 peak: rows x video frames x
one frame's operations (portbench/harness/flops.py) of the traced groups
over the summed device intervals of the program's `sam_audio.pe_encode`
spans (portbench/harness/spans.py) times 989 TFLOP/s."""

from portbench.harness import spans


def read(ctx):
    f = ctx["flops"]
    work = sum(g.rows * g.video_frames * f.pe_frame_flops(ctx["cfg"])
               for g in ctx["run"].groups)
    return spans.stage_mfu(ctx, "pe_encode", work)
