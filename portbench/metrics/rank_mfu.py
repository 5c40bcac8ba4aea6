"""The ranker's share of the chip's bf16 peak: the ranker's operations on
the traced groups (as its kind counts them, portbench/harness/flops.py
`rank_flops`; CLAP: every candidate's HTSAT embedding and each item's
RoBERTa prompt) over the summed device intervals of the program's
`sam_audio.rank` spans (portbench/harness/spans.py) times 989 TFLOP/s.
None where no ranker scored a group."""

from portbench.harness import spans


def read(ctx):
    f = ctx["flops"]
    work = sum(f.rank_flops(ctx["cfg"], g) for g in ctx["run"].groups)
    return spans.stage_mfu(ctx, "rank", work)
