"""The ODE's share of the chip's bf16 peak: the DiT operations of the traced
groups (rows x evaluations x one evaluation's products,
portbench/harness/flops.py) over the summed device intervals of the
program's `sam_audio.ode` spans (first launch's start to last's end,
portbench/harness/spans.py) times 989 TFLOP/s."""

from portbench.harness import spans


def read(ctx):
    f = ctx["flops"]
    work = sum(g.rows * g.evals * f.dit_eval_flops(ctx["cfg"], g.frames, g.text)
               for g in ctx["run"].groups)
    return spans.stage_mfu(ctx, "ode", work)
