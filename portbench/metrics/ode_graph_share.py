"""The share of the traced groups' DiT evaluations that a CUDA graph
replay served: the program's `sam_audio.dit_graph` spans (one a replay,
models/dit_graph.py) in the traced window (portbench/harness/spans.py)
over the groups' evaluations (`evals`, portbench/harness/flops.py). None
where the program opens no such span."""

from portbench.harness import spans


def read(ctx):
    sp = spans.reduce(ctx)
    if sp is None:
        return None
    replays = sum(s.name == "dit_graph" for s in sp.spans)
    evals = sum(g.evals for g in ctx["run"].groups)
    if not replays or not evals:
        return None
    return replays / evals
