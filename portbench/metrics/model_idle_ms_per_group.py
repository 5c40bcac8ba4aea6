"""Device-idle milliseconds a group inside the model step: the traced
window's idle gaps that fall inside the program's `sam_audio.separate`
spans (uploads, launch gaps, waits for the copy back), by exact interval
overlap, over the traced groups (portbench/harness/spans.py)."""

from portbench.harness import spans


def read(ctx):
    return spans.idle_ms_per_group(ctx, "model")
