"""Device-idle milliseconds a group while the offline pipeline works on the
host: the traced window's idle gaps that fall inside the program's
`sam_audio.run` spans and outside its `sam_audio.separate` spans (host
decode, planning, the processor's batch, the copy of the answers), by exact
interval overlap, over the traced groups (portbench/harness/spans.py)."""

from portbench.harness import spans


def read(ctx):
    return spans.idle_ms_per_group(ctx, "pipeline")
