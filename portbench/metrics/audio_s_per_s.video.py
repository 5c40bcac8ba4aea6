"""`audio_s_per_s` in the video cell, kept as a metric of its own: the
cell's host-side frame copies make its runs spread far wider than the
other cells', and its own bound keeps theirs tight."""

from portbench.harness.registry import metric_reader

read = metric_reader("audio_s_per_s")
