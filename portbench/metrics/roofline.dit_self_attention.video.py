"""`roofline.dit_self_attention` in the video cell, where it moves audio_s_per_s.video."""

from portbench.harness.registry import metric_reader

read = metric_reader("roofline.dit_self_attention")
