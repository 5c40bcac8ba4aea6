"""`roofline.codec_residual_units` in the video cell, where it moves audio_s_per_s.video."""

from portbench.harness.registry import metric_reader

read = metric_reader("roofline.codec_residual_units")
