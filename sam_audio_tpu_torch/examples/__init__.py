"""Walkthroughs of the port's API, one module each, run as

    python -m sam_audio_tpu_torch.examples.span_prompting [--device cpu]
    python -m sam_audio_tpu_torch.examples.visual_prompting [--device cpu]
    python -m sam_audio_tpu_torch.examples.train_flow_matching [--device cpu]

on the card by default. Without --model each builds a small model with
random weights and synthetic audio, so that it runs in seconds."""
