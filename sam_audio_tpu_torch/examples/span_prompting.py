"""Span prompting walkthrough (the script form of the reference's
examples/span_prompting.ipynb; the JAX package's examples/span_prompting.py).

The three prompting modes on a synthetic mixture:
  1. text only,
  2. explicit temporal anchors ("+" spans marking where the target sounds),
  3. predicted spans (predict_spans=True with a span predictor attached).

Run: python -m sam_audio_tpu_torch.examples.span_prompting [--model <snapshot>]
[--device cpu] [--out DIR]. Without --model a small model with random
weights shows the API.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from sam_audio_tpu_torch import SAMAudio, SAMAudioProcessor
from sam_audio_tpu_torch.audio_io import write_wav


def make_demo_model(device):
    from sam_audio_tpu_torch.config import DACVAEConfig, SAMAudioConfig, TransformerConfig
    from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer

    on_card = torch.device(device).type == "cuda"
    cfg = SAMAudioConfig(
        # 128-wide heads: the DiT's attention takes the fused kernel on the card
        transformer=TransformerConfig(dim=256, n_heads=2, n_layers=2, dropout=0.0,
                                      context_dim=256, out_channels=256),
        # the 48 kHz / hop-1920 codec's layout with narrow layers, so that the
        # demo runs in seconds (a real snapshot has the full DAC-VAE): on the
        # card the narrowest widths its residual-unit kernel takes (multiples
        # of 32), on the CPU the JAX example's
        audio_codec=(DACVAEConfig(encoder_dim=32, decoder_dim=512) if on_card
                     else DACVAEConfig(encoder_dim=8, decoder_dim=64)),
        span_predictor=None,
        # bf16 on the card; PyTorch's CPU kernels are faster in fp32
        compute_dtype="bfloat16" if on_card else "float32",
    )
    return SAMAudio.init_random(cfg, seed=0, device=device, tokenizer=ByteFallbackTokenizer())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=None, help="snapshot dir; default: a random demo model")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--out", default="sam_audio_demo")
    args = ap.parse_args(argv)

    if args.model:
        model = SAMAudio.from_pretrained(args.model, device=args.device)
        processor = SAMAudioProcessor.from_pretrained(args.model)
    else:
        model = make_demo_model(args.device)
        processor = SAMAudioProcessor(audio_hop_length=model.hop_length,
                                      audio_sampling_rate=model.sample_rate)

    # a synthetic mixture: a 440 Hz tone during [1, 2] s over noise
    sr = model.sample_rate
    t = np.arange(3 * sr) / sr
    tone = 0.4 * np.sin(2 * np.pi * 440 * t) * ((t >= 1.0) & (t < 2.0))
    mix = (tone + 0.05 * np.random.RandomState(0).randn(t.size)).astype(np.float32)
    os.makedirs(args.out, exist_ok=True)
    write_wav(f"{args.out}/mixture.wav", mix, sr)

    def seed():
        return torch.Generator(device=model.device).manual_seed(1)

    # 1. text only
    batch = processor(descriptions=["a steady tone"], audios=[mix[None]]).to(model.device)
    result = model.separate(batch, generator=seed())
    write_wav(f"{args.out}/target_text.wav", result.target[0], sr)
    write_wav(f"{args.out}/residual_text.wav", result.residual[0], sr)
    print("text-only:", result.target[0].shape)

    # 2. explicit span anchors: "+" marks where the target occurs
    batch = processor(descriptions=["a steady tone"], audios=[mix[None]],
                      anchors=[[("+", 1.0, 2.0)]])
    result = model.separate(batch, generator=seed())
    write_wav(f"{args.out}/target_span.wav", result.target[0], sr)
    print("span-prompted:", result.target[0].shape)

    # 3. predicted spans (a span predictor; random here, for the API's shape)
    if model.span_predictor is None:
        from sam_audio_tpu_torch.models.span_predictor import SpanPredictor, SpanPredictorConfig

        model.span_predictor = SpanPredictor.init_random(
            SpanPredictorConfig(audio_dim=model.cfg.audio_codec.codebook_dim,
                                text_dim=model.cfg.text_encoder.dim, hidden=128, n_layers=2,
                                n_heads=4),
            seed=2, device=model.device)
    batch = processor(descriptions=["a steady tone"], audios=[mix[None]])
    result = model.separate(batch, predict_spans=True, generator=seed())
    print("predicted spans:", batch.anchors)
    write_wav(f"{args.out}/target_predicted.wav", result.target[0], sr)
    print(f"outputs in {args.out}/")


if __name__ == "__main__":
    main()
