"""Visual prompting walkthrough (the JAX package's examples/visual_prompting.py).

The masked-video prompt (reference README "visual prompt": point at the
sounding object by masking video frames) and visual reranking by ImageBind:
  1. per-frame masks over a synthetic video (mask == 0 KEEPS a pixel, the
     reference's convention, processor.mask_videos),
  2. separate with the masked video as the prompt (PE vision tower -> the
     gated AlignModalities fusion onto the audio tokens),
  3. k candidates reranked by their audio <-> video ImageBind similarity,
  4. visual_stride: every stride-th frame encoded, the features between
     them interpolated.

Run: python -m sam_audio_tpu_torch.examples.visual_prompting [--model <snapshot>]
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
    from sam_audio_tpu_torch.config import (
        DACVAEConfig, PerceptionEncoderConfig, SAMAudioConfig, TransformerConfig)
    from sam_audio_tpu_torch.models.pe_clip import PerceptionEncoder
    from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer

    on_card = torch.device(device).type == "cuda"
    cfg = SAMAudioConfig(
        transformer=TransformerConfig(dim=256, n_heads=2, n_layers=2, dropout=0.0,
                                      context_dim=256, out_channels=256),
        # a small vision tower, so that the demo runs in seconds; a real
        # snapshot uses PE-Core-L14-336
        vision_encoder=PerceptionEncoderConfig(dim=64, width=64, vit_layers=2, vit_heads=2,
                                               image_size=56, patch_size=14),
        # the 48 kHz / hop-1920 codec's layout with the JAX example's narrow
        # layers
        audio_codec=DACVAEConfig(encoder_dim=8, decoder_dim=64),
        span_predictor=None,
        # bf16 on the card; PyTorch's CPU kernels are faster in fp32
        compute_dtype="bfloat16" if on_card else "float32",
    )
    model = SAMAudio.init_random(cfg, seed=0, device=device, tokenizer=ByteFallbackTokenizer())
    # the PE-Core tower ships apart from checkpoint.pt; random here
    model.vision_encoder = PerceptionEncoder.init_random(cfg.vision_encoder, seed=1,
                                                         device=device)
    return model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=None, help="snapshot dir; default: a random demo model")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--out", default="sam_audio_visual_demo")
    args = ap.parse_args(argv)

    if args.model:
        model = SAMAudio.from_pretrained(args.model, device=args.device)
        processor = SAMAudioProcessor.from_pretrained(args.model)
    else:
        model = make_demo_model(args.device)
        processor = SAMAudioProcessor(audio_hop_length=model.hop_length,
                                      audio_sampling_rate=model.sample_rate)

    sr = model.sample_rate
    rng = np.random.RandomState(0)
    seconds = 2.0
    t = np.arange(int(seconds * sr)) / sr
    mix = (0.4 * np.sin(2 * np.pi * 440 * t)
           + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    os.makedirs(args.out, exist_ok=True)
    write_wav(f"{args.out}/mixture.wav", mix, sr)

    # a synthetic video, one frame a latent frame; the "sounding object" is
    # the left half of the image, so the mask KEEPS the left half (mask == 0)
    size = model.cfg.vision_encoder.image_size
    n_frames = max(int(seconds * sr) // model.hop_length, 1)
    video = rng.randint(0, 255, (n_frames, 3, size, size), np.uint8)
    mask = np.ones_like(video)
    mask[:, :, :, : size // 2] = 0
    masked = processor.mask_videos([video], [mask])

    def seed():
        return torch.Generator(device=model.device).manual_seed(1)

    # 1. the masked frames condition the separation
    batch = processor(descriptions=["the object on the left"], audios=[mix[None]],
                      masked_videos=masked)
    result = model.separate(batch, generator=seed())
    write_wav(f"{args.out}/target_visual.wav", result.target[0], sr)
    print("visual-prompted:", result.target[0].shape)

    # 2. k candidates scored by ImageBind's audio <-> video cosine similarity
    if model.visual_ranker is None:
        from sam_audio_tpu_torch.config import ImageBindRankerConfig
        from sam_audio_tpu_torch.models.imagebind import ImageBindConfig, ImageBindModel
        from sam_audio_tpu_torch.ranking.imagebind import ImageBindRanker

        demo_ib = ImageBindConfig(num_audio_clips=2, audio_hidden=64, audio_layers=2,
                                  audio_heads=2, image_size=56, image_patch=14,
                                  num_video_clips=2, vision_hidden=64, vision_layers=2,
                                  vision_heads=2, embed_dim=32)
        model.visual_ranker = ImageBindRanker(
            ImageBindRankerConfig(),
            model=ImageBindModel.init_random(demo_ib, seed=2, device=model.device))
    result = model.separate(batch, reranking_candidates=2, generator=seed())
    write_wav(f"{args.out}/target_reranked.wav", result.target[0], sr)
    print("visually reranked best-of-2:", result.target[0].shape)

    # 3. opt-in fast modes (not the reference's semantics; they stack):
    #    visual_stride=8 encodes every 8th frame and interpolates the
    #    features; model.quantize(8) also quantizes the PE tower; preview_nfe
    #    ranks on cheap solves
    result = model.separate(batch, reranking_candidates=2, generator=seed(), visual_stride=8)
    write_wav(f"{args.out}/target_strided.wav", result.target[0], sr)
    print("visual_stride=8:", result.target[0].shape)
    print(f"outputs in {args.out}/")


if __name__ == "__main__":
    main()
