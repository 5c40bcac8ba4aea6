#!/usr/bin/env python3
"""Where the time of one text-prompted separate() goes, for the PyTorch port
on one NVIDIA GPU (default SAMAudioConfig, random weights, bf16, k=1).

    python3 -m sam_audio_tpu_torch.profile_separate [--seconds 10] [--bits 4|8]
        [--candidates 8] [--trace out.json]

`--bits` quantizes the model first (SAMAudio.quantize); `--candidates k`
profiles separate(reranking_candidates=k) with a CLAP ranker of random
weights scoring on the card (the stage times stay those of k=1).

Prints, each as one JSON line:
  * `stages`: host-clock ms of each stage of separate() (codec encode, T5,
    the 32-evaluation ODE, the two codec decodes), each ended by a
    torch.cuda.synchronize();
  * `profile`: one whole separate() under torch.profiler: its wall ms, the
    summed device time of its kernels, the device's idle share, and the top
    kernels by device time, grouped by the port's own kernels, matrix
    products, convolutions and the rest.
The card's name and power limit from nvidia-smi come first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def _ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _group(name: str) -> str:
    n = name.lower()
    if ("fused_glue_attention" in n or "flash_attention_kernel" in n or "res_unit" in n
            or "int4_" in n):
        return "port kernels"
    if "gemm" in n or "gemv" in n or "cutlass" in n or "matmul" in n or "xmma" in n:
        return "matrix products"
    if "conv" in n or "cudnn" in n or "implicit" in n or "winograd" in n:
        return "convolutions"
    return "other (elementwise, reductions, copies)"


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--bits", type=int, choices=(4, 8), default=None)
    ap.add_argument("--candidates", type=int, default=1)
    ap.add_argument("--trace", default=None, help="write a chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_separate: no CUDA device", file=sys.stderr)
        return 2

    from sam_audio_tpu_torch import SAMAudio, SAMAudioConfig, SAMAudioProcessor
    from sam_audio_tpu_torch.models import dacvae
    from sam_audio_tpu_torch.models.sam_audio import (
        DTYPES, decode_channel, forward)
    from sam_audio_tpu_torch.models.t5 import t5_encode
    from sam_audio_tpu_torch.ops.ode import odeint
    from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    cfg = SAMAudioConfig()
    model = SAMAudio.init_random(cfg, seed=0, device="cuda",
                                 tokenizer=ByteFallbackTokenizer(cfg.text_encoder.vocab_size))
    if args.bits:
        model.quantize(args.bits)
    if args.candidates > 1:
        from sam_audio_tpu_torch.config import ClapRankerConfig
        from sam_audio_tpu_torch.ranking.clap import ClapRanker

        model.text_ranker = ClapRanker(ClapRankerConfig(), allow_random=True, device="cuda")
    proc = SAMAudioProcessor(cfg.audio_codec.hop_length, cfg.audio_codec.sample_rate)
    n = int(args.seconds * cfg.audio_codec.sample_rate)
    rng = np.random.RandomState(0)
    wav = (0.3 * np.sin(2 * np.pi * 440 * np.arange(n) / cfg.audio_codec.sample_rate)
           + 0.05 * rng.randn(n)).astype(np.float32)
    batch = proc(descriptions=["a dog barking"], audios=[wav])
    gen = torch.Generator(device="cuda").manual_seed(0)
    k = args.candidates
    model.separate(batch, generator=gen, reranking_candidates=k)  # warm-up (plans)

    # stages, as separate_latents runs them
    p, dt = model.params, DTYPES[cfg.compute_dtype]
    dev = torch.device("cuda")
    stages = {}
    with torch.inference_mode():
        audios = torch.as_tensor(batch.audios, device=dev)
        lat, stages["encode_ms"] = _ms(lambda: dacvae.encode(
            p["audio_codec"], audios, cfg.audio_codec, compute_dtype=dt))
        ids, mask = model._tokenize(batch.descriptions)
        text, stages["t5_ms"] = _ms(lambda: t5_encode(
            p["text_encoder"], ids, mask, cfg.text_encoder, compute_dtype=dt))
        lat = lat.transpose(1, 2).float()
        feats = torch.cat([lat, lat], 2)
        t = feats.shape[1]
        video = torch.zeros((1, cfg.vision_encoder.dim, t), device=dev)
        aids = torch.as_tensor(batch.anchor_ids, dtype=torch.long, device=dev)
        align = torch.as_tensor(batch.anchor_alignment, dtype=torch.long, device=dev)
        pad = torch.as_tensor(batch.audio_pad_mask, device=dev)
        noise = torch.randn((1, t, feats.shape[-1]), generator=gen, device=dev)

        def field(tt, y):
            return forward(p, cfg, y, feats, text, tt.expand(1), video, mask, aids,
                           align, pad, compute_dtype=dt).to(y.dtype)

        latents, stages["ode_32nfe_ms"] = _ms(lambda: odeint(
            field, noise, method="midpoint", step_size=2 / 32))
        _, stages["decode_target_ms"] = _ms(lambda: decode_channel(
            p, latents, cfg=cfg, channel=0))
        _, stages["decode_residual_ms"] = _ms(lambda: decode_channel(
            p, latents, cfg=cfg, channel=1))
    stages["sum_ms"] = sum(stages.values())
    print(json.dumps({"stages": stages}), flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _ms(lambda: model.separate(batch, generator=gen, reranking_candidates=k))
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA")
               and getattr(e, "self_device_time_total", 0) > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    groups = {}
    for e in kernels:
        g = groups.setdefault(_group(e.key), {"ms": 0.0, "launches": 0})
        g["ms"] += e.self_device_time_total / 1e3
        g["launches"] += e.count
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    print(json.dumps({"profile": {
        "bits": args.bits, "candidates": k, "wall_ms": wall, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": max(0.0, 1 - busy_us / 1e3 / wall),
        "kernel_launches": sum(e.count for e in kernels),
        "groups": groups,
        "top": [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
                 "launches": e.count} for e in top]}}), flush=True)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
