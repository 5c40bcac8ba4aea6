#!/usr/bin/env python3
"""Where the time of one separate() goes, for the PyTorch port on one NVIDIA
GPU (default SAMAudioConfig, random weights, bf16, k=1).

    python3 -m sam_audio_tpu_torch.profile_separate [--seconds 10] [--bits 4|8]
        [--candidates 8] [--video] [--trace out.json]

`--bits` quantizes the model first (SAMAudio.quantize); `--candidates k`
profiles separate(reranking_candidates=k) with a CLAP ranker of random
weights scoring on the card (the stages gain `rank`). `--video` prompts
with 25 masked frames a second of 360 x 640 through a PE-Core tower of the
default PerceptionEncoderConfig (random, bf16; the model's video gate
opened to 0.5): the stages gain `pe_encode`, and a `pe_profile` line
profiles the tower's encode alone.

Prints, each as one JSON line, from one separate() under torch.profiler:
  * `stages`: each of the program's spans (utils.stage, `sam_audio.<stage>`)
    with its calls, host ms and device ms (`span_stages`);
  * `profile`: its wall ms, the device's busy ms (the union of its
    operations' intervals) and idle share, and the top kernels by device
    time, grouped by the port's own kernels, products, convolutions, the rest.
The card's name and power limit from nvidia-smi come first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from bisect import bisect_left


def _ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _group(name: str) -> str:
    n = name.lower()
    if ("fused_glue_attention" in n or "flash_attention" in n or "res_unit" in n
            or "int4_" in n):
        return "port kernels"
    if ("gemm" in n or "gemv" in n or "cutlass" in n or "matmul" in n or "xmma" in n
            or "nvjet" in n):   # cuBLAS's nvjet kernels are products too
        return "matrix products"
    if "conv" in n or "cudnn" in n or "implicit" in n or "winograd" in n:
        return "convolutions"
    return "other (elementwise, reductions, copies)"


def _union_ms(intervals) -> float:
    total = end = 0
    for s, e in sorted(intervals):
        total += max(0, e - max(s, end))
        end = max(end, e)
    return total / 1e6


def span_stages(events) -> dict:
    """Each `sam_audio.*` span of a profile's kineto events: calls, host ms,
    and device ms: the union of its device intervals, from the first to the
    last device operation launched inside it (where its linked host op
    starts, else after the operation before it on its stream)."""
    op_at, device, spans, stream_t, ops = {}, [], [], {}, []
    for e in events:
        iv = (e.start_ns(), e.start_ns() + e.duration_ns())
        if str(e.device_type()).endswith("CUDA"):
            if not e.is_user_annotation():
                device.append((e.device_resource_id(), *iv, e.linked_correlation_id()))
        elif e.is_user_annotation() or "::" in e.name():    # ops; runtime calls' ids differ
            op_at[e.correlation_id()] = iv[0]
            if e.name().startswith("sam_audio."):
                spans.append((e.name()[len("sam_audio."):], *iv))
    for stream, s, e, linked in sorted(device):
        t = stream_t[stream] = op_at.get(linked, stream_t.get(stream))
        if t is not None:
            ops.append((t, s, e))
    ops.sort()
    at = [o[0] for o in ops]
    stages = {}
    for name, s0, s1 in spans:
        host, dev = stages.setdefault(name, ([], []))
        host.append((s0, s1))
        inside = ops[bisect_left(at, s0):bisect_left(at, s1)]
        if inside:
            dev.append((min(o[1] for o in inside), max(o[2] for o in inside)))
    return {name: {"calls": len(host), "host_ms": _union_ms(host), "device_ms": _union_ms(dev)}
            for name, (host, dev) in stages.items()}


def device_profile(fn):
    """fn() once under torch.profiler: wall ms, device busy ms (the union of
    the device's operation intervals), idle share, launches, device ms by
    group, the top kernels and the program's spans (`stages`)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _ms(fn)
    events = prof.profiler.kineto_results.events()
    # a user annotation's copy on the device timeline spans operations
    # that are counted on their own
    ops = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
           if str(e.device_type()).endswith("CUDA") and not e.is_user_annotation()]
    groups, by_name = {}, {}
    for name, s, e in ops:
        for table, key in ((groups, _group(name)), (by_name, name[:90])):
            g = table.setdefault(key, {"ms": 0.0, "launches": 0})
            g["ms"] += (e - s) / 1e6
            g["launches"] += 1
    busy_ms = _union_ms((s, e) for _, s, e in ops)
    top = sorted(by_name.items(), key=lambda kv: -kv[1]["ms"])[:15]
    return prof, {"wall_ms": wall, "device_busy_ms": busy_ms,
                  "device_idle_share": max(0.0, 1 - busy_ms / wall),
                  "kernel_launches": len(ops), "groups": groups,
                  "top": [{"name": k, **v} for k, v in top], "stages": span_stages(events)}


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--bits", type=int, choices=(4, 8), default=None)
    ap.add_argument("--candidates", type=int, default=1)
    ap.add_argument("--video", action="store_true", help="a masked video prompt (PE tower)")
    ap.add_argument("--trace", default=None, help="write a chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_separate: no CUDA device", file=sys.stderr)
        return 2

    from sam_audio_tpu_torch import SAMAudio, SAMAudioConfig, SAMAudioProcessor
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
    masked = None
    if args.video:
        from sam_audio_tpu_torch.models.pe_clip import PerceptionEncoder

        model.params["align_masked_video"]["gate"].fill_(0.5)
        model.vision_encoder = PerceptionEncoder.init_random(cfg.vision_encoder, seed=0)
        frames = rng.randint(0, 256, (int(args.seconds * 25), 3, 360, 640), dtype=np.uint8)
        mask = np.zeros_like(frames)
        mask[:, :, 90:270, 213:427] = 1
        masked = proc.mask_videos([frames], [mask])
    batch = proc(descriptions=["a dog barking"], audios=[wav], masked_videos=masked)
    gen = torch.Generator(device="cuda").manual_seed(0)
    k = args.candidates
    model.separate(batch, generator=gen, reranking_candidates=k)  # warm-up (plans)

    prof, rec = device_profile(
        lambda: model.separate(batch, generator=gen, reranking_candidates=k))
    print(json.dumps({"stages": rec.pop("stages")}), flush=True)
    print(json.dumps({"profile": {"bits": args.bits, "candidates": k, "video": args.video,
                                  **rec}}), flush=True)
    if args.video:
        t = batch.anchor_alignment.shape[-1]
        with torch.inference_mode():
            _, pe = device_profile(lambda: model._encode_videos(batch.masked_video, t))
        print(json.dumps({"pe_profile": pe}), flush=True)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
