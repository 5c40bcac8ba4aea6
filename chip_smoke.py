#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sam_audio_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device  — require CUDA; print the card's name and power limit; TF32 off.
  2. build   — compile the CUDA kernels in sam_audio_tpu_torch/csrc with nvcc.
  3. kernels — hold each kernel against its plain PyTorch version on the card
               (bf16 at the main-path shapes, plus an fp32 case; padded and
               fully masked rows for the attention kernels, dilations 1/3/9
               for the residual unit); time kernel, plain version and one
               PyTorch library call as a yardstick.
  4. small   — a small model in fp32 through separate() on the card (the
               kernels) and on the CPU (the plain versions): must agree.
  5. main    — the default SAMAudioConfig (sam-audio-large widths), random
               weights from a seed, bf16, a 10 s 48 kHz mixture with a text
               prompt, separate(k=1): one counted run, then timed runs.
  6. long    — a 45 s clip (1125 frames) through separate(k=1): the flash
               kernel's path.
The second-to-last line is the `{"kernels": [...]}` record, the last line
`{"ok": true, "device": {...}}`; every shape's times also go to the
git-ignored build/chip_smoke.json. Imports nothing from JAX or sam_audio_tpu.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
HBM_BPS = 3.35e12       # H100 SXM HBM3 bytes/s
DEVICE = "cuda"
MIXTURE_SECONDS = 10.0
LONG_SECONDS = 45.0
TIMED_RUNS = 3


def log(*args):
    print(*args, flush=True)


def bound_ms(flops: float, nbytes: float):
    """The least time for bf16 work of `flops` operations moving `nbytes`."""
    t_ops = flops / PEAK_BF16
    t_bytes = nbytes / HBM_BPS
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Mean device ms per call, from CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b):
    d = (a.float() - b.float()).abs()
    return float(d.max()), float((d / (b.float().abs() + 1e-6)).max())


def require(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def check_close(name, got, ref, atol, rtol):
    import torch

    require(torch.isfinite(got.float()).all().item(), f"{name}: non-finite output")
    abs_e, rel_e = max_err(got, ref)
    ok = bool(((got.float() - ref.float()).abs()
               <= atol + rtol * ref.float().abs()).all())
    log(f"  {name}: max_abs_err={abs_e:.3e} max_rel_err={rel_e:.3e} "
        f"tolerance=atol {atol:g} + rtol {rtol:g}*|ref| -> {'ok' if ok else 'FAIL'}")
    require(ok, f"{name}: kernel disagrees with its plain version")
    return abs_e


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _attn_inputs(b, t, h, d, dtype, seed, masked_rows=True):
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=DEVICE)

    q, k, v = (rnd(b, t, h, d).to(dtype) for _ in range(3))
    mask = torch.ones((b, t), dtype=torch.bool, device=DEVICE)
    if masked_rows and b >= 3:
        mask[1, t * 4 // 5:] = False   # a padded batch row
        mask[2, :] = False             # a fully masked row
    return q, k, v, mask


def check_fused_attention(results):
    import torch
    import torch.nn.functional as F

    from sam_audio_tpu_torch.ops.fused_attention import (
        _norm_rope, fused_glue_attention, fused_glue_attention_plain)
    from sam_audio_tpu_torch.ops.rope import precompute_rope

    log("[kernels] fused_glue_attention")
    d, h = 128, 16
    cos, sin = precompute_rope(d, 512, 20000, device=DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(7)
    qw = 1 + 0.1 * torch.randn(d, generator=g, device=DEVICE)
    kw = 1 + 0.1 * torch.randn(d, generator=g, device=DEVICE)
    errs = []
    for dtype, (b, t), (atol, rtol) in (
            (torch.bfloat16, (3, 250), (2e-2, 2e-2)),
            (torch.bfloat16, (1, 512), (2e-2, 2e-2)),
            (torch.float32, (3, 250), (1e-4, 1e-4))):
        q, k, v, mask = _attn_inputs(b, t, h, d, dtype, seed=t)
        out = fused_glue_attention(q, k, v, qw, kw, cos, sin, mask)
        ref = fused_glue_attention_plain(q, k, v, qw, kw, cos, sin, mask)
        torch.cuda.synchronize()
        e = check_close(f"{dtype} B={b} T={t}", out, ref, atol, rtol)
        if dtype == torch.bfloat16:
            errs.append(e)
        else:
            results["fp32_err"] = e
    # main-path shape: B=1, T=250, H=16, D=128, bf16, no masked keys
    q, k, v, mask = _attn_inputs(1, 250, h, d, torch.bfloat16, seed=1,
                                 masked_rows=False)
    ms = time_ms(lambda: fused_glue_attention(q, k, v, qw, kw, cos, sin, mask))
    plain = time_ms(lambda: fused_glue_attention_plain(q, k, v, qw, kw, cos, sin, mask))
    qn = _norm_rope(q, qw, cos, sin, 1e-5).transpose(1, 2)
    kn = _norm_rope(k, kw, cos, sin, 1e-5).transpose(1, 2)
    vt = v.transpose(1, 2)
    lib = time_ms(lambda: F.scaled_dot_product_attention(qn, kn, vt))
    t = 250
    flops = 4 * t * t * d * h
    nbytes = 4 * t * h * d * 2 + 2 * d * 4 + 2 * t * d // 2 * 4 + t
    bms, by = bound_ms(flops, nbytes)
    log(f"  main shape (1, 250, 16, 128) bf16: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, SDPA {lib:.4f} ms, bound {bms:.5f} ms ({by})")
    results.update(name="fused_glue_attention", per_launch=(ms, plain, lib, bms, by),
                   max_abs_err=max(errs), tolerance="bf16 atol 2e-2 + rtol 2e-2; "
                   "fp32 atol 1e-4 + rtol 1e-4")


def check_flash_attention(results):
    import torch
    import torch.nn.functional as F

    from sam_audio_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)

    log("[kernels] flash_attention")
    d, h = 128, 16
    errs = []
    for dtype, (b, t, hh), (atol, rtol) in (
            (torch.bfloat16, (3, 1125, h), (2e-2, 2e-2)),
            (torch.float32, (2, 1100, 4), (1e-4, 1e-4))):
        q, k, v, mask = _attn_inputs(b, t, hh, d, dtype, seed=t)
        if dtype == torch.float32:  # padded + fully masked rows at B=2
            mask[0, 900:] = False
            mask[1, :] = False
        out = flash_attention(q, k, v, mask)
        ref = flash_attention_plain(q, k, v, mask)
        torch.cuda.synchronize()
        e = check_close(f"{dtype} B={b} S={t} H={hh}", out, ref, atol, rtol)
        if dtype == torch.bfloat16:
            errs.append(e)
        else:
            results["fp32_err"] = e
    t = 1125
    q, k, v, mask = _attn_inputs(1, t, h, d, torch.bfloat16, seed=3,
                                 masked_rows=False)
    ms = time_ms(lambda: flash_attention(q, k, v, mask))
    plain = time_ms(lambda: flash_attention_plain(q, k, v, mask), iters=5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    flops = 4 * t * t * d * h
    nbytes = 4 * t * h * d * 2 + t
    bms, by = bound_ms(flops, nbytes)
    log(f"  main shape (1, 1125, 16, 128) bf16: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, SDPA {lib:.4f} ms, bound {bms:.5f} ms ({by})")
    results.update(name="flash_attention", per_launch=(ms, plain, lib, bms, by),
                   max_abs_err=max(errs), tolerance="bf16 atol 2e-2 + rtol 2e-2; "
                   "fp32 atol 1e-4 + rtol 1e-4")


# (C, T) of the residual units of a 10 s 48 kHz clip, and how many launches
# of each one separate makes (1 encode + 2 decodes; 3 dilations each)
ENCODER_SHAPES = ((64, 480000), (128, 240000), (256, 30000), (512, 3000))
DECODER_SHAPES = ((768, 3000), (384, 30000), (192, 240000), (96, 480000))


def check_fused_conv(results):
    import torch
    import torch.nn.functional as F

    from sam_audio_tpu_torch.ops.conv import snake
    from sam_audio_tpu_torch.ops.fused_conv import (
        fused_residual_unit, fused_residual_unit_plain, residual_unit_operands)

    log("[kernels] fused_residual_unit")

    def unit(c, seed):
        g = torch.Generator(device=DEVICE).manual_seed(seed)

        def u(*shape, scale):
            return (torch.rand(*shape, generator=g, device=DEVICE) * 2 - 1) * scale

        return {"snake1": {"alpha": 0.5 + torch.rand(1, c, 1, generator=g, device=DEVICE)},
                "conv1": {"weight": u(c, c, 7, scale=(7 * c) ** -0.5),
                          "bias": u(c, scale=(7 * c) ** -0.5)},
                "snake2": {"alpha": 0.5 + torch.rand(1, c, 1, generator=g, device=DEVICE)},
                "conv2": {"weight": u(c, c, 1, scale=c ** -0.5), "bias": u(c, scale=c ** -0.5)}}

    def library_chain(p, x, dil):
        h = snake(p["snake1"], x)
        h = F.conv1d(h, p["conv1"]["weight"].to(x.dtype), p["conv1"]["bias"].to(x.dtype),
                     padding=3 * dil, dilation=dil)
        h = snake(p["snake2"], h)
        return x + F.conv1d(h, p["conv2"]["weight"].to(x.dtype),
                            p["conv2"]["bias"].to(x.dtype))

    errs = []
    totals = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0, "flops": 0.0,
              "bytes": 0.0}
    per_shape = []
    g = torch.Generator(device=DEVICE).manual_seed(11)
    for c, t in ENCODER_SHAPES + DECODER_SHAPES:
        x = torch.randn(1, c, t, generator=g, device=DEVICE).to(torch.bfloat16)
        for dil in (1, 3, 9):
            p = unit(c, seed=c + dil)
            out = fused_residual_unit(p, x, dil, torch.bfloat16)
            ref = fused_residual_unit_plain(*residual_unit_operands(p, x, torch.bfloat16), dil)
            torch.cuda.synchronize()
            errs.append(check_close(f"bf16 C={c} T={t} dil={dil}", out, ref, 5e-2, 2e-2))
            reps = 2 if c * t > 3e7 else 5
            ms = time_ms(lambda: fused_residual_unit(p, x, dil, torch.bfloat16), iters=reps)
            ops = residual_unit_operands(p, x, torch.bfloat16)
            plain = time_ms(lambda: fused_residual_unit_plain(*ops, dil), iters=reps)
            lib = time_ms(lambda: library_chain(p, x, dil), iters=reps)
            flops = 2 * 8 * c * c * t
            nbytes = 2 * c * t * 2 + 8 * c * c * 2 + 4 * c * 4
            bms, _ = bound_ms(flops, nbytes)
            # encoder shapes run once per separate, decoder shapes twice
            n = 1 if (c, t) in ENCODER_SHAPES else 2
            totals["ms"] += n * ms
            totals["plain"] += n * plain
            totals["lib"] += n * lib
            totals["bound"] += n * bms
            totals["flops"] += n * flops
            totals["bytes"] += n * nbytes
            per_shape.append(dict(C=c, T=t, dilation=dil, ms=ms, plain_ms=plain,
                                  library_ms=lib, bound_ms=bms))
            log(f"    kernel {ms:.3f} ms, plain {plain:.3f} ms, conv1d chain "
                f"{lib:.3f} ms, bound {bms:.4f} ms")
    x = torch.randn(2, 64, 3000, generator=g, device=DEVICE)
    for dil in (1, 3, 9):
        p = unit(64, seed=dil)
        out = fused_residual_unit(p, x, dil, torch.float32)
        ref = fused_residual_unit_plain(*residual_unit_operands(p, x, torch.float32), dil)
        torch.cuda.synchronize()
        results["fp32_err"] = max(results.get("fp32_err", 0.0),
                                  check_close(f"fp32 C=64 T=3000 dil={dil}", out, ref,
                                              1e-4, 1e-4))
    _, by = bound_ms(totals["flops"], totals["bytes"])
    results.update(name="fused_residual_unit", totals=totals, bound_by=by,
                   max_abs_err=max(errs), per_shape=per_shape,
                   tolerance="bf16 atol 5e-2 + rtol 2e-2; fp32 atol 1e-4 + rtol 1e-4")


# ---------------------------------------------------------------------------
# Phases 4-6: separate() end to end
# ---------------------------------------------------------------------------


def mixture(n: int, sr: int, seed: int):
    """n samples of tones, noise bursts and a noise floor at rate sr."""
    import numpy as np

    rng = np.random.RandomState(seed)
    t = np.arange(n) / sr
    tones = sum(0.2 * np.sin(2 * np.pi * f * t) for f in (220.0, 330.0, 1250.0))
    bursts = (np.sin(2 * np.pi * 2.0 * t) > 0.6) * rng.randn(n) * 0.1
    return (tones + bursts + 0.01 * rng.randn(n)).astype(np.float32)


def small_config():
    from sam_audio_tpu_torch.config import (
        DACVAEConfig, SAMAudioConfig, T5EncoderConfig, TransformerConfig)

    return SAMAudioConfig(
        in_channels=96,
        audio_codec=DACVAEConfig(encoder_dim=32, encoder_rates=(2, 4), latent_dim=64,
                                 decoder_dim=128, decoder_rates=(4, 2),
                                 codebook_dim=16, sample_rate=8000),
        text_encoder=T5EncoderConfig(dim=64, num_layers=2, num_heads=4, head_dim=16,
                                     d_ff=128, vocab_size=512),
        transformer=TransformerConfig(dim=256, n_heads=2, n_layers=2, dropout=0.0,
                                      context_dim=256, max_positions=2048,
                                      frequency_embedding_dim=64, out_channels=32),
        span_predictor=None, compute_dtype="float32")


def small_agreement():
    """The same small fp32 model and noise through separate() on the card
    (kernels) and on the CPU (plain versions); covers all three kernels."""
    import numpy as np
    import torch

    from sam_audio_tpu_torch import SAMAudio, SAMAudioProcessor
    from sam_audio_tpu_torch.ops.flash_attention import flash_attention
    from sam_audio_tpu_torch.ops.fused_attention import fused_glue_attention
    from sam_audio_tpu_torch.ops.fused_conv import fused_residual_unit
    from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer
    from sam_audio_tpu_torch.utils import tree_map

    log("[small] fp32 separate on the card vs on the CPU")
    cfg = small_config()
    tok = ByteFallbackTokenizer(cfg.text_encoder.vocab_size)
    gpu = SAMAudio.init_random(cfg, seed=0, device=DEVICE, tokenizer=tok)
    cpu = SAMAudio(cfg, tree_map(lambda x: x.cpu(), gpu.params), device="cpu",
                   tokenizer=tok, allow_random_towers=True)
    proc = SAMAudioProcessor(cfg.audio_codec.hop_length, cfg.audio_codec.sample_rate)
    worst = 0.0
    for frames in (200, 1100):   # fused attention (<= 512) / flash (>= 1024)
        n = frames * cfg.audio_codec.hop_length
        batch = proc(descriptions=["a dog barking", "rain"],
                     audios=[mixture(n, 8000, 1), mixture(n * 4 // 5, 8000, 2)])
        noise = np.random.RandomState(frames).randn(
            2, frames, 2 * cfg.audio_codec.codebook_dim).astype(np.float32)
        before = (fused_glue_attention.launches, flash_attention.launches,
                  fused_residual_unit.launches)
        a = gpu.separate(batch, noise=noise)
        after = (fused_glue_attention.launches, flash_attention.launches,
                 fused_residual_unit.launches)
        b = cpu.separate(batch, noise=noise)
        for i in range(2):
            for got, ref in ((a.target[i], b.target[i]), (a.residual[i], b.residual[i])):
                require(got.shape == ref.shape and np.isfinite(got).all(),
                        "small: bad output")
                worst = max(worst, float(np.abs(got - ref).max()))
        log(f"  T={frames} frames: launches (fused, flash, res-unit) "
            f"{tuple(y - x for x, y in zip(before, after))}, max |gpu - cpu| = {worst:.3e}")
    require(worst <= 2e-3, f"small: card and CPU disagree ({worst:.3e} > 2e-3)")


def reset_counts():
    from sam_audio_tpu_torch.ops.flash_attention import flash_attention
    from sam_audio_tpu_torch.ops.fused_attention import fused_glue_attention
    from sam_audio_tpu_torch.ops.fused_conv import fused_residual_unit

    for fn in (fused_glue_attention, flash_attention, fused_residual_unit):
        fn.launches = 0


def read_counts():
    from sam_audio_tpu_torch.ops.flash_attention import flash_attention
    from sam_audio_tpu_torch.ops.fused_attention import fused_glue_attention
    from sam_audio_tpu_torch.ops.fused_conv import fused_residual_unit

    return {"fused_glue_attention": fused_glue_attention.launches,
            "flash_attention": flash_attention.launches,
            "fused_residual_unit": fused_residual_unit.launches}


def check_outputs(res, n_samples, what):
    import numpy as np

    for name, wavs in (("target", res.target), ("residual", res.residual)):
        w = wavs[0]
        require(w.shape == (n_samples,), f"{what}: {name} has shape {w.shape}")
        require(bool(np.isfinite(w).all()), f"{what}: {name} is not finite")
        rms = float(np.sqrt(np.mean(np.square(w))))
        require(rms > 0, f"{what}: {name} is silent")
        log(f"  {name}: {w.shape[0]} samples, finite, rms {rms:.4e}")


def main_path(model, proc, seconds, expect, timed_runs):
    import torch

    sr = model.sample_rate
    batch = proc(descriptions=["a dog barking"],
                 audios=[mixture(int(seconds * sr), sr, 0)])
    frames = batch.anchor_alignment.shape[-1]
    log(f"  {seconds:g} s at {sr} Hz -> {frames} latent frames")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = model.separate(batch, generator=gen)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    log(f"  counted run: {first_ms:.1f} ms, launches {counts}")
    for name, n in expect.items():
        require(counts[name] == n, f"{name}: {counts[name]} launches, expected {n}")
    check_outputs(res, int(seconds * sr), f"{seconds:g} s separate")
    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(timed_runs):
        t0 = time.perf_counter()
        model.separate(batch, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return counts, first_ms, times, torch.cuda.max_memory_allocated()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from sam_audio_tpu_torch import SAMAudio, SAMAudioConfig, SAMAudioProcessor
    from sam_audio_tpu_torch.ops import _build
    from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    out_dir = _build.build_all()
    log(f"[build] {out_dir} in {time.perf_counter() - t0:.1f} s")
    for line in str(_build.build_info.get("log", "")).splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("  " + line.strip())

    # 3. kernels vs plain
    k1, k2, k3 = {}, {}, {}
    check_fused_attention(k1)
    check_flash_attention(k2)
    check_fused_conv(k3)

    # 4. small model: card vs CPU
    small_agreement()

    # 5. main path, full width
    log("[main] default SAMAudioConfig, random weights (seed 0), bf16")
    cfg = SAMAudioConfig()
    model = SAMAudio.init_random(cfg, seed=0, device=DEVICE,
                                 tokenizer=ByteFallbackTokenizer(cfg.text_encoder.vocab_size))
    proc = SAMAudioProcessor(cfg.audio_codec.hop_length, cfg.audio_codec.sample_rate)
    n_layers, nfe = cfg.transformer.n_layers, 32
    counts, first_ms, times, peak = main_path(
        model, proc, MIXTURE_SECONDS,
        {"fused_glue_attention": n_layers * nfe, "fused_residual_unit": 36,
         "flash_attention": 0}, TIMED_RUNS)
    p50 = sorted(times)[len(times) // 2]
    log(f"  timed runs (ms): {[round(t, 1) for t in times]}; p50 {p50:.1f} ms; "
        f"realtime factor {MIXTURE_SECONDS * 1e3 / p50:.2f}x; peak memory "
        f"{peak / 2**30:.2f} GiB")

    # 6. long direct path (flash attention)
    log(f"[long] {LONG_SECONDS:g} s clip")
    long_counts, long_ms, long_times, long_peak = main_path(
        model, proc, LONG_SECONDS,
        {"flash_attention": n_layers * nfe, "fused_residual_unit": 36,
         "fused_glue_attention": 0}, 1)
    log(f"  timed run {long_times[0]:.1f} ms; peak memory {long_peak / 2**30:.2f} GiB")

    def entry(res, source, replaces, launches, ms, plain, lib, bms, by):
        # "tpu_source", "max_err" and "kernel_ms" repeat "replaces",
        # "max_abs_err" and "ms" under a second set of names that readers use
        return {"name": res["name"], "route": "cuda", "source": source,
                "replaces": replaces, "tpu_source": replaces, "launches": launches,
                "max_abs_err": res["max_abs_err"], "max_err": res["max_abs_err"],
                "max_abs_err_fp32": res["fp32_err"], "tolerance": res["tolerance"],
                "ms": ms, "kernel_ms": ms, "plain_ms": plain, "bound_ms": bms,
                "bound_by": by, "library_ms": lib,
                "ms_scope": "device time of one separate's launches"}

    kernels = []
    for res, src, rep, n in (
            (k1, "sam_audio_tpu_torch/csrc/fused_attention.cu",
             "sam_audio_tpu/ops/fused_attention.py:151", counts["fused_glue_attention"]),
            (k2, "sam_audio_tpu_torch/csrc/flash_attention.cu",
             "sam_audio_tpu/ops/flash_attention.py:99", long_counts["flash_attention"])):
        ms, plain, lib, bms, by = res["per_launch"]
        kernels.append(entry(res, src, rep, n, ms * n, plain * n, lib * n, bms * n, by))
    tot = k3["totals"]
    kernels.append(entry(k3, "sam_audio_tpu_torch/csrc/fused_conv.cu",
                         "sam_audio_tpu/ops/fused_conv.py:105",
                         counts["fused_residual_unit"], tot["ms"], tot["plain"],
                         tot["lib"], tot["bound"], k3["bound_by"]))
    summary = {"main_10s": {"p50_ms": p50, "runs_ms": times, "first_ms": first_ms,
                            "realtime_factor": MIXTURE_SECONDS * 1e3 / p50,
                            "peak_bytes": peak, "launches": counts},
               "long_45s": {"ms": long_times[0], "first_ms": long_ms,
                            "peak_bytes": long_peak, "launches": long_counts},
               "power": smi}
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "chip_smoke.json"), "w") as f:
        json.dump({"kernels": kernels, "summary": summary,
                   "fused_residual_unit_shapes": k3["per_shape"]}, f, indent=1)
    log(json.dumps({"summary": summary}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
