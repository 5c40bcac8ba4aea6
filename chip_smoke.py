#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sam_audio_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels 1,3    (phases 1-3 for the listed kernels, then stop)

Phases (any failure exits non-zero):
  1. device  — require CUDA; print the card's name and power limit; TF32 off.
  2. build   — compile the CUDA kernels in sam_audio_tpu_torch/csrc with nvcc
               (one process per source, in parallel).
  3. kernels — hold each kernel against its plain PyTorch version on the card
               (bf16 at the main-path shapes, plus an fp32 case; padded and
               fully masked rows for the attention kernels, dilations 1/3/9
               for the residual unit, 250/2000/14 tokens for the int4
               product, whose two runs must give the same bits); time kernel,
               plain version and one PyTorch library call as a yardstick, the
               kernel and the library call also with the host out of the
               window (`device_ms`: a CUDA graph of the calls, replayed).
  4. small   — a small model in fp32 through separate() on the card (the
               kernels) and on the CPU (the plain versions): must agree; then
               the same after quantize(bits=4).
  5. main    — the default SAMAudioConfig (sam-audio-large widths), random
               weights from a seed, bf16, a 10 s 48 kHz mixture with a text
               prompt, separate(k=1): one counted run, then timed runs.
  6. long    — a 45 s clip (1125 frames) through separate(k=1): the flash
               kernel's path.
  7. rerank  — the same model, separate(reranking_candidates=8) with a CLAP
               ranker of random weights scoring on the card; the winner must
               be the argmax of the host scoring path on the same decoded
               candidates. Then once with preview_nfe=8.
  8. int4    — quantize(bits=4), separate(k=1) on the 10 s clip (every DiT
               linear through the int4 kernel), held against the exact bf16
               model with the same noise (correlation and SNR).
  9. int8    — the same probe after quantize(bits=8) of a fresh model.
Each path is driven with the launch counts set to 0 just before it and read
just after; each must launch exactly the kernels its shapes select.
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
PEAK_FP32 = 67e12       # H100 SXM fp32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12       # H100 SXM HBM3 bytes/s
DEVICE = "cuda"
MIXTURE_SECONDS = 10.0
LONG_SECONDS = 45.0
TIMED_RUNS = 3


def log(*args):
    print(*args, flush=True)


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16):
    """The least time for work of `flops` operations (at `peak` FLOP/s, bf16
    tensor cores by default) moving `nbytes`."""
    t_ops = flops / peak
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


def device_ms(fn, iters: int = 20, replays: int = 3) -> float:
    """Mean device ms per call with the host out of the window: `iters` calls
    are captured in one CUDA graph and the graph's replay is timed with CUDA
    events (the mean of `replays` replays)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


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
    first = fused_glue_attention(q, k, v, qw, kw, cos, sin, mask)
    require(torch.equal(first, fused_glue_attention(q, k, v, qw, kw, cos, sin, mask)),
            "fused_glue_attention: two runs on one input differ")
    require(torch.equal(first, fused_glue_attention(q, k, v, qw, kw, cos, sin)),
            "fused_glue_attention: no mask and an all-true mask differ")
    ms = time_ms(lambda: fused_glue_attention(q, k, v, qw, kw, cos, sin, mask))
    plain = time_ms(lambda: fused_glue_attention_plain(q, k, v, qw, kw, cos, sin, mask))
    qn = _norm_rope(q, qw, cos, sin, 1e-5).transpose(1, 2)
    kn = _norm_rope(k, kw, cos, sin, 1e-5).transpose(1, 2)
    vt = v.transpose(1, 2)
    lib = time_ms(lambda: F.scaled_dot_product_attention(qn, kn, vt))
    dev = device_ms(lambda: fused_glue_attention(q, k, v, qw, kw, cos, sin, mask))
    lib_dev = device_ms(lambda: F.scaled_dot_product_attention(qn, kn, vt))
    t = 250
    flops = 4 * t * t * d * h
    nbytes = 4 * t * h * d * 2 + 2 * d * 4 + 2 * t * d // 2 * 4 + t
    bms, by = bound_ms(flops, nbytes)
    log(f"  main shape (1, 250, 16, 128) bf16: kernel {ms:.4f} ms (device {dev:.4f}), plain "
        f"{plain:.4f} ms, SDPA {lib:.4f} ms (device {lib_dev:.4f}), bound {bms:.5f} ms ({by})")
    # the k=8 rerank's shape (B=8, bf16) and the int4/int8 modes' fp32 path
    extra = {}
    for what, b, dtype, elem, peak in (("bf16 B=8", 8, torch.bfloat16, 2, PEAK_BF16),
                                       ("fp32 B=1", 1, torch.float32, 4, PEAK_FP32)):
        q, k, v, mask = _attn_inputs(b, t, h, d, dtype, seed=2, masked_rows=False)
        xms = time_ms(lambda: fused_glue_attention(q, k, v, qw, kw, cos, sin, mask))
        xdev = device_ms(lambda: fused_glue_attention(q, k, v, qw, kw, cos, sin, mask))
        qn = _norm_rope(q, qw, cos, sin, 1e-5).transpose(1, 2)
        kn = _norm_rope(k, kw, cos, sin, 1e-5).transpose(1, 2)
        vt = v.transpose(1, 2)
        xlib = device_ms(lambda: F.scaled_dot_product_attention(qn, kn, vt))
        xb, xby = bound_ms(b * flops, b * 4 * t * h * d * elem + 2 * d * 4 + t * d * 4 + b * t,
                           peak)
        extra[what] = dict(ms=xms, device_ms=xdev, library_device_ms=xlib, bound_ms=xb,
                           bound_by=xby)
        log(f"  ({b}, 250, 16, 128) {dtype}: kernel {xms:.4f} ms (device {xdev:.4f}), SDPA "
            f"device {xlib:.4f} ms, bound {xb:.5f} ms ({xby})")
    results["extra"] = extra
    results.update(name="fused_glue_attention",
                   per_launch=(ms, plain, lib, bms, by, dev, lib_dev),
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
    require(torch.equal(flash_attention(q, k, v), flash_attention(q, k, v, mask)),
            "flash_attention: no mask and an all-true mask differ")
    ms = time_ms(lambda: flash_attention(q, k, v, mask))
    plain = time_ms(lambda: flash_attention_plain(q, k, v, mask), iters=5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    dev = device_ms(lambda: flash_attention(q, k, v, mask))
    lib_dev = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    flops = 4 * t * t * d * h
    nbytes = 4 * t * h * d * 2 + t
    bms, by = bound_ms(flops, nbytes)
    log(f"  main shape (1, 1125, 16, 128) bf16: kernel {ms:.4f} ms (device {dev:.4f}), plain "
        f"{plain:.4f} ms, SDPA {lib:.4f} ms (device {lib_dev:.4f}), bound {bms:.5f} ms ({by})")
    results.update(name="flash_attention",
                   per_launch=(ms, plain, lib, bms, by, dev, lib_dev),
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
              "bytes": 0.0, "dev": 0.0, "lib_dev": 0.0}
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
            require(torch.equal(out, fused_residual_unit(p, x, dil, torch.bfloat16)),
                    "fused_residual_unit: two runs on one input differ")
            reps = 2 if c * t > 3e7 else 5
            ms = time_ms(lambda: fused_residual_unit(p, x, dil, torch.bfloat16), iters=reps)
            ops = residual_unit_operands(p, x, torch.bfloat16)
            plain = time_ms(lambda: fused_residual_unit_plain(*ops, dil), iters=reps)
            lib = time_ms(lambda: library_chain(p, x, dil), iters=reps)
            dev = device_ms(lambda: fused_residual_unit(p, x, dil, torch.bfloat16), iters=reps)
            lib_dev = device_ms(lambda: library_chain(p, x, dil), iters=reps)
            flops = 2 * 8 * c * c * t
            nbytes = 2 * c * t * 2 + 8 * c * c * 2 + 4 * c * 4
            bms, _ = bound_ms(flops, nbytes)
            # encoder shapes run once per separate, decoder shapes twice
            n = 1 if (c, t) in ENCODER_SHAPES else 2
            for key, val in (("ms", ms), ("plain", plain), ("lib", lib), ("bound", bms),
                             ("flops", flops), ("bytes", nbytes), ("dev", dev),
                             ("lib_dev", lib_dev)):
                totals[key] += n * val
            per_shape.append(dict(C=c, T=t, dilation=dil, ms=ms, device_ms=dev, plain_ms=plain,
                                  library_ms=lib, library_device_ms=lib_dev, bound_ms=bms))
            log(f"    kernel {ms:.3f} ms (device {dev:.3f}), plain {plain:.3f} ms, conv1d chain "
                f"{lib:.3f} ms (device {lib_dev:.3f}), bound {bms:.4f} ms")
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


def int4_launches_k1(cfg, text_tokens=14, nfe=32):
    """{(out, in, tokens): launches} of the int4 product in one separate of a
    10 s clip (T = 250 frames) at k=1. Per layer and evaluation: six
    (dim, dim) products at T tokens (self-attention q/k/v/o, cross-attention
    q/o), two at the prompt's tokens (cross-attention k/v), w1 and w3
    (ffn, dim), w2 (dim, ffn); the input projection (dim, in_channels) once
    per evaluation."""
    dim, ffn, n = cfg.transformer.dim, cfg.transformer.ffn_hidden_dim, cfg.transformer.n_layers
    t = 250
    return {(dim, dim, t): 6 * n * nfe, (dim, dim, text_tokens): 2 * n * nfe,
            (ffn, dim, t): 2 * n * nfe, (dim, ffn, t): n * nfe,
            (dim, cfg.in_channels, t): nfe}


def check_matmul_int4(results, cfg):
    import torch

    from sam_audio_tpu_torch.ops.int4_matmul import matmul_int4, matmul_int4_plain, unpack_int4
    from sam_audio_tpu_torch.ops.quant import quantize_linear_int4

    log("[kernels] matmul_int4")
    k1 = int4_launches_k1(cfg)
    dim, ffn = cfg.transformer.dim, cfg.transformer.ffn_hidden_dim
    g = torch.Generator(device=DEVICE).manual_seed(13)
    totals = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0, "flops": 0.0,
              "bytes": 0.0, "dev": 0.0, "lib_dev": 0.0}
    errs, per_shape = [], []
    for out, din in ((dim, dim), (ffn, dim), (dim, ffn), (dim, cfg.in_channels)):
        q = quantize_linear_int4({"weight": torch.randn(out, din, generator=g, device=DEVICE)
                                  * din ** -0.5})
        w4, s = q["w4"], q["w4_scale"]
        lo, hi = unpack_int4(w4)
        n_groups = s.shape[1]
        # the library yardstick's weight, dequantized once before timing
        w_deq = (torch.cat([lo, hi]).float().reshape(out, n_groups, -1) * s[..., None]
                 ).reshape(out, din).to(torch.bfloat16)
        for tokens in (250, 2000, 14):
            x = torch.randn(tokens, din, generator=g, device=DEVICE).to(torch.bfloat16)
            y = matmul_int4(x, w4, s)
            ref = matmul_int4_plain(x, w4, s)
            torch.cuda.synchronize()
            errs.append(check_close(f"bf16 tokens={tokens} (out, in)=({out}, {din})", y, ref,
                                    2e-2, 2e-2))
            require(torch.equal(y, matmul_int4(x, w4, s)),
                    "matmul_int4: two runs on one input differ (the reduction must be "
                    "deterministic)")
            ms = time_ms(lambda: matmul_int4(x, w4, s))
            plain = time_ms(lambda: matmul_int4_plain(x, w4, s), iters=5)
            lib = time_ms(lambda: torch.matmul(x, w_deq.t()))
            dev = device_ms(lambda: matmul_int4(x, w4, s))
            lib_dev = device_ms(lambda: torch.matmul(x, w_deq.t()))
            flops = 2 * tokens * din * out
            nbytes = tokens * din * 2 + w4.numel() + s.numel() * 4 + tokens * out * 2
            bms, by = bound_ms(flops, nbytes)
            n = k1.get((out, din, tokens), 0)
            for key, v in (("ms", ms), ("plain", plain), ("lib", lib), ("bound", bms),
                           ("flops", flops), ("bytes", nbytes), ("dev", dev),
                           ("lib_dev", lib_dev)):
                totals[key] += n * v
            per_shape.append(dict(out=out, din=din, tokens=tokens, ms=ms, device_ms=dev,
                                  plain_ms=plain, library_ms=lib, library_device_ms=lib_dev,
                                  bound_ms=bms, bound_by=by, launches_per_separate_k1=n))
            log(f"    kernel {ms:.4f} ms (device {dev:.4f}), plain {plain:.4f} ms, matmul of the "
                f"dequantized weight {lib:.4f} ms (device {lib_dev:.4f}), bound {bms:.5f} ms "
                f"({by}); {n} launches at k=1")
        if (out, din) == (dim, dim):
            x = torch.randn(250, din, generator=g, device=DEVICE)
            y = matmul_int4(x, w4, s)
            ref = matmul_int4_plain(x, w4, s)
            torch.cuda.synchronize()
            results["fp32_err"] = check_close(f"fp32 tokens=250 (out, in)=({out}, {din})", y,
                                              ref, 1e-4, 1e-4)
    _, by = bound_ms(totals["flops"], totals["bytes"])
    results.update(name="matmul_int4", totals=totals, bound_by=by, max_abs_err=max(errs),
                   per_shape=per_shape,
                   tolerance="bf16 atol 2e-2 + rtol 2e-2; fp32 atol 1e-4 + rtol 1e-4")


# ---------------------------------------------------------------------------
# Phases 4-9: separate() end to end
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
    """DiT head_dim 128 (the fused kernel's branch) and an FFN of 1024, so
    every quantized linear has 128-wide int4 groups (96 for the input
    projection), as the int4 kernel requires multiples of 16."""
    from sam_audio_tpu_torch.config import (
        DACVAEConfig, SAMAudioConfig, T5EncoderConfig, TransformerConfig)

    return SAMAudioConfig(
        in_channels=96,
        audio_codec=DACVAEConfig(encoder_dim=32, encoder_rates=(2, 4), latent_dim=64,
                                 decoder_dim=128, decoder_rates=(4, 2),
                                 codebook_dim=16, sample_rate=8000),
        text_encoder=T5EncoderConfig(dim=64, num_layers=2, num_heads=4, head_dim=16,
                                     d_ff=128, vocab_size=512),
        transformer=TransformerConfig(dim=384, n_heads=3, n_layers=2, dropout=0.0,
                                      context_dim=384, max_positions=2048,
                                      frequency_embedding_dim=64, out_channels=32),
        span_predictor=None, compute_dtype="float32")


def small_agreement():
    """The same small fp32 model and noise through separate() on the card
    (kernels) and on the CPU (plain versions); covers all four kernels."""
    import numpy as np

    from sam_audio_tpu_torch import SAMAudio, SAMAudioProcessor
    from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer
    from sam_audio_tpu_torch.utils import tree_map

    log("[small] fp32 separate on the card vs on the CPU")
    cfg = small_config()
    tok = ByteFallbackTokenizer(cfg.text_encoder.vocab_size)
    gpu = SAMAudio.init_random(cfg, seed=0, device=DEVICE, tokenizer=tok)
    cpu = SAMAudio(cfg, tree_map(lambda x: x.cpu(), gpu.params), device="cpu",
                   tokenizer=tok, allow_random_towers=True)
    proc = SAMAudioProcessor(cfg.audio_codec.hop_length, cfg.audio_codec.sample_rate)

    def compare(frames, what):
        n = frames * cfg.audio_codec.hop_length
        batch = proc(descriptions=["a dog barking", "rain"],
                     audios=[mixture(n, 8000, 1), mixture(n * 4 // 5, 8000, 2)])
        noise = np.random.RandomState(frames).randn(
            2, frames, 2 * cfg.audio_codec.codebook_dim).astype(np.float32)
        reset_counts()
        a = gpu.separate(batch, noise=noise)
        counts = read_counts()
        b = cpu.separate(batch, noise=noise)
        worst = 0.0
        for i in range(2):
            for got, ref in ((a.target[i], b.target[i]), (a.residual[i], b.residual[i])):
                require(got.shape == ref.shape and np.isfinite(got).all(),
                        "small: bad output")
                worst = max(worst, float(np.abs(got - ref).max()))
        log(f"  {what}, T={frames} frames: launches {counts}, max |gpu - cpu| = {worst:.3e}")
        require(worst <= 2e-3, f"small: card and CPU disagree ({worst:.3e} > 2e-3)")
        return counts

    for frames in (200, 1100):   # fused attention (<= 512) / flash (>= 1024)
        compare(frames, "exact")
    gpu.quantize(4)
    cpu.quantize(4)
    counts = compare(200, "quantize(bits=4)")
    require(counts["matmul_int4"] == 2 * 11 * 32 + 32,
            f"small int4: {counts['matmul_int4']} int4 launches, expected {2 * 11 * 32 + 32}")


def kernel_wrappers():
    from sam_audio_tpu_torch.ops.flash_attention import flash_attention
    from sam_audio_tpu_torch.ops.fused_attention import fused_glue_attention
    from sam_audio_tpu_torch.ops.fused_conv import fused_residual_unit
    from sam_audio_tpu_torch.ops.int4_matmul import matmul_int4

    return (fused_glue_attention, flash_attention, fused_residual_unit, matmul_int4)


def reset_counts():
    for fn in kernel_wrappers():
        fn.launches = 0


def read_counts():
    return {fn.__name__: fn.launches for fn in kernel_wrappers()}


def check_outputs(res, n_samples, what):
    import numpy as np

    for name, wavs in (("target", res.target), ("residual", res.residual)):
        w = wavs[0]
        require(w.shape == (n_samples,), f"{what}: {name} has shape {w.shape}")
        require(bool(np.isfinite(w).all()), f"{what}: {name} is not finite")
        rms = float(np.sqrt(np.mean(np.square(w))))
        require(rms > 0, f"{what}: {name} is silent")
        log(f"  {name}: {w.shape[0]} samples, finite, rms {rms:.4e}")


def clip_batch(proc, sr, seconds):
    batch = proc(descriptions=["a dog barking"], audios=[mixture(int(seconds * sr), sr, 0)])
    log(f"  {seconds:g} s at {sr} Hz -> {batch.anchor_alignment.shape[-1]} latent frames")
    return batch


def drive(what, model, batch, seconds, expect, timed_runs, **kwargs):
    """One counted separate(batch, **kwargs) with the launch counts set to 0
    just before it and read just after (each must equal `expect`), then
    `timed_runs` timed ones. Returns the counted run's result, the counts,
    its ms, the timed ms and the peak device memory (of the timed runs, or
    of the counted run when there are none)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = model.separate(batch, **kwargs)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    log(f"  counted run: {first_ms:.1f} ms, launches {counts}")
    for name, n in expect.items():
        require(counts[name] == n, f"{what}: {counts[name]} {name} launches, expected {n}")
    check_outputs(res, int(seconds * model.sample_rate), what)
    times = []
    if timed_runs:
        torch.cuda.reset_peak_memory_stats()
    for _ in range(timed_runs):
        t0 = time.perf_counter()
        model.separate(batch, **kwargs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return res, counts, first_ms, times, torch.cuda.max_memory_allocated()


def p50(times):
    return sorted(times)[len(times) // 2]


def rerank_phase(model, batch, n_layers, nfe, gen):
    """k=8 with a CLAP ranker scoring on the card; its winner must be the
    argmax of the host path's scores on the same decoded candidates."""
    import numpy as np
    import torch

    from sam_audio_tpu_torch.config import ClapRankerConfig
    from sam_audio_tpu_torch.ranking.clap import ClapRanker

    log("[rerank] exact bf16, k=8, CLAP ranker (random weights, seed 0) on the card")
    ranker = ClapRanker(ClapRankerConfig(), allow_random=True, device=DEVICE)
    seen = []
    on_device = ranker.score_on_device

    def spy(targets, sizes, descriptions, **kw):
        scores = on_device(targets, sizes, descriptions, **kw)
        if not seen:   # the counted run's candidates and scores
            seen.append((targets.cpu().numpy(), list(sizes), list(descriptions),
                         scores.cpu().numpy()))
        return scores

    ranker.score_on_device = spy
    model.text_ranker = ranker
    k = 8
    res, counts, first_ms, times, peak = drive(
        "rerank k=8", model, batch, MIXTURE_SECONDS,
        {"fused_glue_attention": n_layers * nfe, "fused_residual_unit": 36,
         "flash_attention": 0, "matmul_int4": 0}, TIMED_RUNS,
        reranking_candidates=k, generator=gen)
    require(bool(seen), "rerank: the on-device scoring path was not taken")
    targets, sizes, desc, dev_scores = seen[0]
    winner = int(np.argmax(dev_scores[0]))
    host_scores = ranker(extracted_audio=[targets[0, :, :sizes[0]]], descriptions=desc,
                         sample_rate=model.sample_rate)
    score_err = float(np.abs(host_scores - dev_scores).max())
    log(f"  scores on the card {np.round(dev_scores[0], 5).tolist()}; winner {winner}; "
        f"host path argmax {int(np.argmax(host_scores[0]))}; max |host - card| "
        f"{score_err:.3e}")
    require(int(np.argmax(host_scores[0])) == winner,
            "rerank: the host path's argmax differs from the winner")
    require(np.array_equal(res.target[0], targets[0, winner, :sizes[0]]),
            "rerank: the returned target is not the winning candidate")
    log(f"  timed runs (ms): {[round(t, 1) for t in times]}; p50 {p50(times):.1f} ms; "
        f"peak memory {peak / 2**30:.2f} GiB")
    log("[rerank] preview_nfe=8 (rank 8 candidates at 8 evaluations, solve the winner at 32)")
    _, pcounts, preview_ms, _, ppeak = drive(
        "preview_nfe=8", model, batch, MIXTURE_SECONDS,
        {"fused_glue_attention": n_layers * (nfe + 8), "fused_residual_unit": 60,
         "flash_attention": 0, "matmul_int4": 0}, 0,
        reranking_candidates=k, preview_nfe=8, generator=gen)
    model.text_ranker = None
    del ranker.score_on_device   # the spy's closure holds the ranker: free it now
    torch.cuda.empty_cache()
    return {"p50_ms": p50(times), "runs_ms": times, "first_ms": first_ms,
            "peak_bytes": peak, "launches": counts, "winner": winner,
            "scores": dev_scores[0].tolist(), "max_abs_score_err_host": score_err,
            "preview_nfe8": {"ms": preview_ms, "peak_bytes": ppeak, "launches": pcounts}}


def quantized_probe(what, model, batch, noise, ref, expect):
    """separate(k=1) of a quantized model with the exact model's noise;
    correlation and SNR of its target against the exact target."""
    import numpy as np

    res, counts, first_ms, times, peak = drive(what, model, batch, MIXTURE_SECONDS, expect,
                                               TIMED_RUNS, noise=noise)
    a = res.target[0].astype(np.float64)
    corr = float(np.corrcoef(a, ref)[0, 1])
    snr = float(10 * np.log10(np.sum(ref * ref) / max(np.sum((a - ref) ** 2), 1e-30)))
    log(f"  timed runs (ms): {[round(t, 1) for t in times]}; p50 {p50(times):.1f} ms; "
        f"realtime factor {MIXTURE_SECONDS * 1e3 / p50(times):.2f}x; peak memory "
        f"{peak / 2**30:.2f} GiB; target vs exact bf16: correlation {corr:.4f}, "
        f"SNR {snr:.2f} dB")
    require(np.isfinite(corr) and corr >= 0.5,
            f"{what}: target correlation with the exact model {corr:.4f} < 0.5")
    return {"p50_ms": p50(times), "runs_ms": times, "first_ms": first_ms,
            "realtime_factor": MIXTURE_SECONDS * 1e3 / p50(times), "peak_bytes": peak,
            "launches": counts, "corr_vs_exact": corr, "snr_db_vs_exact": snr}


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
    cfg = SAMAudioConfig()
    k1, k2, k3, k4 = {}, {}, {}, {}
    checks = {"1": lambda: check_fused_attention(k1), "2": lambda: check_flash_attention(k2),
              "3": lambda: check_fused_conv(k3), "4": lambda: check_matmul_int4(k4, cfg)}
    if len(sys.argv) > 2 and sys.argv[1] == "--kernels":
        # a short run for work on a kernel: no model, no result line
        for number in sys.argv[2].split(","):
            checks[number]()
        record = {"fused_glue_attention": k1.get("per_launch"),
                  "fused_glue_attention_extra": k1.get("extra"),
                  "flash_attention": k2.get("per_launch"),
                  "fused_residual_unit_shapes": k3.get("per_shape"),
                  "fused_residual_unit_totals": k3.get("totals"),
                  "matmul_int4_shapes": k4.get("per_shape"), "power": smi}
        os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
        with open(os.path.join(HERE, "build", "chip_smoke_kernels.json"), "w") as f:
            json.dump(record, f, indent=1)
        log(json.dumps({k: v for k, v in record.items() if "shapes" not in k}))
        log(smi)
        return 0
    for check in checks.values():
        check()

    # 4. small model: card vs CPU, exact and int4
    small_agreement()

    # 5. main path, full width
    log("[main] default SAMAudioConfig, random weights (seed 0), bf16")
    tok = ByteFallbackTokenizer(cfg.text_encoder.vocab_size)
    model = SAMAudio.init_random(cfg, seed=0, device=DEVICE, tokenizer=tok)
    proc = SAMAudioProcessor(cfg.audio_codec.hop_length, cfg.audio_codec.sample_rate)
    n_layers, nfe = cfg.transformer.n_layers, 32
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    batch = clip_batch(proc, model.sample_rate, MIXTURE_SECONDS)
    _, counts, first_ms, times, peak = drive(
        "main", model, batch, MIXTURE_SECONDS,
        {"fused_glue_attention": n_layers * nfe, "fused_residual_unit": 36,
         "flash_attention": 0, "matmul_int4": 0}, TIMED_RUNS, generator=gen)
    log(f"  timed runs (ms): {[round(t, 1) for t in times]}; p50 {p50(times):.1f} ms; "
        f"realtime factor {MIXTURE_SECONDS * 1e3 / p50(times):.2f}x; peak memory "
        f"{peak / 2**30:.2f} GiB")

    # 6. long direct path (flash attention)
    log(f"[long] {LONG_SECONDS:g} s clip")
    _, long_counts, long_ms, long_times, long_peak = drive(
        "long", model, clip_batch(proc, model.sample_rate, LONG_SECONDS), LONG_SECONDS,
        {"flash_attention": n_layers * nfe, "fused_residual_unit": 36,
         "fused_glue_attention": 0, "matmul_int4": 0}, 1, generator=gen)
    log(f"  timed run {long_times[0]:.1f} ms; peak memory {long_peak / 2**30:.2f} GiB")

    # 7. k=8 with the CLAP rerank
    rerank = rerank_phase(model, batch, n_layers, nfe, gen)

    # 8. int4, against the exact model's target with the same noise
    noise = torch.randn((1, batch.anchor_alignment.shape[-1], 2 * cfg.audio_codec.codebook_dim),
                        generator=torch.Generator(device=DEVICE).manual_seed(5), device=DEVICE)
    ref = model.separate(batch, noise=noise).target[0].astype("float64")
    log("[int4] quantize(bits=4), separate(k=1), 10 s clip")
    model.quantize(4)
    torch.cuda.empty_cache()
    int4 = quantized_probe(
        "int4", model, batch, noise, ref,
        {"matmul_int4": sum(int4_launches_k1(cfg).values()),
         "fused_glue_attention": n_layers * nfe, "fused_residual_unit": 36,
         "flash_attention": 0})

    # 9. int8, on a fresh model with the same weights
    log("[int8] quantize(bits=8) of a fresh model (seed 0), separate(k=1), 10 s clip")
    del model
    torch.cuda.empty_cache()
    model = SAMAudio.init_random(cfg, seed=0, device=DEVICE, tokenizer=tok).quantize(8)
    int8 = quantized_probe(
        "int8", model, batch, noise, ref,
        {"matmul_int4": 0, "fused_glue_attention": n_layers * nfe,
         "fused_residual_unit": 36, "flash_attention": 0})

    def entry(res, source, replaces, launches, ms, plain, lib, bms, by, dev, lib_dev):
        # "tpu_source", "max_err" and "kernel_ms" repeat "replaces",
        # "max_abs_err" and "ms" under a second set of names that readers use
        extra = {"per_launch_at": res["extra"]} if "extra" in res else {}
        return {**extra, "name": res["name"], "route": "cuda", "source": source,
                "replaces": replaces, "tpu_source": replaces, "launches": launches,
                "max_abs_err": res["max_abs_err"], "max_err": res["max_abs_err"],
                "max_abs_err_fp32": res["fp32_err"], "tolerance": res["tolerance"],
                "ms": ms, "kernel_ms": ms, "plain_ms": plain, "bound_ms": bms,
                "bound_by": by, "library_ms": lib, "device_ms": dev,
                "library_device_ms": lib_dev,
                "ms_scope": "one separate's launches; ms and library_ms include the host "
                            "wrapper, device_ms and library_device_ms are CUDA-graph replays"}

    kernels = []
    for res, src, rep, n in (
            (k1, "sam_audio_tpu_torch/csrc/fused_attention.cu",
             "sam_audio_tpu/ops/fused_attention.py:151", counts["fused_glue_attention"]),
            (k2, "sam_audio_tpu_torch/csrc/flash_attention.cu",
             "sam_audio_tpu/ops/flash_attention.py:99", long_counts["flash_attention"])):
        ms, plain, lib, bms, by, dev, lib_dev = res["per_launch"]
        kernels.append(entry(res, src, rep, n, ms * n, plain * n, lib * n, bms * n, by,
                             dev * n, lib_dev * n))
    for res, src, rep, n in (
            (k3, "sam_audio_tpu_torch/csrc/fused_conv.cu",
             "sam_audio_tpu/ops/fused_conv.py:105", counts["fused_residual_unit"]),
            (k4, "sam_audio_tpu_torch/csrc/int4_matmul.cu",
             "sam_audio_tpu/ops/int4_matmul.py:86", int4["launches"]["matmul_int4"])):
        tot = res["totals"]
        kernels.append(entry(res, src, rep, n, tot["ms"], tot["plain"], tot["lib"],
                             tot["bound"], res["bound_by"], tot["dev"], tot["lib_dev"]))
    summary = {"main_10s": {"p50_ms": p50(times), "runs_ms": times, "first_ms": first_ms,
                            "realtime_factor": MIXTURE_SECONDS * 1e3 / p50(times),
                            "peak_bytes": peak, "launches": counts},
               "long_45s": {"ms": long_times[0], "first_ms": long_ms,
                            "peak_bytes": long_peak, "launches": long_counts},
               "rerank_k8_10s": rerank, "int4_10s": int4, "int8_10s": int8,
               "power": smi}
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "chip_smoke.json"), "w") as f:
        json.dump({"kernels": kernels, "summary": summary,
                   "fused_residual_unit_shapes": k3["per_shape"],
                   "matmul_int4_shapes": k4["per_shape"]}, f, indent=1)
    log(json.dumps({"summary": summary}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
