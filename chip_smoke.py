#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sam_audio_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels 1,3    (phases 1-3 for the listed kernels, then stop)
    python3 chip_smoke.py --phase parallel (phases 1-2 and 18, then stop)

Phases (any failure exits non-zero):
  1. device  — require CUDA; print the card's name and power limit; TF32 off.
  2. build   — compile the CUDA kernels in sam_audio_tpu_torch/csrc with nvcc
               (one process per source, in parallel). Then the host runtime
               (runtime/native.py): its library built with g++ from
               csrc/host and loaded, its batch planner against the
               serving layer's (runtime.plan_batches), a
               float32 and an EXTENSIBLE WAV through audio_io.load_audio with
               ffmpeg unreachable, its resampler against resample_np.
  3. kernels — hold each kernel against its plain PyTorch version on the card
               (bf16 at the main-path shapes, plus an fp32 case; padded and
               fully masked rows for the attention kernels, dilations 1/3/9
               for the residual unit (and fp32 at every main-path shape,
               the 36 launches of an fp32 separate, within 1e-4 and two
               runs bit-equal), 250/2000/14 tokens for the int4
               product, whose two runs must give the same bits); time kernel,
               plain version and one PyTorch library call as a yardstick, the
               kernel and the library call also with the host out of the
               window (`device_ms`: a CUDA graph of the calls, replayed).
               Each kernel's fp32 body is also timed at its paths' shapes
               (kernel 1 at B = 1, 4, 8 x 250 x 16 heads; kernel 2 at 1125
               keys; kernel 3 at the 24 main shapes; kernel 4 at 250 tokens)
               beside its plain version, the library call in fp32 (TF32
               off) and two labelled bounds: as fp32 FMAs at 67 TFLOP/s and
               as the three TF32 products of split TF32 at 495.
               Kernels 1 and 2 under autograd (their Functions: the kernel
               forward, the plain version's VJP) at the training shapes
               (kernel 1: B=4, T=250; kernel 2: B=1, T=1125; bf16 and fp32):
               the Function's output against the plain version (bf16 2e-2,
               fp32 1e-4), and dq, dk, dv (and kernel 1's norm weights'
               gradients) against autograd of the plain version on the card,
               exactly: the backward is the plain version's VJP, so this
               holds the wiring, not a measured error; forward + backward
               timed against the plain version and against SDPA forward +
               backward after norm and RoPE; kernels 3 and 4 must raise
               under grad and launch nothing.
  4. small   — a small model in fp32 through separate() on the card (the
               kernels) and on the CPU (the plain versions): must agree;
               then a clip past max_direct_seconds streamed through 3
               windows, with the same window noise on both; then a visual
               prompt through a small PE tower (k=1) on both; then
               save_pretrained -> load_sam_audio onto the card, whose
               visual separate must be bit-identical; then the same after
               quantize(bits=4).
  5. main    — the default SAMAudioConfig (sam-audio-large widths), random
               weights from a seed, bf16, a 10 s 48 kHz mixture with a text
               prompt, separate(k=1): one counted run, then timed runs.
  6. long    — a 45 s clip (1125 frames) through separate(k=1): the flash
               kernel's path.
  7. rerank  — the same model, separate(reranking_candidates=8) with a CLAP
               ranker of random weights scoring on the card; the winner must
               be the argmax of the host scoring path on the same decoded
               candidates. Then once with preview_nfe=8.
  8. stream  — a 60 s clip with a text prompt and two anchors past
               max_direct_seconds=10: separate() streams it through 7 windows
               of 10 s, one window a call (streaming_batch_windows=1), then
               four (groups of 4 and 3); the two targets must agree.
  9. judge   — a SAMAudioJudgeModel of the default config (ModernBERT-base,
               two PE-AV towers of 24 x 1024, the DAC-VAE encoder), random
               weights, bf16, as the text ranker of separate(k=8) on the
               10 s clip: its device scores held against its host path on
               the same candidates, the winner the host path's argmax where
               the host scores decide one (check_ranking); an ensemble
               (judge + sound activity) through the host path, whose scores
               must be the weighted sum of its members'; the int8 judge on
               the same candidates; the same weights in fp32 (host and
               device within 1e-5).
 10. int4    — quantize(bits=4), separate(k=1) on the 10 s clip (every DiT
               linear through the int4 kernel), held against the exact bf16
               model with the same noise (correlation and SNR).
 11. int8    — the same probe after quantize(bits=8) of a fresh model.
 12. visual  — a fresh model of main's weights (its video gate opened to
               0.5: at init it is 0, which would make the video inert) with
               a PE-Core-L14-336 tower (PerceptionEncoderConfig: 24 x 1024,
               16 heads, 336 px, 577 tokens a frame; random weights, seed 0,
               bf16); the 10 s clip with 250 masked uint8 frames of 360 x
               640 (mask_videos): separate(k=1) counted and timed, the PE
               encode timed alone; visual_stride=4; k=8 ranked on the card
               by ImageBind (imagebind_huge widths, random weights), held
               against its host path (check_ranking); quantize(bits=8) of a
               fresh visual model, which quantizes the PE tower too,
               against the bf16 target with the same noise.
 13. visual stream — a 30 s clip with 750 frames past max_direct_seconds=10
               (4 windows) at streaming_batch_windows 1 and 4; the two
               targets must agree.
 14. spans   — main's weights with a PEAudioFrame span predictor of the
               default config (24 x 1024, 16 heads; random, seed 0, fp32 as
               the loader builds it; its head's bias set so that some
               frames are active):
               separate(k=1, predict_spans=True) on the 10 s clip counted
               (kernel 1: 512, kernel 3: 36 + 12 for the predictor's encode)
               and timed on fresh batches, the predictor timed alone; with one
               injected noise it must equal separate() of the batch anchored at
               the predicted spans, bit for bit.
 15. serve   — main's model behind a ContinuousBatcher (max_batch 4, 2 s
               buckets, 50 ms wait, max_seconds 10, long_policy "stream" up to
               40 s) and a SeparationServer on 127.0.0.1:0, warmed at 6 and
               10 s: 8 concurrent requests (6 and 10 s; one a 44.1 kHz WAV),
               a 30 s request (streamed), a 45 s one (413), a malformed body
               (400); /v1/stats must show 9 served, 1 streamed, 0 failed, and
               kernel 1 launch 512 per group and per window. Then the same 8
               through SeparationPipeline.run.
 16. eval    — the eval harness (sam_audio_tpu_torch.eval): first phase 4's
               small model through run_eval on the card and on the CPU with
               the same injected noise (4 items of 0.2 s), scored by small
               Judge, AesPredictor and CLAP towers and, in a second run, by
               a narrow AudioboxAesthetics (its WavLM tower), whose averaged
               metrics must agree;
               then main's model (seed 0, bf16) with phase 7's CLAP ranker,
               scored by phase 9's judge, an AudioboxAesthetics at WavLM-base
               widths and phase 7's CLAP model (all random, built with
               model=): run_eval over a setting registered here alone,
               "synthetic-10s" (8 items of 10 s) twice, the second run
               warm, at batch_size=4 and reranking_candidates=8, then
               "synthetic-span" at its
               defaults, each counted (kernel 1: 512 a separate; kernel 3:
               48 a separate of 32 candidates, whose targets decode in two
               chunks of 16, plus 12 for the judge's encoder a batch), its
               averages finite and its JSON written; the WavLM encode of
               8 x 10 s chunks timed; last the ImageBind metric on phase 12's
               winning target and video with the imagebind_huge tower, equal
               to phase 12's host ranking score of that pair.
 17. train   — training at full width: the default SAMAudioConfig (DiT 2048
               x 16, 1.15B trainable parameters; T5-base; DAC-VAE 48 kHz),
               fp32 master weights from seed 0, bf16 compute, dropout 0.1
               from a seeded generator, remat="full". Eight 10 s examples
               (mixture = target + residual, half with two anchors) through
               ShardWriter -> ShardedRecordDataset -> iter_batches ->
               FlowMatchingDataPipeline (kernel 3: 12 a batch of 4), the
               Trainer (AdamW, warmup + cosine, EMA 0.999, batch 4) for 4
               steps (kernel 1: 32 a step, 16 forward + 16 recomputed):
               losses finite, every DiT leaf changed, codec and T5
               bit-identical; each step, each batch's featurization and the
               peak memory timed. A checkpoint at step 2 restored into a
               fresh Trainer: its steps 3-4 within 1e-6 of the run's (step 4
               under torch.profiler: device busy ms, idle share, kernel
               groups). The EMA exported, loaded with load_sam_audio and
               separated (k=1, 10 s). LoRA rank 16 over attention for 2
               steps: only the adapters move, the merged model separates.
               The native span predictor for 2 steps on the same records
               (kernel 3: 12 a batch). Then
               `python -m sam_audio_tpu_torch.train --synthetic 4
               --random-init --config <small> --batch-size 2 --device cuda
               --ckpt-dir ... --export-dir ...` must exit 0.
 18. parallel — torch.distributed: first the unsharded references in this
               process (main's model: 10 s at k=1, the same with its noise
               scaled by 1 + 2^-8 (the correlations' floor), k=8 with phase
               7's CLAP ranker, 48 s = 1,200 frames through kernel 2, and
               10 s after quantize(4)), then 4 ranks: NCCL one rank a card with
               four or more cards, else gloo with the 4 ranks on one card
               (parallel/mesh.init_distributed's rule; under gloo the
               collectives that parallel/comm.py passes CUDA tensors to are
               held against gloo on host copies). Each rank: (a)
               phase 4's small fp32 model at dp2 x tp2 (k=1, k=4), int8
               under tp2 and sp4 (the ring), each within 2e-3 of the
               unsharded separate on the same card; two dp2 x tp2 Trainer
               steps against one rank's, the step-2 checkpoint restored at
               dp4 x tp1 and a third step (2e-3); (b) main's model at
               dp2 x tp2 on the 10 s clip at k=1 and k=8 (the winner the
               unsharded one where the score margin exceeds the bf16
               spread), int4 under tp2, and sp4 on the 48 s clip (300 frames
               a rank): finite, of the clip's length, correlation >= 0.99
               with the unsharded target (k=1 also against an unsharded run
               in the rank); quantize(8) and quantize(4) after shard(tp=2)
               bit-identical to quantize-then-shard on every leaf; sp4 over
               a shard(tp=2) model (its DiT gathered whole) on the 48 s clip
               against the unsharded target, and the int4 tree's separate;
               (b') the dp2 x tp2 model served from rank 0: the serve phase's
               8 concurrent 6-10 s requests through a ContinuousBatcher over
               parallel.serve.Lockstep while ranks 1-3 follow, each reply
               >= 0.99 correlated with the unsharded batcher's (same global
               seed; 2 groups of 4). Sharded serving and sp over tp run at
               CUT_LAYERS = 4 layers (full width), against unsharded
               references at that depth; (c) two dp2 x tp2
               Trainer steps at full width (TRAIN_LAYERS layers), step 1's
               dropout masks (digests) equal to this rank's blocks of a
               one-rank step's, run in this process before the world.
               Every rank's launches (kernel
               1 on H/tp heads and kernel 3 at k=1: 512 / 36, kernel 4 under
               int4), peak memory and wall ms are logged. With fewer than
               four cards, a one-rank NCCL world runs (a) once more and the
               NCCL collectives; last, `python -m torch.distributed.run
               --standalone --nproc-per-node 4 -m sam_audio_tpu_torch.train
               --synthetic 4 --random-init --config <small> --batch-size 4
               --dp 2 --tp 2 --device cuda --ckpt-dir ... --export-dir ...`
               must exit 0. Ranks that share a card measure no scaling.
Phase 4 also takes two Trainer steps of the small fp32 model (dropout 0, no
warmup) on the card and on the CPU with the same t and x0, at 200 frames
(kernel 1) and 1100 (kernel 2): every trainable leaf's gradient card vs CPU
within 1e-4 of the leaf's largest, losses and parameters within 2e-3, every
layer's wq and q_norm given a gradient on the card, 8 attention launches (2
steps x 2 layers x forward and recomputation), and remat="dots" against
"full".
Phase 3 also runs kernel 3 at widths that are not multiples of 32
(NARROW_WIDTHS, padded to the next one in the kernel), bf16 and fp32, B = 1
and 8, each timed against its bound and the F.conv1d chain.
Phase 4 also separates with tiny_test_config (fp32; kernel 3 at 4 and 8
channels) on the card and on the CPU (SMALL_TOL).
Phase 4 also runs the port's three examples (python -m
sam_audio_tpu_torch.examples.{span_prompting,visual_prompting,
train_flow_matching} --device cuda) in this process at their small widths
(the prompting ones at the JAX examples' codec, encoder 8 / decoder 64),
each counted (kernel 3 in all, kernel 1 in the two prompting ones).
Phase 4 also attaches a narrow native span predictor to the small model:
logits card vs CPU (2e-3), the same spans with no frame within 1e-3 of the
threshold, separate(predict_spans=True) on both; its snapshot with
span_predictor/ reloaded on the card, and `python -m
sam_audio_tpu_torch.separate_cli --device cuda --predict-spans --seed 0` on
it against the in-process separate (one 16-bit step).
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
PEAK_TF32 = 495e12      # H100 SXM dense TF32 tensor-core FLOP/s
HBM_BPS = 3.35e12       # H100 SXM HBM3 bytes/s
DEVICE = "cuda"
MIXTURE_SECONDS = 10.0
LONG_SECONDS = 45.0
STREAM_SECONDS = 60.0
STREAM_WINDOW_SECONDS = 10.0
TIMED_RUNS = 3
EVAL_SECONDS = 10.0     # the eval phase's script-local setting "synthetic-10s"


def log(*args):
    print(*args, flush=True)


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16):
    """The least time for work of `flops` operations (at `peak` FLOP/s, bf16
    tensor cores by default) moving `nbytes`."""
    t_ops = flops / peak
    t_bytes = nbytes / HBM_BPS
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def fp32_bounds(flops: float, nbytes: float) -> dict:
    """The two bounds of an fp32 body, labelled: its work as fp32 FMAs at
    PEAK_FP32 (the parent bodies' arithmetic), and as the three TF32
    tensor-core products of split TF32 at PEAK_TF32 (the redesigned bodies',
    which can run under the first); each against the bytes at HBM_BPS."""
    fma, fma_by = bound_ms(flops, nbytes, PEAK_FP32)
    tf32, tf32_by = bound_ms(3 * flops, nbytes, PEAK_TF32)
    return {"bound_fma_ms": fma, "bound_fma_by": fma_by, "bound_3xtf32_ms": tf32,
            "bound_3xtf32_by": tf32_by}


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
    # streaming at streaming_batch_windows=4: four full 10 s windows a launch
    q, k, v, mask = _attn_inputs(4, 250, h, d, torch.bfloat16, seed=4, masked_rows=False)
    errs.append(check_close("bf16 B=4 T=250 (streaming, 4 windows a call)",
                            fused_glue_attention(q, k, v, qw, kw, cos, sin, mask),
                            fused_glue_attention_plain(q, k, v, qw, kw, cos, sin, mask),
                            2e-2, 2e-2))
    # the k=8 rerank's shape (B=8, bf16), streaming's B=4 and the int4/int8
    # modes' fp32 path
    extra = {}
    for what, b, dtype, elem, peak in (("bf16 B=8", 8, torch.bfloat16, 2, PEAK_BF16),
                                       ("bf16 B=4", 4, torch.bfloat16, 2, PEAK_BF16),
                                       ("fp32 B=1", 1, torch.float32, 4, PEAK_FP32),
                                       ("fp32 B=4", 4, torch.float32, 4, PEAK_FP32),
                                       ("fp32 B=8", 8, torch.float32, 4, PEAK_FP32)):
        q, k, v, mask = _attn_inputs(b, t, h, d, dtype, seed=2, masked_rows=False)
        xms = time_ms(lambda: fused_glue_attention(q, k, v, qw, kw, cos, sin, mask))
        xdev = device_ms(lambda: fused_glue_attention(q, k, v, qw, kw, cos, sin, mask))
        qn = _norm_rope(q, qw, cos, sin, 1e-5).transpose(1, 2)
        kn = _norm_rope(k, kw, cos, sin, 1e-5).transpose(1, 2)
        vt = v.transpose(1, 2)
        xlib = device_ms(lambda: F.scaled_dot_product_attention(qn, kn, vt))
        nbytes = b * 4 * t * h * d * elem + 2 * d * 4 + t * d * 4 + b * t
        xb, xby = bound_ms(b * flops, nbytes, peak)
        extra[what] = dict(ms=xms, device_ms=xdev, library_device_ms=xlib, bound_ms=xb,
                           bound_by=xby)
        line = (f"  ({b}, 250, 16, 128) {dtype}: kernel {xms:.4f} ms (device {xdev:.4f}), SDPA "
                f"device {xlib:.4f} ms, bound {xb:.5f} ms ({xby})")
        if dtype == torch.float32:
            # the fp32 body (3xTF32): plain, SDPA with the host, both bounds
            bounds = fp32_bounds(b * flops, nbytes)
            extra[what].update(
                bounds,
                plain_ms=time_ms(lambda: fused_glue_attention_plain(q, k, v, qw, kw, cos, sin,
                                                                    mask), iters=5),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(qn, kn, vt)))
            line += (f"; plain {extra[what]['plain_ms']:.4f} ms, SDPA {extra[what]['library_ms']:.4f}"
                     f" ms; bound as fp32 FMAs {bounds['bound_fma_ms']:.5f} ms, as 3xTF32 "
                     f"{bounds['bound_3xtf32_ms']:.5f} ms ({bounds['bound_3xtf32_by']})")
        log(line)
    results["extra"] = extra
    check_fused_attention_grad(results)
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
    # the fp32 body (FMA products): a quantized separate of a direct clip over 40 s
    q, k, v = (x.float() for x in (q, k, v))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    rec = dict(fp32_bounds(flops, 4 * t * h * d * 4 + t),
               ms=time_ms(lambda: flash_attention(q, k, v, mask)),
               device_ms=device_ms(lambda: flash_attention(q, k, v, mask)),
               plain_ms=time_ms(lambda: flash_attention_plain(q, k, v, mask), iters=3),
               library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
               library_device_ms=device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)))
    results["fp32"] = {"(1, 1125, 16, 128)": rec}
    log(f"  (1, 1125, 16, 128) fp32: kernel {rec['ms']:.4f} ms (device {rec['device_ms']:.4f}), "
        f"plain {rec['plain_ms']:.4f} ms, SDPA {rec['library_ms']:.4f} ms (device "
        f"{rec['library_device_ms']:.4f}); bound as fp32 FMAs {rec['bound_fma_ms']:.5f} ms, as "
        f"3xTF32 {rec['bound_3xtf32_ms']:.5f} ms")
    check_flash_attention_grad(results)
    results.update(name="flash_attention",
                   per_launch=(ms, plain, lib, bms, by, dev, lib_dev),
                   max_abs_err=max(errs), tolerance="bf16 atol 2e-2 + rtol 2e-2; "
                   "fp32 atol 1e-4 + rtol 1e-4")


# (C, T) of the residual units of a 10 s 48 kHz clip, and how many launches
# of each one separate makes (1 encode + 2 decodes; 3 dilations each)
ENCODER_SHAPES = ((64, 480000), (128, 240000), (256, 30000), (512, 3000))
DECODER_SHAPES = ((768, 3000), (384, 30000), (192, 240000), (96, 480000))
# widths that are not multiples of 32 (kernel 3 pads them to the next one):
# the JAX examples' demo codec (encoder 8: units of 8 / 16 / 32 / 64; decoder
# 64: 32 / 16 / 8 / 4) and tiny_test_config's (4, 8), at ragged lengths
NARROW_WIDTHS = (4, 8, 16, 24, 48, 80, 200)   # 200: the padded split (chunk 32)
NARROW_T = 24001


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
    # the judge's codec encoder on k=8 candidates: the encoder's shapes at B=8
    judge = {"ms": 0.0, "dev": 0.0, "lib_dev": 0.0, "bound": 0.0, "flops": 0.0, "bytes": 0.0}
    for c, t in ENCODER_SHAPES:
        x = torch.randn(8, c, t, generator=g, device=DEVICE).to(torch.bfloat16)
        for dil in (1, 3, 9):
            p = unit(c, seed=c + dil)
            out = fused_residual_unit(p, x, dil, torch.bfloat16)
            ref = fused_residual_unit_plain(*residual_unit_operands(p, x, torch.bfloat16), dil)
            torch.cuda.synchronize()
            errs.append(check_close(f"bf16 B=8 C={c} T={t} dil={dil} (judge encoder, k=8)",
                                    out, ref, 5e-2, 2e-2))
            del out, ref
            ms = time_ms(lambda: fused_residual_unit(p, x, dil, torch.bfloat16), iters=2)
            dev = device_ms(lambda: fused_residual_unit(p, x, dil, torch.bfloat16), iters=2)
            lib_dev = device_ms(lambda: library_chain(p, x, dil), iters=2)
            flops = 8 * 2 * 8 * c * c * t
            nbytes = 8 * 2 * c * t * 2 + 8 * c * c * 2 + 4 * c * 4
            bms, _ = bound_ms(flops, nbytes)
            for key, val in (("ms", ms), ("dev", dev), ("lib_dev", lib_dev), ("bound", bms),
                             ("flops", flops), ("bytes", nbytes)):
                judge[key] += val
            per_shape.append(dict(B=8, C=c, T=t, dilation=dil, ms=ms, device_ms=dev,
                                  library_device_ms=lib_dev, bound_ms=bms))
            log(f"    kernel {ms:.3f} ms (device {dev:.3f}), conv1d chain device "
                f"{lib_dev:.3f} ms, bound {bms:.4f} ms")
        del x
    torch.cuda.empty_cache()
    results["judge_encoder_k8"] = judge
    x = torch.randn(2, 64, 3000, generator=g, device=DEVICE)
    for dil in (1, 3, 9):
        p = unit(64, seed=dil)
        out = fused_residual_unit(p, x, dil, torch.float32)
        ref = fused_residual_unit_plain(*residual_unit_operands(p, x, torch.float32), dil)
        torch.cuda.synchronize()
        results["fp32_err"] = max(results.get("fp32_err", 0.0),
                                  check_close(f"fp32 C=64 T=3000 dil={dil}", out, ref,
                                              1e-4, 1e-4))
    results["fp32"] = check_fp32_main(unit, library_chain, g)
    results["fp32_err"] = max(results["fp32_err"], results["fp32"]["max_abs_err"])
    results["narrow"] = check_narrow_widths(unit, library_chain, g)
    p = unit(64, seed=1)
    xg = torch.randn(1, 64, 3000, generator=g, device=DEVICE, requires_grad=True)
    check_refuses_grad("fused_residual_unit",
                       lambda: fused_residual_unit(p, xg, 1, torch.bfloat16))
    _, by = bound_ms(totals["flops"], totals["bytes"])
    results.update(name="fused_residual_unit", totals=totals, bound_by=by,
                   max_abs_err=max(errs), per_shape=per_shape,
                   tolerance="bf16 atol 5e-2 + rtol 2e-2; fp32 atol 1e-4 + rtol 1e-4")


def check_fp32_main(unit, library_chain, g):
    """Kernel 3's fp32 body (3xTF32 tensor-core products) at every main-path
    shape (ENCODER_SHAPES + DECODER_SHAPES, dilations 1/3/9, B = 1: the 36
    launches of an fp32 separate, the encoder's 12 those of the span
    predictor's encode): one launch a call, within 1e-4 of the plain
    version, two runs bit-equal; ms and device ms beside the plain version,
    the F.conv1d chain (cuDNN, TF32 off) and both bounds (fp32 FMAs, 3xTF32).
    Returns the per-shape records and the weighted totals."""
    import torch

    from sam_audio_tpu_torch.ops.fused_conv import (
        fp32_chunk, fused_residual_unit, fused_residual_unit_plain, residual_unit_operands)

    records, err = [], 0.0
    totals = {k: 0.0 for k in ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
                               "bound_fma_ms", "bound_3xtf32_ms")}
    encoder = dict(totals)
    for c, t in ENCODER_SHAPES + DECODER_SHAPES:
        x = torch.randn(1, c, t, generator=g, device=DEVICE)
        for dil in (1, 3, 9):
            p = unit(c, seed=2000 + c + dil)
            n = fused_residual_unit.launches
            out = fused_residual_unit(p, x, dil, torch.float32)
            require(fused_residual_unit.launches == n + 1, f"fp32 C={c} dil={dil}: no launch")
            ops = residual_unit_operands(p, x, torch.float32)
            ref = fused_residual_unit_plain(*ops, dil)
            torch.cuda.synchronize()
            e = check_close(f"fp32 C={c} T={t} dil={dil} (chunk {fp32_chunk(c)})", out, ref,
                            1e-4, 1e-4)
            err = max(err, e)
            require(torch.equal(out, fused_residual_unit(p, x, dil, torch.float32)),
                    f"fp32 C={c} dil={dil}: two runs on one input differ")
            del out, ref
            reps = 2 if c * t > 3e7 else 5
            rec = dict(fp32_bounds(2 * 8 * c * c * t, 2 * c * t * 4 + 8 * c * c * 4 + 4 * c * 4),
                       C=c, T=t, dilation=dil, chunk=fp32_chunk(c), max_abs_err=e,
                       ms=time_ms(lambda: fused_residual_unit(p, x, dil, torch.float32),
                                  iters=reps),
                       device_ms=device_ms(lambda: fused_residual_unit(p, x, dil, torch.float32),
                                           iters=reps),
                       plain_ms=time_ms(lambda: fused_residual_unit_plain(*ops, dil), iters=reps),
                       library_ms=time_ms(lambda: library_chain(p, x, dil), iters=reps),
                       library_device_ms=device_ms(lambda: library_chain(p, x, dil), iters=reps))
            records.append(rec)
            weight = 1 if (c, t) in ENCODER_SHAPES else 2
            for key in totals:
                totals[key] += weight * rec[key]
                if (c, t) in ENCODER_SHAPES:
                    encoder[key] += rec[key]
            log(f"    kernel {rec['ms']:.3f} ms (device {rec['device_ms']:.3f}), plain "
                f"{rec['plain_ms']:.3f} ms, conv1d chain {rec['library_ms']:.3f} ms (device "
                f"{rec['library_device_ms']:.3f}); bound as fp32 FMAs {rec['bound_fma_ms']:.4f} ms, "
                f"as 3xTF32 {rec['bound_3xtf32_ms']:.4f} ms")
        del x
    torch.cuda.empty_cache()
    log(f"  fp32, the 36 launches of a separate: device {totals['device_ms']:.2f} ms (conv1d "
        f"chain {totals['library_device_ms']:.2f}; bounds {totals['bound_fma_ms']:.2f} as FMAs, "
        f"{totals['bound_3xtf32_ms']:.2f} as 3xTF32); the encoder's 12: device "
        f"{encoder['device_ms']:.2f} ms")
    return {"per_shape": records, "totals_36": totals, "totals_encoder_12": encoder,
            "max_abs_err": err}


def check_narrow_widths(unit, library_chain, g):
    """Kernel 3 at NARROW_WIDTHS, dilations 1/3/9, B = 1 and 8, T = NARROW_T:
    one launch a call (the padded route, no plain fallback), bf16 against the
    plain version at 5e-2 / 2e-2 and fp32 at 1e-4, two runs bit-equal; the
    bf16 kernel's device ms beside its bound and the F.conv1d chain's device
    ms. Returns one record a shape."""
    import torch

    from sam_audio_tpu_torch.ops.fused_conv import (
        bf16_chunk, fused_residual_unit, fused_residual_unit_plain, padded_width,
        residual_unit_operands)

    records = []
    for c in NARROW_WIDTHS:
        for b in (1, 8):
            x = torch.randn(b, c, NARROW_T, generator=g, device=DEVICE)
            for dil in (1, 3, 9):
                p = unit(c, seed=1000 + c + dil)
                rec = dict(B=b, C=c, C_padded=padded_width(c), chunk=bf16_chunk(c), T=NARROW_T,
                           dilation=dil)
                for dtype, atol, rtol in ((torch.bfloat16, 5e-2, 2e-2),
                                          (torch.float32, 1e-4, 1e-4)):
                    xd = x.to(dtype)
                    n = fused_residual_unit.launches
                    out = fused_residual_unit(p, xd, dil, dtype)
                    require(fused_residual_unit.launches == n + 1,
                            f"fused_residual_unit C={c}: no launch")
                    ref = fused_residual_unit_plain(*residual_unit_operands(p, xd, dtype), dil)
                    torch.cuda.synchronize()
                    tag = "bf16" if dtype == torch.bfloat16 else "fp32"
                    rec[f"max_abs_err_{tag}"] = check_close(
                        f"{tag} B={b} C={c} T={NARROW_T} dil={dil} (padded to "
                        f"{padded_width(c)})", out, ref, atol, rtol)
                    require(torch.equal(out, fused_residual_unit(p, xd, dil, dtype)),
                            f"fused_residual_unit C={c} {tag}: two runs on one input differ")
                xb = x.to(torch.bfloat16)
                dev = device_ms(lambda: fused_residual_unit(p, xb, dil, torch.bfloat16), iters=5)
                lib_dev = device_ms(lambda: library_chain(p, xb, dil), iters=5)
                flops = b * 2 * 8 * c * c * NARROW_T
                nbytes = b * 2 * c * NARROW_T * 2 + 8 * c * c * 2 + 4 * c * 4
                bms, by = bound_ms(flops, nbytes)
                rec.update(device_ms=dev, library_device_ms=lib_dev, bound_ms=bms, bound_by=by)
                records.append(rec)
                log(f"    bf16 kernel device {dev:.4f} ms, conv1d chain device {lib_dev:.4f} ms, "
                    f"bound {bms:.5f} ms ({by})")
    return records


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
        # the fp32 body (FMA products): an fp32 model after quantize(4), 250 tokens
        x = torch.randn(250, din, generator=g, device=DEVICE)
        w_deq32 = w_deq.float()
        rec = dict(fp32_bounds(2 * 250 * din * out,
                               250 * din * 4 + w4.numel() + s.numel() * 4 + 250 * out * 4),
                   out=out, din=din, tokens=250, launches_per_separate_k1=k1.get((out, din, 250), 0),
                   ms=time_ms(lambda: matmul_int4(x, w4, s)),
                   device_ms=device_ms(lambda: matmul_int4(x, w4, s)),
                   plain_ms=time_ms(lambda: matmul_int4_plain(x, w4, s), iters=5),
                   library_ms=time_ms(lambda: torch.matmul(x, w_deq32.t())),
                   library_device_ms=device_ms(lambda: torch.matmul(x, w_deq32.t())))
        results.setdefault("fp32", []).append(rec)
        log(f"    fp32 tokens=250: kernel {rec['ms']:.4f} ms (device {rec['device_ms']:.4f}), plain "
            f"{rec['plain_ms']:.4f} ms, fp32 matmul of the dequantized weight "
            f"{rec['library_ms']:.4f} ms (device {rec['library_device_ms']:.4f}); bound as fp32 "
            f"FMAs {rec['bound_fma_ms']:.5f} ms, as 3xTF32 {rec['bound_3xtf32_ms']:.5f} ms")
        if (out, din) == (dim, dim):
            y = matmul_int4(x, w4, s)
            ref = matmul_int4_plain(x, w4, s)
            torch.cuda.synchronize()
            results["fp32_err"] = check_close(f"fp32 tokens=250 (out, in)=({out}, {din})", y,
                                              ref, 1e-4, 1e-4)
            xg = x.to(torch.bfloat16).requires_grad_(True)
            check_refuses_grad("matmul_int4", lambda: matmul_int4(xg, w4, s))
    _, by = bound_ms(totals["flops"], totals["bytes"])
    results.update(name="matmul_int4", totals=totals, bound_by=by, max_abs_err=max(errs),
                   per_shape=per_shape,
                   tolerance="bf16 atol 2e-2 + rtol 2e-2; fp32 atol 1e-4 + rtol 1e-4")


def fwd_bwd(fn, inputs, w):
    """One forward of fn(*inputs) and the backward of <out, w>: (out, grads)."""
    import torch

    out = fn(*inputs)
    return out, torch.autograd.grad((out.float() * w).sum(), inputs)


def check_attention_grad(results, name, launch, plain, library, make_inputs, shapes):
    """A kernel's autograd Function (kernel forward, the plain version's VJP)
    on the card: its forward output held against the plain version's at the
    forward tolerance, its gradients against autograd of the plain version,
    and forward + backward timed against the plain version's and against
    SDPA's after norm and RoPE (the library yardstick, never on the path).
    The gradients are equal by construction (the backward reruns the plain
    version on the saved inputs and never reads the kernel's output), so
    their check holds the Function's wiring (argument order, which inputs
    get a gradient), not a measured error. `make_inputs(b, t, dtype)` ->
    (inputs needing grad, the rest of the call's arguments, SDPA's leaf
    inputs); `shapes`: (b, t, dtype, forward tolerance)."""
    import torch

    log(f"[kernels] {name}: gradients through its autograd Function")
    record = {}
    for b, t, dtype, tol in shapes:
        inputs, rest, lib_inputs = make_inputs(b, t, dtype)
        w = torch.randn(inputs[0].shape, generator=torch.Generator(device=DEVICE).manual_seed(t),
                        device=DEVICE)
        before = launch.launches
        out, got = fwd_bwd(lambda *x: launch(*x, *rest), inputs, w)
        require(launch.launches == before + 1, f"{name}: the gradient run launched "
                f"{launch.launches - before} kernels, expected 1")
        require(out.grad_fn is not None, f"{name}: the Function's output has no grad_fn")
        ref_out, ref = fwd_bwd(lambda *x: plain(*x, *rest), inputs, w)
        torch.cuda.synchronize()
        fwd_err = check_close(f"forward {dtype} B={b} T={t}", out, ref_out, tol, tol)
        # equal by construction: any difference is a wiring fault
        err = max(check_close(f"grad {dtype} B={b} T={t} d{i}", a, r, 0.0, 0.0)
                  for i, (a, r) in enumerate(zip(got, ref)))
        require(all(bool(g.abs().max() > 0) for g in got), f"{name}: a zero gradient")
        ms = time_ms(lambda: fwd_bwd(lambda *x: launch(*x, *rest), inputs, w), iters=10)
        plain_ms = time_ms(lambda: fwd_bwd(lambda *x: plain(*x, *rest), inputs, w), iters=3)
        lib_ms = time_ms(lambda: fwd_bwd(library, lib_inputs, w.transpose(1, 2)), iters=10)
        h, d = inputs[0].shape[2], inputs[0].shape[3]
        elem = inputs[0].element_size()
        # forward 2 products, backward 4 (dV, dP, dQ, dK); q, k, v, dout read and
        # out, dq, dk, dv written once
        bms, by = bound_ms(12 * b * t * t * d * h, 8 * b * t * h * d * elem,
                           PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32)
        key = f"{str(dtype).split('.')[-1]} B={b} T={t}"
        record[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                           bound_by=by, forward_max_abs_err=fwd_err, forward_tolerance=tol,
                           grad_max_abs_err=err,
                           grad_check="structural: the backward is the plain version's VJP "
                                      "on the saved inputs; exact equality holds the wiring")
        log(f"  forward + backward {key}: Function {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"SDPA {lib_ms:.3f} ms, bound {bms:.4f} ms ({by})")
    results["fwd_bwd"] = record


def check_fused_attention_grad(results):
    """Kernel 1 at the training shape (B=4, T=250, H=16, D=128: one 10 s
    crop batch of 4), bf16 and fp32; q, k, v, both norm weights."""
    import torch
    import torch.nn.functional as F

    from sam_audio_tpu_torch.ops.fused_attention import (
        _norm_rope, fused_glue_attention, fused_glue_attention_plain)
    from sam_audio_tpu_torch.ops.rope import precompute_rope

    cos, sin = precompute_rope(128, 512, 20000, device=DEVICE)

    def make(b, t, dtype):
        q, k, v, mask = _attn_inputs(b, t, 16, 128, dtype, seed=b + t)
        g = torch.Generator(device=DEVICE).manual_seed(3)
        qw, kw = (1 + 0.1 * torch.randn(128, generator=g, device=DEVICE) for _ in range(2))
        inputs = [x.requires_grad_(True) for x in (q, k, v, qw, kw)]
        lib = [_norm_rope(x.detach(), wt.detach(), cos, sin, 1e-5).transpose(1, 2)
               .requires_grad_(True) for x, wt in ((q, qw), (k, kw))]
        lib.append(v.detach().transpose(1, 2).requires_grad_(True))
        return inputs, (cos, sin, mask), lib

    check_attention_grad(results, "fused_glue_attention", fused_glue_attention,
                         fused_glue_attention_plain, F.scaled_dot_product_attention, make,
                         ((4, 250, torch.bfloat16, 2e-2), (4, 250, torch.float32, 1e-4)))


def check_flash_attention_grad(results):
    """Kernel 2 at a training example over 40 s (B=1, T=1125), bf16 and
    fp32; q, k, v."""
    import torch
    import torch.nn.functional as F

    from sam_audio_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    def make(b, t, dtype):
        q, k, v, mask = _attn_inputs(b, t, 16, 128, dtype, seed=t + 1, masked_rows=False)
        inputs = [x.requires_grad_(True) for x in (q, k, v)]
        lib = [x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v)]
        return inputs, (mask,), lib

    check_attention_grad(results, "flash_attention", flash_attention, flash_attention_plain,
                         F.scaled_dot_product_attention, make,
                         ((1, 1125, torch.bfloat16, 2e-2), (1, 1125, torch.float32, 1e-4)))


def check_refuses_grad(name, call):
    """A kernel without a gradient must raise under autograd, not return a
    tensor cut from the graph, and launch nothing."""
    import torch

    fn = {fn.__name__: fn for fn in kernel_wrappers()}[name]
    before = fn.launches
    try:
        call()
    except RuntimeError as e:
        require("no gradient" in str(e), f"{name}: raised {e!r}")
        require(fn.launches == before, f"{name}: launched under grad")
        log(f"  {name} under grad: raises RuntimeError, no launch -> ok")
        return
    finally:
        torch.cuda.synchronize()
    raise AssertionError(f"{name}: returned a tensor under grad instead of raising")


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
    small_streaming(cfg, gpu, cpu, proc)
    small_visual(cfg, gpu, cpu, proc, tok)
    small_spans(cfg, gpu, cpu, proc)
    gpu.quantize(4)
    cpu.quantize(4)
    counts = compare(200, "quantize(bits=4)")
    require(counts["matmul_int4"] == 2 * 11 * 32 + 32,
            f"small int4: {counts['matmul_int4']} int4 launches, expected {2 * 11 * 32 + 32}")


def tiny_agreement():
    """tiny_test_config (codec widths 4 / 16: kernel 3 at 4 and 8 channels,
    padded to 32) in fp32 through separate() on the card and on the CPU with
    the same noise: within SMALL_TOL, kernel 3 launched 18 times (6 units to
    encode, 6 for each of the two decodes)."""
    import numpy as np

    from sam_audio_tpu_torch import SAMAudio, SAMAudioProcessor, tiny_test_config
    from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer
    from sam_audio_tpu_torch.utils import tree_map

    log("[small] tiny_test_config, fp32 separate on the card vs on the CPU")
    cfg = tiny_test_config()
    tok = ByteFallbackTokenizer(cfg.text_encoder.vocab_size)
    gpu = SAMAudio.init_random(cfg, seed=0, device=DEVICE, tokenizer=tok)
    cpu = SAMAudio(cfg, tree_map(lambda x: x.cpu(), gpu.params), device="cpu",
                   tokenizer=tok, allow_random_towers=True)
    hop = cfg.audio_codec.hop_length
    proc = SAMAudioProcessor(hop, cfg.audio_codec.sample_rate)
    frames = 48
    batch = proc(descriptions=["a dog barking", "rain"],
                 audios=[mixture(frames * hop, 8000, 3), mixture(frames * hop * 3 // 4, 8000, 4)])
    noise = np.random.RandomState(7).randn(
        2, frames, 2 * cfg.audio_codec.codebook_dim).astype(np.float32)
    reset_counts()
    a = gpu.separate(batch, noise=noise)
    counts = read_counts()
    b = cpu.separate(batch, noise=noise)
    worst = 0.0
    for i in range(2):
        for got, ref in ((a.target[i], b.target[i]), (a.residual[i], b.residual[i])):
            require(got.shape == ref.shape and np.isfinite(got).all(), "tiny: bad output")
            worst = max(worst, float(np.abs(got - ref).max()))
    log(f"  T={frames} frames: launches {counts}, max |gpu - cpu| = {worst:.3e}")
    require(worst <= SMALL_TOL, f"tiny: card and CPU disagree ({worst:.3e} > {SMALL_TOL})")
    require(counts["fused_residual_unit"] == 18,
            f"tiny: {counts['fused_residual_unit']} residual-unit launches, expected 18")
    return {"max_abs_diff": worst, "launches": counts}


def native_phase():
    """The host runtime (sam_audio_tpu_torch/runtime/native.py): built with g++
    from csrc/host on this host and loaded; its batch planner against the
    serving layer's (runtime.plan_batches) on random lengths (including a
    unit <= 0); a float32 WAV and an
    EXTENSIBLE one through audio_io.load_audio with ffmpeg made unreachable,
    bit-equal to the data; the resampler against resample_np (rtol 1e-3,
    atol 1e-4) on 10 s of 44.1 kHz stereo, both timed on the host."""
    import shutil
    import struct

    import numpy as np

    from sam_audio_tpu_torch import audio_io
    from sam_audio_tpu_torch.ops.resample import resample_np
    from sam_audio_tpu_torch.runtime import native, plan_batches

    log("[native] host runtime")
    t0 = time.perf_counter()
    require(native.build_native(quiet=True) and native.native_available(),
            "native: the host library did not build or load")
    build_s = time.perf_counter() - t0
    log(f"  built and loaded {native.library_path()} in {build_s:.2f} s")
    rng = np.random.RandomState(0)
    for hop, steps, max_batch in ((1920, 1, 4), (8, 16, 2), (0, 4, 3)):
        lengths = rng.randint(1, 500000, size=64).tolist()
        got = native.plan_batches(lengths, hop, steps, max_batch)
        require(got == plan_batches(lengths, hop, steps, max_batch),
                f"native: plan_batches differs from runtime.plan_batches at hop={hop}")
    work = os.path.join(HERE, "build", "native_phase")
    os.makedirs(work, exist_ok=True)
    wav = (0.8 * rng.rand(2, 48000) - 0.4).astype(np.float32)
    data = np.ascontiguousarray(wav.T).reshape(-1).astype("<f4").tobytes()
    guid = struct.pack("<H", 3) + bytes.fromhex("000000001000800000aa00389b71")
    files = {}
    for name, fmt in (("float32", struct.pack("<HHIIHH", 3, 2, 48000, 48000 * 8, 8, 32)),
                      ("extensible_float32",
                       struct.pack("<HHIIHHHHI", 0xFFFE, 2, 48000, 48000 * 8, 8, 32, 22, 32, 3)
                       + guid)):
        chunks = (b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data"
                  + struct.pack("<I", len(data)) + data)
        files[name] = os.path.join(work, f"{name}.wav")
        with open(files[name], "wb") as f:
            f.write(b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks)

    def no_ffmpeg(path, sample_rate=None):
        raise AssertionError(f"native: load_audio sent {path} to ffmpeg")

    real = audio_io._ffmpeg_decode
    audio_io._ffmpeg_decode = no_ffmpeg
    try:
        for name, path in files.items():
            got, sr = audio_io.load_audio(path)
            require(sr == 48000 and np.array_equal(got, wav),
                    f"native: load_audio of the {name} WAV is not the data")
    finally:
        audio_io._ffmpeg_decode = real
    clip = (0.3 * rng.randn(2, 441000)).astype(np.float32)
    t0 = time.perf_counter()
    ours = native.resample_native(clip, 44100, 48000)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref = resample_np(clip, 44100, 48000)
    numpy_ms = (time.perf_counter() - t0) * 1e3
    require(ours.shape == ref.shape and np.allclose(ours, ref, rtol=1e-3, atol=1e-4),
            "native: resample_native disagrees with resample_np")
    shutil.rmtree(work, ignore_errors=True)
    log(f"  plan_batches native == runtime.plan_batches; float32 and EXTENSIBLE WAVs through load_audio "
        f"(ffmpeg unreachable); resample 10 s stereo 44.1 -> 48 kHz: native "
        f"{native_ms:.1f} ms, resample_np {numpy_ms:.1f} ms (host), max |diff| "
        f"{float(np.abs(ours - ref).max()):.2e}")
    return {"build_s": build_s, "resample_10s_stereo_host_ms": {"native": native_ms,
                                                                 "numpy": numpy_ms}}


def cpu_window_noise(seed, item, window, shape, device):
    """streaming._window_noise drawn on the CPU and moved to `device`, so that
    a model on the card and one on the CPU get the same bits."""
    import numpy as np
    import torch

    state = np.random.SeedSequence([seed, item, window]).generate_state(1, np.uint64)
    g = torch.Generator().manual_seed(int(state[0]))
    return torch.randn(shape, generator=g, dtype=torch.float32).to(device)


def small_streaming(cfg, gpu, cpu, proc):
    """A 400-frame clip past max_direct_seconds (200 frames) streams through
    3 windows of 200 frames on the card and on the CPU, with the same window
    noise (the base seed from torch's global generator, seeded alike)."""
    import numpy as np
    import torch

    from sam_audio_tpu_torch import streaming

    hop = cfg.audio_codec.hop_length
    batch = proc(descriptions=["a dog barking"], audios=[mixture(400 * hop, 8000, 3)],
                 anchors=[[("+", 0.05, 0.25)]])
    limit_s = 200 * hop / 8000
    draw = streaming._window_noise
    streaming._window_noise = cpu_window_noise
    try:
        torch.manual_seed(11)
        reset_counts()
        a = gpu.separate(batch, max_direct_seconds=limit_s)
        counts = read_counts()
        torch.manual_seed(11)
        b = cpu.separate(batch, max_direct_seconds=limit_s)
    finally:
        streaming._window_noise = draw
    units = 3 * (len(cfg.audio_codec.encoder_rates) + 2 * len(cfg.audio_codec.decoder_rates))
    expect = {"fused_glue_attention": 3 * cfg.transformer.n_layers * 32,
              "fused_residual_unit": 3 * units, "flash_attention": 0, "matmul_int4": 0}
    require(counts == expect, f"small streaming: launches {counts}, expected {expect}")
    worst = 0.0
    for got, ref in ((a.target[0], b.target[0]), (a.residual[0], b.residual[0])):
        require(got.shape == ref.shape == (400 * hop,) and np.isfinite(got).all(),
                "small streaming: bad output")
        worst = max(worst, float(np.abs(got - ref).max()))
    log(f"  streamed, 400 frames in 3 windows of 200: launches {counts}, max |gpu - cpu| = "
        f"{worst:.3e}")
    require(worst <= 2e-3, f"small streaming: card and CPU disagree ({worst:.3e} > 2e-3)")


def small_pe_config():
    """A narrow PE tower (2 layers of 128, 2 heads, 112 px, 65 tokens a
    frame) with the default output width, which the DiT's video projection
    takes."""
    import dataclasses

    from sam_audio_tpu_torch.config import PerceptionEncoderConfig

    return dataclasses.replace(PerceptionEncoderConfig(), width=128, vit_layers=2, vit_heads=2,
                               image_size=112)


def video_frames(n: int, seed: int, hw=(360, 640)):
    """n uint8 RGB frames (N, 3, H, W) and a 0/1 mask of the same shape,
    from the seed: a moving gradient with noise; the mask a box."""
    import numpy as np

    rng = np.random.RandomState(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    frames = np.empty((n, 3, h, w), np.uint8)
    for i in range(n):
        base = (xx + 4 * i) % 256
        frames[i, 0] = base
        frames[i, 1] = (yy + 2 * i) % 256
        frames[i, 2] = (base // 2 + yy // 2) % 256
    frames = np.clip(frames.astype(np.int16) + rng.randint(-20, 21, frames.shape, np.int16),
                     0, 255).astype(np.uint8)
    mask = np.zeros_like(frames)
    mask[:, :, h // 4: 3 * h // 4, w // 3: 2 * w // 3] = 1
    return frames, mask


def small_visual(cfg, gpu, cpu, proc, tok):
    """A visual prompt through a small PE tower (fp32, the same weights) on
    the card and on the CPU, k=1, the same noise; then save_pretrained ->
    load_sam_audio onto the card, whose visual separate must be
    bit-identical to the model it was saved from."""
    import numpy as np
    import torch

    from sam_audio_tpu_torch.checkpoint import load_sam_audio
    from sam_audio_tpu_torch.models.pe_clip import PerceptionEncoder
    from sam_audio_tpu_torch.utils import tree_map

    pe_cfg = small_pe_config()
    enc = PerceptionEncoder.init_random(pe_cfg, seed=1, device=DEVICE, compute_dtype=torch.float32)
    gpu.vision_encoder = enc
    cpu.vision_encoder = PerceptionEncoder(pe_cfg, tree_map(lambda x: x.cpu(), enc.params),
                                           device="cpu", compute_dtype=torch.float32)
    for m in (gpu, cpu):   # open the video gate (0 at init)
        m.params["align_masked_video"]["gate"].fill_(0.5)
    frames = 200
    n = frames * cfg.audio_codec.hop_length
    video, mask = video_frames(57, 5, hw=(90, 160))
    batch = proc(descriptions=["a dog barking"], audios=[mixture(n, 8000, 6)],
                 masked_videos=proc.mask_videos([video], [mask]))
    noise = np.random.RandomState(6).randn(1, frames, 2 * cfg.audio_codec.codebook_dim
                                           ).astype(np.float32)
    reset_counts()
    a = gpu.separate(batch, noise=noise)
    counts = read_counts()
    b = cpu.separate(batch, noise=noise)
    worst = max(float(np.abs(x - y).max()) for x, y in ((a.target[0], b.target[0]),
                                                        (a.residual[0], b.residual[0])))
    units = len(cfg.audio_codec.encoder_rates) * 3 + 2 * len(cfg.audio_codec.decoder_rates) * 3
    expect = {"fused_glue_attention": cfg.transformer.n_layers * 32,
              "fused_residual_unit": units, "flash_attention": 0, "matmul_int4": 0}
    log(f"  visual prompt (PE {pe_cfg.vit_layers} x {pe_cfg.width}, 57 frames of 90 x 160 "
        f"-> {frames}), k=1: launches {counts}, max |gpu - cpu| = {worst:.3e}")
    require(counts == expect, f"small visual: launches {counts}, expected {expect}")
    require(np.isfinite(a.target[0]).all() and a.target[0].shape == (n,),
            "small visual: bad output")
    require(worst <= 2e-3, f"small visual: card and CPU disagree ({worst:.3e} > 2e-3)")
    snap = os.path.join(HERE, "build", "small_snapshot")
    gpu.save_pretrained(snap)
    loaded = load_sam_audio(snap, device=DEVICE, allow_random_towers=True, tokenizer=tok)
    loaded.vision_encoder = enc
    c = loaded.separate(batch, noise=noise)
    same = all(torch.equal(torch.as_tensor(x), torch.as_tensor(y))
               for x, y in ((a.target[0], c.target[0]), (a.residual[0], c.residual[0])))
    log(f"  save_pretrained -> load_sam_audio on the card: separate bit-identical: {same}")
    require(same, "small: the reloaded snapshot does not separate bit-identically")
    gpu.vision_encoder = cpu.vision_encoder = None


SPAN_MARGIN = 1e-3


def small_spans(cfg, gpu, cpu, proc):
    """A narrow native SpanPredictor (fp32) on the small model: its logits on
    the card against the CPU (2e-3), the same spans with no valid frame within
    1e-3 of the threshold, and separate(predict_spans=True) on both with the
    same noise; then the small snapshot with span_predictor/ reloaded onto the
    card, and the command line on it against the in-process separate."""
    import numpy as np
    import torch

    from sam_audio_tpu_torch.audio_io import read_wav, write_wav
    from sam_audio_tpu_torch.checkpoint import load_sam_audio, save_span_predictor
    from sam_audio_tpu_torch.models.init import center_span_head
    from sam_audio_tpu_torch.models.span_predictor import SpanPredictor, SpanPredictorConfig
    from sam_audio_tpu_torch.processor import SAMAudioProcessor
    from sam_audio_tpu_torch.utils import tree_map

    sp_cfg = SpanPredictorConfig(audio_dim=cfg.audio_codec.codebook_dim,
                                 text_dim=cfg.text_encoder.dim, hidden=64, n_layers=2,
                                 n_heads=4, min_duration_s=0.005)
    gpu.span_predictor = SpanPredictor.init_random(sp_cfg, seed=1, device=DEVICE)
    cpu.span_predictor = SpanPredictor(sp_cfg, tree_map(lambda x: x.cpu(),
                                                        gpu.span_predictor.params))
    # open the anchor gate (0 at init: the spans would be inert); set back at the end
    gates = [m.params["embed_anchors"]["gate"] for m in (gpu, cpu)]
    saved = [g.clone() for g in gates]
    for g in gates:
        g.fill_(0.5)
    frames = 200
    n = frames * cfg.audio_codec.hop_length
    descs = ["a dog barking", "rain"]
    wavs = [mixture(n, 8000, 12), mixture(n * 3 // 4, 8000, 13)]
    def fresh():
        return proc(descriptions=descs, audios=wavs)

    b0 = fresh()
    mask = np.asarray(b0.audio_pad_mask)
    audios = torch.as_tensor(b0.audios)
    # a random head's logits lie close together: scale it by 20 and centre
    # its bias on the CPU's logits, in both copies
    center_span_head((gpu.span_predictor, cpu.span_predictor),
                     cpu.span_predictor.logits(cpu, b0, audios).numpy(), mask, scale=20.0)
    reset_counts()
    lg = gpu.span_predictor.logits(gpu, b0, audios.to(DEVICE)).cpu()
    counts = read_counts()
    ref = cpu.span_predictor.logits(cpu, b0, audios)
    err = float((lg - ref).abs().max())
    probs = torch.sigmoid(ref).numpy()
    margin = float(np.abs(probs - sp_cfg.threshold)[mask].min())
    log(f"[small] native span predictor ({sp_cfg.n_layers} x {sp_cfg.hidden}, fp32): logits "
        f"max |gpu - cpu| {err:.3e}; nearest valid frame {margin:.3e} from the threshold; "
        f"launches {counts}")
    require(err <= 2e-3, f"small spans: logits disagree ({err:.3e} > 2e-3)")
    require(margin >= SPAN_MARGIN, f"small spans: a frame lies {margin:.2e} from the threshold")
    require(counts["fused_residual_unit"] == 3 * len(cfg.audio_codec.encoder_rates),
            f"small spans: the predictor's encode launched {counts}")
    noise = np.random.RandomState(14).randn(2, frames, 2 * cfg.audio_codec.codebook_dim
                                            ).astype(np.float32)
    bg, bc = fresh(), fresh()
    a = gpu.separate(bg, noise=noise, predict_spans=True)
    b = cpu.separate(bc, noise=noise, predict_spans=True)
    log(f"  predicted spans (card) {bg.anchors}")
    require(bg.anchors == bc.anchors, "small spans: card and CPU spans differ")
    require(any(bg.anchors), "small spans: no span predicted")
    worst = max(float(np.abs(x - y).max()) for x, y in ((a.target[0], b.target[0]),
                                                        (a.residual[1], b.residual[1])))
    log(f"  separate(predict_spans=True): max |gpu - cpu| = {worst:.3e}")
    require(worst <= 2e-3, f"small spans: card and CPU disagree ({worst:.3e} > 2e-3)")

    snap = os.path.join(HERE, "build", "small_snapshot")
    gpu.save_pretrained(snap)
    save_span_predictor(snap, gpu.span_predictor)
    loaded = load_sam_audio(snap, device=DEVICE, allow_random_towers=True)
    require(isinstance(loaded.span_predictor, SpanPredictor),
            "small spans: the reloaded snapshot has no native span predictor")
    bl = fresh()
    c = loaded.separate(bl, noise=noise, predict_spans=True)
    same = bl.anchors == bg.anchors and all(
        np.array_equal(x, y) for x, y in ((a.target[0], c.target[0]), (a.residual[1], c.residual[1])))
    log(f"  snapshot with span_predictor/ reloaded on the card: bit-identical: {same}")
    require(same, "small spans: the reloaded snapshot does not separate bit-identically")

    work = os.path.join(HERE, "build", "small_cli")
    os.makedirs(work, exist_ok=True)
    mix = os.path.join(work, "mix.wav")
    write_wav(mix, wavs[0], 8000)
    env = {**os.environ, "PYTHONPATH": HERE}
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "sam_audio_tpu_torch.separate_cli", "-p", snap, "-i", mix,
         "-d", descs[0], "-o", work, "--device", DEVICE, "--predict-spans", "--seed", "0",
         "--allow-random-towers"], cwd=HERE, env=env, capture_output=True, text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    require(run.returncode == 0, f"separate_cli failed: {run.stderr[-2000:]}")
    batch = SAMAudioProcessor.from_pretrained(snap)(descriptions=[descs[0]], audios=[mix])
    # the command line runs with PyTorch's TF32 defaults (cuDNN may use TF32,
    # cuBLAS may not), which this script turns off: compare under the same
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        res = loaded.separate(batch, predict_spans=True,
                              generator=torch.Generator(device=DEVICE).manual_seed(0))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    worst = 0.0
    for name, want in (("target", res.target[0]), ("residual", res.residual[0])):
        write_wav(os.path.join(work, f"want_{name}.wav"), want, 8000)
        got, sr = read_wav(os.path.join(work, f"{name}.wav"))
        ref_wav, _ = read_wav(os.path.join(work, f"want_{name}.wav"))
        require(sr == 8000 and got.shape == ref_wav.shape, f"separate_cli: {name} shape")
        worst = max(worst, float(np.abs(got - ref_wav).max()))
    log(f"  separate_cli --device {DEVICE} --predict-spans --seed 0 ({cli_s:.1f} s of "
        f"process; it printed {run.stdout.strip().splitlines()}): max |cli - in-process| over "
        f"both WAVs {worst:.3e} (one 16-bit step: {2 ** -15:.3e})")
    require(worst <= 2 ** -15, "separate_cli: its WAVs differ from the in-process separate "
            "by more than one 16-bit step")
    gpu.span_predictor = cpu.span_predictor = None
    for g, v in zip(gates, saved):
        g.copy_(v)


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


def codec_units(codec):
    """Residual units of one encode and of one decode (3 per block)."""
    return 3 * len(codec.encoder_rates), 3 * len(codec.decoder_rates)


def stream_phase(model, proc, n_layers, nfe, seed):
    """A 60 s clip past max_direct_seconds=10 through separate(): 7 windows
    of 10 s (fade 1 s, stride 9 s), at streaming_batch_windows 1 and 4 (each
    call one encode and two decodes). `seed` seeds a new generator for each
    counted run, so both draw the same window noise."""
    import math

    import numpy as np
    import torch

    sr, hop = model.sample_rate, model.hop_length
    total = int(STREAM_SECONDS * sr)
    win = int(STREAM_WINDOW_SECONDS * sr) // hop * hop
    stride = win - min(sr // hop * hop, win // 2)
    n_windows = 1 + math.ceil((total - win) / stride)
    log(f"[stream] {STREAM_SECONDS:g} s clip, text prompt and two anchors, "
        f"max_direct_seconds={STREAM_WINDOW_SECONDS:g}: {n_windows} windows")
    batch = proc(descriptions=["a dog barking"], audios=[mixture(total, sr, 4)],
                 anchors=[[("+", 5.0, 20.0), ("+", 40.0, 55.0)]])
    enc, dec = codec_units(model.cfg.audio_codec)
    model.max_direct_seconds = STREAM_WINDOW_SECONDS
    out = {}
    try:
        for bw in (1, 4):
            groups = -(-n_windows // bw)
            model.streaming_batch_windows = bw
            log(f"  streaming_batch_windows={bw}: {groups} separate() calls")
            res, counts, first_ms, times, peak = drive(
                f"stream bw={bw}", model, batch, STREAM_SECONDS,
                {"fused_glue_attention": groups * n_layers * nfe,
                 "fused_residual_unit": groups * (enc + 2 * dec), "flash_attention": 0,
                 "matmul_int4": 0}, 2,
                generator=torch.Generator(device=DEVICE).manual_seed(seed))
            require(res.noise is None, "stream: the streamed result carries noise")
            log(f"  timed runs (ms): {[round(t, 1) for t in times]}; p50 {p50(times):.1f} ms; "
                f"realtime factor {STREAM_SECONDS * 1e3 / p50(times):.2f}x; peak memory "
                f"{peak / 2**30:.2f} GiB")
            out[bw] = (res.target[0].astype(np.float64), {
                "p50_ms": p50(times), "runs_ms": times, "first_ms": first_ms,
                "realtime_factor": STREAM_SECONDS * 1e3 / p50(times), "peak_bytes": peak,
                "launches": counts})
    finally:
        del model.max_direct_seconds, model.streaming_batch_windows
    a, b = out[1][0], out[4][0]
    corr = float(np.corrcoef(a, b)[0, 1])
    diff = float(np.abs(a - b).max())
    snr = float(10 * np.log10(np.sum(a * a) / max(np.sum((a - b) ** 2), 1e-30)))
    log(f"  target bw=4 vs bw=1: correlation {corr:.6f}, max |diff| {diff:.3e}, "
        f"SNR {snr:.2f} dB")
    require(np.isfinite(corr) and corr >= 0.99,
            f"stream: bw=4 target correlation with bw=1 {corr:.4f} < 0.99")
    return {"windows": n_windows, "bw1": out[1][1], "bw4": out[4][1], "corr_bw4_vs_bw1": corr,
            "max_abs_diff_bw4_vs_bw1": diff, "snr_db_bw4_vs_bw1": snr}


def judge_rerank(what, model, batch, judge, expect, timed_runs, gen):
    """separate(k=8) with `judge` as the text ranker, scoring on the card;
    the counted run's candidates are scored again by the judge's host path.
    Returns the ranker, the counted run's record and its candidates."""
    import numpy as np
    import torch

    from sam_audio_tpu_torch.config import JudgeRankerConfig
    from sam_audio_tpu_torch.processor import SAMAudioJudgeProcessor
    from sam_audio_tpu_torch.ranking.judge import JudgeRanker
    from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer

    codec = judge.cfg.audio_codec
    ranker = JudgeRanker(JudgeRankerConfig(), model=judge, device=DEVICE,
                         processor=SAMAudioJudgeProcessor(
                             codec.hop_length, codec.sample_rate,
                             tokenizer=ByteFallbackTokenizer(judge.cfg.text_model.vocab_size)))
    seen, score_ms = [], []
    on_device = ranker.score_on_device

    def spy(targets, sizes, descriptions, mixtures=None):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        scores = on_device(targets, sizes, descriptions, mixtures=mixtures)
        end.record()
        torch.cuda.synchronize()
        score_ms.append(start.elapsed_time(end))
        if not seen:   # the counted run's candidates, mixture and scores
            seen.append((targets.clone(), list(sizes), list(descriptions), mixtures.clone(),
                         scores.float().cpu().numpy()))
        return scores

    ranker.score_on_device = spy
    model.text_ranker = ranker
    k = 8
    res, counts, first_ms, times, peak = drive(what, model, batch, MIXTURE_SECONDS, expect,
                                               timed_runs, reranking_candidates=k,
                                               generator=gen)
    model.text_ranker = None
    ranker.score_on_device = on_device
    require(bool(seen), f"{what}: the on-device scoring path was not taken")
    targets, sizes, desc, mixtures, dev_scores = seen[0]
    winner = int(np.argmax(dev_scores[0]))
    n = sizes[0]
    tgt = targets[0, :, :n].float().cpu().numpy()
    mix = mixtures[0, 0, :n].float().cpu().numpy()
    host_scores = ranker(extracted_audio=[tgt], input_audio=[np.broadcast_to(mix, (k, n))],
                         descriptions=desc, sample_rate=model.sample_rate)
    top = np.sort(dev_scores[0])
    rec = {"first_ms": first_ms, "runs_ms": times, "peak_bytes": peak, "launches": counts,
           "scores": dev_scores[0].tolist(), "winner": winner,
           "winner_lead": float(top[-1] - top[-2]),
           "host_argmax": int(np.argmax(host_scores[0])),
           "host_scores": host_scores[0].tolist(),
           "host_lead": float(np.sort(host_scores[0])[-1] - np.sort(host_scores[0])[-2]),
           "max_abs_score_err_host": float(np.abs(host_scores - dev_scores).max()),
           "score_ms": score_ms[1:]}
    log(f"  scores on the card {np.round(dev_scores[0], 5).tolist()}; winner {winner} (lead "
        f"{rec['winner_lead']:.3e}); host path argmax {rec['host_argmax']}; max |host - card| "
        f"{rec['max_abs_score_err_host']:.3e}")
    require(bool(np.isfinite(dev_scores).all() and np.isfinite(host_scores).all()),
            f"{what}: non-finite scores")
    require(dev_scores.shape == host_scores.shape == (1, k), f"{what}: scores of a bad shape")
    require(np.array_equal(res.target[0], tgt[winner]),
            f"{what}: the returned target is not the winning candidate")
    return ranker, rec, (targets, sizes, desc, mixtures, dev_scores, host_scores)


def check_ranking(what, rec, tol):
    """The device scores must equal the host path's within `tol` (atol and
    rtol), and the device winner must be the host path's argmax wherever the
    host scores decide it: when the host's lead exceeds twice the largest
    |host - device|. Under a smaller lead the two argmaxes are a numerical
    tie, which the first check already bounds."""
    import numpy as np

    dev, host = (np.asarray(rec[n]) for n in ("scores", "host_scores"))
    err = rec["max_abs_score_err_host"]
    require(bool((np.abs(host - dev) <= tol + tol * np.abs(host)).all()),
            f"{what}: device and host scores differ beyond atol {tol:g} + rtol {tol:g}")
    decided = rec["host_lead"] > 2 * err
    rec["argmax_decided"] = bool(decided)
    log(f"  host lead {rec['host_lead']:.3e} vs 2 x max |host - device| {2 * err:.3e}: "
        f"{'decided' if decided else 'a numerical tie'}; argmaxes "
        f"{'agree' if rec['host_argmax'] == rec['winner'] else 'differ'}")
    if decided:
        require(rec["host_argmax"] == rec["winner"],
                f"{what}: the host path's argmax differs from the winner")


def judge_phase(model, proc, batch, n_layers, nfe, gen, jcfg=None):
    """k=8 reranked on the card by a judge of the default config (random
    weights, seed 0, bf16), counted and timed; its device scores held
    against its host path on the same candidates. Then an ensemble with the
    sound-activity ranker through the host path, and the int8 judge on the
    same candidates. Last the same weights in fp32: on those candidates, and
    in a k=8 separate of their own, held against the host path at 1e-5.
    (With random weights the 8 scores lie within ~1e-5 of each other in
    fp32, far under the bf16 rounding of the judge's outputs, so which
    candidate wins is decided by rounding; check_ranking says when.)"""
    import dataclasses

    import numpy as np
    import torch

    from sam_audio_tpu_torch.config import SAMAudioJudgeConfig, SoundActivityRankerConfig
    from sam_audio_tpu_torch.models.judge import SAMAudioJudgeModel
    from sam_audio_tpu_torch.ranking.ranker import EnsembleRanker
    from sam_audio_tpu_torch.ranking.sound_activity import SoundActivityRanker

    jcfg = jcfg or SAMAudioJudgeConfig()
    k = 8
    # kernel 3: 36 for the separate (encode, the k targets' decode, the
    # winner's residual) and 24 for the judge's encoder (12 units on the
    # mixture at B=1, 12 on the candidates at B=8)
    enc, dec = codec_units(model.cfg.audio_codec)
    judge_enc, _ = codec_units(jcfg.audio_codec)
    expect = {"fused_glue_attention": n_layers * nfe,
              "fused_residual_unit": enc + 2 * dec + 2 * judge_enc,
              "flash_attention": 0, "matmul_int4": 0}
    widths = (f"ModernBERT {jcfg.text_model.num_hidden_layers} x {jcfg.text_model.hidden_size}, "
              f"PE-AV 2 x {jcfg.transformer.num_layers} x {jcfg.transformer.hidden_size}")

    log(f"[judge] SAMAudioJudgeConfig ({widths}), random weights (seed 0), "
        f"{jcfg.compute_dtype}: counted and timed")
    judge = SAMAudioJudgeModel.init_random(jcfg, seed=0, device=DEVICE)
    torch.cuda.empty_cache()
    ranker, rec, cands = judge_rerank("judge k=8", model, batch, judge, expect, TIMED_RUNS, gen)
    targets, sizes, desc, mixtures, dev_scores, host_scores = cands
    check_ranking("judge", rec, 2e-2)
    # the judge's DAC-VAE encoder alone, on the mixture (B=1) and the k
    # candidates (B=k): the part of the scoring that runs kernel 3
    from sam_audio_tpu_torch.models import dacvae

    def encode(values):
        return lambda: dacvae.encode(judge.params["audio_codec"], values, jcfg.audio_codec,
                                     judge.compute_dtype)

    with torch.inference_mode():
        enc_ms = (time_ms(encode(mixtures[..., :targets.shape[-1]].float()), iters=3)
                  + time_ms(encode(targets.reshape(k, 1, -1).float()), iters=3))
    rec["encoder_ms"] = enc_ms
    log(f"  timed runs (ms): {[round(t, 1) for t in rec['runs_ms']]}; p50 "
        f"{p50(rec['runs_ms']):.1f} ms; peak memory {rec['peak_bytes'] / 2**30:.2f} GiB; judge "
        f"scoring alone (CUDA events) {[round(t, 2) for t in rec['score_ms']]} ms, p50 "
        f"{p50(rec['score_ms']):.2f} ms, of which its DAC-VAE encoder {enc_ms:.2f} ms")

    log("[judge] ensemble (judge 1.0 + sound activity 0.5) through the host path, anchors")
    calls = {"judge": [], "sound_activity": [], "ensemble": []}

    def recorded(name, fn):   # no score_on_device: separate() takes the host path
        def call(**kw):
            scores = fn(**kw)
            calls[name].append((kw, scores))
            return scores
        return call

    ensemble = EnsembleRanker(
        [recorded("judge", ranker),
         recorded("sound_activity", SoundActivityRanker(SoundActivityRankerConfig()))],
        [1.0, 0.5])
    model.text_ranker = recorded("ensemble", ensemble)
    sr = model.sample_rate
    anchored = proc(descriptions=["a dog barking"],
                    audios=[mixture(int(MIXTURE_SECONDS * sr), sr, 0)],
                    anchors=[[("+", 1.0, 4.0), ("-", 6.0, 7.5)]])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ens_res = model.separate(anchored, reranking_candidates=k, generator=gen)
    torch.cuda.synchronize()
    ens_ms = (time.perf_counter() - t0) * 1e3
    ens_counts = read_counts()
    # the host path encodes the 8 (mixture, candidate) pairs as 16 streams in
    # one call: 12 launches
    ens_expect = {"fused_glue_attention": n_layers * nfe,
                  "fused_residual_unit": enc + 2 * dec + judge_enc,
                  "flash_attention": 0, "matmul_int4": 0}
    require(ens_counts == ens_expect, f"ensemble: launches {ens_counts}, expected {ens_expect}")
    require(all(len(c) == 1 for c in calls.values()),
            "ensemble: the host path did not call the ensemble and each member once")
    kw, ens_scores = calls["ensemble"][0]
    require("spans" in kw, "ensemble: separate() passed no spans")
    members = (calls["judge"][0][1], calls["sound_activity"][0][1])
    weighted = 1.0 * members[0] + 0.5 * members[1]
    ens_err = float(np.abs(ens_scores - weighted).max())
    e_win = int(np.argmax(ens_scores[0]))
    log(f"  {ens_ms:.1f} ms, launches {ens_counts}; judge {np.round(members[0][0], 5).tolist()}, "
        f"sound activity {np.round(members[1][0], 4).tolist()}; ensemble winner {e_win}; "
        f"max |ensemble - weighted sum| {ens_err:.3e}")
    require(ens_err <= 1e-6, "ensemble: scores are not the weighted sum of its members'")
    require(np.array_equal(ens_res.target[0], kw["extracted_audio"][0][e_win]),
            "ensemble: the returned target is not the ensemble's winner")

    log("[judge] int8 judge (quantize()) on the counted run's candidates")
    judge.quantize()
    torch.cuda.empty_cache()
    q_scores = ranker.score_on_device(targets, sizes, desc, mixtures=mixtures).float().cpu().numpy()
    q_err = float(np.abs(q_scores - dev_scores).max())
    log(f"  int8 scores {np.round(q_scores[0], 5).tolist()}; winner {int(np.argmax(q_scores[0]))}; "
        f"max |int8 - bf16| {q_err:.3e}")
    require(bool(np.isfinite(q_scores).all()), "judge int8: non-finite scores")
    del ranker, judge
    torch.cuda.empty_cache()

    log("[judge] the same weights in fp32: the bf16 run's candidates, then a k=8 separate")
    judge32 = SAMAudioJudgeModel.init_random(dataclasses.replace(jcfg, compute_dtype="float32"),
                                             seed=0, device=DEVICE)
    ranker32, rec32, _ = judge_rerank("judge fp32 k=8", model, batch, judge32, expect, 0, gen)
    check_ranking("judge fp32", rec32, 1e-5)
    ref32 = ranker32.score_on_device(targets, sizes, desc, mixtures=mixtures).cpu().numpy()
    rec["max_abs_diff_vs_fp32_judge"] = float(np.abs(ref32 - dev_scores).max())
    rec["fp32_judge_argmax"] = int(np.argmax(ref32[0]))
    log(f"  fp32 judge on the bf16 run's candidates: {np.round(ref32[0], 7).tolist()}, argmax "
        f"{rec['fp32_judge_argmax']}, max |bf16 - fp32| {rec['max_abs_diff_vs_fp32_judge']:.3e}")
    del ranker32, judge32
    torch.cuda.empty_cache()
    return {**rec, "p50_ms": p50(rec["runs_ms"]), "score_p50_ms": p50(rec["score_ms"]),
            "fp32_winner_check": rec32,
            "ensemble": {"ms": ens_ms, "launches": ens_counts, "winner": e_win,
                         "max_abs_err_weighted_sum": ens_err},
            "int8": {"scores": q_scores[0].tolist(), "max_abs_diff_vs_bf16": q_err}}


def quantized_probe(what, model, batch, noise, ref, expect, timed_runs=TIMED_RUNS):
    """separate(k=1) of a quantized model with the exact model's noise;
    correlation and SNR of its target against the exact target."""
    import numpy as np

    res, counts, first_ms, times, peak = drive(what, model, batch, MIXTURE_SECONDS, expect,
                                               timed_runs, noise=noise)
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


VISUAL_SECONDS = 10.0
VISUAL_STREAM_SECONDS = 30.0
VIDEO_FPS = 25          # one frame a latent frame (48 kHz / hop 1920)


def visual_model(cfg, tok):
    """main's weights (seed 0) with the video gate opened, and a PE-Core
    tower of the default PerceptionEncoderConfig (random, seed 0, bf16)."""
    from sam_audio_tpu_torch import SAMAudio
    from sam_audio_tpu_torch.models.pe_clip import PerceptionEncoder

    model = SAMAudio.init_random(cfg, seed=0, device=DEVICE, tokenizer=tok)
    model.params["align_masked_video"]["gate"].fill_(0.5)
    model.vision_encoder = PerceptionEncoder.init_random(cfg.vision_encoder, seed=0,
                                                         device=DEVICE)
    return model


def pe_encode_ms(model, videos, t_frames, stride, runs=3):
    """The PE encode of `videos` alone (models/pe_clip.encode_videos), CUDA
    events, the median of `runs`."""
    import torch

    from sam_audio_tpu_torch.models.pe_clip import encode_videos

    times = []
    with torch.inference_mode():
        for _ in range(runs + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            encode_videos(model, videos, t_frames, stride=stride)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
    return p50(times[1:])


def visual_phase(cfg, tok, proc, n_layers, nfe):
    """Visual prompting at full width: k=1, visual_stride=4, k=8 ranked by
    ImageBind on the card, and the int8 model with its PE tower quantized."""
    import numpy as np
    import torch

    from sam_audio_tpu_torch.config import ImageBindRankerConfig
    from sam_audio_tpu_torch.models.imagebind import ImageBindHugeConfig, ImageBindHugeModel
    from sam_audio_tpu_torch.ranking.imagebind import ImageBindRanker

    pe = cfg.vision_encoder
    grid = pe.image_size // pe.patch_size
    log(f"[visual] main's weights (video gate 0.5), PE-Core tower {pe.name}: {pe.vit_layers} x "
        f"{pe.width}, {pe.vit_heads} heads, {pe.image_size} px, {grid * grid + 1} tokens a "
        f"frame (random, seed 0, bf16)")
    model = visual_model(cfg, tok)
    sr = model.sample_rate
    n_frames = int(VISUAL_SECONDS * VIDEO_FPS)
    video, mask = video_frames(n_frames, 7)
    masked = proc.mask_videos([video], [mask])
    batch = proc(descriptions=["a dog barking"],
                 audios=[mixture(int(VISUAL_SECONDS * sr), sr, 0)], masked_videos=masked)
    t_frames = batch.anchor_alignment.shape[-1]
    log(f"  {VISUAL_SECONDS:g} s clip, {n_frames} masked frames of {video.shape[2]} x "
        f"{video.shape[3]} -> {t_frames} latent frames")
    expect = {"fused_glue_attention": n_layers * nfe, "fused_residual_unit": 36,
              "flash_attention": 0, "matmul_int4": 0}
    out = {}
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    for stride in (1, 4):
        log(f"[visual] separate(k=1, visual_stride={stride})")
        _, counts, first_ms, times, peak = drive(f"visual stride={stride}", model, batch,
                                                 VISUAL_SECONDS, expect, TIMED_RUNS,
                                                 generator=gen, visual_stride=stride)
        enc_ms = pe_encode_ms(model, batch.masked_video, t_frames, stride)
        out[stride] = {"p50_ms": p50(times), "runs_ms": times, "first_ms": first_ms,
                       "realtime_factor": VISUAL_SECONDS * 1e3 / p50(times), "peak_bytes": peak,
                       "launches": counts, "pe_encode_ms": enc_ms}
        log(f"  timed runs (ms): {[round(t, 1) for t in times]}; p50 {p50(times):.1f} ms; "
            f"realtime factor {VISUAL_SECONDS * 1e3 / p50(times):.2f}x; peak memory "
            f"{peak / 2**30:.2f} GiB; PE encode alone (CUDA events) {enc_ms:.1f} ms")
    saved = out[1]["pe_encode_ms"] - out[4]["pe_encode_ms"]
    log(f"  visual_stride=4 saves {saved:.1f} ms of the PE encode "
        f"({out[1]['pe_encode_ms']:.1f} -> {out[4]['pe_encode_ms']:.1f} ms)")

    ib_cfg = ImageBindHugeConfig()
    log(f"[visual] k=8 ranked by ImageBind (imagebind_huge widths: vision {ib_cfg.vision_layers}"
        f" x {ib_cfg.vision_dim}, audio {ib_cfg.audio_layers} x {ib_cfg.audio_dim}; random, "
        f"seed 0, fp32) on the card")
    ranker = ImageBindRanker(ImageBindRankerConfig(), device=DEVICE,
                             model=ImageBindHugeModel.init_random(ib_cfg, seed=0, device=DEVICE))
    seen, score_ms = [], []
    on_device = ranker.score_on_device

    def spy(targets, sizes, videos, sample_rate=48_000):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        scores = on_device(targets, sizes, videos, sample_rate=sample_rate)
        end.record()
        torch.cuda.synchronize()
        score_ms.append(start.elapsed_time(end))
        if not seen:
            seen.append((targets.cpu().numpy(), list(sizes), scores.cpu().numpy()))
        return scores

    ranker.score_on_device = spy
    model.visual_ranker = ranker
    k = 8
    res, counts, first_ms, times, peak = drive("visual k=8 imagebind", model, batch,
                                               VISUAL_SECONDS, expect, TIMED_RUNS,
                                               reranking_candidates=k, generator=gen)
    model.visual_ranker = None
    require(bool(seen), "visual k=8: the on-device scoring path was not taken")
    targets, sizes, dev_scores = seen[0]
    winner = int(np.argmax(dev_scores[0]))
    host = ranker(extracted_audio=[targets[0, :, :sizes[0]]], videos=batch.masked_video,
                  sample_rate=sr)
    top, htop = np.sort(dev_scores[0]), np.sort(host[0])
    rec = {"p50_ms": p50(times), "runs_ms": times, "first_ms": first_ms, "peak_bytes": peak,
           "launches": counts, "scores": dev_scores[0].tolist(), "winner": winner,
           "winner_lead": float(top[-1] - top[-2]), "host_scores": host[0].tolist(),
           "host_argmax": int(np.argmax(host[0])), "host_lead": float(htop[-1] - htop[-2]),
           "max_abs_score_err_host": float(np.abs(host - dev_scores).max()),
           "score_ms": score_ms[1:]}
    log(f"  scores on the card {np.round(dev_scores[0], 6).tolist()}; winner {winner}; host path "
        f"argmax {rec['host_argmax']}; max |host - card| {rec['max_abs_score_err_host']:.3e}")
    require(np.array_equal(res.target[0], targets[0, winner, :sizes[0]]),
            "visual k=8: the returned target is not the winning candidate")
    check_ranking("visual imagebind", rec, 1e-3)
    # the winner and its video, for the eval phase's ImageBind metric
    pair = (targets[0, winner, :sizes[0]], batch.masked_video[0], float(host[0][winner]))
    log(f"  timed runs (ms): {[round(t, 1) for t in times]}; p50 {p50(times):.1f} ms; peak "
        f"memory {peak / 2**30:.2f} GiB; ImageBind scoring alone (CUDA events) "
        f"{[round(t, 2) for t in score_ms[1:]]} ms")
    del ranker.score_on_device, ranker, model
    torch.cuda.empty_cache()

    noise = torch.randn((1, t_frames, 2 * cfg.audio_codec.codebook_dim),
                        generator=torch.Generator(device=DEVICE).manual_seed(5), device=DEVICE)
    log("[visual] quantize(bits=8) of a fresh visual model (the PE tower too), k=1, against "
        "the bf16 target with the same noise")
    model = visual_model(cfg, tok)
    ref = model.separate(batch, noise=noise).target[0].astype("float64")
    model.quantize(8)
    require("w8" in model.vision_encoder.params["layers"]["attn"]["wq"],
            "visual int8: the PE tower was not quantized")
    torch.cuda.empty_cache()
    int8 = quantized_probe("visual int8", model, batch, noise, ref, expect, timed_runs=1)
    del model
    torch.cuda.empty_cache()
    return {"k1": out[1], "stride4": out[4], "pe_encode_saved_ms_stride4": saved,
            "k8_imagebind": rec, "int8": int8, "imagebind_pair": pair}


def visual_stream_phase(cfg, tok, proc, n_layers, nfe, seed):
    """A 30 s clip with 750 masked frames past max_direct_seconds=10 through
    separate(): 4 windows of 10 s, each conditioned on its frames (the
    global nearest-frame map), at streaming_batch_windows 1 and 4."""
    import math

    import numpy as np
    import torch

    model = visual_model(cfg, tok)
    sr, hop = model.sample_rate, model.hop_length
    total = int(VISUAL_STREAM_SECONDS * sr)
    win = int(STREAM_WINDOW_SECONDS * sr) // hop * hop
    stride = win - min(sr // hop * hop, win // 2)
    n_windows = 1 + math.ceil((total - win) / stride)
    n_frames = int(VISUAL_STREAM_SECONDS * VIDEO_FPS)
    video, mask = video_frames(n_frames, 8)
    batch = proc(descriptions=["a dog barking"], audios=[mixture(total, sr, 9)],
                 masked_videos=proc.mask_videos([video], [mask]))
    del video, mask
    log(f"[visual stream] {VISUAL_STREAM_SECONDS:g} s clip with {n_frames} masked frames, "
        f"max_direct_seconds={STREAM_WINDOW_SECONDS:g}: {n_windows} windows")
    enc, dec = codec_units(model.cfg.audio_codec)
    model.max_direct_seconds = STREAM_WINDOW_SECONDS
    out = {}
    for bw in (1, 4):
        groups = -(-n_windows // bw)
        model.streaming_batch_windows = bw
        log(f"  streaming_batch_windows={bw}: {groups} separate() calls")
        res, counts, first_ms, times, peak = drive(
            f"visual stream bw={bw}", model, batch, VISUAL_STREAM_SECONDS,
            {"fused_glue_attention": groups * n_layers * nfe,
             "fused_residual_unit": groups * (enc + 2 * dec), "flash_attention": 0,
             "matmul_int4": 0}, 2, generator=torch.Generator(device=DEVICE).manual_seed(seed))
        require(res.noise is None, "visual stream: the streamed result carries noise")
        log(f"  timed runs (ms): {[round(t, 1) for t in times]}; p50 {p50(times):.1f} ms; "
            f"realtime factor {VISUAL_STREAM_SECONDS * 1e3 / p50(times):.2f}x; peak memory "
            f"{peak / 2**30:.2f} GiB")
        out[bw] = (res.target[0].astype(np.float64), {
            "p50_ms": p50(times), "runs_ms": times, "first_ms": first_ms,
            "realtime_factor": VISUAL_STREAM_SECONDS * 1e3 / p50(times), "peak_bytes": peak,
            "launches": counts})
    del model
    torch.cuda.empty_cache()
    a, b = out[1][0], out[4][0]
    corr = float(np.corrcoef(a, b)[0, 1])
    snr = float(10 * np.log10(np.sum(a * a) / max(np.sum((a - b) ** 2), 1e-30)))
    log(f"  target bw=4 vs bw=1: correlation {corr:.6f}, max |diff| {float(np.abs(a - b).max()):.3e}"
        f", SNR {snr:.2f} dB")
    require(np.isfinite(corr) and corr >= 0.99,
            f"visual stream: bw=4 target correlation with bw=1 {corr:.4f} < 0.99")
    return {"windows": n_windows, "bw1": out[1][1], "bw4": out[4][1], "corr_bw4_vs_bw1": corr,
            "snr_db_bw4_vs_bw1": snr}


def spans_phase(cfg, tok, proc, n_layers, nfe):
    """separate(k=1, predict_spans=True) at full width: main's model (seed 0,
    bf16; its anchor gate opened to 0.5 for this phase) with a PEAudioFrame
    span predictor of the default config (24 x 1024, 16 heads, vocab 50,368;
    random, seed 0) in fp32, as checkpoint.load_span_predictor builds it and
    as in JAX. Counted, then timed
    on fresh batches (a batch keeps the predicted spans as its anchors), the
    predictor timed alone; with one injected noise the result must equal,
    bit for bit, separate() of the batch anchored at the predicted spans.
    Returns the model, for the serve phase."""
    import numpy as np
    import torch

    from sam_audio_tpu_torch import SAMAudio
    from sam_audio_tpu_torch.models.init import center_span_head
    from sam_audio_tpu_torch.models.span_predictor import PEAudioFrameConfig, PEAudioFrameModel

    pcfg = PEAudioFrameConfig()
    log(f"[spans] main's weights (seed 0, bf16) + PEAudioFrame {pcfg.num_layers} x {pcfg.hidden}, "
        f"{pcfg.num_heads} heads, vocab {pcfg.vocab_size} (random, seed 0, fp32)")
    model = SAMAudio.init_random(cfg, seed=0, device=DEVICE, tokenizer=tok)
    # the anchor gate is 0 at init, which would make the predicted spans inert
    gate = model.params["embed_anchors"]["gate"]
    gate.fill_(0.5)
    predictor = PEAudioFrameModel.init_random(pcfg, seed=0, device=DEVICE)
    sr = model.sample_rate

    def fresh():
        return proc(descriptions=["a dog barking"],
                    audios=[mixture(int(MIXTURE_SECONDS * sr), sr, 0)])

    probe = fresh()
    mask = np.asarray(probe.audio_pad_mask)
    audios = torch.as_tensor(probe.audios, device=DEVICE)
    with torch.inference_mode():
        raw = predictor.logits(model, probe, audios).cpu().numpy()
    # random weights: the head's bias is set so that between a third and two
    # thirds of the clip's frames are active, or the spans could be empty
    shift = center_span_head((predictor,), raw, mask)
    log(f"  head bias shifted by {-shift:.4f} (random logits span "
        f"[{raw[mask].min():.3f}, {raw[mask].max():.3f}])")
    model.span_predictor = predictor
    # kernel 3: the separate's encode and two decodes, and the predictor's own encode
    enc, dec = codec_units(cfg.audio_codec)
    expect = {"fused_glue_attention": n_layers * nfe, "fused_residual_unit": 2 * enc + 2 * dec,
              "flash_attention": 0, "matmul_int4": 0}
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    batch = fresh()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = model.separate(batch, predict_spans=True, generator=gen)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    spans = [tuple(a[1:]) for a in batch.anchors[0]]
    log(f"  counted run: {first_ms:.1f} ms, launches {counts}; {len(spans)} spans: "
        f"{[(round(a, 2), round(b, 2)) for a, b in spans]}")
    for name, n in expect.items():
        require(counts[name] == n, f"spans: {counts[name]} {name} launches, expected {n}")
    require(len(spans) > 0, "spans: no span predicted")
    check_outputs(res, int(MIXTURE_SECONDS * sr), "spans")
    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TIMED_RUNS):
        b = fresh()
        t0 = time.perf_counter()
        model.separate(b, predict_spans=True, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    sp_ms = []
    with torch.inference_mode():
        for _ in range(TIMED_RUNS + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            predictor(model, probe, audios)
            end.record()
            torch.cuda.synchronize()
            sp_ms.append(start.elapsed_time(end))
    log(f"  timed runs (ms): {[round(t, 1) for t in times]}; p50 {p50(times):.1f} ms; "
        f"realtime factor {MIXTURE_SECONDS * 1e3 / p50(times):.2f}x; peak memory "
        f"{peak / 2**30:.2f} GiB; span predictor alone (CUDA events) "
        f"{[round(t, 2) for t in sp_ms[1:]]} ms, p50 {p50(sp_ms[1:]):.2f} ms")
    noise = torch.randn((1, batch.anchor_alignment.shape[-1], 2 * cfg.audio_codec.codebook_dim),
                        generator=torch.Generator(device=DEVICE).manual_seed(6), device=DEVICE)
    predicted = fresh()
    a = model.separate(predicted, noise=noise, predict_spans=True)
    anchored = proc(descriptions=["a dog barking"],
                    audios=[mixture(int(MIXTURE_SECONDS * sr), sr, 0)],
                    anchors=[[tuple(x) for x in predicted.anchors[0]]])
    b = model.separate(anchored, noise=noise)
    same = all(np.array_equal(x, y) for x, y in ((a.target[0], b.target[0]),
                                                 (a.residual[0], b.residual[0])))
    plain = model.separate(fresh(), noise=noise)
    moved = float(np.abs(plain.target[0] - a.target[0]).max())
    log(f"  predict_spans vs the same batch anchored at the predicted spans, one noise: "
        f"bit-identical: {same}; max |target - unanchored target| {moved:.3e}")
    require(same, "spans: predict_spans differs from separate() anchored at its spans")
    require(moved > 0, "spans: the predicted spans do not change the target")
    model.span_predictor = None
    gate.zero_()   # main's weights again, for the serve phase
    del predictor
    torch.cuda.empty_cache()
    return model, {"p50_ms": p50(times), "runs_ms": times, "first_ms": first_ms,
                   "realtime_factor": MIXTURE_SECONDS * 1e3 / p50(times), "peak_bytes": peak,
                   "launches": counts, "spans": spans, "span_predictor_ms": sp_ms[1:],
                   "span_predictor_p50_ms": p50(sp_ms[1:])}


SERVE_TIMEOUT = 300     # seconds any one HTTP call or future may take


def _post(port, body: bytes, timeout=SERVE_TIMEOUT):
    """POST /v1/separate; returns (status, JSON reply, seconds)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/separate", data=body,
                                 method="POST", headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), time.perf_counter() - t0


def _get(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=SERVE_TIMEOUT) as r:
        return json.loads(r.read())


def _wav_reply(b64):
    import base64
    import io
    import wave

    import numpy as np

    with wave.open(io.BytesIO(base64.b64decode(b64)), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16).astype(np.float32) / 32768


def serve_phase(model, n_layers, nfe):
    """main's model behind a ContinuousBatcher (max_batch 4, 2 s buckets, 50 ms
    wait, direct up to 10 s, longer requests streamed up to 40 s) and a
    SeparationServer on 127.0.0.1:0, warmed at 6 and 10 s. Eight concurrent
    requests (four 6 s, four 10 s at 48 kHz as JSON floats, one of them a
    44.1 kHz WAV instead), one 30 s request (streamed), one of 45 s (413) and
    one malformed body (400); replies as 16-bit WAV. Then the same eight
    through SeparationPipeline.run."""
    import base64
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from sam_audio_tpu_torch.audio_io import write_wav
    from sam_audio_tpu_torch.ops.resample import resample_np
    from sam_audio_tpu_torch.server import ContinuousBatcher, SeparationServer
    from sam_audio_tpu_torch.serving import SeparationPipeline, SeparationRequest

    sr = model.sample_rate
    batcher = ContinuousBatcher(model, max_batch=4, bucket_seconds=2.0, max_wait_ms=50.0,
                                max_seconds=10.0, long_policy="stream", max_stream_seconds=40.0,
                                autostart=False)
    server = None
    try:
        t0 = time.perf_counter()
        warmed = batcher.warmup(seconds=(6.0, 10.0))
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        log(f"[serve] ContinuousBatcher(max_batch=4, bucket 2 s, wait 50 ms, max_seconds=10, "
            f"stream to 40 s): warmed {warmed} in {warm_s:.1f} s")
        batcher.start()
        server = SeparationServer(batcher, host="127.0.0.1", port=0,
                                  request_timeout=SERVE_TIMEOUT)
        server.start()
        port = server.port
        require(_get(port, "/healthz") == {"ok": True}, "serve: /healthz")

        seconds = [6.0, 10.0] * 4
        clips = [mixture(int(s * sr), sr, 20 + i) for i, s in enumerate(seconds)]
        bodies = []
        for i, clip in enumerate(clips):
            req = {"description": ["a dog barking", "rain", "a bell", "speech"][i % 4],
                   "response_format": "wav_b64"}
            if i == 0:   # one request as a 44.1 kHz WAV: the server resamples it
                req["audio_wav_b64"] = base64.b64encode(
                    _wav_bytes(resample_np(clip[None], sr, 44100)[0], 44100)).decode()
            else:
                req["audio"] = clip.tolist()
                req["sample_rate"] = sr
            bodies.append(json.dumps(req).encode())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(bodies)) as pool:
            replies = [f.result(timeout=SERVE_TIMEOUT)
                       for f in [pool.submit(_post, port, b) for b in bodies]]
        wall = time.perf_counter() - t0
        direct_stats = _get(port, "/v1/stats")
        for (code, body, _), clip in zip(replies, clips):
            require(code == 200, f"serve: a request got {code}: {body.get('error')}")
            for name in ("target", "residual"):
                w = _wav_reply(body[f"{name}_wav_b64"])
                require(w.shape == clip.shape, f"serve: {name} has {w.shape[0]} samples, the "
                        f"request {clip.shape[0]}")
                require(bool(np.isfinite(w).all()), f"serve: {name} is not finite")
                require(float(np.sqrt(np.mean(w * w))) > 0, f"serve: {name} is silent")
        lat = sorted(r[2] * 1e3 for r in replies)
        served_s = sum(seconds)
        log(f"  8 concurrent requests ({served_s:g} audio s): wall {wall * 1e3:.1f} ms, "
            f"{served_s / wall:.2f} audio s per wall s; latency p50 {lat[len(lat) // 2]:.1f} ms, "
            f"p90 {lat[int(0.9 * (len(lat) - 1) + 0.5)]:.1f} ms; batches "
            f"{direct_stats['batches']}, batch_size_hist {direct_stats['batch_size_hist']}, "
            f"occupancy {direct_stats['occupancy']:.3f}; metadata "
            f"{[r[1]['metadata'] for r in replies]}")

        long_clip = mixture(int(30.0 * sr), sr, 30)
        code, body, stream_s = _post(port, json.dumps(
            {"description": "a dog barking", "audio": long_clip.tolist(), "sample_rate": sr,
             "response_format": "wav_b64"}).encode())
        require(code == 200 and body["metadata"].get("streamed"),
                f"serve: the 30 s request got {code} {body.get('metadata', body.get('error'))}")
        w = _wav_reply(body["target_wav_b64"])
        require(w.shape == long_clip.shape and np.isfinite(w).all() and np.abs(w).max() > 0,
                "serve: bad streamed reply")
        windows = body["metadata"]["num_windows"]
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        log(f"  30 s request streamed through {windows} windows in {stream_s * 1e3:.1f} ms; "
            f"launches (8 requests + the stream) {counts}")
        over = np.zeros(int(45.0 * sr), np.float32)
        code413, body413, _ = _post(port, json.dumps(
            {"description": "x", "audio_wav_b64": base64.b64encode(
                _wav_bytes(over, sr)).decode()}).encode())
        code400, body400, _ = _post(port, b"{not json")
        log(f"  45 s request: {code413} ({body413.get('error')}); malformed body: {code400}")
        require(code413 == 413, f"serve: the 45 s request got {code413}, expected 413")
        require(code400 == 400, f"serve: the malformed body got {code400}, expected 400")
        stats = _get(port, "/v1/stats")
        log(f"  /v1/stats {stats}")
        require((stats["requests"], stats["streamed_requests"], stats["failed_requests"])
                == (9, 1, 0), "serve: /v1/stats does not show 9 served, 1 streamed, 0 failed")
        enc, dec = codec_units(model.cfg.audio_codec)
        units = enc + 2 * dec   # one encode and two decodes a group or window
        expect = {"fused_glue_attention": n_layers * nfe * (stats["batches"] + windows),
                  "fused_residual_unit": units * (stats["batches"] + windows),
                  "flash_attention": 0, "matmul_int4": 0}
        require(counts == expect, f"serve: launches {counts}, expected {expect}")
        # the same 8 clips as 16-bit WAV payloads: what the JSON floats cost
        wav_bodies = [json.dumps({"description": json.loads(b)["description"],
                                  "audio_wav_b64": base64.b64encode(_wav_bytes(c, sr)).decode(),
                                  "response_format": "wav_b64"}).encode()
                      for b, c in zip(bodies, clips)]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(wav_bodies)) as pool:
            wav_replies = [f.result(timeout=SERVE_TIMEOUT)
                           for f in [pool.submit(_post, port, b) for b in wav_bodies]]
        wav_wall = time.perf_counter() - t0
        require(all(r[0] == 200 for r in wav_replies), "serve: a WAV-payload request failed")
        wav_lat = sorted(r[2] * 1e3 for r in wav_replies)
        after = _get(port, "/v1/stats")
        log(f"  the same 8 as 16-bit WAV payloads: wall {wav_wall * 1e3:.1f} ms, "
            f"{served_s / wav_wall:.2f} audio s per wall s; latency p50 "
            f"{wav_lat[len(wav_lat) // 2]:.1f} ms, p90 {wav_lat[int(0.9 * 7 + 0.5)]:.1f} ms; "
            f"{after['batches'] - stats['batches']} batches")
    finally:
        if server is not None:
            server.shutdown()
        batcher.shutdown(timeout=SERVE_TIMEOUT)

    work = os.path.join(HERE, "build", "serve")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "request0_44k.wav")
    write_wav(path, resample_np(clips[0][None], sr, 44100), 44100)
    reqs = [SeparationRequest(description=json.loads(b)["description"],
                              audio=path if i == 0 else clips[i][None])
            for i, b in enumerate(bodies)]
    pipe = SeparationPipeline(model, max_batch=4, bucket_seconds=2.0)
    t0 = time.perf_counter()
    out = pipe.run(reqs)
    torch.cuda.synchronize()
    offline_s = time.perf_counter() - t0
    require(all(o.target.shape == c.shape and np.isfinite(o.target).all()
                for o, c in zip(out, clips)), "serve: bad offline pipeline output")
    summary = {k: round(v * 1e3, 1) for k, v in pipe.timer.summary().items()}
    log(f"  SeparationPipeline.run of the same 8 (offline): {offline_s * 1e3:.1f} ms, "
        f"{served_s / offline_s:.2f} audio s per wall s; StageTimer ms {summary}; groups "
        f"{sorted({(o.metadata['bucket'], o.metadata['batch_size']) for o in out})}")
    return {"warmup_s": warm_s, "wall_ms": wall * 1e3, "audio_s_per_wall_s": served_s / wall,
            "latency_ms": lat, "p50_latency_ms": lat[len(lat) // 2],
            "p90_latency_ms": lat[int(0.9 * (len(lat) - 1) + 0.5)],
            "batch_size_hist": direct_stats["batch_size_hist"],
            "occupancy": direct_stats["occupancy"], "batches": direct_stats["batches"],
            "stream_30s_ms": stream_s * 1e3, "stream_windows": windows, "peak_bytes": peak,
            "launches": counts, "stats": stats, "offline_ms": offline_s * 1e3,
            "offline_stage_ms": summary, "wav_payload_wall_ms": wav_wall * 1e3,
            "wav_payload_latency_ms": wav_lat}


# ---------------------------------------------------------------------------
# Phase 16: the eval harness
# ---------------------------------------------------------------------------


class TimedMetric:
    """An eval metric whose calls are timed with CUDA events."""

    def __init__(self, metric):
        self.metric, self.keys, self.ms = metric, metric.keys, []

    def __call__(self, **kw):
        import torch

        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.metric(**kw)
        end.record()
        torch.cuda.synchronize()
        self.ms.append(start.elapsed_time(end))
        return out


def small_eval():
    """Phase 4's small model through run_eval on the card and on the CPU with
    the same injected noise and metric towers: 4 items of 0.2 s (200 frames,
    kernel 1) at batch_size 2, k=1, scored once by the Judge, the
    AesPredictor stand-in and CLAP, and once by an AudioboxAesthetics (the
    WavLM tower). The averaged metrics must agree."""
    from sam_audio_tpu_torch import SAMAudio, SAMAudioProcessor
    from sam_audio_tpu_torch.eval import main as eval_main
    from sam_audio_tpu_torch.eval.datasets import SyntheticBench
    from sam_audio_tpu_torch.eval.settings import SETTINGS
    from sam_audio_tpu_torch.models.init import inject_noise, small_eval_metrics
    from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer
    from sam_audio_tpu_torch.utils import tree_map

    log("[eval] small model through run_eval on the card vs on the CPU")
    cfg = small_config()
    codec = cfg.audio_codec
    tok = ByteFallbackTokenizer(cfg.text_encoder.vocab_size)
    gpu = SAMAudio.init_random(cfg, seed=0, device=DEVICE, tokenizer=tok)
    cpu = SAMAudio(cfg, tree_map(lambda x: x.cpu(), gpu.params), device="cpu", tokenizer=tok,
                   allow_random_towers=True)
    proc = SAMAudioProcessor(codec.hop_length, codec.sample_rate)
    SETTINGS["synthetic-small"] = (SyntheticBench, {"seconds": 0.2, "num_items": 4})
    out_dir = os.path.join(HERE, "build", "eval_small")
    runs = (("judge", "aesthetic-predictor", "clap"), ("aesthetic-audiobox",))
    res = {DEVICE: {}, "cpu": {}}
    try:
        for dev, model in ((DEVICE, gpu), ("cpu", cpu)):
            inject_noise(model, 2 * codec.codebook_dim)
            metrics = small_eval_metrics(codec, dev)
            for names in runs:
                reset_counts()
                res[dev][names] = eval_main.run_eval(
                    ["synthetic-small"], cache_path=out_dir, batch_size=2, checkpoint_path="",
                    reranking_candidates=1, model=model, processor=proc,
                    metrics=[metrics[n] for n in names],
                    output_dir=os.path.join(out_dir, dev), device=dev)["synthetic-small"]
                if dev == DEVICE and names == runs[0]:
                    counts = read_counts()
    finally:
        del SETTINGS["synthetic-small"]
    enc, dec = codec_units(codec)
    expect = {"fused_glue_attention": 2 * cfg.transformer.n_layers * 32,
              "fused_residual_unit": 2 * (enc + 2 * dec + enc),
              "flash_attention": 0, "matmul_int4": 0}
    require(counts == expect, f"small eval: launches {counts}, expected {expect}")
    worst = {}
    for names, n_keys in zip(runs, (9, 4)):
        card, host = res[DEVICE][names], res["cpu"][names]
        require(card.keys() == host.keys() and len(host) == n_keys,
                f"small eval {names}: the card and the CPU report different metrics")
        worst[names[-1]] = max(abs(card[k] - v) for k, v in host.items())
        require(all(abs(card[k] - v) <= 2e-3 + 2e-3 * abs(v) for k, v in host.items()),
                f"small eval {names}: card and CPU averages disagree beyond 2e-3")
    log(f"  launches {counts}; max |card - cpu| of the averages: judge / predictor / CLAP "
        f"{worst['clap']:.3e}, AudioboxAesthetics {worst['aesthetic-audiobox']:.3e}")
    return {"launches": counts, "max_abs_diff_card_cpu": worst}


def eval_phase(cfg, tok, proc, n_layers, nfe, imagebind_pair):
    """run_eval at full width: main's model (seed 0, bf16) with phase 7's
    CLAP ranker at k=8, scored by phase 9's judge, an AudioboxAesthetics at
    WavLM-base widths and phase 7's CLAP model, over `synthetic-10s` twice
    (the second run warm) and `synthetic-span`; then the WavLM encode alone
    and the ImageBind metric on phase 12's winning pair."""
    import math

    import numpy as np
    import torch

    from sam_audio_tpu_torch import SAMAudio
    from sam_audio_tpu_torch.config import ClapRankerConfig, SAMAudioJudgeConfig
    from sam_audio_tpu_torch.eval import main as eval_main
    from sam_audio_tpu_torch.eval.datasets import SyntheticBench
    from sam_audio_tpu_torch.eval.metrics import CLAP, Aesthetic, ImageBind, Judge
    from sam_audio_tpu_torch.eval.settings import SETTINGS
    from sam_audio_tpu_torch.models.aesthetics import AudioboxAesthetics
    from sam_audio_tpu_torch.models.imagebind import ImageBindHugeConfig, ImageBindHugeModel
    from sam_audio_tpu_torch.models.judge import SAMAudioJudgeModel
    from sam_audio_tpu_torch.models.wavlm import wavlm_encode
    from sam_audio_tpu_torch.processor import SAMAudioJudgeProcessor
    from sam_audio_tpu_torch.ranking.clap import ClapRanker
    from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer

    rec = {"small": small_eval()}
    jcfg = SAMAudioJudgeConfig()
    log("[eval] main's model (seed 0, bf16) + phase 7's CLAP ranker; metrics: phase 9's judge, "
        "AudioboxAesthetics at WavLM-base widths, phase 7's CLAP model (all random)")
    model = SAMAudio.init_random(cfg, seed=0, device=DEVICE, tokenizer=tok)
    ranker = ClapRanker(ClapRankerConfig(), allow_random=True, device=DEVICE)
    model.text_ranker = ranker
    judge = SAMAudioJudgeModel.init_random(jcfg, seed=0, device=DEVICE)
    aes = AudioboxAesthetics.init_random(seed=0, device=DEVICE)
    metrics = [TimedMetric(Judge(model=judge, processor=SAMAudioJudgeProcessor(
                   jcfg.audio_codec.hop_length, jcfg.audio_codec.sample_rate,
                   ByteFallbackTokenizer(jcfg.text_model.vocab_size)))),
               TimedMetric(Aesthetic(model=aes)), TimedMetric(CLAP(model=ranker.model))]
    enc, dec = codec_units(cfg.audio_codec)
    judge_enc, _ = codec_units(jcfg.audio_codec)
    k, batch_size = 8, 4
    separate_ms = []
    inner = model.separate

    def timed_separate(batch, **kw):   # each batch's separate, on the host clock
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = inner(batch, **kw)
        torch.cuda.synchronize()
        separate_ms.append((time.perf_counter() - t0) * 1e3)
        return res

    model.separate = timed_separate
    out_dir = os.path.join(HERE, "build", "eval")
    SETTINGS["synthetic-10s"] = (SyntheticBench, {"seconds": EVAL_SECONDS, "num_items": 8})
    try:
        for setting, n_items, run in (("synthetic-10s", 8, 1), ("synthetic-10s", 8, 2),
                                      ("synthetic-span", 4, 1)):
            for m in metrics:
                m.ms = []
            separate_ms.clear()
            batches = math.ceil(n_items / batch_size)
            # a separate of 4 x 8 candidates decodes its targets in two chunks of 16
            expect = {"fused_glue_attention": batches * n_layers * nfe,
                      "fused_residual_unit": batches * (enc + dec * math.ceil(batch_size * k / 16)
                                                        + dec + judge_enc),
                      "flash_attention": 0, "matmul_int4": 0}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            avg = eval_main.run_eval([setting], cache_path=out_dir, batch_size=batch_size,
                                     checkpoint_path="", reranking_candidates=k, model=model,
                                     processor=proc, metrics=metrics, output_dir=out_dir,
                                     device=DEVICE)[setting]
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            counts = read_counts()
            peak = torch.cuda.max_memory_allocated()
            for name, n in expect.items():
                require(counts[name] == n,
                        f"eval {setting}: {counts[name]} {name} launches, expected {n}")
            require(len(avg) == 9 and all(np.isfinite(v) for v in avg.values()),
                    f"eval {setting}: averaged metrics {avg}")
            with open(os.path.join(out_dir, f"{setting}.json")) as f:
                require(sorted(json.load(f)) == sorted(avg), f"eval {setting}: JSON differs")
            metric_ms = {type(m.metric).__name__: sum(m.ms) for m in metrics}
            rec[f"{setting} run {run}"] = {
                "wall_ms": wall, "ms_per_item": wall / n_items,
                "items_per_s": n_items * 1e3 / wall, "metric_ms": metric_ms,
                "separate_ms": list(separate_ms), "peak_bytes": peak, "launches": counts,
                "averages": avg}
            log(f"  {setting} run {run}: {n_items} items in {wall:.1f} ms ({wall / n_items:.1f} "
                f"ms an item, {n_items * 1e3 / wall:.3f} items/s), launches {counts}; separate ms a batch "
                f"{[round(t, 1) for t in separate_ms]}; metric ms (CUDA "
                f"events) {({n: round(v, 1) for n, v in metric_ms.items()})}; peak memory "
                f"{peak / 2**30:.2f} GiB; averages "
                f"{({n: round(v, 4) for n, v in avg.items()})}")
    finally:
        del SETTINGS["synthetic-10s"]
    model.text_ranker = None
    del model, inner, timed_separate, ranker, judge, metrics
    torch.cuda.empty_cache()

    wcfg = aes.cfg.wavlm
    log(f"[eval] WavLM encode alone (fp32, {wcfg.num_layers} x {wcfg.hidden_size}): 8 chunks "
        f"of 10 s at 16 kHz")
    wav = torch.randn(8, 160_000, generator=torch.Generator(device=DEVICE).manual_seed(8),
                      device=DEVICE) * 0.1
    mask = torch.ones(8, 160_000, dtype=torch.bool, device=DEVICE)
    with torch.inference_mode():
        frames = wavlm_encode(aes.params["wavlm"], wcfg, wav, mask,
                              compute_dtype=torch.float32).shape[1]
        rec["wavlm_encode_ms"] = time_ms(lambda: wavlm_encode(
            aes.params["wavlm"], wcfg, wav, mask, compute_dtype=torch.float32), iters=3, warmup=1)
    log(f"  {frames} frames a chunk; {rec['wavlm_encode_ms']:.2f} ms (CUDA events, mean of 3)")
    del aes, wav, mask
    torch.cuda.empty_cache()

    target, video, host_score = imagebind_pair
    log("[eval] ImageBind metric (imagebind_huge widths, random, seed 0) on phase 12's winner")
    metric = TimedMetric(ImageBind(model=ImageBindHugeModel.init_random(
        ImageBindHugeConfig(), seed=0, device=DEVICE)))
    score = metric(target_wavs=[target], videos=[video],
                   target_wavs_sample_rate=cfg.audio_codec.sample_rate)["ImageBind"][0]
    diff = abs(score - host_score)
    log(f"  metric {score:.6f}, phase 12's host ranking score {host_score:.6f}, |diff| "
        f"{diff:.3e}; {metric.ms[0]:.1f} ms")
    require(diff <= 1e-3 + 1e-3 * abs(host_score),
            "eval ImageBind: the metric differs from the host ranking path's score")
    rec["imagebind"] = {"score": score, "host_score": host_score, "ms": metric.ms[0]}
    del metric
    torch.cuda.empty_cache()
    return rec


def examples_phase():
    """Phase 4's walkthroughs: the port's three examples
    (sam_audio_tpu_torch/examples) with --device cuda at their small widths,
    each counted and timed; their files under the git-ignored
    build/examples/."""
    import importlib
    import shutil

    import torch

    out = {}
    for name, extra in (("span_prompting", ()), ("visual_prompting", ()),
                        ("train_flow_matching", ("--steps", "3", "--batch-size", "2"))):
        work = os.path.join(HERE, "build", "examples", name)
        shutil.rmtree(work, ignore_errors=True)
        module = importlib.import_module(f"sam_audio_tpu_torch.examples.{name}")
        reset_counts()
        t0 = time.perf_counter()
        module.main(["--device", DEVICE, "--out", work, *extra])
        torch.cuda.synchronize()
        out[name] = {"ms": (time.perf_counter() - t0) * 1e3, "launches": read_counts(),
                     "files": sorted(os.listdir(work))}
        log(f"[examples] python -m sam_audio_tpu_torch.examples.{name} --device cuda: "
            f"{out[name]['ms']:.0f} ms, launches {out[name]['launches']}, files "
            f"{out[name]['files']}")
        require(out[name]["launches"]["fused_residual_unit"] > 0,
                f"examples: {name} launched no residual unit")
    for name in ("span_prompting", "visual_prompting"):   # 128-wide heads: kernel 1
        require(out[name]["launches"]["fused_glue_attention"] > 0,
                f"examples: {name} launched no fused attention")
    require(os.listdir(os.path.join(HERE, "build", "examples", "train_flow_matching", "ckpt"))
            == ["3"], "examples: train_flow_matching kept no step-3 checkpoint")
    return out


# ---------------------------------------------------------------------------
# Training: phase 4's card-vs-CPU check and phase 17 at full width
# ---------------------------------------------------------------------------


def small_training():
    """Two Trainer steps of the small fp32 model (dropout 0) on the card and
    on the CPU with the same t and x0, at 200 frames (kernel 1) and 1100
    (kernel 2). First the loss's gradient at the initial parameters, every
    trainable leaf card vs CPU within 1e-4 of that leaf's largest CPU
    gradient (a zero, rescaled or sign-flipped gradient fails it), and every
    layer's wq and q_norm given a gradient on the card (a wrapper that cut
    the graph would leave them at zero). Then the steps, with no warmup so
    that both move the parameters: losses and updated parameters within
    2e-3, each step's attention launches exact. Then the "dots" remat
    policy's gradients against "full"'s on the card."""
    import numpy as np
    import torch

    from sam_audio_tpu_torch.models.init import sam_audio_init
    from sam_audio_tpu_torch.train.flow_matching import Trainer, flow_matching_loss
    from sam_audio_tpu_torch.utils import tree_leaves_with_path, tree_map

    log("[small train] fp32 Trainer steps on the card vs on the CPU")
    cfg = small_config()
    n_layers = cfg.transformer.n_layers
    params = sam_audio_init(cfg, torch.Generator().manual_seed(0), "cpu")
    kw = dict(learning_rate=1e-3, lr_schedule="cosine", warmup_steps=0, total_steps=3,
              ema_decay=0.9, remat="full")
    rng = np.random.RandomState(3)
    record = {}
    for frames, kernel in ((200, "fused_glue_attention"), (1100, "flash_attention")):
        c2 = 2 * cfg.audio_codec.codebook_dim
        pad = np.ones((2, frames), bool)
        pad[1, frames * 4 // 5:] = False
        batch = {"audio_features": rng.randn(2, frames, c2).astype(np.float32),
                 "target_latents": rng.randn(2, frames, c2).astype(np.float32),
                 "text_features": rng.randn(2, 7, cfg.text_encoder.dim).astype(np.float32),
                 "text_mask": np.ones((2, 7), bool),
                 "anchor_ids": np.array([[0, 3, 1, 3], [0, 3, 3, 3]]),
                 "anchor_alignment": np.where(pad, 0, 1), "audio_pad_mask": pad}
        host_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        card_batch = tree_map(lambda x: x.to(DEVICE), host_batch)
        draws = [(torch.from_numpy(rng.rand(2).astype(np.float32)),
                  torch.from_numpy(rng.randn(2, frames, c2).astype(np.float32)))
                 for _ in range(2)]
        card = Trainer(cfg, tree_map(lambda x: x.to(DEVICE), params), device=DEVICE, **kw)
        host = Trainer(cfg, tree_map(lambda x: x.clone(), params), device="cpu", **kw)
        names = [p for p, x in tree_leaves_with_path(card.state.params) if x.requires_grad]
        grads = {}
        for side, trainer, b, dev in (("card", card, card_batch, DEVICE),
                                      ("host", host, host_batch, "cpu")):
            loss = flow_matching_loss(trainer.state.params, cfg, b, t=draws[0][0].to(dev),
                                      x0=draws[0][1].to(dev))
            grads[side] = dict(zip(names, torch.autograd.grad(loss, trainer.state.trainable,
                                                             allow_unused=True)))
        grad_err = 0.0
        for name in names:
            gc, gh = grads["card"][name], grads["host"][name]
            require((gc is None) == (gh is None),
                    f"small train T={frames}: {name} has a gradient on one device only")
            if gh is None:
                continue
            scale = float(gh.abs().max())
            err = float((gc.cpu() - gh).abs().max())
            require(err <= 1e-4 * scale, f"small train T={frames}: the gradient of {name} "
                    f"disagrees card vs CPU ({err:.3e} > 1e-4 x {scale:.3e})")
            grad_err = max(grad_err, err / scale if scale else 0.0)
        g_wq = grads["card"]["transformer/layers/attention/wq/weight"]
        g_qn = grads["card"]["transformer/layers/attention/q_norm/weight"]
        for i in range(n_layers):
            require(bool(g_wq[i].abs().max() > 0) and bool(g_qn[i].abs().max() > 0),
                    f"small train: layer {i}'s self-attention got no gradient on the card")
        reset_counts()
        losses = []
        for t, x0 in draws:
            a = card.step(card_batch, t=t.to(DEVICE), x0=x0.to(DEVICE))
            b = host.step(host_batch, t=t, x0=x0)
            losses.append((float(a["loss"]), float(b["loss"])))
        counts = read_counts()
        # per step: each layer's forward and its recomputation under remat="full"
        expect = {name: 0 for name in counts}
        expect[kernel] = 2 * 2 * n_layers
        require(counts == expect, f"small train T={frames}: launches {counts}, expected {expect}")
        ref = dict(tree_leaves_with_path(host.state.params))
        worst = max(float((x.detach().cpu() - ref[p].detach()).abs().max())
                    for p, x in tree_leaves_with_path(card.state.params))
        loss_err = max(abs(a - b) for a, b in losses)
        log(f"  T={frames}: gradients card vs CPU within {grad_err:.3e} of each leaf's largest; "
            f"losses card/CPU {losses}, launches {counts}, max |param card - CPU| "
            f"= {worst:.3e}")
        require(loss_err <= 2e-3 and worst <= 2e-3,
                f"small train T={frames}: card and CPU disagree ({loss_err:.3e}, {worst:.3e})")
        record[f"T={frames}"] = dict(grad_rel_err=grad_err, loss_err=loss_err, param_err=worst,
                                     launches=counts)
    # "dots" keeps the linear outputs; its gradients equal "full"'s
    grads = {}
    for remat in ("full", "dots"):
        loss = flow_matching_loss(card.state.params, cfg, card_batch, t=draws[0][0].to(DEVICE),
                                  x0=draws[0][1].to(DEVICE), remat=remat)
        grads[remat] = torch.autograd.grad(loss, card.state.trainable, allow_unused=True)
    diff = max(float((a - b).abs().max()) for a, b in zip(*grads.values())
               if a is not None and b is not None)
    log(f"  remat dots vs full: max |grad difference| = {diff:.3e}")
    require(diff <= 1e-5, f"small train: remat='dots' and 'full' disagree ({diff:.3e})")
    record["dots_vs_full_grad_err"] = diff
    return record


TRAIN_DESCRIPTIONS = ("a dog barking", "rain on a roof", "a man speaking", "a violin")


def train_examples(n: int, seconds: float, sr: int):
    """n synthetic examples: target = tones and bursts, residual = noise,
    mixture = their sum; every other one with two anchors."""
    import numpy as np

    from sam_audio_tpu_torch.train.data import TrainExample

    rng = np.random.RandomState(17)
    length = int(seconds * sr)
    out = []
    for i in range(n):
        target = mixture(length, sr, 100 + i)
        residual = (0.1 * rng.randn(length)).astype(np.float32)
        anchors = [("+", 0.1 * seconds, 0.4 * seconds), ("-", 0.6 * seconds, 0.7 * seconds)]
        out.append(TrainExample(mixture=target + residual, target=target, residual=residual,
                                description=TRAIN_DESCRIPTIONS[i % len(TRAIN_DESCRIPTIONS)],
                                anchors=anchors if i % 2 == 0 else None))
    return out


def featurize_epoch(ds, pipeline, epoch, batch_size):
    """The epoch's batches through iter_batches (its prefetch thread) and
    make_batch, all featurized before training starts (so that a step's time
    holds no featurization). Returns (batches, ms per batch)."""
    import torch

    from sam_audio_tpu_torch.train.records import iter_batches

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = list(iter_batches(ds.epoch(epoch), pipeline, batch_size,
                                max_batches=ds.batches_per_epoch(epoch, batch_size)))
    torch.cuda.synchronize()
    return batches, (time.perf_counter() - t0) * 1e3 / max(len(batches), 1)


def leaf_checksums(tree):
    """{path: exact checksum} of fp32 leaves (their bits summed as int64)."""
    import torch

    from sam_audio_tpu_torch.utils import tree_leaves_with_path

    return {p: int(x.detach().view(torch.int32).sum(dtype=torch.int64))
            for p, x in tree_leaves_with_path(tree)}


def train_phase(cfg, tok, proc, n_layers, seconds=MIXTURE_SECONDS, n_examples=8,
                batch_size=4, expect_launches=True):
    """Phase 17: training at full width. Records -> FlowMatchingDataPipeline
    -> Trainer (fp32 master weights from seed 0, bf16 compute, dropout from
    a seeded generator, remat="full", AdamW with warmup + cosine, EMA 0.999)
    for 4 steps, a checkpoint at step 2 restored into a fresh Trainer whose
    steps 3-4 must equal the uninterrupted run's, the EMA exported and
    separated, LoRA (rank 16, attention) for 2 steps and its merged model
    separated, the native span predictor for 2 steps, and the command line
    on the small config."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from sam_audio_tpu_torch.checkpoint import load_sam_audio
    from sam_audio_tpu_torch.models.init import sam_audio_init
    from sam_audio_tpu_torch.models.sam_audio import SAMAudio
    from sam_audio_tpu_torch.models.span_predictor import SpanPredictorConfig
    from sam_audio_tpu_torch.train.checkpoints import TrainCheckpointManager
    from sam_audio_tpu_torch.train.data import FlowMatchingDataPipeline
    from sam_audio_tpu_torch.train.export import export_snapshot
    from sam_audio_tpu_torch.train.flow_matching import DEFAULT_FROZEN_PREFIXES, Trainer
    from sam_audio_tpu_torch.train.lora import LoRATrainer
    from sam_audio_tpu_torch.train.records import ShardedRecordDataset, ShardWriter
    from sam_audio_tpu_torch.train.span import SpanDataPipeline, SpanTrainer
    from sam_audio_tpu_torch.utils import tree_leaves_with_path, tree_map

    work = os.path.join(HERE, "build", "train_phase")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    free = shutil.disk_usage(work).free
    log(f"[train] {n_examples} x {seconds:g} s examples, batch {batch_size}, "
        f"{free / 2**30:.1f} GiB free on the build disk")
    sr = cfg.audio_codec.sample_rate
    with ShardWriter(os.path.join(work, "records"), shard_size=4) as writer:
        for ex in train_examples(n_examples, seconds, sr):
            writer.add(ex)
    ds = ShardedRecordDataset(os.path.join(work, "records"), seed=0)
    per_batch = len(cfg.audio_codec.encoder_rates) * 3 if expect_launches else 0

    def counted(what, counts, expect):
        if expect_launches:
            require(counts == expect, f"{what}: launches {counts}, expected {expect}")

    def params0():
        return sam_audio_init(cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE)

    kw = dict(device=DEVICE, learning_rate=1e-4, weight_decay=0.01, grad_clip=1.0,
              lr_schedule="cosine", warmup_steps=1, total_steps=4, ema_decay=0.999,
              remat="full", seed=0)
    params = params0()
    frozen = {p: x.cpu().clone() for p, x in tree_leaves_with_path(params)
              if p.startswith(DEFAULT_FROZEN_PREFIXES)}
    start = {p: x.cpu().clone() for p, x in tree_leaves_with_path(params)
             if not p.startswith(DEFAULT_FROZEN_PREFIXES)}
    n_trainable = sum(x.numel() for x in start.values())
    trainer = Trainer(cfg, params, **kw)
    towers = {k: params[k] for k in DEFAULT_FROZEN_PREFIXES}
    pipeline = FlowMatchingDataPipeline(cfg, towers, tok, bucket_seconds=2.0)
    mgr = TrainCheckpointManager(os.path.join(work, "ckpt"), max_to_keep=1,
                                 save_interval_steps=10**6)
    log(f"  {n_trainable / 1e9:.3f}B trainable parameters (fp32 master), compute "
        f"{cfg.compute_dtype}, dropout {cfg.transformer.dropout}, remat full")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    epochs, feat_ms, step_ms, losses = [], [], [], []
    save_ms = 0.0
    for epoch in range(2):
        batches, ms = featurize_epoch(ds, pipeline, epoch, batch_size)
        epochs.append(batches)
        feat_ms.append(ms)
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = trainer.step(batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
            log(f"  step {trainer.state.step}: loss {losses[-1]:.5f}, grad_norm "
                f"{float(metrics['grad_norm']):.4f}, {step_ms[-1]:.1f} ms")
            if trainer.state.step == 2:
                t0 = time.perf_counter()
                require(mgr.save(trainer.state, force=True), "train: checkpoint not written")
                save_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = len(step_ms)
    require(steps == 4, f"train: {steps} steps, expected 4")
    require(all(np.isfinite(losses)), f"train: losses {losses}")
    counted("train", counts, {"fused_glue_attention": 2 * n_layers * steps,
                              "fused_residual_unit": per_batch * steps,
                              "flash_attention": 0, "matmul_int4": 0})
    live = dict(tree_leaves_with_path(trainer.state.params))
    for p, x in frozen.items():
        require(torch.equal(live[p].cpu(), x), f"train: frozen {p} changed")
    moved = [p for p, x in start.items() if not torch.equal(live[p].detach().cpu(), x)]
    stuck = [p for p in start if p.startswith("transformer/") and p not in moved]
    require(not stuck, f"train: trainable leaves that did not change: {stuck[:5]}")
    log(f"  launches {counts}; featurization {feat_ms} ms a batch; steps {step_ms} ms; peak "
        f"{peak / 2**30:.2f} GiB; {len(moved)} of {len(start)} trainable leaves changed "
        f"(the rest get no gradient: no video, zero gates), codec and T5 bit-identical; "
        f"checkpoint written in {save_ms:.0f} ms")
    final = {p: x.detach().cpu() for p, x in live.items()}
    del trainer, live, start
    torch.cuda.empty_cache()

    # resume: a fresh Trainer restored from step 2 takes steps 3-4 again
    fresh = Trainer(cfg, params0(), **kw)
    t0 = time.perf_counter()
    fresh.state = mgr.restore(fresh.state)
    restore_ms = (time.perf_counter() - t0) * 1e3
    require(fresh.state.step == 2, f"train: restored step {fresh.state.step}")
    # step 3, then step 4 under torch.profiler (the train cell's breakdown)
    from sam_audio_tpu_torch.profile_separate import device_profile

    resumed = [float(fresh.step(epochs[1][0])["loss"])]
    out = {}
    _, profile = device_profile(lambda: out.update(fresh.step(epochs[1][1])))
    resumed.append(float(out["loss"]))
    log(f"  step 4 profiled: wall {profile['wall_ms']:.1f} ms, device busy "
        f"{profile['device_busy_ms']:.1f} ms, idle {profile['device_idle_share']:.1%}, "
        f"{profile['kernel_launches']} launches; by group "
        + ", ".join(f"{k} {v['ms']:.1f} ms" for k, v in profile["groups"].items()))
    for row in profile["top"][:8]:
        log(f"    {row['ms']:8.2f} ms  x{row['launches']:<5d} {row['name']}")
    loss_diff = max(abs(a - b) for a, b in zip(resumed, losses[2:]))
    param_diff = max(float((x.detach().cpu() - final[p]).abs().max())
                     for p, x in tree_leaves_with_path(fresh.state.params))
    log(f"  resumed from step 2 ({restore_ms:.0f} ms): losses {resumed} vs {losses[2:]}, max "
        f"|loss diff| {loss_diff:.3e}, max |param diff| {param_diff:.3e}")
    require(loss_diff <= 1e-6 and param_diff <= 1e-6, "train: the resumed run differs")
    del final
    shutil.rmtree(os.path.join(work, "ckpt"))

    # export the EMA, load it onto the card and separate a clip
    t0 = time.perf_counter()
    export_snapshot(cfg, fresh.ema_inference_params(), os.path.join(work, "export"))
    export_ms = (time.perf_counter() - t0) * 1e3
    del fresh
    torch.cuda.empty_cache()
    model = load_sam_audio(os.path.join(work, "export"), device=DEVICE, tokenizer=tok)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    clip = clip_batch(proc, model.sample_rate, seconds)
    expect_sep = {"fused_glue_attention": n_layers * 32, "fused_residual_unit": 36,
                  "flash_attention": 0, "matmul_int4": 0} if expect_launches else {}
    drive("train export", model, clip, seconds, expect_sep, 0, generator=gen)
    del model
    shutil.rmtree(os.path.join(work, "export"))
    torch.cuda.empty_cache()
    log(f"  exported the EMA in {export_ms:.0f} ms; load_sam_audio + separate(k=1) ok")

    # LoRA: rank 16 over attention, 2 steps; only the adapters move
    lora = LoRATrainer(cfg, params0(), rank=16, targets="attention", **kw)
    base = leaf_checksums(lora.base_params)
    a0 = {k: v["a"].detach().clone() for k, v in lora.adapters.items()}
    reset_counts()
    lora_ms = []
    for batch in epochs[0]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = lora.step(batch)
        torch.cuda.synchronize()
        lora_ms.append((time.perf_counter() - t0) * 1e3)
        require(np.isfinite(float(metrics["loss"])), "lora: loss not finite")
    lora_counts = read_counts()
    counted("lora", lora_counts, {"fused_glue_attention": 2 * n_layers * len(lora_ms),
                                  "fused_residual_unit": 0, "flash_attention": 0,
                                  "matmul_int4": 0})
    require(leaf_checksums(lora.base_params) == base, "lora: the base weights changed")
    require(all(bool(v["b"].abs().max() > 0) and not torch.equal(v["a"], a0[k])
                for k, v in lora.adapters.items()), "lora: an adapter did not change")
    n_adapter = sum(x.numel() for v in lora.adapters.values() for x in v.values())
    merged = SAMAudio(cfg, lora.ema_inference_params(), device=DEVICE, tokenizer=tok)
    del lora
    torch.cuda.empty_cache()
    drive("lora merged", merged, clip, seconds, expect_sep, 0, generator=gen)
    del merged
    torch.cuda.empty_cache()
    log(f"  LoRA: {n_adapter / 1e6:.2f}M adapter parameters, steps {lora_ms} ms, launches "
        f"{lora_counts}; base bit-identical; merged model separates")

    # span: the native predictor on the same records, 2 steps
    codec = cfg.audio_codec
    sp_cfg = SpanPredictorConfig(audio_dim=min(128, codec.codebook_dim),
                                 text_dim=cfg.text_encoder.dim,
                                 frame_rate=codec.sample_rate / codec.hop_length)
    reset_counts()
    sp_batches, sp_feat_ms = featurize_epoch(
        ds, SpanDataPipeline(cfg, towers, tok, sp_cfg, bucket_seconds=2.0), 0, batch_size)
    span_counts = read_counts()
    counted("span featurization", span_counts,
            {"fused_residual_unit": per_batch * len(sp_batches), "fused_glue_attention": 0,
             "flash_attention": 0, "matmul_int4": 0})
    span = SpanTrainer(sp_cfg, device=DEVICE, seed=0)
    sp0 = leaf_checksums(span.state.params)
    span_ms, span_losses = [], []
    for batch in sp_batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = span.step(batch)
        torch.cuda.synchronize()
        span_ms.append((time.perf_counter() - t0) * 1e3)
        span_losses.append(float(metrics["loss"]))
    require(all(np.isfinite(span_losses)), f"span: losses {span_losses}")
    require(leaf_checksums(span.state.params) != sp0, "span: the predictor did not change")
    log(f"  span: losses {span_losses}, steps {span_ms} ms, featurization {sp_feat_ms:.1f} ms "
        f"a batch, launches {span_counts}")
    del span, sp_batches, epochs, towers, pipeline
    torch.cuda.empty_cache()

    # the command line on the small config
    small = os.path.join(work, "small.json")
    with open(small, "w") as f:
        json.dump(dataclasses.asdict(small_config()), f)
    cmd = [sys.executable, "-m", "sam_audio_tpu_torch.train", "--synthetic", "4",
           "--random-init", "--config", small, "--batch-size", "2", "--device", DEVICE,
           "--ckpt-dir", os.path.join(work, "cli_ckpt"), "--export-dir",
           os.path.join(work, "cli_export"), "--log-every", "1"]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=600)
    cli_ms = (time.perf_counter() - t0) * 1e3
    for line in run.stderr.strip().splitlines()[-3:]:
        log("  cli: " + line)
    require(run.returncode == 0, f"train CLI exited {run.returncode}: {run.stderr[-2000:]}")
    require(os.path.exists(os.path.join(work, "cli_export", "params.npz")),
            "train CLI wrote no export")
    shutil.rmtree(work)
    return {"trainable_params": n_trainable, "step_ms": step_ms, "losses": losses,
            "featurization_ms_per_batch": feat_ms, "peak_bytes": peak, "launches": counts,
            "launches_per_step": {k: v / steps for k, v in counts.items()},
            "checkpoint_save_ms": save_ms, "restore_ms": restore_ms,
            "resume_loss_diff": loss_diff, "resume_param_diff": param_diff,
            "step_profile": profile,
            "export_ms": export_ms, "lora_step_ms": lora_ms, "lora_launches": lora_counts,
            "lora_adapter_params": n_adapter, "span_step_ms": span_ms,
            "span_featurization_ms_per_batch": sp_feat_ms, "span_launches": span_counts,
            "cli_ms": cli_ms}


# ---------------------------------------------------------------------------
# Phase 18: parallelism over torch.distributed
# ---------------------------------------------------------------------------

PARALLEL_WORLD = 4
SP_SECONDS = 48.0       # 1,200 latent frames: 300 a rank over sp4, kernel 2 unsharded
SMALL_TOL = 2e-3        # phase 4's card-vs-CPU bound
CORR_BOUND = 0.99       # full width, bf16: sharded vs unsharded target correlation
TRAIN_LAYERS = 16       # the default depth; see parallel_train


def parallel_dir():
    d = os.path.join(HERE, "build", "parallel")
    os.makedirs(d, exist_ok=True)
    return d


def corr(a, b) -> float:
    import numpy as np

    return float(np.corrcoef(np.asarray(a, np.float64), np.asarray(b, np.float64))[0, 1])


def spy_scores(ranker, seen):
    """Record the (B, k) scores of every on-device scoring of `ranker`."""
    on_device = ranker.score_on_device

    def spy(*args, **kw):
        scores = on_device(*args, **kw)
        seen.append(scores.float().cpu().numpy())
        return scores

    ranker.score_on_device = spy


# the depth of sharded serving and of sp over tp in this phase: full width,
# 4 of the 16 layers, so that the script keeps its time
CUT_LAYERS = 4
SERVE_SECONDS = (6.0, 10.0) * 4   # the serve phase's 8 concurrent requests
SERVE_BUCKET_SECONDS = 2.0        # and its batcher's buckets
SERVE_SEED = 31                   # the global generators' seed for their noise


def batcher_requests(model, sr):
    """The serve phase's 8 concurrent 6-10 s requests through a
    ContinuousBatcher (max_batch 4, 2 s buckets, 50 ms wait) over `model`: a
    SAMAudio, or on rank 0 a parallel.serve.Lockstep while the other ranks
    follow. All 8 are queued before the device thread starts, so that every
    run plans the same two groups of 4, and the noise comes from the global
    generators seeded SERVE_SEED. Returns (the targets, each request's ms
    from the start, the wall ms)."""
    import numpy as np
    import torch

    from sam_audio_tpu_torch.server import ContinuousBatcher
    from sam_audio_tpu_torch.serving import SeparationRequest

    clips = [mixture(int(sec * sr), sr, 20 + i) for i, sec in enumerate(SERVE_SECONDS)]
    words = ("a dog barking", "rain", "a bell", "speech")
    batcher = ContinuousBatcher(model, max_batch=4, bucket_seconds=SERVE_BUCKET_SECONDS,
                                max_wait_ms=50.0, max_seconds=10.0, autostart=False)
    torch.manual_seed(SERVE_SEED)
    done = {}
    t0 = time.perf_counter()
    futs = [batcher.submit(SeparationRequest(words[i % 4], clip[None]))
            for i, clip in enumerate(clips)]
    for i, fut in enumerate(futs):
        fut.add_done_callback(lambda _, i=i: done.__setitem__(i, time.perf_counter()))
    batcher.start()
    try:
        replies = [fut.result(timeout=SERVE_TIMEOUT) for fut in futs]
    finally:
        batcher.shutdown(timeout=SERVE_TIMEOUT)
    wall = (time.perf_counter() - t0) * 1e3
    for reply, clip in zip(replies, clips):
        require(reply.target.shape == clip.shape and bool(np.isfinite(reply.target).all()),
                f"parallel serve: a reply of {reply.target.shape}, the request {clip.shape}")
    return ([r.target for r in replies], [(done[i] - t0) * 1e3 for i in range(len(futs))],
            wall)


def mask_digest(keep) -> str:
    import hashlib

    return hashlib.sha1(keep.contiguous().cpu().numpy().tobytes()).hexdigest()


def record_dropout_masks(masks):
    """Patch ops/nn.dropout_keep to append (its keep mask, full_last) to
    `masks`. Returns the original, to put back."""
    from sam_audio_tpu_torch.ops import nn as N

    draw = N.dropout_keep

    def recorded(shape, rate, generator, device, full_last=0):
        keep = draw(shape, rate, generator, device, full_last)
        masks.append((keep, full_last))
        return keep

    N.dropout_keep = recorded
    return draw


def layers_cfg(n_layers):
    """The default SAMAudioConfig (full width) at `n_layers` DiT layers."""
    import dataclasses

    from sam_audio_tpu_torch import SAMAudioConfig

    cfg = SAMAudioConfig()
    return dataclasses.replace(cfg, transformer=dataclasses.replace(
        cfg.transformer, n_layers=n_layers))


def train_cfg():
    """Phase 18's training config: TRAIN_LAYERS layers."""
    return layers_cfg(TRAIN_LAYERS)


def parallel_trainer(cfg, device, mesh=None):
    """Phase 18's trainer (seed 0: the dropout generator too) and its first
    batch (4 x 10 s of synthetic features)."""
    import torch

    from sam_audio_tpu_torch.models.init import sam_audio_init
    from sam_audio_tpu_torch.train.flow_matching import Trainer, synthetic_batch

    trainer = Trainer(cfg, sam_audio_init(cfg, torch.Generator(device=device).manual_seed(0),
                                          device),
                      mesh=mesh, device=device, learning_rate=1e-4, warmup_steps=1,
                      total_steps=2, lr_schedule="cosine", ema_decay=0.999)
    gen = torch.Generator(device=device).manual_seed(9)
    return trainer, gen, synthetic_batch(cfg, gen, batch_size=4, t_frames=250, text_len=16)


def dropout_reference():
    """One one-rank training step of phase 18's trainer at full width
    (dropout 0.1, remat "full"), every dropout site's mask recorded: for
    each site and each (dp, tp) coordinate of the dp2 x tp2 mesh, the digest
    of the block that rank must draw (its 2 of the 4 rows, and its half of
    the FFN's hidden units where the site is column-parallel)."""
    import torch

    from sam_audio_tpu_torch.ops import nn as N

    trainer, _, batch = parallel_trainer(train_cfg(), DEVICE)
    masks = []
    draw = record_dropout_masks(masks)
    try:
        trainer.step(batch)
    finally:
        N.dropout_keep = draw
    torch.cuda.synchronize()
    digests = []
    for keep, full_last in masks:
        site = {}
        for d in range(2):
            for t in range(2):
                block = keep[2 * d: 2 * d + 2]
                if full_last:
                    half = block.shape[-1] // 2
                    block = block[..., t * half: (t + 1) * half]
                site[f"{d},{t}"] = mask_digest(block)
        digests.append(site)
    del trainer, masks
    torch.cuda.empty_cache()
    return digests


def parallel_references(cfg, tok, proc, n_layers, nfe):
    """The unsharded runs that the world is held against, in this process on
    the card: main's model (seed 0, bf16) on the 10 s clip at k=1 and at k=8
    with phase 7's CLAP ranker, the 48 s clip (kernel 2), and after
    quantize(4) the 10 s clip at k=1; at CUT_LAYERS layers, the 48 s clip
    and the serve phase's 8 requests through a ContinuousBatcher; the
    dropout masks of a one-rank training step. Saved with their noise to
    build/parallel/refs.pt."""
    import torch

    from sam_audio_tpu_torch import SAMAudio
    from sam_audio_tpu_torch.config import ClapRankerConfig
    from sam_audio_tpu_torch.ranking.clap import ClapRanker

    sr = cfg.audio_codec.sample_rate
    c2 = 2 * cfg.audio_codec.codebook_dim
    batch10 = clip_batch(proc, sr, MIXTURE_SECONDS)
    batch48 = clip_batch(proc, sr, SP_SECONDS)
    gen = torch.Generator().manual_seed(11)
    t10, t48 = batch10.anchor_alignment.shape[-1], batch48.anchor_alignment.shape[-1]
    noise = {"k1": torch.randn((1, t10, c2), generator=gen),
             "k8": torch.randn((8, t10, c2), generator=gen),
             "sp": torch.randn((1, t48, c2), generator=gen)}
    model = SAMAudio.init_random(cfg, seed=0, device=DEVICE, tokenizer=tok)
    refs, launches = {"noise": noise}, {}

    def run(name, batch, expect, m=None, **kw):
        reset_counts()
        t0 = time.perf_counter()
        res = (m or model).separate(batch, noise=noise[name.split("_")[0]].to(DEVICE), **kw)
        torch.cuda.synchronize()
        launches[name] = read_counts()
        for kernel, n in expect.items():
            require(launches[name][kernel] == n, f"parallel reference {name}: "
                    f"{launches[name][kernel]} {kernel} launches, expected {n}")
        log(f"  unsharded {name}: {(time.perf_counter() - t0) * 1e3:.1f} ms, "
            f"launches {launches[name]}")
        return res.target[0]

    refs["k1"] = run("k1", batch10, {"fused_glue_attention": n_layers * nfe,
                                     "fused_residual_unit": 36})
    # the floor of the correlations below: the same model with its noise
    # changed by 2^-8 of itself (about one bf16 rounding)
    noise["k1p"] = noise["k1"] * (1 + 2.0 ** -8)
    refs["k1_perturbed_corr"] = corr(run("k1p", batch10, {}), refs["k1"])
    log(f"  unsharded, noise x (1 + 2^-8): correlation {refs['k1_perturbed_corr']:.5f} with k1")
    model.text_ranker = ClapRanker(ClapRankerConfig(), allow_random=True, device=DEVICE)
    seen = []
    spy_scores(model.text_ranker, seen)
    refs["k8"] = run("k8", batch10, {"fused_glue_attention": n_layers * nfe},
                     reranking_candidates=8)
    require(bool(seen), "parallel reference k8: the on-device scoring path was not taken")
    refs["k8_scores"] = seen[-1][0]
    model.text_ranker = None
    refs["sp"] = run("sp", batch48, {"flash_attention": n_layers * nfe,
                                     "fused_residual_unit": 36})
    cut = SAMAudio.init_random(layers_cfg(CUT_LAYERS), seed=0, device=DEVICE, tokenizer=tok)
    log(f"  sharded serving and sp over tp at {CUT_LAYERS} of {n_layers} layers "
        "(full width):")
    refs["sp_cut"] = run("sp_cut", batch48, {"flash_attention": CUT_LAYERS * nfe,
                                             "fused_residual_unit": 36}, m=cut)
    reset_counts()
    targets, lat, wall = batcher_requests(cut, cfg.audio_codec.sample_rate)
    torch.cuda.synchronize()
    refs["serve"] = targets
    launches["serve"] = read_counts()
    log(f"  unsharded serve (8 requests, ContinuousBatcher): wall {wall:.1f} ms, request ms "
        f"{[round(x, 1) for x in lat]}, launches {launches['serve']}")
    del cut
    model.quantize(4)
    refs["k1_int4"] = run("k1_int4", batch10, {"matmul_int4": sum(
        int4_launches_k1(cfg).values())})
    refs["launches"] = launches
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    refs["dropout"] = dropout_reference()
    log(f"  one-rank training step at {TRAIN_LAYERS} layers: {len(refs['dropout'])} dropout "
        f"masks recorded in {(time.perf_counter() - t0) * 1e3:.0f} ms (trainer built)")
    torch.save(refs, os.path.join(parallel_dir(), "refs.pt"))
    return refs


def parallel_small(rank, device, meshes):
    """(a) the small fp32 model of phase 4, each sharded path against the
    unsharded one on the same card (SMALL_TOL)."""
    import numpy as np
    import torch

    from sam_audio_tpu_torch import SAMAudio, SAMAudioProcessor
    from sam_audio_tpu_torch.models.init import sam_audio_init
    from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer
    from sam_audio_tpu_torch.train.checkpoints import TrainCheckpointManager
    from sam_audio_tpu_torch.train.flow_matching import Trainer, synthetic_batch
    from sam_audio_tpu_torch.utils import tree_leaves_with_path, tree_map

    cfg = small_config()
    tok = ByteFallbackTokenizer(cfg.text_encoder.vocab_size)
    proc = SAMAudioProcessor(cfg.audio_codec.hop_length, cfg.audio_codec.sample_rate)
    # 200 and 160 frames: the batch pads to 200, 50 a rank over sp4
    batch = proc(descriptions=["a dog barking", "rain"],
                 audios=[mixture(1600, 8000, 1), mixture(1280, 8000, 2)])
    noise = torch.randn((2, batch.anchor_alignment.shape[-1], 2 * cfg.audio_codec.codebook_dim),
                        generator=torch.Generator().manual_seed(3))
    out = {}

    def model(mesh=None, bits=None, sp=None):
        m = SAMAudio.init_random(cfg, seed=0, device=device, tokenizer=tok)
        if bits:
            m.quantize(bits)
        if mesh is not None:
            m.shard(mesh)
        m.sp_mesh = sp
        return m

    def check(name, mesh=None, bits=None, sp=None, k=1):
        ref = model(bits=bits).separate(batch, noise=noise, reranking_candidates=k)
        reset_counts()
        got = model(mesh, bits, sp).separate(batch, noise=noise, reranking_candidates=k)
        counts = read_counts()
        err = max(float(np.abs(a - b).max()) for a, b in zip(got.target + got.residual,
                                                              ref.target + ref.residual))
        require(err <= SMALL_TOL, f"parallel small {name} on rank {rank}: max |sharded - "
                f"unsharded| {err:.3e} > {SMALL_TOL}")
        out[name] = {"max_abs_err": err, "launches": counts}

    check("dp2tp2_k1", meshes["dp2tp2"])
    check("dp2tp2_k4", meshes["dp2tp2"], k=4)
    check("int8_tp2", meshes["dp2tp2"], bits=8)
    check("sp4", sp=meshes["sp"])

    # two Trainer steps at dp2 x tp2 against one rank's; the step-2
    # checkpoint restored at tp1 (dp4 x tp1), then a third step on both
    params = sam_audio_init(cfg, torch.Generator().manual_seed(0), "cpu")
    kw = dict(device=device, learning_rate=1e-3, lr_schedule="cosine", warmup_steps=0,
              total_steps=3, ema_decay=0.9)
    def fresh():   # each trainer owns its tensors (on the CPU .to() would share them)
        return tree_map(lambda x: x.clone(), params)

    one = Trainer(cfg, fresh(), **kw)
    mesh_run = Trainer(cfg, fresh(), mesh=meshes["dp2tp2"], **kw)
    gen = torch.Generator(device=device).manual_seed(5)
    batches = [synthetic_batch(cfg, gen, batch_size=4, t_frames=200) for _ in range(3)]
    losses = []
    for b in batches[:2]:
        losses.append((float(one.step(b)["loss"]), float(mesh_run.step(b)["loss"])))
    ckpt = os.path.join(parallel_dir(), "ckpt_small")
    if rank == 0:
        import shutil

        shutil.rmtree(ckpt, ignore_errors=True)
    torch.distributed.barrier()
    TrainCheckpointManager(ckpt).save(mesh_run.state)
    restored = Trainer(cfg, fresh(), mesh=meshes["dp4"], **kw)
    restored.state = TrainCheckpointManager(ckpt).restore(restored.state)
    for run in (one, mesh_run, restored):
        losses.append(float(run.step(batches[2])["loss"]))
    ref = dict(tree_leaves_with_path(one.state.params))
    errs = {}
    for name, run in (("dp2tp2", mesh_run), ("restored_dp4", restored)):
        errs[name] = max(float((x - ref[p].detach()).abs().max())
                         for p, x in tree_leaves_with_path(run.full_params()))
    loss_err = max([abs(a - b) for a, b in losses[:2]] + [abs(losses[2] - x)
                                                         for x in losses[3:]])
    require(loss_err <= SMALL_TOL and max(errs.values()) <= SMALL_TOL,
            f"parallel small train on rank {rank}: loss {loss_err:.3e}, params {errs}")
    out["train"] = {"loss_err": loss_err, "param_err": errs}
    return out


def parallel_full(rank, device, meshes, refs):
    """(b) main's model at full width (default config, bf16, seed 0) against
    the unsharded references of this process's parent."""
    import numpy as np
    import torch

    from sam_audio_tpu_torch import SAMAudio, SAMAudioConfig, SAMAudioProcessor
    from sam_audio_tpu_torch.config import ClapRankerConfig
    from sam_audio_tpu_torch.ranking.clap import ClapRanker
    from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer

    cfg = SAMAudioConfig()
    tok = ByteFallbackTokenizer(cfg.text_encoder.vocab_size)
    proc = SAMAudioProcessor(cfg.audio_codec.hop_length, cfg.audio_codec.sample_rate)
    sr = cfg.audio_codec.sample_rate
    batch10, batch48 = clip_batch(proc, sr, MIXTURE_SECONDS), clip_batch(proc, sr, SP_SECONDS)
    out = {}

    def run(name, model, batch, seconds, ref, **kw):
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        reset_counts()
        t0 = time.perf_counter()
        res = model.separate(batch, noise=refs["noise"][name.split("_")[0]].to(device), **kw)
        torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        tgt = res.target[0]
        require(tgt.shape == (int(seconds * sr),) and bool(np.isfinite(tgt).all()),
                f"parallel {name} on rank {rank}: target {tgt.shape}, finite "
                f"{bool(np.isfinite(tgt).all())}")
        c = corr(tgt, ref)
        out[name] = {"ms": ms, "launches": read_counts(), "corr": c, "corr_bound": CORR_BOUND,
                     "peak_bytes": torch.cuda.max_memory_allocated(device)}
        require(c >= CORR_BOUND, f"parallel {name} on rank {rank}: correlation {c:.5f} "
                f"with the unsharded target < {CORR_BOUND}")
        return res

    # the same unsharded separate in this rank: how far a rank's process is
    # from the script's own, sharding aside
    plain = SAMAudio.init_random(cfg, seed=0, device=device, tokenizer=tok)
    in_rank = plain.separate(batch10, noise=refs["noise"]["k1"].to(device)).target[0]
    del plain
    torch.cuda.empty_cache()
    model = SAMAudio.init_random(cfg, seed=0, device=device, tokenizer=tok).shard(
        meshes["dp2tp2"])
    res = run("k1", model, batch10, MIXTURE_SECONDS, refs["k1"])
    out["k1"].update(corr_in_rank_unsharded=corr(res.target[0], in_rank),
                     corr_in_rank_vs_script=corr(in_rank, refs["k1"]),
                     max_abs_in_rank_vs_script=float(np.abs(in_rank - refs["k1"]).max()))
    model.text_ranker = ClapRanker(ClapRankerConfig(), allow_random=True, device=device)
    seen = []
    spy_scores(model.text_ranker, seen)
    run("k8", model, batch10, MIXTURE_SECONDS, refs["k8"], reranking_candidates=8)
    # the winner must be the unsharded one where the unsharded score margin
    # exceeds the spread of the bf16 scores between the two runs
    require(bool(seen), f"parallel k8 on rank {rank}: the on-device scoring path was not "
            "taken")
    got, want = seen[-1][0], refs["k8_scores"]
    spread = float(np.abs(got - want).max())
    top2 = np.sort(want)[-2:]
    margin = float(top2[1] - top2[0])
    same = int(np.argmax(got)) == int(np.argmax(want))
    out["k8"].update(winner=int(np.argmax(got)), ref_winner=int(np.argmax(want)),
                     score_spread=spread, ref_margin=margin)
    require(same or margin <= spread, f"parallel k8 on rank {rank}: winner "
            f"{int(np.argmax(got))} vs {int(np.argmax(want))} with margin {margin:.3e} > "
            f"spread {spread:.3e}")
    del model
    torch.cuda.empty_cache()

    model = SAMAudio.init_random(cfg, seed=0, device=device, tokenizer=tok).quantize(4)
    model.shard(meshes["dp2tp2"])
    run("k1_int4", model, batch10, MIXTURE_SECONDS, refs["k1_int4"])
    del model
    torch.cuda.empty_cache()

    # quantize() after shard() must give quantize-then-shard's tree, bit for bit
    from sam_audio_tpu_torch.utils import tree_leaves_with_path

    for bits in (8, 4):
        t0 = time.perf_counter()
        want = dict(tree_leaves_with_path(SAMAudio.init_random(
            cfg, seed=0, device=device, tokenizer=tok).quantize(bits).shard(
                meshes["dp2tp2"]).params))
        model = SAMAudio.init_random(cfg, seed=0, device=device, tokenizer=tok).shard(
            meshes["dp2tp2"]).quantize(bits)
        got = dict(tree_leaves_with_path(model.params))
        differ = sorted(set(want) ^ set(got)) + [
            p for p in want if p in got and (got[p].dtype != want[p].dtype
                                             or got[p].shape != want[p].shape
                                             or not torch.equal(got[p], want[p]))]
        out[f"quantize_after_shard_{bits}"] = {
            "leaves": len(want), "differing": differ,
            "quantized_leaves": sum(p.endswith(("/w4", "/w8")) for p in want),
            "ms": (time.perf_counter() - t0) * 1e3}
        require(not differ, f"parallel quantize({bits}) after shard on rank {rank}: leaves "
                f"{differ[:5]} differ from quantize-then-shard's")
        del want, got
        if bits == 4:   # the same tree as k1_int4's: kernel 4 under tp2 again
            run("k1_int4_after_shard", model, batch10, MIXTURE_SECONDS, refs["k1_int4"])
        del model
        torch.cuda.empty_cache()

    model = SAMAudio.init_random(cfg, seed=0, device=device, tokenizer=tok)
    model.sp_mesh = meshes["sp"]
    run("sp", model, batch48, SP_SECONDS, refs["sp"])
    del model
    torch.cuda.empty_cache()

    # the ring trunk over a tp-sharded model (its DiT leaves gathered whole),
    # at CUT_LAYERS layers
    model = SAMAudio.init_random(layers_cfg(CUT_LAYERS), seed=0, device=device,
                                 tokenizer=tok).shard(meshes["dp2tp2"])
    model.sp_mesh = meshes["sp"]
    run("sp_tp", model, batch48, SP_SECONDS, refs["sp_cut"])
    del model
    torch.cuda.empty_cache()
    return out


def parallel_serve(rank, device, meshes, refs):
    """(b') main's model (CUT_LAYERS layers) at dp2 x tp2 served from rank 0:
    a ContinuousBatcher over parallel.serve.Lockstep takes the serve phase's
    8 requests while ranks 1-3 follow; each reply is finite, of its clip's
    length, and correlates >= CORR_BOUND with the unsharded batcher's."""
    import torch

    from sam_audio_tpu_torch import SAMAudio
    from sam_audio_tpu_torch.parallel.serve import serve
    from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer

    cfg = layers_cfg(CUT_LAYERS)
    model = SAMAudio.init_random(cfg, seed=0, device=device, tokenizer=ByteFallbackTokenizer(
        cfg.text_encoder.vocab_size)).shard(meshes["dp2tp2"])
    torch.cuda.synchronize(device)
    reset_counts()
    t0 = time.perf_counter()
    got = serve(model, lambda lockstep: batcher_requests(lockstep, cfg.audio_codec.sample_rate))
    torch.cuda.synchronize(device)
    out = {"ms": (time.perf_counter() - t0) * 1e3, "launches": read_counts()}
    if rank == 0:
        targets, out["request_ms"], out["wall_ms"] = got
        out["corr"] = [corr(a, b) for a, b in zip(targets, refs["serve"])]
        require(min(out["corr"]) >= CORR_BOUND, f"parallel serve: correlations {out['corr']} "
                f"with the unsharded replies, bound {CORR_BOUND}")
    else:
        out["followed_calls"] = got
    del model
    torch.cuda.empty_cache()
    return out


def parallel_train(rank, device, meshes, refs_dropout):
    """(c) training at full width, dp2 x tp2, 2 steps of a global batch of 4
    x 10 s (synthetic features). Each rank holds a tp half of the DiT's
    fp32 masters, gradients, AdamW moments and EMA (about 0.58B parameters:
    14 GB with the moments' temporaries) plus remat="full" activations of its
    2 rows; TRAIN_LAYERS sets the depth. Step 1's dropout masks must be
    this rank's blocks of the one-rank step's (`refs_dropout`: digests from
    dropout_reference)."""
    import math

    import torch

    from sam_audio_tpu_torch.ops import nn as N
    from sam_audio_tpu_torch.train.flow_matching import synthetic_batch
    from sam_audio_tpu_torch.utils import tree_leaves_with_path

    cfg = train_cfg()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    trainer, gen, batch = parallel_trainer(cfg, device, meshes["dp2tp2"])
    local = sum(x.numel() for _, x in tree_leaves_with_path(trainer.state.params)
                if x.requires_grad)
    wq = trainer.state.params["transformer"]["layers"]["attention"]["wq"]["weight"]
    before = wq.detach().clone()
    steps, masks = [], []
    for i in range(2):
        if i:
            batch = synthetic_batch(cfg, gen, batch_size=4, t_frames=250, text_len=16)
        reset_counts()
        torch.cuda.synchronize(device)
        draw = record_dropout_masks(masks) if i == 0 else None
        t0 = time.perf_counter()
        try:
            m = trainer.step(batch)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            torch.cuda.synchronize(device)
        finally:
            if draw is not None:
                N.dropout_keep = draw
        steps.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": loss,
                      "grad_norm": gnorm, "launches": read_counts()})
        require(math.isfinite(loss) and math.isfinite(gnorm),
                f"parallel train on rank {rank}: loss {loss}, grad norm {gnorm}")
    require(bool((wq.detach() != before).any()), f"parallel train on rank {rank}: wq did not move")
    # every dropout site's mask of step 1 is this rank's block of the one-rank step's
    coord = f"{meshes['dp2tp2'].axis_index('dp')},{meshes['dp2tp2'].axis_index('tp')}"
    want = [site[coord] for site in refs_dropout]
    got = [mask_digest(keep) for keep, _ in masks]
    require(got == want, f"parallel train on rank {rank}: {sum(a != b for a, b in zip(got, want))}"
            f" of {len(want)} dropout masks differ from the one-rank step's blocks ({len(got)} "
            "drawn)")
    out = {"layers": TRAIN_LAYERS, "local_trainable_params": local, "steps": steps,
           "peak_bytes": torch.cuda.max_memory_allocated(device),
           "dropout_masks_equal": len(got),
           "dropout_split_sites": sum(bool(full_last) for _, full_last in masks)}
    del masks
    del trainer
    torch.cuda.empty_cache()
    return out


def gloo_cuda_probe(device):
    """The gloo collectives that parallel/comm.py passes CUDA tensors to as
    they are (all_reduce: sum of fp32 and int32, max; all_gather), each
    held against the same collective on host copies. Point-to-point is
    staged through host memory and not probed."""
    import torch
    import torch.distributed as dist

    n, r = dist.get_world_size(), dist.get_rank()
    out = {}
    for name, x, op in (("all_reduce_sum_fp32", torch.arange(6.0) + r, dist.ReduceOp.SUM),
                        ("all_reduce_max_fp32", torch.arange(6.0) * r, dist.ReduceOp.MAX),
                        ("all_reduce_sum_int32", torch.arange(6, dtype=torch.int32) * r,
                         dist.ReduceOp.SUM)):
        card, host = x.to(device), x.clone()
        dist.all_reduce(card, op=op)
        dist.all_reduce(host, op=op)
        out[name] = bool(torch.equal(card.cpu(), host))
    x = torch.arange(6.0) + r
    card = [torch.empty(6, device=device) for _ in range(n)]
    host = [torch.empty(6) for _ in range(n)]
    dist.all_gather(card, x.to(device))
    dist.all_gather(host, x)
    out["all_gather_fp32"] = all(torch.equal(a.cpu(), b) for a, b in zip(card, host))
    require(all(out.values()), f"gloo on CUDA tensors disagrees with gloo on host copies: {out}")
    return out


def nccl_check(device):
    """The NCCL collectives on a world of one rank (all_reduce, all_gather,
    broadcast of a card tensor)."""
    import torch
    import torch.distributed as dist

    x = torch.arange(8, dtype=torch.float32, device=device)
    y = x.clone()
    dist.all_reduce(y)
    parts = [torch.empty_like(x)]
    dist.all_gather(parts, x)
    dist.broadcast(y, 0)
    require(torch.equal(y, x) and torch.equal(parts[0], x), "nccl: a one-rank collective "
            "changed its tensor")
    return {"backend": dist.get_backend(), "all_reduce": True, "all_gather": True,
            "broadcast": True}


def parallel_rank(rank, world, port, full, device_type):
    """One rank of the phase's world (torch.multiprocessing.spawn)."""
    import pickle

    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from sam_audio_tpu_torch.parallel.mesh import Mesh, init_distributed, make_mesh

    device = init_distributed(device_type, f"127.0.0.1:{port}", world, rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"rank": rank, "device": str(device), "backend": dist.get_backend()}
    try:
        if world == 1:
            meshes = {"dp2tp2": make_mesh(1, 1), "dp4": make_mesh(1, 1), "sp": Mesh({"sp": 1})}
            if device.type == "cuda":
                res["nccl"] = nccl_check(device)
        else:
            meshes = {"dp2tp2": make_mesh(2, 2), "dp4": make_mesh(4, 1),
                      "sp": Mesh({"sp": world})}
            if res["backend"] == "gloo" and device.type == "cuda":
                res["gloo_cuda"] = gloo_cuda_probe(device)
        t0 = time.perf_counter()
        res["small"] = parallel_small(rank, device, meshes)
        res["small_ms"] = (time.perf_counter() - t0) * 1e3
        if full:
            refs = torch.load(os.path.join(parallel_dir(), "refs.pt"), weights_only=False)
            res["full"] = parallel_full(rank, device, meshes, refs)
            res["serve"] = parallel_serve(rank, device, meshes, refs)
            res["train"] = parallel_train(rank, device, meshes, refs["dropout"])
    finally:
        dist.destroy_process_group()
    with open(os.path.join(parallel_dir(), f"world{world}_rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(world, full, timeout_s=900, device_type="cuda"):
    """Spawn `world` ranks running parallel_rank; a rank's failure fails the
    phase. Returns the ranks' results."""
    import pickle

    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    ctx = mp.spawn(parallel_rank, args=(world, free_port(), full, device_type), nprocs=world,
                   join=False)
    try:
        while not ctx.join(timeout=10):
            require(time.perf_counter() - t0 < timeout_s,
                    f"parallel: the {world}-rank world did not finish in {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = []
    for rank in range(world):
        with open(os.path.join(parallel_dir(), f"world{world}_rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    log(f"  {world}-rank world ({out[0]['backend']}, devices "
        f"{sorted({r['device'] for r in out})}): {(time.perf_counter() - t0) * 1e3:.0f} ms "
        "wall, process start included")
    return out


def parallel_cli():
    """(d) torchrun with 4 processes: the training command line on a dp2 x tp2
    mesh of the small config, on the card."""
    import dataclasses
    import shutil

    out = os.path.join(parallel_dir(), "cli")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    with open(os.path.join(out, "small.json"), "w") as f:
        json.dump(dataclasses.asdict(small_config()), f)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(PARALLEL_WORLD), "-m", "sam_audio_tpu_torch.train",
           "--synthetic", "4", "--random-init", "--config", os.path.join(out, "small.json"),
           "--batch-size", "4", "--dp", "2", "--tp", "2", "--device", "cuda",
           "--ckpt-dir", os.path.join(out, "ckpt"), "--export-dir", os.path.join(out, "export")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=600)
    ms = (time.perf_counter() - t0) * 1e3
    tail = "\n".join((proc.stdout + proc.stderr).strip().splitlines()[-12:])
    log(f"  torchrun (4 processes) exit {proc.returncode} in {ms:.0f} ms:\n" + tail)
    require(proc.returncode == 0, "parallel: the torchrun training command line failed")
    require(os.path.exists(os.path.join(out, "export", "params.npz")),
            "parallel: the torchrun run wrote no export")
    return {"exit": proc.returncode, "ms": ms, "backend_line": next(
        (ln for ln in (proc.stdout + proc.stderr).splitlines() if "backend" in ln), "")}


def parallel_phase(cfg, tok, proc, n_layers, nfe, smi):
    """Phase 18: the unsharded references here, then a 4-rank world (NCCL,
    one rank a card, with four or more cards; else gloo, the 4 ranks on one
    card), a one-rank NCCL world on one card, and the torchrun command line.
    Every rank's launches, errors, correlations, wall ms and peak memory are
    logged. Ranks that share one card measure no scaling."""
    import torch

    cards = torch.cuda.device_count()
    log(f"[parallel] {smi}; {cards} card(s): a {PARALLEL_WORLD}-rank world over "
        f"{'NCCL, one rank a card' if cards >= PARALLEL_WORLD else 'gloo, sharing one card'}")
    refs = parallel_references(cfg, tok, proc, n_layers, nfe)
    torch.cuda.empty_cache()
    ranks = run_world(PARALLEL_WORLD, full=True)
    record = {"world": {"ranks": PARALLEL_WORLD, "backend": ranks[0]["backend"],
                        "cards": cards}, "ref_launches": refs["launches"],
              "unsharded_perturbed_corr": refs["k1_perturbed_corr"], "ranks": []}
    for r in ranks:
        log(f"  rank {r['rank']} ({r['device']}):")
        for name, x in r["small"].items():
            log(f"    small {name}: {x}")
        if "gloo_cuda" in r:
            log(f"    gloo collectives on CUDA tensors equal gloo on host copies: {r['gloo_cuda']}")
        k1 = r["full"]["k1"]
        log(f"    unsharded in this rank vs the script's: corr "
            f"{k1['corr_in_rank_vs_script']:.5f}, max abs {k1['max_abs_in_rank_vs_script']:.3e};"
            f" sharded vs this rank's unsharded: corr {k1['corr_in_rank_unsharded']:.5f}")
        for name, x in r["full"].items():
            if name.startswith("quantize_after_shard"):
                log(f"    full {name}: {x['leaves']} leaves ({x['quantized_leaves']} quantized) "
                    f"equal to quantize-then-shard's in {x['ms']:.0f} ms")
                continue
            log(f"    full {name}: ms {x['ms']:.1f}, corr {x['corr']:.5f} (bound "
                f"{x['corr_bound']}), peak {x['peak_bytes'] / 2**30:.2f} GiB, launches "
                f"{x['launches']}" + (f", winner {x['winner']} vs {x['ref_winner']}, margin "
                                      f"{x['ref_margin']:.3e}, spread {x['score_spread']:.3e}"
                                      if name == "k8" else ""))
        sv = r["serve"]
        log(f"    serve ({CUT_LAYERS} layers, dp2 x tp2, 8 requests, "
            f"{'Lockstep on rank 0' if r['rank'] == 0 else 'follow'}"
            f"): {sv['ms']:.1f} ms, launches {sv['launches']}" + (
                f", wall {sv['wall_ms']:.1f} ms, request ms "
                f"{[round(x, 1) for x in sv['request_ms']]}, corr "
                f"{[round(c, 5) for c in sv['corr']]}" if r["rank"] == 0
                else f", {sv['followed_calls']} calls followed"))
        tr = r["train"]
        log(f"    train ({tr['layers']} layers, {tr['local_trainable_params']:,} trainable "
            f"parameters on this rank): steps "
            f"{[(round(s['ms'], 1), round(s['loss'], 5)) for s in tr['steps']]}, peak "
            f"{tr['peak_bytes'] / 2**30:.2f} GiB, launches {tr['steps'][-1]['launches']}; "
            f"{tr['dropout_masks_equal']} dropout masks equal to the one-rank step's blocks "
            f"({tr['dropout_split_sites']} column-parallel)")
        record["ranks"].append(r)
        full = r["full"]
        require(full["k1"]["launches"]["fused_glue_attention"] == n_layers * nfe
                and full["k1"]["launches"]["fused_residual_unit"] == 36,
                f"parallel: rank {r['rank']} dp2tp2 k=1 launches {full['k1']['launches']}")
        for name in ("k1_int4", "k1_int4_after_shard"):
            require(full[name]["launches"]["matmul_int4"] == refs["launches"]["k1_int4"][
                "matmul_int4"], f"parallel: rank {r['rank']} {name} launches "
                f"{full[name]['launches']}")
        require(full["sp"]["launches"]["fused_residual_unit"] > 0,
                f"parallel: rank {r['rank']} sp4 launched no residual unit")
        require(full["sp_tp"]["launches"]["fused_residual_unit"] == 36
                and full["sp_tp"]["launches"]["flash_attention"] == 0,
                f"parallel: rank {r['rank']} sp4 over tp2 launches {full['sp_tp']['launches']}")
        require(r["serve"]["launches"]["fused_glue_attention"] == 2 * CUT_LAYERS * nfe
                and r["serve"]["launches"]["fused_residual_unit"] == 2 * 36,
                f"parallel: rank {r['rank']} served 2 groups with launches "
                f"{r['serve']['launches']}")
        require(r["train"]["steps"][-1]["launches"]["fused_glue_attention"] > 0,
                f"parallel: rank {r['rank']} training launched no kernel 1")
    calls = {r["serve"].get("followed_calls") for r in ranks[1:]}
    require(calls == {2}, f"parallel serve: the followers ran {calls} calls, rank 0 sent 2")
    losses = {tuple(round(s["loss"], 6) for s in r["train"]["steps"]) for r in ranks}
    require(len(losses) == 1, f"parallel: the ranks report different losses {losses}")
    if cards < PARALLEL_WORLD:
        log("[parallel] the same small-model calls on a one-rank NCCL world")
        one = run_world(1, full=False)
        require(one[0]["backend"] == "nccl", f"parallel: the one-rank world ran "
                f"{one[0]['backend']}")
        log(f"  rank 0: {one[0]['nccl']}; small {one[0]['small']}")
        record["one_rank_nccl"] = one[0]
    record["cli"] = parallel_cli()
    log("  times from ranks that share one card measure no scaling" if cards < PARALLEL_WORLD
        else "  one rank a card")
    return record


def _wav_bytes(x, sr):
    import io
    import wave

    import numpy as np

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


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
                  "fp32": {name: res["fp32"] for name, res in
                           (("fused_glue_attention", k1), ("flash_attention", k2),
                            ("fused_residual_unit", k3), ("matmul_int4", k4)) if "fp32" in res},
                  "fused_residual_unit_shapes": k3.get("per_shape"),
                  "fused_residual_unit_totals": k3.get("totals"),
                  "matmul_int4_shapes": k4.get("per_shape"), "power": smi}
        os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
        with open(os.path.join(HERE, "build", "chip_smoke_kernels.json"), "w") as f:
            json.dump(record, f, indent=1)
        log(json.dumps({k: v for k, v in record.items() if "shapes" not in k and k != "fp32"}))
        log(smi)
        return 0
    if sys.argv[1:3] == ["--phase", "parallel"]:
        # a short run for work on the parallel phase: no kernel checks, no
        # result line
        tok = ByteFallbackTokenizer(cfg.text_encoder.vocab_size)
        proc = SAMAudioProcessor(cfg.audio_codec.hop_length, cfg.audio_codec.sample_rate)
        record = parallel_phase(cfg, tok, proc, cfg.transformer.n_layers, 32, smi)
        os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
        with open(os.path.join(HERE, "build", "chip_smoke_parallel.json"), "w") as f:
            json.dump({"parallel": record, "power": smi}, f, indent=1)
        log(smi)
        return 0
    # 2b. the host runtime, built with g++ on this host
    host_runtime = native_phase()
    for check in checks.values():
        check()

    # 4. small model: card vs CPU, exact and int4; tiny_test_config; two
    # Trainer steps
    small_agreement()
    tiny = tiny_agreement()
    small_train = small_training()
    examples = examples_phase()

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

    # 8. a 60 s clip streamed through 10 s windows
    stream = stream_phase(model, proc, n_layers, nfe, seed=1)

    # 9. k=8 reranked by the judge; the ensemble; the int8 judge
    judge = judge_phase(model, proc, batch, n_layers, nfe, gen)

    # 10. int4, against the exact model's target with the same noise
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

    # 11. int8, on a fresh model with the same weights
    log("[int8] quantize(bits=8) of a fresh model (seed 0), separate(k=1), 10 s clip")
    del model
    torch.cuda.empty_cache()
    model = SAMAudio.init_random(cfg, seed=0, device=DEVICE, tokenizer=tok).quantize(8)
    int8 = quantized_probe(
        "int8", model, batch, noise, ref,
        {"matmul_int4": 0, "fused_glue_attention": n_layers * nfe,
         "fused_residual_unit": 36, "flash_attention": 0})
    del model
    torch.cuda.empty_cache()

    # 12. visual prompting at full width: k=1, stride 4, k=8 ImageBind, int8
    visual = visual_phase(cfg, tok, proc, n_layers, nfe)

    # 13. a 30 s clip with its video streamed through 10 s windows
    visual_stream = visual_stream_phase(cfg, tok, proc, n_layers, nfe, seed=2)

    # 14. separate(predict_spans=True) with a full-width PEAudioFrame predictor
    model, spans = spans_phase(cfg, tok, proc, n_layers, nfe)

    # 15. the HTTP server and its continuous batcher; the offline pipeline
    serve = serve_phase(model, n_layers, nfe)
    del model
    torch.cuda.empty_cache()

    # 16. the eval harness: card vs CPU, run_eval at full width, ImageBind
    evaluation = eval_phase(cfg, tok, proc, n_layers, nfe, visual.pop("imagebind_pair"))
    torch.cuda.empty_cache()

    # 17. training at full width: records -> Trainer -> checkpoint/resume ->
    # export -> separate; LoRA; span; the command line
    train = train_phase(cfg, tok, proc, n_layers)
    torch.cuda.empty_cache()

    # 18. parallelism: dp x tp, sp, int4 under tp, training; torchrun
    parallel = parallel_phase(cfg, tok, proc, n_layers, nfe, smi)

    def entry(res, source, replaces, launches, ms, plain, lib, bms, by, dev, lib_dev):
        # "tpu_source", "max_err" and "kernel_ms" repeat "replaces",
        # "max_abs_err" and "ms" under a second set of names that readers use
        extra = {"per_launch_at": res["extra"]} if "extra" in res else {}
        if "judge_encoder_k8" in res:   # kernel 3's B=8 launches of one judge scoring
            extra["judge_encoder_k8_candidates"] = res["judge_encoder_k8"]
        if "fwd_bwd" in res:   # forward + backward through the autograd Function
            extra["forward_backward"] = res["fwd_bwd"]
        if "narrow" in res:    # kernel 3 at widths that are not multiples of 32
            extra["narrow_widths"] = res["narrow"]
        if "fp32" in res:   # the fp32 body at its paths' shapes, with both bounds
            extra["fp32"] = res["fp32"]
        extra["train_launches_per_step"] = train["launches_per_step"][res["name"]]
        extra["parallel_launches_per_rank"] = parallel_launches[res["name"]]
        return {**extra, "name": res["name"], "route": "cuda", "source": source,
                "replaces": replaces, "tpu_source": replaces, "launches": launches,
                "max_abs_err": res["max_abs_err"], "max_err": res["max_abs_err"],
                "max_abs_err_fp32": res["fp32_err"], "tolerance": res["tolerance"],
                "ms": ms, "kernel_ms": ms, "plain_ms": plain, "bound_ms": bms,
                "bound_by": by, "library_ms": lib, "device_ms": dev,
                "library_device_ms": lib_dev,
                "ms_scope": "one separate's launches; ms and library_ms include the host "
                            "wrapper, device_ms and library_device_ms are CUDA-graph replays"}

    # each kernel's launches per rank on its sharded path (kernel 2: the
    # unsharded 48 s reference that the sp4 ring is held against)
    paths = {"fused_glue_attention": "k1", "fused_residual_unit": "k1",
             "matmul_int4": "k1_int4"}
    parallel_launches = {
        name: {f"rank{r['rank']}": r["full"][path]["launches"][name]
               for r in parallel["ranks"]} for name, path in paths.items()}
    parallel_launches["flash_attention"] = {
        "unsharded_48s": parallel["ref_launches"]["sp"]["flash_attention"]}
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
               "rerank_k8_10s": rerank, "stream_60s": stream, "judge_k8_10s": judge,
               "int4_10s": int4, "int8_10s": int8, "visual_10s": visual,
               "visual_stream_30s": visual_stream, "spans_10s": spans, "serve": serve,
               "eval": evaluation, "small_train": small_train, "examples": examples,
               "tiny": tiny, "host_runtime": host_runtime,
               "train": train,
               "parallel": parallel, "power": smi}
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
