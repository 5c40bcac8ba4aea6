"""Streaming separation of audio of any length; counterpart of
sam_audio_tpu/streaming.py.

The mixture is cut into overlapping fixed-size windows that share the
prompt; each window is a direct separate(), and the window outputs are
blended by a normalised sine crossfade. A 10 s window is T = 250 frames, so
every window runs the fused attention kernel (kernel 1) and the codec's
residual-unit kernel (kernel 3) at the shapes of a 10 s clip.

Noise: each window draws its own, on the model's device, from a generator
seeded by (a base seed, the item index, the ABSOLUTE window index)
(`_window_noise`), so the result does not depend on `batch_windows` and two
calls with equally seeded generators give the same bits. (The JAX package
folds the window index into one PRNG key; torch cannot reproduce that
stream.)

Video: the masked frames of the whole clip (any frame rate) are mapped to
the clip's latent frames by the nearest-frame map of processor.load_video,
from the GLOBAL latent frame (the identity when the video has one frame per
latent frame), and each window is conditioned on its own slice.

Two things of the JAX module exist only for XLA and are not carried over:
the pinning of the anchor-slot width across groups, and the padding of the
last group to `batch_windows` windows. The last group is solved at its true
size.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from sam_audio_tpu_torch.processor import Anchor, SAMAudioProcessor


@dataclass
class StreamingResult:
    target: np.ndarray
    residual: np.ndarray
    num_windows: int


def _crossfade_weights(length: int, fade: int) -> np.ndarray:
    """Sine ramp with w[i]^2 + w[length - fade + i]^2 == 1 across the overlap.

    The assembly divides by sum(w), so the blend is a normalised weighted
    overlap-add: identical window outputs blend to themselves (the
    correlated content adjacent windows share), where a raw equal-power sum
    would rise by up to 3 dB at the overlap's centre; fully decorrelated
    components dip by up to 3 dB in power at the seam instead."""
    w = np.ones(length, np.float32)
    if fade > 0:
        ramp = np.sin(0.5 * np.pi * (np.arange(fade) + 0.5) / fade)
        w[:fade] = ramp
        w[-fade:] = ramp[::-1]
    return w


def base_seed(generator: Optional[torch.Generator] = None) -> int:
    """One seed drawn from `generator` (or torch's global generator): the
    root of every window's noise."""
    if generator is None:
        return int(torch.randint(2 ** 62, (1,)))
    return int(torch.randint(2 ** 62, (1,), generator=generator, device=generator.device))


def _window_noise(seed: int, item: int, window: int, shape, device) -> torch.Tensor:
    """Standard normal noise of `shape` on `device` for window `window`
    (absolute index) of item `item`."""
    state = np.random.SeedSequence([seed, item, window]).generate_state(1, np.uint64)
    g = torch.Generator(device=device).manual_seed(int(state[0]))
    return torch.randn(shape, generator=g, device=device, dtype=torch.float32)


def separate_streaming(model, description: str, audio: np.ndarray, window_s: float = 10.0,
                       overlap_s: float = 1.0, anchors: Optional[List[Anchor]] = None,
                       reranking_candidates: int = 1,
                       generator: Optional[torch.Generator] = None,
                       seed: Optional[int] = None, item: int = 0, batch_windows: int = 1,
                       preview_nfe: Optional[int] = None, masked_video=None,
                       visual_stride: int = 1,
                       ode_opt: Optional[dict] = None) -> StreamingResult:
    """audio: (T,) or (channels, T) at model.sample_rate. Returns the
    full-length target and residual. Anchors are in absolute seconds and
    are clipped to each window. `masked_video` (optional): the masked
    frames (N, C, H, W) of the whole clip; `visual_stride` passes through to
    separate().

    The window noise derives from `seed` and `item`; without a seed, one is
    drawn from `generator`. `batch_windows` > 1 solves that many windows per
    separate() call. One worker thread preprocesses and solves group g+1
    while this thread blends group g; group 0 runs on this thread first, so
    the kernels are built once, before the worker starts."""
    sr, hop = model.sample_rate, model.hop_length
    processor = SAMAudioProcessor(audio_hop_length=hop, audio_sampling_rate=sr)
    wav = np.asarray(audio, np.float32)
    if wav.ndim == 2:
        wav = wav.mean(0)
    total = wav.shape[-1]
    win = int(window_s * sr) // hop * hop
    fade = min(int(overlap_s * sr) // hop * hop, win // 2)
    stride = win - fade
    if seed is None:
        seed = base_seed(generator)
    k = int(reranking_candidates)
    latent_ch = 2 * model.cfg.audio_codec.codebook_dim

    def solve(windows, chunks, window_anchors, window_videos=None):
        batch = processor(descriptions=[description] * len(chunks), audios=chunks,
                          anchors=window_anchors, masked_videos=window_videos)
        t_frames = batch.anchor_alignment.shape[-1]
        noise = torch.cat([_window_noise(seed, item, i, (k, t_frames, latent_ch), model.device)
                           for i in windows])
        return model.separate(batch, reranking_candidates=k, noise=noise,
                              preview_nfe=preview_nfe, visual_stride=visual_stride,
                              ode_opt=ode_opt)

    if total <= win:
        res = solve([0], [wav[None]], [anchors] if anchors else None,
                    [masked_video] if masked_video is not None else None)
        return StreamingResult(res.target[0], res.residual[0], 1)

    n_windows = 1 + math.ceil((total - win) / stride)
    bw = max(int(batch_windows), 1)

    def clip_anchors(start: int) -> List[Anchor]:
        s0, s1 = start / sr, (start + win) / sr
        return [(tok, max(a, s0) - s0, min(b, s1) - s0) for tok, a, b in anchors
                if min(b, s1) > max(a, s0)]

    fmap = None
    if masked_video is not None:
        mv = np.asarray(masked_video)
        total_f = -(-total // hop)   # latent frames of the whole clip
        fmap = (np.arange(total_f) if mv.shape[0] == total_f else
                np.round(np.linspace(0, mv.shape[0] - 1, total_f)).astype(int))

    def window_video(start: int):
        """The frames of the window's latent frames, by the global map."""
        f0 = start // hop
        return mv[fmap[np.minimum(np.arange(f0, f0 + win // hop), len(fmap) - 1)]]

    def run_group(g0: int):
        """Preprocess and solve windows g0 .. g0 + bw - 1 (the last group
        at its true size)."""
        group = list(range(g0, min(g0 + bw, n_windows)))
        starts = [min(i * stride, total - win) for i in group]
        res = solve(group, [wav[s: s + win][None] for s in starts],
                    [clip_anchors(s) for s in starts] if anchors else None,
                    [window_video(s) for s in starts] if fmap is not None else None)
        return group, starts, res

    out_t = np.zeros(total, np.float32)
    out_r = np.zeros(total, np.float32)
    norm = np.zeros(total, np.float32)
    w_base = _crossfade_weights(win, fade)
    current = run_group(0)
    with ThreadPoolExecutor(max_workers=1) as pool:
        for next_g0 in list(range(bw, n_windows, bw)) + [None]:
            # the worker solves the next group while this thread blends
            fut = pool.submit(run_group, next_g0) if next_g0 is not None else None
            group, starts, res = current
            for j, (i, start) in enumerate(zip(group, starts)):
                w = w_base
                if i == 0:   # the signal's edges keep full weight
                    w = w.copy()
                    w[:fade] = 1.0
                if start + win >= total:
                    w = w.copy()
                    w[-fade:] = 1.0
                out_t[start: start + win] += np.asarray(res.target[j])[:win] * w
                out_r[start: start + win] += np.asarray(res.residual[j])[:win] * w
                norm[start: start + win] += w
            if fut is None:
                break
            current = fut.result()
    norm = np.maximum(norm, 1e-8)
    return StreamingResult(out_t / norm, out_r / norm, n_windows)
