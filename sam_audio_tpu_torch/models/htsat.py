"""HTSAT, the CLAP audio tower (counterpart of sam_audio_tpu/models/htsat.py).

laion_clap's audio branch for "HTSAT-tiny": a swin transformer over a log-mel
"image". wav (10 s at 48 kHz) -> STFT (n_fft 1024, hop 480, periodic Hann,
reflect centre pad) -> power -> 64 Slaney mels (`melW`) -> 10*log10 ->
BatchNorm over the mel bins (eval statistics) -> bicubic time resize
(align_corners) to spec_size*freq_ratio frames, folded into a
(spec_size, spec_size) image -> 4x4 conv patch embed -> swin stages (window
attention with relative-position bias, shifted windows, patch merging) ->
LayerNorm -> mean over tokens = the CLAP `embedding`.

The parameter tree is the JAX package's (stages and blocks as lists, torch
layouts), so a JAX tree bridged by checkpoint.params_from_numpy runs as it is.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sam_audio_tpu_torch.ops import nn as N
from sam_audio_tpu_torch.ops.mel import stft_power


@dataclass(frozen=True)
class HTSATConfig:
    sample_rate: int = 48_000
    n_fft: int = 1024
    hop_length: int = 480
    n_mels: int = 64
    fmin: float = 50.0
    fmax: float = 14_000.0
    spec_size: int = 256
    patch_size: int = 4
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 8
    mlp_ratio: float = 4.0
    bn_eps: float = 1e-5
    ln_eps: float = 1e-5

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.n_mels

    @property
    def out_dim(self) -> int:
        return self.embed_dim * 2 ** (len(self.depths) - 1)


@lru_cache(maxsize=8)
def _bicubic_weights(in_len: int, out_len: int):
    """Per-output gather indices (out, 4) and kernel weights (out, 4) of
    torch's bicubic interpolation (align_corners=True, A = -0.75)."""
    a = -0.75
    if out_len == 1 or in_len == 1:
        src = np.zeros(out_len)
    else:
        src = np.arange(out_len) * (in_len - 1) / (out_len - 1)
    x0 = np.floor(src).astype(np.int64)
    frac = src - x0

    def k(t):
        at = np.abs(t)
        return np.where(at <= 1, (a + 2) * at**3 - (a + 3) * at**2 + 1,
                        np.where(at < 2, a * at**3 - 5 * a * at**2 + 8 * a * at - 4 * a,
                                 0.0))

    offs = np.arange(-1, 3)
    idx = np.clip(x0[:, None] + offs[None, :], 0, in_len - 1)
    return idx, k(frac[:, None] - offs[None, :]).astype(np.float32)


def bicubic_resize_1d(x: torch.Tensor, out_len: int, axis: int) -> torch.Tensor:
    """F.interpolate(mode='bicubic', align_corners=True) along one axis."""
    in_len = x.shape[axis]
    if in_len == out_len:
        return x
    idx, w = _bicubic_weights(in_len, out_len)
    xt = x.movedim(axis, -1)
    gathered = xt[..., torch.as_tensor(idx, device=x.device)]      # (..., out, 4)
    out = torch.einsum("...ok,ok->...o", gathered, torch.as_tensor(w, device=x.device))
    return out.movedim(-1, axis)


@lru_cache(maxsize=32)
def _relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)  # (ws^2, ws^2)


@lru_cache(maxsize=32)
def _shift_attn_mask(res: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws^2, ws^2) additive mask of the shifted windows (0 / -100)."""
    img = np.zeros((res, res), np.int64)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(res // ws, ws, res // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def _window_reverse(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def _swin_block(params, x, res: int, nh: int, ws: int, shift: int, eps: float,
                compute_dtype):
    """One swin block on tokens x: (B, res*res, C)."""
    b, n, c = x.shape
    hd = c // nh
    shortcut = x
    y = N.layernorm(params["norm1"], x, eps).reshape(b, res, res, c)
    if shift > 0:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))
    win = _window_partition(y, ws)                       # (B*nW, ws^2, C)
    bw, t, _ = win.shape
    qkv = N.linear(params["qkv"], win, compute_dtype).reshape(bw, t, 3, nh, hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))   # (bw, nh, t, hd)
    attn = (q * (hd ** -0.5)) @ k.transpose(-1, -2)
    rpi = torch.as_tensor(_relative_position_index(ws).reshape(-1), device=x.device)
    bias = params["relative_position_bias_table"][rpi].reshape(t, t, nh).permute(2, 0, 1)
    attn = attn + bias[None].to(attn.dtype)
    if shift > 0:
        mask = torch.as_tensor(_shift_attn_mask(res, ws, shift), device=x.device)
        n_w = mask.shape[0]
        attn = attn.reshape(bw // n_w, n_w, nh, t, t) + mask[None, :, None].to(attn.dtype)
        attn = attn.reshape(bw, nh, t, t)
    attn = torch.softmax(attn.float(), dim=-1)
    if compute_dtype is not None:
        attn = attn.to(compute_dtype)
    o = (attn @ v).transpose(1, 2).reshape(bw, t, c)
    o = N.linear(params["proj"], o, compute_dtype)
    o = _window_reverse(o, ws, res, res)
    if shift > 0:
        o = torch.roll(o, (shift, shift), dims=(1, 2))
    x = shortcut + o.reshape(b, n, c)
    y = N.layernorm(params["norm2"], x, eps)
    y = N.linear(params["fc2"], F.gelu(N.linear(params["fc1"], y, compute_dtype)),
                 compute_dtype)
    return x + y


def _patch_merge(params, x, res: int, eps: float, compute_dtype):
    """(B, res*res, C) -> (B, (res/2)^2, 2C), the official swin slice order."""
    b, n, c = x.shape
    y = x.reshape(b, res, res, c)
    y = torch.cat([y[:, 0::2, 0::2], y[:, 1::2, 0::2], y[:, 0::2, 1::2],
                   y[:, 1::2, 1::2]], dim=-1).reshape(b, n // 4, 4 * c)
    return N.linear(params["reduction"], N.layernorm(params["norm"], y, eps), compute_dtype)


def htsat_logmel(params, cfg: HTSATConfig, wav: torch.Tensor) -> torch.Tensor:
    """wav (B, T) -> log-mel (B, frames, n_mels), torchlibrosa numerics."""
    spec = stft_power(wav, cfg.n_fft, cfg.hop_length, center=True, power=2.0)
    mel = spec @ params["melW"].to(spec.dtype)
    return 10.0 * torch.log10(torch.clamp(mel, min=1e-10))


def _reshape_wav2img(x: torch.Tensor, cfg: HTSATConfig) -> torch.Tensor:
    """(B, T, F) log-mel -> (B, 1, spec, spec) image (HTSAT freq-fold)."""
    b = x.shape[0]
    ratio = cfg.freq_ratio
    target_t = cfg.spec_size * ratio
    assert x.shape[1] <= target_t, (x.shape, target_t)
    x = bicubic_resize_1d(x, target_t, axis=1)
    if x.shape[2] < cfg.spec_size // ratio:
        x = bicubic_resize_1d(x, cfg.spec_size // ratio, axis=2)
    x = x.transpose(1, 2)                                    # (B, F, T)
    f = x.shape[1]
    x = x.reshape(b, f, ratio, target_t // ratio)
    return x.permute(0, 2, 1, 3).reshape(b, 1, ratio * f, target_t // ratio)


def htsat_embed(params, cfg: HTSATConfig, wav: torch.Tensor,
                compute_dtype=None) -> torch.Tensor:
    """wav: (B, n_samples) -> (B, out_dim) CLAP audio `embedding`."""
    logmel = htsat_logmel(params, cfg, wav)
    bn = params["bn0"]
    logmel = ((logmel - bn["mean"].float()) / torch.sqrt(bn["var"].float() + cfg.bn_eps)
              * bn["weight"].float() + bn["bias"].float())
    img = _reshape_wav2img(logmel, cfg)
    if compute_dtype is not None:
        img = img.to(compute_dtype)
    pe = params["patch_embed"]
    x = F.conv2d(img, pe["proj"]["weight"].to(img.dtype), stride=cfg.patch_size)
    x = x + pe["proj"]["bias"].to(img.dtype)[None, :, None, None]
    b, c, gh, gw = x.shape
    x = N.layernorm(pe["norm"], x.reshape(b, c, gh * gw).transpose(1, 2), cfg.ln_eps)
    res = gh
    for li, depth in enumerate(cfg.depths):
        stage = params["stages"][li]
        ws = min(cfg.window_size, res)
        for j in range(depth):
            shift = 0 if (j % 2 == 0 or res <= ws) else ws // 2
            x = _swin_block(stage["blocks"][j], x, res, cfg.num_heads[li], ws, shift,
                            cfg.ln_eps, compute_dtype)
        if "downsample" in stage:
            x = _patch_merge(stage["downsample"], x, res, cfg.ln_eps, compute_dtype)
            res //= 2
    x = N.layernorm(params["norm"], x, cfg.ln_eps)
    # the adaptive average pool over the freq-folded tokens is the token mean
    return torch.mean(x.float(), dim=1)
