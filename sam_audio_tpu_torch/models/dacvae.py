"""DAC-VAE 48 kHz neural codec; counterpart of sam_audio_tpu/models/dacvae.py.

A Snake-activated conv encoder (dim 64, rates [2,8,10,12]), a VAE
bottleneck (in_proj -> mean half), and a mirrored transposed-conv decoder
(dim 1536, rates [12,10,8,2]); reference integration points:
sam_audio/model/codec.py:42-109. Weight norm is already folded into plain
weights in the parameter tree.

Every residual unit (snake -> k7 dilated conv -> snake -> k1 conv -> add) goes
through ops/fused_conv.fused_residual_unit: its CUDA kernel on the card, its
plain version on the CPU. The remaining convs go to F.conv1d /
F.conv_transpose1d, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math

import torch

from sam_audio_tpu_torch.config import DACVAEConfig
from sam_audio_tpu_torch.ops import conv as C
from sam_audio_tpu_torch.ops.fused_conv import fused_residual_unit

DILATIONS = (1, 3, 9)


def _residual_unit_apply(params, x, dilation, compute_dtype=None):
    out = fused_residual_unit(params, x, dilation,
                              compute_dtype=compute_dtype or x.dtype)
    return out.to(x.dtype)


def encoder_apply(params, x, cfg: DACVAEConfig, compute_dtype=None):
    """x: (B, 1, T) waveform -> (B, latent_dim, T/hop)."""
    h = C.conv1d(params["conv_in"], x, padding=3, compute_dtype=compute_dtype)
    for block, stride in zip(params["blocks"], cfg.encoder_rates):
        for res, dil in zip(block["res"], DILATIONS):
            h = _residual_unit_apply(res, h, dil, compute_dtype)
        h = C.snake(block["snake"], h)
        h = C.conv1d(block["conv"], h, stride=stride,
                     padding=math.ceil(stride / 2), compute_dtype=compute_dtype)
    h = C.snake(params["snake_out"], h)
    return C.conv1d(params["conv_out"], h, padding=1, compute_dtype=compute_dtype)


def decoder_apply(params, z, cfg: DACVAEConfig, compute_dtype=None):
    """z: (B, latent_dim, T) -> (B, 1, T*hop)."""
    h = C.conv1d(params["conv_in"], z, padding=3, compute_dtype=compute_dtype)
    for block, stride in zip(params["blocks"], cfg.decoder_rates):
        h = C.snake(block["snake"], h)
        h = C.conv_transpose1d(block["conv_t"], h, stride=stride,
                               padding=math.ceil(stride / 2),
                               compute_dtype=compute_dtype)
        for res, dil in zip(block["res"], DILATIONS):
            h = _residual_unit_apply(res, h, dil, compute_dtype)
    h = C.snake(params["snake_out"], h)
    h = C.conv1d(params["conv_out"], h, padding=3, compute_dtype=compute_dtype)
    return torch.tanh(h)


def pad_to_hop(wav: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Reflect-pad the waveform to a hop multiple (reference codec.py:72-78)."""
    rem = wav.shape[-1] % hop_length
    if rem == 0:
        return wav
    return C.pad1d(wav, (0, hop_length - rem), mode="reflect")


def encode(params, wav: torch.Tensor, cfg: DACVAEConfig, compute_dtype=None):
    """wav: (B, 1, T) -> mean latents (B, codebook_dim, ceil(T/hop))
    (reference codec.py:65-70; cfg.mean/std are never applied there)."""
    z = encoder_apply(params["encoder"], pad_to_hop(wav, cfg.hop_length), cfg,
                      compute_dtype)
    moments = C.conv1d(params["in_proj"], z, compute_dtype=compute_dtype)
    return moments[:, : cfg.codebook_dim]


def decode(params, encoded: torch.Tensor, cfg: DACVAEConfig, compute_dtype=None):
    """encoded: (B, codebook_dim, T) -> wav (B, 1, T*hop) (reference
    codec.py:86-89)."""
    emb = C.conv1d(params["out_proj"], encoded, compute_dtype=compute_dtype)
    return decoder_apply(params["decoder"], emb, cfg, compute_dtype)


def feature_idx_to_wav_idx(feature_idx, hop_length: int, sample_rate: int,
                           orig_sample_rate=None) -> int:
    """reference codec.py:91-109 (scalar index)."""
    orig = sample_rate if orig_sample_rate is None else orig_sample_rate
    return int(feature_idx * hop_length * (orig / sample_rate))
