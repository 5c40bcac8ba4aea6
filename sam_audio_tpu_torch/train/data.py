"""Training data pipeline: (mixture, target, residual, text) examples ->
flow-matching batches; counterpart of sam_audio_tpu/train/data.py.

Host-side batching and tokenization (the port's processor, with JAX's
length bucketing and anchor-slot padding, which fix a batch's shapes) and
featurization on the device: one batched DAC-VAE encode of the three stems
(kernel 3 on the card) and T5, under torch.no_grad(): the towers are frozen
and outside the loss.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from sam_audio_tpu_torch.checkpoint import cast_matmul_weights
from sam_audio_tpu_torch.config import SAMAudioConfig
from sam_audio_tpu_torch.models import dacvae
from sam_audio_tpu_torch.models.sam_audio import DTYPES
from sam_audio_tpu_torch.models.t5 import t5_encode
from sam_audio_tpu_torch.processor import Anchor, SAMAudioProcessor
from sam_audio_tpu_torch.utils import tree_map


@dataclass
class TrainExample:
    mixture: np.ndarray          # (1, T) or (T,) waveform @ model sample rate
    target: np.ndarray           # ground-truth isolated source
    residual: np.ndarray         # mixture minus target
    description: str
    anchors: Optional[List[Anchor]] = None


@torch.no_grad()
def encode_training_batch(params, mixtures, targets, residuals, text_ids, text_mask,
                          anchor_ids, anchor_alignment, audio_pad_mask, *,
                          cfg: SAMAudioConfig) -> Dict[str, torch.Tensor]:
    """Device-side featurization: codec-encode the three stems in ONE batched
    pass (3B rows) and build the conditioning and target latents. `params`
    holds "audio_codec" and "text_encoder"."""
    compute_dtype = DTYPES[cfg.compute_dtype]
    b = mixtures.shape[0]
    stacked = torch.cat([mixtures, targets, residuals], dim=0)
    lat = dacvae.encode(params["audio_codec"], stacked, cfg.audio_codec,
                        compute_dtype=compute_dtype)
    lat = lat.transpose(1, 2).float()                         # (3B, T, C)
    mix_lat, tgt_lat, res_lat = lat[:b], lat[b:2 * b], lat[2 * b:]
    text_features = t5_encode(params["text_encoder"], text_ids, text_mask,
                              cfg.text_encoder, compute_dtype=compute_dtype)
    return {
        "audio_features": torch.cat([mix_lat, mix_lat], dim=2),
        "target_latents": torch.cat([tgt_lat, res_lat], dim=2),
        "text_features": text_features,
        "text_mask": text_mask.bool(),
        "anchor_ids": anchor_ids,
        "anchor_alignment": anchor_alignment,
        "audio_pad_mask": audio_pad_mask.bool(),
    }


def pad_text_to_bucket(ids, mask, multiple: int = 16):
    """Round the tokenized text width up to a multiple of `multiple` (JAX's
    compile-shape bucketing; kept so that a batch has JAX's shapes). Padded
    positions carry mask=False, which T5 and the cross-attention honour."""
    ids = np.asarray(ids)
    mask = np.asarray(mask)
    n = ids.shape[1]
    target = -(-max(n, 1) // multiple) * multiple
    if target == n:
        return ids, mask
    pad = ((0, 0), (0, target - n))
    return np.pad(ids, pad), np.pad(mask, pad)


def frozen_towers(cfg: SAMAudioConfig, params):
    """Copies of the codec and text encoder for featurization, their matmul
    weights stored in the compute dtype (the inference path's storage: the
    same numbers as a cast per op). The copies leave the trainer's tree
    alone."""
    towers = tree_map(lambda x: x.detach().clone(),
                      {"audio_codec": params["audio_codec"],
                       "text_encoder": params["text_encoder"]})
    compute_dtype = DTYPES[cfg.compute_dtype]
    if compute_dtype != torch.float32:
        towers = cast_matmul_weights(towers, compute_dtype)
    return towers


def as2d(w) -> np.ndarray:
    w = np.asarray(w, np.float32)
    return w if w.ndim == 2 else w[None]


def pad_stack(wavs, tmax: int) -> np.ndarray:
    """Mono (B, 1, tmax) of `wavs`, each cut or zero-padded to tmax."""
    out = np.zeros((len(wavs), 1, tmax), np.float32)
    for i, w in enumerate(wavs):
        w = as2d(w).mean(0)
        out[i, 0, : min(w.shape[-1], tmax)] = w[:tmax]
    return out


class FlowMatchingDataPipeline:
    """Host batching + device featurization for flow-matching training.

    Time is bucketed (`bucket_seconds`), text to multiples of `text_bucket`,
    and anchor slots are padded to at least `pad_anchors_to`, as in JAX: they
    fix a batch's shapes, and with them the loss's mask and mean."""

    def __init__(self, cfg: SAMAudioConfig, params, tokenizer,
                 bucket_seconds: float = 2.0, text_bucket: int = 16,
                 pad_anchors_to: int = 8):
        self.cfg = cfg
        self.params = frozen_towers(cfg, params)
        self.device = params["audio_codec"]["in_proj"]["weight"].device
        self.tokenizer = tokenizer
        self.text_bucket = int(text_bucket)
        self.pad_anchors_to = int(pad_anchors_to)
        self.processor = SAMAudioProcessor(
            audio_hop_length=cfg.audio_codec.hop_length,
            audio_sampling_rate=cfg.audio_codec.sample_rate,
            bucket_seconds=bucket_seconds,
        )

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def make_batch(self, examples: Sequence[TrainExample]) -> Dict[str, Any]:
        # anchors are all-or-nothing per batch; examples without spans get an
        # empty list (only the <null>/<pad> slots, like no-anchor items)
        anchors = None
        if any(e.anchors for e in examples):
            anchors = [e.anchors or [] for e in examples]
        batch = self.processor(
            descriptions=[e.description for e in examples],
            audios=[as2d(e.mixture) for e in examples],
            anchors=anchors,
            pad_anchors_to=self.pad_anchors_to,
        )
        tmax = batch.audios.shape[-1]
        ids, mask = self.tokenizer([e.description for e in examples],
                                   max_length=self.cfg.text_encoder.max_length)
        ids, mask = pad_text_to_bucket(ids, mask, self.text_bucket)
        t = self._tensor
        return encode_training_batch(
            self.params, t(batch.audios), t(pad_stack([e.target for e in examples], tmax)),
            t(pad_stack([e.residual for e in examples], tmax)),
            t(ids, torch.long), t(mask, torch.bool), t(batch.anchor_ids, torch.long),
            t(batch.anchor_alignment, torch.long), t(batch.audio_pad_mask, torch.bool),
            cfg=self.cfg)
