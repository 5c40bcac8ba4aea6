"""Span-predictor training; counterpart of sam_audio_tpu/train/span.py.

Trains the native span predictor (models/span_predictor.SpanPredictor) from
the same records the flow-matching trainer reads. Self-supervised labels: a
latent frame is positive when the TARGET stem is audible in it, its RMS
within `activity_db` of the stem's peak frame RMS and above an absolute
floor (the sound-activity ranker's criterion). The objective is per-frame
weighted binary cross-entropy on the predictor's logits, masked to real
frames. Featurization encodes the mixture (kernel 3 on the card) and the
text under torch.no_grad(); the predictor's 64-wide heads run plain sdpa.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from sam_audio_tpu_torch import checkpoint
from sam_audio_tpu_torch.config import SAMAudioConfig
from sam_audio_tpu_torch.models import dacvae
from sam_audio_tpu_torch.models.init import span_predictor_init
from sam_audio_tpu_torch.models.sam_audio import DTYPES, resolve_device
from sam_audio_tpu_torch.models.span_predictor import (
    SpanPredictor, SpanPredictorConfig, span_predictor_forward)
from sam_audio_tpu_torch.models.t5 import t5_encode
from sam_audio_tpu_torch.processor import SAMAudioProcessor
from sam_audio_tpu_torch.train.data import as2d, frozen_towers, pad_stack, pad_text_to_bucket
from sam_audio_tpu_torch.train.flow_matching import (
    Trainer, TrainState, apply_step, make_lr_schedule, new_train_state)
from sam_audio_tpu_torch.utils import tree_map


def frame_activity_labels(wavs, hop: int, t_frames: int, activity_db: float = -40.0,
                          silence_floor: float = 1e-4) -> torch.Tensor:
    """(B, 1, Twav) or (B, Twav) waveforms -> (B, t_frames) {0, 1} float32
    labels, on the waveforms' device. An all-silent stem yields all-zero
    labels."""
    w = torch.as_tensor(wavs, dtype=torch.float32)
    if w.ndim == 3:
        w = w[:, 0, :]
    b, t_wav = w.shape
    pad = t_frames * hop - t_wav
    w = w[:, : t_frames * hop] if pad < 0 else torch.nn.functional.pad(w, (0, pad))
    frames = w.reshape(b, t_frames, hop)
    rms = torch.sqrt(torch.mean(torch.square(frames), dim=-1) + 1e-12)
    peak = torch.amax(rms, dim=-1, keepdim=True)
    thresh = peak * (10.0 ** (activity_db / 20.0))
    return ((rms > thresh) & (rms > silence_floor)).float()


@torch.no_grad()
def encode_span_batch(tower_params, mixtures, targets, text_ids, text_mask, audio_pad_mask,
                      *, cfg: SAMAudioConfig, audio_dim: int) -> Dict[str, torch.Tensor]:
    """Featurization for span training: codec-encode the MIXTURE (the
    predictor reads its first `audio_dim` latent channels), T5-encode the
    text, and derive the activity labels from the TARGET stem."""
    compute_dtype = DTYPES[cfg.compute_dtype]
    lat = dacvae.encode(tower_params["audio_codec"], mixtures, cfg.audio_codec,
                        compute_dtype=compute_dtype)
    lat = lat.transpose(1, 2).float()[..., :audio_dim]
    text_features = t5_encode(tower_params["text_encoder"], text_ids, text_mask,
                              cfg.text_encoder, compute_dtype=compute_dtype)
    labels = frame_activity_labels(targets, cfg.audio_codec.hop_length, lat.shape[1])
    return {
        "audio_features": lat,
        "text_features": text_features,
        "text_mask": text_mask.bool(),
        "audio_pad_mask": audio_pad_mask.bool(),
        "labels": labels,
    }


def span_bce_loss(sp_params, sp_cfg: SpanPredictorConfig, batch: Dict[str, Any],
                  pos_weight: float = 1.0, return_logits: bool = False):
    """Masked per-frame BCE-with-logits; `pos_weight` scales the positive
    class. `return_logits=True` also returns the logits, so that a step
    computes its frame metrics without a second forward."""
    logits = span_predictor_forward(
        sp_params, sp_cfg, batch["audio_features"], batch["audio_pad_mask"],
        batch["text_features"], batch["text_mask"]).float()
    y = batch["labels"].float()
    # stable BCE: max(x,0) - x*y + log1p(exp(-|x|)), positives weighted
    per = torch.clamp(logits, min=0.0) - logits * y + torch.log1p(torch.exp(-logits.abs()))
    w = torch.where(y > 0.5, torch.full_like(y, pos_weight), torch.ones_like(y))
    mask = batch["audio_pad_mask"].float()
    loss = torch.sum(per * w * mask) / torch.clamp(torch.sum(w * mask), min=1.0)
    return (loss, logits) if return_logits else loss


def _frame_metrics(logits, labels, mask):
    mask = mask.bool()
    pred = (logits > 0.0) & mask
    pos = (labels > 0.5) & mask
    tp = torch.sum(pred & pos).float()
    precision = tp / torch.clamp(torch.sum(pred), min=1)
    recall = tp / torch.clamp(torch.sum(pos), min=1)
    f1 = 2 * precision * recall / torch.clamp(precision + recall, min=1e-9)
    return {"frame_precision": precision, "frame_recall": recall, "frame_f1": f1}


class SpanTrainer:
    """AdamW trainer over the native span predictor (no EMA, nothing
    frozen). Same step / fit interface as the flow-matching Trainer; the
    objective draws no random numbers."""

    def __init__(self, sp_cfg: SpanPredictorConfig, params=None, *, device="cuda",
                 seed: int = 0, learning_rate: float = 3e-4, weight_decay: float = 0.01,
                 grad_clip: float = 1.0, lr_schedule: str = "constant",
                 warmup_steps: int = 0, total_steps: int = 0,
                 final_lr_ratio: float = 0.0, pos_weight: float = 1.0):
        self.cfg = sp_cfg
        self.device = resolve_device(device)
        if params is None:
            params = span_predictor_init(
                sp_cfg, torch.Generator(device=self.device).manual_seed(seed), self.device)
        params = tree_map(lambda x: x.detach().to(self.device), params)
        self.state: TrainState = new_train_state(
            params, lambda path: True, weight_decay=weight_decay, ema_decay=0.0,
            accum_steps=1, generators={})
        lr = make_lr_schedule(learning_rate, lr_schedule, warmup_steps, total_steps,
                              final_lr_ratio)

        def train_step(state: TrainState, batch):
            def loss_fn():
                # the metrics reuse the loss pass's logits (pre-update params)
                loss, logits = span_bce_loss(state.params, sp_cfg, batch,
                                             pos_weight=pos_weight, return_logits=True)
                return loss, _frame_metrics(logits.detach(), batch["labels"],
                                            batch["audio_pad_mask"])

            return apply_step(state, loss_fn, grad_clip=grad_clip, lr_schedule=lr)

        self._step = train_step

    def step(self, batch) -> Dict[str, torch.Tensor]:
        return self._step(self.state, batch)

    def ema_inference_params(self):
        return tree_map(lambda p: p.detach(), self.state.params)

    fit = Trainer.fit


class SpanDataPipeline:
    """Host batching + device featurization for span training; reads the
    same TrainExample records as the flow-matching pipeline (residual and
    anchors unused: the target stem supplies the labels)."""

    def __init__(self, cfg: SAMAudioConfig, params, tokenizer, sp_cfg: SpanPredictorConfig,
                 bucket_seconds: float = 2.0, text_bucket: int = 16):
        self.cfg = cfg
        self.sp_cfg = sp_cfg
        self.text_bucket = int(text_bucket)
        self.params = frozen_towers(cfg, params)
        self.device = params["audio_codec"]["in_proj"]["weight"].device
        self.tokenizer = tokenizer
        self.processor = SAMAudioProcessor(
            audio_hop_length=cfg.audio_codec.hop_length,
            audio_sampling_rate=cfg.audio_codec.sample_rate,
            bucket_seconds=bucket_seconds,
        )

    def make_batch(self, examples: Sequence) -> Dict[str, Any]:
        batch = self.processor(descriptions=[e.description for e in examples],
                               audios=[as2d(e.mixture) for e in examples])
        targets = pad_stack([e.target for e in examples], batch.audios.shape[-1])
        ids, mask = self.tokenizer([e.description for e in examples],
                                   max_length=self.cfg.text_encoder.max_length)
        ids, mask = pad_text_to_bucket(ids, mask, self.text_bucket)

        def t(x, dtype=None):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

        return encode_span_batch(
            self.params, t(batch.audios), t(targets), t(ids, torch.long), t(mask, torch.bool),
            t(batch.audio_pad_mask, torch.bool), cfg=self.cfg, audio_dim=self.sp_cfg.audio_dim)


def save_span_predictor(snapshot_dir: str, sp_cfg: SpanPredictorConfig, params) -> str:
    """Write <snapshot>/span_predictor/{config.json, params.npz} (the native
    arch's tag), so that `SAMAudio.from_pretrained(snapshot)` of either
    package attaches the trained predictor; names a span predictor in the
    snapshot's config.json if it names none."""
    return checkpoint.save_span_predictor(
        snapshot_dir, SpanPredictor(sp_cfg, tree_map(lambda p: p.detach(), params)))


def synthetic_span_batch(cfg: SAMAudioConfig, sp_cfg: SpanPredictorConfig,
                         generator: torch.Generator, batch_size: int = 2,
                         t_frames: int = 16, text_len: int = 8):
    """Random span-training batch with the right shapes (smoke tests). The
    labels are a fixed function of the first audio-feature channel, so the
    objective is learnable. On the generator's device."""
    dev = generator.device
    feats = torch.randn((batch_size, t_frames, sp_cfg.audio_dim), generator=generator,
                        device=dev)
    return {
        "audio_features": feats,
        "text_features": torch.randn((batch_size, text_len, cfg.text_encoder.dim),
                                     generator=generator, device=dev),
        "text_mask": torch.ones((batch_size, text_len), dtype=torch.bool, device=dev),
        "audio_pad_mask": torch.ones((batch_size, t_frames), dtype=torch.bool, device=dev),
        "labels": (feats[..., 0] > 0).float(),
    }
