"""Eval metrics: Judge / Aesthetic / CLAP / ImageBind (counterpart of
sam_audio_tpu/eval/metrics.py; reference: eval/metrics/{judge,aes,clap,
imagebind}.py).

Each metric is a callable taking the eval loop's keyword arguments
(target_wavs, input_wavs, descriptions, videos, target_wavs_sample_rate)
and returning {metric name: [one float per item]} as host lists. Its towers
run on `device` (default cuda). A metric with no weights refuses to score
unless `allow_random=True` (hermetic runs); `model=` takes a built tower.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

COLUMN_MAP = {
    "CE": "ContentEnjoyment",
    "CU": "ContentUsefulness",
    "PC": "ProductionComplexity",
    "PQ": "ProductionQuality",
}


def _require_weights(name: str, staging_hint: str, allow_random: bool):
    """Eval metrics never score with random weights unasked: the numbers
    would print as if real. Tests pass model= or allow_random=True."""
    if allow_random:
        logging.getLogger(__name__).warning(
            "%s metric running with RANDOM weights (allow_random=True): scores are "
            "meaningless; for real runs %s", name, staging_hint)
        return
    raise ValueError(
        f"{name} eval metric has no weights: {staging_hint}. Refusing to score with "
        f"random init (the numbers would be meaningless but printed as if real); pass "
        f"allow_random=True only in hermetic tests.")


def _host(x: torch.Tensor) -> np.ndarray:
    return x.float().cpu().numpy()


class Judge:
    """4-axis judge scores (reference: eval/metrics/judge.py:23-44). The
    checkpoint is a local judge snapshot directory (config.json +
    params.npz and the tokenizer's files)."""

    keys = ("JudgeOverall", "JudgeFaithfulness", "JudgeRecall", "JudgePrecision")

    def __init__(self, checkpoint: str = "facebook/sam-audio-judge", model=None,
                 processor=None, device="cuda"):
        if model is None:
            from sam_audio_tpu_torch.models.judge import SAMAudioJudgeModel

            model = SAMAudioJudgeModel.from_pretrained(checkpoint, device=device)
        if processor is None:
            from sam_audio_tpu_torch.processor import SAMAudioJudgeProcessor

            processor = SAMAudioJudgeProcessor.from_pretrained(checkpoint)
        self.model = model
        self.processor = processor

    def __call__(self, input_wavs, target_wavs, descriptions,
                 target_wavs_sample_rate: int = 48_000, **kwargs):
        processed = self.processor(
            text=descriptions,
            input_audio=[np.asarray(x) for x in input_wavs],
            separated_audio=[np.asarray(x) for x in target_wavs],
            sampling_rate=target_wavs_sample_rate)
        dev = self.model.device

        def on_device(name, dtype):
            return torch.as_tensor(np.asarray(processed[name]), dtype=dtype, device=dev)

        result = self.model(input_ids=on_device("input_ids", torch.long),
                            input_values=on_device("input_values", torch.float32),
                            separated_values=on_device("separated_values", torch.float32),
                            attention_mask=on_device("attention_mask", torch.bool),
                            padding_mask=on_device("padding_mask", torch.bool))
        return {key: _host(getattr(result, field))[:, 0].tolist()
                for key, field in zip(self.keys, ("overall", "faithfulness", "recall",
                                                  "precision"))}


class Aesthetic:
    """CE / CU / PC / PQ (reference: eval/metrics/aes.py:8-49). `checkpoint`:
    an audiobox-aesthetics torch checkpoint (.pt / .pth / .ckpt, converted
    on load), the directory `python -m sam_audio_tpu_torch.convert
    aesthetics` writes (config.json + params.npz), or a flat npz of the
    AesPredictor stand-in."""

    keys = tuple(COLUMN_MAP.values())

    def __init__(self, checkpoint: Optional[str] = None, model=None,
                 allow_random: bool = False, device="cuda"):
        if model is None:
            from sam_audio_tpu_torch.models.aesthetics import AesPredictor, AudioboxAesthetics

            if checkpoint and checkpoint.endswith((".pt", ".pth", ".ckpt")):
                model = AudioboxAesthetics.from_torch_checkpoint(checkpoint, device=device)
            elif checkpoint and os.path.isfile(os.path.join(checkpoint, "config.json")):
                model = AudioboxAesthetics.from_pretrained(checkpoint, device=device)
            elif checkpoint:
                model = AesPredictor.from_pretrained(checkpoint, device=device)
            else:
                _require_weights(
                    "Aesthetic", "convert audiobox-aesthetics (python -m "
                    "sam_audio_tpu_torch.convert aesthetics) and pass checkpoint=",
                    allow_random)
                model = AesPredictor.init_random(seed=0, device=device)
        self.model = model

    def __call__(self, target_wavs, target_wavs_sample_rate: int = 48_000, **kwargs):
        result = self.model([np.asarray(w) for w in target_wavs], target_wavs_sample_rate)
        return {long_name: [row[short] for row in result]
                for short, long_name in COLUMN_MAP.items()}


class CLAP:
    """Text <-> audio similarity (reference: eval/metrics/clap.py:14-46);
    `checkpoint` is a converted laion_clap npz."""

    keys = ("CLAPSimilarity",)

    def __init__(self, checkpoint: Optional[str] = None, model=None,
                 allow_random: bool = False, device="cuda"):
        if model is None:
            from sam_audio_tpu_torch.models.clap import ClapConfig, ClapModel

            if checkpoint:
                from sam_audio_tpu_torch.checkpoint import load_params
                from sam_audio_tpu_torch.models.sam_audio import resolve_device

                model = ClapModel(ClapConfig(), load_params(checkpoint, resolve_device(device)))
            else:
                _require_weights(
                    "CLAP", "convert laion_clap 630k-best.pt (python -m "
                    "sam_audio_tpu_torch.convert clap) and pass checkpoint=", allow_random)
                model = ClapModel.init_random(seed=0, device=device)
        self.model = model

    def __call__(self, target_wavs, descriptions, target_wavs_sample_rate: int = 48_000,
                 **kwargs):
        from sam_audio_tpu_torch.models.clap import fit_duration_np
        from sam_audio_tpu_torch.ops.resample import resample_np

        sr = self.model.cfg.sample_rate
        n = self.model.cfg.n_samples
        wavs = []
        for w in target_wavs:
            w = np.asarray(w, np.float32).reshape(-1)
            if target_wavs_sample_rate != sr:
                w = resample_np(w, target_wavs_sample_rate, sr)
            wavs.append(fit_duration_np(w, n))
        audio_embs = _host(self.model.get_audio_embedding(
            torch.as_tensor(np.stack(wavs), device=self.model.device)))
        text_embs = _host(self.model.get_text_embedding(list(descriptions)))
        return {"CLAPSimilarity": np.einsum("bd,bd->b", audio_embs, text_embs).tolist()}


class ImageBind:
    """Audio <-> video cosine (reference: eval/metrics/imagebind.py:12-52);
    `checkpoint` is a converted ImageBind npz (imagebind_huge or the light
    towers)."""

    keys = ("ImageBind",)

    def __init__(self, checkpoint: Optional[str] = None, model=None,
                 allow_random: bool = False, device="cuda"):
        if model is None:
            from sam_audio_tpu_torch.models.imagebind import ImageBindModel, load_imagebind_model

            if checkpoint:
                model = load_imagebind_model(checkpoint, device=device)
            else:
                _require_weights(
                    "ImageBind", "convert imagebind_huge.pth (python -m "
                    "sam_audio_tpu_torch.convert imagebind) and pass checkpoint=",
                    allow_random)
                model = ImageBindModel.init_random(seed=0, device=device)
        self.model = model

    def __call__(self, target_wavs, videos, target_wavs_sample_rate: int = 48_000, **kwargs):
        audio_embs = _host(self.model.embed_audio([np.asarray(w) for w in target_wavs],
                                                  target_wavs_sample_rate))
        video_embs = _host(self.model.embed_videos([np.asarray(v) for v in videos]))
        return {"ImageBind": np.einsum("bd,bd->b", audio_embs, video_embs).tolist()}
