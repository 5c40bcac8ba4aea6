"""CLAP text <-> audio ranker (reference: sam_audio/ranking/clap.py:11-86):
each candidate's audio embedding scored against its prompt's text embedding.
Counterpart of sam_audio_tpu/ranking/clap.py.

Two scoring paths:
  * `score_on_device` — the serving path: the decoded candidates stay on the
    card and repeat-padding is a cyclic gather on their true lengths, with
    the crop starts drawn on the host from the same seeded RandomState
    sequence as the host path. SAMAudio.separate takes it when the clip fits
    the 10 s CLAP window at the CLAP sample rate.
  * `__call__` — the host path for any length and sample rate: per-row numpy
    resampling, repeat-pad and seeded rand_trunc (reference clap.py:59-61).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from sam_audio_tpu_torch.config import ClapRankerConfig
from sam_audio_tpu_torch.models.clap import (
    ClapConfig,
    ClapModel,
    clap_audio_embed,
    clap_text_embed,
    fit_duration_np,
)
from sam_audio_tpu_torch.ops.resample import resample_np
from sam_audio_tpu_torch.ranking.ranker import Ranker


class ClapRanker(Ranker):
    def __init__(self, config: ClapRankerConfig, model: Optional[ClapModel] = None,
                 allow_random: bool = False, seed: int = 0, device="cuda"):
        self.config = config
        self._model = model
        self.allow_random = allow_random
        self.device = device
        # rand_trunc seed: laion_clap crops >10 s audio at random
        # (reference ranking/clap.py:59-61); the crop is reproducible here
        self.seed = seed

    @property
    def model(self) -> ClapModel:
        if self._model is None:
            if self.config.checkpoint:
                from sam_audio_tpu_torch.checkpoint import load_params
                from sam_audio_tpu_torch.models.sam_audio import resolve_device

                self._model = ClapModel(ClapConfig(), load_params(
                    self.config.checkpoint, resolve_device(self.device)))
            elif self.allow_random:
                # tests and benchmarks only: random weights give meaningless scores
                self._model = ClapModel.init_random(seed=0, device=self.device)
            else:
                raise ValueError(
                    "ClapRanker has no weights: ClapRankerConfig.checkpoint is empty "
                    "(convert a laion_clap checkpoint with `python -m "
                    "sam_audio_tpu_torch.convert clap --torch 630k-best.pt --out "
                    "clap.npz` and set checkpoint=). The "
                    "reference always loads real ranker weights "
                    "(sam_audio/ranking/clap.py:16-19); pass allow_random=True only "
                    "for tests.")
        return self._model

    def supports_on_device(self, sizes, sample_rate: int) -> bool:
        """On-device scoring equals the host path when the audio is at the
        CLAP sample rate and every candidate fits the window."""
        cfg = self.model.cfg
        return sample_rate == cfg.sample_rate and all(0 < int(s) <= cfg.n_samples
                                                      for s in sizes)

    @torch.inference_mode()
    def score_on_device(self, targets: torch.Tensor, sizes, descriptions,
                        mixtures=None) -> torch.Tensor:
        """targets: (bsz, k, T_pad) on the card at the CLAP rate; sizes: each
        item's true sample count (<= n_samples). Returns (bsz, k) scores on
        the card. Repeat-padding is the gather wav[(start + i) % size], the
        starts drawn in the host path's RandomState order (item-major, then
        candidate). The mixtures that separate() also passes are not read."""
        model = self.model
        cfg = model.cfg
        n = cfg.n_samples
        bsz, k, t_pad = targets.shape
        rng = np.random.RandomState(self.seed)
        sizes_np = np.asarray(sizes, np.int64)
        starts = np.zeros((bsz * k,), np.int64)
        for i in range(bsz):
            t = int(sizes_np[i])
            tiled = t * -(-n // t)  # the length after np.tile(ceil(n / t))
            for j in range(k):
                if tiled > n:  # the same draws as fit_duration_np
                    starts[i * k + j] = rng.randint(0, tiled - n + 1)
        dev = targets.device
        sizes_r = torch.as_tensor(np.repeat(sizes_np, k), device=dev)
        idx = (torch.as_tensor(starts, device=dev)[:, None]
               + torch.arange(n, device=dev)[None, :]) % sizes_r[:, None]
        fitted = torch.gather(targets.reshape(bsz * k, t_pad).float(), 1, idx)
        a_emb = clap_audio_embed(model.params, cfg, fitted)
        t_emb = clap_text_embed(model.params, cfg, *model.tokenize(descriptions))
        return torch.einsum("bkd,bd->bk", a_emb.reshape(bsz, k, -1), t_emb)

    def __call__(self, extracted_audio: Sequence[np.ndarray], descriptions: List[str],
                 sample_rate: int = 48_000, **kwargs) -> np.ndarray:
        """extracted_audio: per item a (k, T) array. Returns (bsz, k) scores.
        The mixture and spans that separate() also passes are not read."""
        bsz = len(extracted_audio)
        k = int(np.asarray(extracted_audio[0]).shape[0])
        cfg = self.model.cfg
        rng = np.random.RandomState(self.seed)
        rows = []
        for item in extracted_audio:
            arr = np.asarray(item, np.float32)
            if sample_rate != cfg.sample_rate:
                arr = resample_np(arr, sample_rate, cfg.sample_rate)
            for j in range(k):
                # repeat-pad / rand_trunc on each candidate's true length
                rows.append(fit_duration_np(arr[j], cfg.n_samples, rand_trunc=True, rng=rng))
        wavs = torch.as_tensor(np.stack(rows), device=self.model.device)
        audio_emb = self.model.get_audio_embedding(wavs).cpu().numpy()
        text_emb = self.model.get_text_embedding(descriptions).cpu().numpy()
        scores = np.einsum("bkd,bd->bk", audio_emb.reshape(bsz, k, -1), text_emb)
        return scores.astype(np.float32)
