"""ImageBind audio <-> video ranker (reference: sam_audio/ranking/imagebind.py:
152-197): the cosine between each candidate's audio embedding and its prompt
video's embedding. Counterpart of sam_audio_tpu/ranking/imagebind.py.

Two scoring paths:
  * `score_on_device` — the decoded candidates stay on the card: resample to
    16 kHz, Kaldi mel clips and the audio tower there; the video's frame
    transforms are host numpy, once a call, and its tower runs on the card.
    Exact against the host path only when every candidate's true length is
    the decoded length (the clip starts depend on the true duration), which
    `supports_on_device` and SAMAudio._rerank_on_device check.
  * `__call__` — the host path for any lengths: per candidate numpy
    resampling and fbank.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from sam_audio_tpu_torch.config import ImageBindRankerConfig
from sam_audio_tpu_torch.ranking.ranker import Ranker


class ImageBindRanker(Ranker):
    def __init__(self, config: ImageBindRankerConfig, model=None, allow_random: bool = False,
                 device="cuda"):
        self.config = config
        self._model = model
        self.allow_random = allow_random
        self.device = device

    @property
    def model(self):
        if self._model is None:
            from sam_audio_tpu_torch.models.imagebind import ImageBindModel, load_imagebind_model

            if self.config.checkpoint:
                self._model = load_imagebind_model(self.config.checkpoint, self.device)
            elif self.allow_random:
                # tests and benchmarks only: random weights give meaningless scores
                self._model = ImageBindModel.init_random(seed=0, device=self.device)
            else:
                raise ValueError(
                    "ImageBindRanker has no weights: ImageBindRankerConfig.checkpoint is "
                    "empty (convert an imagebind_huge checkpoint with `python -m "
                    "sam_audio_tpu_torch.convert imagebind --torch imagebind_huge.pth --out "
                    "imagebind.npz` and set checkpoint=). The reference always loads real "
                    "ranker weights (sam_audio/ranking/imagebind.py:23); pass "
                    "allow_random=True only for tests.")
        return self._model

    def supports_on_device(self, sizes, sample_rate: int) -> bool:
        """True when every candidate has one true length (the caller also
        checks it equals the decoded length). Raises without weights, as
        the host path's first score would."""
        self.model
        return len({int(s) for s in sizes}) == 1 and int(sizes[0]) > 0

    @torch.inference_mode()
    def score_on_device(self, targets: torch.Tensor, sizes, videos,
                        sample_rate: int = 48_000) -> torch.Tensor:
        """targets: (bsz, k, T) decoded candidates on the card; videos: per
        item the host frames (N, C, H, W). Returns (bsz, k) scores on the
        card."""
        bsz, k, t = targets.shape
        video_emb = self.model.embed_videos(videos)
        a_emb = self.model.embed_audio_device(targets.reshape(bsz * k, t), sample_rate)
        return torch.einsum("bkd,bd->bk", a_emb.reshape(bsz, k, -1), video_emb)

    def __call__(self, extracted_audio: Sequence[np.ndarray], videos: Sequence[np.ndarray],
                 sample_rate: int = 48_000, **kwargs) -> np.ndarray:
        """extracted_audio: per item a (k, T_i) array; videos: per item
        (N, C, H, W). Returns (bsz, k) float32 scores."""
        bsz = len(extracted_audio)
        k = int(np.asarray(extracted_audio[0]).shape[0])
        flat = [np.asarray(extracted_audio[i][j], np.float32)
                for i in range(bsz) for j in range(k)]
        audio_emb = self.model.embed_audio(flat, sample_rate).cpu().numpy()
        video_emb = self.model.embed_videos(videos).cpu().numpy()
        scores = np.einsum("bkd,bd->bk", audio_emb.reshape(bsz, k, -1), video_emb)
        return scores.astype(np.float32)
