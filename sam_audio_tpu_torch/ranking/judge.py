"""Judge ranker: each candidate scored by the SAMAudioJudge model (reference:
sam_audio/ranking/judge.py:11-42); counterpart of
sam_audio_tpu/ranking/judge.py.

Two scoring paths:
  * `score_on_device` — the serving path SAMAudio.separate takes: when every
    candidate's true length is a hop multiple at the judge codec's sample
    rate (always so for separate()'s frame-aligned decodes), the host
    processor's reflect-pad is a no-op, so the (mixture, candidate) pairs
    stay on the card and `judge_forward_grouped` runs the mixture-side
    towers once per item.
  * `__call__` — the host path for any length and rate: the judge processor
    reflect-pads and batches the flattened (item, candidate) pairs, then
    `judge_forward`.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from sam_audio_tpu_torch.config import JudgeRankerConfig
from sam_audio_tpu_torch.ranking.ranker import Ranker


class JudgeRanker(Ranker):
    def __init__(self, config: JudgeRankerConfig, model=None, processor=None,
                 device="cuda"):
        self.config = config
        self._model = model
        self._processor = processor
        self.device = device

    @property
    def model(self):
        if self._model is None:
            from sam_audio_tpu_torch.models.judge import SAMAudioJudgeModel

            self._model = SAMAudioJudgeModel.from_pretrained(
                self.config.checkpoint_or_model_id, device=self.device)
        return self._model

    @property
    def processor(self):
        if self._processor is None:
            from sam_audio_tpu_torch.processor import SAMAudioJudgeProcessor

            self._processor = SAMAudioJudgeProcessor.from_pretrained(
                self.config.checkpoint_or_model_id)
        return self._processor

    def supports_on_device(self, sizes, sample_rate: int) -> bool:
        """On-device scoring equals the host path when reflect-padding is a
        no-op: every true length a hop multiple at the judge's sample rate."""
        codec = self.model.cfg.audio_codec
        return sample_rate == codec.sample_rate and all(
            int(s) > 0 and int(s) % codec.hop_length == 0 for s in sizes)

    @torch.inference_mode()
    def score_on_device(self, targets: torch.Tensor, sizes, descriptions,
                        mixtures=None) -> torch.Tensor:
        """targets: (bsz, k, T_pad) candidates and mixtures: (bsz, 1, Tw),
        both on the model's device; sizes: each item's true sample count (hop
        multiples). Returns the (bsz, k) `overall` scores on the device."""
        from sam_audio_tpu_torch.models.judge import judge_forward_grouped

        if mixtures is None:
            raise ValueError("judge on-device scoring needs the mixtures")
        model = self.model
        bsz, k, t_pad = targets.shape
        dev = targets.device
        # one text, mixture and mask row per item; the grouped forward
        # repeats the mixture-side features over the candidates
        ids, mask = self.processor.tokenizer(list(descriptions), max_length=512)
        sizes_t = torch.as_tensor(np.asarray(sizes, np.int64), device=dev)
        padding_mask = torch.arange(t_pad, device=dev)[None, :] < sizes_t[:, None]
        mix = mixtures.float()
        if mix.shape[-1] < t_pad:   # equal pad lengths (the zeros are masked)
            mix = torch.nn.functional.pad(mix, (0, t_pad - mix.shape[-1]))
        out = judge_forward_grouped(
            model.params, model.cfg,
            input_ids=torch.as_tensor(np.asarray(ids), dtype=torch.long, device=dev),
            input_values=mix[..., :t_pad],
            separated_values=targets.reshape(bsz * k, 1, t_pad).float(),
            attention_mask=torch.as_tensor(np.asarray(mask), dtype=torch.bool, device=dev),
            padding_mask=padding_mask, k=k, compute_dtype=model.compute_dtype)
        return out.overall.reshape(bsz, k)

    def __call__(self, extracted_audio: Sequence[np.ndarray],
                 input_audio: Sequence[np.ndarray], descriptions: List[str],
                 sample_rate: int = 48_000, **kwargs) -> np.ndarray:
        """extracted_audio / input_audio: per item a (k, T) array of
        candidates / mixtures. Returns (bsz, k) `overall` scores."""
        bsz = len(extracted_audio)
        k = int(np.asarray(extracted_audio[0]).shape[0])
        # the flattened (bsz x k) pairs (reference ranking/judge.py:29-32)
        separated = [np.asarray(extracted_audio[i][j], np.float32)
                     for i in range(bsz) for j in range(k)]
        mixtures = [np.asarray(input_audio[i][j], np.float32)
                    for i in range(bsz) for j in range(k)]
        texts = [descriptions[i] for i in range(bsz) for _ in range(k)]
        batch = self.processor(text=texts, input_audio=mixtures, separated_audio=separated,
                               sampling_rate=sample_rate)
        dev = self.model.device

        def on_device(name, dtype):
            return torch.as_tensor(np.asarray(batch[name]), dtype=dtype, device=dev)

        out = self.model(input_ids=on_device("input_ids", torch.long),
                         input_values=on_device("input_values", torch.float32),
                         separated_values=on_device("separated_values", torch.float32),
                         attention_mask=on_device("attention_mask", torch.bool),
                         padding_mask=on_device("padding_mask", torch.bool))
        return out.overall.float().cpu().numpy().reshape(bsz, k)
