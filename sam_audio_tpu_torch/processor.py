"""Preprocessing frontend: files/arrays -> batched, masked numpy tensors.

The text + audio + anchors path of the reference processor
(sam_audio/processor.py:23-260): load/resample to 48 kHz, downmix to mono,
right-pad to a batch, frame-index math (hop 1920 => 25 latent fps), anchor
spans -> per-frame alignment tensors. Host-side numpy only; the model moves
the arrays to its device.
"""

from __future__ import annotations

import json
import math
import os
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from sam_audio_tpu_torch.audio_io import load_audio
from sam_audio_tpu_torch.config import SAMAudioConfig
from sam_audio_tpu_torch.ops.resample import resample_np

Anchor = Tuple[str, float, float]

ANCHOR_VOCAB = {"<null>": 0, "+": 1, "-": 2, "<pad>": 3}


def batch_audio(
    audios: Sequence[Union[str, np.ndarray]], audio_sampling_rate: int = 48_000
) -> Tuple[np.ndarray, np.ndarray]:
    """Load/resample each item, downmix to mono, right-pad into (B, 1, Tmax).
    reference: sam_audio/processor.py:23-36."""
    wavs = []
    for audio in audios:
        if isinstance(audio, str):
            wav, sr = load_audio(audio)
            if sr != audio_sampling_rate:
                wav = resample_np(wav, sr, audio_sampling_rate)
        else:
            wav = np.asarray(audio, np.float32)
            if wav.ndim == 1:
                wav = wav[None]
        wavs.append(wav.mean(0))
    sizes = np.array([w.shape[-1] for w in wavs], np.int64)
    tmax = int(sizes.max())
    out = np.zeros((len(wavs), 1, tmax), np.float32)
    for i, w in enumerate(wavs):
        out[i, 0, : w.shape[-1]] = w
    return out, sizes


def mask_from_sizes(sizes: np.ndarray, total: Optional[int] = None) -> np.ndarray:
    total = int(sizes.max()) if total is None else total
    return np.arange(total)[None, :] < sizes[:, None]


class Batch:
    """Batched model inputs (reference: sam_audio/processor.py:39-124), all
    numpy; `SAMAudio.separate` moves them to the model's device."""

    def __init__(
        self,
        audios: np.ndarray,
        sizes: np.ndarray,
        wav_sizes: np.ndarray,
        descriptions: List[str],
        hop_length: int,
        audio_sampling_rate: int,
        anchors: Optional[List[List[Anchor]]] = None,
        audio_pad_mask: Optional[np.ndarray] = None,
        masked_video: Optional[list] = None,
    ):
        self.audios = audios
        self.sizes = sizes
        self.wav_sizes = wav_sizes
        self.descriptions = list(descriptions)
        self.audio_pad_mask = audio_pad_mask
        self.masked_video = masked_video
        self.hop_length = hop_length
        self.audio_sampling_rate = audio_sampling_rate
        self.process_anchors(anchors)
        assert self.audios.shape[0] == len(self.descriptions)

    def _wav_to_feature_idx(self, wav_idx: float) -> int:
        return math.ceil(wav_idx / self.hop_length)

    def process_anchors(self, anchors: Optional[List[List[Anchor]]]):
        """Spans (seconds) -> anchor_ids (B, A) + per-frame alignment (B, T)
        (reference: sam_audio/processor.py:78-124)."""
        batch_size = self.audios.shape[0]
        t_feat = self.audio_pad_mask.shape[-1]
        anchor_alignment = np.zeros((batch_size, t_feat), np.int32)
        anchor_alignment[~self.audio_pad_mask] = 1  # pad frames -> <pad> slot
        if anchors is None:
            anchor_ids = np.full((batch_size, 2), ANCHOR_VOCAB["<pad>"],
                                 np.int32)
            anchor_ids[:, 0] = ANCHOR_VOCAB["<null>"]
        else:
            ids = []
            for i, anchor_list in enumerate(anchors):
                current = [ANCHOR_VOCAB["<null>"], ANCHOR_VOCAB["<pad>"]]
                for token, start_time, end_time in anchor_list:
                    start_idx = self._wav_to_feature_idx(
                        start_time * self.audio_sampling_rate
                    )
                    end_idx = self._wav_to_feature_idx(
                        end_time * self.audio_sampling_rate
                    )
                    anchor_alignment[i, start_idx:end_idx] = len(current)
                    current.append(ANCHOR_VOCAB[token])
                ids.append(current)
            # slots rounded up to a multiple of 4, as the JAX package does;
            # unused slots are <pad> (never referenced by the alignment)
            longest = 4 * ((max(len(c) for c in ids) + 3) // 4)
            anchor_ids = np.full((batch_size, longest), ANCHOR_VOCAB["<pad>"],
                                 np.int32)
            for i, c in enumerate(ids):
                anchor_ids[i, : len(c)] = c
        self.anchor_ids = anchor_ids
        self.anchor_alignment = anchor_alignment
        self.anchors = anchors


class SAMAudioProcessor:
    def __init__(self, audio_hop_length: int, audio_sampling_rate: int):
        self.audio_hop_length = audio_hop_length
        self.audio_sampling_rate = audio_sampling_rate

    @classmethod
    def from_pretrained(cls, path: str) -> "SAMAudioProcessor":
        """`path` is a local snapshot directory holding config.json."""
        with open(os.path.join(path, "config.json")) as fin:
            config = SAMAudioConfig.from_dict(json.load(fin))
        return cls(
            audio_hop_length=config.audio_codec.hop_length,
            audio_sampling_rate=config.audio_codec.sample_rate,
        )

    def wav_to_feature_idx(self, wav_idx):
        if isinstance(wav_idx, np.ndarray):
            return np.ceil(wav_idx / self.audio_hop_length).astype(np.int64)
        return math.ceil(wav_idx / self.audio_hop_length)

    def __call__(
        self,
        descriptions: List[str],
        audios: Sequence[Union[str, np.ndarray]],
        anchors: Optional[List[List[Anchor]]] = None,
        masked_videos=None,
    ) -> Batch:
        """reference: sam_audio/processor.py:211-260."""
        if masked_videos is not None:
            raise NotImplementedError(
                "masked_videos= (visual prompting) is not ported yet; it "
                "comes with the visual slice (PE / ImageBind)."
            )
        assert len(descriptions) == len(audios)
        assert anchors is None or len(descriptions) == len(anchors)

        audio_arr, wav_sizes = batch_audio(audios, self.audio_sampling_rate)

        sizes = self.wav_to_feature_idx(wav_sizes)
        t_feat = self.wav_to_feature_idx(int(audio_arr.shape[-1]))
        audio_pad_mask = mask_from_sizes(sizes, total=t_feat)
        return Batch(
            audios=audio_arr,
            sizes=sizes,
            descriptions=descriptions,
            audio_pad_mask=audio_pad_mask,
            anchors=anchors,
            hop_length=self.audio_hop_length,
            audio_sampling_rate=self.audio_sampling_rate,
            wav_sizes=wav_sizes,
        )


__all__ = ["SAMAudioProcessor", "Batch", "batch_audio", "mask_from_sizes",
           "ANCHOR_VOCAB"]
