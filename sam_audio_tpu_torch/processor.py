"""Preprocessing frontend: files/arrays -> batched, masked numpy tensors.

The reference processor (sam_audio/processor.py:23-260): load/resample to
48 kHz, downmix to mono, right-pad to a batch, frame-index math (hop 1920 =>
25 latent fps), anchor spans -> per-frame alignment tensors, one video frame
per latent frame (`load_video`), video masking (`mask_videos`). Host-side numpy only; the model moves
the arrays to its device. `SAMAudioJudgeProcessor` prepares the judge's
(text, mixture, separated) inputs.

`pad_to_samples` right-pads a batch to a given length: the serving batcher
pads each group to its length bucket, so that its groups have the JAX
package's shapes (and a parity test can inject the same noise into both).
`bucket_seconds` (rounding the padded length up to a bucket) and
`pad_anchors_to` (a minimum anchor-slot width) are JAX's
(sam_audio_tpu/processor.py:253-316). They exist there so that XLA reuses
one compiled program; the port's training pipeline keeps them because they
fix a batch's shapes, and so the noise and the loss's mean. Inference leaves
them off.
"""

from __future__ import annotations

import json
import math
import os
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from sam_audio_tpu_torch.audio_io import load_audio
from sam_audio_tpu_torch.config import SAMAudioConfig, SAMAudioJudgeConfig
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
        anchor_pad_to: Optional[int] = None,
    ):
        self.audios = audios
        self.sizes = sizes
        self.wav_sizes = wav_sizes
        self.descriptions = list(descriptions)
        self.audio_pad_mask = audio_pad_mask
        self.masked_video = masked_video
        self.hop_length = hop_length
        self.audio_sampling_rate = audio_sampling_rate
        self.anchor_pad_to = anchor_pad_to   # minimum anchor-slot width
        self.process_anchors(anchors)
        assert self.audios.shape[0] == len(self.descriptions)

    def _wav_to_feature_idx(self, wav_idx: float) -> int:
        return math.ceil(wav_idx / self.hop_length)

    def to(self, device=None):
        """The reference's `processor(...).to(device)` (reference
        processor.py:66-76) returns the batch itself: the arrays stay numpy
        and `SAMAudio.separate` moves them to the model's device."""
        return self

    def process_anchors(self, anchors: Optional[List[List[Anchor]]]):
        """Spans (seconds) -> anchor_ids (B, A) + per-frame alignment (B, T)
        (reference: sam_audio/processor.py:78-124)."""
        batch_size = self.audios.shape[0]
        t_feat = self.audio_pad_mask.shape[-1]
        anchor_alignment = np.zeros((batch_size, t_feat), np.int32)
        anchor_alignment[~self.audio_pad_mask] = 1  # pad frames -> <pad> slot
        pad_to = self.anchor_pad_to
        if anchors is None:
            width = max(2, pad_to or 0)
            if pad_to:   # the anchors branch's rounding: one width either way
                width = 4 * ((width + 3) // 4)
            anchor_ids = np.full((batch_size, width), ANCHOR_VOCAB["<pad>"],
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
            longest = 4 * ((max([len(c) for c in ids] + [pad_to or 0]) + 3) // 4)
            anchor_ids = np.full((batch_size, longest), ANCHOR_VOCAB["<pad>"],
                                 np.int32)
            for i, c in enumerate(ids):
                anchor_ids[i, : len(c)] = c
        self.anchor_ids = anchor_ids
        self.anchor_alignment = anchor_alignment
        self.anchors = anchors


def load_video(sizes: np.ndarray, videos: Sequence[Union[str, np.ndarray]],
               feature_to_wav_idx: Callable, audio_sampling_rate: int) -> List[np.ndarray]:
    """One video frame per latent audio frame (reference:
    sam_audio/processor.py:131-155): an array (N, C, H, W) takes frames
    round(linspace(0, N - 1, size)); a file (ffmpeg, video_io) the frame
    nearest each latent frame's time."""
    all_frames = []
    for size, video in zip(sizes, videos):
        if isinstance(video, str):
            from sam_audio_tpu_torch.video_io import decode_video_frames

            frames, pts = decode_video_frames(video)
            audio_ts = feature_to_wav_idx(np.arange(int(size))) / audio_sampling_rate
            frames = frames[np.abs(audio_ts[None, :] - pts[:, None]).argmin(axis=0)]
        else:
            video = np.asarray(video)
            if video.ndim != 4 or video.shape[1] != 3:
                raise ValueError(f"expected video frames (N, 3, H, W), got {video.shape}")
            frames = video[np.round(np.linspace(0, video.shape[0] - 1, int(size))).astype(int)]
        all_frames.append(frames)
    return all_frames


class SAMAudioProcessor:
    def __init__(self, audio_hop_length: int, audio_sampling_rate: int,
                 bucket_seconds: float = 0.0):
        self.audio_hop_length = audio_hop_length
        self.audio_sampling_rate = audio_sampling_rate
        self.bucket_seconds = bucket_seconds

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

    def feature_to_wav_idx(self, feature_idx):
        return feature_idx * self.audio_hop_length

    def mask_videos(self, videos, masks) -> List[np.ndarray]:
        """video * (mask == 0) per frame: pixels are kept where the mask is 0
        (reference: sam_audio/processor.py:197-204). Either may be a file."""
        out = []
        for v, m in zip(videos, masks):
            if isinstance(v, str) or isinstance(m, str):
                from sam_audio_tpu_torch.video_io import decode_video_frames

                v = decode_video_frames(v)[0] if isinstance(v, str) else v
                m = decode_video_frames(m)[0] if isinstance(m, str) else m
            v, m = np.asarray(v), np.asarray(m)
            out.append(v * (m == 0))
        return out

    def __call__(
        self,
        descriptions: List[str],
        audios: Sequence[Union[str, np.ndarray]],
        anchors: Optional[List[List[Anchor]]] = None,
        masked_videos=None,
        pad_to_samples: Optional[int] = None,
        pad_anchors_to: Optional[int] = None,
    ) -> Batch:
        """reference: sam_audio/processor.py:211-260. `masked_videos`: per
        item the masked frames (N, C, H, W) (see `mask_videos`) or a video
        file, mapped to one frame per latent frame. `pad_to_samples` (at
        least the longest item) is the padded waveform length; without it,
        a processor with `bucket_seconds` rounds the length up to a bucket.
        `pad_anchors_to` is the minimum anchor-slot width."""
        assert len(descriptions) == len(audios)
        assert anchors is None or len(descriptions) == len(anchors)
        assert masked_videos is None or len(descriptions) == len(masked_videos)

        audio_arr, wav_sizes = batch_audio(audios, self.audio_sampling_rate)
        if pad_to_samples is not None:
            tmax = audio_arr.shape[-1]
            if pad_to_samples < tmax:
                raise ValueError(f"pad_to_samples={pad_to_samples} is shorter than the "
                                 f"longest item ({tmax} samples)")
            audio_arr = np.pad(audio_arr, [(0, 0), (0, 0), (0, pad_to_samples - tmax)])
        elif self.bucket_seconds > 0:
            # a bucket is a whole number of hops
            bucket = int(self.bucket_seconds * self.audio_sampling_rate)
            bucket = max(self.audio_hop_length,
                         bucket // self.audio_hop_length * self.audio_hop_length)
            tmax = audio_arr.shape[-1]
            audio_arr = np.pad(audio_arr, [(0, 0), (0, 0), (0, -(-tmax // bucket) * bucket - tmax)])

        sizes = self.wav_to_feature_idx(wav_sizes)
        t_feat = self.wav_to_feature_idx(int(audio_arr.shape[-1]))
        audio_pad_mask = mask_from_sizes(sizes, total=t_feat)
        masked_video = None
        if masked_videos is not None:
            masked_video = load_video(sizes, masked_videos, self.feature_to_wav_idx,
                                      self.audio_sampling_rate)
        return Batch(
            audios=audio_arr,
            sizes=sizes,
            descriptions=descriptions,
            audio_pad_mask=audio_pad_mask,
            anchors=anchors,
            masked_video=masked_video,
            hop_length=self.audio_hop_length,
            audio_sampling_rate=self.audio_sampling_rate,
            wav_sizes=wav_sizes,
            anchor_pad_to=pad_anchors_to,
        )


class SAMAudioJudgeProcessor:
    """The judge's inputs: tokenized text and reflect-padded, batched audio
    pairs (reference: sam_audio/processor.py:263-379)."""

    def __init__(self, audio_hop_length: int, audio_sampling_rate: int, tokenizer=None):
        self.audio_hop_length = audio_hop_length
        self.audio_sampling_rate = audio_sampling_rate
        self.tokenizer = tokenizer

    @classmethod
    def from_pretrained(cls, path: str, allow_fallback_tokenizer: bool = False):
        """`path` is a local judge snapshot directory (config.json; the
        tokenizer's files, or the byte fallback when allowed)."""
        from sam_audio_tpu_torch.text_tokenizer import get_text_tokenizer

        if not os.path.isdir(path):
            raise FileNotFoundError(
                f"{path!r} is not a local judge snapshot directory; the port reads no hub")
        with open(os.path.join(path, "config.json")) as fin:
            config = SAMAudioJudgeConfig.from_dict(json.load(fin))
        return cls(audio_hop_length=config.audio_codec.hop_length,
                   audio_sampling_rate=config.audio_codec.sample_rate,
                   tokenizer=get_text_tokenizer(path, allow_fallback=allow_fallback_tokenizer))

    def _reflect_pad(self, wav: np.ndarray) -> np.ndarray:
        if wav.ndim == 1:
            wav = wav[None]
        rem = wav.shape[-1] % self.audio_hop_length
        if rem == 0:
            return wav
        pad = self.audio_hop_length - rem
        return np.pad(wav, [(0, 0)] * (wav.ndim - 1) + [(0, pad)], mode="reflect")

    def _process_audio(self, raw_audio, sampling_rate: Optional[int] = None):
        # one bare array (or path) is ONE clip, as in the reference's
        # non-list branch: a (C, T) array is not C mono items
        if isinstance(raw_audio, (str, np.ndarray)):
            raw_audio = [raw_audio]
        if raw_audio and isinstance(raw_audio[0], str):
            loaded = []
            for f in raw_audio:
                wav, sr = load_audio(f)
                if sr != self.audio_sampling_rate:
                    wav = resample_np(wav, sr, self.audio_sampling_rate)
                loaded.append(wav.mean(0, keepdims=True))
            raw_audio = loaded
        elif sampling_rate is not None and sampling_rate != self.audio_sampling_rate:
            raise ValueError(f"Expected sampling rate {self.audio_sampling_rate}, "
                             f"got {sampling_rate}")
        padded = [self._reflect_pad(np.asarray(x, np.float32)).T for x in raw_audio]
        lengths = np.array([x.shape[0] for x in padded])
        tmax = int(lengths.max())
        input_values = np.zeros((len(padded), padded[0].shape[1], tmax), np.float32)
        for i, x in enumerate(padded):
            input_values[i, :, : x.shape[0]] = x.T
        padding_mask = np.arange(tmax)[None] < lengths[:, None]
        return {"input_values": input_values, "padding_mask": padding_mask}

    def __call__(self, text=None, input_audio=None, separated_audio=None,
                 sampling_rate: Optional[int] = None):
        """Returns a dict of numpy arrays: input_ids / attention_mask (text),
        input_values / padding_mask (mixtures), separated_values."""
        batch = {}
        if text is not None:
            ids, mask = self.tokenizer(text if isinstance(text, (list, tuple)) else [text],
                                       max_length=512)
            batch["input_ids"] = ids
            batch["attention_mask"] = mask
        if input_audio is not None:
            batch.update(self._process_audio(input_audio, sampling_rate))
        if separated_audio is not None:
            batch["separated_values"] = self._process_audio(
                separated_audio, sampling_rate)["input_values"]
        return batch


__all__ = ["SAMAudioProcessor", "SAMAudioJudgeProcessor", "Batch", "batch_audio",
           "load_video", "mask_from_sizes", "ANCHOR_VOCAB"]
