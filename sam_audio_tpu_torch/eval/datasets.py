"""Eval datasets: SAMAudioBench, MUSDB and the hermetic SyntheticBench
(counterpart of sam_audio_tpu/eval/datasets.py; reference:
eval/dataset/sam_audio_bench.py:24-153, eval/dataset/musdb.py:20-75).

Host-side loading (decode, resample, mask) in numpy, with the port's
audio_io / video_io. SAMAudioBench's metadata and MUSDB's archive are
fetched through `datasets.load_dataset` and `cache_file`, imported and run
only when such a dataset is built.
"""

from __future__ import annotations

import math
import os
import subprocess
from dataclasses import dataclass
from io import BytesIO
from typing import List, Optional, Tuple

import numpy as np

from sam_audio_tpu_torch.audio_io import load_audio
from sam_audio_tpu_torch.ops.resample import resample_np

Anchor = Tuple[str, float, float]


@dataclass
class Item:
    """reference: eval/dataset/sam_audio_bench.py:16-21."""

    anchors: Optional[List[Anchor]]
    masked_video_frames: Optional[np.ndarray]
    audio_samples: np.ndarray
    description: str


def _nearest_grid(out_len: int, in_len: int) -> np.ndarray:
    """Nearest-neighbour source indices of torch's F.interpolate: floor(i *
    scale) with the scale computed in float32, as torch's kernel does (the
    exact integer floor(i * in // out) differs on ~3% of size pairs)."""
    scale = np.float32(in_len) / np.float32(out_len)
    idx = np.floor(np.arange(out_len, dtype=np.float32) * scale).astype(np.int64)
    return np.clip(idx, 0, in_len - 1)


class SAMAudioBench:
    """facebook/sam-audio-bench metadata (HF datasets) + a local mp4 cache,
    prepared as the reference README says; a missing cache fails fast."""

    def __init__(self, cache_path, collate_fn, span: bool = True, visual: bool = True,
                 subset: Optional[str] = None):
        from datasets import load_dataset

        self.dataset = load_dataset("facebook/sam-audio-bench")["test"]
        if subset is not None:
            self.dataset = self.dataset.filter(lambda x: subset in x["paper_eval_sets"])
        self._span = span
        self._visual = visual
        self.cache_path = os.path.join(cache_path, "sam_audio_bench")
        self.collate_fn = collate_fn
        assert os.path.exists(self.cache_path), (
            f"`SAMAudioBench` requires media cached at {self.cache_path}; "
            "see README for preparation.")

    @property
    def visual(self):
        return self._visual

    def __len__(self):
        return len(self.dataset)

    def _get_path(self, video_id, source_dataset, start_offset, end_offset):
        """The media file of an item, by the reference's four naming patterns
        (sam_audio_bench.py:55-71); True when the file is the whole video and
        the item's window must be cut from it."""
        base = f"{self.cache_path}/{source_dataset}"
        candidates = [
            (f"{base}/{video_id}.mp4", True),
            (f"{base}/{video_id}_{int(start_offset * 1000)}_{int(end_offset * 1000)}.mp4",
             False),
            (f"{base}/{video_id}_{int(start_offset)}_{int(end_offset)}.mp4", False),
            (f"{base}/{video_id}.{int(start_offset * 1000):08d}_"
             f"{int(end_offset * 1000):08d}.mp4", False),
        ]
        for path, select in candidates:
            if os.path.exists(path):
                return path, select
        return candidates[-1][0], False

    def collate(self, items: List[Item]):
        has_video = any(i.masked_video_frames is not None for i in items)
        return self.collate_fn(
            descriptions=[i.description for i in items],
            audios=[i.audio_samples for i in items],
            anchors=[i.anchors for i in items] if self._span else None,
            masked_videos=[i.masked_video_frames for i in items]
            if has_video and self._visual else None)

    def _get_masked_video(self, item, video_path, select_frames):
        if item["mask_bytes"] is None:
            return None
        from sam_audio_tpu_torch.video_io import decode_video_frames

        masklet = np.load(BytesIO(item["mask_bytes"]))["video_masklet"]
        frames, pts = decode_video_frames(video_path)
        if select_frames:
            frames = frames[(pts >= item["start_offset"]) & (pts < item["end_offset"])]
        if masklet.shape[0] != frames.shape[0]:
            idxs = np.round(np.linspace(0, masklet.shape[0] - 1, frames.shape[0])).astype(int)
            masklet = masklet[idxs]
        mask = masklet[:, None]   # (N, 1, h, w)
        if mask.shape[-2:] != frames.shape[-2:]:
            # nearest spatial resize (the reference's F.interpolate,
            # sam_audio_bench.py:109)
            h, w = frames.shape[-2:]
            mask = mask[:, :, _nearest_grid(h, mask.shape[-2])]
            mask = mask[:, :, :, _nearest_grid(w, mask.shape[-1])]
        return frames * mask

    def __getitem__(self, idx) -> Item:
        item = self.dataset[idx]
        video_path, select_frames = self._get_path(
            item["video_id"], item["source_dataset"], item["start_offset"], item["end_offset"])
        assert os.path.exists(video_path), f"{video_path} does not exist!"
        wav, sr = load_audio(video_path)
        if select_frames:
            wav = wav[:, int(item["start_offset"] * sr): int(item["end_offset"] * sr)]
        target_sr = self.collate_fn.audio_sampling_rate
        if sr != target_sr:
            wav = resample_np(wav, sr, target_sr)
        return Item(description=item["description"],
                    anchors=[("+", s, e) for s, e in item["spans"]],
                    masked_video_frames=self._get_masked_video(item, video_path, select_frames),
                    audio_samples=wav.mean(0, keepdims=True))


def cache_file(url: str, outfile: str):
    """Resumable download with tmp + rename (reference musdb.py:12-17)."""
    if not os.path.exists(outfile):
        os.makedirs(os.path.dirname(outfile), exist_ok=True)
        subprocess.check_call(["curl", "--url", url, "--output", outfile + ".tmp"])
        os.rename(outfile + ".tmp", outfile)


class MUSDB:
    """musdb18hq mixtures + facebook/sam-audio-musdb18hq-test metadata
    (reference: eval/dataset/musdb.py:20-75)."""

    URL = "https://zenodo.org/records/3338373/files/musdb18hq.zip?download=1"

    def __init__(self, collate_fn, sample_rate: int = 48_000,
                 cache_path: str = os.path.expanduser("~/.cache/sam_audio")):
        from datasets import load_dataset

        self.cache_path = os.path.join(cache_path, "musdb18hq")
        zip_file = os.path.join(cache_path, "musdb18hq.zip")
        cache_file(self.URL, zip_file)
        if not os.path.exists(self.cache_path):
            subprocess.check_call(["unzip", zip_file, "-d", self.cache_path + ".tmp"])
            os.rename(self.cache_path + ".tmp", self.cache_path)
        self.ds = load_dataset("facebook/sam-audio-musdb18hq-test")["test"]
        self.collate_fn = collate_fn
        self.sample_rate = sample_rate

    @property
    def visual(self):
        return False

    def __len__(self):
        return len(self.ds)

    def collate(self, items):
        audios, descriptions = zip(*items)
        return self.collate_fn(audios=list(audios), descriptions=list(descriptions))

    def __getitem__(self, idx):
        item = self.ds[idx]
        path = os.path.join(self.cache_path, "test", item["id"], "mixture.wav")
        assert os.path.exists(path), f"{path} does not exist!"
        wav, sr = load_audio(path)
        wav = wav[:, int(item["start_time"] * sr): int(item["end_time"] * sr)]
        if sr != self.sample_rate:
            wav = resample_np(wav, sr, self.sample_rate)
        return wav.mean(0, keepdims=True), item["description"]


class SyntheticBench:
    """Hermetic smoke dataset: tone + noise mixtures with known spans, so the
    whole eval loop (separate -> metrics -> aggregation) runs with no
    network or media cache."""

    DESCRIPTIONS = ["a pure tone", "white noise", "a low hum", "clicking"]

    def __init__(self, cache_path=None, collate_fn=None, span: bool = False,
                 num_items: int = 4, seconds: float = 1.0, sample_rate: Optional[int] = None):
        self.collate_fn = collate_fn
        self._span = span
        self.num_items = num_items
        self.seconds = seconds
        self.sample_rate = sample_rate or getattr(collate_fn, "audio_sampling_rate", 48_000)

    @property
    def visual(self):
        return False

    def __len__(self):
        return self.num_items

    def collate(self, items: List[Item]):
        return self.collate_fn(
            descriptions=[i.description for i in items],
            audios=[i.audio_samples for i in items],
            anchors=[i.anchors for i in items] if self._span else None)

    def __getitem__(self, idx) -> Item:
        rng = np.random.RandomState(idx)
        sr = self.sample_rate
        t = np.arange(int(self.seconds * sr)) / sr
        freq = 220 * (idx + 1)
        tone = 0.4 * np.sin(2 * math.pi * freq * t)
        # the tone is active in the middle half only
        start, end = self.seconds * 0.25, self.seconds * 0.75
        gate = ((t >= start) & (t < end)).astype(np.float32)
        mix = (tone * gate + 0.05 * rng.randn(t.size)).astype(np.float32)
        return Item(description=self.DESCRIPTIONS[idx % len(self.DESCRIPTIONS)],
                    anchors=[("+", float(start), float(end))],
                    masked_video_frames=None,
                    audio_samples=mix[None])
