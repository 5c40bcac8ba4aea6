"""Batched offline serving: length buckets and host decode on a thread pool.

Counterpart of sam_audio_tpu/serving.py. `SeparationPipeline.run` takes a
list of requests and:

  1. decodes and resamples their audio on a host thread pool;
  2. groups them into (bucket length, batch) groups (`runtime.plan_batches`),
     each group split by modality (video requests apart from the others);
  3. pads each group to the power-of-two batch grid (1, 2, 4, ...,
     max_batch) by repeating its last request, and its audio to the bucket
     (`processor(pad_to_samples=)`);
  4. runs `model.separate` per group, one group after another, and returns
     the responses in request order.

The JAX package solves group g+1 on a worker thread while the caller copies
out group g, which overlaps work there because XLA dispatches
asynchronously. Here `model.separate` runs to its end and returns host
arrays, so nothing is left to overlap: the groups run in a plain loop.

The buckets and the batch grid keep the JAX package's group shapes: eager
PyTorch builds no program per shape, but the same groups give the same
numbers, and `warmup` builds the kernels and sizes the allocator before
the first request. The online batcher is server.ContinuousBatcher.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Union

import numpy as np

from sam_audio_tpu_torch.processor import Anchor, SAMAudioProcessor
from sam_audio_tpu_torch.runtime import plan_batches
from sam_audio_tpu_torch.utils import StageTimer


@dataclass
class SeparationRequest:
    description: str
    audio: Union[str, np.ndarray]
    anchors: Optional[List[Anchor]] = None
    masked_video: Optional[Any] = None


@dataclass
class SeparationResponse:
    target: np.ndarray
    residual: np.ndarray
    metadata: dict = field(default_factory=dict)


def batch_grid(max_batch: int) -> List[int]:
    """The dispatched batch sizes: 1, 2, 4, ... below max_batch, and max_batch."""
    grid, p = [], 1
    while p < max_batch:
        grid.append(p)
        p *= 2
    grid.append(max_batch)
    return grid


def decode_request_audio(req: SeparationRequest, sample_rate: int) -> np.ndarray:
    """A request's audio as (channels, T) float32 at `sample_rate`: a file is
    read and resampled, an array taken as it is (1-D = mono)."""
    from sam_audio_tpu_torch.audio_io import load_audio
    from sam_audio_tpu_torch.ops.resample import resample_np

    if isinstance(req.audio, str):
        wav, sr = load_audio(req.audio)
        if sr != sample_rate:
            wav = resample_np(wav, sr, sample_rate)
        return wav.astype(np.float32)
    wav = np.asarray(req.audio, np.float32)
    return wav if wav.ndim == 2 else wav[None]


def split_by_modality(batches, buckets, has_video):
    """Each planned group split into its requests without and with video
    (`has_video(i)`): visual conditioning is per batch. Returns [(group,
    bucket)]."""
    work = []
    for group, bucket in zip(batches, buckets):
        for sub in ([i for i in group if not has_video(i)], [i for i in group if has_video(i)]):
            if sub:
                work.append((sub, bucket))
    return work


def group_batch(processor, requests, wavs, idx, bucket):
    """The processor's Batch of requests `idx`, padded to `bucket` samples."""
    reqs = [requests[i] for i in idx]
    return processor(
        descriptions=[r.description for r in reqs],
        audios=[wavs[i] for i in idx],
        # `or []`: a group mixing anchored and anchor-less requests passes
        # no None rows to process_anchors (an empty list is the <null> row)
        anchors=[r.anchors or [] for r in reqs] if any(r.anchors for r in reqs) else None,
        masked_videos=([r.masked_video for r in reqs]
                       if any(r.masked_video is not None for r in reqs) else None),
        pad_to_samples=bucket,
    )


class SeparationPipeline:
    def __init__(self, model, processor: Optional[SAMAudioProcessor] = None,
                 max_batch: int = 4, bucket_seconds: float = 2.0,
                 reranking_candidates: int = 1, predict_spans: bool = False,
                 num_io_threads: int = 4, preview_nfe: Optional[int] = None,
                 visual_stride: int = 1, pad_batch_sizes: bool = True,
                 text_pad_to: Optional[int] = 64):
        """`text_pad_to` rounds the tokenized text width up to a multiple
        (`model.text_pad_multiple`; pad columns are masked), so that groups
        have the JAX package's shapes whatever their longest prompt.
        `pad_batch_sizes` pads each group to the batch grid (padded rows are
        dropped before the reply)."""
        self.model = model
        if text_pad_to:
            model.text_pad_multiple = int(text_pad_to)
        self.processor = processor or SAMAudioProcessor(
            audio_hop_length=model.hop_length, audio_sampling_rate=model.sample_rate)
        self.max_batch = max_batch
        self.bucket_steps = max(1, int(bucket_seconds * model.sample_rate / model.hop_length))
        self.reranking_candidates = reranking_candidates
        self.predict_spans = predict_spans
        self.preview_nfe = preview_nfe
        self.visual_stride = visual_stride
        self.pad_batch_sizes = bool(pad_batch_sizes)
        self.num_io_threads = num_io_threads
        self.timer = StageTimer()

    def warmup(self, seconds: Sequence[float], batch_sizes: Optional[Sequence[int]] = None):
        """One silent text-prompted batch per (bucket of `seconds`, batch
        size) through `run`: the kernels are built and the allocator sized
        before the first request. `batch_sizes` defaults to the batch grid.
        Returns the warmed (bucket_samples, batch_size) shapes."""
        unit = self.model.hop_length * self.bucket_steps
        sizes = sorted({min(max(1, int(b)), self.max_batch)
                        for b in (batch_sizes or batch_grid(self.max_batch))})
        buckets = sorted({max(unit, -(-int(s * self.model.sample_rate) // unit) * unit)
                          for s in seconds})
        warmed = []
        for bucket in buckets:
            for b in sizes:
                self.run([SeparationRequest(description="warmup",
                                            audio=np.zeros((1, bucket), np.float32))
                          for _ in range(b)])
                warmed.append((bucket, b))
        return warmed

    def run(self, requests: Sequence[SeparationRequest]) -> List[SeparationResponse]:
        if not requests:
            return []
        sr = self.model.sample_rate
        with self.timer.stage("host_decode"):
            with ThreadPoolExecutor(self.num_io_threads) as pool:
                wavs = list(pool.map(lambda r: decode_request_audio(r, sr), requests))
        batches, buckets = plan_batches([w.shape[-1] for w in wavs], hop=self.model.hop_length,
                                        bucket_steps=self.bucket_steps,
                                        max_batch=self.max_batch)
        work = split_by_modality(batches, buckets,
                                 lambda i: requests[i].masked_video is not None)
        responses: List[Optional[SeparationResponse]] = [None] * len(requests)

        grid = batch_grid(self.max_batch)
        for group, bucket in work:
            idx = list(group)
            if self.pad_batch_sizes:
                idx += [group[-1]] * (next(g for g in grid if g >= len(group)) - len(group))
            with self.timer.stage("preprocess"):
                batch = group_batch(self.processor, requests, wavs, idx, bucket)
            with self.timer.stage("separate"):
                result = self.model.separate(
                    batch, reranking_candidates=self.reranking_candidates,
                    predict_spans=self.predict_spans, preview_nfe=self.preview_nfe,
                    visual_stride=self.visual_stride)
            for j, i in enumerate(group):
                responses[i] = SeparationResponse(
                    target=np.asarray(result.target[j]), residual=np.asarray(result.residual[j]),
                    metadata={"bucket": bucket, "batch_size": len(group),
                              "dispatch_size": len(idx)})
        return responses  # type: ignore[return-value]
