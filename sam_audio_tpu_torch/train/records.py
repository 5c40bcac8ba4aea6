"""Sharded on-disk training records; a numpy copy of
sam_audio_tpu/train/records.py (the same npz layout and index.json, so either
package reads the other's shards).

The reference ships no training code (SURVEY.md section 0); its eval datasets
stream from HF (eval/dataset/). For training at scale we need a local format
that (a) packs ragged waveforms densely, (b) shards across files so many
hosts/workers can read disjoint subsets, and (c) reshuffles deterministically
per epoch. This is a minimal npz-based equivalent of tfrecord/array_record
sharding, with no TF dependency:

  out_dir/
    index.json                 {"num_shards": N, "counts": [...], "total": M}
    shard-00000.npz            packed ragged arrays + offset tables
    shard-00001.npz            ...

Each shard stores, per stem (mixture/target/residual), one concatenated
float32 array + an int64 offsets table; descriptions as utf-8 bytes +
offsets; anchors as (label, start_s, end_s) rows + offsets. Everything is a
flat numpy array -> zero pickle, mmap-friendly, portable.

Reading: `ShardedRecordDataset` shards the *shard list* across processes
(process_index/process_count, from torch.distributed when it is
initialised, else 0 and 1) and yields `TrainExample`s with per-epoch
deterministic shuffling of both shard order and in-shard order.
`iter_batches` builds batches on a background prefetch thread, so that host
batch assembly overlaps the card's work (as eval/main.iter_batches).
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np

from sam_audio_tpu_torch.train.data import TrainExample

_ANCHOR_LABELS = ("+", "-")


def _pack_ragged(arrays: Sequence[np.ndarray], dtype):
    offsets = np.zeros(len(arrays) + 1, np.int64)
    for i, a in enumerate(arrays):
        offsets[i + 1] = offsets[i] + a.size
    data = np.empty(offsets[-1], dtype)
    for i, a in enumerate(arrays):
        data[offsets[i]: offsets[i + 1]] = np.asarray(a, dtype).ravel()
    return data, offsets


def _unpack_ragged(data: np.ndarray, offsets: np.ndarray, i: int) -> np.ndarray:
    return data[offsets[i]: offsets[i + 1]]


class ShardWriter:
    """Append TrainExamples; flushes `shard_size` examples per npz shard and
    writes index.json on close(). Usable as a context manager."""

    def __init__(self, out_dir: str, shard_size: int = 256):
        assert shard_size > 0
        self.out_dir = out_dir
        self.shard_size = shard_size
        os.makedirs(out_dir, exist_ok=True)
        self._pending: List[TrainExample] = []
        self._counts: List[int] = []

    def add(self, example: TrainExample) -> None:
        self._pending.append(example)
        if len(self._pending) >= self.shard_size:
            self._flush()

    def _flush(self) -> None:
        if not self._pending:
            return
        exs = self._pending
        arrays = {}
        for name in ("mixture", "target", "residual"):
            wavs = [np.asarray(getattr(e, name), np.float32).ravel()
                    for e in exs]
            data, off = _pack_ragged(wavs, np.float32)
            arrays[f"{name}_data"] = data
            arrays[f"{name}_offsets"] = off
        descs = [e.description.encode("utf-8") for e in exs]
        arrays["desc_data"], arrays["desc_offsets"] = _pack_ragged(
            [np.frombuffer(d, np.uint8) for d in descs], np.uint8)
        anchor_rows = []
        for e in exs:
            rows = [
                (float(_ANCHOR_LABELS.index(a[0])), float(a[1]), float(a[2]))
                for a in (e.anchors or [])
            ]
            anchor_rows.append(np.asarray(rows, np.float64).reshape(-1, 3))
        arrays["anchors_data"], arrays["anchors_offsets"] = _pack_ragged(
            anchor_rows, np.float64)  # times round-trip exactly
        path = os.path.join(self.out_dir,
                            f"shard-{len(self._counts):05d}.npz")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)  # crash-safe, like eval/datasets.py downloads
        self._counts.append(len(exs))
        self._pending = []

    def close(self) -> None:
        self._flush()
        index = {"num_shards": len(self._counts), "counts": self._counts,
                 "total": int(sum(self._counts))}
        with open(os.path.join(self.out_dir, "index.json"), "w") as f:
            json.dump(index, f)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_shards(examples: Iterable[TrainExample], out_dir: str,
                 shard_size: int = 256) -> None:
    with ShardWriter(out_dir, shard_size) as w:
        for e in examples:
            w.add(e)


def _load_shard(path: str) -> List[TrainExample]:
    with np.load(path) as z:
        n = len(z["mixture_offsets"]) - 1
        out = []
        for i in range(n):
            desc = _unpack_ragged(z["desc_data"], z["desc_offsets"], i)
            rows = _unpack_ragged(
                z["anchors_data"], z["anchors_offsets"], i).reshape(-1, 3)
            anchors = [
                (_ANCHOR_LABELS[int(r[0])], float(r[1]), float(r[2]))
                for r in rows
            ] or None
            out.append(TrainExample(
                mixture=_unpack_ragged(z["mixture_data"],
                                       z["mixture_offsets"], i).copy(),
                target=_unpack_ragged(z["target_data"],
                                      z["target_offsets"], i).copy(),
                residual=_unpack_ragged(z["residual_data"],
                                        z["residual_offsets"], i).copy(),
                description=bytes(desc).decode("utf-8"),
                anchors=anchors,
            ))
    return out


def _process_grid():
    """(rank, world size) of torch.distributed when it is initialised, else
    (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class ShardedRecordDataset:
    """Streams TrainExamples from a `write_shards` directory.

    Multi-process: each process reads shards `process_index::process_count`
    of the per-epoch-shuffled shard order — disjoint, near-balanced subsets
    with no coordination (the same scheme as the eval loop's data sharding).
    """

    def __init__(self, directory: str, process_index: Optional[int] = None,
                 process_count: Optional[int] = None, seed: int = 0,
                 shuffle: bool = True):
        with open(os.path.join(directory, "index.json")) as f:
            self.index = json.load(f)
        self.directory = directory
        rank, world = _process_grid()
        self.process_index = rank if process_index is None else process_index
        self.process_count = world if process_count is None else process_count
        self.seed = seed
        self.shuffle = shuffle

    def __len__(self) -> int:
        return self.index["total"]

    def _shard_paths(self) -> List[str]:
        return [
            os.path.join(self.directory, f"shard-{i:05d}.npz")
            for i in range(self.index["num_shards"])
        ]

    def _epoch_order(self, epoch: int):
        order = np.arange(self.index["num_shards"])
        rng = np.random.RandomState((self.seed * 1_000_003 + epoch) % 2**31)
        if self.shuffle:
            rng.shuffle(order)
        return order, rng

    def batches_per_epoch(self, epoch: int, batch_size: int,
                          drop_remainder: bool = True) -> int:
        """The MINIMUM number of `batch_size` batches any process yields
        this epoch. Multi-host dp training must bound every process's loop
        to this (pass it as iter_batches(max_batches=...)): shard striding
        gives processes near-equal but not identical example counts, and a
        process dispatching one extra collective train step would deadlock
        against peers that already left the loop. Deterministic from
        index.json + the epoch shuffle, so every process computes the same
        value with no communication."""
        counts = np.asarray(self.index["counts"])
        order, _ = self._epoch_order(epoch)
        per_process = []
        for p in range(self.process_count):
            c = int(counts[order[p:: self.process_count]].sum())
            per_process.append(c // batch_size if drop_remainder
                               else -(-c // batch_size))
        return min(per_process) if per_process else 0

    def epoch(self, epoch: int = 0) -> Iterator[TrainExample]:
        paths = self._shard_paths()
        order, rng = self._epoch_order(epoch)
        mine = order[self.process_index:: self.process_count]
        for shard_idx in mine:
            examples = _load_shard(paths[int(shard_idx)])
            idxs = np.arange(len(examples))
            if self.shuffle:
                rng.shuffle(idxs)
            for i in idxs:
                yield examples[int(i)]

    def __iter__(self) -> Iterator[TrainExample]:
        return self.epoch(0)


def iter_batches(examples: Iterable[TrainExample], pipeline, batch_size: int,
                 drop_remainder: bool = True, prefetch: int = 2,
                 max_batches: Optional[int] = None):
    """Group examples into device batches via `pipeline.make_batch`, built on
    a background thread so host featurization overlaps device compute.

    `max_batches` bounds the yield count — multi-host dp training MUST pass
    `dataset.batches_per_epoch(...)` here so every process dispatches the
    same number of collective train steps (a process with one extra batch
    would block forever in its all-reduce while the others have left the loop).

    The consumer may stop early (--max-steps, an exception): the prefetch
    worker observes the stop flag on its next bounded put and exits instead
    of blocking forever on a full queue (which would pin the prefetched
    device batches in device memory for the life of the process)."""
    def groups():
        n = 0
        group: List[TrainExample] = []
        for e in examples:
            group.append(e)
            if len(group) == batch_size:
                yield group
                group = []
                n += 1
                if max_batches is not None and n >= max_batches:
                    return
        if group and not drop_remainder:
            if max_batches is None or n < max_batches:
                yield group

    q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
    _END = object()
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for g in groups():
                if not _put(pipeline.make_batch(g)):
                    return
        except BaseException as e:  # surface in the consumer
            _put(e)
            return
        _put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        try:  # release a worker blocked mid-put
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=5.0)
