"""The host runtime.

`plan_batches` here is the serving layer's batch planner, in plain Python
(the numpy path of sam_audio_tpu/runtime/native.py). `native` holds the C++
host library (built with g++ at first use): WAV I/O, which `load_audio` uses
for float and extensible WAVs, and, for parity with the JAX package, a
resampler and a second planner that no serving path calls.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def plan_batches(lengths: Sequence[int], hop: int, bucket_steps: int,
                 max_batch: int) -> Tuple[List[List[int]], List[int]]:
    """Groups request indices by length bucket. Each length rounds up to a
    multiple of `hop * bucket_steps` (left as it is when that unit is not
    positive); indices sorted by (bucket, index) fill groups of at most
    `max_batch` of one bucket. Returns (groups, the padded length of each
    group)."""
    n = len(lengths)
    unit = hop * bucket_steps
    if unit <= 0:
        bucketed = list(lengths)
    else:
        bucketed = [((length + unit - 1) // unit) * unit for length in lengths]
    idx = sorted(range(n), key=lambda i: (bucketed[i], i))
    batches, buckets = [], []
    i = 0
    while i < n:
        b = bucketed[idx[i]]
        group = []
        while i < n and bucketed[idx[i]] == b and len(group) < max_batch:
            group.append(idx[i])
            i += 1
        batches.append(group)
        buckets.append(b)
    return batches, buckets


__all__ = ["plan_batches"]
