"""Ranker interface and the weighted ensemble (reference:
sam_audio/ranking/ranker.py:9-36).

A ranker scores k candidate separations per item: __call__(**kwargs) ->
(batch_size, num_candidates) numpy array; argmax picks the winner.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List

import numpy as np


class Ranker(ABC):
    @abstractmethod
    def __call__(self, **kwargs) -> np.ndarray:
        """Returns scores of shape (batch_size, num_candidates)."""

    def forward(self, **kwargs) -> np.ndarray:
        """torch-style alias of __call__ (reference ranker.py:16-18)."""
        return self(**kwargs)


class EnsembleRanker(Ranker):
    """The weighted sum of the members' scores (reference: ranker.py:22-36).
    Every member gets every keyword argument; it scores on the host."""

    def __init__(self, rankers: List[Ranker], weights: List[float]):
        if len(rankers) != len(weights):
            raise ValueError(f"{len(rankers)} rankers and {len(weights)} weights")
        self.rankers = rankers
        self.weights = weights

    def __call__(self, **kwargs) -> np.ndarray:
        result = None
        for weight, ranker in zip(self.weights, self.rankers):
            scores = np.asarray(ranker(**kwargs), np.float32)
            result = weight * scores if result is None else result + weight * scores
        return result
