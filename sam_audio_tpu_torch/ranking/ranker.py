"""Ranker interface (reference: sam_audio/ranking/ranker.py:9-36).

A ranker scores k candidate separations per item: __call__(**kwargs) ->
(batch_size, num_candidates) numpy array; argmax picks the winner.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np


class Ranker(ABC):
    @abstractmethod
    def __call__(self, **kwargs) -> np.ndarray:
        """Returns scores of shape (batch_size, num_candidates)."""
