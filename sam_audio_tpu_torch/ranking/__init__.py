"""Ranker factory (reference: sam_audio/ranking/__init__.py:15-30). The port
has the CLAP text ranker; the others come with later slices of the port."""

from __future__ import annotations

from typing import Optional

from sam_audio_tpu_torch.config import (
    ClapRankerConfig,
    EnsembleRankerConfig,
    ImageBindRankerConfig,
    JudgeRankerConfig,
    RankerConfig,
    SoundActivityRankerConfig,
)
from sam_audio_tpu_torch.ranking.ranker import Ranker

_LATER_SLICES = {
    JudgeRankerConfig: "the judge slice",
    ImageBindRankerConfig: "the visual slice",
    SoundActivityRankerConfig: "the judge slice, with the other host scorers",
    EnsembleRankerConfig: "the judge slice, once its members are ported",
}


def create_ranker(config: Optional[RankerConfig], allow_random: bool = False,
                  device="cuda") -> Optional[Ranker]:
    """Build a ranker from its config on `device`. `allow_random=True`
    (tests, benchmarks) lets a weightless CLAP config use random weights
    instead of raising."""
    if config is None:
        return None
    if isinstance(config, ClapRankerConfig):
        from sam_audio_tpu_torch.ranking.clap import ClapRanker

        return ClapRanker(config, allow_random=allow_random, device=device)
    for cls, where in _LATER_SLICES.items():
        if isinstance(config, cls):
            raise NotImplementedError(
                f"the {config.kind!r} ranker is not ported yet ({where})")
    raise ValueError(f"Unknown ranker config: {config!r}")
