"""Ranker factory (reference: sam_audio/ranking/__init__.py:15-30): the CLAP,
judge, ImageBind, sound-activity and ensemble rankers."""

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
from sam_audio_tpu_torch.ranking.ranker import EnsembleRanker, Ranker


def create_ranker(config: Optional[RankerConfig], allow_random: bool = False,
                  device="cuda") -> Optional[Ranker]:
    """Build a ranker from its config on `device`. `allow_random=True`
    (tests, benchmarks) lets a weightless CLAP or ImageBind config use random
    weights instead of raising. A judge loads its snapshot directory
    (`checkpoint_or_model_id`) at first use."""
    if config is None:
        return None
    if isinstance(config, SoundActivityRankerConfig):
        from sam_audio_tpu_torch.ranking.sound_activity import SoundActivityRanker

        return SoundActivityRanker(config)
    if isinstance(config, ClapRankerConfig):
        from sam_audio_tpu_torch.ranking.clap import ClapRanker

        return ClapRanker(config, allow_random=allow_random, device=device)
    if isinstance(config, JudgeRankerConfig):
        from sam_audio_tpu_torch.ranking.judge import JudgeRanker

        return JudgeRanker(config, device=device)
    if isinstance(config, ImageBindRankerConfig):
        from sam_audio_tpu_torch.ranking.imagebind import ImageBindRanker

        return ImageBindRanker(config, allow_random=allow_random, device=device)
    if isinstance(config, EnsembleRankerConfig):
        rankers, weights = [], []
        for _, (sub, weight) in config.items():
            rankers.append(create_ranker(sub, allow_random=allow_random, device=device))
            weights.append(weight)
        return EnsembleRanker(rankers, weights)
    raise ValueError(f"Unknown ranker config: {config!r}")
