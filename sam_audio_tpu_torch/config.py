"""Configuration for the PyTorch port (a copy of sam_audio_tpu/config.py
without the judge configs; the port imports nothing from the JAX package).

Mirrors the reference `config.json` schema (reference: sam_audio/model/config.py:10-251)
so that published checkpoints' configs load unchanged, while using frozen
(hashable) dataclasses internally.

Ranker configs are tagged unions on the "kind" field, including recursive ensembles
(reference: sam_audio/model/config.py:184-201).
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


def _freeze(x):
    """Convert lists to tuples recursively (frozen dataclasses must be hashable)."""
    if isinstance(x, list):
        return tuple(_freeze(v) for v in x)
    if isinstance(x, dict):
        return {k: _freeze(v) for k, v in x.items()}
    return x


@dataclass(frozen=True)
class DACVAEConfig:
    """DAC-VAE codec config (reference: sam_audio/model/config.py:10-41)."""

    encoder_dim: int = 64
    encoder_rates: Tuple[int, ...] = (2, 8, 10, 12)
    latent_dim: int = 1024
    decoder_dim: int = 1536
    decoder_rates: Tuple[int, ...] = (12, 10, 8, 2)
    n_codebooks: int = 16
    codebook_size: int = 1024
    codebook_dim: int = 128
    quantizer_dropout: bool = False
    sample_rate: int = 48_000
    mean: float = 0.0
    std: float = 1.0

    @property
    def hop_length(self) -> int:
        return int(math.prod(self.encoder_rates))


@dataclass(frozen=True)
class T5EncoderConfig:
    """Text encoder config (reference: sam_audio/model/config.py:44-60)."""

    name: str = "t5-base"
    max_length: Optional[int] = 512
    pad_mode: str = "longest"
    dim: int = 768
    # JAX-side architecture hyperparameters for the T5 encoder stack
    # (t5-base defaults; overridable for tiny test models).
    num_layers: int = 12
    num_heads: int = 12
    head_dim: int = 64
    d_ff: int = 3072
    vocab_size: int = 32128
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6


@dataclass(frozen=True)
class PerceptionEncoderConfig:
    """Vision encoder config (reference: sam_audio/model/config.py:63-83)."""

    dim: int = 1024
    batch_size: int = 300
    name: str = "PE-Core-L14-336"
    normalize_feature: bool = True
    interpolation_mode: str = "BICUBIC"
    image_size: int = 336
    # ViT hyperparameters (PE-Core-L14-336: ViT-L/14 @ 336px)
    patch_size: int = 14
    width: int = 1024
    vit_layers: int = 24
    vit_heads: int = 16
    mlp_ratio: float = 4.0
    use_cls_token: bool = True
    # PE-Core applies parameter-free axial 2D RoPE inside self-attention
    # (invisible to checkpoint key sniffing — rope buffers are skipped at
    # conversion). Off by default to keep structural-tower goldens stable;
    # flip on when loading real PE-Core weights.
    use_rope2d: bool = False
    rope2d_theta: float = 10000.0


@dataclass(frozen=True)
class TransformerConfig:
    """DiT backbone config (reference: sam_audio/model/config.py:86-135)."""

    dim: int = 2048
    n_heads: int = 16
    n_layers: int = 16
    dropout: float = 0.1
    norm_eps: float = 1.0e-05
    qk_norm: bool = True
    fc_bias: bool = False
    ffn_exp: int = 4
    ffn_dim_multiplier: float = 1
    multiple_of: int = 64
    non_linearity: str = "swiglu"
    use_rope: bool = True
    max_positions: int = 10000
    frequency_embedding_dim: int = 256
    timestep_non_linearity: str = "swiglu"
    t_block_non_linearity: str = "silu"
    t_block_bias: bool = True
    context_dim: int = 2048
    context_non_linearity: str = "swiglu"
    context_embedder_dropout: float = 0.0
    context_norm: bool = False
    out_channels: int = 256
    in_channels: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def ffn_hidden_dim(self) -> int:
        """SwiGLU hidden size (reference: sam_audio/model/transformer.py:179-185)."""
        hidden = int(self.ffn_exp * self.dim)
        if self.non_linearity == "swiglu":
            hidden = int(2 * hidden / 3)
        hidden = int(self.ffn_dim_multiplier * hidden)
        m = self.multiple_of
        return m * ((hidden + m - 1) // m)


# ---------------------------------------------------------------------------
# Ranker configs (tagged unions, reference: sam_audio/model/config.py:138-201)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RankerConfig:
    kind: str = ""


@dataclass(frozen=True)
class ImageBindRankerConfig(RankerConfig):
    kind: str = "imagebind"
    checkpoint: Optional[str] = None


@dataclass(frozen=True)
class ClapRankerConfig(RankerConfig):
    kind: str = "clap"
    checkpoint: Optional[str] = None


@dataclass(frozen=True)
class JudgeRankerConfig(RankerConfig):
    kind: str = "judge"
    checkpoint_or_model_id: str = "facebook/sam-audio-judge"


@dataclass(frozen=True)
class SoundActivityRankerConfig(RankerConfig):
    kind: str = "sound_activity"
    threshold_mode: str = "rel_to_max"
    sil_threshold: float = -40
    metric: str = "iou"


@dataclass(frozen=True)
class EnsembleRankerConfig(RankerConfig):
    kind: str = "ensemble"
    # mapping name -> (sub-config, weight); stored as a tuple of items so the
    # dataclass stays hashable.
    rankers: Tuple[Tuple[str, Tuple[RankerConfig, float]], ...] = ()

    def items(self):
        return self.rankers


def parse_ranker_config(config_dict: Optional[dict]) -> Optional[RankerConfig]:
    """Tag-dispatch ranker config parser (reference: sam_audio/model/config.py:184-201)."""
    if config_dict is None:
        return None
    config_dict = dict(config_dict)
    kind = config_dict.pop("kind")
    if kind == "imagebind":
        return ImageBindRankerConfig(**config_dict)
    if kind == "clap":
        return ClapRankerConfig(**config_dict)
    if kind == "judge":
        return JudgeRankerConfig(**config_dict)
    if kind == "sound_activity":
        return SoundActivityRankerConfig(**config_dict)
    if kind == "ensemble":
        items = tuple(
            (k, (parse_ranker_config(v), float(w)))
            for k, (v, w) in config_dict["rankers"].items()
        )
        return EnsembleRankerConfig(rankers=items)
    raise ValueError(f"Unknown ranker kind: {kind!r}")


# ---------------------------------------------------------------------------
# Top-level model configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SAMAudioConfig:
    """Top-level model config (reference: sam_audio/model/config.py:204-231)."""

    in_channels: int = 768
    audio_codec: DACVAEConfig = field(default_factory=DACVAEConfig)
    text_encoder: T5EncoderConfig = field(default_factory=T5EncoderConfig)
    vision_encoder: PerceptionEncoderConfig = field(
        default_factory=PerceptionEncoderConfig
    )
    transformer: TransformerConfig = field(default_factory=TransformerConfig)
    num_anchors: int = 3
    anchor_embedding_dim: int = 128
    visual_ranker: Optional[RankerConfig] = None
    text_ranker: Optional[RankerConfig] = None
    span_predictor: Optional[str] = "pe-a-frame-large"
    # Dtype knobs (not in the reference schema).
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SAMAudioConfig":
        d = dict(d)
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        if "audio_codec" in d and isinstance(d["audio_codec"], dict):
            d["audio_codec"] = DACVAEConfig(**_freeze(d["audio_codec"]))
        if "text_encoder" in d and isinstance(d["text_encoder"], dict):
            d["text_encoder"] = T5EncoderConfig(**_freeze(d["text_encoder"]))
        if "vision_encoder" in d and isinstance(d["vision_encoder"], dict):
            d["vision_encoder"] = PerceptionEncoderConfig(**_freeze(d["vision_encoder"]))
        if "transformer" in d and isinstance(d["transformer"], dict):
            d["transformer"] = TransformerConfig(**_freeze(d["transformer"]))
        if isinstance(d.get("visual_ranker"), dict):
            d["visual_ranker"] = parse_ranker_config(d["visual_ranker"])
        if isinstance(d.get("text_ranker"), dict):
            d["text_ranker"] = parse_ranker_config(d["text_ranker"])
        return cls(**d)

    @classmethod
    def from_json(cls, path: str) -> "SAMAudioConfig":
        with open(path) as fin:
            return cls.from_dict(json.load(fin))


def tiny_test_config(**overrides) -> SAMAudioConfig:
    """A miniature SAMAudioConfig for fast unit tests (CPU-friendly)."""
    base = dict(
        in_channels=24,
        audio_codec=DACVAEConfig(
            encoder_dim=4,
            encoder_rates=(2, 4),
            latent_dim=16,
            decoder_dim=16,
            decoder_rates=(4, 2),
            codebook_dim=4,
            sample_rate=8000,
        ),
        text_encoder=T5EncoderConfig(
            dim=16, num_layers=2, num_heads=2, head_dim=8, d_ff=32, vocab_size=256
        ),
        vision_encoder=PerceptionEncoderConfig(
            dim=12, width=16, vit_layers=2, vit_heads=2, image_size=28, patch_size=14
        ),
        transformer=TransformerConfig(
            dim=32,
            n_heads=2,
            n_layers=2,
            dropout=0.0,
            context_dim=32,
            max_positions=64,
            frequency_embedding_dim=8,
            out_channels=8,
            in_channels=None,
        ),
        num_anchors=3,
        anchor_embedding_dim=8,
        span_predictor=None,
        compute_dtype="float32",
    )
    base.update(overrides)
    return SAMAudioConfig(**base)
