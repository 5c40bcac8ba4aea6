"""Span predictor: when does the described sound occur in the mixture.

Counterpart of sam_audio_tpu/models/span_predictor.py (reference:
sam_audio/model/model.py:96-102, 231-245). Input: the text prompt and the
first 128 latent channels of the mixture; output: per item a list of
(start_sec, end_sec) spans, which `SAMAudio.separate(predict_spans=True)`
turns into "+" anchors.

Two executors with one callable interface, `(model, batch, audios) ->
spans`:

  * `SpanPredictor` — the JAX package's native design: audio latents ->
    linear embed -> pre-LN layers (RoPE self-attention, cross-attention to
    the T5 features, a SwiGLU FFN) -> a final LayerNorm and a 1-wide head.
    Its codec encode and T5 run in the model's compute dtype.
  * `PEAudioFrameModel` — a converted PEAudioFrame ("pe-a-frame-large")
    checkpoint: [token embeddings ; data_proj(latents)] through one PE-AV
    transformer (models/peav.py), the frame head over the audio positions.
    Its codec encode runs in fp32, as JAX's runs with no compute dtype.

Frame probabilities become spans on the host (`frames_to_spans`): a hard
threshold and a minimum duration, at sample_rate / hop_length frames a
second (25 for the 48 kHz codec).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from sam_audio_tpu_torch.config import PEAVTransformerConfig
from sam_audio_tpu_torch.ops import nn as N
from sam_audio_tpu_torch.ops.attention import attend
from sam_audio_tpu_torch.ops.rope import apply_rope, precompute_rope
from sam_audio_tpu_torch.utils import unstack_layers

Spans = List[List[Tuple[float, float]]]


@dataclass(frozen=True)
class SpanPredictorConfig:
    audio_dim: int = 128
    text_dim: int = 768
    hidden: int = 512
    n_layers: int = 4
    n_heads: int = 8
    norm_eps: float = 1e-5
    max_positions: int = 10000
    threshold: float = 0.5
    min_duration_s: float = 0.2
    frame_rate: float = 25.0


def span_predictor_forward(params, cfg: SpanPredictorConfig, audio_features, audio_pad_mask,
                           text_features, text_mask, compute_dtype=None):
    """audio_features: (B, T, audio_dim); text_features: (B, L, text_dim);
    the masks bool, True = valid. Returns frame logits (B, T) fp32."""
    b, t, _ = audio_features.shape
    nh = cfg.n_heads
    hd = cfg.hidden // nh
    h = N.linear(params["audio_embed"], audio_features, compute_dtype)
    y = N.linear(params["text_embed"], text_features, compute_dtype)
    rope = precompute_rope(hd, t, max(10000, 2 * cfg.max_positions), device=h.device)

    def heads(p, x):
        return N.linear(p, x, compute_dtype).reshape(b, x.shape[1], nh, hd)

    for layer in unstack_layers(params["layers"]):
        sa, ca = layer["self_attn"], layer["cross_attn"]
        x = N.layernorm(layer["ln1"], h, cfg.norm_eps)
        q = apply_rope(heads(sa["wq"], x), *rope)
        k = apply_rope(heads(sa["wk"], x), *rope)
        o = attend(q, k, heads(sa["wv"], x), key_padding_mask=audio_pad_mask)
        h = h + N.linear(sa["wo"], o.reshape(b, t, -1), compute_dtype)

        x = N.layernorm(layer["ln_cross"], h, cfg.norm_eps)
        o = attend(heads(ca["wq"], x), heads(ca["wk"], y), heads(ca["wv"], y),
                   key_padding_mask=text_mask)
        h = h + N.linear(ca["wo"], o.reshape(b, t, -1), compute_dtype)

        x = N.layernorm(layer["ln2"], h, cfg.norm_eps)
        h = h + N.feedforward(layer["mlp"], x, "swiglu", compute_dtype)
    h = N.layernorm(params["final_norm"], h, cfg.norm_eps)
    return N.linear(params["head"], h, compute_dtype)[..., 0].float()


def frames_to_spans(probs: np.ndarray, valid_mask: np.ndarray, threshold: float = 0.5,
                    min_duration_s: float = 0.2, frame_rate: float = 25.0) -> Spans:
    """Per item, the runs of valid frames with p > threshold lasting at least
    `min_duration_s`, as (start, end) seconds."""
    out = []
    min_frames = max(1, int(round(min_duration_s * frame_rate)))
    for p, m in zip(probs, valid_mask):
        active = (p > threshold) & m
        spans = []
        start = None
        for i, a in enumerate(active.tolist() + [False]):
            if a and start is None:
                start = i
            elif not a and start is not None:
                if i - start >= min_frames:
                    spans.append((start / frame_rate, i / frame_rate))
                start = None
        out.append(spans)
    return out


def _spans(model, batch, logits, cfg) -> Spans:
    probs = torch.sigmoid(logits).cpu().numpy()
    return frames_to_spans(probs, np.asarray(batch.audio_pad_mask), threshold=cfg.threshold,
                           min_duration_s=cfg.min_duration_s,
                           frame_rate=model.sample_rate / model.hop_length)


def _latents(model, audios, audio_dim: int, compute_dtype) -> torch.Tensor:
    """The mixture's first `audio_dim` latent channels, (B, T, audio_dim) fp32."""
    from sam_audio_tpu_torch.models import dacvae

    lat = dacvae.encode(model.params["audio_codec"], audios, model.cfg.audio_codec,
                        compute_dtype=compute_dtype)
    return lat.transpose(1, 2).float()[..., :audio_dim]


class SpanPredictor:
    """The native predictor, attached as `SAMAudio.span_predictor`. `params`
    are tensors on the device of the model it serves."""

    def __init__(self, cfg: SpanPredictorConfig, params):
        self.cfg = cfg
        self.params = params

    @classmethod
    def init_random(cls, cfg: SpanPredictorConfig = SpanPredictorConfig(), seed: int = 0,
                    device="cuda"):
        from sam_audio_tpu_torch.models.init import span_predictor_init
        from sam_audio_tpu_torch.models.sam_audio import resolve_device

        dev = resolve_device(device)
        return cls(cfg, span_predictor_init(cfg, torch.Generator(device=dev).manual_seed(seed),
                                            dev))

    def logits(self, model, batch, audios) -> torch.Tensor:
        from sam_audio_tpu_torch.models.sam_audio import DTYPES
        from sam_audio_tpu_torch.models.t5 import t5_encode

        # featurized in the model's compute dtype, as the JAX package's
        # trainer (train/span.py) encodes them
        compute_dtype = DTYPES[model.cfg.compute_dtype]
        lat = _latents(model, audios, self.cfg.audio_dim, compute_dtype)
        text_ids, text_mask = model._tokenize(batch.descriptions)
        text_features = t5_encode(model.params["text_encoder"], text_ids, text_mask,
                                  model.cfg.text_encoder, compute_dtype=compute_dtype)
        pad_mask = torch.as_tensor(np.asarray(batch.audio_pad_mask), device=model.device)
        return span_predictor_forward(self.params, self.cfg, lat, pad_mask, text_features,
                                      text_mask)

    def __call__(self, model, batch, audios) -> Spans:
        return _spans(model, batch, self.logits(model, batch, audios), self.cfg)


@dataclass(frozen=True)
class PEAudioFrameConfig:
    """A converted PEAudioFrame ("pe-a-frame-large") checkpoint (reference
    model.py:96-102). The transformer's switches are sniffed at conversion
    (convert.convert_peaudioframe_state_dict)."""

    audio_dim: int = 128
    hidden: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    vocab_size: int = 50368
    threshold: float = 0.5
    min_duration_s: float = 0.2
    prenorm: bool = True
    act: str = "gelu_tanh"
    pos: str = "sinusoidal"
    norm: str = "layernorm"

    def transformer(self) -> PEAVTransformerConfig:
        return PEAVTransformerConfig(hidden_size=self.hidden, num_layers=self.num_layers,
                                     num_heads=self.num_heads, prenorm=self.prenorm,
                                     act=self.act, pos=self.pos, norm=self.norm)


def peaudioframe_forward(params, cfg: PEAudioFrameConfig, audio_features, audio_pad_mask,
                         input_ids, attention_mask, compute_dtype=None):
    """[text token embeddings ; projected audio frames] through one PE-AV
    transformer, the frame head over the last T positions. audio_features:
    (B, T, audio_dim); input_ids / attention_mask: (B, L). Returns frame
    logits (B, T) fp32."""
    from sam_audio_tpu_torch.models.peav import peav_apply

    t = audio_features.shape[1]
    text = N.embedding(params["text_embed"], input_ids)
    audio = N.linear(params["data_proj"], audio_features, compute_dtype)
    x = torch.cat([text.to(audio.dtype), audio], dim=1)
    mask = torch.cat([attention_mask.bool(), audio_pad_mask.bool()], dim=1)
    out = peav_apply(params["transformer"], x, cfg.transformer(), padding_mask=mask,
                     compute_dtype=compute_dtype)
    frames = out.last_hidden_state[:, -t:]
    return N.linear(params["head"], frames, None)[..., 0].float()


class PEAudioFrameModel:
    """A span predictor running a converted PEAudioFrame checkpoint; the same
    callable interface as SpanPredictor. It runs in fp32 whatever the
    model's compute dtype, as in JAX: the codec encode and the transformer."""

    def __init__(self, cfg: PEAudioFrameConfig, params, tokenizer=None):
        self.cfg = cfg
        self.params = params
        self._tokenizer = tokenizer

    @classmethod
    def init_random(cls, cfg: PEAudioFrameConfig = PEAudioFrameConfig(), seed: int = 0,
                    device="cuda"):
        from sam_audio_tpu_torch.models.init import peaudioframe_init
        from sam_audio_tpu_torch.models.sam_audio import resolve_device

        dev = resolve_device(device)
        return cls(cfg, peaudioframe_init(cfg, torch.Generator(device=dev).manual_seed(seed), dev))

    @property
    def tokenizer(self):
        if self._tokenizer is None:
            from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer

            self._tokenizer = ByteFallbackTokenizer(self.cfg.vocab_size)
        return self._tokenizer

    def logits(self, model, batch, audios) -> torch.Tensor:
        # JAX encodes with no compute dtype: fp32 over its fp32 weights
        lat = _latents(model, audios, self.cfg.audio_dim, torch.float32)
        ids, mask = self.tokenizer(batch.descriptions)
        dev = model.device
        pad_mask = torch.as_tensor(np.asarray(batch.audio_pad_mask), device=dev)
        return peaudioframe_forward(
            self.params, self.cfg, lat, pad_mask,
            torch.as_tensor(np.asarray(ids), dtype=torch.long, device=dev),
            torch.as_tensor(np.asarray(mask), device=dev))

    def __call__(self, model, batch, audios) -> Spans:
        return _spans(model, batch, self.logits(model, batch, audios), self.cfg)
