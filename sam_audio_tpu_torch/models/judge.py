"""SAMAudioJudge: the quality scorer of (text, mixture, separated) triplets;
counterpart of sam_audio_tpu/models/judge.py.

Four scores (overall, recall, precision, faithfulness), as the reference
pipeline computes them (sam_audio/model/judge.py:35-132):

  text:  ModernBERT -> hidden layer `nth_text_layer` -> CLS -> text_proj1
  audio: [mixture ; separated] stacked on the batch axis -> the DAC-VAE
         *encoder* (every residual unit through kernel 3 on the card) ->
         data_proj -> the shared PE-AV transformer
  fuse:  concat(hyp, input) -> cat_audio_proj (bottleneck 256)
         + layernorm(text_proj2(text)) broadcast -> proj_audio_and_text
         -> the finetune PE-AV transformer -> 4-dim head -> masked mean
         -> de-normalise (x * std + mean)

`judge_forward_grouped` is the k-candidate form used by the reranker: the
mixture-side towers run once per item and their features are repeated k
times, with the same outputs as `judge_forward` on the flattened pairs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from sam_audio_tpu_torch.config import SAMAudioJudgeConfig
from sam_audio_tpu_torch.models import dacvae
from sam_audio_tpu_torch.models.modernbert import modernbert_encode
from sam_audio_tpu_torch.models.peav import peav_apply
from sam_audio_tpu_torch.models.sam_audio import DTYPES, resolve_device
from sam_audio_tpu_torch.ops import nn as N


@dataclass
class SAMAudioJudgeOutput:
    """reference: sam_audio/model/judge.py:16-32; each (B, 1)."""

    overall: Optional[torch.Tensor] = None
    recall: Optional[torch.Tensor] = None
    precision: Optional[torch.Tensor] = None
    faithfulness: Optional[torch.Tensor] = None


def _text_features(params, cfg: SAMAudioJudgeConfig, input_ids, attention_mask,
                   compute_dtype):
    if attention_mask is None:
        attention_mask = torch.ones(input_ids.shape, dtype=torch.bool, device=input_ids.device)
    nth = cfg.nth_text_layer
    last, hidden = modernbert_encode(params["text_model"], input_ids, attention_mask,
                                     cfg.text_model, compute_dtype,
                                     output_hidden_states=nth is not None)
    text_out = last if nth is None else hidden[nth]
    return N.linear(params["text_proj1"], text_out[:, 0], compute_dtype)


def _shared_tower(params, cfg: SAMAudioJudgeConfig, values, mask, compute_dtype):
    """(N, 1, Tw) waveforms -> the shared PE-AV tower's (N, T, hidden)."""
    feats = dacvae.encode(params["audio_codec"], values, cfg.audio_codec, compute_dtype)
    x = N.linear(params["data_proj"], feats.transpose(1, 2), compute_dtype)
    return peav_apply(params["transformer"], x, cfg.transformer, padding_mask=mask,
                      compute_dtype=compute_dtype).last_hidden_state


def judge_forward(params, cfg: SAMAudioJudgeConfig, input_ids, input_values,
                  separated_values, attention_mask=None, padding_mask=None,
                  compute_dtype=None) -> SAMAudioJudgeOutput:
    """input_ids (B, L); input_values / separated_values (B, 1, Tw) mixture
    and separated waveforms; padding_mask (B, Tw) True = a real sample."""
    text_features = _text_features(params, cfg, input_ids, attention_mask, compute_dtype)
    feature_mask = stacked_mask = None
    if padding_mask is not None:
        # the frame mask samples every hop-th position (not a ceil of sizes)
        feature_mask = padding_mask[:, :: cfg.audio_codec.hop_length]
        stacked_mask = torch.cat([feature_mask] * 2, dim=0)
    # mixture and separated stacked on the batch axis: one codec/tower pass
    tower = _shared_tower(params, cfg, torch.cat([input_values, separated_values], dim=0),
                          stacked_mask, compute_dtype)
    b = input_values.shape[0]
    return _fuse_and_score(params, cfg, text_features, tower[:b], tower[b:], feature_mask,
                           compute_dtype)


def _fuse_and_score(params, cfg, text_features, input_features, hyp_features,
                    feature_mask, compute_dtype) -> SAMAudioJudgeOutput:
    """The per-candidate fusion tail (reference judge.py:112-132)."""
    audio_features = N.linear(params["cat_audio_proj"],
                              torch.cat([hyp_features, input_features], dim=2), compute_dtype)
    text = N.layernorm(params["layer_norm"],
                       N.linear(params["text_proj2"], text_features, compute_dtype))
    text = text[:, None, :].expand(*audio_features.shape[:2], text.shape[-1])
    audio_and_text = N.linear(params["proj_audio_and_text"],
                              torch.cat([audio_features, text.to(audio_features.dtype)], dim=2),
                              compute_dtype)
    ft = peav_apply(params["finetune_transformer"],
                    N.linear(params["finetune_data_proj"], audio_and_text, compute_dtype),
                    cfg.finetune_transformer, padding_mask=feature_mask,
                    compute_dtype=compute_dtype)
    result = N.linear(params["head"], ft.last_hidden_state, compute_dtype).float()
    if feature_mask is not None:
        m = feature_mask[:, :, None].float()
        pooled = (result * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
    else:
        pooled = result.mean(1)
    de_norm = pooled * params["std"].float() + params["mean"].float()
    return SAMAudioJudgeOutput(overall=de_norm[:, 0:1], recall=de_norm[:, 1:2],
                               precision=de_norm[:, 2:3], faithfulness=de_norm[:, 3:4])


def judge_forward_grouped(params, cfg: SAMAudioJudgeConfig, input_ids, input_values,
                          separated_values, attention_mask=None, padding_mask=None,
                          k: int = 1, compute_dtype=None) -> SAMAudioJudgeOutput:
    """`judge_forward` for k candidates per item, without the repeated work:
    input_ids (B, L) and input_values (B, 1, Tw) hold ONE text and mixture
    per item, separated_values (B*k, 1, Tw) its k candidates, padding_mask
    (B, Tw) is shared by an item's mixture and candidates. ModernBERT runs
    once per text and the codec + shared tower once per mixture; their
    features are repeated k times (rows item-major, as the reference's
    flatten, sam_audio/ranking/judge.py:29-32)."""
    text_features = _text_features(params, cfg, input_ids, attention_mask, compute_dtype)
    item_mask = cand_mask = None
    if padding_mask is not None:
        item_mask = padding_mask[:, :: cfg.audio_codec.hop_length]
        cand_mask = torch.repeat_interleave(item_mask, k, dim=0)
    input_features = torch.repeat_interleave(
        _shared_tower(params, cfg, input_values, item_mask, compute_dtype), k, dim=0)
    hyp_features = _shared_tower(params, cfg, separated_values, cand_mask, compute_dtype)
    return _fuse_and_score(params, cfg, torch.repeat_interleave(text_features, k, dim=0),
                           input_features, hyp_features, cand_mask, compute_dtype)


# Read in fp32 by the judge and stored there: ModernBERT's token table (its
# rows are normalised in fp32 before the cast, as in JAX) and the PE-AV
# towers' layer norms (stacked, so 2-D, under names without "norm").
FP32_SUBTREES = ("tok_embeddings", "ln1", "ln2")


class SAMAudioJudgeModel:
    """Holds (cfg, params, device), as the reference class does.

      * `SAMAudioJudgeModel.from_pretrained(dir, device="cuda")` — a local
        `config.json` + `params.npz` snapshot of the JAX package's judge
        (no hub, no network);
      * `SAMAudioJudgeModel.init_random(cfg, seed, device="cuda")`.
    Calls run at the config's compute dtype (weights stored in it)."""

    def __init__(self, cfg: SAMAudioJudgeConfig, params, device="cuda"):
        from sam_audio_tpu_torch.checkpoint import cast_matmul_weights

        self.cfg = cfg
        self.device = resolve_device(device)
        self.compute_dtype = DTYPES[cfg.compute_dtype]
        if self.compute_dtype != torch.float32:
            params = cast_matmul_weights(params, self.compute_dtype, keep=FP32_SUBTREES)
        self.params = params

    @classmethod
    def init_random(cls, cfg: SAMAudioJudgeConfig, seed: int = 0, device="cuda"):
        from sam_audio_tpu_torch.models.init import judge_init

        dev = resolve_device(device)
        return cls(cfg, judge_init(cfg, torch.Generator(device=dev).manual_seed(seed), dev),
                   device=dev)

    @classmethod
    def from_pretrained(cls, path: str, device="cuda", **overrides):
        from sam_audio_tpu_torch.checkpoint import load_judge

        return load_judge(path, device=device, **overrides)

    def quantize(self):
        """The opt-in int8 mode of the scorer (not exact): both PE-AV towers
        and ModernBERT run W8A8 (ops/quant.py). Returns self."""
        from sam_audio_tpu_torch.ops.quant import quantize_judge_params

        self.params = quantize_judge_params(self.params)
        return self

    @torch.inference_mode()
    def __call__(self, **kwargs) -> SAMAudioJudgeOutput:
        """judge_forward on tensors on the model's device."""
        return judge_forward(self.params, self.cfg, compute_dtype=self.compute_dtype, **kwargs)
