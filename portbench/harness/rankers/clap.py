"""The CLAP text ranker (`"text_ranker": {"kind": "clap"}`; its widths in
the configuration's `clap` block, the fields of the program's ClapConfig;
scored by reference/sam_audio_clap.py).

Weights: the program's CLAP tree (models/clap.py, models/htsat.py,
models/roberta.py) drawn from seed + 2 by weights.materialize's rules, with
the swin blocks' relative position tables normal(0, 0.02); its buffers are
computed, not drawn: the mel filterbank (librosa's Slaney filters, from the
reference), bn0's running mean 0 and variance 1, the logit scales
log(1 / 0.07). Tokens: the byte fallback at RoBERTa's vocabulary.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench.harness.weights import _affine, _linear, materialize

# roberta-base's position table (512 tokens past the padding id 1) and its
# one token type
ROBERTA_POSITIONS = 514
ROBERTA_TYPES = 1


def config(cfg: dict):
    """The program's ClapConfig of the configuration's `clap` block."""
    from sam_audio_tpu_torch.models.clap import ClapConfig

    return ClapConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in cfg["clap"].items()})


def spec(c: dict):
    """The program's CLAP tree for a `clap` block; `melW` is filled in by
    weights()."""
    ws = c["window_size"]

    def block(ch, heads):
        return {"norm1": _affine(ch), "qkv": _linear(ch, 3 * ch), "proj": _linear(ch, ch),
                "relative_position_bias_table": ("n", ((2 * ws - 1) ** 2, heads), 0.02),
                "norm2": _affine(ch), "fc1": _linear(ch, 4 * ch), "fc2": _linear(4 * ch, ch)}

    e, p, mels = c["audio_embed_dim"], c["patch_size"], c["n_mels"]
    stages = []
    for i, depth in enumerate(c["depths"]):
        ch = e * 2 ** i
        stage = {"blocks": [block(ch, c["audio_heads"][i]) for _ in range(depth)]}
        if i < len(c["depths"]) - 1:
            stage["downsample"] = {"norm": _affine(4 * ch),
                                   "reduction": _linear(4 * ch, 2 * ch, False)}
        stages.append(stage)
    out = e * 2 ** (len(c["depths"]) - 1)
    audio = {"bn0": {**_affine(mels), "mean": ("c", (mels,), 0.0), "var": ("c", (mels,), 1.0)},
             "patch_embed": {"proj": {"weight": ("u", (e, 1, p, p), 1.0 / p),
                                      "bias": ("u", (e,), 1.0 / p)},
                             "norm": _affine(e)},
             "stages": stages, "norm": _affine(out)}
    h, m, L = c["text_hidden"], c["text_intermediate"], (c["text_layers"],)
    text = {"word_embeddings": {"weight": ("n", (c["text_vocab"], h), 1.0)},
            "position_embeddings": {"weight": ("n", (ROBERTA_POSITIONS, h), 1.0)},
            "token_type_embeddings": {"weight": ("n", (ROBERTA_TYPES, h), 1.0)},
            "emb_ln": _affine(h),
            "layers": {"attn": {k: _linear(h, h, True, L) for k in ("wq", "wk", "wv", "wo")},
                       "attn_ln": _affine(h, L), "fc1": _linear(h, m, True, L),
                       "fc2": _linear(m, h, True, L), "ffn_ln": _affine(h, L)},
            "pooler": _linear(h, h)}
    j = c["embed_dim"]
    return {"audio_branch": audio, "text_branch": text,
            "audio_projection": {"fc1": _linear(out, j), "fc2": _linear(j, j)},
            "text_projection": {"fc1": _linear(h, j), "fc2": _linear(j, j)},
            "logit_scale_a": ("c", (), math.log(1 / 0.07)),
            "logit_scale_t": ("c", (), math.log(1 / 0.07))}


def weights(cfg: dict, seed: int, device) -> dict:
    from portbench.reference.sam_audio_clap import mel_filterbank

    c = cfg["clap"]
    tree = materialize(spec(c), seed + 2, device)
    tree["audio_branch"]["melW"] = torch.tensor(
        mel_filterbank(c["sample_rate"], c["n_fft"], c["n_mels"], c["fmin"], c["fmax"]),
        dtype=torch.float32, device=device)
    return tree


def build(cfg: dict, seed: int, device):
    """The program's ClapRanker over a ClapModel of weights(), with the byte
    tokenizer."""
    from sam_audio_tpu_torch.config import parse_ranker_config
    from sam_audio_tpu_torch.models.clap import ClapModel
    from sam_audio_tpu_torch.ranking.clap import ClapRanker
    from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer

    c = config(cfg)
    model = ClapModel(c, weights(cfg, seed, device),
                      tokenizer=ByteFallbackTokenizer(c.text_vocab), allow_fallback_tokenizer=True)
    return ClapRanker(parse_ranker_config(cfg["text_ranker"]), model=model)


def prompt_tokens(cfg: dict, descriptions: List[str]) -> int:
    """RoBERTa's tokens of the group's longest prompt (the byte tokenizer's,
    at most `max_text_len`)."""
    from portbench.reference.sam_audio import byte_tokens

    return max(len(byte_tokens(d, cfg["clap"]["max_text_len"])) for d in descriptions)


def audio_flops(clap: dict) -> float:
    """HTSAT-tiny and the audio projection on one candidate (the `clap`
    block of a configuration): the log-mel filterbank product, the bicubic
    time resize to spec_size x freq_ratio frames, the patch embedding, every
    swin block (qkv, windowed scores and values, projection, MLP of 4x) and
    patch merge, the 2-layer projection. The FFT is not a product."""
    frames = int(round(clap["sample_rate"] * clap["duration_s"])) // clap["hop_length"] + 1
    mels = clap["n_mels"]
    ratio = clap["spec_size"] // mels
    total = 2 * frames * (clap["n_fft"] // 2 + 1) * mels
    if frames != clap["spec_size"] * ratio:
        total += 2 * 4 * mels * clap["spec_size"] * ratio
    p, c = clap["patch_size"], clap["audio_embed_dim"]
    res = clap["spec_size"] // p
    total += 2 * p * p * c * res * res
    for i, depth in enumerate(clap["depths"]):
        n, t = res * res, min(clap["window_size"], res) ** 2
        total += depth * (n * 2 * 12 * c * c + 4 * n * t * c)
        if i < len(clap["depths"]) - 1:
            total += 2 * (n // 4) * 4 * c * 2 * c
            res, c = res // 2, 2 * c
    e = clap["embed_dim"]
    return total + 2 * c * e + 2 * e * e


def text_flops(clap: dict, tokens: int) -> float:
    """RoBERTa (every layer's products and attention), its pooler and the
    2-layer projection on one prompt of `tokens` tokens."""
    h, m, e = clap["text_hidden"], clap["text_intermediate"], clap["embed_dim"]
    layer = tokens * 2 * (4 * h * h + 2 * h * m) + 4 * tokens * tokens * h
    return clap["text_layers"] * layer + 2 * h * h + 2 * h * e + 2 * e * e


def flops(cfg: dict, g) -> float:
    """Every candidate's audio embedding and each item's prompt."""
    clap = cfg["clap"]
    return g.rows * (g.candidates * audio_flops(clap) + text_flops(clap, g.rank_text))


def encoder_launches(cfg: dict, g) -> Dict[int, int]:
    """CLAP runs no codec encode."""
    return {}
