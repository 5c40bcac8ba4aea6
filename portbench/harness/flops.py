"""Operations and bytes of the work a cell does, worked out from the
configuration's shapes, and the published peaks they are held against.

A product of (m, k) by (k, n) counts 2 m k n operations. Elementwise work,
norms and softmax are not counted in a model's operations (they are a few
percent and bound by bytes); the kernels' roofline bounds count the bytes
each kernel must move: every input read once, every output written once.
The kernel formulas are those of chip_smoke.py (kernel 1 :416-418 and :443,
kernel 2 :505-506, kernel 3 :606-607).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

# NVIDIA H100 SXM, dense, at the full 700 W power limit (NVIDIA's data sheet)
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
HBM_BPS = 3.35e12


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    """The least time for `flops` operations moving `nbytes`."""
    return max(flops / peak, nbytes / HBM_BPS)


@dataclass
class GroupShape:
    """One dispatched group: `rows` batch rows of `samples` padded samples
    (`frames` latent frames), `text` padded prompt tokens, `video_frames`
    frames a row through the vision tower (0 without video), `evals` DiT
    evaluations."""
    rows: int
    samples: int
    frames: int
    text: int
    video_frames: int = 0
    evals: int = 32


def ffn_hidden(tf: dict) -> int:
    hidden = int(tf["ffn_exp"] * tf["dim"])
    if tf["non_linearity"] == "swiglu":
        hidden = int(2 * hidden / 3)
    hidden = int(tf["ffn_dim_multiplier"] * hidden)
    m = tf["multiple_of"]
    return m * ((hidden + m - 1) // m)


def dit_eval_flops(cfg: dict, t: int, text: int) -> float:
    """One velocity evaluation of one row: the input projections, the stem,
    the embedders, every layer's products and attention, the head."""
    tf = cfg["transformer"]
    d = tf["dim"]
    f = ffn_hidden(tf)
    mats = 3 if tf["non_linearity"] == "swiglu" else 2
    ctx = 3 if tf["context_non_linearity"] == "swiglu" else 2
    per_token_layer = (2 * 4 * d * d             # self-attention q, k, v, o
                       + 2 * 2 * d * d           # cross-attention q, o
                       + 2 * mats * d * f)       # FFN
    layer = (t * per_token_layer
             + text * 2 * 2 * d * d              # cross-attention k, v on the prompt
             + 4 * t * t * d                     # self-attention scores and values
             + 4 * t * text * d)                 # cross-attention scores and values
    align = t * 2 * (cfg["in_channels"] * d + cfg["vision_encoder"]["dim"] * d
                     + cfg["anchor_embedding_dim"] * d)
    stem = t * 2 * 2 * 3 * d * d                 # two k=3 convs
    memory = text * 2 * (cfg["text_encoder"]["dim"] * d + ctx * tf["context_dim"] * d)
    head = t * 2 * d * tf["out_channels"]
    t_mats = 2 if tf["timestep_non_linearity"] == "swiglu" else 1
    t_embed = 2 * (t_mats * tf["frequency_embedding_dim"] * d + d * d + d * 6 * d)
    return tf["n_layers"] * layer + align + stem + memory + head + t_embed


def t5_flops(cfg: dict, text: int) -> float:
    c = cfg["text_encoder"]
    inner = c["num_heads"] * c["head_dim"]
    per_layer = text * 2 * (4 * c["dim"] * inner + 2 * c["dim"] * c["d_ff"]) + 4 * text * text * inner
    return c["num_layers"] * per_layer


def residual_units(cfg: dict, samples: int, frames: int) -> Tuple[List[Tuple[int, int]],
                                                                  List[Tuple[int, int]]]:
    """(channels, length) of every codec residual unit of one row: the
    encoder's (on `samples`), and one decoder's (from `frames`)."""
    c = cfg["audio_codec"]
    enc, d, n = [], c["encoder_dim"], samples
    for s in c["encoder_rates"]:
        enc += [(d, n)] * 3
        n = (n + 2 * math.ceil(s / 2) - 2 * s) // s + 1
        d *= 2
    dec, d, n = [], c["decoder_dim"], frames
    for s in c["decoder_rates"]:
        n = (n - 1) * s - 2 * math.ceil(s / 2) + 2 * s
        d //= 2
        dec += [(d, n)] * 3
    return enc, dec


def unit_flops(ch: int, n: int) -> float:
    return 2 * 8 * ch * ch * n          # the k7 conv and the 1x1 conv


def unit_bytes(ch: int, n: int, rows: int) -> float:
    """One launch over `rows` rows: bf16 activations in and out, the k7 and
    1x1 weights (bf16), fp32 biases and Snake alphas."""
    return rows * 2 * ch * n * 2 + 8 * ch * ch * 2 + 4 * ch * 4


def codec_encode_flops(cfg: dict, samples: int) -> float:
    c = cfg["audio_codec"]
    enc, _ = residual_units(cfg, samples, 1)
    total = 2 * 7 * c["encoder_dim"] * samples              # conv_in
    d, n = c["encoder_dim"], samples
    for s in c["encoder_rates"]:
        n = (n + 2 * math.ceil(s / 2) - 2 * s) // s + 1
        total += 2 * d * 2 * d * 2 * s * n                  # stride conv
        d *= 2
    total += 2 * 3 * d * c["latent_dim"] * n + 2 * c["latent_dim"] * 2 * c["codebook_dim"] * n
    return total + sum(unit_flops(ch, t) for ch, t in enc)


def codec_decode_flops(cfg: dict, frames: int) -> float:
    c = cfg["audio_codec"]
    _, dec = residual_units(cfg, 1, frames)
    d, n = c["decoder_dim"], frames
    total = 2 * c["codebook_dim"] * c["latent_dim"] * n + 2 * 7 * c["latent_dim"] * d * n
    for s in c["decoder_rates"]:
        total += 2 * d * (d // 2) * 2 * s * n               # transposed conv
        n = (n - 1) * s - 2 * math.ceil(s / 2) + 2 * s
        d //= 2
    total += 2 * 7 * d * n                                  # conv_out
    return total + sum(unit_flops(ch, t) for ch, t in dec)


def pe_frame_flops(cfg: dict) -> float:
    ve = cfg["vision_encoder"]
    w = ve["width"]
    p = ve["patch_size"]
    grid = ve["image_size"] // p
    tok = grid * grid + (1 if ve["use_cls_token"] else 0)
    mlp = int(w * ve["mlp_ratio"])
    layer = tok * 2 * (4 * w * w + 2 * w * mlp) + 4 * tok * tok * w
    pool = 2 * (w * w * (2 * tok + 2) + 2 * tok * w) + 2 * w * ve["dim"]
    return 2 * 3 * p * p * w * grid * grid + ve["vit_layers"] * layer + pool


def group_flops(cfg: dict, g: GroupShape) -> float:
    """The model operations of one group: codec encode, T5, [the vision
    tower], the ODE's DiT evaluations, two codec decodes."""
    per_row = (codec_encode_flops(cfg, g.samples) + t5_flops(cfg, g.text)
               + g.evals * dit_eval_flops(cfg, g.frames, g.text)
               + 2 * codec_decode_flops(cfg, g.frames)
               + g.video_frames * pe_frame_flops(cfg))
    return g.rows * per_row


def self_attention_work(cfg: dict, g: GroupShape) -> Tuple[float, float]:
    """(operations, bytes) of the DiT's self-attention over one group: every
    layer of every evaluation, norm, RoPE and attention at (B, T, H, D),
    bf16 operands, fp32 norm weights and RoPE tables, a byte of mask a key."""
    tf = cfg["transformer"]
    h, d, t, b = tf["n_heads"], tf["dim"] // tf["n_heads"], g.frames, g.rows
    launches = g.evals * tf["n_layers"]
    flops = 4 * b * t * t * d * h
    nbytes = b * 4 * t * h * d * 2 + 2 * d * 4 + t * d * 4 + b * t
    return launches * flops, launches * nbytes


def residual_unit_bound_s(cfg: dict, g: GroupShape) -> float:
    """The least time of every codec residual unit of one group, launch by
    launch: one encode and two decodes, each unit over the group's rows."""
    enc, dec = residual_units(cfg, g.samples, g.frames)
    return sum(times * bound_s(g.rows * unit_flops(ch, n), unit_bytes(ch, n, g.rows))
               for units, times in ((enc, 1), (dec, 2)) for ch, n in units)
