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
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Tuple

from portbench.harness import rankers

# NVIDIA H100 SXM, dense, at the full 700 W power limit (NVIDIA's data sheet)
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
HBM_BPS = 3.35e12


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    """The least time for `flops` operations moving `nbytes`."""
    return max(flops / peak, nbytes / HBM_BPS)


# rows a launch of the program's chunked decode of the candidates
# (sam_audio.decode_channel_chunked's max_streams)
DECODE_STREAMS = 16


@dataclass
class GroupShape:
    """One dispatched group: `rows` batch rows (items) of `samples` padded
    samples (`frames` latent frames), `text` padded prompt tokens,
    `video_frames` frames a row through the vision tower (0 without video),
    `evals` DiT evaluations, `candidates` ODE solutions an item (k), and
    `rank_text` the ranker's text tokens a prompt (0 where it reads none, or
    where no ranker scores the candidates: `ranker`)."""
    rows: int
    samples: int
    frames: int
    text: int
    video_frames: int = 0
    evals: int = 32
    candidates: int = 1
    rank_text: int = 0


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


def ranker(cfg: dict, g: GroupShape):
    """The kind (portbench/harness/rankers/<kind>.py) of the ranker that
    scores the group's candidates; None where the configuration has none or
    an item has one candidate."""
    return rankers.for_config(cfg) if g.candidates > 1 else None


def target_rows(cfg: dict, g: GroupShape) -> int:
    """Target decodes: every candidate where a ranker scores them, else the
    one kept (candidate 0 of each item)."""
    return g.rows * (g.candidates if ranker(cfg, g) else 1)


def rank_flops(cfg: dict, g: GroupShape) -> float:
    """The ranker's operations on one group, as its kind counts them (its
    `flops`); 0 where no ranker scores it."""
    kind = ranker(cfg, g)
    return 0 if kind is None else kind.flops(cfg, g)


def group_flops(cfg: dict, g: GroupShape) -> float:
    """The model operations of one group: codec encode, T5, [the vision
    tower] an item; the ODE's DiT evaluations of every candidate; the
    target decodes (`target_rows`) and a residual decode an item; [the
    ranker]."""
    per_row = (codec_encode_flops(cfg, g.samples) + t5_flops(cfg, g.text)
               + g.candidates * g.evals * dit_eval_flops(cfg, g.frames, g.text)
               + (target_rows(cfg, g) // g.rows + 1) * codec_decode_flops(cfg, g.frames)
               + g.video_frames * pe_frame_flops(cfg))
    return g.rows * per_row + rank_flops(cfg, g)


def self_attention_work(cfg: dict, g: GroupShape) -> Tuple[float, float]:
    """(operations, bytes) of the DiT's self-attention over one group: every
    layer of every evaluation, norm, RoPE and attention at (B, T, H, D),
    bf16 operands, fp32 norm weights and RoPE tables, a byte of mask a key."""
    tf = cfg["transformer"]
    h, d, t, b = tf["n_heads"], tf["dim"] // tf["n_heads"], g.frames, g.rows * g.candidates
    launches = g.evals * tf["n_layers"]
    flops = 4 * b * t * t * d * h
    nbytes = b * 4 * t * h * d * 2 + 2 * d * 4 + t * d * 4 + b * t
    return launches * flops, launches * nbytes


def decode_launches(cfg: dict, g: GroupShape) -> Dict[int, int]:
    """Rows a launch -> launches of each decoder unit: the target decode
    (every candidate in chunks of DECODE_STREAMS rows where a ranker scores
    them, else one launch over the items) and the residual decode of the
    kept candidates."""
    counts: Dict[int, int] = Counter()
    targets = target_rows(cfg, g)
    if ranker(cfg, g) and targets > DECODE_STREAMS:
        for i in range(0, targets, DECODE_STREAMS):
            counts[min(DECODE_STREAMS, targets - i)] += 1
    else:
        counts[targets] += 1
    counts[g.rows] += 1
    return dict(counts)


def encode_launches(cfg: dict, g: GroupShape) -> Dict[int, int]:
    """Rows a launch -> launches of each encoder unit: the separation's
    encode over the group's rows, and the encodes its ranker runs over the
    group's samples (`encoder_launches` of its kind)."""
    counts: Dict[int, int] = Counter({g.rows: 1})
    kind = ranker(cfg, g)
    if kind is not None:
        counts.update(kind.encoder_launches(cfg, g))
    return dict(counts)


def residual_unit_bound_s(cfg: dict, g: GroupShape) -> float:
    """The least time of every codec residual unit of one group, launch by
    launch: the encodes as `encode_launches` has them, the decodes as
    `decode_launches` has them."""
    enc, dec = residual_units(cfg, g.samples, g.frames)
    return sum(times * bound_s(rows * unit_flops(ch, n), unit_bytes(ch, n, rows))
               for units, launches in ((enc, encode_launches(cfg, g)),
                                       (dec, decode_launches(cfg, g)))
               for rows, times in launches.items() for ch, n in units)
