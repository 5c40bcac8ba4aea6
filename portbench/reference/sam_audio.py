"""Plain float32 reference of SAM-Audio's separation, for the benchmark's
check of what the timed path produced.

Written from the model's published description (the reference sam_audio
package: model.py, transformer.py, patcher.py, codec.py, text_encoder.py,
vision_encoder.py, align.py, processor.py) in plain PyTorch: no kernel, no
cache, no batching beyond one row, float32 throughout, TF32 off. It reads
the weight tree the benchmark drew and the inputs the benchmark made, and
imports nothing of the program under test.

Path of one row (`separate_row`: `conditioned`, `solve`, `decode`):
  mixture (1, T) -> reflect pad to a hop multiple -> DAC-VAE encoder ->
  in_proj, mean half -> latents (T', 128)
  prompt -> byte tokens (+ eos), padded to a multiple of 64 -> T5 encoder
  [masked video -> resize (cubic, antialiased) -> PE-Core tower -> one
   feature a latent frame]
  noise (T', 256) -> 16 midpoint steps of the DiT velocity -> target and
  residual halves -> DAC-VAE decoder each -> trimmed to frames * hop
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

NEG = torch.finfo(torch.float32).min

# The precision of every product's operands: float32, or, for the check's
# control (the reference in the program's place one step below bf16), fp8
# e4m3 with one scale a tensor; sums, norms and elementwise work stay fp32.
_FP8 = False


def set_precision(name: str):
    global _FP8
    if name not in ("fp32", "fp8"):
        raise ValueError(name)
    _FP8 = name == "fp8"


def q_(x):
    """An operand of a product, in the reference's precision."""
    if not _FP8:
        return x
    s = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


# -- shared pieces -------------------------------------------------------------

def linear(p, x):
    y = q_(x) @ q_(p["weight"]).t()
    return y + p["bias"] if "bias" in p else y


def rmsnorm(w, x, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def layernorm(p, x, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], p["weight"], p["bias"], eps)


def attention(qx, k, v, scale, key_mask=None, bias=None):
    """qx (Tq, H, D), k / v (Tk, H, D); key_mask (Tk,) True = attend."""
    logits = torch.einsum("qhd,khd->hqk", q_(qx), q_(k)) * scale
    if bias is not None:
        logits = logits + bias
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[None, None, :], NEG)
    return torch.einsum("hqk,khd->qhd", q_(torch.softmax(logits, -1)), q_(v))


def layer(tree, i):
    """Layer i of a tree whose leaves are stacked on axis 0."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def n_layers(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


# -- text ----------------------------------------------------------------------

def byte_tokens(text: str, max_length: Optional[int] = 512, vocab_size: int = 32128):
    """The byte-level fallback vocabulary: utf-8 bytes to 3 + byte, eos 1."""
    ids = [3 + (b % min(vocab_size - 3, 256)) for b in text.encode("utf-8")]
    if max_length is not None:
        ids = ids[: max_length - 1]
    return ids + [1]


def padded_text(text: str, pad_multiple: int, vocab_size: int):
    """(ids (L,), mask (L,)) for one prompt padded to a multiple of
    `pad_multiple` (pad id 0, masked)."""
    ids = byte_tokens(text, vocab_size=vocab_size)
    n = len(ids)
    width = -(-n // pad_multiple) * pad_multiple
    out = torch.zeros(width, dtype=torch.long)
    out[:n] = torch.tensor(ids)
    return out, torch.arange(width) < n


def t5_bucket(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    half = num_buckets // 2
    ret = (rel > 0).long() * half
    n = rel.abs()
    max_exact = half // 2
    large = max_exact + (torch.log(n.float() / max_exact + 1e-20)
                         / math.log(max_distance / max_exact)
                         * (half - max_exact)).long()
    large = large.clamp(max=half - 1)
    return ret + torch.where(n < max_exact, n, large)


def t5_encode(p, ids, mask, c):
    """One prompt: ids / mask (L,) -> last hidden state (L, dim)."""
    h = p["token_embedding"]["weight"][ids]
    L = ids.shape[0]
    pos = torch.arange(L, device=ids.device)
    buckets = t5_bucket(pos[None, :] - pos[:, None], c["relative_attention_num_buckets"],
                        c["relative_attention_max_distance"])
    bias = p["relative_attention_bias"]["weight"][buckets].permute(2, 0, 1)
    nh, hd = c["num_heads"], c["head_dim"]
    blocks = p["blocks"]
    for i in range(n_layers(blocks)):
        b = layer(blocks, i)
        x = rmsnorm(b["attn"]["layer_norm"]["weight"], h, c["layer_norm_eps"])
        qh, k, v = (linear(b["attn"][n], x).view(L, nh, hd) for n in ("q", "k", "v"))
        a = attention(qh, k, v, 1.0, key_mask=mask, bias=bias)   # T5: no 1/sqrt(d)
        h = h + linear(b["attn"]["o"], a.reshape(L, nh * hd))
        x = rmsnorm(b["ff"]["layer_norm"]["weight"], h, c["layer_norm_eps"])
        h = h + linear(b["ff"]["wo"], F.relu(linear(b["ff"]["wi"], x)))
    return rmsnorm(p["final_layer_norm"]["weight"], h, c["layer_norm_eps"])


# -- codec ---------------------------------------------------------------------

def snake(alpha, x):
    a = alpha.reshape(-1, 1)
    return x + torch.sin(a * x) ** 2 / (a + 1e-9)


def conv(p, x, stride=1, padding=0, dilation=1):
    return F.conv1d(q_(x), q_(p["weight"]), p.get("bias"), stride, padding, dilation)


def residual_unit(p, x, dilation):
    h = conv(p["conv1"], snake(p["snake1"]["alpha"], x), padding=3 * dilation,
             dilation=dilation)
    return x + conv(p["conv2"], snake(p["snake2"]["alpha"], h))


def codec_encode(p, wav, c):
    """wav (T,) -> mean latents (T', codebook_dim)."""
    hop = math.prod(c["encoder_rates"])
    x = wav[None, None]
    if x.shape[-1] % hop:
        x = F.pad(x, (0, hop - x.shape[-1] % hop), mode="reflect")
    e = p["encoder"]
    h = conv(e["conv_in"], x[0], padding=3)
    for blk, s in zip(e["blocks"], c["encoder_rates"]):
        for ru, dil in zip(blk["res"], (1, 3, 9)):
            h = residual_unit(ru, h, dil)
        h = conv(blk["conv"], snake(blk["snake"]["alpha"], h), stride=s,
                 padding=math.ceil(s / 2))
    h = conv(e["conv_out"], snake(e["snake_out"]["alpha"], h), padding=1)
    moments = conv(p["in_proj"], h)
    return moments[: c["codebook_dim"]].t()


def codec_decode(p, z, c):
    """z (T', codebook_dim) -> waveform (T' * hop,)."""
    d = p["decoder"]
    h = conv(d["conv_in"], conv(p["out_proj"], z.t()), padding=3)
    for blk, s in zip(d["blocks"], c["decoder_rates"]):
        h = F.conv_transpose1d(q_(snake(blk["snake"]["alpha"], h)), q_(blk["conv_t"]["weight"]),
                               blk["conv_t"]["bias"], s, math.ceil(s / 2))
        for ru, dil in zip(blk["res"], (1, 3, 9)):
            h = residual_unit(ru, h, dil)
    h = conv(d["conv_out"], snake(d["snake_out"]["alpha"], h), padding=3)
    return torch.tanh(h)[0]


# -- DiT -----------------------------------------------------------------------

def sinusoid(pos, dim, theta=10000.0):
    half = dim // 2
    freq = torch.exp(-math.log(theta) * torch.arange(half, dtype=torch.float32,
                                                     device=pos.device) / half)
    arg = pos.float()[..., None] * freq
    return torch.cat([torch.cos(arg), torch.sin(arg)], -1)


def swiglu_mlp(p, x):
    return linear(p["w2"], F.silu(linear(p["w1"], x)) * linear(p["w3"], x))


def mlp(p, x, kind):
    if kind == "swiglu":
        return swiglu_mlp(p, x)
    act = {"silu": F.silu, "relu": F.relu, "gelu": lambda v: F.gelu(v, approximate="tanh")}
    return linear(p["w2"], act[kind](linear(p["w1"], x)))


def rope_tables(head_dim, n, theta, device):
    freqs = 1.0 / (theta ** (np.arange(0, head_dim, 2)[: head_dim // 2] / head_dim))
    ang = np.outer(np.arange(n, dtype=np.float64), freqs)
    return (torch.tensor(np.cos(ang), dtype=torch.float32, device=device),
            torch.tensor(np.sin(ang), dtype=torch.float32, device=device))


def rotate_half_pairs(x, cos, sin):
    """Rotary pairs stored as channels (i, i + D/2), as the checkpoint
    layout keeps the q/k projections. x (T, H, D)."""
    d = x.shape[-1] // 2
    c, s = cos[:, None, :], sin[:, None, :]
    x1, x2 = x[..., :d], x[..., d:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], -1)


def dit_attention(p, x, src, heads, eps, key_mask, rope=None):
    t, dim = x.shape
    hd = dim // heads
    qh = linear(p["wq"], x).view(t, heads, hd)
    k = linear(p["wk"], src).view(src.shape[0], heads, hd)
    v = linear(p["wv"], src).view(src.shape[0], heads, hd)
    if "q_norm" in p:
        qh = rmsnorm(p["q_norm"]["weight"], qh, eps)
        k = rmsnorm(p["k_norm"]["weight"], k, eps)
    if rope is not None:
        qh, k = rotate_half_pairs(qh, *rope), rotate_half_pairs(k, *rope)
    o = attention(qh, k, v, 1.0 / math.sqrt(hd), key_mask=key_mask)
    return linear(p["wo"], o.reshape(t, dim))


def groupnorm1(p, x, eps=1e-5):
    """GroupNorm with one group over (C, T)."""
    m = x.mean()
    v = ((x - m) ** 2).mean()
    return (x - m) * torch.rsqrt(v + eps) * p["weight"][:, None] + p["bias"][:, None]


def patcher(p, x):
    """The stem's two conv blocks and residual. x (C, T)."""
    h = x
    for name in ("block1", "block2"):
        blk = p[name]
        h = F.conv1d(q_(F.pad(F.silu(groupnorm1(blk["groupnorm"], h)), (1, 1))),
                     q_(blk["project"]["weight"]), blk["project"]["bias"])
    return h + x


def dit(p, tf, x, time, memory, memory_mask, pad_mask):
    """x (T, dim) aligned inputs, time () float, memory (L, dim) -> (T, out)."""
    dim, heads, eps = tf["dim"], tf["n_heads"], tf["norm_eps"]
    if "data_proj" in p:
        x = linear(p["data_proj"], x)
    h = patcher(p["x_embedder"], x.t()).t()
    t_emb = sinusoid(time[None], tf["frequency_embedding_dim"])
    t = mlp(p["t_embedder"]["projection"], t_emb, tf["timestep_non_linearity"])[0]
    t0 = linear(p["t_block"], F.silu(t)).view(6, dim)
    y = memory
    if "norm" in p["y_embedder"]:
        y = rmsnorm(p["y_embedder"]["norm"]["weight"], y, eps)
    y = mlp(p["y_embedder"]["projection"], y, tf["context_non_linearity"])
    rope = rope_tables(dim // heads, h.shape[0], max(10000, 2 * tf["max_positions"]),
                       h.device) if tf["use_rope"] else None
    layers = p["layers"]
    for i in range(n_layers(layers)):
        b = layer(layers, i)
        mod = b["scale_shift_table"] + t0
        sh_a, sc_a, g_a, sh_f, sc_f, g_f = mod
        a_in = rmsnorm(b["attention_norm"]["weight"], h, eps) * (1 + sc_a) + sh_a
        h = h + dit_attention(b["attention"], a_in, a_in, heads, eps, pad_mask, rope) * g_a
        h = h + dit_attention(b["cross_attention"], h, y, heads, eps, memory_mask)
        f_in = rmsnorm(b["ffn_norm"]["weight"], h, eps) * (1 + sc_f) + sh_f
        h = h + mlp(b["feed_forward"], f_in, tf["non_linearity"]) * g_f
    shift, scale = p["final_layer_scale_shift_table"] + t
    h = rmsnorm(p["norm"]["weight"], h, eps) * (1 + scale) + shift
    return linear(p["output"], h)


# -- vision tower ----------------------------------------------------------------

def keys_cubic(x):
    x = np.abs(x)
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return np.where(x >= 2.0, 0.0, np.where(x >= 1.0, far, near))


def cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of an antialiased cubic resize (Keys, a = -0.5,
    half-pixel centres; the kernel widened by the scale when shrinking;
    weights normalised per output sample)."""
    scale = n_in / n_out
    width = max(scale, 1.0)
    centre = (np.arange(n_out) + 0.5) * scale - 0.5
    w = keys_cubic((centre[None, :] - np.arange(n_in)[:, None]) / width)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (centre >= -0.5) & (centre <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def rope2d_tables(head_dim, grid, theta, prefix, device):
    half = head_dim // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, 2) / half))
    ang = np.outer(np.arange(grid, dtype=np.float64), freqs)
    ax = np.broadcast_to(ang[None, :, :], (grid, grid, ang.shape[1]))
    ay = np.broadcast_to(ang[:, None, :], (grid, grid, ang.shape[1]))
    angles = np.concatenate([ax, ay], -1).reshape(grid * grid, -1)
    angles = np.concatenate([np.zeros((prefix, angles.shape[1])), angles])
    return (torch.tensor(np.cos(angles), dtype=torch.float32, device=device),
            torch.tensor(np.sin(angles), dtype=torch.float32, device=device))


def rotate_adjacent_pairs(x, cos, sin):
    """Rotary pairs (2i, 2i + 1). x (N, T, H, D)."""
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], -1).flatten(-2)


def pe_encode(p, ve, frames):
    """frames (N, 3, H, W) uint8 -> (N, dim) unit-norm features."""
    s = ve["image_size"]
    x = frames.float()
    h, w = x.shape[-2:]
    dev = x.device
    x = torch.einsum("nchw,hy->ncyw", x, torch.tensor(cubic_resize_matrix(h, s),
                                                      dtype=torch.float32, device=dev))
    x = torch.einsum("nchw,wx->nchx", x, torch.tensor(cubic_resize_matrix(w, s),
                                                      dtype=torch.float32, device=dev))
    x = (x / 255.0 - 0.5) / 0.5
    n, width, heads = x.shape[0], ve["width"], ve["vit_heads"]
    hd = width // heads
    tok = F.conv2d(q_(x), q_(p["patch_embed"]["weight"]), p["patch_embed"].get("bias"),
                   stride=ve["patch_size"]).flatten(2).transpose(1, 2)
    if ve["use_cls_token"]:
        tok = torch.cat([p["cls_token"].view(1, 1, width).expand(n, 1, width), tok], 1)
    h = tok + p["pos_embed"][None]
    if "ln_pre" in p:
        h = layernorm(p["ln_pre"], h)
    rope = (rope2d_tables(hd, s // ve["patch_size"], ve["rope2d_theta"],
                          1 if ve["use_cls_token"] else 0, dev)
            if ve["use_rope2d"] else None)
    t = h.shape[1]
    layers = p["layers"]
    for i in range(n_layers(layers)):
        b = layer(layers, i)
        y = layernorm(b["ln1"], h)
        qh, k, v = (linear(b["attn"][nm], y).view(n, t, heads, hd) for nm in ("wq", "wk", "wv"))
        if rope is not None:
            qh, k = rotate_adjacent_pairs(qh, *rope), rotate_adjacent_pairs(k, *rope)
        logits = torch.einsum("nqhd,nkhd->nhqk", q_(qh), q_(k)) / math.sqrt(hd)
        o = torch.einsum("nhqk,nkhd->nqhd", q_(torch.softmax(logits, -1)), q_(v))
        h = h + linear(b["attn"]["wo"], o.reshape(n, t, width))
        y = layernorm(b["ln2"], h)
        h = h + linear(b["mlp"]["fc2"], F.gelu(linear(b["mlp"]["fc1"], y), approximate="tanh"))
    h = layernorm(p["ln_post"], h)
    ap = p["attn_pool"]
    qp = linear(ap["wq"], ap["probe"]).view(1, heads, hd)
    k = linear(ap["wk"], h).view(n, t, heads, hd)
    v = linear(ap["wv"], h).view(n, t, heads, hd)
    w_ = torch.softmax(torch.einsum("qhd,nkhd->nhqk", q_(qp), q_(k)) / math.sqrt(hd), -1)
    pooled = torch.einsum("nhqk,nkhd->nqhd", q_(w_), q_(v)).reshape(n, width)
    out = linear(p["proj"], layernorm(ap["ln"], linear(ap["wo"], pooled)))
    if ve.get("normalize_feature", True):
        out = out / out.norm(dim=-1, keepdim=True).clamp(min=1e-8)
    return out


def video_features(p, ve, frames, masks, n_frames, chunk=50):
    """Raw frames and masks (N, 3, H, W) -> masked (pixels kept where the
    mask is 0), one frame a latent frame (round(linspace)), encoded in
    chunks -> (n_frames, dim)."""
    pick = np.round(np.linspace(0, frames.shape[0] - 1, n_frames)).astype(int)
    feats = []
    for i in range(0, n_frames, chunk):
        idx = pick[i: i + chunk]
        f = torch.as_tensor(frames[idx]) * torch.as_tensor(masks[idx] == 0)
        feats.append(pe_encode(p, ve, f.to(p["pos_embed"].device)))
    return torch.cat(feats)


# -- one row of separate ---------------------------------------------------------

def conditioned(p, cfg, wav, description, pad_to, text_pad_to=64, video=None):
    """The velocity field of one item and its true latent frames. wav (T,)
    float32 at the codec's rate, zero-padded to `pad_to` samples (the length
    bucket it was served in); video (frames, vision dim) features of the
    clip's frames, or None. Padded frames are masked as keys of
    self-attention and read the <pad> anchor slot."""
    c, tf = cfg["audio_codec"], cfg["transformer"]
    dev = wav.device
    hop = math.prod(c["encoder_rates"])
    frames = -(-wav.shape[0] // hop)
    lat = codec_encode(p["audio_codec"], F.pad(wav, (0, pad_to - wav.shape[0])), c)
    t_lat = lat.shape[0]
    assert t_lat == -(-pad_to // hop), (t_lat, pad_to)
    feats = torch.cat([lat, lat], -1)
    ids, mask = padded_text(description, text_pad_to, cfg["text_encoder"]["vocab_size"])
    ids, mask = ids.to(dev), mask.to(dev)
    text = t5_encode(p["text_encoder"], ids, mask, cfg["text_encoder"])
    memory_base = linear(p["memory_proj"], text)
    vf = torch.zeros(t_lat, cfg["vision_encoder"]["dim"], device=dev)
    if video is not None:
        n = min(video.shape[0], t_lat)
        vf[:n] = video[:n]
    av = p["align_masked_video"]
    post = layernorm(av["layer_norm"], linear(av["conv"], vf))
    ea = p["embed_anchors"]
    pad_mask = torch.arange(t_lat, device=dev) < frames
    # no anchors: real frames read the <null> slot (id 0), padded frames <pad>
    slot = torch.where(pad_mask, 0, cfg["num_anchors"])
    anchor = linear(ea["proj"], ea["embed"]["weight"][slot])

    def velocity(t, y):
        x = linear(p["proj"], torch.cat([y, torch.zeros_like(feats), feats], -1))
        x = x + torch.tanh(av["gate"]) * post
        x = x + torch.tanh(ea["gate"]) * anchor
        memory = memory_base + sinusoid(t[None], tf["dim"])
        return dit(p["transformer"], tf, x, t, memory, mask, pad_mask)

    return velocity, frames


def solve(velocity, noise):
    """16 midpoint steps of 2/32 from noise (T', 2 * codebook_dim)."""
    dev = noise.device
    y = noise.float()
    step = torch.tensor(2.0 / 32, dtype=torch.float32, device=dev)
    for i in range(16):
        t = torch.tensor(float(i), dtype=torch.float32, device=dev) * step
        k1 = velocity(t, y)
        y = y + step * velocity(t + step / 2, y + step / 2 * k1)
    return y


def decode(p, cfg, y, frames, channel):
    """One channel (0 target, 1 residual) of the solved latents, trimmed to
    frames * hop samples."""
    c = cfg["audio_codec"]
    cd = c["codebook_dim"]
    n = frames * math.prod(c["encoder_rates"])
    return codec_decode(p["audio_codec"], y[:, channel * cd: (channel + 1) * cd], c)[:n]


def separate_row(p, cfg, wav, description, noise, pad_to, text_pad_to=64, video=None):
    """One row of `conditioned`'s item from noise (pad_to / hop, 2 *
    codebook_dim). Returns (target, residual), each trimmed to frames * hop
    samples."""
    velocity, frames = conditioned(p, cfg, wav, description, pad_to, text_pad_to, video)
    assert noise.shape[0] == -(-pad_to // math.prod(cfg["audio_codec"]["encoder_rates"]))
    y = solve(velocity, noise)
    return decode(p, cfg, y, frames, 0), decode(p, cfg, y, frames, 1)
