"""Plain float32 reference of SAM-Audio's reranked separation with the CLAP
ranker, for the benchmark's check of the k-candidate path.

Written from the published descriptions in plain PyTorch, float32, TF32
off, one candidate at a time: the reference sam_audio package's k-candidate
separate (model.py: k noises an item, every candidate's target decoded for
the ranker, the residual of the chosen one) and its CLAP ranker
(ranking/clap.py, laion_clap's `630k-best` HTSAT-tiny + roberta-base):

  audio: repeat-pad to 10 s, the int16 round trip, torchlibrosa's log-mel
  (periodic Hann STFT, reflect centre pad, power 2, librosa's Slaney mel
  filterbank, 10 log10 with amin 1e-10), bn0 over the mel bins, HTSAT's
  wav-to-image fold (bicubic time resize with aligned corners to
  spec_size x freq_ratio frames, folded into a spec_size square), a swin
  transformer (4x4 patch embedding and LayerNorm; windows of 8 with
  relative position bias, every second block shifted by 4 with its mask;
  patch merging), LayerNorm, the mean over tokens, the 2-layer projection,
  L2 normalisation;
  text: RoBERTa (word + position + type embeddings, position ids past the
  padding id 1, post-LayerNorm layers with exact GELU), the tanh pooler on
  the first token, the 2-layer projection, L2 normalisation;
  score: audio . text.

Tokens are the byte fallback the benchmark gives the program (utf-8 bytes
to 3 + byte, eos 1, at most `max_text_len`). It reads the weight trees the
benchmark drew and imports nothing of the program under test. The mel
filterbank is the one buffer the benchmark hands both sides (weights.py
takes it from here); the window, the relative position index, the shift
masks and the resize are worked out here.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import sam_audio as sa
from portbench.reference.sam_audio import layernorm, q_
# the rest of a configuration's reference module, as the check calls it
from portbench.reference.sam_audio import separate_row, set_precision, video_features  # noqa: F401


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """(n_fft // 2 + 1, n_mels) librosa.filters.mel with its defaults
    (Slaney's mel scale, Slaney's area normalisation), in float64."""
    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        lin = f / (200.0 / 3)
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                        / (np.log(6.4) / 27.0), lin)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)),
                        m * (200.0 / 3))

    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    edges = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    widths = np.diff(edges)
    ramps = edges[:, None] - freqs[None, :]
    lower = -ramps[:-2] / widths[:-1, None]
    upper = ramps[2:] / widths[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper))
    w *= (2.0 / (edges[2: n_mels + 2] - edges[:n_mels]))[:, None]
    return w.T


# -- audio tower -----------------------------------------------------------------

def fit_to_window(wav, n):
    """Repeat-pad to n samples. A clip whose repeats overrun n is cropped
    at a random start by laion_clap; no cell has one, so it is refused."""
    t = wav.shape[0]
    reps = -(-n // t)
    if t * reps != n:
        raise ValueError(f"a clip of {t} samples does not tile the {n}-sample window")
    return wav.repeat(reps)


def logmel(c, melw, wav):
    """wav (n,) -> (frames, n_mels) log-mel."""
    window = torch.hann_window(c["n_fft"], periodic=True, dtype=torch.float32,
                               device=wav.device)
    spec = torch.stft(wav, c["n_fft"], c["hop_length"], window=window, center=True,
                      pad_mode="reflect", return_complex=True).abs() ** 2
    mel = q_(spec.t()) @ q_(melw)
    return 10.0 * torch.log10(torch.clamp(mel, min=1e-10))


def wav_to_image(c, x):
    """(frames, n_mels) -> (1, 1, spec, spec): HTSAT's reshape_wav2img."""
    ratio = c["spec_size"] // c["n_mels"]
    target_t = c["spec_size"] * ratio
    x = x[None, None]
    if x.shape[2] < target_t:
        x = F.interpolate(x, (target_t, x.shape[3]), mode="bicubic", align_corners=True)
    if x.shape[3] < c["spec_size"] // ratio:
        x = F.interpolate(x, (x.shape[2], c["spec_size"] // ratio), mode="bicubic",
                          align_corners=True)
    x = x.permute(0, 1, 3, 2)
    b, ch, f, t = x.shape
    x = x.reshape(b, ch, f, ratio, t // ratio).permute(0, 1, 3, 2, 4)
    return x.reshape(b, ch, ratio * f, t // ratio)


def relative_position_index(ws):
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij"))
    flat = coords.flatten(1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0)
    return (rel[..., 0] + ws - 1) * (2 * ws - 1) + rel[..., 1] + ws - 1


def windows(x, ws):
    """(H, W, C) -> (nW, ws * ws, C)."""
    h, w, c = x.shape
    return x.view(h // ws, ws, w // ws, ws, c).permute(0, 2, 1, 3, 4).reshape(-1, ws * ws, c)


def unwindows(x, ws, h, w):
    c = x.shape[-1]
    return x.view(h // ws, w // ws, ws, ws, c).permute(0, 2, 1, 3, 4).reshape(h, w, c)


def shift_mask(res, ws, shift, device):
    """(nW, ws^2, ws^2): -100 between tokens of different regions of the
    rolled image."""
    img = torch.zeros(res, res, 1, device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = windows(img, ws)[..., 0]
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def swin_block(b, x, res, heads, ws, shift, eps):
    """x (res * res, C)."""
    n, c = x.shape
    hd = c // heads
    y = layernorm(b["norm1"], x, eps).view(res, res, c)
    if shift:
        y = torch.roll(y, (-shift, -shift), (0, 1))
    win = windows(y, ws)
    nw, t, _ = win.shape
    qkv = sa.linear(b["qkv"], win).view(nw, t, 3, heads, hd)
    qh, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    logits = torch.einsum("wqhd,wkhd->whqk", q_(qh * hd ** -0.5), q_(k))
    idx = relative_position_index(ws).to(x.device)
    bias = b["relative_position_bias_table"][idx.reshape(-1)].view(t, t, heads)
    logits = logits + bias.permute(2, 0, 1)[None]
    if shift:
        logits = logits + shift_mask(res, ws, shift, x.device)[:, None]
    o = torch.einsum("whqk,wkhd->wqhd", q_(torch.softmax(logits, -1)), q_(v))
    o = sa.linear(b["proj"], o.reshape(nw, t, c))
    o = unwindows(o, ws, res, res)
    if shift:
        o = torch.roll(o, (shift, shift), (0, 1))
    x = x + o.reshape(n, c)
    y = layernorm(b["norm2"], x, eps)
    return x + sa.linear(b["fc2"], F.gelu(sa.linear(b["fc1"], y)))


def patch_merge(d, x, res, eps):
    c = x.shape[-1]
    y = x.view(res, res, c)
    y = torch.cat([y[0::2, 0::2], y[1::2, 0::2], y[0::2, 1::2], y[1::2, 1::2]], -1)
    return sa.linear(d["reduction"], layernorm(d["norm"], y.reshape(-1, 4 * c), eps))


def htsat(p, c, wav, eps=1e-5):
    """One window of audio (n,) -> the pooled embedding (out_dim,)."""
    x = logmel(c, p["melW"], wav)
    bn = p["bn0"]
    x = (x - bn["mean"]) / torch.sqrt(bn["var"] + eps) * bn["weight"] + bn["bias"]
    img = wav_to_image(c, x)
    pe = p["patch_embed"]
    x = F.conv2d(q_(img), q_(pe["proj"]["weight"]), pe["proj"]["bias"],
                 stride=c["patch_size"])[0]
    res = x.shape[-1]
    x = layernorm(pe["norm"], x.flatten(1).t(), eps)
    for i, depth in enumerate(c["depths"]):
        stage = p["stages"][i]
        ws = min(c["window_size"], res)
        for j in range(depth):
            shift = ws // 2 if j % 2 and res > ws else 0
            x = swin_block(stage["blocks"][j], x, res, c["audio_heads"][i], ws, shift, eps)
        if "downsample" in stage:
            x = patch_merge(stage["downsample"], x, res, eps)
            res //= 2
    return layernorm(p["norm"], x, eps).mean(0)


def projection(p, x):
    return sa.linear(p["fc2"], F.relu(sa.linear(p["fc1"], x)))


def unit(x):
    return x / x.norm().clamp(min=1e-8)


def audio_embedding(clap, c, wav):
    """One candidate's waveform at the CLAP rate -> unit (embed_dim,)."""
    wav = fit_to_window(wav.float(), int(round(c["sample_rate"] * c["duration_s"])))
    wav = torch.trunc(wav.clamp(-1.0, 1.0) * 32767.0) / 32767.0   # the int16 round trip
    return unit(projection(clap["audio_projection"], htsat(clap["audio_branch"], c, wav)))


# -- text tower ------------------------------------------------------------------

def roberta_pooled(p, c, ids, eps=1e-5, pad_id=1):
    """ids (L,) of one prompt, unpadded -> the pooler output (hidden,)."""
    h, heads = c["text_hidden"], c["text_heads"]
    real = (ids != pad_id).long()
    pos = torch.cumsum(real, 0) * real + pad_id
    x = (p["word_embeddings"]["weight"][ids] + p["position_embeddings"]["weight"][pos]
         + p["token_type_embeddings"]["weight"][0])
    x = layernorm(p["emb_ln"], x, eps)
    t = ids.shape[0]
    for i in range(sa.n_layers(p["layers"])):
        b = sa.layer(p["layers"], i)
        a = b["attn"]
        qh, k, v = (sa.linear(a[n], x).view(t, heads, h // heads) for n in ("wq", "wk", "wv"))
        o = sa.attention(qh, k, v, 1.0 / math.sqrt(h // heads))
        x = layernorm(b["attn_ln"], x + sa.linear(a["wo"], o.reshape(t, h)), eps)
        x = layernorm(b["ffn_ln"], x + sa.linear(b["fc2"], F.gelu(sa.linear(b["fc1"], x))), eps)
    return torch.tanh(sa.linear(p["pooler"], x[0]))


def text_embedding(clap, c, description):
    ids = torch.tensor(sa.byte_tokens(description, c["max_text_len"], c["text_vocab"]),
                       device=clap["logit_scale_t"].device)
    return unit(projection(clap["text_projection"], roberta_pooled(clap["text_branch"], c, ids)))


def score(clap, cfg, audio, description, mixture):
    """One waveform's score against its prompt: audio . text. CLAP does
    not read the mixture."""
    c = cfg["clap"]
    return audio_embedding(clap, c, audio) @ text_embedding(clap, c, description)


# -- k candidates of one item ------------------------------------------------------

def separate_candidates(p, cfg, clap, wav, description, noise, pad_to, text_pad_to=64,
                        video=None, choose: Optional[Callable] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, int, torch.Tensor]:
    """The k candidates of one item from its k noises (k, pad_to / hop, 2 *
    codebook_dim), one at a time: each solved, its target decoded and scored
    by CLAP against the prompt. `choose(targets, scores)` names the
    candidate whose residual is decoded (default: the best score). Returns
    (targets (k, frames * hop), scores (k,), the chosen index, its
    residual)."""
    c = cfg["clap"]
    if cfg["audio_codec"]["sample_rate"] != c["sample_rate"]:
        raise ValueError("the ranker's rate differs from the codec's: no cell resamples")
    velocity, frames = sa.conditioned(p, cfg, wav, description, pad_to, text_pad_to, video)
    text = text_embedding(clap, c, description)
    targets, scores, latents = [], [], []
    for y0 in noise:
        y = sa.solve(velocity, y0)
        latents.append(y)
        targets.append(sa.decode(p, cfg, y, frames, 0))
        scores.append(audio_embedding(clap, c, targets[-1]) @ text)
    targets, scores = torch.stack(targets), torch.stack(scores)
    i = int(torch.argmax(scores)) if choose is None else int(choose(targets, scores))
    return targets, scores, i, sa.decode(p, cfg, latents[i], frames, 1)
