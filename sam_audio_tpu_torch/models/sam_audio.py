"""SAMAudio: promptable audio source separation via conditional flow matching.

Counterpart of sam_audio_tpu/models/sam_audio.py for the text-prompted path
(reference: sam_audio/model/model.py:75-362):

  * `forward` — one velocity-field evaluation (noisy latents + conditioning
    -> velocity), reference model.py:130-180.
  * `SAMAudio.separate` — codec-encode, T5-encode, condition, integrate the
    ODE (midpoint, 16 steps = 32 DiT evaluations), codec-decode target and
    residual. Reference model.py:247-338. With k candidates and a text
    ranker (CLAP), the k targets are decoded and ranked and only the
    winner's residual is decoded; `preview_nfe` ranks cheap previews first.
  * `SAMAudio.quantize` — the int8 / int4 serving modes (ops/quant.py).

Entry points run on the card unless the caller passes device="cpu"; with no
GPU and no explicit CPU request they raise.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from sam_audio_tpu_torch.config import SAMAudioConfig
from sam_audio_tpu_torch.models import dacvae
from sam_audio_tpu_torch.models.dit import dit_apply
from sam_audio_tpu_torch.models.t5 import t5_encode
from sam_audio_tpu_torch.ops import nn as N
from sam_audio_tpu_torch.ops.ode import odeint

logger = logging.getLogger(__name__)

DFLT_ODE_OPT = {"method": "midpoint", "step_size": 2 / 32}

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sam_audio_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU explicitly")
    return dev


@dataclass
class SeparationResult:
    """reference: sam_audio/model/model.py:68-72 (per-item lists of unpadded
    waveforms)."""

    target: List
    residual: List
    noise: Any


def align_inputs(params, cfg: SAMAudioConfig, noisy_audio, audio_features,
                 masked_video_features=None, anchor_ids=None,
                 anchor_alignment=None, compute_dtype=None):
    x = torch.cat([noisy_audio, torch.zeros_like(audio_features), audio_features],
                  dim=2)
    projected = N.linear(params["proj"], x, compute_dtype)
    aligned = N.align_modalities(params["align_masked_video"], projected,
                                 masked_video_features, compute_dtype)
    return N.embed_anchors(params["embed_anchors"], aligned, anchor_ids,
                           anchor_alignment, compute_dtype)


def forward(params, cfg: SAMAudioConfig, noisy_audio, audio_features,
            text_features, time, masked_video_features=None, text_mask=None,
            anchor_ids=None, anchor_alignment=None, audio_pad_mask=None,
            compute_dtype=None):
    """One ODE function evaluation. noisy_audio/audio_features: (B, T,
    2*latent); text_features: (B, L, text_dim); time: (B,). Returns the
    velocity (B, T, out_channels)."""
    aligned = align_inputs(params, cfg, noisy_audio, audio_features,
                           masked_video_features, anchor_ids, anchor_alignment,
                           compute_dtype)
    # memory = proj(text) + sinusoidal(time) (reference model.py:170-172)
    t_emb = N.sinusoidal_embedding(time, cfg.transformer.dim)[:, None, :]
    if text_features is not None:
        memory = N.linear(params["memory_proj"], text_features, compute_dtype)
        memory = memory + t_emb.to(memory.dtype)
    else:
        memory = t_emb if compute_dtype is None else t_emb.to(compute_dtype)
    return dit_apply(
        params["transformer"], aligned, time, cfg=cfg.transformer,
        padding_mask=audio_pad_mask, memory=memory,
        memory_padding_mask=text_mask, compute_dtype=compute_dtype,
    )


def separate_latents(params, audios, text_ids, text_mask, anchor_ids,
                     anchor_alignment, audio_pad_mask, noise, *,
                     cfg: SAMAudioConfig, candidates: int = 1,
                     ode_method: str = "midpoint", ode_step_size: float = 2 / 32):
    """Encode -> condition -> ODE. audios (B, 1, Tw); noise (B*k, T, 2C).
    Returns the generated latents (B*k, T, 2C) = [target || residual]."""
    compute_dtype = DTYPES[cfg.compute_dtype]
    lat = dacvae.encode(params["audio_codec"], audios, cfg.audio_codec,
                        compute_dtype=compute_dtype)          # (B, C, T)
    lat = lat.transpose(1, 2).float()
    audio_features = torch.cat([lat, lat], dim=2)            # (B, T, 2C)
    text_features = t5_encode(params["text_encoder"], text_ids, text_mask,
                              cfg.text_encoder, compute_dtype=compute_dtype)
    b, t, _ = audio_features.shape
    # zeros when there is no visual prompt (reference model.py:186-191)
    video_features = torch.zeros((b, cfg.vision_encoder.dim, t),
                                 device=audio_features.device)

    def rep(x):  # candidate expansion, item-major (reference model.py:193-206)
        return x if candidates <= 1 else torch.repeat_interleave(x, candidates, 0)

    audio_features, text_features, text_mask, video_features = map(
        rep, (audio_features, text_features, text_mask, video_features))
    anchor_ids, anchor_alignment, audio_pad_mask = map(
        rep, (anchor_ids, anchor_alignment, audio_pad_mask))
    bk = audio_features.shape[0]

    def vector_field(tt, y):
        v = forward(
            params, cfg, noisy_audio=y, audio_features=audio_features,
            text_features=text_features, time=tt.expand(bk),
            masked_video_features=video_features, text_mask=text_mask,
            anchor_ids=anchor_ids, anchor_alignment=anchor_alignment,
            audio_pad_mask=audio_pad_mask, compute_dtype=compute_dtype,
        )
        return v.to(y.dtype)

    return odeint(vector_field, noise.float(), method=ode_method,
                  step_size=ode_step_size)


def decode_channel(params, latents, *, cfg: SAMAudioConfig, channel: int = 0):
    """latents (N, T, 2C) -> waveforms (N, Tw) fp32 for one channel
    (0 = target, 1 = residual)."""
    c = cfg.audio_codec.codebook_dim
    z = latents[..., channel * c: (channel + 1) * c].transpose(1, 2)
    wavs = dacvae.decode(params["audio_codec"], z, cfg.audio_codec,
                         compute_dtype=DTYPES[cfg.compute_dtype])
    return wavs.float()[:, 0, :]


def decode_channel_chunked(params, latents, *, cfg: SAMAudioConfig, channel: int = 0,
                           max_streams: int = 16):
    """decode_channel in groups of at most `max_streams` rows: the codec's
    activations at 48 kHz are ~180 MB per 10 s stream, so a large batch*k
    decodes in pieces. (The JAX package pads the last group to reuse one
    compiled program; eager PyTorch has no program to reuse.)"""
    if latents.shape[0] <= max_streams:
        return decode_channel(params, latents, cfg=cfg, channel=channel)
    return torch.cat([decode_channel(params, latents[i: i + max_streams], cfg=cfg,
                                     channel=channel)
                      for i in range(0, latents.shape[0], max_streams)])


def gather_candidates(latents, idxs, *, candidates: int):
    """latents (B*k, ...), idxs (B,) -> the chosen candidates (B, ...)."""
    b = latents.shape[0] // candidates
    idxs = torch.as_tensor(np.asarray(idxs), dtype=torch.long, device=latents.device)
    return latents[torch.arange(b, device=latents.device) * candidates + idxs]


class SAMAudio:
    """Holds (cfg, params, device) and provides the reference API.

      * `SAMAudio.from_pretrained(path, device="cuda")` — load the
        config.json + params.npz snapshot the JAX package writes.
      * `SAMAudio.init_random(cfg, seed, device="cuda")` — random weights.
    """

    def __init__(self, cfg: SAMAudioConfig, params, device="cuda", tokenizer=None,
                 allow_random_towers: bool = False, text_ranker=None):
        from sam_audio_tpu_torch.checkpoint import cast_matmul_weights

        self.cfg = cfg
        self.device = resolve_device(device)
        compute_dtype = DTYPES[cfg.compute_dtype]
        if compute_dtype != torch.float32:
            params = cast_matmul_weights(params, compute_dtype)
        self.params = params
        self._tokenizer = tokenizer
        self.allow_random_towers = allow_random_towers
        # scores the k candidates of separate(reranking_candidates=k); a
        # ranking.Ranker, e.g. ranking.clap.ClapRanker
        self.text_ranker = text_ranker

    @classmethod
    def init_random(cls, cfg: SAMAudioConfig, seed: int = 0, device="cuda",
                    tokenizer=None):
        from sam_audio_tpu_torch.models.init import sam_audio_init

        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, sam_audio_init(cfg, gen, dev), device=dev,
                   tokenizer=tokenizer, allow_random_towers=True)

    @classmethod
    def from_pretrained(cls, path: str, device="cuda", **kwargs):
        from sam_audio_tpu_torch.checkpoint import load_sam_audio

        return load_sam_audio(path, device=device, **kwargs)

    @property
    def sample_rate(self) -> int:
        return self.cfg.audio_codec.sample_rate

    @property
    def hop_length(self) -> int:
        return self.cfg.audio_codec.hop_length

    @property
    def tokenizer(self):
        if self._tokenizer is None:
            from sam_audio_tpu_torch.text_tokenizer import get_text_tokenizer

            # the byte fallback is gated like random tower weights
            # (reference text_encoder.py:14-15)
            self._tokenizer = get_text_tokenizer(
                self.cfg.text_encoder, allow_fallback=self.allow_random_towers)
        return self._tokenizer

    def _tokenize(self, descriptions: List[str]):
        ids, mask = self.tokenizer(descriptions,
                                   max_length=self.cfg.text_encoder.max_length)
        ids, mask = np.asarray(ids), np.asarray(mask)
        # optional `text_pad_multiple` attribute: round the longest-padded
        # width up (pad columns carry mask=False, so results are unchanged)
        m = int(getattr(self, "text_pad_multiple", 1) or 1)
        if m > 1 and ids.shape[1] % m:
            pad = m - ids.shape[1] % m
            pad_id = int(getattr(self.tokenizer, "pad_id", 0))
            ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=pad_id)
            mask = np.pad(mask, ((0, 0), (0, pad)))
        return (torch.as_tensor(ids, dtype=torch.long, device=self.device),
                torch.as_tensor(mask, dtype=torch.bool, device=self.device))

    def feature_idx_to_wav_idx(self, feature_idx) -> int:
        return dacvae.feature_idx_to_wav_idx(feature_idx, self.hop_length,
                                             self.sample_rate)

    def unbatch(self, wavs, sizes, time_dim: int = -1):
        """Trim padded rows to their true lengths (reference model.py:340-344)."""
        return [np.asarray(row)[..., : int(size)] for row, size in zip(wavs, sizes)]

    def quantize(self, bits: int = 8):
        """Opt-in quantized serving modes (not exact; ops/quant.py), made from
        the weights as stored:

        bits=8 — W8A8: the DiT's hot linears and the input projection run
        int8 x int8 -> int32 (per-channel weight scales, per-token activation
        scales). The JAX package also quantizes an attached PE vision tower
        here; the port has no vision tower yet (the visual slice).
        bits=4 — packed int4 weight storage with group-128 scales; the
        products run through kernel 4 (ops/int4_matmul.py). On the H100 it
        saves weight memory, not time.

        Returns self."""
        from sam_audio_tpu_torch.ops.quant import quantize_sam_audio_params

        self.params = quantize_sam_audio_params(self.params, bits)
        return self

    @torch.inference_mode()
    def separate(self, batch, noise=None, ode_opt: Optional[Dict[str, Any]] = None,
                 reranking_candidates: int = 1,
                 generator: Optional[torch.Generator] = None,
                 predict_spans: bool = False, preview_nfe: Optional[int] = None,
                 visual_stride: int = 1,
                 max_direct_seconds: Optional[float] = None) -> SeparationResult:
        """Separate `batch` (a processor.Batch). `noise` (B or B*k, T, 2C)
        is injected as in reference model.py:247-338; without it the noise
        is drawn from `generator` on the model's device.

        With k = reranking_candidates > 1 and a `text_ranker`, the k targets
        are decoded and scored, and only the winner's residual is decoded.
        `preview_nfe` (opt-in, not reference semantics): the candidates are
        solved and ranked at that cheap budget (8 => 4 midpoint steps), then
        only the winning noise is solved at the full budget."""
        if preview_nfe is not None and (int(preview_nfe) < 2 or int(preview_nfe) % 2):
            raise ValueError(
                "preview_nfe must be an even integer >= 2 (midpoint previews "
                f"take 2 evals per step: preview_nfe=8 => 4 steps); got {preview_nfe}")
        if predict_spans:
            raise NotImplementedError(
                "predict_spans is not ported yet (the spans slice)")
        if visual_stride != 1 or batch.masked_video is not None:
            raise NotImplementedError(
                "visual prompting is not ported yet (the visual slice)")
        cfg = self.cfg
        ode_opt = ode_opt or DFLT_ODE_OPT
        k = int(reranking_candidates)

        t_frames = int(batch.anchor_alignment.shape[-1])
        if max_direct_seconds is None:
            max_direct_seconds = getattr(self, "max_direct_seconds", None)
        limit = int(cfg.transformer.max_positions)
        if max_direct_seconds is not None:
            limit = min(limit, int(max_direct_seconds * self.sample_rate
                                   / self.hop_length))
        if t_frames > limit:
            if noise is None:
                raise NotImplementedError(
                    f"{t_frames} frames exceeds the direct limit ({limit}); "
                    "streaming long audio is not ported yet (the streaming "
                    "slice). Pass noise= to force the direct solve.")
            logger.warning("separate: %d frames exceeds the direct limit (%d) "
                           "but explicit noise= forces the direct path",
                           t_frames, limit)

        dev = self.device
        audios = torch.as_tensor(np.asarray(batch.audios), dtype=torch.float32,
                                 device=dev)
        b = audios.shape[0]
        text_ids, text_mask = self._tokenize(batch.descriptions)
        latent_ch = 2 * cfg.audio_codec.codebook_dim
        if noise is None:
            noise = torch.randn((b * k, t_frames, latent_ch), generator=generator,
                                device=dev, dtype=torch.float32)
        else:
            noise = torch.as_tensor(noise, dtype=torch.float32, device=dev)
            if noise.shape[0] == b and k > 1:
                # same noise for every candidate of an item (item-major)
                noise = torch.repeat_interleave(noise, k, 0)
        method = ode_opt.get("method", "midpoint")
        step = ode_opt.get("step_size",
                           ode_opt.get("options", {}).get("step_size", 2 / 32))
        sizes = [self.feature_idx_to_wav_idx(int(s)) for s in np.asarray(batch.sizes)]

        def as_long(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.long, device=dev)

        core_args = (self.params, audios, text_ids, text_mask, as_long(batch.anchor_ids),
                     as_long(batch.anchor_alignment),
                     torch.as_tensor(np.asarray(batch.audio_pad_mask), dtype=torch.bool,
                                     device=dev))

        def trimmed(wavs):
            wavs = wavs.cpu().numpy()
            return [wavs[i, :sizes[i]] for i in range(b)]

        rerank = k > 1 and self.text_ranker is not None
        if rerank and preview_nfe is not None:
            # rank on cheap previews, then the full solve of the winners only
            preview = separate_latents(*core_args, noise, cfg=cfg, candidates=k,
                                       ode_method=method, ode_step_size=2.0 / preview_nfe)
            idxs = self._choose(batch, decode_channel_chunked(
                self.params, preview, cfg=cfg, channel=0), sizes, k)[0]
            chosen = separate_latents(
                *core_args, gather_candidates(noise, idxs, candidates=k), cfg=cfg,
                candidates=1, ode_method=method, ode_step_size=float(step))
            target = trimmed(decode_channel(self.params, chosen, cfg=cfg, channel=0))
        else:
            latents = separate_latents(*core_args, noise, cfg=cfg, candidates=k,
                                       ode_method=method, ode_step_size=float(step))
            if rerank:
                # all k targets are decoded for the ranker; the residual only
                # for the winner (the JAX package's lazy decode)
                idxs, target = self._choose(batch, decode_channel_chunked(
                    self.params, latents, cfg=cfg, channel=0), sizes, k)
                chosen = gather_candidates(latents, idxs, candidates=k)
            else:  # candidate 0 of every item
                chosen = gather_candidates(latents, [0] * b, candidates=k)
                target = trimmed(decode_channel(self.params, chosen, cfg=cfg, channel=0))
        residual = trimmed(decode_channel(self.params, chosen, cfg=cfg, channel=1))
        return SeparationResult(target=target, residual=residual, noise=noise)

    # -- reranking (reference model.py:306-330) ------------------------------

    def _choose(self, batch, tgt_dev, sizes, k: int):
        """tgt_dev: the (B*k, Tw) decoded targets on the device. Returns the
        winners' indices and their trimmed target waveforms."""
        b = len(sizes)
        idxs = self._rerank_on_device(batch, tgt_dev, sizes, k)
        if idxs is not None:
            # only the b winners leave the device
            sel = gather_candidates(tgt_dev, idxs, candidates=k).cpu().numpy()
            return idxs, [sel[i, :sizes[i]] for i in range(b)]
        tgt_all = tgt_dev.cpu().numpy()
        cands = [tgt_all[i * k:(i + 1) * k, :sizes[i]] for i in range(b)]
        idxs = self._rerank(batch, cands, sizes, k)
        return idxs, [cands[i][idxs[i]] for i in range(b)]

    def _rerank_on_device(self, batch, tgt_dev, sizes, k: int):
        """Scores the candidates without a host round trip when the text
        ranker can (ClapRanker.score_on_device: clips within the 10 s CLAP
        window at its sample rate). Returns the winners' indices, or None
        for the host path."""
        r = self.text_ranker
        if r is None or not hasattr(r, "supports_on_device"):
            return None
        if not r.supports_on_device(sizes, self.sample_rate):
            return None
        scores = r.score_on_device(tgt_dev.reshape(len(sizes), k, -1), sizes,
                                   batch.descriptions)
        return [int(i) for i in torch.argmax(scores, dim=1).cpu()]

    def _rerank(self, batch, target, sizes, k: int):
        """Host path: target is per item a (k, T_i) array."""
        b = len(target)
        audios = np.asarray(batch.audios)
        # the mixture, zero-padded to the frame-rounded size of the targets
        mixes = [np.pad(audios[i, 0, :sizes[i]], (0, max(0, sizes[i] - audios.shape[-1])))
                 for i in range(b)]
        kwargs = dict(
            extracted_audio=target,
            input_audio=[np.broadcast_to(m, (k, m.shape[0])) for m in mixes],
            descriptions=batch.descriptions, sample_rate=self.sample_rate)
        if batch.anchors is not None:
            kwargs["spans"] = batch.anchors
        return [int(i) for i in np.argmax(np.asarray(self.text_ranker(**kwargs)), axis=1)]
