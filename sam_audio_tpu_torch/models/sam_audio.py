"""SAMAudio: promptable audio source separation via conditional flow matching.

Counterpart of sam_audio_tpu/models/sam_audio.py (reference:
sam_audio/model/model.py:75-362):

  * `forward` — one velocity-field evaluation (noisy latents + conditioning
    -> velocity), reference model.py:130-180.
  * `SAMAudio.separate` — codec-encode, T5-encode, condition (text, anchors
    given or predicted by the span predictor, models/span_predictor.py, and a
    masked video through the PE-Core vision tower, models/pe_clip.py),
    integrate the ODE (midpoint, 16 steps = 32 DiT evaluations),
    codec-decode target and residual. Reference model.py:247-338. With k
    candidates and a ranker (a text ranker, or the visual ranker when the
    batch has video), the k targets are decoded and ranked and only the
    winner's residual is decoded; `preview_nfe` ranks cheap previews first.
  * `SAMAudio.quantize` — the int8 / int4 serving modes (ops/quant.py); int8
    also quantizes an attached vision tower.
  * `SAMAudio.save_pretrained` — config.json + params.npz in the JAX
    package's layout.
  * clips past the direct limit stream through fixed windows
    (`_separate_long`, streaming.py).

Entry points run on the card unless the caller passes device="cpu"; with no
GPU and no explicit CPU request they raise.
"""

from __future__ import annotations

import functools
import logging
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from sam_audio_tpu_torch.config import SAMAudioConfig
from sam_audio_tpu_torch.models import dacvae
from sam_audio_tpu_torch.models.dit import dit_apply, dit_rope_tables
from sam_audio_tpu_torch.models.dit_graph import DiTGraphs
from sam_audio_tpu_torch.models.t5 import t5_encode
from sam_audio_tpu_torch.ops import nn as N
from sam_audio_tpu_torch.ops.ode import odeint
from sam_audio_tpu_torch.parallel import comm
from sam_audio_tpu_torch.parallel.mesh import dp_block
from sam_audio_tpu_torch.utils import stage

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
            compute_dtype=None, remat=None, dropout_generator=None, dit_fn=None,
            rope_tables=None):
    """One ODE function evaluation. noisy_audio/audio_features: (B, T,
    2*latent); text_features: (B, L, text_dim); time: (B,). Returns the
    velocity (B, T, out_channels). `remat` and `dropout_generator` are for
    training (models/dit.py dit_apply); inference passes neither. `dit_fn`
    replaces the DiT (the sequence-parallel trunk; inference only).
    `rope_tables`: the DiT's (cos, sin) for T frames (dit_rope_tables), or
    None to look them up."""
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
    if dit_fn is not None:
        if remat is not None or dropout_generator is not None:
            raise ValueError("dit_fn is inference-only")
        return dit_fn(params["transformer"], aligned, time, cfg=cfg.transformer,
                      padding_mask=audio_pad_mask, memory=memory,
                      memory_padding_mask=text_mask, compute_dtype=compute_dtype)
    return dit_apply(
        params["transformer"], aligned, time, cfg=cfg.transformer,
        padding_mask=audio_pad_mask, memory=memory,
        memory_padding_mask=text_mask, compute_dtype=compute_dtype,
        remat=remat, dropout_generator=dropout_generator, rope_tables=rope_tables,
    )


def separate_latents(params, audios, text_ids, text_mask, anchor_ids,
                     anchor_alignment, audio_pad_mask, noise, *,
                     cfg: SAMAudioConfig, candidates: int = 1,
                     ode_method: str = "midpoint", ode_step_size: float = 2 / 32,
                     video_features: Optional[torch.Tensor] = None, mesh=None,
                     sp_mesh=None, sp_axis: str = "sp", graphs: Optional[DiTGraphs] = None):
    """Encode -> condition -> ODE. audios (B, 1, Tw); noise (B*k, T, 2C);
    video_features (B, vision_dim, T) or None for no visual prompt.
    Returns the generated latents (B*k, T, 2C) = [target || residual].

    `mesh` (parallel.mesh.Mesh, from `SAMAudio.shard`): when its "dp" size
    divides B*k, each dp rank solves its block of the rows (as JAX pins
    them, models/sam_audio.py:222-237) and the blocks are gathered after
    the ODE; otherwise every rank solves all rows. The codec and T5 run
    whole on every rank. `sp_mesh`: the DiT trunk runs sequence-parallel
    over its `sp_axis` axis (parallel/sp.py) on whole DiT leaves; the
    velocity is gathered whole for the ODE on every rank.

    `graphs` (the model's `DiTGraphs`): where it engages (the state on a
    CUDA device, autograd off, no mesh, no sp_mesh, no tp group), each
    evaluation of the ODE replays a CUDA graph of the DiT evaluation
    (models/dit_graph.py); otherwise, and without it, they run eagerly."""
    compute_dtype = DTYPES[cfg.compute_dtype]
    with stage("codec_encode"):
        lat = dacvae.encode(params["audio_codec"], audios, cfg.audio_codec,
                            compute_dtype=compute_dtype)      # (B, C, T)
    lat = lat.transpose(1, 2).float()
    audio_features = torch.cat([lat, lat], dim=2)            # (B, T, 2C)
    with stage("t5"):
        text_features = t5_encode(params["text_encoder"], text_ids, text_mask,
                                  cfg.text_encoder, compute_dtype=compute_dtype)
    b, t, _ = audio_features.shape
    # zeros when there is no visual prompt (reference model.py:186-191)
    if video_features is None:
        video_features = torch.zeros((b, cfg.vision_encoder.dim, t),
                                     device=audio_features.device)

    def rep(x):  # candidate expansion, item-major (reference model.py:193-206)
        return x if candidates <= 1 else torch.repeat_interleave(x, candidates, 0)

    audio_features, text_features, text_mask, video_features = map(
        rep, (audio_features, text_features, text_mask, video_features))
    anchor_ids, anchor_alignment, audio_pad_mask = map(
        rep, (anchor_ids, anchor_alignment, audio_pad_mask))
    bk = audio_features.shape[0]
    noise = noise.float()
    dp_group = None if mesh is None else mesh.group("dp")
    dp = comm.size(dp_group)
    if dp > 1 and bk % dp == 0:
        rows = dp_block(bk, mesh)
        audio_features, text_features, text_mask, video_features, anchor_ids, \
            anchor_alignment, audio_pad_mask, noise = (
                x[rows] for x in (audio_features, text_features, text_mask, video_features,
                                  anchor_ids, anchor_alignment, audio_pad_mask, noise))
        bk //= dp
    else:
        dp_group = None

    dit_fn = None
    if sp_mesh is not None:
        from sam_audio_tpu_torch.parallel.sp import dit_apply_sp, gather_sequence

        def dit_fn(*args, **kwargs):
            return gather_sequence(dit_apply_sp(*args, mesh=sp_mesh, axis_name=sp_axis,
                                                **kwargs), sp_mesh, sp_axis)

    # what an evaluation reads besides the state, the time and the params
    rope = None if dit_fn is not None else dit_rope_tables(cfg.transformer, t, noise.device)
    inputs = dict(audio_features=audio_features, text_features=text_features,
                  text_mask=text_mask, video_features=video_features, anchor_ids=anchor_ids,
                  anchor_alignment=anchor_alignment, audio_pad_mask=audio_pad_mask,
                  rope_cos=None if rope is None else rope[0],
                  rope_sin=None if rope is None else rope[1])

    def vector_field(tt, y, video_features, rope_cos, rope_sin, **cond):
        v = forward(
            params, cfg, noisy_audio=y, time=tt.expand(bk),
            masked_video_features=video_features, compute_dtype=compute_dtype,
            dit_fn=dit_fn, rope_tables=None if rope_cos is None else (rope_cos, rope_sin),
            **cond,
        )
        return v.to(y.dtype)

    sharded = mesh is not None or sp_mesh is not None or comm.tp_group() is not None
    if graphs is not None and graphs.engages(noise, sharded):
        func = graphs.field(vector_field, noise, inputs)
    else:
        func = functools.partial(vector_field, **inputs)
    with stage("ode"):
        latents = odeint(func, noise, method=ode_method, step_size=ode_step_size)
    return comm.gather(latents, 0, dp_group)


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

    `dit_graphs` holds the CUDA graphs of the DiT evaluation that
    `separate` replays on the card (models/dit_graph.py); setting `params`
    (quantize(), shard(), a load) clears it. The graphs see leaves changed
    in place; a leaf replaced inside the tree needs `params` set again.
    """

    def __init__(self, cfg: SAMAudioConfig, params, device="cuda", tokenizer=None,
                 allow_random_towers: bool = False, text_ranker=None,
                 visual_ranker=None, vision_encoder=None, span_predictor=None):
        from sam_audio_tpu_torch.checkpoint import cast_matmul_weights

        self.cfg = cfg
        self.device = resolve_device(device)
        compute_dtype = DTYPES[cfg.compute_dtype]
        if compute_dtype != torch.float32:
            params = cast_matmul_weights(params, compute_dtype)
        self.dit_graphs = DiTGraphs()
        self.params = params
        self._tokenizer = tokenizer
        self.allow_random_towers = allow_random_towers
        # scores the k candidates of separate(reranking_candidates=k); a
        # ranking.Ranker, e.g. ranking.clap.ClapRanker
        self.text_ranker = text_ranker
        # ranks the candidates of a batch with video (ranking.imagebind)
        self.visual_ranker = visual_ranker
        # the PE-Core tower (models/pe_clip.PerceptionEncoder) ships apart
        # from checkpoint.pt (reference model.py:346-359); without one a
        # visual prompt raises unless allow_random_towers (tests)
        self.vision_encoder = vision_encoder
        # `(model, batch, audios) -> spans` for separate(predict_spans=True)
        # (models/span_predictor.py); load_sam_audio attaches the one of
        # <snapshot>/span_predictor/
        self.span_predictor = span_predictor
        # parallel.mesh.Mesh set by shard(): tp-split leaves, rows over dp
        self.mesh = None
        self._shard_dims: Dict[str, Dict[str, Optional[int]]] = {}
        # a mesh with an "sp" axis: the DiT trunk runs sequence-parallel
        self.sp_mesh = None
        self._warned_visual_host = False

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

    def save_pretrained(self, out_dir: str) -> str:
        """Write `out_dir/config.json` and `out_dir/params.npz` in the JAX
        package's layout (its save_pretrained / train/export.py), which
        `from_pretrained(out_dir)` and the JAX package load back. The current
        params are written, quantized trees included; weights stored in
        bf16 are widened to fp32, exactly. Attached towers (rankers, the
        vision encoder) live in their own artifacts and are not written."""
        import dataclasses
        import json
        import os

        from sam_audio_tpu_torch.checkpoint import save_params

        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(self.cfg), f, indent=2)
        save_params(os.path.join(out_dir, "params.npz"), self.params)
        return out_dir

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, params):
        # the graphs read the parameters they were captured with
        self._params = params
        self.dit_graphs.clear()

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
        scales). An attached PE vision tower's block linears take the same
        path (ops.quant.quantize_pe_params).
        bits=4 — packed int4 weight storage with group-128 scales; the
        products run through kernel 4 (ops/int4_matmul.py). On the H100 it
        saves weight memory, not time.

        Returns self."""
        from sam_audio_tpu_torch.ops.quant import quantize_pe_params, quantize_sam_audio_params

        self.params = self._requantized(self.params, "params",
                                        lambda p: quantize_sam_audio_params(p, bits))
        if bits == 8 and self.vision_encoder is not None:
            self.vision_encoder.params = self._requantized(
                self.vision_encoder.params, "vision", quantize_pe_params)
        return self

    def _requantized(self, tree, name: str, quantize):
        """`quantize(tree)`; after shard() on the whole leaves, split again:
        the per-row scales of a row-parallel leaf and the int4 groups that
        straddle a tp split are those of quantize() before shard(), bit for
        bit (as JAX quantizes the sharded arrays with global scales)."""
        from sam_audio_tpu_torch.parallel.mesh import gather_params, shard_dims, shard_params

        if name not in self._shard_dims:   # not sharded (or attached after shard())
            return quantize(tree)
        tree = quantize(gather_params(tree, self.mesh, self._shard_dims[name]))
        self._shard_dims[name] = shard_dims(tree, self.mesh)
        return shard_params(tree, self.mesh)

    def shard(self, mesh=None, tp: int = 1):
        """Split the params over a (dp, tp) mesh of the torch.distributed
        ranks (parallel/mesh.py): each rank keeps its block of every leaf a
        tensor-parallel rule matches (the DiT, T5, and an attached PE vision
        tower), the rest stays whole; separate() then runs the towers
        tensor-parallel and splits the B*k rows over dp. Every rank calls it
        with the same arguments and gets the same SeparationResult from
        separate() (parallel/serve.py drives the other ranks from rank 0).
        `quantize()` may come before or after. Returns self."""
        from sam_audio_tpu_torch.parallel.mesh import make_mesh, shard_dims, shard_params

        if mesh is None:
            mesh = make_mesh(tp=tp)
        # the split dimension of every leaf, for quantize() and the sp trunk
        self._shard_dims = {"params": shard_dims(self.params, mesh)}
        self.params = shard_params(self.params, mesh)
        if self.vision_encoder is not None:
            self._shard_dims["vision"] = shard_dims(self.vision_encoder.params, mesh)
            self.vision_encoder.params = shard_params(self.vision_encoder.params, mesh)
            self.vision_encoder.mesh = mesh
        self.mesh = mesh
        return self

    def _parallel_args(self):
        """(the params separate_latents runs on, its parallel arguments). With
        `sp_mesh` every rank solves every row through the ring (no dp split),
        on a sharded DiT's tp leaves gathered whole, once a separate, as JAX's
        shard_map gathers them; whole leaves need no tp collective."""
        if self.sp_mesh is None:
            return self.params, dict(mesh=self.mesh)
        params = self.params
        if self.mesh is not None and self.mesh.axis_size("tp") > 1:
            from sam_audio_tpu_torch.parallel.mesh import gather_params

            params = dict(params, transformer=gather_params(
                {"transformer": params["transformer"]}, self.mesh,
                self._shard_dims["params"])["transformer"])
        return params, dict(sp_mesh=self.sp_mesh)

    @torch.inference_mode()
    def separate(self, batch, noise=None, **kwargs) -> SeparationResult:
        """Separate `batch` (a processor.Batch). `noise` (B or B*k, T, 2C)
        is injected as in reference model.py:247-338; without it the noise
        is drawn from `generator` on the model's device.

        With k = reranking_candidates > 1 and a `text_ranker`, the k targets
        are decoded and scored, and only the winner's residual is decoded.
        `preview_nfe` (opt-in, not reference semantics): the candidates are
        solved and ranked at that cheap budget (8 => 4 midpoint steps), then
        only the winning noise is solved at the full budget.

        Clips longer than `max_direct_seconds` (the argument, else the
        model's attribute; at most the RoPE table's
        `cfg.transformer.max_positions` frames) stream through
        streaming.py's windows (`_separate_long`), with the noise drawn per
        window from a seed taken from `generator`; the result then carries
        noise=None. `model.streaming_window_s` (10 s) and
        `model.streaming_batch_windows` (1) set the windows. Explicit
        `noise=` forces the direct solve.

        A batch with `masked_video` (processor(masked_videos=...)) is
        conditioned on the PE-Core features of its frames, one a latent
        frame. `visual_stride` (opt-in, not reference semantics) encodes
        every stride-th frame and interpolates the features between them.
        With k > 1 and a `visual_ranker`, the ranker scores the candidates
        against the video.

        `predict_spans`: when the batch has no anchors, the attached
        `span_predictor` predicts when the described sound occurs and its
        spans become "+" anchors of `batch` (in place). Without a predictor it
        raises, unless `allow_random_towers` (then it is skipped, as in JAX);
        past the direct limit it raises.

        Keyword arguments: ode_opt, reranking_candidates, generator,
        predict_spans, preview_nfe, visual_stride, max_direct_seconds. After
        `shard()` every rank calls it with the same batch and noise (or a
        generator in the same state) and returns the same result."""
        with comm.use_tp(None if self.mesh is None else self.mesh.group("tp")), \
                stage("separate"):
            return self._separate(batch, noise, **kwargs)

    def _separate(self, batch, noise=None, ode_opt: Optional[Dict[str, Any]] = None,
                 reranking_candidates: int = 1,
                 generator: Optional[torch.Generator] = None,
                 predict_spans: bool = False, preview_nfe: Optional[int] = None,
                 visual_stride: int = 1,
                 max_direct_seconds: Optional[float] = None) -> SeparationResult:
        """separate() inside the model's tensor-parallel group."""
        if preview_nfe is not None and (int(preview_nfe) < 2 or int(preview_nfe) % 2):
            raise ValueError(
                "preview_nfe must be an even integer >= 2 (midpoint previews "
                f"take 2 evals per step: preview_nfe=8 => 4 steps); got {preview_nfe}")
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
                return self._separate_long(batch, k=k, generator=generator,
                                           preview_nfe=preview_nfe,
                                           visual_stride=visual_stride,
                                           predict_spans=predict_spans,
                                           limit_frames=limit, ode_opt=ode_opt)
            logger.warning("separate: %d frames exceeds the direct limit (%d) "
                           "but explicit noise= forces the direct path",
                           t_frames, limit)
        dev = self.device
        with stage("upload"):
            audios = torch.as_tensor(np.asarray(batch.audios), dtype=torch.float32,
                                     device=dev)
            text_ids, text_mask = self._tokenize(batch.descriptions)
        b = audios.shape[0]
        if predict_spans and self.span_predictor is None and not self.allow_random_towers:
            raise ValueError(
                "predict_spans=True but no span predictor is attached. Convert a "
                "PEAudioFrame checkpoint into <snapshot>/span_predictor/ (python -m "
                "sam_audio_tpu_torch.convert span-predictor ...): the reference always "
                "loads 'pe-a-frame-large' (sam_audio/model/model.py:96-102).")
        if predict_spans and self.span_predictor is not None and batch.anchors is None:
            self._predict_spans_into_batch(batch, audios)
        video_features = None
        if batch.masked_video is not None:
            with stage("pe_encode"):
                video_features = self._encode_videos(batch.masked_video, t_frames,
                                                     stride=int(visual_stride))
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

        params, par = self._parallel_args()
        par["graphs"] = self.dit_graphs
        with stage("upload"):
            core_args = (params, audios, text_ids, text_mask, as_long(batch.anchor_ids),
                         as_long(batch.anchor_alignment),
                         torch.as_tensor(np.asarray(batch.audio_pad_mask), dtype=torch.bool,
                                         device=dev))

        def decoded(decode, channel, rows):
            with stage(("decode_target", "decode_residual")[channel]):
                return decode(self.params, rows, cfg=cfg, channel=channel)

        def trimmed(wavs):
            with stage("to_host"):
                wavs = wavs.cpu().numpy()
            return [wavs[i, :sizes[i]] for i in range(b)]

        rerank = k > 1 and (self.text_ranker is not None or (
            batch.masked_video is not None and self.visual_ranker is not None))
        if rerank and preview_nfe is not None:
            # rank on cheap previews, then the full solve of the winners only
            preview = separate_latents(*core_args, noise, cfg=cfg, candidates=k,
                                       ode_method=method, ode_step_size=2.0 / preview_nfe,
                                       video_features=video_features, **par)
            idxs = self._choose(batch, decoded(decode_channel_chunked, 0, preview), sizes, k)[0]
            chosen = separate_latents(
                *core_args, gather_candidates(noise, idxs, candidates=k), cfg=cfg,
                candidates=1, ode_method=method, ode_step_size=float(step),
                video_features=video_features, **par)
            target = trimmed(decoded(decode_channel, 0, chosen))
        else:
            latents = separate_latents(*core_args, noise, cfg=cfg, candidates=k,
                                       ode_method=method, ode_step_size=float(step),
                                       video_features=video_features, **par)
            if rerank:
                # all k targets are decoded for the ranker; the residual only
                # for the winner (the JAX package's lazy decode)
                idxs, target = self._choose(
                    batch, decoded(decode_channel_chunked, 0, latents), sizes, k)
                chosen = gather_candidates(latents, idxs, candidates=k)
            else:  # candidate 0 of every item
                chosen = gather_candidates(latents, [0] * b, candidates=k)
                target = trimmed(decoded(decode_channel, 0, chosen))
        residual = trimmed(decoded(decode_channel, 1, chosen))
        return SeparationResult(target=target, residual=residual, noise=noise)

    def _separate_long(self, batch, k: int, generator, preview_nfe, predict_spans: bool,
                       limit_frames: int, ode_opt=None,
                       visual_stride: int = 1) -> SeparationResult:
        """A batch whose clips exceed the direct limit, through streaming.py's
        windows, one item at a time (reference model.py's direct path stops
        at its RoPE table, ~400 s). One base seed is drawn from `generator`;
        item i's windows draw their noise from (seed, i, window)."""
        from sam_audio_tpu_torch.streaming import base_seed, separate_streaming

        if predict_spans:
            raise ValueError(
                "predict_spans=True is unsupported beyond max_direct_seconds: span "
                "prediction attends over the whole clip at once. Pass explicit "
                "anchors= for long clips.")
        seed = base_seed(generator)
        # each window re-enters separate() directly, so it must fit the limit
        window_s = min(float(getattr(self, "streaming_window_s", 10.0)),
                       limit_frames * self.hop_length / self.sample_rate)
        batch_windows = int(getattr(self, "streaming_batch_windows", 1))
        audios = np.asarray(batch.audios)
        sizes = [self.feature_idx_to_wav_idx(int(s)) for s in np.asarray(batch.sizes)]
        target, residual = [], []
        for i in range(audios.shape[0]):
            res = separate_streaming(
                self, batch.descriptions[i], audios[i, 0, : sizes[i]], window_s=window_s,
                batch_windows=batch_windows,
                anchors=(list(batch.anchors[i])
                         if batch.anchors is not None and batch.anchors[i] else None),
                reranking_candidates=k, seed=seed, item=i, preview_nfe=preview_nfe,
                masked_video=(batch.masked_video[i] if batch.masked_video is not None
                              else None),
                visual_stride=visual_stride, ode_opt=ode_opt)
            target.append(res.target[: sizes[i]])
            residual.append(res.residual[: sizes[i]])
        return SeparationResult(target=target, residual=residual, noise=None)

    # -- reranking (reference model.py:306-330) ------------------------------

    def _choose(self, batch, tgt_dev, sizes, k: int):
        """tgt_dev: the (B*k, Tw) decoded targets on the device. Returns the
        winners' indices and their trimmed target waveforms."""
        b = len(sizes)
        with stage("rank"):
            idxs = self._rerank_on_device(batch, tgt_dev, sizes, k)
            if idxs is not None:
                # only the b winners leave the device
                with stage("to_host"):
                    sel = gather_candidates(tgt_dev, idxs, candidates=k).cpu().numpy()
                return idxs, [sel[i, :sizes[i]] for i in range(b)]
            with stage("to_host"):
                tgt_all = tgt_dev.cpu().numpy()
            cands = [tgt_all[i * k:(i + 1) * k, :sizes[i]] for i in range(b)]
            idxs = self._rerank(batch, cands, sizes, k)
            return idxs, [cands[i][idxs[i]] for i in range(b)]

    def _rerank_on_device(self, batch, tgt_dev, sizes, k: int):
        """Scores the candidates without a host round trip when the ranker
        can (ClapRanker.score_on_device: clips within the 10 s CLAP window at
        its sample rate; JudgeRanker.score_on_device: frame-aligned clips at
        the judge's rate, with the mixtures; ImageBindRanker.score_on_device:
        a batch with video whose candidates all have the decoded length,
        since ImageBind's clip starts depend on the true duration). Returns
        the winners' indices, or None for the host path."""
        if batch.masked_video is not None and self.visual_ranker is not None:
            r = self.visual_ranker
            t_pad = int(tgt_dev.shape[-1])
            if (hasattr(r, "supports_on_device") and all(int(s) == t_pad for s in sizes)
                    and r.supports_on_device(sizes, self.sample_rate)):
                scores = r.score_on_device(tgt_dev.reshape(len(sizes), k, -1), sizes,
                                           batch.masked_video, sample_rate=self.sample_rate)
                return [int(i) for i in torch.argmax(scores, dim=1).cpu()]
            if not self._warned_visual_host:
                logger.warning(
                    "visual rerank: candidates of unequal or padded lengths (sizes %s, "
                    "decoded length %d) are scored on the host path: ImageBind's clip starts "
                    "depend on each candidate's true duration", list(sizes), t_pad)
                self._warned_visual_host = True
            return None
        r = self.text_ranker
        if r is None or not hasattr(r, "supports_on_device"):
            return None
        if not r.supports_on_device(sizes, self.sample_rate):
            return None
        scores = r.score_on_device(
            tgt_dev.reshape(len(sizes), k, -1), sizes, batch.descriptions,
            mixtures=torch.as_tensor(np.asarray(batch.audios), dtype=torch.float32,
                                     device=self.device))
        return [int(i) for i in torch.argmax(scores, dim=1).cpu()]

    def _rerank(self, batch, target, sizes, k: int):
        """Host path: target is per item a (k, T_i) array."""
        b = len(target)
        if batch.masked_video is not None and self.visual_ranker is not None:
            scores = self.visual_ranker(extracted_audio=target, videos=batch.masked_video,
                                        sample_rate=self.sample_rate)
            return [int(i) for i in np.argmax(np.asarray(scores), axis=1)]
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

    # -- optional towers --------------------------------------------------------

    def _encode_videos(self, masked_videos, t_frames: int, stride: int = 1):
        from sam_audio_tpu_torch.models.pe_clip import encode_videos

        return encode_videos(self, masked_videos, t_frames, stride=stride)

    def _predict_spans_into_batch(self, batch, audios):
        """The predicted spans become "+" anchors of `batch` (in place)."""
        spans = self.span_predictor(self, batch, audios)
        batch.process_anchors([[["+"] + list(span) for span in item] for item in spans])
