"""DiT backbone (adaLN-single diffusion transformer); counterpart of
sam_audio_tpu/models/dit.py.

Matches the reference DiT (sam_audio/model/transformer.py:291-524):
per-block learned (6, dim) scale-shift tables added to a shared projection of
the timestep embedding, RoPE self-attention with per-head q/k RMSNorm,
un-gated cross-attention to the text memory, SwiGLU FFN, Patcher conv stem,
final adaLN modulation and linear head. Layer parameters are stacked on
axis 0; the layer loop is a Python loop over views of them
(`utils.unstack_layers`, whose backward stacks the layers' gradients once).

Self-attention dispatch (as dit.py:70-110):
  * T <= 512 with qk_norm and head_dim % 128 == 0 -> the fused norm + RoPE +
    attention kernel (ops/fused_attention.py);
  * otherwise norm + RoPE in PyTorch, then ops/attention.attend, which sends
    T >= 1024 to the flash kernel (ops/flash_attention.py) and the rest to
    plain sdpa.

Training (as dit.py:259-376): `dropout_generator` turns on dropout at the
reference's five sites (post-stem, timestep embedder, context embedder at
`context_embedder_dropout`, each block's FFN hidden layer, pre-output);
`remat` recomputes each layer in the backward pass, "full" through
torch.utils.checkpoint and "dots" keeping the outputs of the unbatched
matmuls (the projections), as JAX's dots_with_no_batch_dims_saveable.
Each site draws its mask from a generator seeded from `dropout_generator`
once a forward, so a recomputed layer draws the same mask.

Tensor parallelism (parallel/mesh.py's rules): wq/wk/wv/w1/w3 and t_block
column-parallel, wo/w2 row-parallel; each rank attends over its H/tp heads
and t_block's output is gathered whole for every block's modulation.
`dit_prepare` / `dit_block_apply(attend_fn=)` / `dit_finalize` split the
trunk as JAX does, for the sequence-parallel path (parallel/sp.py).

RoPE tables come from `dit_rope_tables` (built once a length, on the
device) unless the caller passes them: a CUDA graph of the evaluation
(models/dit_graph.py) reads them from its own buffers.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from sam_audio_tpu_torch.config import TransformerConfig
from sam_audio_tpu_torch.ops import conv as C
from sam_audio_tpu_torch.ops import nn as N
from sam_audio_tpu_torch.ops.attention import attend, sdpa
from sam_audio_tpu_torch.ops.fused_attention import fused_glue_attention
from sam_audio_tpu_torch.ops.rope import apply_rope_half, rope_tables as cached_rope
from sam_audio_tpu_torch.utils import unstack_layers

FUSED_MAX_SEQLEN = 512


def attention_apply(params, x, *, n_heads, head_dim, cross_x=None,
                    key_padding_mask=None, rope_tables=None, norm_eps=1e-5,
                    compute_dtype=None, attend_fn=None):
    """x: (B, Tq, dim); cross_x: (B, Tk, dim) or None for self-attention.
    Heads split contiguously (B, T, H, D); checkpoint conversion already
    permuted the reference's strided head split.

    Under tensor parallelism (parallel/mesh.py) wq/wk/wv hold this rank's
    block of heads and wo the matching input columns: the rank attends over
    its H/tp heads (kernel 1 included) and wo sums the partial outputs. A
    block that splits a head is gathered whole first. The per-head q/k norm
    weights are whole on every rank.

    `attend_fn(q, k, v, key_padding_mask=)` replaces SELF-attention (the
    sequence-parallel ring, parallel/sp.py) and so takes the place of the
    fused kernel; cross-attention always attends locally."""
    src = x if cross_x is None else cross_x
    b, tq, _ = x.shape
    tk = src.shape[1]
    full = n_heads * head_dim
    q, k, v = (N.whole_heads(N.column_linear(params[name], inp, compute_dtype, full),
                             head_dim)
               for name, inp in (("wq", x), ("wk", src), ("wv", src)))
    h = q.shape[-1] // head_dim
    q = q.reshape(b, tq, h, head_dim)
    k = k.reshape(b, tk, h, head_dim)
    v = v.reshape(b, tk, h, head_dim)
    if "q_norm" in params:
        qn, kn = params["q_norm"]["weight"], params["k_norm"]["weight"]
        if h < n_heads:
            qn, kn = N.tp_replicated(qn), N.tp_replicated(kn)
    if (cross_x is None and attend_fn is None and rope_tables is not None
            and "q_norm" in params and head_dim % 128 == 0 and tq <= FUSED_MAX_SEQLEN):
        out = fused_glue_attention(q, k, v, qn, kn, rope_tables[0], rope_tables[1],
                                   key_padding_mask=key_padding_mask, eps=norm_eps)
        return N.row_linear(params["wo"], out.reshape(b, tq, h * head_dim),
                            compute_dtype, full)
    if "q_norm" in params:
        q = N.rmsnorm({"weight": qn}, q, norm_eps)
        k = N.rmsnorm({"weight": kn}, k, norm_eps)
    if rope_tables is not None:
        q = apply_rope_half(q, *rope_tables)
        k = apply_rope_half(k, *rope_tables)
    if cross_x is not None:
        attn = sdpa
    else:
        attn = attend_fn or attend
    out = attn(q, k, v, key_padding_mask=key_padding_mask)
    return N.row_linear(params["wo"], out.reshape(b, tq, h * head_dim), compute_dtype, full)


def dit_block_apply(params, h, *, cfg: TransformerConfig, cross_x, t0,
                    padding_mask, memory_padding_mask, rope_tables,
                    compute_dtype=None, dropout_generator=None, attend_fn=None):
    """h: (B, T, dim); t0: (B, 6*dim) shared timestep projection.
    `dropout_generator` draws the FFN hidden layer's dropout mask;
    `attend_fn` replaces self-attention (attention_apply)."""
    b = h.shape[0]
    biases = (params["scale_shift_table"][None].float()
              + t0.reshape(b, 6, -1).float()).to(h.dtype)
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (
        biases[:, i][:, None, :] for i in range(6)
    )
    h_attn = attention_apply(
        params["attention"],
        N.modulate(N.rmsnorm(params["attention_norm"], h, cfg.norm_eps),
                   shift_msa, scale_msa),
        n_heads=cfg.n_heads, head_dim=cfg.head_dim,
        key_padding_mask=padding_mask, rope_tables=rope_tables,
        norm_eps=cfg.norm_eps, compute_dtype=compute_dtype, attend_fn=attend_fn,
    )
    h = h + N.gate(h_attn, gate_msa)
    h = h + attention_apply(  # un-gated cross-attn (reference transformer.py:382-388)
        params["cross_attention"], h, cross_x=cross_x,
        n_heads=cfg.n_heads, head_dim=cfg.head_dim,
        key_padding_mask=memory_padding_mask, norm_eps=cfg.norm_eps,
        compute_dtype=compute_dtype,
    )
    h_ff = N.feedforward(
        params["feed_forward"],
        N.modulate(N.rmsnorm(params["ffn_norm"], h, cfg.norm_eps),
                   shift_mlp, scale_mlp),
        cfg.non_linearity, compute_dtype,
        cfg.dropout if dropout_generator is not None else 0.0, dropout_generator,
        hidden=cfg.ffn_hidden_dim,
    )
    return h + N.gate(h_ff, gate_mlp)


def _conv_block_apply(params, x, num_groups=1, compute_dtype=None):
    x = C.groupnorm(params["groupnorm"], x, num_groups)
    x = F.silu(x)
    return C.audiocraft_conv1d(params["project"], x, compute_dtype=compute_dtype)


def patcher_apply(params, x, compute_dtype=None):
    """ResnetBlock1d with patch_size=1 (reference: patcher.py:104-164). x: (B,C,T)."""
    h = _conv_block_apply(params["block1"], x, compute_dtype=compute_dtype)
    h = _conv_block_apply(params["block2"], h, compute_dtype=compute_dtype)
    if "to_out" in params:
        return h + C.conv1d(params["to_out"], x, compute_dtype=compute_dtype)
    return h + x


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """remat="dots": keep the unbatched products (every linear), recompute
    the rest (norms, attention's batched products, elementwise work)."""
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _site_generator(seed, device):
    return None if seed is None else torch.Generator(device=device).manual_seed(seed)


def dit_rope_tables(cfg: TransformerConfig, frames: int, device):
    """The DiT's (cos, sin) RoPE tables for `frames` post-stem frames (the
    stem keeps the length), or None without RoPE."""
    if not cfg.use_rope:
        return None
    return cached_rope(cfg.head_dim, frames, max(10000, 2 * cfg.max_positions),
                       torch.device(device))


def dit_prepare(params, x, time, *, cfg: TransformerConfig, memory=None,
                compute_dtype=None, dropout_generator=None, rope_tables=None):
    """Stem and embedders (everything before the layer loop), shared with
    the sequence-parallel trunk (parallel/sp.py). Returns (h, t, t0, y,
    rope_tables, layer_seeds, out_seed): the seeds of the layers' and the
    output's dropout sites (None without `dropout_generator`). Given
    `rope_tables` are used as they are, else `dit_rope_tables` gives them."""
    seeds = [None] * (4 + cfg.n_layers)
    if dropout_generator is not None:
        seeds = torch.randint(0, 2**62, (4 + cfg.n_layers,), generator=dropout_generator,
                              device=dropout_generator.device).tolist()
    stem_seed, out_seed, t_seed, y_seed, *layer_seeds = seeds

    if "data_proj" in params:
        x = N.linear(params["data_proj"], x, compute_dtype)
    h = patcher_apply(params["x_embedder"], x.transpose(1, 2),
                      compute_dtype=compute_dtype).transpose(1, 2)
    h = N.dropout(h, cfg.dropout, _site_generator(stem_seed, h.device))

    t = N.timestep_embedder(params["t_embedder"], time,
                            cfg.frequency_embedding_dim,
                            cfg.timestep_non_linearity, compute_dtype,
                            cfg.dropout, _site_generator(t_seed, h.device))
    t0 = N.get_nonlinearity(cfg.t_block_non_linearity)(t)
    # column-parallel under tp (parallel/mesh.py); every block reads all of it
    full = 6 * cfg.dim
    t0 = N.gather_columns(N.column_linear(params["t_block"], t0, compute_dtype, full), full)

    y = None
    if memory is not None:
        ym = memory
        if "norm" in params["y_embedder"]:
            ym = N.rmsnorm(params["y_embedder"]["norm"], ym, cfg.norm_eps)
        if compute_dtype is not None:
            ym = ym.to(compute_dtype)
        y = N.projection(params["y_embedder"]["projection"], ym,
                         cfg.context_non_linearity, compute_dtype,
                         cfg.context_embedder_dropout, _site_generator(y_seed, h.device))

    if rope_tables is None:
        rope_tables = dit_rope_tables(cfg, h.shape[1], h.device)
    return h, t, t0, y, rope_tables, layer_seeds, out_seed


def dit_finalize(params, h, t, *, cfg: TransformerConfig, compute_dtype=None,
                 out_seed=None):
    """Final adaLN modulate and output head (per token; shared with sp.py)."""
    shift, scale = (
        params["final_layer_scale_shift_table"][None].float() + t[:, None].float()
    ).to(h.dtype).transpose(0, 1)
    h = N.modulate(N.rmsnorm(params["norm"], h, cfg.norm_eps),
                   shift[:, None, :], scale[:, None, :])
    h = N.dropout(h, cfg.dropout, _site_generator(out_seed, h.device))
    return N.linear(params["output"], h, compute_dtype)


def dit_apply(params, x, time, *, cfg: TransformerConfig, padding_mask=None,
              memory=None, memory_padding_mask=None, compute_dtype=None,
              remat=None, dropout_generator=None, rope_tables=None):
    """x: (B, T, in_channels or dim); time: (B,); memory: (B, L, context_dim).
    Returns (B, T, out_channels). Reference: transformer.py:473-524.

    `remat`: None, "full" (each layer recomputed in the backward pass:
    activation memory of about one layer) or "dots" (the layer's linear
    outputs kept, the rest recomputed). `dropout_generator`: a
    torch.Generator (the trainer's is on the CPU, so no device sync) that
    seeds the dropout sites; None is inference. `rope_tables`: (cos, sin)
    for the post-stem length, or None for `dit_rope_tables`'."""
    if remat not in (None, "full", "dots"):
        raise ValueError(f"unknown remat policy {remat!r}")
    h, t, t0, y, rope_tables, layer_seeds, out_seed = dit_prepare(
        params, x, time, cfg=cfg, memory=memory, compute_dtype=compute_dtype,
        dropout_generator=dropout_generator, rope_tables=rope_tables)

    def block(h, layer, seed):
        return dit_block_apply(
            layer, h, cfg=cfg, cross_x=y, t0=t0,
            padding_mask=padding_mask, memory_padding_mask=memory_padding_mask,
            rope_tables=rope_tables, compute_dtype=compute_dtype,
            dropout_generator=_site_generator(seed, h.device),
        )

    remat_kw = {}
    if remat == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        remat_kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                   _save_matmuls)
    for layer, seed in zip(unstack_layers(params["layers"]), layer_seeds):
        if remat is None:
            h = block(h, layer, seed)
        else:   # the dropout masks come from seeds, not the global RNG
            h = checkpoint(block, h, layer, seed, use_reentrant=False,
                           preserve_rng_state=False, **remat_kw)
    return dit_finalize(params, h, t, cfg=cfg, compute_dtype=compute_dtype,
                        out_seed=out_seed)
