"""Sequence-parallel DiT forward: one attention over a sequence split across
ranks; counterpart of the JAX package's parallel/sp.py.

`dit_apply_sp` runs `models/dit.dit_apply`'s computation with the layer
trunk on this rank's block of the sequence: the stem and the embedders run
whole on every rank, then the activations, the padding mask and the RoPE
tables (sliced at the block's global positions, rank * S / n onward) are
split along the sequence. Self-attention is the ring
(ops/ring_attention.ring_attend_local); everything else in a block (norms,
adaLN modulation, FFN, the cross-attention to the whole text memory) is per
token and runs on the local block. The final modulation and the output head
run on the block too.

Differentiable: the parameters enter through comm.copy_to, so every rank's
gradient is the sum of all blocks' contributions, and the ring's shift
transposes to the reverse ring: the gradients equal the single-rank ones.
"""

from __future__ import annotations

import torch

from sam_audio_tpu_torch.models.dit import dit_block_apply, dit_finalize, dit_prepare
from sam_audio_tpu_torch.ops.ring_attention import _group, ring_attend_local
from sam_audio_tpu_torch.parallel import comm
from sam_audio_tpu_torch.utils import tree_map, unstack_layers


def dit_apply_sp(params, x, time, *, cfg, mesh, axis_name: str = "sp", padding_mask=None,
                 memory=None, memory_padding_mask=None, compute_dtype=None):
    """Sequence-parallel `dit_apply` (no dropout, no remat). x: (B, T,
    in_channels or dim), whole on every rank, with the post-stem length T
    divisible by the group's size. `mesh`: a parallel.mesh.Mesh (its
    `axis_name` axis) or a process group. Returns this rank's block
    (B, T / n, out_channels); `gather_sequence` joins the blocks."""
    group = _group(mesh, axis_name)
    n = comm.size(group)
    params = tree_map(lambda p: comm.copy_to(p, group), params)
    h, t, t0, y, rope_tables, _, _ = dit_prepare(
        params, x, time, cfg=cfg, memory=memory, compute_dtype=compute_dtype)
    b, s, _ = h.shape
    if s % n != 0:
        raise ValueError(
            f"post-stem sequence length {s} must divide over "
            f"{axis_name}={n}; pad the input (and padding_mask) first")
    if memory is None:
        raise ValueError("dit_apply_sp requires text memory (the DiT always "
                         "has it in practice); memory=None would need a "
                         "second ring in the cross-attention slot")
    if padding_mask is None:
        padding_mask = torch.ones((b, s), dtype=torch.bool, device=h.device)
    if memory_padding_mask is None:
        memory_padding_mask = torch.ones(y.shape[:2], dtype=torch.bool, device=y.device)
    h_loc = comm.block(h, 1, group)
    pad_loc = comm.block(padding_mask.bool(), 1, group)
    tables = None
    if rope_tables is not None:
        tables = tuple(comm.block(tab, 0, group) for tab in rope_tables)

    def ring(q, k, v, key_padding_mask=None):
        mask = (torch.ones(q.shape[:2], device=q.device) if key_padding_mask is None
                else key_padding_mask)
        return ring_attend_local(q, k, v, mask, scale=1.0 / (q.shape[-1] ** 0.5),
                                 group=group)

    for layer in unstack_layers(params["layers"]):
        h_loc = dit_block_apply(
            layer, h_loc, cfg=cfg, cross_x=y, t0=t0, padding_mask=pad_loc,
            memory_padding_mask=memory_padding_mask, rope_tables=tables,
            compute_dtype=compute_dtype, attend_fn=ring)
    return dit_finalize(params, h_loc, t, cfg=cfg, compute_dtype=compute_dtype)


def gather_sequence(out: torch.Tensor, mesh, axis_name: str = "sp") -> torch.Tensor:
    """The whole (B, T, C) from every rank's (B, T / n, C) block."""
    return comm.gather(out, 1, _group(mesh, axis_name))
