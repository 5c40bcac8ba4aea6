"""Ring (context-parallel) attention across a group of ranks; counterpart of
the JAX package's ops/ring_attention.py.

The sequence axis is split over the ranks of a group: each rank keeps its
block of queries and passes its key/value block (and its padding mask) to
the next rank of the ring, n times in all, merging the partial attention
with the online-softmax recurrence in fp32. No (S, S) matrix exists on any
rank. The local step is plain PyTorch, as JAX's is an einsum outside any
Pallas kernel; the shift is a collective (parallel/comm.ring_shift, whose
backward shifts the other way, so the ring is differentiable).

JAX's semantics are kept exactly: fp32 scores, the finite `_MASK_VALUE`
added to masked keys (so the running-max merge never meets -inf - -inf),
and `l` clamped at 1e-30.
"""

from __future__ import annotations

from typing import Optional

import torch

from sam_audio_tpu_torch.parallel import comm

_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _group(mesh_or_group, axis_name: str):
    from sam_audio_tpu_torch.parallel.mesh import Mesh

    if isinstance(mesh_or_group, Mesh):
        return mesh_or_group.group(axis_name)
    return mesh_or_group


def ring_attend_local(q, k, v, mask, *, scale: float, group) -> torch.Tensor:
    """This rank's blocks: q, k, v (B, S_local, H, D); mask (B, S_local),
    nonzero = attend. Returns (B, S_local, H, D) in q's dtype."""
    n = comm.size(group)
    b, sq, h, d = q.shape
    qf = q.float() * scale
    m = torch.full((b, h, sq), _MASK_VALUE, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    k_blk, v_blk, mask_blk = k, v, mask.float()
    for step in range(n):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.float())
        s = s + (1.0 - mask_blk)[:, None, None, :] * _MASK_VALUE
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha.transpose(1, 2)[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p, v_blk.float())
        m = m_new
        if step < n - 1:   # JAX's last shift brings the blocks home unused
            k_blk = comm.ring_shift(k_blk, group)
            v_blk = comm.ring_shift(v_blk, group)
            mask_blk = comm.ring_shift(mask_blk, group)
    l = torch.clamp(l, min=1e-30)
    return (acc / l.transpose(1, 2)[..., None]).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh_or_group,
                   key_padding_mask: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None, axis_name: str = "sp") -> torch.Tensor:
    """q, k, v: (B, S, H, D), whole on every rank, with S divisible by the
    group's size; key_padding_mask: (B, S) bool, True = attend. Semantics of
    ops.attention.sdpa (softmax in fp32). Each rank computes its block of
    the sequence; returns this rank's block (B, S / n, H, D).
    `mesh_or_group`: a parallel.mesh.Mesh (its `axis_name` axis) or a
    process group."""
    group = _group(mesh_or_group, axis_name)
    b, s, h, d = q.shape
    n = comm.size(group)
    if s % n != 0:
        raise ValueError(
            f"sequence length {s} must divide over {axis_name}={n}; pad the "
            "sequence (and extend key_padding_mask) to a multiple first")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if key_padding_mask is None:
        key_padding_mask = torch.ones((b, s), dtype=torch.bool, device=q.device)
    q, k, v, mask = (comm.block(x, 1, group) for x in (q, k, v, key_padding_mask))
    return ring_attend_local(q, k, v, mask, scale=scale, group=group)
