"""The port's collectives: the one place where ranks exchange tensors.

JAX's GSPMD inserts the collectives of a sharded program by itself; the
port writes each one out here, as an autograd Function where a gradient
crosses it:

  * `copy_to` / `reduce_from`: Megatron's f and g. f is the identity
    forward and sums the gradient over the group backward (a whole
    activation entering column-parallel linears, or a whole parameter used
    on a local slice); g sums partial products forward and passes the
    gradient through backward (the output of a row-parallel linear).
  * `gather`: the blocks of every rank concatenated along a dimension;
    backward takes this rank's block of the gradient (every rank computes
    the same loss from the gathered value). `scatter` is its reverse.
  * `all_reduce` (sum, max), without a gradient.
  * `ring_shift`: each rank's tensor moves to the next rank of the group;
    backward moves the gradient the other way, as JAX's ppermute
    transposes.

A group of None is a group of one rank: every function is then the
identity. NCCL takes CUDA tensors as they are, and so do gloo's all_reduce
and all_gather (checked on the card: chip_smoke.py's parallel phase probes
them). Gloo's point-to-point takes host tensors only, so under gloo (ranks
that share one card, parallel/mesh.init_distributed) the ring shift copies a
CUDA tensor to host memory, exchanges it, and copies it back.

The active tensor-parallel group (`use_tp`) tells the model code that its
sharded leaves need collectives (ops/nn.column_linear / row_linear); the
active data-parallel group (`use_dp`) that its rows are one block of a
global batch (the dropout masks, ops/nn.dropout_keep).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

# Process-wide settings, not context variables: autograd runs a CUDA
# backward (and a rematerialised layer's forward) on its own threads.
_TP: Optional[dist.ProcessGroup] = None
_DP: Optional[dist.ProcessGroup] = None


@contextlib.contextmanager
def use_tp(group: Optional[dist.ProcessGroup]):
    """Make `group` the tensor-parallel group of the code run inside."""
    global _TP
    saved, _TP = _TP, group
    try:
        yield
    finally:
        _TP = saved


@contextlib.contextmanager
def use_dp(group: Optional[dist.ProcessGroup]):
    """Make `group` the data-parallel group of the code run inside: its
    activations hold this rank's block of the global batch's rows
    (ops/nn.dropout_keep draws a site's mask over all of them)."""
    global _DP
    saved, _DP = _DP, group
    try:
        yield
    finally:
        _DP = saved


def tp_group() -> Optional[dist.ProcessGroup]:
    return _TP


def dp_group() -> Optional[dist.ProcessGroup]:
    return _DP


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.detach().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    src = x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send x to the rank `step` ahead on the group's ring and receive the
    tensor of the rank `step` behind."""
    n = size(group)
    me = rank(group)
    dst = dist.get_global_rank(group, (me + step) % n)
    src = dist.get_global_rank(group, (me - step) % n)
    send = x.detach().contiguous()
    if x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO:
        send = send.cpu()   # gloo's send / recv take host tensors only
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dst, group), dist.P2POp(dist.irecv, recv, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        r = rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.n, ctx.n).contiguous(), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return block(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def _grad_path(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """f: the identity; the gradient is summed over `group`."""
    if size(group) == 1 or not _grad_path(x):
        return x
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """g: the sum over `group` of every rank's partial `x`."""
    if size(group) == 1:
        return x
    if not _grad_path(x):
        return _all_reduce(x, group)
    return _ReduceFrom.apply(x, group)


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's block of `x` concatenated along `dim`, in rank order."""
    if size(group) == 1:
        return x
    if not _grad_path(x):
        return _all_gather(x, dim, group)
    return _Gather.apply(x, dim, group)


def scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of an activation that is whole (and the same) on
    every rank; backward gathers the blocks' gradients, so that the whole
    activation's gradient is whole again on every rank (Megatron's
    scatter). `block` is the plain slice, for a tensor whose gradient the
    caller sums over the group itself."""
    if size(group) == 1:
        return x
    if not _grad_path(x):
        return block(x, dim, group)
    return _Scatter.apply(x, dim, group)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (or "max") of `x` over `group`, without a gradient."""
    if size(group) == 1:
        return x
    return _all_reduce(x, group, {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op])


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """The tensor of the previous rank on the group's ring."""
    if size(group) == 1:
        return x
    if not _grad_path(x):
        return _shift(x, group, 1)
    return _RingShift.apply(x, group)


def block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of a whole `x` along `dim` (a view)."""
    n = size(group)
    if n == 1:
        return x
    per = x.shape[dim] // n
    return x.narrow(dim, rank(group) * per, per)
