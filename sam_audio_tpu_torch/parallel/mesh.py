"""Rank meshes and the sharding rules; counterpart of
the JAX package's parallel/mesh.py, over torch.distributed.

  * A `Mesh` lays the ranks of the default process group out as a grid with
    named axes, row-major as JAX's `np.reshape(devices, shape)`: for the
    ("dp", "tp") mesh of `make_mesh`, rank = d * tp + t. It holds one
    process group per axis for this rank (the ranks that differ from it on
    that axis only), or None where the axis has size 1.
  * The Megatron rules are JAX's three regexes over "/"-joined parameter
    paths, with JAX's PartitionSpecs written as plain tuples:
    column-parallel weights (wq/wk/wv, w1/w3, fc1, T5's q/k/v and ff/wi,
    t_block) split `out`, row-parallel ones (wo, w2, fc2, T5's o and ff/wo)
    split `in`, and the column-parallel biases (and the int8 `w_scale`)
    follow `out`. Everything else, the int4 `w4` / `w4_scale` included,
    stays whole on every rank.
  * `shard_params` keeps each rank's slice of a leaf; a leaf whose matched
    dimension does not divide by tp stays whole, as in JAX.
  * `shard_batch` keeps the rank's contiguous block of rows over "dp".
  * `init_distributed` starts the default process group from torchrun's
    environment or explicit flags, with the backend chosen from the
    topology (NCCL when every local rank has a card of its own, gloo on the
    CPU or when ranks share a card).

Where JAX derives every collective from these shardings, the port writes
them out: parallel/comm.py holds them, and the model code calls them where a
sharded leaf meets a whole activation.
"""

from __future__ import annotations

import itertools
import math
import os
import re
import sys
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from sam_audio_tpu_torch.utils import tree_map, tree_map_with_path


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """Ranks 0 .. prod(axes) - 1 of the default group as a named grid.

    `axes` maps axis names to sizes, outermost first ({"dp": 2, "tp": 2};
    {"sp": 4} for the sequence-parallel trunk). Every rank of the world must
    build the same meshes in the same order (process groups are created
    collectively). `shape[name]` is an axis' size, `index[name]` this rank's
    coordinate on it, `group(name)` the process group along it (None when
    the size is 1 or this rank lies outside the mesh)."""

    def __init__(self, axes: Dict[str, int]):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)
        sizes = [self.shape[a] for a in self.axis_names]
        self.size = math.prod(sizes)
        rank, world = _world()
        if self.size > world:
            raise ValueError(f"mesh {self.shape} needs {self.size} ranks, have {world}")
        self.rank = rank
        coords = list(itertools.product(*[range(s) for s in sizes]))
        self.index = dict(zip(self.axis_names, coords[rank])) if rank < self.size else {}
        self._groups: Dict[str, Optional[dist.ProcessGroup]] = {}
        for ax, name in enumerate(self.axis_names):
            if self.shape[name] == 1:
                self._groups[name] = None
                continue
            # every line along this axis: created by every rank, in one order
            others = [range(s) if i != ax else [0] for i, s in enumerate(sizes)]
            mine = None
            for base in itertools.product(*others):
                ranks = []
                for j in range(sizes[ax]):
                    c = list(base)
                    c[ax] = j
                    ranks.append(coords.index(tuple(c)))
                g = dist.new_group(ranks)
                if rank in ranks:
                    mine = g
            self._groups[name] = mine

    def group(self, name: str) -> Optional[dist.ProcessGroup]:
        return self._groups.get(name)

    def axis_size(self, name: str) -> int:
        return self.shape.get(name, 1)

    def axis_index(self, name: str) -> int:
        return self.index.get(name, 0)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, index={self.index})"


def make_mesh(dp: Optional[int] = None, tp: int = 1) -> Mesh:
    """A (dp, tp) mesh over the ranks of the default group (one rank
    without torch.distributed). dp defaults to world // tp."""
    _, n = _world()
    if dp is None:
        dp = n // tp
    if dp < 1 or tp < 1:
        raise ValueError(
            f"make_mesh: a {dp}x{tp} (dp x tp) mesh is impossible with {n} "
            f"device(s) — tp must be <= the device count (and >= 1).")
    if dp * tp > n:
        raise AssertionError(f"mesh {dp}x{tp} needs {dp * tp} devices, have {n}")
    return Mesh({"dp": dp, "tp": tp})


# Megatron-style tensor-parallel rules: JAX's regexes (parallel/mesh.py:54-76),
# matched against "/"-joined parameter paths of torch-layout (out, in)
# weights, possibly with a leading stacked-layer axis.
_COLUMN_PARALLEL = re.compile(
    r"(attention|cross_attention|attn)/(wq|wk|wv|q|k|v)/(weight|w8)$"
    r"|feed_forward/(w1|w3)/(weight|w8)$"
    r"|mlp/(fc1|w1|w3)/(weight|w8)$"
    r"|ff/wi/weight$"
    r"|t_block/weight$"
)
_ROW_PARALLEL = re.compile(
    r"(attention|cross_attention|attn)/(wo|o)/(weight|w8)$"
    r"|feed_forward/w2/(weight|w8)$"
    r"|mlp/(fc2|w2)/(weight|w8)$"
    r"|ff/wo/weight$"
)
_COLUMN_BIAS = re.compile(
    r"(attention|cross_attention|attn)/(wq|wk|wv)/(bias|w_scale)$"
    r"|feed_forward/(w1|w3)/(bias|w_scale)$"
    r"|mlp/(fc1|w1|w3)/(bias|w_scale)$"
    r"|t_block/bias$"
)


def param_partition_spec(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    """JAX's PartitionSpec for a parameter at `path` with `ndim` dims, as a
    tuple: "tp" names the split dimension. Stacked layer axes lead and are
    never split."""
    if _COLUMN_PARALLEL.search(path):
        return (None,) * (ndim - 2) + ("tp", None)
    if _ROW_PARALLEL.search(path):
        return (None,) * (ndim - 2) + (None, "tp")
    if _COLUMN_BIAS.search(path):
        return (None,) * (ndim - 1) + ("tp",)
    return (None,) * ndim


def params_pspec_tree(params):
    """Tree of partition specs matching `params`."""
    return tree_map_with_path(lambda path, x: param_partition_spec(path, x.ndim), params)


def shard_dim(path: str, shape, mesh: Mesh) -> Optional[int]:
    """The dimension of a leaf of the full `shape` that `mesh` splits over
    "tp", or None when it stays whole (no rule, tp = 1, or a matched
    dimension that does not divide, as JAX's shard_params falls back)."""
    tp = mesh.axis_size("tp")
    if tp == 1:
        return None
    spec = param_partition_spec(path, len(shape))
    if "tp" not in spec:
        return None
    d = spec.index("tp")
    return d if shape[d] % tp == 0 else None


def shard_dims(params, mesh: Mesh) -> Dict[str, Optional[int]]:
    """{path: shard_dim} for every leaf of the full tree `params`."""
    out = {}
    tree_map_with_path(lambda path, x: out.__setitem__(path, shard_dim(path, x.shape, mesh)),
                       params)
    return out


def take_shard(x: torch.Tensor, dim: Optional[int], mesh: Mesh) -> torch.Tensor:
    """This rank's tp block of a full leaf along `dim` (a copy, so the full
    tensor's storage can be freed), or the leaf itself when dim is None."""
    if dim is None:
        return x
    return x.chunk(mesh.axis_size("tp"), dim)[mesh.axis_index("tp")].clone()


def shard_params(params, mesh: Mesh):
    """This rank's slices of the full tree `params` by the tp rules
    (the whole tree when tp = 1)."""
    return tree_map_with_path(
        lambda path, x: take_shard(x, shard_dim(path, x.shape, mesh), mesh), params)


def dp_block(n: int, mesh: Mesh) -> slice:
    """The rows of a global batch of `n` that this rank's dp index holds."""
    dp = mesh.axis_size("dp")
    if n % dp:
        raise ValueError(f"a batch of {n} rows does not divide over dp={dp}")
    per = n // dp
    return slice(mesh.axis_index("dp") * per, (mesh.axis_index("dp") + 1) * per)


def shard_batch(batch, mesh: Mesh, process_local: bool = False):
    """Each leaf's block of rows over "dp" (a view).

    `process_local=True` is JAX's multi-process case: each dp group read
    its own rows (train/records.py, one record subset per dp index), so the
    local leaves already are its block of the global batch, which
    concatenates them in dp order, and are returned as they are."""
    if process_local or mesh.axis_size("dp") == 1:
        return batch
    return tree_map(lambda x: x[dp_block(x.shape[0], mesh)], batch)


def process_allgather(tree):
    """Every process's value of each leaf stacked on a new leading axis, as
    numpy arrays (JAX's multihost_utils.process_allgather; the reference's
    all_gather_object, eval/main.py:24-27). One process: a leading axis of
    1."""
    import numpy as np

    _, world = _world()
    local = tree_map(lambda x: np.asarray(x.detach().cpu() if torch.is_tensor(x) else x),
                     tree)
    if world == 1:
        return tree_map(lambda x: x[None], local)
    gathered = [None] * world
    dist.all_gather_object(gathered, local)
    leaves = [[] for _ in range(world)]
    for r in range(world):
        tree_map(leaves[r].append, gathered[r])
    stacked = iter([np.stack(col) for col in zip(*leaves)])
    return tree_map(lambda _: next(stacked), local)


def init_distributed(device="cuda", coordinator: Optional[str] = None,
                     num_processes: int = 0, process_id: int = -1) -> torch.device:
    """Join the default process group and return this rank's device.

    The world comes from `coordinator` ("host:port") with `num_processes`
    and `process_id` (processes of one host: process_id is the local rank),
    else from torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT); a world of one starts no
    group unless `coordinator` asks for one. The backend follows
    the topology, never an error:

      * NCCL when `device` is CUDA and this host's ranks fit its visible
        cards: rank -> cuda:LOCAL_RANK;
      * gloo on the CPU;
      * gloo when ranks share a card (more local ranks than cards: one card
        serves several ranks, and NCCL refuses two ranks of one
        communicator on one device); rank -> cuda:(LOCAL_RANK % cards).
        parallel/comm.py stages CUDA tensors through host memory for it.

    Rank 0 prints the choice once on stderr. If the backend cannot start,
    the process fails."""
    import datetime

    dev = torch.device(device)
    if coordinator:
        if num_processes < 1 or process_id < 0:
            raise ValueError("--coordinator needs --num-processes and --process-id")
        world, rank = num_processes, process_id
        local_rank, local_world = process_id, num_processes
        init_method = f"tcp://{coordinator}"
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        rank = int(os.environ.get("RANK", "0"))
        local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        init_method = "env://"
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda requested and no CUDA device is available")
        cards = torch.cuda.device_count()
        backend = "nccl" if local_world <= cards else "gloo"
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    else:
        backend, cards = "gloo", 0
    if dist.is_initialized() or (world == 1 and not coordinator):
        return dev
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(minutes=10))
    if rank == 0:
        why = ("the CPU" if dev.type == "cpu" else
               f"{local_world} local ranks on {cards} card(s)")
        print(f"torch.distributed: backend {backend} for {world} ranks ({why})",
              file=sys.stderr)
    return dev
