"""LoRA (low-rank adaptation) fine-tuning for SAMAudio; counterpart of
sam_audio_tpu/train/lora.py.

Every targeted weight W (out, in) is reparameterized as

    W' = W + (alpha / rank) * B @ A,   A: (rank, in),  B: (out, rank)

with only A and B trained (B zero-init, so step 0 is exactly the base
model). The optimizer state covers the adapter factors alone, and the
merged weights serve at the base model's cost.

The DiT's per-layer weights are stacked on a leading n_layers axis, as in
JAX, so the adapters are stacked too: a (L, rank, in), b (L, out, rank), and
the merge is one broadcast `b @ a` per target. `lora_merge` is a plain
function from (base, adapters) to the tree every forward accepts, and
differentiable in the adapters. Adapters are saved in JAX's npz format
(`<path>::a` / `<path>::b` keys and `__meta_*` entries), so either package
reads the other's.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from sam_audio_tpu_torch.models.sam_audio import resolve_device
from sam_audio_tpu_torch.parallel import comm
from sam_audio_tpu_torch.parallel.mesh import shard_dims, shard_params
from sam_audio_tpu_torch.train.flow_matching import (
    GradSync, Trainer, TrainState, apply_step, default_generators, draw_noise, ema_tree,
    flow_matching_loss, gather_params, make_lr_schedule, new_train_state)
from sam_audio_tpu_torch.utils import tree_leaves_with_path, tree_map, tree_map_with_path

# Attention projections in every DiT block (self + cross), the classic LoRA
# target set. Keys are path regexes over "/"-joined tree paths.
DEFAULT_TARGETS = (
    r"transformer/layers/(attention|cross_attention)/w[qkvo]/weight$",
)
# Broader preset: + SwiGLU FFN projections.
FFN_TARGETS = DEFAULT_TARGETS + (
    r"transformer/layers/feed_forward/w[123]/weight$",
)

TARGET_PRESETS = {
    "attention": DEFAULT_TARGETS,
    "attention+ffn": FFN_TARGETS,
}


def _match(patterns: Iterable[str], path: str) -> bool:
    return any(re.search(p, path) for p in patterns)


def lora_init(generator: torch.Generator, params, *, rank: int,
              targets: Iterable[str] = DEFAULT_TARGETS,
              dtype=torch.float32) -> Dict[str, Dict[str, torch.Tensor]]:
    """Adapters for every leaf whose path matches `targets`, in tree order:
    {path: {"a": (..., rank, in), "b": (..., out, rank)}}, the leading dims
    the leaf's stacked-layer axes. A is N(0, 1/rank) from `generator` (on
    the params' device), B zeros: merged == base at step 0."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    leaves = []
    for key, leaf in tree_leaves_with_path(params):
        if _match(targets, key):
            if leaf.ndim < 2:
                raise ValueError(
                    f"LoRA target {key} has ndim {leaf.ndim}; targets must be "
                    "(..., out, in) weight matrices")
            leaves.append((key, leaf))
    if not leaves:
        raise ValueError(f"no params matched LoRA targets {tuple(targets)}")
    adapters = {}
    for key, leaf in leaves:
        *stack, out, inp = leaf.shape
        a = torch.randn((*stack, rank, inp), generator=generator, device=leaf.device,
                        dtype=dtype) / np.sqrt(rank)
        adapters[key] = {"a": a, "b": torch.zeros((*stack, out, rank), dtype=dtype,
                                                  device=leaf.device)}
    return adapters


def lora_scaling(rank: int, alpha: Optional[float]) -> float:
    """alpha defaults to rank (scaling 1.0), the common convention."""
    return (alpha if alpha is not None else float(rank)) / float(rank)


def lora_merge(params, adapters: Dict[str, Dict[str, torch.Tensor]],
               scaling: float = 1.0, shard_dims: Optional[Dict[str, Optional[int]]] = None,
               group=None):
    """params with every adapted weight replaced by W + scaling * b @ a
    (broadcast over the stacked layer axes); differentiable in `adapters`.

    `shard_dims` / `group`: `params` holds this rank's tensor-parallel
    blocks (parallel/mesh.py) and the adapters are whole: a leaf split
    along `out` takes its block of b's rows, one split along `in` its block
    of a's columns."""
    hit = set()
    dims = shard_dims or {}

    def fn(key, w):
        ab = adapters.get(key)
        if ab is None:
            return w
        hit.add(key)
        a, b = ab["a"], ab["b"]
        if dims.get(key) == w.ndim - 2:
            b = comm.block(b, -2, group)
        elif dims.get(key) == w.ndim - 1:
            a = comm.block(a, -1, group)
        delta = torch.matmul(b, a)  # (..., out, in)
        return w + (scaling * delta).to(w.dtype)

    merged = tree_map_with_path(fn, params)
    missing = set(adapters) - hit
    if missing:
        raise ValueError(f"adapters with no matching param: {sorted(missing)}")
    return merged


# ---------------------------------------------------------------------------
# Adapter checkpoint format: flat npz, "<path>::a" / "<path>::b" keys.
# ---------------------------------------------------------------------------


def save_lora(path: str, adapters, *, rank: int, alpha: Optional[float] = None,
              targets: Iterable[str] = DEFAULT_TARGETS) -> None:
    arrays = {"__meta_rank": np.int64(rank),
              "__meta_alpha": np.float64(alpha if alpha is not None else rank),
              "__meta_targets": np.array(list(targets))}
    for key, ab in adapters.items():
        arrays[f"{key}::a"] = ab["a"].detach().cpu().float().numpy()
        arrays[f"{key}::b"] = ab["b"].detach().cpu().float().numpy()
    np.savez(path, **arrays)


def load_lora(path: str, device="cpu") -> Tuple[Dict[str, Dict[str, torch.Tensor]], Dict[str, Any]]:
    """Returns (adapters on `device`, meta) with meta = {rank, alpha,
    targets, scaling}."""
    with np.load(path, allow_pickle=False) as z:
        meta = {
            "rank": int(z["__meta_rank"]),
            "alpha": float(z["__meta_alpha"]),
            "targets": [str(t) for t in z["__meta_targets"]],
        }
        adapters: Dict[str, Dict[str, torch.Tensor]] = {}
        for name in z.files:
            if name.startswith("__meta"):
                continue
            key, _, part = name.rpartition("::")
            adapters.setdefault(key, {})[part] = torch.from_numpy(z[name]).to(device)
    meta["scaling"] = lora_scaling(meta["rank"], meta["alpha"])
    return adapters, meta


@torch.no_grad()
def merge_lora_checkpoint(params, lora_path: str):
    """Load adapters from `lora_path` and fold them into `params` for
    serving (the merged tree runs at the base model's cost)."""
    device = tree_leaves_with_path(params)[0][1].device
    adapters, meta = load_lora(lora_path, device)
    return lora_merge(params, adapters, meta["scaling"])


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


class LoRATrainer:
    """Flow-matching fine-tuning where only LoRA adapters train.

    Same step / fit interface as `flow_matching.Trainer`; the optimizer and
    EMA state cover the adapter factors alone. The base params stay frozen
    (fp32, no grad) and are merged into every forward.

    `mesh`: the base holds this rank's tp blocks and the adapters stay whole
    on every rank, as in JAX; each rank merges the block of b (a leaf split
    along `out`) or of a (split along `in`) that matches its block, and the
    gradients of those adapters are summed over tp so that every rank's copy
    stays the same."""

    def __init__(self, cfg, params, *, rank: int, alpha: Optional[float] = None,
                 targets: Iterable[str] | str = "attention", mesh=None,
                 local_batches: bool = False, device="cuda",
                 learning_rate: float = 1e-4, weight_decay: float = 0.0,
                 grad_clip: float = 1.0, lr_schedule: str = "constant",
                 warmup_steps: int = 0, total_steps: int = 0,
                 final_lr_ratio: float = 0.0, ema_decay: float = 0.0,
                 accum_steps: int = 1, remat="full", seed: int = 0):
        if isinstance(targets, str):
            targets = TARGET_PRESETS[targets]
        self.cfg = cfg
        self.device = resolve_device(device)
        self.rank = rank
        self.alpha = alpha
        self.targets = tuple(targets)
        self.scaling = lora_scaling(rank, alpha)
        self.mesh = mesh
        base = tree_map(lambda x: x.detach().to(self.device), params)
        adapters = lora_init(torch.Generator(device=self.device).manual_seed(seed),
                             base, rank=rank, targets=self.targets)
        self.base_dims = {} if mesh is None else shard_dims(base, mesh)
        self.base_params = base if mesh is None else shard_params(base, mesh)
        self._tp = None if mesh is None else mesh.group("tp")
        self.state: TrainState = new_train_state(
            adapters, lambda path: True, weight_decay=weight_decay, ema_decay=ema_decay,
            accum_steps=accum_steps, generators=default_generators(self.device, seed + 1))
        self.state.mesh = mesh
        sync = None
        if mesh is not None:
            split = [self.base_dims[key] is not None
                     for key in sorted(adapters) for _ in ("a", "b")]
            sync = GradSync(mesh, [False] * len(split), tp_sum=split)
        lr = make_lr_schedule(learning_rate, lr_schedule, warmup_steps, total_steps,
                              final_lr_ratio)
        scaling = self.scaling

        def train_step(state: TrainState, batch, t=None, x0=None):
            batch, t, x0 = draw_noise(state, batch, t, x0, local_batches)
            dp_group = None if mesh is None else mesh.group("dp")

            def loss_fn():
                merged = lora_merge(self.base_params, state.params, scaling,
                                    self.base_dims, self._tp)
                loss = flow_matching_loss(merged, cfg, batch, t=t, x0=x0, remat=remat,
                                          dropout_generator=state.generators["dropout"],
                                          dp_group=dp_group)
                return loss, {}

            with comm.use_tp(self._tp):
                return apply_step(state, loss_fn, grad_clip=grad_clip, lr_schedule=lr,
                                  accum_steps=accum_steps, ema_decay=ema_decay, sync=sync)

        self._step = train_step

    @property
    def adapters(self):
        return self.state.params

    def step(self, batch, t=None, x0=None) -> Dict[str, torch.Tensor]:
        return self._step(self.state, batch, t=t, x0=x0)

    def ema_adapters(self):
        return ema_tree(self.state)

    @torch.no_grad()
    def ema_inference_params(self):
        """Merged params for evaluation and serving (EMA adapters if
        tracked); on a mesh, this rank's blocks (full_params joins them)."""
        return lora_merge(self.base_params, self.ema_adapters(), self.scaling,
                          self.base_dims, self._tp)

    def full_params(self, tree=None):
        """The whole tree (default: the base) from this rank's blocks,
        gathered over tp on every rank."""
        return gather_params(self.base_params if tree is None else tree, self.mesh,
                             self.base_dims)

    def save_adapters(self, path: str) -> None:
        save_lora(path, self.ema_adapters(), rank=self.rank, alpha=self.alpha,
                  targets=self.targets)

    # fit() is the full trainer's loop.
    fit = Trainer.fit
