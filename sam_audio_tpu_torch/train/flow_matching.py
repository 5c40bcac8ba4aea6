"""Conditional flow-matching training for SAMAudio; counterpart of
sam_audio_tpu/train/flow_matching.py.

The objective (rectified flow / CFM, matching the reference's midpoint
sampler from noise at t=0 to data at t=1):

    x_t = (1 - t) * x0 + t * x1,   x0 ~ N(0, I),  x1 = [target || residual]
    loss = || v_theta(x_t, t, cond) - (x1 - x0) ||^2     (masked mean)

The optimizer is JAX's `optax.chain(clip_by_global_norm, adamw)` (optionally
inside `optax.MultiSteps`) written over `torch.optim.AdamW`, with optax's
semantics where torch's defaults differ:

  * the schedule is read at the optimizer-step count before its increment,
    so a warmup's first step has lr 0 (`make_lr_schedule`);
  * gradients are clipped by their global norm only when it is at least
    `grad_clip`, by `grad_clip / norm`, with no epsilon (not
    `clip_grad_norm_`);
  * frozen leaves (codec, T5) are not in the optimizer: no update and no
    weight decay; a trainable leaf that gets no gradient (the video
    alignment without video) gets a zero one, so that weight decay still
    shrinks it as optax's does;
  * `grad_norm` is the micro-step gradient's norm before clipping;
  * `accum_steps = k` applies the running mean of k micro-gradients every k
    calls (`optax.MultiSteps`): `state.step` counts micro-steps, the
    schedule counts optimizer steps;
  * the EMA holds copies of the trainable leaves, updated every micro-step.

The trainer holds fp32 master parameters (models.init.sam_audio_init or
checkpoint.load_params, not `SAMAudio.params`, whose matmul weights are
stored in the compute dtype) and computes in `cfg.compute_dtype`. Its
randomness comes from explicit generators: t and x0 from one on the
device, the dropout sites' seeds from one on the CPU (models/dit.py), both
in the TrainState so that a checkpoint resumes them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from sam_audio_tpu_torch.config import SAMAudioConfig
from sam_audio_tpu_torch.models.sam_audio import DTYPES, forward, resolve_device
from sam_audio_tpu_torch.parallel import comm
from sam_audio_tpu_torch.parallel.mesh import dp_block, shard_batch, shard_dims, shard_params
from sam_audio_tpu_torch.utils import tree_leaves_with_path, tree_map, tree_map_with_path

DEFAULT_FROZEN_PREFIXES = ("audio_codec", "text_encoder")


def flow_matching_loss(params, cfg: SAMAudioConfig, batch: Dict[str, Any],
                       generator: Optional[torch.Generator] = None, *,
                       t: Optional[torch.Tensor] = None, x0: Optional[torch.Tensor] = None,
                       remat="full", dropout_generator: Optional[torch.Generator] = None,
                       dp_group=None):
    """The masked flow-matching loss (a scalar tensor).

    t (B,) and x0 (B, T, 2C) are drawn from `generator` (on the batch's
    device) unless given (a test passes JAX's draws). `remat`: None, "full"
    or "dots" (models/dit.dit_apply). `dropout_generator` turns dropout on
    when `cfg.transformer.dropout > 0`.

    `dp_group`: `batch` is this rank's block of a global batch split over
    the group; the mask's count is then the global one, so that the sum of
    the ranks' losses (and of their gradients) is the global batch's.

    batch keys: audio_features (B,T,2C), target_latents (B,T,2C) =
    [target || residual], text_features (B,L,text_dim), text_mask (B,L),
    anchor_ids (B,A), anchor_alignment (B,T), audio_pad_mask (B,T),
    masked_video_features optional (B,vision_dim,T)."""
    x1 = batch["target_latents"].float()
    b = x1.shape[0]
    if t is None:
        t = torch.rand((b,), generator=generator, device=x1.device)
    if x0 is None:
        x0 = torch.randn(x1.shape, generator=generator, device=x1.device)
    tt = t[:, None, None]
    xt = (1.0 - tt) * x0 + tt * x1
    v_target = x1 - x0
    v_pred = forward(
        params, cfg,
        noisy_audio=xt,
        audio_features=batch["audio_features"],
        text_features=batch["text_features"],
        time=t,
        masked_video_features=batch.get("masked_video_features"),
        text_mask=batch["text_mask"],
        anchor_ids=batch["anchor_ids"],
        anchor_alignment=batch["anchor_alignment"],
        audio_pad_mask=batch["audio_pad_mask"],
        compute_dtype=DTYPES[cfg.compute_dtype],
        remat=remat,
        dropout_generator=dropout_generator if cfg.transformer.dropout > 0 else None,
    ).float()
    err = torch.square(v_pred - v_target)
    mask = batch["audio_pad_mask"][:, :, None].float()
    count = comm.all_reduce(torch.sum(mask) * err.shape[-1], dp_group)
    return torch.sum(err * mask) / torch.clamp(count, min=1.0)


# ---------------------------------------------------------------------------
# Learning-rate schedules with optax's semantics (optax/schedules)
# ---------------------------------------------------------------------------


def _linear_schedule(init: float, end: float, steps: int) -> Callable[[int], float]:
    def schedule(count):
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return schedule


def _cosine_schedule(init: float, decay_steps: int, alpha: float) -> Callable[[int], float]:
    def schedule(count):
        decay = 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
        return init * ((1.0 - alpha) * decay + alpha)
    return schedule


def _join_schedules(schedules, boundaries) -> Callable[[int], float]:
    def schedule(count):
        out = schedules[0](count)
        for boundary, fn in zip(boundaries, schedules[1:]):
            out = out if count < boundary else fn(count - boundary)
        return out
    return schedule


def make_lr_schedule(learning_rate: float, schedule: str = "constant",
                     warmup_steps: int = 0, total_steps: int = 0,
                     final_lr_ratio: float = 0.0) -> Union[float, Callable[[int], float]]:
    """Warmup + decay, as JAX's make_lr_schedule builds it from optax's
    linear_schedule, cosine_decay_schedule(alpha=final_lr_ratio) and
    join_schedules. `schedule`: constant | cosine | linear. Returns the
    plain float for a constant rate without warmup, else count -> lr, read
    at the optimizer-step count before its increment."""
    if schedule == "constant" and warmup_steps == 0:
        return learning_rate
    decay_steps = max(total_steps - warmup_steps, 1)
    end = learning_rate * final_lr_ratio
    if schedule == "constant":
        main = lambda count: learning_rate  # noqa: E731
    elif schedule == "cosine":
        main = _cosine_schedule(learning_rate, decay_steps, final_lr_ratio)
    elif schedule == "linear":
        main = _linear_schedule(learning_rate, end, decay_steps)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    if warmup_steps == 0:
        return main
    warmup = _linear_schedule(0.0, learning_rate, warmup_steps)
    return _join_schedules([warmup, main], [warmup_steps])


# ---------------------------------------------------------------------------
# Train state and the optimizer step
# ---------------------------------------------------------------------------


@dataclass
class TrainState:
    """What a step reads and writes, and what a checkpoint holds.

    `params`: the parameter tree (fp32 master copy; trainable leaves require
    grad, frozen ones do not). `optimizer`: the torch.optim.AdamW over the
    trainable leaves, in tree order (its state: Adam's moments and count).
    `step`: micro-steps taken (JAX's state.step). `ema_params`: the tree
    with the trainable leaves replaced by their EMA, or None. `accum`: the
    running mean of the micro-gradients (accum_steps > 1). `generators`:
    the step's random sources by name. `mesh` and `shard_dims` ({path:
    the dimension split over tp, or None}; parallel/mesh.py): the leaves
    are this rank's blocks (every rank holds the same generators)."""

    params: Any
    optimizer: torch.optim.Optimizer
    step: int = 0
    ema_params: Any = None
    accum: Optional[List[torch.Tensor]] = None
    generators: Dict[str, torch.Generator] = field(default_factory=dict)
    mesh: Any = None
    shard_dims: Dict[str, Optional[int]] = field(default_factory=dict)

    @property
    def trainable(self) -> List[torch.Tensor]:
        return self.optimizer.param_groups[0]["params"]


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


def _trainable_paths(params, trainable_filter) -> List[str]:
    return [path for path, leaf in tree_leaves_with_path(params) if trainable_filter(path)]


def new_train_state(params, trainable_filter, *, weight_decay: float, ema_decay: float,
                    accum_steps: int, generators: Dict[str, torch.Generator]) -> TrainState:
    """Mark the trainable leaves (fp32; they must be) as requiring grad and
    the rest as not, and build the AdamW over the former, the EMA copies
    and the accumulation buffers."""
    trainable = []
    for path, leaf in tree_leaves_with_path(params):
        train = trainable_filter(path)
        if train and leaf.dtype != torch.float32:
            raise ValueError(
                f"trainable leaf {path} is {leaf.dtype}: the trainer takes fp32 master "
                "parameters (models.init.sam_audio_init or checkpoint.load_params), not "
                "SAMAudio.params, whose matmul weights are stored in the compute dtype")
        leaf.requires_grad_(train)
        if train:
            trainable.append(leaf)
    if not trainable:
        raise ValueError("no trainable parameters")
    optimizer = torch.optim.AdamW(trainable, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=weight_decay)
    ema = None
    if ema_decay > 0.0:
        # real copies of the trainable leaves; frozen leaves alias the live ones
        ema = tree_map(lambda x: x.detach().clone() if x.requires_grad else x, params)
    accum = ([torch.zeros_like(p) for p in trainable] if accum_steps > 1 else None)
    return TrainState(params, optimizer, 0, ema, accum, generators)


class GradSync:
    """The collectives of a step on a (dp, tp) mesh: the micro-gradients are
    summed over dp (each rank's loss is its share of the global mean, see
    flow_matching_loss), the leaves flagged in `tp_sum` are summed over tp
    (LoRA's whole adapters of split leaves, train/lora.py), and the global
    norm sums the squares of split leaves over tp and counts whole leaves
    once."""

    def __init__(self, mesh, split: List[bool], tp_sum: Optional[List[bool]] = None):
        self.dp = mesh.group("dp")
        self.tp = mesh.group("tp")
        self.split = split
        self.tp_sum = tp_sum or [False] * len(split)

    def grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The summed gradients, replacing `grads`' items one at a time (the
        list holds the only references: one extra leaf at a time)."""
        for i, tp_sum in enumerate(self.tp_sum):
            grads[i] = comm.all_reduce(grads[i], self.dp)
            if tp_sum:
                grads[i] = comm.all_reduce(grads[i], self.tp)
        return grads

    def norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        sq = [torch.sum(torch.square(g.float())) for g in grads]
        zero = torch.zeros((), device=grads[0].device)
        split = sum((x for x, s in zip(sq, self.split) if s), zero)
        whole = sum((x for x, s in zip(sq, self.split) if not s), zero)
        return torch.sqrt(whole + comm.all_reduce(split, self.tp))


def _ema_leaves(state: TrainState) -> List[torch.Tensor]:
    return [e for (_, e), (_, p) in zip(tree_leaves_with_path(state.ema_params),
                                        tree_leaves_with_path(state.params))
            if p.requires_grad]


def apply_step(state: TrainState, loss_fn: Callable[[], tuple], *, grad_clip: float,
               lr_schedule, accum_steps: int = 1, ema_decay: float = 0.0,
               sync: Optional[GradSync] = None) -> Dict[str, Any]:
    """One micro-step: `loss_fn()` -> (loss, extra metrics); the gradient of
    the loss for the trainable leaves; then (every `accum_steps` calls, on
    the running mean) clip, AdamW at the schedule's rate, and the EMA.
    `sync`: the collectives of a sharded step. Returns {"loss",
    "grad_norm", **extra} as tensors (no device sync)."""
    leaves = state.trainable
    loss, extra = loss_fn()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
    norm_fn = global_norm
    if sync is not None:
        grads = sync.grads(grads)
        loss = comm.all_reduce(loss.detach(), sync.dp)
        norm_fn = sync.norm
    gnorm = norm_fn(grads)
    n = state.step % accum_steps
    if accum_steps > 1:
        for acc, g in zip(state.accum, grads):   # optax.MultiSteps' running mean
            acc.add_((g - acc) / (n + 1))
        grads = state.accum
    if n == accum_steps - 1:
        norm = gnorm if accum_steps == 1 else norm_fn(grads)
        scale = torch.where(norm < grad_clip, torch.ones_like(norm), grad_clip / norm)
        torch._foreach_mul_(grads, scale)
        count = state.step // accum_steps
        lr = lr_schedule(count) if callable(lr_schedule) else lr_schedule
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        for p, g in zip(leaves, grads):
            p.grad = g
        state.optimizer.step()
        for p in leaves:
            p.grad = None
        if accum_steps > 1:
            for acc in state.accum:
                acc.zero_()
    state.step += 1
    if ema_decay > 0.0 and state.ema_params is not None:
        ema = _ema_leaves(state)
        with torch.no_grad():
            torch._foreach_mul_(ema, ema_decay)
            torch._foreach_add_(ema, [p.detach() for p in leaves], alpha=1.0 - ema_decay)
    return {"loss": loss.detach(), "grad_norm": gnorm, **extra}


def ema_tree(state: TrainState):
    """The EMA where tracked, the live params elsewhere, cast back to the
    live params' dtypes and detached (inference weights)."""
    if state.ema_params is None:
        return tree_map(lambda p: p.detach(), state.params)
    flat = dict(tree_leaves_with_path(state.params))
    return tree_map_with_path(lambda path, e: e.detach().to(flat[path].dtype), state.ema_params)


def draw_noise(state: TrainState, batch, t=None, x0=None, local_batch: bool = False):
    """(batch, t, x0) of this rank. t and x0 are drawn for the global batch
    from `state.generators["noise"]` (the same on every rank) unless given,
    then every rank keeps its dp block of them and of the batch
    (`local_batch`: `batch` already is that block, parallel/mesh.shard_batch),
    so that a dp run draws what one card draws for the same batch."""
    x1 = batch["target_latents"]
    mesh = state.mesh
    dp = 1 if mesh is None else mesh.axis_size("dp")
    n = x1.shape[0] * (dp if local_batch else 1)
    gen = state.generators.get("noise")
    if t is None:
        t = torch.rand((n,), generator=gen, device=x1.device)
    if x0 is None:
        x0 = torch.randn((n, *x1.shape[1:]), generator=gen, device=x1.device)
    if dp == 1:
        return batch, t, x0
    rows = dp_block(n, mesh)
    return shard_batch(batch, mesh, process_local=local_batch), t[rows], x0[rows]


def make_train_step(cfg: SAMAudioConfig, *, grad_clip: float = 1.0, lr_schedule=1e-4,
                    accum_steps: int = 1, ema_decay: float = 0.0, remat="full",
                    sync: Optional[GradSync] = None, local_batch: bool = False):
    """Returns train_step(state, batch, t=None, x0=None) -> metrics: the
    flow-matching loss of `state.params` with t and x0 from
    `state.generators["noise"]` (unless given; draw_noise) and dropout
    seeded from `state.generators["dropout"]`, then `apply_step`. On a mesh
    (`state.mesh`, with `sync`) the step runs inside its tensor-parallel
    group on this rank's dp block."""

    def train_step(state: TrainState, batch, t=None, x0=None):
        batch, t, x0 = draw_noise(state, batch, t, x0, local_batch)
        dp_group = None if state.mesh is None else state.mesh.group("dp")

        def loss_fn():
            loss = flow_matching_loss(state.params, cfg, batch, t=t, x0=x0, remat=remat,
                                      dropout_generator=state.generators.get("dropout"),
                                      dp_group=dp_group)
            return loss, {}

        with comm.use_tp(None if state.mesh is None else state.mesh.group("tp")):
            return apply_step(state, loss_fn, grad_clip=grad_clip, lr_schedule=lr_schedule,
                              accum_steps=accum_steps, ema_decay=ema_decay, sync=sync)

    return train_step


def default_generators(device, seed: int) -> Dict[str, torch.Generator]:
    """t and x0 on `device`; the dropout sites' seeds on the CPU."""
    return {"noise": torch.Generator(device=device).manual_seed(seed),
            "dropout": torch.Generator().manual_seed(seed + 1)}


class Trainer:
    """Flow-matching trainer on one card or a (dp, tp) mesh of ranks.

    `params`: the full fp32 tree (trainable + frozen towers); the trainer
    keeps its storage (no copy) on `device`. `trainable_filter(path)` freezes the
    leaves where it returns False (default: the codec and the text encoder,
    whose features the data pipeline computes outside the loss).

    `mesh` (parallel.mesh.make_mesh): the params, the AdamW state and the
    EMA hold this rank's tp blocks (JAX's rules), every rank passes the same
    global batch to `step` and trains on its dp block (`local_batches`: each
    dp group passes its own block, as JAX's processes do), the gradients
    and the loss are the global batch's, and the clip uses the global
    norm. A dp x tp run takes the single card's steps."""

    def __init__(self, cfg: SAMAudioConfig, params, *, mesh=None, local_batches: bool = False,
                 device="cuda",
                 learning_rate: float = 1e-4, weight_decay: float = 0.01,
                 grad_clip: float = 1.0, trainable_filter=None,
                 lr_schedule: str = "constant", warmup_steps: int = 0,
                 total_steps: int = 0, final_lr_ratio: float = 0.0,
                 ema_decay: float = 0.0, accum_steps: int = 1, remat="full",
                 seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        if trainable_filter is None:
            def trainable_filter(path: str) -> bool:
                return not path.startswith(DEFAULT_FROZEN_PREFIXES)
        self._trainable_filter = trainable_filter
        self.mesh = mesh
        params = tree_map(lambda x: x.detach().to(self.device), params)
        dims = {} if mesh is None else shard_dims(params, mesh)
        if mesh is not None:
            params = shard_params(params, mesh)
        self.state = new_train_state(
            params, trainable_filter, weight_decay=weight_decay, ema_decay=ema_decay,
            accum_steps=accum_steps, generators=default_generators(self.device, seed))
        self.state.mesh, self.state.shard_dims = mesh, dims
        sync = None
        if mesh is not None:
            sync = GradSync(mesh, [dims[p] is not None
                                   for p in _trainable_paths(params, trainable_filter)])
        self._step = make_train_step(
            cfg, grad_clip=grad_clip,
            lr_schedule=make_lr_schedule(learning_rate, lr_schedule, warmup_steps,
                                         total_steps, final_lr_ratio),
            accum_steps=accum_steps, ema_decay=ema_decay, remat=remat, sync=sync,
            local_batch=local_batches)

    def step(self, batch, t=None, x0=None) -> Dict[str, torch.Tensor]:
        """One micro-step on `batch` (tensors on the trainer's device; on a
        mesh the global batch, and t / x0 when given are the global ones)."""
        return self._step(self.state, batch, t=t, x0=x0)

    def ema_inference_params(self):
        """Params for evaluation and export: EMA where tracked, live
        elsewhere, cast back to the live params' dtypes (on a mesh, this
        rank's blocks; full_params joins them)."""
        return ema_tree(self.state)

    def full_params(self, tree=None):
        """The whole tree (default: the live params) from this rank's blocks,
        gathered over tp on every rank."""
        return gather_params(self.state.params if tree is None else tree, self.mesh,
                             self.state.shard_dims)

    def fit(self, batches, *, eval_fn=None, eval_every: int = 0,
            log_every: int = 50, log_fn=print):
        """Drive training over an iterable of batches. `eval_fn(trainer,
        step)` runs every `eval_every` steps (and once at the end); its dict
        result is merged into the step metrics history returned."""
        history = []
        for i, batch in enumerate(batches):
            metrics = self.step(batch)
            step = int(self.state.step)
            if log_every and (i % log_every == 0):
                log_fn(f"step {step}: loss={float(metrics['loss']):.4f} "
                       f"grad_norm={float(metrics['grad_norm']):.3f}")
            rec = {"step": step, "loss": float(metrics["loss"])}
            if eval_fn is not None and eval_every and step % eval_every == 0:
                rec.update(eval_fn(self, step) or {})
            history.append(rec)
        if eval_fn is not None and history and (
                not eval_every or history[-1]["step"] % eval_every != 0):
            history[-1].update(eval_fn(self, int(self.state.step)) or {})
        return history


def gather_params(tree, mesh, shard_dims: Dict[str, Optional[int]]):
    """The whole leaves of a tree of this rank's tp blocks (split along
    `shard_dims[path]` on `mesh`; parallel/mesh.shard_dims), detached."""
    if mesh is None:
        return tree_map(lambda x: x.detach(), tree)
    group = mesh.group("tp")
    return tree_map_with_path(
        lambda path, x: x.detach() if shard_dims.get(path) is None
        else comm.gather(x.detach(), shard_dims[path], group), tree)


def synthetic_batch(cfg: SAMAudioConfig, generator: torch.Generator, batch_size: int = 2,
                    t_frames: int = 16, text_len: int = 8):
    """Random training batch with the right shapes (tests / dry runs), on the
    generator's device."""
    dev = generator.device
    c2 = 2 * cfg.audio_codec.codebook_dim

    def rnd(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    anchor_ids = torch.full((batch_size, 4), 3, dtype=torch.long, device=dev)
    anchor_ids[:, 0] = 0
    return {
        "audio_features": rnd(batch_size, t_frames, c2),
        "target_latents": rnd(batch_size, t_frames, c2),
        "text_features": rnd(batch_size, text_len, cfg.text_encoder.dim),
        "text_mask": torch.ones((batch_size, text_len), dtype=torch.bool, device=dev),
        "anchor_ids": anchor_ids,
        "anchor_alignment": torch.zeros((batch_size, t_frames), dtype=torch.long, device=dev),
        "audio_pad_mask": torch.ones((batch_size, t_frames), dtype=torch.bool, device=dev),
    }
