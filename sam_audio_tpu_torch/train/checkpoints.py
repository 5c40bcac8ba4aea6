"""Rolling training checkpoints with retention; counterpart of
sam_audio_tpu/train/checkpoints.py, with torch files in orbax's place.

Each step is a directory `<dir>/<step>/` holding the TrainState:

    params.pt      {path: tensor} of every parameter leaf
    optimizer.pt   the AdamW's state_dict (moments and counts)
    ema.pt         {path: tensor} of the EMA's trainable leaves (if tracked)
    state.pt       {"step", "accum", "generators": {name: generator state}}

A step is written into `<step>.tmp/` and renamed, so a crash never leaves a
half-written step behind. Retention is orbax's (CheckpointManager with
`max_to_keep`, `keep_period` and `save_interval_steps`): a step is saved
when it is past the latest one and a multiple of the interval, or when none
is saved yet, or when forced; after a save, a step survives when it is among
the `max_to_keep` most recently saved or a multiple of `keep_period`; the
latest step is the one saved last. The
cross-format artifacts, which the JAX package reads, are the exported
snapshot (train/export.py) and the LoRA npz (train/lora.py); these
checkpoints are the port's own.

On a (dp, tp) mesh (TrainState.mesh) every tensor is saved whole: the
blocks are gathered over tp on every rank and global rank 0 writes. A
restore slices the whole tensors for the live mesh, which may differ from
the one that saved (orbax's resharding restore): a step written at dp2 x tp2
resumes at tp1 or at dp1 x tp4.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional

import torch
import torch.distributed as dist

from sam_audio_tpu_torch.parallel import comm
from sam_audio_tpu_torch.parallel.mesh import take_shard
from sam_audio_tpu_torch.train.flow_matching import TrainState, gather_params
from sam_audio_tpu_torch.utils import tree_leaves_with_path


def _multi_rank() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _writer() -> bool:
    return not _multi_rank() or dist.get_rank() == 0


def _barrier() -> None:
    if _multi_rank():
        dist.barrier()


def _trainable_paths(state: TrainState):
    return [path for path, p in tree_leaves_with_path(state.params) if p.requires_grad]


def _optimizer_state(state: TrainState):
    """The AdamW's state_dict with the moments of split leaves whole."""
    sd = state.optimizer.state_dict()
    if state.mesh is None:
        return sd
    group = state.mesh.group("tp")
    for i, path in enumerate(_trainable_paths(state)):
        d = state.shard_dims.get(path)
        if d is None or i not in sd["state"]:
            continue
        sd["state"][i] = {k: (comm.gather(v, d, group) if torch.is_tensor(v) and v.ndim else v)
                          for k, v in sd["state"][i].items()}
    return sd


def _flat(tree, trainable_only: bool = False, like=None):
    """{path: tensor} of a tree's leaves (of the leaves trainable in `like`
    when `trainable_only`), detached."""
    leaves = tree_leaves_with_path(tree)
    if trainable_only:
        keep = {path for path, p in tree_leaves_with_path(like) if p.requires_grad}
        leaves = [(path, x) for path, x in leaves if path in keep]
    return {path: x.detach() for path, x in leaves}


class TrainCheckpointManager:
    """Rolling TrainState checkpoints under `directory/<step>/`."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3,
                 keep_period: Optional[int] = None, save_interval_steps: int = 1):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.keep_period = keep_period
        self.save_interval_steps = save_interval_steps
        os.makedirs(self.directory, exist_ok=True)
        # saved steps in the order they were saved (on disk: sorted), as
        # orbax's LatestN counts them
        self._steps: List[int] = sorted(
            int(name) for name in os.listdir(self.directory) if name.isdigit())

    # -- write ---------------------------------------------------------------

    def should_save(self, step: int) -> bool:
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return not self._steps or step % self.save_interval_steps == 0

    def save(self, state: TrainState, force: bool = False) -> bool:
        """Save at state.step (subject to the interval unless forced).
        Returns True if a checkpoint was written. A step already on disk is
        skipped even when forced."""
        step = int(state.step)
        if step in self._steps or (not force and not self.should_save(step)):
            return False
        final = os.path.join(self.directory, str(step))
        tmp = final + ".tmp"
        # every rank takes part in the gathers; global rank 0 writes
        params = _flat(gather_params(state.params, state.mesh, state.shard_dims))
        optimizer = _optimizer_state(state)
        ema = None
        if state.ema_params is not None:
            ema = _flat(gather_params(state.ema_params, state.mesh, state.shard_dims), True,
                        state.params)
        accum = state.accum
        if accum is not None and state.mesh is not None:
            dims = [state.shard_dims.get(p) for p in _trainable_paths(state)]
            accum = [x if d is None else comm.gather(x, d, state.mesh.group("tp"))
                     for x, d in zip(accum, dims)]
        if _writer():
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(params, os.path.join(tmp, "params.pt"))
            torch.save(optimizer, os.path.join(tmp, "optimizer.pt"))
            if ema is not None:
                torch.save(ema, os.path.join(tmp, "ema.pt"))
            torch.save({"step": step, "accum": accum,
                        "generators": {k: g.get_state() for k, g in state.generators.items()}},
                       os.path.join(tmp, "state.pt"))
            os.replace(tmp, final)
        self._steps.append(step)
        self._remove_old()
        _barrier()
        return True

    def _remove_old(self) -> None:
        n = len(self._steps)
        keep = self.max_to_keep
        for i, step in enumerate(list(self._steps)):
            latest = keep is None or i >= n - keep
            periodic = self.keep_period is not None and step % self.keep_period == 0
            if not (latest or periodic):
                if _writer():
                    shutil.rmtree(os.path.join(self.directory, str(step)))
                self._steps.remove(step)

    # -- read ----------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        """The step saved last (orbax's: after a forced save of an earlier
        step, that step)."""
        return self._steps[-1] if self._steps else None

    def all_steps(self):
        return sorted(self._steps)

    def restore(self, template: TrainState, step: Optional[int] = None) -> TrainState:
        """Restore into `template` in place (a freshly built TrainState of the
        live trainer: its tensors keep their devices and the optimizer its
        parameter references) and return it. On a mesh each rank takes its
        blocks of the whole saved tensors."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoints found")
        root = os.path.join(self.directory, str(step))

        def load(name):
            return torch.load(os.path.join(root, name), map_location="cpu",
                              weights_only=True, mmap=True)

        mesh = template.mesh

        def local(path, x):
            if mesh is None:
                return x
            return take_shard(x, template.shard_dims.get(path), mesh)

        def copy_into(tree, saved, trainable_only=False):
            live = _flat(tree, trainable_only, template.params)
            if set(live) != set(saved):
                raise ValueError(f"checkpoint {root} holds other leaves than the trainer")
            with torch.no_grad():
                for path, x in live.items():
                    x.copy_(local(path, saved[path]))

        copy_into(template.params, load("params.pt"))
        paths = _trainable_paths(template)
        optimizer = load("optimizer.pt")
        for i, st in optimizer["state"].items():
            optimizer["state"][i] = {k: (local(paths[i], v) if torch.is_tensor(v) and v.ndim
                                         else v) for k, v in st.items()}
        template.optimizer.load_state_dict(optimizer)
        if template.ema_params is not None:
            copy_into(template.ema_params, load("ema.pt"), trainable_only=True)
        meta = load("state.pt")
        template.step = int(meta["step"])
        if template.accum is not None:
            for path, live, saved in zip(paths, template.accum, meta["accum"]):
                live.copy_(local(path, saved))
        for name, g in template.generators.items():
            g.set_state(meta["generators"][name])
        return template
