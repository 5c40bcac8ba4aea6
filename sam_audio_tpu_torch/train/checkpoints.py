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
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional

import torch

from sam_audio_tpu_torch.train.flow_matching import TrainState
from sam_audio_tpu_torch.utils import tree_leaves_with_path


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
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(_flat(state.params), os.path.join(tmp, "params.pt"))
        torch.save(state.optimizer.state_dict(), os.path.join(tmp, "optimizer.pt"))
        if state.ema_params is not None:
            torch.save(_flat(state.ema_params, True, state.params),
                       os.path.join(tmp, "ema.pt"))
        torch.save({"step": step, "accum": state.accum,
                    "generators": {k: g.get_state() for k, g in state.generators.items()}},
                   os.path.join(tmp, "state.pt"))
        os.replace(tmp, final)
        self._steps.append(step)
        self._remove_old()
        return True

    def _remove_old(self) -> None:
        n = len(self._steps)
        keep = self.max_to_keep
        for i, step in enumerate(list(self._steps)):
            latest = keep is None or i >= n - keep
            periodic = self.keep_period is not None and step % self.keep_period == 0
            if not (latest or periodic):
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
        parameter references) and return it."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoints found")
        root = os.path.join(self.directory, str(step))

        def load(name):
            return torch.load(os.path.join(root, name), map_location="cpu",
                              weights_only=True, mmap=True)

        def copy_into(tree, saved, trainable_only=False):
            live = _flat(tree, trainable_only, template.params)
            if set(live) != set(saved):
                raise ValueError(f"checkpoint {root} holds other leaves than the trainer")
            with torch.no_grad():
                for path, x in live.items():
                    x.copy_(saved[path])

        copy_into(template.params, load("params.pt"))
        template.optimizer.load_state_dict(load("optimizer.pt"))
        if template.ema_params is not None:
            copy_into(template.ema_params, load("ema.pt"), trainable_only=True)
        meta = load("state.pt")
        template.step = int(meta["step"])
        if template.accum is not None:
            for live, saved in zip(template.accum, meta["accum"]):
                live.copy_(saved)
        for name, g in template.generators.items():
            g.set_state(meta["generators"][name])
        return template
