"""Export trained params as a serving snapshot; counterpart of
sam_audio_tpu/train/export.py.

The snapshot (config.json + params.npz, the JAX package's layout, as
`SAMAudio.save_pretrained` writes it) is what the port's
`SAMAudio.from_pretrained` / `load_sam_audio` and the JAX package's
`SAMAudio.from_pretrained` read, so a trained model drops into separate(),
the eval command line and the server with no conversion. The frozen towers
(codec, T5) ride along, so the snapshot is self-contained.
"""

from __future__ import annotations

import dataclasses
import json
import os

from sam_audio_tpu_torch.checkpoint import save_params
from sam_audio_tpu_torch.config import SAMAudioConfig


def export_snapshot(cfg: SAMAudioConfig, params, out_dir: str) -> str:
    """Write `out_dir/{config.json,params.npz}` and return `out_dir`.

    `params` is the full tree (trainable + frozen towers): pass
    `trainer.ema_inference_params()` for the EMA weights, or
    `trainer.state.params` for the live ones."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)
    save_params(os.path.join(out_dir, "params.npz"), params)
    return out_dir
