"""The weight bridge: JAX parameter trees -> the port's tensors.

The JAX package stores parameters as nested dicts/lists of arrays and saves
them flat (`a/b/0/c` keys) in `params.npz` beside `config.json`
(sam_audio_tpu/checkpoint.py:50-90, `SAMAudio.save_pretrained`). The port
keeps every storage convention of that tree as it is:

  * DiT and T5 layers stacked on axis 0;
  * q/k projection output channels already deinterleaved for split-half
    RoPE (no further permutation here);
  * weight norm already folded into plain conv weights;
  * torch layouts: Linear (out, in), Conv1d (out, in, k),
    ConvTranspose1d (in, out, k).

So the bridge only unflattens and moves arrays to tensors. A reference
`checkpoint.pt` goes through the JAX package's converter first.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping

import numpy as np
import torch

from sam_audio_tpu_torch.config import SAMAudioConfig
from sam_audio_tpu_torch.utils import tree_map


def unflatten(flat: Mapping[str, np.ndarray]):
    """`a/b/0/c` keys -> nested dicts, with all-digit levels as lists."""
    root: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        keys = list(node)
        if keys and all(k.isdigit() for k in keys):
            return [node[str(i)] for i in range(len(keys))]
        return node

    return listify(root)


def params_from_numpy(flat_or_tree, device="cpu"):
    """A JAX parameter tree (nested dicts/lists of arrays) or its flat
    `a/b/0/c` dict -> the same tree of torch tensors on `device`, dtypes
    kept."""
    tree = flat_or_tree
    if isinstance(tree, Mapping) and any("/" in k for k in tree):
        tree = unflatten(tree)
    return tree_map(
        lambda x: torch.from_numpy(np.array(x)).to(device),
        tree)


def cast_matmul_weights(tree, dtype: torch.dtype, _name: str = ""):
    """Store the linear, conv and embedding weights in `dtype`. Each of them
    is cast to the compute dtype where it is used (ops.nn.linear,
    ops.conv.conv1d, the residual-unit kernel), so casting once at load gives
    the same numbers without a cast per call. Norm weights and the T5
    relative-position table stay fp32: they are read in fp32."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if (k == "weight" and isinstance(v, torch.Tensor) and v.ndim >= 2
                    and "norm" not in _name
                    and _name != "relative_attention_bias"):
                out[k] = v.to(dtype)
            else:
                out[k] = cast_matmul_weights(v, dtype, k)
        return out
    if isinstance(tree, list):
        return [cast_matmul_weights(v, dtype, _name) for v in tree]
    return tree


def load_sam_audio(path: str, device="cuda", allow_random_towers: bool = False,
                   tokenizer=None, **config_overrides):
    """Load the `config.json` + `params.npz` snapshot that the JAX package's
    `SAMAudio.save_pretrained` writes. Returns a models.sam_audio.SAMAudio
    on `device`. Without a text tower in the snapshot, a random one is made
    only when `allow_random_towers=True` (tests)."""
    from sam_audio_tpu_torch.models.sam_audio import SAMAudio, resolve_device
    from sam_audio_tpu_torch.models.init import t5_encoder_init

    device = resolve_device(device)
    with open(os.path.join(path, "config.json")) as fin:
        cfg_dict = json.load(fin)
    cfg_dict.update(config_overrides)
    cfg = SAMAudioConfig.from_dict(cfg_dict)
    npz = os.path.join(path, "params.npz")
    if not os.path.exists(npz):
        raise FileNotFoundError(
            f"No params.npz in {path}; convert a reference checkpoint.pt with "
            "the JAX package's converter (scripts/convert_checkpoint.py) first")
    with np.load(npz) as data:
        flat: Dict[str, np.ndarray] = {k: data[k] for k in data.files}
    params = params_from_numpy(flat, device)
    if "text_encoder" not in params:
        if not allow_random_towers:
            raise FileNotFoundError(
                f"The snapshot {path} has no text_encoder parameters. Export "
                "one with the converted T5 tower; random text towers are for "
                "tests only (allow_random_towers=True).")
        gen = torch.Generator(device=device).manual_seed(0)
        params["text_encoder"] = t5_encoder_init(cfg.text_encoder, gen, device)
    model = SAMAudio(cfg, params, device=device, tokenizer=tokenizer,
                     allow_random_towers=allow_random_towers)
    if not allow_random_towers and tokenizer is None:
        model.tokenizer  # fail at load, not mid-separate, without a tokenizer
    return model
