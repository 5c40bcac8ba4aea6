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

So the bridge only unflattens and moves arrays to tensors. The judge's tree
keeps the same conventions: its PE-AV layers stacked on axis 0, its
ModernBERT layers a list (`layers/0/...` keys). A reference `checkpoint.pt`
is converted by the port's own converters (convert.py), and `save_params`
writes a tree back in the JAX package's `params.npz` layout.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Optional

import numpy as np
import torch

from sam_audio_tpu_torch.config import SAMAudioConfig, SAMAudioJudgeConfig
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


def flatten(tree, prefix: str = ""):
    """A tree of tensors / arrays -> its flat `a/b/0/c` dict of numpy arrays
    (the JAX package's flatten_pytree). bfloat16 tensors are widened to
    float32, exactly (numpy has no bfloat16)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
    else:
        if isinstance(tree, torch.Tensor):
            t = tree.detach().cpu()
            tree = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        out[prefix[:-1]] = np.asarray(tree)
    return out


def save_params(path: str, params):
    """Write `params` as the flat npz the JAX package's load_params reads."""
    np.savez(path, **flatten(params))


def load_params(path: str, device="cpu"):
    """A flat `a/b/0/c` npz (the JAX package's `save_params`, e.g. a
    converted CLAP checkpoint) -> its tree of tensors on `device`."""
    with np.load(path) as data:
        return params_from_numpy({k: data[k] for k in data.files}, device)


def cast_matmul_weights(tree, dtype: torch.dtype, keep=(), _name: str = ""):
    """Store the linear, conv and embedding weights in `dtype`. Each of them
    is cast to the compute dtype where it is used (ops.nn.linear,
    ops.conv.conv1d, the residual-unit kernel), so casting once at load gives
    the same numbers without a cast per call. Norm weights and the T5
    relative-position table stay fp32: they are read in fp32, and so do the
    subtrees named in `keep`. Quantized leaves (w8, w4 and their scales) are
    not "weight" and stay as stored."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in keep:
                out[k] = v
            elif (k == "weight" and isinstance(v, torch.Tensor) and v.ndim >= 2
                    and "norm" not in _name
                    and _name != "relative_attention_bias"):
                out[k] = v.to(dtype)
            else:
                out[k] = cast_matmul_weights(v, dtype, keep, k)
        return out
    if isinstance(tree, list):
        return [cast_matmul_weights(v, dtype, keep, _name) for v in tree]
    return tree


def load_snapshot(path: str, device="cuda", allow_random_towers: bool = False,
                  t5_path: Optional[str] = None, **config_overrides):
    """A local snapshot directory -> (SAMAudioConfig, the parameter tree on
    `device` as stored: fp32 for an exported or converted snapshot).
    `config.json` and either `params.npz` (the tree that
    `SAMAudio.save_pretrained`, train/export.py or the JAX package writes,
    quantized trees included) or the reference's `checkpoint.pt`, converted
    here (convert.convert_sam_audio_state_dict, strict). `t5_path` is an HF
    T5 encoder state dict (.pt) for the text tower, which checkpoint.pt does
    not hold (reference model.py:346-359). Without a text tower, a random
    one is made only when `allow_random_towers=True` (tests). The trainer
    takes these params as its fp32 master copy; `load_sam_audio` builds a
    model of them."""
    from sam_audio_tpu_torch.models.init import t5_encoder_init
    from sam_audio_tpu_torch.models.sam_audio import resolve_device

    device = resolve_device(device)
    with open(os.path.join(path, "config.json")) as fin:
        cfg_dict = json.load(fin)
    cfg_dict.update(config_overrides)
    cfg = SAMAudioConfig.from_dict(cfg_dict)
    npz = os.path.join(path, "params.npz")
    pt = os.path.join(path, "checkpoint.pt")
    if os.path.exists(npz):
        params = load_params(npz, device)
    elif os.path.exists(pt):
        from sam_audio_tpu_torch.convert import (
            convert_sam_audio_state_dict, load_torch_state_dict)

        params = params_from_numpy(
            convert_sam_audio_state_dict(load_torch_state_dict(pt), cfg), device)
    else:
        raise FileNotFoundError(f"No params.npz or checkpoint.pt in {path}")
    if t5_path is not None:
        from sam_audio_tpu_torch.convert import convert_t5_state_dict, load_torch_state_dict

        params["text_encoder"] = params_from_numpy(
            convert_t5_state_dict(load_torch_state_dict(t5_path), cfg.text_encoder), device)
    if "text_encoder" not in params:
        if not allow_random_towers:
            raise FileNotFoundError(
                f"The snapshot {path} has no text_encoder parameters. Pass "
                "t5_path= (an HF T5 encoder state dict) or convert one into the "
                "snapshot with `python -m sam_audio_tpu_torch.convert --snapshot ... "
                "--t5 ...`; random text towers are for tests only "
                "(allow_random_towers=True).")
        gen = torch.Generator(device=device).manual_seed(0)
        params["text_encoder"] = t5_encoder_init(cfg.text_encoder, gen, device)
    return cfg, params


def load_sam_audio(path: str, device="cuda", allow_random_towers: bool = False,
                   tokenizer=None, t5_path: Optional[str] = None, **config_overrides):
    """Load a local snapshot directory (`load_snapshot`). Returns a
    models.sam_audio.SAMAudio on `device`, with the rankers of
    `cfg.text_ranker` and `cfg.visual_ranker`, and the span predictor of
    `<path>/span_predictor/` when `cfg.span_predictor` names one
    (`load_span_predictor`). `allow_random_towers=True` (tests) also lets a
    missing text tower and a weightless ranker take random weights."""
    from sam_audio_tpu_torch.models.sam_audio import SAMAudio, resolve_device
    from sam_audio_tpu_torch.ranking import create_ranker

    device = resolve_device(device)
    cfg, params = load_snapshot(path, device, allow_random_towers, t5_path, **config_overrides)
    rankers = {name: create_ranker(getattr(cfg, name), allow_random=allow_random_towers,
                                   device=device)
               for name in ("text_ranker", "visual_ranker")}
    span_predictor = None
    sp_dir = os.path.join(path, "span_predictor")
    if cfg.span_predictor is not None and os.path.exists(os.path.join(sp_dir, "params.npz")):
        span_predictor = load_span_predictor(sp_dir, device)
    model = SAMAudio(cfg, params, device=device, tokenizer=tokenizer,
                     allow_random_towers=allow_random_towers, span_predictor=span_predictor,
                     **rankers)
    if not allow_random_towers and tokenizer is None:
        model.tokenizer  # fail at load, not mid-separate, without a tokenizer
    return model


SPAN_ARCH_TAG = "sam_audio_tpu_span"


def load_span_predictor(sp_dir: str, device="cuda"):
    """`<snapshot>/span_predictor/` (params.npz and config.json) -> the span
    predictor its config names (JAX: checkpoint.py:874-918): `"arch":
    "sam_audio_tpu_span"` is the native SpanPredictor, an untagged config a
    converted PEAudioFrame checkpoint. Config keys the class lacks are
    dropped."""
    import dataclasses

    from sam_audio_tpu_torch.models.span_predictor import (
        PEAudioFrameConfig, PEAudioFrameModel, SpanPredictor, SpanPredictorConfig)

    raw = {}
    cfg_path = os.path.join(sp_dir, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as fin:
            raw = json.load(fin)
    cfg_cls, cls = ((SpanPredictorConfig, SpanPredictor) if raw.get("arch") == SPAN_ARCH_TAG
                    else (PEAudioFrameConfig, PEAudioFrameModel))
    known = {f.name for f in dataclasses.fields(cfg_cls)}
    return cls(cfg_cls(**{k: v for k, v in raw.items() if k in known}),
               load_params(os.path.join(sp_dir, "params.npz"), device))


def save_span_predictor(snapshot_dir: str, predictor) -> str:
    """Write `predictor` as `<snapshot_dir>/span_predictor/` in the JAX
    package's layout (train/span.py save_span_predictor for the native arch,
    scripts/convert_checkpoint.py for PEAudioFrame), and name a span
    predictor in the snapshot's config.json if it names none, since the
    loader attaches one only then. Returns the directory."""
    import dataclasses

    from sam_audio_tpu_torch.models.span_predictor import SpanPredictor

    sp_dir = os.path.join(snapshot_dir, "span_predictor")
    os.makedirs(sp_dir, exist_ok=True)
    cfg = dataclasses.asdict(predictor.cfg)
    if isinstance(predictor, SpanPredictor):
        cfg = {"arch": SPAN_ARCH_TAG, **cfg}
    with open(os.path.join(sp_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    save_params(os.path.join(sp_dir, "params.npz"), predictor.params)
    model_cfg = os.path.join(snapshot_dir, "config.json")
    if os.path.exists(model_cfg):
        with open(model_cfg) as f:
            raw = json.load(f)
        if not raw.get("span_predictor"):
            raw["span_predictor"] = SPAN_ARCH_TAG
            with open(model_cfg, "w") as f:
                json.dump(raw, f, indent=2)
    return sp_dir


def load_judge(path: str, device="cuda", **config_overrides):
    """Load a judge snapshot from the local directory `path`: `config.json`
    (SAMAudioJudgeConfig) and `params.npz` (the JAX package's judge tree,
    int8-quantized trees included). No hub, no network. Returns a
    models.judge.SAMAudioJudgeModel on `device`."""
    from sam_audio_tpu_torch.models.judge import SAMAudioJudgeModel
    from sam_audio_tpu_torch.models.sam_audio import resolve_device

    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"{path!r} is not a local judge snapshot directory (config.json + params.npz, "
            "written by `python -m sam_audio_tpu_torch.convert --judge`); the port reads "
            "no hub")
    device = resolve_device(device)
    with open(os.path.join(path, "config.json")) as fin:
        cfg_dict = json.load(fin)
    cfg_dict.update(config_overrides)
    npz = os.path.join(path, "params.npz")
    if not os.path.exists(npz):
        raise FileNotFoundError(
            f"No params.npz in {path}; convert the reference checkpoint with "
            "`python -m sam_audio_tpu_torch.convert --judge --snapshot ... --out ...` first")
    return SAMAudioJudgeModel(SAMAudioJudgeConfig.from_dict(cfg_dict), load_params(npz, device),
                              device=device)
