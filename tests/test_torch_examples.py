"""The port's walkthroughs (sam_audio_tpu_torch/examples/) run end to end on
the CPU, loaded and driven with a patched argv as tests/test_examples.py
drives the JAX package's, so that API drift breaks the suite. Their demo
models are small, so each runs in seconds. Also: every console script that
pyproject.toml names for the port resolves to a callable."""

import importlib
import importlib.util
import os
import sys
import tomllib

import numpy as np
import pytest
import torch

REPO = os.path.join(os.path.dirname(__file__), "..")
EXAMPLES_DIR = os.path.join(REPO, "sam_audio_tpu_torch", "examples")


def _run(name, tmp_path, monkeypatch, extra=()):
    spec = importlib.util.spec_from_file_location(
        f"torch_examples_{name}", os.path.join(EXAMPLES_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", "--device", "cpu", "--out", str(tmp_path),
                                      *extra])
    # the demos are thousands of small ops: on cores that other processes
    # load, one thread does not wait at the barriers of threads without a core
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return mod.main()
    finally:
        torch.set_num_threads(threads)


def test_span_prompting_example(tmp_path, monkeypatch):
    _run("span_prompting", tmp_path, monkeypatch)
    for f in ("mixture.wav", "target_text.wav", "residual_text.wav", "target_span.wav",
              "target_predicted.wav"):
        assert (tmp_path / f).stat().st_size > 44, f   # a WAV header and audio


def test_visual_prompting_example(tmp_path, monkeypatch):
    _run("visual_prompting", tmp_path, monkeypatch)
    for f in ("mixture.wav", "target_visual.wav", "target_reranked.wav", "target_strided.wav"):
        assert (tmp_path / f).stat().st_size > 44, f


def test_train_flow_matching_example(tmp_path, monkeypatch):
    history, result = _run("train_flow_matching", tmp_path, monkeypatch,
                           extra=("--steps", "3", "--batch-size", "2"))
    assert [h["step"] for h in history] == [1, 2, 3]
    assert os.listdir(tmp_path / "ckpt") == ["3"]
    assert sorted(os.listdir(tmp_path / "export")) == ["config.json", "params.npz"]
    assert np.isfinite(result.target[0]).all() and result.target[0].size > 0


def test_port_console_scripts_resolve():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    port = {name: target for name, target in scripts.items()
            if target.startswith("sam_audio_tpu_torch.")}
    assert sorted(port) == ["sam-audio-tpu-torch-eval", "sam-audio-tpu-torch-serve",
                            "sam-audio-tpu-torch-train"]
    for name, target in port.items():
        module, _, attr = target.partition(":")
        assert callable(getattr(importlib.import_module(module), attr)), name


if __name__ == "__main__":
    pytest.main([__file__, "-v"])
