"""Hermetic proof of scripts/validate_torch_checkpoint.py: a reference-shaped
checkpoint.pt built from the test oracles (tests/test_torch_convert.py's
`_sam_sd`: the SAMAudio oracle's state dict, weight-norm codec included)
and its config.json; the validator must pass every stage, port against
JAX, with the JAX package's random text tower shared, and must fail stage
A when the port's load is perturbed in one leaf (here both packages convert
an HF-shaped T5 state dict, `--t5`)."""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import test_sam_audio_torch_parity as sam_case
from test_torch_convert import _sam_sd

_SCRIPT = os.path.join(os.path.dirname(__file__), os.pardir, "scripts",
                       "validate_torch_checkpoint.py")


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    path = tmp_path_factory.mktemp("staged")
    torch.save({k: torch.from_numpy(v) for k, v in _sam_sd().items()}, path / "checkpoint.pt")
    (path / "config.json").write_text(json.dumps(dataclasses.asdict(sam_case.CFG)))
    return str(path)


@pytest.fixture(scope="module")
def validator():
    spec = importlib.util.spec_from_file_location("validate_torch_checkpoint", _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t5_file(path):
    """An HF T5 encoder state dict of sam_case.CFG's text tower."""
    rng = np.random.RandomState(3)
    te = sam_case.CFG.text_encoder
    d, inner = te.dim, te.num_heads * te.head_dim

    def r(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32) * 0.3)

    sd = {"shared.weight": r(te.vocab_size, d), "encoder.final_layer_norm.weight": 1 + r(d)}
    for i in range(te.num_layers):
        p = f"encoder.block.{i}.layer"
        for n in "qkv":
            sd[f"{p}.0.SelfAttention.{n}.weight"] = r(inner, d)
        sd[f"{p}.0.SelfAttention.o.weight"] = r(d, inner)
        sd[f"{p}.0.layer_norm.weight"] = 1 + r(d)
        sd[f"{p}.1.DenseReluDense.wi.weight"] = r(te.d_ff, d)
        sd[f"{p}.1.DenseReluDense.wo.weight"] = r(d, te.d_ff)
        sd[f"{p}.1.layer_norm.weight"] = 1 + r(d)
    sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = r(
        te.relative_attention_num_buckets, te.num_heads)
    torch.save(sd, path)
    return str(path)


def _lines(out, validator):
    return {stage: next(ln for ln in out.splitlines() if ln.startswith(stage))
            for stage in validator.STAGES}


def test_validator_passes_on_a_reference_shaped_checkpoint(snapshot, validator, capsys):
    assert validator.main(snapshot) == 0
    out = capsys.readouterr().out
    for stage, line in _lines(out, validator).items():
        assert line.endswith("PASS (tol 0.0001)"), line
    assert "VALIDATION PASS" in out


def test_validator_fails_stage_a_on_a_perturbed_leaf(snapshot, validator, capsys,
                                                     monkeypatch, tmp_path):
    from sam_audio_tpu_torch import checkpoint as port_checkpoint

    load = port_checkpoint.load_sam_audio

    def perturbed(*args, **kwargs):
        model = load(*args, **kwargs)
        model.params["transformer"]["output"]["weight"] += 1e-2
        return model

    monkeypatch.setattr(port_checkpoint, "load_sam_audio", perturbed)
    assert validator.main(snapshot, t5=_t5_file(tmp_path / "t5.pt")) == 1
    out = capsys.readouterr().out
    lines = _lines(out, validator)
    assert "FAIL" in lines["A velocity field"]
    # the codec's stages do not read the perturbed leaf
    assert "PASS" in lines["C codec encode"] and "PASS" in lines["D codec decode"]
    assert "VALIDATION FAIL" in out
