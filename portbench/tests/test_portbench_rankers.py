"""Rankers by kind (portbench/harness/rankers/): the counters and the CLAP
draws read as they did before CLAP moved behind the plug-in, and a kind the
harness has never seen joins by new modules alone: a stub that scores each
candidate by its distance to the mixture runs the tiny reranked cell end to
end, and its argmin fails the check."""

import hashlib
import json
import re
import sys
from pathlib import Path

import pytest
import torch

from conftest import StubRanker, install_stub_kind, tiny_rerank_cell
from portbench.harness import bench, flops, rankers
from portbench.harness.rankers import clap

BENCH = Path(__file__).resolve().parents[1]
SEED = 4_000_000_117


def _config(path):
    return json.loads((BENCH / path).read_text())


# Each cell's group shape (the rerank cell at its longest and a shorter
# prompt) and the tiny configurations': group_flops, rank_flops,
# residual_unit_bound_s, self_attention_work, decode_launches, as the
# counters gave them when CLAP's were written into flops.py.
PINNED = [
    ("configs/sam-audio-1b.json", dict(rows=16, samples=480000, frames=250, text=64),
     (307238516293632, 0, 0.03718118024246412, (4194304000000, 33622540288), {16: 2})),
    ("configs/sam-audio-1b-visual.json",
     dict(rows=2, samples=480000, frames=250, text=64, video_frames=250),
     (230578306760704, 0, 0.004647699685531896, (524288000000, 4260620288), {2: 2})),
    ("configs/sam-audio-1b.json", dict(rows=4, samples=2208000, frames=1150, text=64),
     (361750536388608, 0, 0.042758348337938214, (22187868160000, 38891941888), {4: 2})),
    ("configs/sam-audio-1b-clap.json",
     dict(rows=2, samples=480000, frames=250, text=64, candidates=8, rank_text=64),
     (285137364568064, 212176947200, 0.017873116292205303, (4194304000000, 33622540288),
      {16: 1, 2: 1})),
    ("configs/sam-audio-1b-clap.json",
     dict(rows=2, samples=480000, frames=250, text=64, candidates=8, rank_text=40),
     (285129026816000, 203839195136, 0.017873116292205303, (4194304000000, 33622540288),
      {16: 1, 2: 1})),
    ("tests/data/tiny.json", dict(rows=2, samples=480, frames=60, text=64, video_frames=60),
     (557591552, 0, 8.648597014925372e-08, (58982400, 2227712), {2: 2})),
    ("tests/data/tiny_clap.json",
     dict(rows=2, samples=480, frames=60, text=64, candidates=4, rank_text=12),
     (2140778816, 4931904, 1.690173134328358e-07, (235929600, 8148992), {8: 1, 2: 1})),
    ("tests/data/tiny_clap.json",
     dict(rows=4, samples=480, frames=60, text=64, candidates=8, rank_text=20),
     (8546984576, 19649152, 5.554817910447761e-07, (943718400, 31834112), {16: 2, 4: 1})),
]


@pytest.mark.parametrize("path, shape, counts", PINNED,
                         ids=["offline-b16-10s", "video-b2-10s", "long-b4-45s",
                              "rerank-k8-10s", "rerank-k8-10s-short-prompt", "tiny",
                              "tiny-clap-k4", "tiny-clap-k8"])
def test_counters_read_as_pinned(path, shape, counts):
    cfg, g = _config(path), flops.GroupShape(**shape)
    assert (flops.group_flops(cfg, g), flops.rank_flops(cfg, g),
            flops.residual_unit_bound_s(cfg, g), flops.self_attention_work(cfg, g),
            flops.decode_launches(cfg, g)) == counts


def _digest(tree):
    from sam_audio_tpu_torch.utils import tree_leaves_with_path

    h = hashlib.sha256()
    for path, x in sorted(tree_leaves_with_path(tree), key=lambda t: str(t[0])):
        h.update(str(path).encode())
        h.update(str(tuple(x.shape)).encode())
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


# tiny_clap.json's CLAP tree at SEED, as weights.clap_weights drew it
CLAP_DIGEST = "c845a2a4c94358269c5ccc95d68297a19e12f1b1b9e5ff009edb124f3813e666"


def test_clap_draws_are_pinned():
    cfg = _config("tests/data/tiny_clap.json")
    cpu = torch.device("cpu")
    assert _digest(clap.weights(cfg, SEED, cpu)) == CLAP_DIGEST
    assert _digest(clap.build(cfg, SEED, cpu).model.params) == CLAP_DIGEST


def test_clap_prompt_tokens_are_the_byte_tokenizers():
    cfg = _config("tests/data/tiny_clap.json")
    assert clap.prompt_tokens(cfg, ["a dog", "x" * 200]) == cfg["clap"]["max_text_len"]
    assert clap.prompt_tokens(cfg, ["a dog", "a cat barks"]) == 12
    assert clap.encoder_launches(cfg, flops.GroupShape(2, 480, 60, 64, 0, 32, 4, 12)) == {}


def test_unknown_kind_names_the_file_to_add():
    with pytest.raises(ValueError, match="portbench/harness/rankers/nosuch.py"):
        rankers.for_config({"text_ranker": {"kind": "nosuch"}})
    assert rankers.for_config({"text_ranker": None}) is None


# -- a kind that joins by new modules alone -------------------------------------------


@pytest.fixture
def stub_cell(monkeypatch):
    install_stub_kind(monkeypatch, "stub")
    cell = tiny_rerank_cell()
    cfg = {k: v for k, v in cell.config.items() if k != "clap"}
    cell.config = dict(cfg, text_ranker={"kind": "stub"}, reference="stub_ref")
    return cell


def test_stub_kind_runs_the_reranked_cell(stub_cell):
    out = bench.run_cell(stub_cell, SEED, 0.0, False, device="cpu")
    assert out["correct"], out["check"]
    assert out["check"]["rank_gap"]["value"] == 0.0


def test_stub_kind_is_counted(stub_cell, monkeypatch):
    cfg = stub_cell.config
    # ranked at rank_text 0: the stub reads no prompt
    g = flops.GroupShape(rows=2, samples=480, frames=60, text=64, candidates=4)
    assert flops.rank_flops(cfg, g) == 3 * 2 * 4 * 480
    # the stub's encode of the group's 2 rows runs beside the separation's
    assert flops.encode_launches(cfg, g) == {2: 2}
    enc, _ = flops.residual_units(cfg, g.samples, g.frames)
    stub_encode = sum(flops.bound_s(2 * flops.unit_flops(ch, n), flops.unit_bytes(ch, n, 2))
                      for ch, n in enc)
    with_stub = flops.group_flops(cfg, g), flops.residual_unit_bound_s(cfg, g)
    stub = sys.modules["portbench.harness.rankers.stub"]
    monkeypatch.setattr(stub, "flops", lambda cfg, g: 0)
    monkeypatch.setattr(stub, "encoder_launches", lambda cfg, g: {})
    assert flops.encode_launches(cfg, g) == {2: 1}
    assert with_stub[0] == flops.group_flops(cfg, g) + 3 * 2 * 4 * 480
    assert with_stub[1] == pytest.approx(flops.residual_unit_bound_s(cfg, g) + stub_encode,
                                         rel=1e-12)


def test_stub_kind_argmin_fails_the_check(stub_cell, monkeypatch):
    real = StubRanker.score_on_device
    monkeypatch.setattr(StubRanker, "score_on_device", lambda self, *a, **kw: -real(self, *a, **kw))
    out = bench.run_cell(stub_cell, SEED, 0.0, False, device="cpu")
    assert not out["correct"], out["check"]
    assert out["check"]["rank_gap"]["value"] == 1.0


KINDS = {"clap", "judge", "imagebind", "sound_activity", "ensemble", "stub"} | {
    p.stem for p in (BENCH / "harness" / "rankers").glob("*.py") if p.stem != "__init__"}


@pytest.mark.parametrize("name", ["bench.py", "flops.py", "weights.py"])
def test_generic_harness_names_no_kind(name):
    text = (BENCH / "harness" / name).read_text().lower()
    assert not [k for k in KINDS if re.search(rf"\b{k}\b", text)]
    assert "clap" not in text
