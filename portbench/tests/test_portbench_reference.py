"""The plain reference against the program on the CPU at a tiny size, the
benchmark's weight tree against the program's own, and the comparison's
power to fail: each fault planted under the program drives a run whose
`correct` comes out false."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.harness import bench, weights
from conftest import DATA, tiny_cell

BENCH = Path(__file__).resolve().parents[1]
SEED = 4_000_000_117      # past 32 signed bits, as the benchmark's seeds are


def run(cell, seed=SEED):
    return bench.run_cell(cell, seed, 0.0, False, device="cpu")


def test_weight_tree_is_the_programs():
    from sam_audio_tpu_torch import SAMAudioConfig
    from sam_audio_tpu_torch.models.init import pe_clip_init, sam_audio_init

    cfg = json.loads((DATA / "tiny.json").read_text())
    pcfg = SAMAudioConfig.from_dict(cfg)
    gen = torch.Generator().manual_seed(0)
    theirs = sam_audio_init(pcfg, gen, torch.device("cpu"))
    ours = weights.sam_audio_weights(cfg, 1, torch.device("cpu"))
    from sam_audio_tpu_torch.utils import tree_leaves_with_path

    def shapes(t):
        return {p: tuple(x.shape) for p, x in tree_leaves_with_path(t)}

    assert shapes(ours) == shapes(theirs)
    pe = weights.pe_weights(cfg, 1, torch.device("cpu"))
    assert shapes(pe) == shapes(pe_clip_init(pcfg.vision_encoder, gen, torch.device("cpu")))


def test_weights_repeat_from_the_seed():
    cfg = json.loads((DATA / "tiny.json").read_text())
    a = weights.sam_audio_weights(cfg, SEED, torch.device("cpu"))
    b = weights.sam_audio_weights(cfg, SEED, torch.device("cpu"))
    assert torch.equal(a["transformer"]["layers"]["attention"]["wq"]["weight"],
                       b["transformer"]["layers"]["attention"]["wq"]["weight"])
    assert float(a["embed_anchors"]["embed"]["weight"][cfg["num_anchors"]].abs().sum()) == 0.0


@pytest.mark.parametrize("traffic", [{}, {"audio_as": "array", "video": None},
                                     {"requests_per_call": 1}],
                         ids=["files-video", "arrays-text", "one-a-call"])
def test_reference_agrees_with_the_program(traffic):
    out = run(tiny_cell(**traffic))
    assert out["correct"], out["check"]
    assert out["check"]["target_rel_err"]["value"] < 1e-5
    assert out["check"]["residual_rel_err"]["value"] < 1e-5
    assert set(out["check"]) == {"target_rel_err", "residual_rel_err", "wrong_length", "non_finite"}


def test_result_line_has_the_contract_keys():
    out = run(tiny_cell())
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "check"
    assert set(out["metrics"]) == {"audio_s_per_s", "peak_mem_gib", "setup_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    traced = bench.run_cell(tiny_cell(), SEED, 0.0, True, device="cpu")
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "host_ms_per_group" in traced["metrics"]


# -- faults planted under the timed path ------------------------------------------


def _state_unchanged(monkeypatch):
    """The ODE returns its state unchanged: the noise is decoded."""
    import sam_audio_tpu_torch.models.sam_audio as sa

    monkeypatch.setattr(sa, "odeint", lambda func, y0, **kw: y0)


def _half_batch(monkeypatch):
    """Half of each batch left out: the first half's rows are solved and
    the second half's answers are copies of them."""
    import sam_audio_tpu_torch.models.sam_audio as sa

    real = sa.separate_latents

    def halved(params, audios, *args, **kw):
        b = audios.shape[0]
        h = max(1, b // 2)
        args = [a[:h] if torch.is_tensor(a) and a.shape[:1] == (b,) else a for a in args]
        kw = {k: (v[:h] if torch.is_tensor(v) and v.shape[:1] == (b,) else v)
              for k, v in kw.items()}
        lat = real(params, audios[:h], *args, **kw)
        return torch.cat([lat, lat])[:b]

    monkeypatch.setattr(sa, "separate_latents", halved)


def _answer_altered(monkeypatch):
    """One answer altered where it is produced: the last row's target
    waveform scaled by 1.01 as the codec decodes it."""
    import sam_audio_tpu_torch.models.sam_audio as sa

    real = sa.decode_channel

    def altered(params, latents, *, cfg, channel=0):
        out = real(params, latents, cfg=cfg, channel=channel)
        if channel == 0:
            out = out.clone()
            out[-1] *= 1.01
        return out

    monkeypatch.setattr(sa, "decode_channel", altered)


def _video_features_zeroed(monkeypatch):
    """The video branch alone broken: the vision tower's features of every
    row zeroed, as if no video had been given."""
    import sam_audio_tpu_torch.models.pe_clip as pe

    real = pe.encode_videos
    monkeypatch.setattr(pe, "encode_videos",
                        lambda *args, **kw: torch.zeros_like(real(*args, **kw)))


def _video_frames_reversed(monkeypatch):
    """The frames aligned to the latent frames backwards in time: the
    tower sees the last frame where the first belongs."""
    import sam_audio_tpu_torch.models.pe_clip as pe

    real = pe.encode_videos
    monkeypatch.setattr(pe, "encode_videos", lambda model, videos, *args, **kw: real(
        model, [np.ascontiguousarray(v[::-1]) for v in videos], *args, **kw))


VIDEO_FAULTS = [_video_features_zeroed, _video_frames_reversed]


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered]
                         + VIDEO_FAULTS,
                         ids=["state-unchanged", "half-batch", "answer-altered",
                              "video-zeroed", "video-reversed"])
def test_fault_fails_the_check(monkeypatch, fault):
    fault(monkeypatch)
    out = run(tiny_cell(check_rows=8))
    assert not out["correct"], out["check"]


def test_fp8_control_fails_the_check():
    out = bench.run_cell(tiny_cell(), SEED, 0.0, False, device="cpu", control="fp8")
    assert not out["correct"]
    assert out["check"]["target_rel_err"]["value"] > 3e-2


# -- what may be imported ----------------------------------------------------------


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_in_the_benchmark(path):
    assert not set(_imports(path)) & {"jax", "jaxlib", "flax", "sam_audio_tpu"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "sam_audio_tpu_torch" not in set(_imports(path))


def test_forbidden_names_compare_whole(monkeypatch):
    import sys
    import types

    assert "sam_audio_tpu_torch" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sam_audio_tpu", types.ModuleType("sam_audio_tpu"))
    assert bench.forbidden_modules() == ["sam_audio_tpu"]


def test_no_card_no_result(monkeypatch, capsys):
    import importlib.util

    spec = importlib.util.spec_from_file_location("portbench_run", BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = mod.main(["--workload", "sam-audio-1b.offline-b16-10s", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""
