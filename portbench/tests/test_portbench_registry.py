"""BENCHMARK.json resolves by name to its data files and readers; so does
a manifest with a configuration of a ranker kind the harness lacks, added
as new files."""

import importlib
import json
import shutil

import pytest

from conftest import install_stub_kind
from portbench.harness import rankers, registry

BENCH = registry.manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]
# what a ranker kind's plug-in provides (portbench/harness/rankers/__init__.py)
PLUG_IN = ("build", "weights", "prompt_tokens", "flops", "encoder_launches")


def check_cell(name, root=registry.ROOT, bench=None):
    cell = registry.load_cell(name, root, bench)
    assert cell.config_name == name.split(".")[0]
    assert cell.traffic["requests_per_call"] <= cell.traffic["max_batch"]
    e2e = {m["name"] for m in cell.end_to_end}
    suffix = ".video" if cell.traffic.get("video") else ""
    assert e2e == {"audio_s_per_s" + suffix, "peak_mem_gib", "setup_s"}
    assert cell.per_layer and all(m["moves"] in e2e for m in cell.per_layer)
    assert all(m["name"].endswith(".video") == bool(suffix) for m in cell.per_layer)
    assert set(cell.check["limits"]) >= {"target_rel_err", "residual_rel_err"}
    assert callable(registry.loop(cell.traffic["loop"]).drive)


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    check_cell(name)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(registry.metric_reader(metric))


def check_config(entry, root=registry.ROOT):
    from sam_audio_tpu_torch import SAMAudioConfig

    cfg = json.loads((root / entry["file"]).read_text())
    parsed = SAMAudioConfig.from_dict(cfg)
    assert parsed.transformer.dim == 2048 and parsed.transformer.n_layers == 16
    assert parsed.compute_dtype == "bfloat16"
    assert entry["reduced"] == []
    ref = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    kind = rankers.for_config(cfg)
    if not cfg.get("text_ranker"):
        assert kind is None
        return
    # the ranker's kind parses as the program's, resolves to a plug-in, and
    # the configuration's reference module scores with it
    assert parsed.text_ranker.kind == cfg["text_ranker"]["kind"]
    assert all(callable(getattr(kind, f)) for f in PLUG_IN)
    assert callable(ref.score) and callable(ref.separate_candidates)
    if parsed.text_ranker.kind == "clap":
        from sam_audio_tpu_torch.config import ClapRankerConfig
        from sam_audio_tpu_torch.models.clap import ClapConfig

        # the `clap` block is ClapConfig's own fields at laion_clap
        # 630k-best's widths (its defaults)
        assert isinstance(parsed.text_ranker, ClapRankerConfig)
        assert kind.config(cfg) == ClapConfig()


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_programs_schema(entry):
    check_config(entry)


def check_manifest(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    names = [m["name"] for m in bench["end_to_end"]]
    assert "setup_s" in names
    for m in bench["per_layer"]:
        assert m["moves"] in names
    assert all(w["chips"] == 1 for w in bench["workloads"])


def test_manifest_contract_shape():
    check_manifest(BENCH)


def test_a_ranker_kind_joins_the_manifest_as_new_files(tmp_path, monkeypatch):
    """A Judge-ranked configuration, as a later PR would add it: a copy of the
    benchmark with a configuration file, a cell file and their entries, and
    the kind's plug-in and reference module as new modules (conftest's stub
    stands in for both). The manifest's own checks pass on it unchanged."""
    install_stub_kind(monkeypatch, "judge")
    bench_dir = tmp_path / "portbench"
    for d in ("traffic", "cells", "harness/loops"):
        shutil.copytree(registry.BENCH_DIR / d, bench_dir / d)
    cfg = json.loads((registry.BENCH_DIR / "configs" / "sam-audio-1b.json").read_text())
    cfg.update(text_ranker={"kind": "judge"}, judge={}, reference="stub_ref")
    (bench_dir / "configs").mkdir()
    (bench_dir / "configs" / "sam-audio-1b-judge.json").write_text(json.dumps(cfg))
    name = "sam-audio-1b-judge.rerank-k8-10s"
    shutil.copy(bench_dir / "cells" / "sam-audio-1b-clap.rerank-k8-10s.json",
                bench_dir / "cells" / f"{name}.json")
    entry = {"name": "sam-audio-1b-judge", "source": "stand-in",
             "file": "portbench/configs/sam-audio-1b-judge.json", "reduced": [], "why": "test"}
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(entry)
    bench["workloads"].append({"name": name, "config": entry["name"],
                               "traffic": "rerank-k8-10s", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:   # the metrics the CLAP cell reads
        if "sam-audio-1b-clap.rerank-k8-10s" in m.get("workloads", []):
            m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(registry, "BENCH_DIR", bench_dir)

    bench = registry.manifest(tmp_path)
    check_manifest(bench)
    check_config(entry, tmp_path)
    check_cell(name, tmp_path, bench)
    assert registry.load_cell(name, tmp_path, bench).traffic["candidates"] == 8


def test_applies_by_workloads_key():
    m = {"name": "x", "moves": "audio_s_per_s", "workloads": ["a.b"]}
    assert registry._applies(m, "a.b", ["audio_s_per_s"])
    assert not registry._applies(m, "c.d", ["audio_s_per_s"])
    assert registry._applies({"name": "y", "moves": "z"}, "c.d", ["z"])
    assert not registry._applies({"name": "y", "moves": "z"}, "c.d", ["audio_s_per_s"])


def test_build_steps_call_the_models_methods(monkeypatch):
    from sam_audio_tpu_torch import SAMAudio

    from conftest import DATA
    from portbench.harness import bench

    calls = []
    monkeypatch.setattr(SAMAudio, "quantize", lambda self, bits=8: calls.append(bits))
    cfg = json.loads((DATA / "tiny.json").read_text())
    cfg["build"] = [["quantize", 4]]
    bench.build_model(cfg, 1, bench.Device("cpu"))
    assert calls == [4]
