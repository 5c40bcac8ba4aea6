"""BENCHMARK.json resolves by name to its data files and readers."""

import json

import pytest

from portbench.harness import registry

BENCH = registry.manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = registry.load_cell(name)
    assert cell.config_name == name.split(".")[0]
    assert cell.traffic["requests_per_call"] <= cell.traffic["max_batch"]
    e2e = {m["name"] for m in cell.end_to_end}
    suffix = ".video" if cell.traffic.get("video") else ""
    assert e2e == {"audio_s_per_s" + suffix, "peak_mem_gib", "setup_s"}
    assert cell.per_layer and all(m["moves"] in e2e for m in cell.per_layer)
    assert all(m["name"].endswith(".video") == bool(suffix) for m in cell.per_layer)
    assert set(cell.check["limits"]) >= {"target_rel_err", "residual_rel_err"}
    assert callable(registry.loop(cell.traffic["loop"]).drive)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(registry.metric_reader(metric))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_programs_schema(entry):
    from sam_audio_tpu_torch import SAMAudioConfig

    cfg = json.loads((registry.ROOT / entry["file"]).read_text())
    parsed = SAMAudioConfig.from_dict(cfg)
    assert parsed.transformer.dim == 2048 and parsed.transformer.n_layers == 16
    assert parsed.compute_dtype == "bfloat16"
    assert entry["reduced"] == []
    if cfg.get("text_ranker"):
        from sam_audio_tpu_torch.config import ClapRankerConfig
        from sam_audio_tpu_torch.models.clap import ClapConfig

        from portbench.harness.bench import clap_config

        # the ranker's kind parses, and the `clap` block is ClapConfig's own
        # fields at laion_clap 630k-best's widths (its defaults)
        assert isinstance(parsed.text_ranker, ClapRankerConfig)
        assert clap_config(cfg) == ClapConfig()


def test_manifest_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names
    for m in BENCH["per_layer"]:
        assert m["moves"] in names
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


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
