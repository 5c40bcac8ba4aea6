"""Shared pieces of the benchmark's own tests: the checkout's root on the
path, and a tiny cell (tests/data: a tiny_test_config-sized model with a
PE tower, fp32, two 0.05 s requests a call) that runs on the CPU; and its
reranked twin (`tiny_rerank_cell`: the same model without the tower, 4
candidates an item scored by a tiny CLAP ranker)."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

DATA = Path(__file__).resolve().parent / "data"


def tiny_cell(config="tiny.json", limits=None, **traffic_overrides):
    from portbench.harness import registry

    bench = registry.manifest()
    traffic = json.loads((DATA / "tiny_traffic.json").read_text())
    traffic.update(traffic_overrides)
    return registry.Cell(
        name="tiny", chips=1, config_name="tiny", traffic_name="tiny",
        config=json.loads((DATA / config).read_text()), traffic=traffic,
        check={"limits": limits or {"target_rel_err": 1e-4, "residual_rel_err": 1e-4,
                                    "wrong_length": 0, "non_finite": 0}},
        end_to_end=[m for m in bench["end_to_end"] if not m["name"].endswith(".video")],
        per_layer=[m for m in bench["per_layer"] if not m["name"].endswith(".video")])


def tiny_rerank_cell(**traffic_overrides):
    traffic = dict(candidates=4, video=None)
    traffic.update(traffic_overrides)
    return tiny_cell("tiny_clap.json", {"target_rel_err": 1e-4, "residual_rel_err": 1e-4,
                                        "rank_gap": 1e-6, "wrong_length": 0, "non_finite": 0},
                     **traffic)


@pytest.fixture
def cell():
    return tiny_cell()


@pytest.fixture
def card():
    """Skips unless a CUDA device is present (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
