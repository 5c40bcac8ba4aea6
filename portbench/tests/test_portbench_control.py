"""On the card: each cell's check passes the program as configured and
fails its control, the plain reference computed with fp8 operands in the
program's place, at a size a test run holds (one call of at most two rows;
the long cell keeps clips over 40 s so that kernel 2 still runs; the rerank
cell one item of its 8 candidates). The
limits are the cell's own. And each fault on the video branch alone fails
the video cell's check.

    python -m pytest portbench/tests/test_portbench_control.py -q -p no:cacheprovider
"""

import pytest

from portbench.harness import bench, registry
from test_portbench_reference import VIDEO_FAULTS

CELLS = [w["name"] for w in registry.manifest()["workloads"]]
SMALL = {"offline-b16-10s": dict(requests_per_call=2, max_batch=2, clip_seconds=4.0, pool=2),
         "video-b2-10s": dict(requests_per_call=1, max_batch=1, clip_seconds=4.0, pool=1),
         "long-b4-45s": dict(requests_per_call=1, max_batch=1, clip_seconds=41.0, pool=1),
         # 5 s clips: twice into the ranker's 10 s window, by its repeat-pad
         "rerank-k8-10s": dict(requests_per_call=1, max_batch=1, clip_seconds=5.0, pool=1)}


def small(name):
    cell = registry.load_cell(name)
    cell.traffic.update(SMALL[cell.traffic_name], warmup_calls=1, check_rows=2)
    return cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("control", [None, "fp8"], ids=["configured", "fp8-control"])
def test_check_separates_program_and_control(card, name, control):
    out = bench.run_cell(small(name), 4_000_000_003, 0.0, False, control=control)
    assert out["correct"] == (control is None), out["check"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", VIDEO_FAULTS, ids=["video-zeroed", "video-reversed"])
def test_video_branch_fault_fails_the_video_check(card, monkeypatch, fault):
    """A fault on the video branch alone (the tower's features zeroed, or
    the frames aligned backwards) fails the video cell's check."""
    fault(monkeypatch)
    out = bench.run_cell(small("sam-audio-1b-visual.video-b2-10s"), 4_000_000_003, 0.0, False)
    assert not out["correct"], out["check"]
