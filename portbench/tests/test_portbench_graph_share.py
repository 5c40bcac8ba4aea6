"""`ode_graph_share` on made-up spans: the `dit_graph` replays of the
traced window over the groups' DiT evaluations, and None for a program
that replays no graph (as on the CPU, or a program without graphs).

    python -m pytest portbench/tests/test_portbench_graph_share.py -q -p no:cacheprovider
"""

from types import SimpleNamespace

import pytest

from portbench.harness import registry, spans
from portbench.harness.flops import GroupShape


def _ctx(replays: int, groups: int, evals: int = 32):
    ode = [spans.Span("ode", 1000 * g, 1000 * g + 900) for g in range(groups)]
    graph = [spans.Span("dit_graph", 1000 * (i // evals) + 10 + i % evals,
                        1000 * (i // evals) + 11 + i % evals) for i in range(replays)]
    return {"spans": spans.Spans(sorted(ode + graph, key=lambda s: (s.start, -s.end))),
            "run": SimpleNamespace(groups=[GroupShape(rows=2, samples=480000, frames=250,
                                                      text=64, evals=evals)] * groups),
            "groups": groups}


@pytest.mark.parametrize("name", ["ode_graph_share", "ode_graph_share.video"])
@pytest.mark.parametrize("replays,groups,evals,want", [
    (64, 2, 32, 1.0),      # every evaluation replayed
    (62, 2, 32, 62 / 64),  # a group's first evaluation captured instead
    (16, 1, 16, 1.0),      # a smaller step budget
    (0, 2, 32, None),      # no graph: nothing to read
])
def test_ode_graph_share_reads_replays_over_evaluations(name, replays, groups, evals, want):
    assert registry.metric_reader(name)(_ctx(replays, groups, evals)) == want


def test_ode_graph_share_is_none_untraced():
    assert registry.metric_reader("ode_graph_share")({"run": None, "trace": None}) is None
