"""The program's spans as the benchmark reads them (harness/spans.py):
their nesting in a traced run of the tiny CPU cell, the two idle metrics
within the window's idle, the per-stage shares of the peak with no device
operation to read, a program without spans (the readers return None), the
placing of device operations by their launches on a made-up trace, and on
the card, that the spans hold the device's busy time of each cell.

    python -m pytest portbench/tests/test_portbench_spans.py -q -p no:cacheprovider
"""

import contextlib
from dataclasses import dataclass

import pytest

from portbench.harness import bench, registry, spans
from conftest import tiny_cell

SEED = 4_000_000_119
NEW = ("pipeline_idle_ms_per_group", "model_idle_ms_per_group", "ode_mfu")


def traced(cell, device="cpu", seed=SEED):
    """A traced run of `cell`, and the context its readers saw."""
    seen = {}
    real = spans.reduce

    def capture(ctx):
        seen["ctx"] = ctx
        return real(ctx)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(spans, "reduce", capture)
        out = bench.run_cell(cell, seed, 0.0, True, device=device)
    return out, seen.get("ctx")


@pytest.fixture(scope="module")
def tiny_traced():
    return traced(tiny_cell())


def test_spans_nest_as_the_program_calls_them(tiny_traced):
    _, ctx = tiny_traced
    sp = spans.reduce(ctx)
    (run,) = sp.host("run")
    assert all(run[0] <= s.start and s.end <= run[1] for s in sp.spans)
    sep = [s for s in sp.spans if s.name == "separate"]
    assert len(sep) == 2 and sep[0].start <= sep[1].start and sep[1].end <= sep[0].end
    inner = [s.name for s in sp.spans if sep[1].start <= s.start and s.end <= sep[1].end]
    it = iter(inner)
    assert all(n in it for n in ("codec_encode", "t5", "ode", "decode_target",
                                 "decode_residual", "to_host")), inner
    # the tiny cell has video: the frames' upload inside the tower's encode
    (pe,) = [s for s in sp.spans if s.name == "pe_encode"]
    assert any(s.name == "upload" and pe.start <= s.start and s.end <= pe.end
               for s in sp.spans)
    for name in ("host_decode", "plan", "preprocess"):
        assert all(s.end <= sep[0].start for s in sp.spans if s.name == name), name


def test_idle_metrics_split_the_windows_idle(tiny_traced):
    out, ctx = tiny_traced
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert {"pipeline_idle_ms_per_group", "model_idle_ms_per_group"} <= set(m)
    idle_ms = m["device_idle_share"] / 100 * out["device"]["window_s"] * 1e3
    parts = (m["pipeline_idle_ms_per_group"] + m["model_idle_ms_per_group"]) * ctx["groups"]
    assert 0 < parts <= idle_ms * (1 + 1e-9)
    assert not out["breakdown"]["idle_gaps"][0][0].startswith("portbench.")


def test_stage_mfu_is_none_without_device_operations(tiny_traced):
    out, ctx = tiny_traced
    assert "ode_mfu" not in out["metrics"]
    assert spans.stage_mfu(ctx, "ode", 1e12) is None
    assert registry.metric_reader("pe_mfu.video")(ctx) is None


def test_a_program_without_spans_reads_none(monkeypatch):
    """A program that opens no `sam_audio.*` span, as the parent of this
    change: the new readers return None and the run ends as before."""
    import sam_audio_tpu_torch.models.pe_clip as pe_clip
    import sam_audio_tpu_torch.models.sam_audio as sa
    import sam_audio_tpu_torch.serving as serving

    for mod in (sa, pe_clip, serving):
        monkeypatch.setattr(mod, "stage", lambda name: contextlib.nullcontext())
    out, ctx = traced(tiny_cell(video=None))
    assert out["correct"] and not set(NEW) & set(out["metrics"])
    assert "device_idle_share" in out["metrics"]
    assert spans.reduce(ctx).spans == []


@dataclass
class _Event:
    """The few fields of a kineto event that the reduction reads."""
    name_: str
    start: int
    dur: int
    kind: str
    corr: int = 0
    linked: int = 0
    thread: int = 1

    def name(self):
        return self.name_

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.dur

    def device_type(self):
        return "DeviceType.CUDA" if self.kind in ("kernel", "gpu_memcpy") else "DeviceType.CPU"

    def is_user_annotation(self):
        return self.kind == "user_annotation"

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked

    def start_thread_id(self):
        return self.thread

    def device_resource_id(self):
        return 7


def test_device_operations_are_placed_by_their_launches():
    """Kernels are placed by the host op they are linked to (an aten op, or
    the span itself), a kernel with no link (launched through ctypes) by
    the operation before it on its stream. A copy is launched in
    `to_host`, one kernel before any span; a span of another thread is
    left out. Runtime calls and the profiler's own events carry ids of
    another kind (3 and 70 here are also ops' ids): they place nothing."""
    ev = [_Event("sam_audio.separate", 100, 900, "user_annotation", corr=1),
          _Event("sam_audio.ode", 200, 300, "user_annotation", corr=2),
          _Event("aten::mm", 210, 20, "cpu_op", corr=3),
          _Event("cudaLaunchKernel", 215, 5, "cuda_runtime", corr=3, linked=3),
          _Event("Activity Buffer Request", 0, 1, "overhead", corr=3),
          _Event("gemm", 230, 400, "kernel", corr=90, linked=3),
          _Event("elementwise", 640, 30, "kernel", corr=91, linked=2),
          _Event("ctypes_kernel", 670, 30, "kernel", corr=92),
          _Event("sam_audio.to_host", 800, 150, "user_annotation", corr=4),
          _Event("aten::copy_", 805, 140, "cpu_op", corr=70),
          _Event("cudaMemcpyAsync", 810, 130, "cuda_runtime", corr=70, linked=70),
          _Event("aten::fill_", 40, 30, "cpu_op", corr=6),
          _Event("Memcpy DtoH", 700, 200, "gpu_memcpy", corr=70, linked=70),
          _Event("cudaLaunchKernel", 50, 5, "cuda_runtime", corr=93, linked=6),
          _Event("early", 60, 10, "kernel", corr=93, linked=6),
          _Event("sam_audio.ode", 300, 10, "user_annotation", corr=5, thread=2)]
    sp = spans.of_events(ev, thread=1)
    assert [s.name for s in sp.spans] == ["separate", "ode", "to_host"]
    assert sp.device("ode") == [(230, 700)]
    assert sp.device("to_host") == [(700, 900)]
    assert sp.device("separate") == [(230, 900)]
    assert sp.placed == 4 and sp.device_ops == 5 and sp.unplaced == ["ctypes_kernel"]
    assert spans.union(sp.inside) == [(230, 630), (640, 900)]   # "early" is outside
    assert spans.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert spans.intersect([(0, 10), (20, 30)], [(5, 25)]) == [(5, 10), (20, 25)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in registry.manifest()["workloads"]])
def test_spans_hold_the_devices_busy_time(card, name):
    """A traced run of the cell as configured: the device operations
    launched inside `sam_audio.*` spans hold at least 98% of the window's
    device busy time, and the line carries the new per-layer metrics."""
    cell = registry.load_cell(name)
    out, ctx = traced(cell, device="cuda")
    assert out["correct"], out["check"]
    share = spans.inside_share(ctx)
    assert share is not None and share >= 0.98, share
    want = {m["name"] for m in cell.per_layer if m["source"] == "program_span"}
    assert want - {"host_ms_per_group", "host_ms_per_group.video"} <= set(out["metrics"])
    assert out["breakdown"]["idle_gaps"][0][0] != "portbench.call", out["breakdown"]
