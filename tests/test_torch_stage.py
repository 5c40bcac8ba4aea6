"""The port's spans (sam_audio_tpu_torch.utils.stage) and the nesting
StageTimer they feed: nothing without a timer or a profiler, self times,
a stage re-entered inside itself, the thread-local timer, and the
`sam_audio.*` annotations a CPU torch.profiler sees, through a real
SeparationPipeline.run of the tiny model."""

import threading

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from sam_audio_tpu_torch import SAMAudio, tiny_test_config
from sam_audio_tpu_torch import utils
from sam_audio_tpu_torch.serving import SeparationPipeline, SeparationRequest
from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer
from sam_audio_tpu_torch.utils import StageTimer, stage


class _Clock:
    """perf_counter advancing by whole seconds only when told to."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(utils, "time", c)
    return c


def _annotations(prof):
    """(name, start, end) of the `sam_audio.*` annotations, outer first."""
    return sorted(((e.name(), int(e.start_ns()), int(e.start_ns() + e.duration_ns()))
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("sam_audio.")), key=lambda s: (s[1], -s[2]))


def test_stage_without_timer_or_profiler_does_nothing():
    timer = StageTimer()            # made, not installed
    assert stage("a") is stage("b") is utils._NO_STAGE
    with stage("a"), stage("b"):
        pass
    assert timer.summary() == {} and getattr(utils._installed, "timer", None) is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert stage("c") is not utils._NO_STAGE
        with stage("c"):
            pass
    assert stage("d") is utils._NO_STAGE      # the profiler's flag is read at each call
    assert [n for n, _, _ in _annotations(prof)] == ["sam_audio.c"]


def test_nested_self_times_sum_to_the_outer_total(clock):
    timer = StageTimer()
    with timer.install():
        with stage("run"):
            clock.now += 1
            with stage("separate"):
                clock.now += 2
                with stage("ode"):
                    clock.now += 4
                with stage("to_host"):
                    clock.now += 8
            clock.now += 16
    assert timer.totals == {"run": 31, "separate": 14, "ode": 4, "to_host": 8}
    assert timer.self_times == {"run": 17, "separate": 2, "ode": 4, "to_host": 8}
    assert sum(timer.self_times.values()) == timer.totals["run"] == timer.outer_total
    assert getattr(utils._installed, "timer", None) is None


def test_stage_reentered_inside_itself_counts_once(clock):
    timer = StageTimer()
    with timer.install():
        with stage("separate"):
            clock.now += 1
            for _ in range(3):          # streaming windows re-entering separate()
                with stage("separate"):
                    clock.now += 2
        with stage("separate"):
            clock.now += 4
    assert timer.totals["separate"] == 11 and timer.counts["separate"] == 2
    assert timer.self_times["separate"] == 11 == timer.outer_total


def test_other_threads_never_reach_the_installed_timer():
    mine, theirs = StageTimer(), StageTimer()
    done = threading.Event()

    def worker():
        with stage("worker_without_timer"):
            pass
        with theirs.install(), stage("worker_with_own"):
            pass
        done.set()

    with mine.install(), stage("main"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    assert done.is_set() and not t.is_alive()
    assert set(mine.totals) == {"main"}
    assert set(theirs.totals) == {"worker_with_own"}


def test_profiler_sees_the_pipelines_spans_nested_as_the_code_nests_them():
    cfg = tiny_test_config()
    model = SAMAudio.init_random(cfg, seed=0, device="cpu",
                                 tokenizer=ByteFallbackTokenizer(cfg.text_encoder.vocab_size))
    pipe = SeparationPipeline(model, bucket_seconds=0.01)
    rng = np.random.RandomState(0)
    reqs = [SeparationRequest(d, (rng.randn(1, 64) * 0.1).astype(np.float32))
            for d in ("a dog barking", "rain")]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.run(reqs)
    spans = _annotations(prof)
    names = [n[len("sam_audio."):] for n, _, _ in spans]
    (run,) = [s for s in spans if s[0] == "sam_audio.run"]
    outer_sep = min((s for s in spans if s[0] == "sam_audio.separate"), key=lambda s: s[1])
    assert all(run[1] <= s <= e <= run[2] for _, s, e in spans)
    order = [n for n, s, e in spans if outer_sep[1] <= s and e <= outer_sep[2]]
    model_stages = ["sam_audio." + n for n in ("codec_encode", "t5", "ode", "decode_target",
                                               "decode_residual", "to_host")]
    it = iter(order)
    assert all(n in it for n in model_stages), order   # in that order
    for n in ("host_decode", "plan", "preprocess"):
        (s,) = [x for x in spans if x[0] == "sam_audio." + n]
        assert s[2] <= outer_sep[1], n                  # before the model step
    assert names.count("separate") == 2                 # the pipeline's and the model's
    # the pipeline's timer saw the same stages, the model's inside its own
    assert {"run", "host_decode", "plan", "preprocess", "separate", "codec_encode", "t5",
            "ode", "decode_target", "decode_residual", "to_host", "upload"} == set(
        pipe.timer.totals)
    assert pipe.timer.counts["separate"] == 1 and pipe.timer.counts["to_host"] == 2


class _Event:
    """The fields of a kineto event that profile_separate.span_stages reads."""

    def __init__(self, name, start, dur, kind, corr=0, linked=0):
        self._name, self._start, self._dur, self._kind = name, start, dur, kind
        self._corr, self._linked = corr, linked

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return "DeviceType.CUDA" if self._kind in ("kernel", "gpu_memcpy") else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._kind == "user_annotation"

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def device_resource_id(self):
        return 7


def test_profile_separate_stages_come_from_the_spans():
    """Each span's host ms and device interval: two ODE spans, a kernel
    launched in each (linked to an aten op, or to the span itself), one
    running past the span's end and one launched through ctypes with no
    link (placed after the kernel before it on its stream); the copy back
    launched in `to_host`; a kernel launched outside every span. Runtime
    calls carry ids of another kind, which may equal an op's (5 here)."""
    from sam_audio_tpu_torch.profile_separate import span_stages

    ms = 1_000_000
    ev = [_Event("sam_audio.ode", 0, 10 * ms, "user_annotation", corr=1),
          _Event("aten::mm", 1 * ms, 1 * ms, "cpu_op", corr=2),
          _Event("cudaLaunchKernel", 1 * ms, 1000, "cuda_runtime", corr=11, linked=2),
          _Event("gemm", 2 * ms, 4 * ms, "kernel", corr=11, linked=2),
          _Event("cudaLaunchKernel", 9 * ms, 1000, "cuda_runtime", corr=12, linked=1),
          _Event("norm", 11 * ms, 3 * ms, "kernel", corr=12, linked=1),
          _Event("attention", 14 * ms, 1 * ms, "kernel", corr=13),
          _Event("sam_audio.ode", 20 * ms, 5 * ms, "user_annotation", corr=3),
          _Event("cudaLaunchKernel", 21 * ms, 1000, "cuda_runtime", corr=14, linked=3),
          _Event("gemm", 22 * ms, 1 * ms, "kernel", corr=14, linked=3),
          _Event("sam_audio.to_host", 30 * ms, 8 * ms, "user_annotation", corr=4),
          _Event("aten::copy_", 30 * ms, 7 * ms, "cpu_op", corr=5),
          _Event("cudaMemcpyAsync", 30 * ms, 7 * ms, "cuda_runtime", corr=15, linked=5),
          _Event("Memcpy DtoH", 31 * ms, 2 * ms, "gpu_memcpy", corr=15, linked=5),
          _Event("aten::fill_", 40 * ms, 1000, "cpu_op", corr=6),
          _Event("cudaLaunchKernel", 40 * ms, 1000, "cuda_runtime", corr=5, linked=6),
          _Event("fill", 41 * ms, 1 * ms, "kernel", corr=5, linked=6)]
    st = span_stages(ev)
    assert st == {"ode": {"calls": 2, "host_ms": 15.0, "device_ms": 14.0},
                  "to_host": {"calls": 1, "host_ms": 8.0, "device_ms": 2.0}}
