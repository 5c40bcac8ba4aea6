"""One run of one cell: set-up, the measured (or traced) window, the check
of what the window produced against the plain reference, the result line.

Set-up: the program built from the configuration file (weights drawn on
the device from the seed, the vision tower where the file has one, then
the file's `build` steps, each a method of the model and its arguments,
such as ["quantize", 4]); the pool of requests made from the seed (WAV
files in a temporary directory under TMPDIR); and the traffic's `loop`,
found by name in portbench/harness/loops/<loop>.py, which builds the
program's front end and warms up the cell's own shapes. The window: the
loop drives the front end inside `Run.window()` until `Run.over()`, and
hands each group it gets back to `Run.record`. The check: once the window
has closed, its peak memory read and the program freed, a sample of the
rows it finished (drawn from the seed) is recomputed by the plain
reference in float32 from the same inputs, the same weights and the same
noise (replayed from the device generator's state that the loop saved
before the call that drew it), and each compared number is held to the
cell's limit.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from portbench.harness import flops, registry, trace, traffic, weights

FORBIDDEN = ("jax", "jaxlib", "flax", "sam_audio_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, as a whole
    name (sam_audio_tpu_torch is not sam_audio_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str):
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


@dataclass
class Row:
    group: int           # the group's place in the window
    slot: int            # the row's place in its dispatched group
    request: traffic.Request
    target: np.ndarray
    residual: np.ndarray
    noise_state: object  # the device generator's state before the group's call
    rows: int            # the group's rows, as the program drew their noise
    samples: int         # the group's padded samples


class Reservoir:
    """A uniform sample of `k` finished rows, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rows, self.seen = k, [], 0
        self.rng = np.random.default_rng([int(seed) % (2 ** 63), 2])

    def offer(self, row: Row):
        self.seen += 1
        if len(self.rows) < self.k:
            self.rows.append(row)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.rows[j] = row


class Device:
    """The few device calls the harness makes, for the card or (tests only)
    the CPU."""

    def __init__(self, kind: str):
        import torch

        self.torch, self.kind = torch, kind
        self.dev = torch.device(kind)

    def sync(self):
        if self.kind == "cuda":
            self.torch.cuda.synchronize()

    def rng_state(self):
        t = self.torch
        return t.cuda.get_rng_state() if self.kind == "cuda" else t.get_rng_state()

    def replay_noise(self, state, shape):
        """The noise the program drew first after `state`: torch.randn of
        `shape` on the device's default generator."""
        t = self.torch
        (t.cuda.set_rng_state if self.kind == "cuda" else t.set_rng_state)(state)
        return t.randn(shape, device=self.dev, dtype=t.float32)

    def reset_peak(self) -> int:
        if self.kind != "cuda":
            return 0
        before = self.torch.cuda.max_memory_allocated()
        self.torch.cuda.reset_peak_memory_stats()
        return before

    def peak(self) -> int:
        return self.torch.cuda.max_memory_allocated() if self.kind == "cuda" else 0

    def name(self) -> str:
        return self.torch.cuda.get_device_name(0) if self.kind == "cuda" else "cpu"


def build_model(cfg: dict, seed: int, dev: Device):
    """SAMAudio with the configuration's weights drawn from the seed, its
    PE-Core tower where the file has `vision_tower`, then the file's `build`
    steps in order: ["quantize", 4] calls model.quantize(4)."""
    import torch

    from sam_audio_tpu_torch import SAMAudio, SAMAudioConfig
    from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer

    pcfg = SAMAudioConfig.from_dict(cfg)
    model = SAMAudio(pcfg, weights.sam_audio_weights(cfg, seed, dev.dev), device=dev.dev,
                     tokenizer=ByteFallbackTokenizer(pcfg.text_encoder.vocab_size))
    if cfg.get("vision_tower"):
        from sam_audio_tpu_torch.models.pe_clip import PerceptionEncoder

        model.vision_encoder = PerceptionEncoder(
            pcfg.vision_encoder, weights.pe_weights(cfg, seed, dev.dev), device=dev.dev,
            compute_dtype=getattr(torch, cfg["compute_dtype"]))
    for name, *args in cfg.get("build", []):
        getattr(model, name)(*args)
    return model


def program_requests(pool: List[traffic.Request], sample_rate: int):
    """The program's SeparationRequest of each pool entry: the WAV path (or
    the array), the prompt, and the frames masked by the program's
    processor (SAMAudioProcessor.mask_videos)."""
    from sam_audio_tpu_torch.processor import SAMAudioProcessor
    from sam_audio_tpu_torch.serving import SeparationRequest

    out = []
    for r in pool:
        masked = None
        if r.frames is not None:
            proc = SAMAudioProcessor(1, sample_rate)
            masked = proc.mask_videos([r.frames], [traffic.box_mask(r.frames.shape, r.box)])[0]
        out.append(SeparationRequest(description=r.description,
                                     audio=r.path if r.path else r.wav, masked_video=masked))
    return out


def text_width(descriptions, pad_to: int) -> int:
    """The padded prompt width of a group (the byte tokenizer's lengths)."""
    from portbench.reference.sam_audio import byte_tokens

    longest = max(len(byte_tokens(d)) for d in descriptions)
    return -(-longest // pad_to) * pad_to


class Run:
    """What a loop drives and what it leaves: the cell, the program, the
    pool of requests and the program's request of each, the set-up's marks,
    and the window's record (groups, rows offered to the check, counts)."""

    def __init__(self, cell: registry.Cell, seed: int, seconds: float, trace_on: bool,
                 dev: Device, t0: float):
        self.cell, self.seed, self.seconds, self.trace_on = cell, seed, seconds, trace_on
        self.traffic, self.dev, self.t0 = cell.traffic, dev, t0
        self.sample_rate = int(cell.config["audio_codec"]["sample_rate"])
        self.hop = math.prod(cell.config["audio_codec"]["encoder_rates"])
        self.marks = [("imports", time.perf_counter())]
        self.model = self.pool = self.requests = self.prof = None
        self.reservoir = Reservoir(int(self.traffic["check_rows"]), seed)
        self.groups: List[flops.GroupShape] = []
        self.durations: List[float] = []
        self.attempted = self.failed = 0
        self.audio_s = 0.0
        self.stages: Dict[str, float] = {}
        self.setup_s = self.w0 = self.w1 = None
        self.setup_peak = self.window_peak = 0

    def mark(self, name: str):
        """A set-up step has ended (the device synchronised)."""
        self.dev.sync()
        self.marks.append((name, time.perf_counter()))

    def span(self, name: str):
        """A host annotation in the traced run's profile; nothing otherwise."""
        if not self.trace_on:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    @contextlib.contextmanager
    def window(self):
        """Set-up ends where this opens. The measured window, or with
        --trace the traced one under torch.profiler."""
        self.setup_s = time.perf_counter() - self.t0
        steps = ", ".join(f"{name} {b - a:.3f}" for (_, a), (name, b)
                          in zip([("start", self.t0)] + self.marks[:-1], self.marks))
        log(f"set-up {self.setup_s:.3f} s ({self.cell.name}, seed {self.seed}): {steps}")
        self.setup_peak = self.dev.reset_peak()
        with contextlib.ExitStack() as stack:
            if self.trace_on:
                from torch.profiler import ProfilerActivity, profile, record_function

                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if self.dev.kind == "cuda" else [])
                self.prof = stack.enter_context(profile(activities=acts))
                stack.enter_context(record_function(trace.WINDOW))
            self.dev.sync()
            self.w0 = time.perf_counter()
            yield self
            self.dev.sync()
            self.w1 = time.perf_counter()
        self.window_peak = self.dev.peak()

    def over(self) -> bool:
        """Whether the window has done its work: `trace_calls` groups when
        traced; else at least one group and --seconds on the host clock."""
        if self.trace_on:
            return len(self.groups) >= int(self.traffic["trace_calls"])
        return bool(self.groups) and time.perf_counter() - self.w0 >= self.seconds

    def record(self, reqs: List[traffic.Request], results, noise_state, seconds: float):
        """One dispatched group back from the program: `reqs` in the order
        of `results`, the device generator's state before the call that
        drew the group's noise, and the call's host seconds."""
        sizes = {(r.metadata["dispatch_size"], r.metadata["bucket"]) for r in results}
        if len(sizes) != 1:
            raise RuntimeError(f"group {len(self.groups)} was not one group: {sizes}")
        rows, samples = sizes.pop()
        g = len(self.groups)
        self.groups.append(flops.GroupShape(
            rows=rows, samples=samples, frames=samples // self.hop,
            text=text_width([r.description for r in reqs], int(self.traffic["text_pad_to"])),
            video_frames=samples // self.hop if self.traffic.get("video") else 0))
        self.durations.append(seconds)
        self.attempted += len(reqs)
        for slot, (req, r) in enumerate(zip(reqs, results)):
            if r is None or r.target is None:
                self.failed += 1
                continue
            self.audio_s += req.wav.shape[0] / self.sample_rate
            self.reservoir.offer(Row(g, slot, req, r.target, r.residual, noise_state,
                                     rows, samples))


def reference_check(cell: registry.Cell, seed: int, dev: Device, rows: List[Row],
                    control: Optional[str] = None) -> Dict[str, float]:
    """The sampled rows recomputed by the plain reference in float32 (TF32
    off): the widest relative L2 gap of a target and of a residual, and the
    rows whose length or finiteness is wrong. With control "fp8" the
    reference computed with fp8 operands takes the program's place."""
    import importlib

    import torch

    ref = importlib.import_module(f"portbench.reference.{cell.config['reference']}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, tr = cell.config, cell.traffic
    p = weights.sam_audio_weights(cfg, seed, dev.dev)
    pe = weights.pe_weights(cfg, seed, dev.dev) if cfg.get("vision_tower") else None
    hop = math.prod(cfg["audio_codec"]["encoder_rates"])
    width = 2 * cfg["audio_codec"]["codebook_dim"]
    gaps = {"target_rel_err": 0.0, "residual_rel_err": 0.0, "wrong_length": 0, "non_finite": 0}
    with torch.inference_mode():
        for row in sorted(rows, key=lambda r: (r.group, r.slot)):
            noise = dev.replay_noise(row.noise_state,
                                     (row.rows, row.samples // hop, width))[row.slot]
            req = row.request
            wav = torch.as_tensor(req.wav, device=dev.dev)

            def separate():
                video = None if req.frames is None else ref.video_features(
                    pe, cfg["vision_encoder"], req.frames,
                    traffic.box_mask(req.frames.shape, req.box), -(-wav.shape[0] // hop))
                return ref.separate_row(p, cfg, wav, req.description, noise, row.samples,
                                        int(tr["text_pad_to"]), video)

            tgt, res = separate()
            got_t, got_r = row.target, row.residual
            if control == "fp8":
                ref.set_precision("fp8")
                try:
                    got_t, got_r = (x.cpu().numpy() for x in separate())
                finally:
                    ref.set_precision("fp32")
            for key, got, want in (("target_rel_err", got_t, tgt),
                                   ("residual_rel_err", got_r, res)):
                want = want.cpu().numpy().astype(np.float64)
                got = np.asarray(got, np.float64)
                if got.shape != want.shape:
                    gaps["wrong_length"] += 1
                    continue
                if not np.all(np.isfinite(got)):
                    gaps["non_finite"] += 1
                    continue
                err = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
                gaps[key] = max(gaps[key], err)
                log(f"row {row.request.index} (group {row.group}, slot {row.slot}) {key} "
                    f"{err:.6g}, rms {np.sqrt(np.mean(want ** 2)):.4g}")
    return gaps


def run_cell(cell: registry.Cell, seed: int, seconds: float, trace_on: bool,
             device: str = "cuda", control: Optional[str] = None,
             t0: Optional[float] = None) -> dict:
    import torch

    dev = Device(device)
    run = Run(cell, seed, seconds, trace_on, dev, time.perf_counter() if t0 is None else t0)
    torch.manual_seed(int(seed) % (2 ** 63))
    if device == "cuda":
        torch.cuda.manual_seed_all(int(seed) % (2 ** 63))
    cfg, tr = cell.config, cell.traffic

    run.model = build_model(cfg, seed, dev)
    run.mark("weights and model")
    with tempfile.TemporaryDirectory(prefix="portbench-") as workdir:
        run.pool = traffic.make_pool(tr, seed, run.sample_rate, workdir)
        run.requests = program_requests(run.pool, run.sample_rate)
        run.mark("request pool")
        registry.loop(tr["loop"]).drive(run)
        log(f"window {run.w1 - run.w0:.3f} s, {len(run.groups)} groups, {run.attempted} "
            f"requests, {run.audio_s:.1f} audio s, peak {run.window_peak / 2 ** 30:.3f} GiB; "
            "group s: " + " ".join(f"{d:.3f}" for d in run.durations))

        run.model = None
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        r0 = time.perf_counter()
        gaps = reference_check(cell, seed, dev, run.reservoir.rows, control)
        log(f"reference check of {len(run.reservoir.rows)} rows: "
            f"{time.perf_counter() - r0:.3f} s")

    ctx = {"cfg": cfg, "traffic": tr, "flops": flops, "groups": len(run.groups), "window_s": run.w1 - run.w0, "audio_s": run.audio_s,
           "setup_s": run.setup_s, "peak_bytes": run.window_peak, "stages": run.stages,
           "group_shape": run.groups[0],
           "group_flops": sum(flops.group_flops(cfg, g) for g in run.groups),
           "trace": trace.from_profiler(run.prof) if trace_on else None, "run": run}
    result: dict = {"correct": False, "attempted": run.attempted, "failed": run.failed,
                    "metrics": {}}
    for m in (cell.per_layer if trace_on else cell.end_to_end):
        value = registry.metric_reader(m["name"])(ctx)
        if value is not None:
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    result["device"] = {"platform": "gpu" if device == "cuda" else device, "kind": dev.name(),
                        "count": cell.chips,
                        "memory_peak_bytes": int(max(run.setup_peak, run.window_peak))}
    if trace_on:
        t_tr = ctx["trace"]
        result["device"]["busy_s"] = t_tr.busy_s()
        result["device"]["window_s"] = t_tr.window_s
        result["breakdown"] = {"device_ops": trace.top_device_ops(t_tr),
                               "idle_gaps": trace.top_idle_gaps(t_tr)}
        log("device time by group: " + json.dumps(trace.group_seconds(t_tr)))

    limits = cell.check["limits"]
    checked = {k: {"value": gaps[k], "limit": limits[k]} for k in limits}
    rows = len(run.reservoir.rows)
    result["correct"] = bool(rows >= 1 and run.failed == 0
                             and all(v["value"] <= v["limit"] for v in checked.values()))
    result["check"] = checked
    print(f"check: {rows} rows recomputed by the reference, {run.failed} requests failed",
          file=sys.stderr)
    for k, v in checked.items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    return result
