#!/usr/bin/env python3
"""The benchmark of sam_audio_tpu_torch on NVIDIA GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json on the machine it is started on and prints
one JSON line last on standard output: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with --trace 1 its per-layer
ones), `device`, with --trace 1 `breakdown`, and `check` (each number
compared with the plain reference, beside its limit). Exits non-zero with
no result when CUDA is missing, the machine holds fewer cards than the cell
asks for, or a module of JAX or of the JAX package is loaded once the
window has closed. `--control fp8` puts the plain reference computed with
fp8 operands in the program's place: the check's control, for setting its
limits (the benchmark never passes it).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment():
    """Fixed cache directories inside the checkout, and no JAX through any
    library that would load it by itself."""
    cache = ROOT / "build" / "portbench-cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(cache / "inductor"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("fp8",), default=None)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))

    from portbench.harness import bench, registry

    cell = registry.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            control=args.control, t0=T0)
    found = bench.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
