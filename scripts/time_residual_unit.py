"""Device time of kernel 3 (`ops/fused_conv.fused_residual_unit`) at the main
path's codec shapes, in bf16 and in fp32, for comparing two trees of the port
on one card.

    python scripts/time_residual_unit.py [--root DIR] [--dtypes bf16,fp32] [--tag NAME]

`--root` is the directory that holds the `sam_audio_tpu_torch` package to
time (default: this repository); its kernels build into DIR/build/kernels.
The shapes are chip_smoke.py's ENCODER_SHAPES and DECODER_SHAPES at B = 1,
dilations 1, 3 and 9: the 36 launches of one separate, encoder units once
and decoder units twice, as chip_smoke.py's totals weigh them. Each shape's
device ms is the mean of 3 replays of a CUDA graph of 5 calls. Prints one
JSON line: per dtype, the weighted total and the per-shape times (null for
a shape the tree's kernel refuses, left out of the total), beside the
card's name and power limit.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ENCODER_SHAPES = ((64, 480000), (128, 240000), (256, 30000), (512, 3000))
DECODER_SHAPES = ((768, 3000), (384, 30000), (192, 240000), (96, 480000))


def device_ms(fn, iters=5, replays=3):
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def unit(c, seed, device):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)

    def u(*shape, scale):
        return (torch.rand(*shape, generator=g, device=device) * 2 - 1) * scale

    return {"snake1": {"alpha": 0.5 + torch.rand(1, c, 1, generator=g, device=device)},
            "conv1": {"weight": u(c, c, 7, scale=(7 * c) ** -0.5),
                      "bias": u(c, scale=(7 * c) ** -0.5)},
            "snake2": {"alpha": 0.5 + torch.rand(1, c, 1, generator=g, device=device)},
            "conv2": {"weight": u(c, c, 1, scale=c ** -0.5), "bias": u(c, scale=c ** -0.5)}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--dtypes", default="bf16,fp32")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        sys.exit("time_residual_unit.py needs a CUDA device")
    from sam_audio_tpu_torch.ops import _build
    from sam_audio_tpu_torch.ops.fused_conv import fused_residual_unit

    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    device = "cuda"
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    g = torch.Generator(device=device).manual_seed(11)
    record = {"tag": args.tag, "root": args.root, "build_s": build_s}
    for name in args.dtypes.split(","):
        dtype = dtypes[name]
        total, per_shape = 0.0, []
        for c, t in ENCODER_SHAPES + DECODER_SHAPES:
            x = torch.randn(1, c, t, generator=g, device=device).to(dtype)
            for dil in (1, 3, 9):
                p = unit(c, c + dil, device)
                try:
                    ms = device_ms(lambda: fused_residual_unit(p, x, dil, dtype))
                except ValueError:   # a shape this tree's kernel refuses
                    ms = None
                else:
                    total += (1 if (c, t) in ENCODER_SHAPES else 2) * ms
                per_shape.append({"C": c, "T": t, "dilation": dil, "device_ms": ms})
            del x
        torch.cuda.empty_cache()
        record[name] = {"total_device_ms": total, "per_shape": per_shape}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    record["card"] = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None
    print(json.dumps(record))


if __name__ == "__main__":
    main()
