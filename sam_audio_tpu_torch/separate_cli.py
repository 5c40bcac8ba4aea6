"""Command-line separation on the card (counterpart of sam_audio_tpu/separate_cli.py):

  python -m sam_audio_tpu_torch.separate_cli -p <snapshot> -i mixture.wav \\
      -d "a dog barking" [-o outdir] [-c 8] [--spans 2.0 4.5] [--predict-spans] \\
      [--window-s 0] [--int8] [--seed 0] [--device cuda]

Writes <outdir>/target.wav and <outdir>/residual.wav. With --window-s > 0 the
clip streams through windows of that many seconds (any length). --seed
seeds a torch.Generator on the device, so a run is reproducible on one
device. --device cpu runs on the CPU (tests); with the default cuda and no
GPU it refuses to run.
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", "-p", required=True, help="local snapshot directory")
    ap.add_argument("--input", "-i", required=True, help="mixture audio file")
    ap.add_argument("--description", "-d", required=True,
                    help="text prompt describing the target sound")
    ap.add_argument("--out", "-o", default=".")
    ap.add_argument("--candidates", "-c", type=int, default=1)
    ap.add_argument("--predict-spans", action="store_true")
    ap.add_argument("--spans", type=float, nargs=2, action="append", metavar=("START", "END"),
                    help="temporal anchor in seconds; repeatable")
    ap.add_argument("--window-s", type=float, default=0.0,
                    help=">0 streams the clip through windows of this many seconds")
    ap.add_argument("--batch-windows", type=int, default=1,
                    help="streaming: solve N windows per separate() call")
    ap.add_argument("--preview-nfe", type=int, default=0,
                    help="opt-in fast reranking: rank candidates on N-evaluation "
                         "previews, re-solve the winner at the full budget")
    ap.add_argument("--int8", action="store_true",
                    help="opt-in int8 serving mode (model.quantize(8))")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--allow-random-towers", action="store_true",
                    help="tests only: let missing sub-towers and tokenizer assets fall "
                         "back to random / byte-level stand-ins instead of raising")
    args = ap.parse_args(argv)

    import torch

    from sam_audio_tpu_torch import SAMAudio, SAMAudioProcessor
    from sam_audio_tpu_torch.audio_io import write_wav

    model = SAMAudio.from_pretrained(args.model, device=args.device,
                                     allow_random_towers=args.allow_random_towers)
    if args.int8:
        model.quantize(8)
    anchors = [("+", s, e) for s, e in (args.spans or [])] or None
    generator = torch.Generator(device=model.device).manual_seed(args.seed)
    os.makedirs(args.out, exist_ok=True)

    t0 = time.time()
    if args.window_s > 0:
        from sam_audio_tpu_torch.audio_io import load_audio
        from sam_audio_tpu_torch.ops.resample import resample_np
        from sam_audio_tpu_torch.streaming import separate_streaming

        wav, sr = load_audio(args.input)
        if sr != model.sample_rate:
            wav = resample_np(wav, sr, model.sample_rate)
        res = separate_streaming(model, args.description, wav, window_s=args.window_s,
                                 anchors=anchors, reranking_candidates=args.candidates,
                                 generator=generator, batch_windows=args.batch_windows,
                                 preview_nfe=args.preview_nfe or None)
        target, residual = res.target, res.residual
        print(f"streamed {res.num_windows} windows")
    else:
        batch = SAMAudioProcessor.from_pretrained(args.model)(
            descriptions=[args.description], audios=[args.input],
            anchors=[anchors] if anchors else None)
        result = model.separate(batch, reranking_candidates=args.candidates,
                                predict_spans=args.predict_spans, generator=generator,
                                preview_nfe=args.preview_nfe or None)
        target, residual = result.target[0], result.residual[0]
        if args.predict_spans and batch.anchors is not None:
            print(f"predicted spans: {[tuple(a[1:]) for a in batch.anchors[0]]}")

    write_wav(os.path.join(args.out, "target.wav"), target, model.sample_rate)
    write_wav(os.path.join(args.out, "residual.wav"), residual, model.sample_rate)
    dur = target.shape[-1] / model.sample_rate
    print(f"separated {dur:.1f}s in {time.time() - t0:.1f}s -> {args.out}/target.wav, "
          f"{args.out}/residual.wav")


if __name__ == "__main__":
    main()
