"""Training command line; counterpart of `python -m sam_audio_tpu.train`.

  python -m sam_audio_tpu_torch.train --records <dir> --model <snapshot> \
      --batch-size 8 --epochs 1 --ckpt-dir ckpts [--ema 0.999] [--device cuda]

Sharded record streaming (train/records.py) -> host batching + featurization
on the card (train/data.py) -> the flow-matching step with the codec and T5
frozen (train/flow_matching.py) -> rolling checkpoints with retention
(train/checkpoints.py) -> an exported serving snapshot (train/export.py).
`--task span` trains the native span predictor from the same records;
`--lora-rank R` trains LoRA adapters only. JAX's flags, plus `--device`
(default cuda; it raises without a card unless `--device cpu`).

Several ranks: `--dp`/`--tp` build a (dp, tp) mesh (parallel/mesh.py; the
params, the AdamW state and the EMA split by the Megatron rules, the batch
over dp). One process per rank, started by torchrun
(`python -m torch.distributed.run --nproc-per-node 4 -m
sam_audio_tpu_torch.train ... --dp 2 --tp 2`) or given `--coordinator
HOST:PORT --num-processes N --process-id I`; the backend follows the
topology (parallel/mesh.init_distributed). `--batch-size` is the global
batch: with `--synthetic` every rank draws it and trains on its dp block;
with `--records` each dp group reads its own record shards into batches of
batch-size / dp rows.

Smoke run (no data, random init):
  python -m sam_audio_tpu_torch.train --synthetic 8 --random-init --batch-size 2
"""

from __future__ import annotations

import argparse
import sys
import time


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m sam_audio_tpu_torch.train", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--task", default="flow", choices=("flow", "span"),
                    help="flow = flow-matching separation training; span = "
                         "train the native span predictor from the same "
                         "records (labels from target-stem activity; see "
                         "train/span.py)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for tests)")
    src = ap.add_argument_group("data")
    src.add_argument("--records", help="ShardWriter directory (index.json)")
    src.add_argument("--synthetic", type=int, default=0, metavar="N",
                     help="train on N random batches (smoke tests)")
    src.add_argument("--batch-size", type=int, default=8)
    src.add_argument("--epochs", type=int, default=1)
    src.add_argument("--max-steps", type=int, default=0,
                     help="stop after this many optimizer steps (0 = off)")
    src.add_argument("--bucket-seconds", type=float, default=2.0,
                     help="length-bucket granularity (fixes the batch shapes)")
    src.add_argument("--prefetch", type=int, default=2)
    src.add_argument("--seed", type=int, default=0)

    mdl = ap.add_argument_group("model")
    mdl.add_argument("--model", "-p", help="snapshot directory (config.json + "
                                           "params.npz or checkpoint.pt)")
    mdl.add_argument("--random-init", action="store_true",
                     help="random-init the model (pretraining / smoke)")
    mdl.add_argument("--config", help="config.json for --random-init "
                                      "(default: the flagship's widths)")
    mdl.add_argument("--train-towers", action="store_true",
                     help=argparse.SUPPRESS)  # rejected: see main()

    opt = ap.add_argument_group("optimizer")
    opt.add_argument("--lr", type=float, default=1e-4)
    opt.add_argument("--weight-decay", type=float, default=0.01)
    opt.add_argument("--grad-clip", type=float, default=1.0)
    opt.add_argument("--lr-schedule", default="constant",
                     choices=("constant", "cosine", "linear"))
    opt.add_argument("--warmup-steps", type=int, default=0)
    opt.add_argument("--total-steps", type=int, default=0,
                     help="decay horizon for cosine/linear (default: "
                          "max-steps or epochs*len(data)/batch)")
    opt.add_argument("--final-lr-ratio", type=float, default=0.0)
    opt.add_argument("--ema", type=float, default=0.0, metavar="DECAY")
    opt.add_argument("--accum-steps", type=int, default=1)
    opt.add_argument("--remat", default="full", choices=("full", "dots"),
                     help="backward-pass rematerialization: 'full' = about one "
                          "layer's activation memory; 'dots' = keep the linear "
                          "outputs (less recompute, more memory)")

    lora = ap.add_argument_group("lora")
    lora.add_argument("--lora-rank", type=int, default=0, metavar="R",
                      help="train LoRA adapters of rank R instead of full "
                           "fine-tuning (base weights frozen)")
    lora.add_argument("--lora-alpha", type=float, default=None,
                      help="LoRA scaling numerator (default: rank)")
    lora.add_argument("--lora-targets", default="attention",
                      choices=("attention", "attention+ffn"),
                      help="which weights get adapters")
    lora.add_argument("--lora-out", metavar="FILE.npz",
                      help="write the trained adapters (EMA if --ema) as an npz "
                           "that train.lora.merge_lora_checkpoint of either "
                           "package loads")

    span = ap.add_argument_group("span (--task span)")
    span.add_argument("--span-hidden", type=int, default=512)
    span.add_argument("--span-layers", type=int, default=4)
    span.add_argument("--span-heads", type=int, default=8)
    span.add_argument("--span-pos-weight", type=float, default=2.0,
                      help="BCE positive-class weight (active frames are "
                           "usually the minority)")

    par = ap.add_argument_group("parallelism")
    par.add_argument("--dp", type=int, default=0,
                     help="data-parallel mesh size (0 = ranks // tp)")
    par.add_argument("--tp", type=int, default=1, help="tensor-parallel mesh size")
    par.add_argument("--coordinator", metavar="HOST:PORT",
                     help="multi-process: the rendezvous address (torchrun's "
                          "environment replaces all three)")
    par.add_argument("--num-processes", type=int, default=0)
    par.add_argument("--process-id", type=int, default=-1)

    ck = ap.add_argument_group("checkpoints")
    ck.add_argument("--ckpt-dir", help="rolling TrainState checkpoints")
    ck.add_argument("--save-every", type=int, default=500)
    ck.add_argument("--max-to-keep", type=int, default=3)
    ck.add_argument("--keep-period", type=int, default=0,
                    help="additionally keep every Nth step forever")
    ck.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint before training")
    ck.add_argument("--export-dir", metavar="DIR",
                    help="after training, write a serving snapshot "
                         "(config.json + params.npz; EMA weights if --ema) "
                         "that SAMAudio.from_pretrained of either package loads")

    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--allow-random-towers", action="store_true",
                    help="tests only: permit the byte-fallback tokenizer etc.")
    return ap


def _load_model(args):
    """(cfg, fp32 params on the device, tokenizer): the trainer's master
    copy comes from the stored (or freshly initialised) fp32 tree, never
    from a model whose matmul weights were cast to the compute dtype."""
    import torch

    from sam_audio_tpu_torch.models.sam_audio import resolve_device
    from sam_audio_tpu_torch.text_tokenizer import get_text_tokenizer

    device = resolve_device(args.device)
    if args.random_init:
        from sam_audio_tpu_torch.config import SAMAudioConfig
        from sam_audio_tpu_torch.models.init import sam_audio_init

        cfg = SAMAudioConfig.from_json(args.config) if args.config else SAMAudioConfig()
        params = sam_audio_init(cfg, torch.Generator(device=device).manual_seed(args.seed),
                                device)
        allow_fallback = True
    elif args.model:
        from sam_audio_tpu_torch.checkpoint import load_snapshot

        cfg, params = load_snapshot(args.model, device,
                                    allow_random_towers=args.allow_random_towers)
        allow_fallback = args.allow_random_towers
    else:
        raise SystemExit("one of --model or --random-init is required")
    return cfg, params, get_text_tokenizer(cfg.text_encoder, allow_fallback=allow_fallback)


def _open_records(args, mesh=None):
    """Returns (dataset, steps_per_epoch_estimate) for --records. On a mesh
    each dp group reads its own shards (the tp ranks of a group the same
    ones)."""
    from sam_audio_tpu_torch.train.records import ShardedRecordDataset

    kw = {}
    if mesh is not None:
        kw = dict(process_index=mesh.axis_index("dp"), process_count=mesh.axis_size("dp"))
    ds = ShardedRecordDataset(args.records, seed=args.seed, **kw)
    # --batch-size is per process alone, the global batch on a mesh
    per_epoch = max(len(ds) // (args.batch_size * (1 if kw else ds.process_count)), 1)
    return ds, per_epoch


def _checkpoints(args, interval: int):
    if not args.ckpt_dir:
        return None
    from sam_audio_tpu_torch.train.checkpoints import TrainCheckpointManager

    return TrainCheckpointManager(args.ckpt_dir, max_to_keep=args.max_to_keep,
                                  keep_period=args.keep_period or None,
                                  save_interval_steps=interval)


def _resume(args, mgr, trainer):
    if mgr is not None and args.resume and mgr.latest_step() is not None:
        trainer.state = mgr.restore(trainer.state)
        print(f"resumed from step {int(trainer.state.step)}", file=sys.stderr)


def _record_batches(args, pipeline, mesh=None):
    from sam_audio_tpu_torch.train.records import iter_batches

    ds, _ = _open_records(args, mesh)
    batch_size = args.batch_size // ds.process_count if mesh is not None else args.batch_size
    for epoch in range(args.epochs):
        # every process the same batch count (see records.batches_per_epoch)
        yield from iter_batches(ds.epoch(epoch), pipeline, batch_size,
                                prefetch=args.prefetch,
                                max_batches=ds.batches_per_epoch(epoch, batch_size))


def _run_span(args, cfg, params, tokenizer, total_steps) -> int:
    """--task span: train the native span predictor (train/span.py);
    --export-dir writes <dir>/span_predictor/, which from_pretrained
    attaches."""
    import torch

    from sam_audio_tpu_torch.models.span_predictor import SpanPredictorConfig
    from sam_audio_tpu_torch.train.span import (
        SpanDataPipeline, SpanTrainer, save_span_predictor, synthetic_span_batch)

    codec = cfg.audio_codec
    sp_cfg = SpanPredictorConfig(
        audio_dim=min(128, codec.codebook_dim), text_dim=cfg.text_encoder.dim,
        hidden=args.span_hidden, n_layers=args.span_layers, n_heads=args.span_heads,
        frame_rate=codec.sample_rate / codec.hop_length)
    trainer = SpanTrainer(
        sp_cfg, device=args.device, seed=args.seed + 3, learning_rate=args.lr,
        weight_decay=args.weight_decay, grad_clip=args.grad_clip,
        lr_schedule=args.lr_schedule, warmup_steps=args.warmup_steps,
        total_steps=total_steps, final_lr_ratio=args.final_lr_ratio,
        pos_weight=args.span_pos_weight)
    mgr = _checkpoints(args, args.save_every)
    _resume(args, mgr, trainer)

    def batches():
        if args.synthetic:
            gen = torch.Generator(device=trainer.device).manual_seed(args.seed + 29)
            for _ in range(args.epochs * args.synthetic):
                yield synthetic_span_batch(cfg, sp_cfg, gen, batch_size=args.batch_size)
            return
        yield from _record_batches(args, SpanDataPipeline(
            cfg, params, tokenizer, sp_cfg, bucket_seconds=args.bucket_seconds))

    print(f"span training starts: total_steps~{total_steps} batch={args.batch_size}",
          file=sys.stderr)
    t0 = time.time()
    n = 0
    try:
        for batch in batches():
            metrics = trainer.step(batch)
            n += 1
            step = int(trainer.state.step)
            if args.log_every and (n - 1) % args.log_every == 0:
                print(f"step {step}: loss={float(metrics['loss']):.4f} "
                      f"f1={float(metrics['frame_f1']):.3f}", file=sys.stderr)
            if mgr is not None:
                mgr.save(trainer.state)
            if args.max_steps and step >= args.max_steps:
                break
    finally:
        if mgr is not None:
            mgr.save(trainer.state, force=True)
    if args.export_dir:
        sp_dir = save_span_predictor(args.export_dir, sp_cfg, trainer.state.params)
        print(f"wrote span predictor to {sp_dir}", file=sys.stderr)
    print(f"done: {n} steps in {time.time() - t0:.1f}s "
          f"(final step {int(trainer.state.step)})", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if not args.records and not args.synthetic:
        raise SystemExit("one of --records or --synthetic is required")
    if args.train_towers:
        # the towers featurize batches in the data pipeline, outside the loss
        # graph, so they get no gradient; the flag would only decay them
        raise SystemExit(
            "--train-towers is rejected: tower features are precomputed in "
            "the data pipeline, so the towers get zero gradient; enabling "
            "their weight decay would only corrupt them. Train the DiT "
            "(default) or use --lora-rank.")
    if args.lora_out and args.lora_rank <= 0:
        raise SystemExit("--lora-out requires --lora-rank")

    import torch
    import torch.distributed as dist

    from sam_audio_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from sam_audio_tpu_torch.train.flow_matching import (
        DEFAULT_FROZEN_PREFIXES, Trainer, synthetic_batch)

    # multi-process: the flags, or torchrun's environment
    joined = dist.is_initialized()
    args.device = str(init_distributed(args.device, args.coordinator, args.num_processes,
                                       args.process_id))
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = None
    if args.tp > 1 or args.dp > 1 or world > 1:
        mesh = make_mesh(dp=args.dp or None, tp=args.tp)
        print(f"mesh: dp={mesh.shape['dp']} tp={mesh.shape['tp']}", file=sys.stderr)
        if args.records and args.batch_size % mesh.shape["dp"]:
            raise SystemExit(f"--batch-size {args.batch_size} must divide over "
                             f"dp={mesh.shape['dp']}")

    cfg, params, tokenizer = _load_model(args)

    # All step accounting (--max-steps, --save-every, the schedule horizon)
    # is in OPTIMIZER steps: with --accum-steps k, state.step counts
    # micro-steps and the schedule advances once per k of them.
    accum = max(int(args.accum_steps), 1)
    total_steps = args.total_steps or args.max_steps
    if not total_steps and args.records:
        _, per_epoch = _open_records(args, mesh)
        total_steps = max(per_epoch * args.epochs // accum, 1)
    if not total_steps:
        total_steps = max(args.synthetic * args.epochs // accum, 1)

    if args.task == "span":
        return _run_span(args, cfg, params, tokenizer, total_steps)

    pipeline = None
    if args.records:
        from sam_audio_tpu_torch.train.data import FlowMatchingDataPipeline

        # featurization runs the frozen towers whole on every rank
        pipeline = FlowMatchingDataPipeline(cfg, params, tokenizer,
                                            bucket_seconds=args.bucket_seconds)
    common = dict(mesh=mesh, local_batches=mesh is not None and not args.synthetic,
                  device=args.device,
                  learning_rate=args.lr,
                  weight_decay=args.weight_decay, grad_clip=args.grad_clip,
                  lr_schedule=args.lr_schedule, warmup_steps=args.warmup_steps,
                  total_steps=total_steps, final_lr_ratio=args.final_lr_ratio,
                  ema_decay=args.ema, accum_steps=args.accum_steps, remat=args.remat)
    if args.lora_rank > 0:
        from sam_audio_tpu_torch.train.lora import LoRATrainer

        trainer = LoRATrainer(cfg, params, rank=args.lora_rank, alpha=args.lora_alpha,
                              targets=args.lora_targets, seed=args.seed + 7, **common)
    else:
        trainer = Trainer(cfg, params, seed=args.seed + 17, **common)
    del params

    # state.step counts micro-steps; --save-every is optimizer steps
    mgr = _checkpoints(args, args.save_every * accum)
    _resume(args, mgr, trainer)
    print(f"training starts: total_steps~{total_steps} batch={args.batch_size} "
          f"frozen={list(DEFAULT_FROZEN_PREFIXES)}", file=sys.stderr)

    def batches():
        if args.synthetic:
            # the global batch, the same on every rank (the trainer takes
            # this rank's dp block)
            gen = torch.Generator(device=trainer.device).manual_seed(args.seed + 19)
            for _ in range(args.epochs * args.synthetic):
                yield synthetic_batch(cfg, gen, batch_size=args.batch_size)
            return
        yield from _record_batches(args, pipeline, mesh)

    t0 = time.time()
    n = 0
    try:
        for batch in batches():
            metrics = trainer.step(batch)
            n += 1
            step = int(trainer.state.step)
            if args.log_every and (n - 1) % args.log_every == 0:
                rate = n / (time.time() - t0)
                print(f"step {step}: loss={float(metrics['loss']):.4f} "
                      f"grad_norm={float(metrics['grad_norm']):.3f} ({rate:.2f} steps/s)",
                      file=sys.stderr)
            if mgr is not None:
                mgr.save(trainer.state)
            if args.max_steps and step >= args.max_steps * accum:
                break
    finally:
        if mgr is not None:
            mgr.save(trainer.state, force=True)

    writer = not dist.is_initialized() or dist.get_rank() == 0
    if args.lora_out and writer:
        trainer.save_adapters(args.lora_out)   # the adapters are whole on every rank
        print(f"wrote LoRA adapters to {args.lora_out}", file=sys.stderr)
    if args.export_dir:
        from sam_audio_tpu_torch.train.export import export_snapshot

        # under LoRA: the merged weights (base + scaled B@A); on a mesh the
        # whole tree, gathered on every rank and written by rank 0
        full = trainer.full_params(trainer.ema_inference_params())
        if writer:
            export_snapshot(cfg, full, args.export_dir)
            print(f"exported serving snapshot to {args.export_dir}", file=sys.stderr)
    print(f"done: {n} steps in {time.time() - t0:.1f}s "
          f"(final step {int(trainer.state.step)})", file=sys.stderr)
    if dist.is_initialized() and not joined:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
