"""Flow-matching training walkthrough (the JAX package's
examples/train_flow_matching.py).

The reference only separates; the port also trains:
  1. (mixture, target, residual, text) examples written to sharded records,
  2. streamed back with a per-epoch shuffle and prefetched featurization,
  3. the flow-matching Trainer (warmup + cosine, EMA; pass
     mesh=parallel.make_mesh(dp=..., tp=...) to train across ranks),
  4. rolling checkpoints with retention, the manager used as a context
     manager, a restore into a fresh Trainer,
  5. the EMA weights exported as a snapshot and separated.

A tiny model with random weights and synthetic tone / noise stems. For a
real run: point `make_examples` at your stems and size the config in
config.json.

Run: python -m sam_audio_tpu_torch.examples.train_flow_matching [--steps 30]
[--batch-size 4] [--device cpu] [--out DIR]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from sam_audio_tpu_torch import DACVAEConfig, SAMAudio, SAMAudioProcessor, tiny_test_config
from sam_audio_tpu_torch.models.init import sam_audio_init
from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer
from sam_audio_tpu_torch.train import (
    ShardedRecordDataset, TrainCheckpointManager, Trainer, iter_batches, write_shards)
from sam_audio_tpu_torch.train.data import FlowMatchingDataPipeline, TrainExample
from sam_audio_tpu_torch.train.export import export_snapshot


def make_examples(n: int, sample_rate: int, seconds: float = 0.25, seed: int = 0):
    """Synthetic stems: target = a tone, residual = a noise bed."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    out = []
    for i in range(n):
        f = float(rng.uniform(200, 2000))
        target = (0.3 * np.sin(2 * np.pi * f * t)).astype(np.float32)
        residual = (0.1 * rng.randn(t.size)).astype(np.float32)
        out.append(TrainExample(mixture=target + residual, target=target, residual=residual,
                                description=f"a {int(f)} Hz tone",
                                anchors=[("+", 0.0, seconds)] if i % 2 == 0 else None))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--out", default="sam_audio_train_demo")
    args = ap.parse_args(argv)

    # the tiny test model with a codec whose widths the residual units'
    # kernel takes on the card (multiples of 32)
    cfg = tiny_test_config(audio_codec=DACVAEConfig(
        encoder_dim=32, encoder_rates=(2, 4), latent_dim=16, decoder_dim=128,
        decoder_rates=(4, 2), codebook_dim=4, sample_rate=8000))
    sr = cfg.audio_codec.sample_rate
    tok = ByteFallbackTokenizer(cfg.text_encoder.vocab_size)
    # fp32 master weights (the trainer's; SAMAudio casts its own copy)
    params = sam_audio_init(cfg, torch.Generator().manual_seed(0), "cpu")

    # 1. sharded records on disk
    records_dir = os.path.join(args.out, "records")
    if not os.path.exists(os.path.join(records_dir, "index.json")):
        write_shards(make_examples(64, sr), records_dir, shard_size=16)
    dataset = ShardedRecordDataset(records_dir, seed=0)
    print(f"dataset: {len(dataset)} examples in {dataset.index['num_shards']} shards")

    # 3. the trainer holds the params on the device (pass mesh= for several ranks)
    trainer = Trainer(cfg, params, device=args.device, learning_rate=3e-4,
                      lr_schedule="cosine", warmup_steps=5, total_steps=args.steps,
                      ema_decay=0.99)

    # 2. streaming batches: featurization on a thread, ahead of the steps
    pipeline = FlowMatchingDataPipeline(cfg, trainer.state.params, tok)

    def batches(num_steps):
        done, epoch = 0, 0
        while done < num_steps:
            for batch in iter_batches(dataset.epoch(epoch), pipeline, args.batch_size):
                yield batch
                done += 1
                if done >= num_steps:
                    return
            epoch += 1

    # 4. rolling checkpoints with retention; resume if one exists
    ckpt_dir = os.path.join(args.out, "ckpt")
    with TrainCheckpointManager(ckpt_dir, max_to_keep=2, keep_period=10) as mgr:
        if mgr.latest_step() is not None:
            trainer.state = mgr.restore(trainer.state)
            print(f"resumed from step {int(trainer.state.step)}")
        history = trainer.fit(batches(args.steps), log_every=10)
        mgr.save(trainer.state, force=True)
        mgr.wait_until_finished()
        print(f"checkpoints kept: {mgr.all_steps()}")
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"loss: {first:.4f} -> {last:.4f} over {len(history)} steps")

    # the latest checkpoint restores into a fresh trainer
    fresh = Trainer(cfg, sam_audio_init(cfg, torch.Generator().manual_seed(0), "cpu"),
                    device=args.device, learning_rate=3e-4, lr_schedule="cosine",
                    warmup_steps=5, total_steps=args.steps, ema_decay=0.99)
    fresh.state = TrainCheckpointManager(ckpt_dir).restore(fresh.state)
    print(f"restored step {int(fresh.state.step)}")

    # 5. the EMA weights as a snapshot, loaded and separated
    snapshot = export_snapshot(cfg, fresh.ema_inference_params(), os.path.join(args.out,
                                                                                "export"))
    model = SAMAudio.from_pretrained(snapshot, device=args.device, tokenizer=tok)
    processor = SAMAudioProcessor(audio_hop_length=cfg.audio_codec.hop_length,
                                  audio_sampling_rate=sr)
    ex = make_examples(1, sr, seed=7)[0]
    batch = processor(descriptions=[ex.description], audios=[ex.mixture[None]])
    result = model.separate(batch, generator=torch.Generator(device=model.device).manual_seed(2))
    print("separated:", np.asarray(result.target[0]).shape)
    return history, result


if __name__ == "__main__":
    main()
