"""The port's training data path and checkpoints against the JAX package
(fp32, CPU, tiny model, inputs from a numpy seed; bound 1e-4):
pad_text_to_bucket, the processor's length buckets and anchor slots,
encode_training_batch and FlowMatchingDataPipeline.make_batch, records
written by either package's ShardWriter read by the other's dataset (the
same examples in the same order per epoch and per process shard),
checkpoint retention against JAX's orbax manager on the same save steps,
and save -> restore -> step bit-identical on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_audio_tpu.config import tiny_test_config as jax_tiny_config
from sam_audio_tpu.models.sam_audio import sam_audio_init as jax_sam_audio_init
from sam_audio_tpu.processor import SAMAudioProcessor as JaxProcessor
from sam_audio_tpu.text_tokenizer import ByteFallbackTokenizer as JaxByteTokenizer
from sam_audio_tpu.train import checkpoints as jck
from sam_audio_tpu.train import data as jdata
from sam_audio_tpu.train import records as jrec
from sam_audio_tpu.train.flow_matching import TrainState as JaxTrainState
from sam_audio_tpu_torch.checkpoint import params_from_numpy
from sam_audio_tpu_torch.config import SAMAudioConfig
from sam_audio_tpu_torch.processor import SAMAudioProcessor
from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer
from sam_audio_tpu_torch.train import checkpoints as ck
from sam_audio_tpu_torch.train import data
from sam_audio_tpu_torch.train import flow_matching as fm
from sam_audio_tpu_torch.train import records
from sam_audio_tpu_torch.utils import tree_leaves_with_path

TOL = dict(rtol=1e-4, atol=1e-4)
SR = 8000    # the tiny config: hop 8 at 8 kHz


def tiny_pair(**tr):
    cfg = jax_tiny_config()
    if tr:
        cfg = jax_tiny_config(transformer=dataclasses.replace(cfg.transformer, **tr))
    params = jax.tree_util.tree_map(np.asarray, jax_sam_audio_init(jax.random.PRNGKey(0), cfg))
    return cfg, SAMAudioConfig.from_dict(dataclasses.asdict(cfg)), params


def examples(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        length = int(rng.randint(60, 140))
        target = (0.3 * rng.randn(length)).astype(np.float32)
        residual = (0.1 * rng.randn(length)).astype(np.float32)
        anchors = [("+", 0.001, 0.006), ("-", 0.008, 0.01)][: i % 3] or None
        mixture = (target + residual)[None] if i % 2 else target + residual
        out.append(data.TrainExample(mixture=mixture, target=target, residual=residual,
                                     description=["a dog barking", "rain",
                                                  "speech in a café"][i % 3],
                                     anchors=anchors))
    return out


def as_jax(ex):
    return jdata.TrainExample(mixture=ex.mixture, target=ex.target, residual=ex.residual,
                              description=ex.description, anchors=ex.anchors)


@pytest.mark.parametrize("width,multiple", [(5, 16), (16, 16), (17, 16), (3, 4), (1, 8)])
def test_pad_text_to_bucket_equals_jax(width, multiple):
    rng = np.random.RandomState(width)
    ids = rng.randint(1, 50, (2, width)).astype(np.int32)
    mask = rng.rand(2, width) > 0.3
    got = data.pad_text_to_bucket(ids, mask, multiple)
    ref = jdata.pad_text_to_bucket(ids, mask, multiple)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("anchors,pad_to", [(None, None), (None, 8), ([[("+", 0.0, 0.004)],
                                                                        []], 8),
                                            ([[("+", 0.0, 0.004), ("-", 0.005, 0.009)],
                                              [("+", 0.001, 0.002)]], None)])
def test_processor_buckets_and_anchor_slots_equal_jax(anchors, pad_to):
    rng = np.random.RandomState(1)
    audios = [rng.randn(1, 77).astype(np.float32), rng.randn(2, 50).astype(np.float32)]
    kw = dict(descriptions=["a", "b"], audios=audios, anchors=anchors, pad_anchors_to=pad_to)
    ours = SAMAudioProcessor(8, SR, bucket_seconds=0.01)(**kw)
    ref = JaxProcessor(audio_hop_length=8, audio_sampling_rate=SR, bucket_seconds=0.01)(**kw)
    assert ours.audios.shape[-1] == 80
    for name in ("audios", "audio_pad_mask", "anchor_ids", "anchor_alignment", "sizes"):
        np.testing.assert_array_equal(getattr(ours, name), np.asarray(getattr(ref, name)),
                                      err_msg=name)


@pytest.mark.parametrize("with_anchors", [True, False])
def test_make_batch_matches_jax(with_anchors):
    jcfg, cfg, params = tiny_pair()
    exs = examples(3, seed=2)
    if not with_anchors:
        exs = [dataclasses.replace(e, anchors=None) for e in exs]
    tok = ByteFallbackTokenizer(cfg.text_encoder.vocab_size)
    jtok = JaxByteTokenizer(jcfg.text_encoder.vocab_size)
    kw = dict(bucket_seconds=0.01, text_bucket=16, pad_anchors_to=8)
    ours = data.FlowMatchingDataPipeline(cfg, params_from_numpy(params), tok, **kw)
    ref = jdata.FlowMatchingDataPipeline(jcfg, jax.tree_util.tree_map(jnp.asarray, params),
                                         jtok, **kw).make_batch([as_jax(e) for e in exs])
    got = ours.make_batch(exs)
    assert set(got) == set(ref)
    assert got["audio_features"].shape[1] == 20        # 140 samples -> 160 -> 20 frames
    assert got["anchor_ids"].shape[1] == 8
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), err_msg=k, **TOL)
    assert not any(t.requires_grad for t in got.values())


def test_encode_training_batch_matches_jax():
    jcfg, cfg, params = tiny_pair()
    rng = np.random.RandomState(5)
    b, n = 2, 96
    wav = [rng.randn(b, 1, n).astype(np.float32) * 0.2 for _ in range(3)]
    ids = rng.randint(3, 200, (b, 6)).astype(np.int32)
    mask = np.ones((b, 6), bool)
    mask[1, 4:] = False
    anchor_ids = np.array([[0, 3, 1, 3], [0, 3, 3, 3]], np.int32)
    align = np.zeros((b, n // 8), np.int32)
    align[0, 2:5] = 2
    pad = np.ones((b, n // 8), bool)
    pad[1, 10:] = False
    args = (*wav, ids, mask, anchor_ids, align, pad)
    ref = jdata.encode_training_batch(jax.tree_util.tree_map(jnp.asarray, params),
                                      *map(jnp.asarray, args), cfg=jcfg)
    tp = params_from_numpy(params)
    got = data.encode_training_batch(
        {"audio_codec": tp["audio_codec"], "text_encoder": tp["text_encoder"]},
        *(torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a)
          for a in args), cfg=cfg)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), err_msg=k, **TOL)


def _assert_same_examples(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for name in ("mixture", "target", "residual"):
            np.testing.assert_array_equal(getattr(x, name), getattr(y, name))
        assert x.description == y.description
        assert x.anchors == y.anchors


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_records_cross_read(tmp_path, writer):
    exs = examples(11, seed=3)
    if writer == "jax":
        jrec.write_shards([as_jax(e) for e in exs], str(tmp_path), shard_size=3)
    else:
        records.write_shards(exs, str(tmp_path), shard_size=3)
    for count in (1, 2, 3):
        for index in range(count):
            ours = records.ShardedRecordDataset(str(tmp_path), process_index=index,
                                                process_count=count, seed=4)
            ref = jrec.ShardedRecordDataset(str(tmp_path), process_index=index,
                                            process_count=count, seed=4)
            assert len(ours) == len(ref) == 11
            for epoch in (0, 1):
                _assert_same_examples(list(ours.epoch(epoch)), list(ref.epoch(epoch)))
                assert ours.batches_per_epoch(epoch, 2) == ref.batches_per_epoch(epoch, 2)
    # without torch.distributed the dataset is process 0 of 1
    whole = records.ShardedRecordDataset(str(tmp_path), seed=4)
    assert (whole.process_index, whole.process_count) == (0, 1)


def test_iter_batches_through_the_pipeline(tmp_path):
    """Records -> prefetching iter_batches -> make_batch, as the command line
    runs them; a consumer that stops early leaves no worker behind."""
    _, cfg, params = tiny_pair()
    records.write_shards(examples(7, seed=6), str(tmp_path), shard_size=4)
    ds = records.ShardedRecordDataset(str(tmp_path), seed=1)
    pipe = data.FlowMatchingDataPipeline(cfg, params_from_numpy(params),
                                         ByteFallbackTokenizer(cfg.text_encoder.vocab_size),
                                         bucket_seconds=0.01)
    got = list(records.iter_batches(ds.epoch(0), pipe, 2))
    assert len(got) == 3 and all(b["audio_features"].shape[0] == 2 for b in got)
    it = records.iter_batches(ds.epoch(1), pipe, 2, max_batches=1)
    assert next(it)["target_latents"].shape[0] == 2
    it.close()


def _jax_state(step):
    w = jnp.full((2,), float(step))
    return JaxTrainState({"w": w}, {"m": w}, jnp.asarray(step, jnp.int32), {"w": w})


def _port_state(step=0):
    params = {"w": torch.zeros(2), "frozen": torch.zeros(1)}
    state = fm.new_train_state(params, lambda p: p == "w", weight_decay=0.0, ema_decay=0.5,
                               accum_steps=1, generators={"noise": torch.Generator()})
    state.step = step
    return state


@pytest.mark.parametrize("max_to_keep,keep_period,interval", [
    (3, None, 1), (2, 4, 1), (3, None, 3), (None, None, 2), (1, 5, 2)])
def test_checkpoint_retention_matches_jax(tmp_path, max_to_keep, keep_period, interval):
    kw = dict(max_to_keep=max_to_keep, keep_period=keep_period, save_interval_steps=interval)
    jm = jck.TrainCheckpointManager(str(tmp_path / "jax"), **kw)
    pm = ck.TrainCheckpointManager(str(tmp_path / "port"), **kw)
    plan = [(s, False) for s in range(1, 13)] + [(13, True), (13, True), (11, True)]
    for step, force in plan:
        ref = jm.save(_jax_state(step), force=force)
        jm.wait_until_finished()
        assert pm.save(_port_state(step), force=force) == ref, (step, force)
        assert pm.all_steps() == jm.all_steps(), (step, force)
        assert pm.latest_step() == jm.latest_step()
    jm.close()
    reopened = ck.TrainCheckpointManager(str(tmp_path / "port"), **kw)
    assert reopened.all_steps() == pm.all_steps()


def test_save_restore_step_is_bit_identical(tmp_path):
    """Four steps straight, against two, a checkpoint, a fresh Trainer
    restored from it, and two more: dropout on (its generator restored),
    accumulation over 2 and an EMA."""
    _, cfg, params = tiny_pair(dropout=0.1)
    kw = dict(device="cpu", learning_rate=1e-3, lr_schedule="cosine", warmup_steps=1,
              total_steps=3, ema_decay=0.9, accum_steps=2, seed=5)
    g = torch.Generator().manual_seed(8)
    batches = [fm.synthetic_batch(cfg, g, t_frames=10) for _ in range(4)]

    straight = fm.Trainer(cfg, params_from_numpy(params), **kw)
    losses = [float(straight.step(b)["loss"]) for b in batches]

    first = fm.Trainer(cfg, params_from_numpy(params), **kw)
    for b in batches[:2]:
        first.step(b)
    mgr = ck.TrainCheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.save(first.state)
    first.step(batches[2])     # moves on past the checkpoint: the restore must not see it

    resumed = fm.Trainer(cfg, params_from_numpy(params), **kw)
    resumed.state = mgr.restore(resumed.state)
    assert resumed.state.step == 2
    got = [float(resumed.step(b)["loss"]) for b in batches[2:]]
    assert got == losses[2:]
    for tree in ("params", "ema_params"):
        a = dict(tree_leaves_with_path(getattr(straight.state, tree)))
        for path, x in tree_leaves_with_path(getattr(resumed.state, tree)):
            assert torch.equal(x, a[path]), (tree, path)
    sa, sb = straight.state.optimizer.state_dict(), resumed.state.optimizer.state_dict()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    with pytest.raises(FileNotFoundError):
        ck.TrainCheckpointManager(str(tmp_path / "empty")).restore(resumed.state)
