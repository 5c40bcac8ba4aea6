"""LoRA, span-predictor training and the training command line of the
PyTorch port against the JAX package (fp32, CPU, tiny models, inputs from a
numpy seed; bound 1e-4): lora_merge and a LoRATrainer step with JAX's
adapters injected, the adapter npz read both ways, frame_activity_labels,
span_bce_loss, SpanDataPipeline.make_batch and SpanTrainer steps, and
`python -m sam_audio_tpu_torch.train --device cpu` (flow, records with
--resume, LoRA, span), whose export the JAX package loads and separates like
the port."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_audio_tpu.config import tiny_test_config as jax_tiny_config
from sam_audio_tpu.models import span_predictor as jsp
from sam_audio_tpu.models.sam_audio import SAMAudio as JaxSAMAudio
from sam_audio_tpu.models.sam_audio import sam_audio_init as jax_sam_audio_init
from sam_audio_tpu.processor import SAMAudioProcessor as JaxProcessor
from sam_audio_tpu.text_tokenizer import ByteFallbackTokenizer as JaxByteTokenizer
from sam_audio_tpu.train import data as jdata
from sam_audio_tpu.train import lora as jlora
from sam_audio_tpu.train import span as jspan
from sam_audio_tpu_torch import SAMAudio, SAMAudioProcessor
from sam_audio_tpu_torch.checkpoint import load_span_predictor, params_from_numpy
from sam_audio_tpu_torch.config import SAMAudioConfig
from sam_audio_tpu_torch.models.span_predictor import SpanPredictorConfig
from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer
from sam_audio_tpu_torch.train import __main__ as cli
from sam_audio_tpu_torch.train import data, lora, records, span
from sam_audio_tpu_torch.utils import tree_leaves_with_path

TOL = dict(rtol=1e-4, atol=1e-4)


def tiny_pair(**tr):
    base = jax_tiny_config()
    tr = dict(dict(dim=128, n_heads=1, context_dim=128, frequency_embedding_dim=8), **tr)
    cfg = jax_tiny_config(transformer=dataclasses.replace(base.transformer, **tr))
    params = jax.tree_util.tree_map(np.asarray, jax_sam_audio_init(jax.random.PRNGKey(0), cfg))
    return cfg, SAMAudioConfig.from_dict(dataclasses.asdict(cfg)), params


def np_batch(cfg, seed, b=2, t=10, text_len=5):
    rng = np.random.RandomState(seed)
    c2 = 2 * cfg.audio_codec.codebook_dim
    pad = np.ones((b, t), bool)
    pad[1, 7:] = False
    return {
        "audio_features": rng.randn(b, t, c2).astype(np.float32),
        "target_latents": rng.randn(b, t, c2).astype(np.float32),
        "text_features": rng.randn(b, text_len, cfg.text_encoder.dim).astype(np.float32),
        "text_mask": np.ones((b, text_len), bool),
        "anchor_ids": np.array([[0, 3, 1, 3], [0, 3, 3, 3]], np.int32),
        "anchor_alignment": np.where(pad, 0, 1).astype(np.int32),
        "audio_pad_mask": pad,
    }


def to_torch(batch):
    return {k: (torch.from_numpy(np.array(v)).long() if np.asarray(v).dtype == np.int32
                else torch.from_numpy(np.array(v))) for k, v in batch.items()}


def jax_draws(rng, batch):
    t_rng, n_rng, _ = jax.random.split(rng, 3)
    x1 = batch["target_latents"]
    return (torch.from_numpy(np.array(jax.random.uniform(t_rng, (x1.shape[0],)))),
            torch.from_numpy(np.array(jax.random.normal(n_rng, x1.shape))))


def random_adapters(jadapters, seed):
    rng = np.random.RandomState(seed)
    return {k: {"a": np.asarray(v["a"]),
                "b": (0.05 * rng.randn(*v["b"].shape)).astype(np.float32)}
            for k, v in jadapters.items()}


def adapters_to_torch(adapters):
    """(params_from_numpy would unflatten the `a/b` path keys)"""
    return {k: {part: torch.from_numpy(np.array(x)) for part, x in ab.items()}
            for k, ab in adapters.items()}


def assert_adapters_close(ours, ref):
    for k, ab in ref.items():
        for part in ("a", "b"):
            np.testing.assert_allclose(ours[k][part].detach().numpy(), np.asarray(ab[part]),
                                       err_msg=f"{k}::{part}", **TOL)


@pytest.mark.parametrize("targets", ["attention", "attention+ffn"])
def test_lora_merge_matches_jax(targets):
    _, _, params = tiny_pair()
    jad = jlora.lora_init(jax.random.PRNGKey(1), params, rank=3,
                          targets=jlora.TARGET_PRESETS[targets])
    adapters = random_adapters(jad, 2)
    ref = jlora.lora_merge(params, adapters, 0.7)
    ours = lora.lora_merge(params_from_numpy(params), adapters_to_torch(adapters), 0.7)
    flat = dict(tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, ref)))
    for path, x in tree_leaves_with_path(ours):
        np.testing.assert_allclose(x.numpy(), flat[path], err_msg=path, **TOL)
    # the port's own init: the same targets, shapes and zero b
    ported = lora.lora_init(torch.Generator().manual_seed(0), params_from_numpy(params),
                            rank=3, targets=lora.TARGET_PRESETS[targets])
    assert list(ported) == sorted(jad) == list(jad)
    for k, ab in ported.items():
        assert ab["a"].shape == jad[k]["a"].shape and not ab["b"].any()
    with pytest.raises(ValueError, match="no params matched"):
        lora.lora_init(torch.Generator(), params_from_numpy(params), rank=2, targets=("nope",))


def test_lora_trainer_steps_match_jax():
    jcfg, cfg, params = tiny_pair()
    kw = dict(rank=4, alpha=8.0, learning_rate=1e-3, grad_clip=0.5, ema_decay=0.9,
              lr_schedule="linear", warmup_steps=1, total_steps=3)
    jt = jlora.LoRATrainer(jcfg, jax.tree_util.tree_map(jnp.asarray, params),
                           rng=jax.random.PRNGKey(1), **kw)
    adapters = random_adapters(jax.device_get(jt.state.params), 3)
    jt.state = jt.state._replace(
        params=jax.tree_util.tree_map(jnp.asarray, adapters),
        ema_params=jax.tree_util.tree_map(jnp.array, adapters))
    ours = lora.LoRATrainer(cfg, params_from_numpy(params), device="cpu", **kw)
    with torch.no_grad():
        for tree in (ours.state.params, ours.state.ema_params):
            for k, ab in tree.items():
                for part in ("a", "b"):
                    ab[part].copy_(torch.from_numpy(np.array(adapters[k][part])))
    rngs = jax.random.split(jax.random.PRNGKey(4), 3)
    for i, rng in enumerate(rngs):
        batch = np_batch(jcfg, 30 + i)
        ref = jt.step(batch, rng)
        t, x0 = jax_draws(rng, batch)
        got = ours.step(to_torch(batch), t=t, x0=x0)
        np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), **TOL)
        np.testing.assert_allclose(float(got["grad_norm"]), float(ref["grad_norm"]), **TOL)
    assert_adapters_close(ours.adapters, jax.device_get(jt.state.params))
    assert_adapters_close(ours.ema_adapters(), jax.device_get(jt.ema_adapters()))
    # the base did not move and takes no gradient
    for path, x in tree_leaves_with_path(ours.base_params):
        assert not x.requires_grad
        assert np.array_equal(x.numpy(), dict(tree_leaves_with_path(params))[path]), path
    merged = ours.ema_inference_params()
    ref = dict(tree_leaves_with_path(jax.tree_util.tree_map(np.asarray,
                                                            jt.ema_inference_params())))
    for path, x in tree_leaves_with_path(merged):
        assert not x.requires_grad
        np.testing.assert_allclose(x.numpy(), ref[path], err_msg=path, **TOL)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lora_npz_reads_both_ways(tmp_path, writer):
    _, _, params = tiny_pair()
    jad = jlora.lora_init(jax.random.PRNGKey(1), params, rank=2)
    adapters = random_adapters(jad, 4)
    path = str(tmp_path / "adapters.npz")
    kw = dict(rank=2, alpha=3.0, targets=jlora.DEFAULT_TARGETS)
    if writer == "jax":
        jlora.save_lora(path, adapters, **kw)
        got, meta = lora.load_lora(path)
        ref_meta = jlora.load_lora(path)[1]
    else:
        lora.save_lora(path, adapters_to_torch(adapters), **kw)
        got, meta = jlora.load_lora(path)
        got = adapters_to_torch(got)
        ref_meta = lora.load_lora(path)[1]
    assert meta == ref_meta == {"rank": 2, "alpha": 3.0, "targets": list(jlora.DEFAULT_TARGETS),
                                "scaling": 1.5}
    assert_adapters_close(got, adapters)
    ours = lora.merge_lora_checkpoint(params_from_numpy(params), path)
    ref = dict(tree_leaves_with_path(jax.tree_util.tree_map(
        np.asarray, jlora.merge_lora_checkpoint(params, path))))
    for p, x in tree_leaves_with_path(ours):
        np.testing.assert_allclose(x.numpy(), ref[p], err_msg=p, **TOL)


@pytest.mark.parametrize("t_frames,n", [(12, 96), (12, 90), (10, 100)])
def test_frame_activity_labels_match_jax(t_frames, n):
    rng = np.random.RandomState(n)
    w = (rng.randn(3, 1, n) * np.linspace(0, 1, n)).astype(np.float32)
    w[1, 0, : n // 2] = 0.0
    w[2] = 0.0                       # an all-silent stem: no active frame
    ours = span.frame_activity_labels(w, 8, t_frames)
    ref = np.asarray(jspan.frame_activity_labels(w, 8, t_frames))
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert ref[0].any() and not ref[2].any()


def span_setup(seed=0):
    jcfg = jsp.SpanPredictorConfig(audio_dim=4, text_dim=16, hidden=64, n_layers=2, n_heads=4)
    params = jax.tree_util.tree_map(
        np.asarray, jsp.span_predictor_init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.RandomState(seed + 1)
    b, t = 2, 14
    feats = rng.randn(b, t, 4).astype(np.float32)
    pad = np.ones((b, t), bool)
    pad[1, 10:] = False
    tmask = np.ones((b, 6), bool)
    tmask[0, 4:] = False
    batch = {"audio_features": feats,
             "text_features": rng.randn(b, 6, 16).astype(np.float32),
             "text_mask": tmask, "audio_pad_mask": pad,
             "labels": (rng.rand(b, t) > 0.6).astype(np.float32)}
    return jcfg, SpanPredictorConfig(**dataclasses.asdict(jcfg)), params, batch


@pytest.mark.parametrize("pos_weight", [1.0, 2.5])
def test_span_bce_loss_matches_jax(pos_weight):
    jcfg, cfg, params, batch = span_setup()
    ref, ref_logits = jspan.span_bce_loss(params, jcfg, batch, pos_weight, return_logits=True)
    tb = to_torch(batch)
    ours, logits = span.span_bce_loss(params_from_numpy(params), cfg, tb, pos_weight,
                                      return_logits=True)
    np.testing.assert_allclose(float(ours), float(ref), **TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    got = span._frame_metrics(logits, tb["labels"], tb["audio_pad_mask"])
    want = jspan._frame_metrics(ref_logits, batch["labels"], batch["audio_pad_mask"])
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), err_msg=k, **TOL)


def test_span_trainer_steps_match_jax():
    jcfg, cfg, params, batch = span_setup()
    kw = dict(learning_rate=3e-3, weight_decay=0.05, grad_clip=0.3, lr_schedule="cosine",
              warmup_steps=1, total_steps=4, pos_weight=2.0)
    jt = jspan.SpanTrainer(jcfg, jax.tree_util.tree_map(jnp.asarray, params), **kw)
    ours = span.SpanTrainer(cfg, params_from_numpy(params), device="cpu", **kw)
    for i in range(3):
        b = dict(batch, labels=np.roll(batch["labels"], i, axis=1))
        ref = jt.step(b)
        got = ours.step(to_torch(b))
        for k in ("loss", "grad_norm", "frame_precision", "frame_recall", "frame_f1"):
            np.testing.assert_allclose(float(got[k]), float(ref[k]), err_msg=k, **TOL)
    flat = dict(tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jt.state.params)))
    for path, x in tree_leaves_with_path(ours.state.params):
        np.testing.assert_allclose(x.detach().numpy(), flat[path], err_msg=path, **TOL)


def test_span_data_pipeline_matches_jax():
    jcfg, cfg, params = tiny_pair()
    jsp_cfg = jsp.SpanPredictorConfig(audio_dim=4, text_dim=16, hidden=32, n_layers=1,
                                      n_heads=2)
    rng = np.random.RandomState(9)
    exs = []
    for i, n in enumerate((100, 70)):
        target = (rng.randn(n) * (np.arange(n) > 30)).astype(np.float32)
        exs.append(data.TrainExample(mixture=target + 0.01 * rng.randn(n).astype(np.float32),
                                     target=target, residual=np.zeros(n, np.float32),
                                     description=["a dog", "rain"][i]))
    jpipe = jspan.SpanDataPipeline(jcfg, jax.tree_util.tree_map(jnp.asarray, params),
                                   JaxByteTokenizer(jcfg.text_encoder.vocab_size), jsp_cfg,
                                   bucket_seconds=0.01)
    ref = jpipe.make_batch([jdata.TrainExample(**dataclasses.asdict(e)) for e in exs])
    pipe = span.SpanDataPipeline(cfg, params_from_numpy(params),
                                 ByteFallbackTokenizer(cfg.text_encoder.vocab_size),
                                 SpanPredictorConfig(**dataclasses.asdict(jsp_cfg)),
                                 bucket_seconds=0.01)
    got = pipe.make_batch(exs)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), err_msg=k, **TOL)
    assert got["labels"].any()


def _write_config(tmp_path):
    cfg = jax_tiny_config()
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(dataclasses.asdict(cfg)))
    return cfg, str(path)


def test_cli_trains_exports_and_jax_separates_the_export(tmp_path):
    jcfg, config = _write_config(tmp_path)
    export = tmp_path / "export"
    common = ["--random-init", "--config", config, "--batch-size", "2", "--device", "cpu",
              "--log-every", "1"]
    assert cli.main(["--synthetic", "3", *common, "--ema", "0.9", "--ckpt-dir",
                     str(tmp_path / "ckpt"), "--save-every", "2", "--max-to-keep", "1",
                     "--export-dir", str(export), "--lr-schedule", "cosine",
                     "--warmup-steps", "1"]) == 0
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["3"]

    # JAX loads the export; both packages separate it alike
    jm = JaxSAMAudio.from_pretrained(str(export), allow_random_towers=True)
    tm = SAMAudio.from_pretrained(str(export), device="cpu", allow_random_towers=True,
                                  tokenizer=ByteFallbackTokenizer(jcfg.text_encoder.vocab_size))
    rng = np.random.RandomState(7)
    audios = [rng.randn(1, 77).astype(np.float32) * 0.2, rng.randn(1, 50).astype(np.float32)]
    kw = dict(descriptions=["a dog barking", "rain"], audios=audios)
    jb = JaxProcessor(audio_hop_length=8, audio_sampling_rate=8000)(**kw)
    tb = SAMAudioProcessor(8, 8000)(**kw)
    noise = rng.randn(2, jb.anchor_alignment.shape[-1], 8).astype(np.float32)
    ref = jm.separate(jb, noise=noise)
    out = tm.separate(tb, noise=noise)
    for i in range(2):
        np.testing.assert_allclose(out.target[i], np.asarray(ref.target[i]), **TOL)
        assert np.isfinite(out.residual[i]).all()

    # records + --model (the export, fp32) + --resume from a checkpoint
    recs = tmp_path / "records"
    g = np.random.RandomState(3)
    records.write_shards([data.TrainExample(mixture=g.randn(90).astype(np.float32),
                                            target=g.randn(90).astype(np.float32),
                                            residual=g.randn(90).astype(np.float32),
                                            description="a dog") for _ in range(4)],
                         str(recs), shard_size=2)
    args = ["--records", str(recs), "--model", str(export), "--allow-random-towers",
            "--batch-size", "2", "--device", "cpu", "--bucket-seconds", "0.01",
            "--ckpt-dir", str(tmp_path / "ckpt2")]
    assert cli.main([*args, "--max-steps", "1"]) == 0
    assert cli.main([*args, "--resume", "--epochs", "2", "--max-steps", "3"]) == 0
    assert sorted(int(p.name) for p in (tmp_path / "ckpt2").iterdir()) == [1, 3]


def test_cli_lora_and_span_tasks(tmp_path):
    _, config = _write_config(tmp_path)
    common = ["--synthetic", "2", "--random-init", "--config", config, "--batch-size", "2",
              "--device", "cpu"]
    out = tmp_path / "adapters.npz"
    assert cli.main([*common, "--lora-rank", "2", "--lora-out", str(out)]) == 0
    adapters, meta = jlora.load_lora(str(out))
    assert meta["rank"] == 2 and all("transformer/layers/" in k for k in adapters)
    sp_dir = tmp_path / "snap"
    assert cli.main([*common, "--task", "span", "--span-hidden", "32", "--span-layers", "1",
                     "--span-heads", "2", "--export-dir", str(sp_dir)]) == 0
    predictor = load_span_predictor(str(sp_dir / "span_predictor"), device="cpu")
    assert predictor.cfg.hidden == 32 and predictor.cfg.audio_dim == 4


@pytest.mark.parametrize("flag,error,match", [
    (["--tp", "2"], ValueError, "impossible with 1 device"),
    (["--dp", "2"], AssertionError, "needs 2 devices, have 1"),
    (["--dp", "2", "--tp", "2"], AssertionError, "needs 4 devices, have 1"),
    (["--coordinator", "h:1"], ValueError, "needs --num-processes and --process-id"),
    (["--coordinator", "h:1", "--num-processes", "2"], ValueError,
     "needs --num-processes and --process-id"),
])
def test_cli_refuses_parallelism(flag, error, match):
    """One process: a mesh larger than the world is refused with JAX's
    make_mesh errors, and --coordinator without the process flags before
    any connection is tried (tests/test_torch_parallel_train.py runs the
    command line on a dp2 x tp2 world)."""
    with pytest.raises(error, match=match):
        cli.main(["--synthetic", "1", "--random-init", "--device", "cpu", *flag])
