"""Training on a (dp, tp) mesh in the PyTorch port against the JAX package's
single-device trainers (fp32, CPU, the tiny config, inputs from a numpy seed,
t and x0 drawn by JAX and injected; bound 1e-4). JAX's own tests hold its
sharded trainer equal to its unsharded one.

One 4-rank gloo world (spawned once for the module) runs: two dp2 x tp2
`Trainer` steps (warmup + cosine, clipping, weight decay, EMA; ragged pad
masks, so that the loss's mask count is the global one), a checkpoint of
step 2 restored at dp4 x tp1 and at dp1 x tp4 and a third step on each mesh
(orbax's resharding restore), two dp2 x tp2 `LoRATrainer` steps with JAX's
adapters injected, and `python -m sam_audio_tpu_torch.train --dp 2 --tp 2
--device cpu` in every rank, whose export equals a one-process run's.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from test_torch_parallel import join_world, spawn_world

TOL = dict(rtol=1e-4, atol=1e-4)
TRAINER_KW = dict(learning_rate=1e-3, weight_decay=0.1, grad_clip=0.5, lr_schedule="cosine",
                  warmup_steps=1, total_steps=4, final_lr_ratio=0.1, ema_decay=0.9)
LORA_KW = dict(rank=4, alpha=8.0, learning_rate=1e-3, grad_clip=0.5, ema_decay=0.9,
               lr_schedule="linear", warmup_steps=1, total_steps=3)
N_STEPS = 3


def np_batch(cfg, seed, b=4, t=10, text_len=5):
    rng = np.random.RandomState(seed)
    c2 = 2 * cfg.audio_codec.codebook_dim
    pad = np.ones((b, t), bool)
    pad[1, 7:] = False
    pad[2, 4:] = False
    text_mask = np.ones((b, text_len), bool)
    text_mask[3, 2:] = False
    return {
        "audio_features": rng.randn(b, t, c2).astype(np.float32),
        "target_latents": rng.randn(b, t, c2).astype(np.float32),
        "text_features": rng.randn(b, text_len, cfg.text_encoder.dim).astype(np.float32),
        "text_mask": text_mask,
        "anchor_ids": np.tile(np.array([[0, 3, 1, 3]], np.int32), (b, 1)),
        "anchor_alignment": np.where(pad, 0, 1).astype(np.int32),
        "audio_pad_mask": pad,
    }


def to_torch(batch):
    return {k: (torch.from_numpy(np.array(v)).long() if np.asarray(v).dtype == np.int32
                else torch.from_numpy(np.array(v))) for k, v in batch.items()}


def port_cfg():
    from sam_audio_tpu_torch.config import tiny_test_config

    return tiny_test_config()


# ---------------------------------------------------------------------------
# The port's side, on every rank of the world
# ---------------------------------------------------------------------------


def port_train(rank, out_dir):
    from sam_audio_tpu_torch.checkpoint import load_params
    from sam_audio_tpu_torch.parallel.mesh import make_mesh
    from sam_audio_tpu_torch.train import __main__ as cli
    from sam_audio_tpu_torch.train.checkpoints import TrainCheckpointManager
    from sam_audio_tpu_torch.train.flow_matching import Trainer
    from sam_audio_tpu_torch.train.lora import LoRATrainer
    from sam_audio_tpu_torch.utils import tree_leaves_with_path

    cfg = port_cfg()
    draws = np.load(os.path.join(out_dir, "draws.npz"))
    batches = [to_torch(np_batch(cfg, 20 + i)) for i in range(N_STEPS)]
    t = [torch.from_numpy(draws[f"t{i}"]) for i in range(N_STEPS)]
    x0 = [torch.from_numpy(draws[f"x0_{i}"]) for i in range(N_STEPS)]

    def params():
        return load_params(os.path.join(out_dir, "params.npz"))

    def flat(tree):
        return {p: x.detach().numpy().copy() for p, x in tree_leaves_with_path(tree)}

    res = {"metrics": []}
    dp2tp2, dp4, tp4 = make_mesh(2, 2), make_mesh(4, 1), make_mesh(1, 4)
    tr = Trainer(cfg, params(), mesh=dp2tp2, device="cpu", **TRAINER_KW)
    res["local_wq_rows"] = tr.state.params["transformer"]["layers"]["attention"]["wq"][
        "weight"].shape[-2]
    for i in range(2):
        m = tr.step(batches[i], t=t[i], x0=x0[i])
        res["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
    mgr = TrainCheckpointManager(os.path.join(out_dir, "ckpt"))
    assert mgr.save(tr.state)
    runs = {"dp2tp2": tr}
    for name, mesh in (("dp4", dp4), ("tp4", tp4)):
        other = Trainer(cfg, params(), mesh=mesh, device="cpu", **TRAINER_KW)
        runs[name] = other
        other.state = mgr.restore(other.state)
    for name, run in runs.items():
        m = run.step(batches[2], t=t[2], x0=x0[2])
        res[f"step3_{name}"] = (float(m["loss"]), float(m["grad_norm"]))
        res[f"params_{name}"] = flat(run.full_params())
        res[f"ema_{name}"] = flat(run.full_params(run.ema_inference_params()))

    adapters = np.load(os.path.join(out_dir, "adapters.npz"))
    lt = LoRATrainer(cfg, params(), mesh=dp2tp2, device="cpu", **LORA_KW)
    with torch.no_grad():
        for tree in (lt.state.params, lt.state.ema_params):
            for k, ab in tree.items():
                for part in ("a", "b"):
                    ab[part].copy_(torch.from_numpy(adapters[f"{k}::{part}"]))
    res["lora_metrics"] = []
    for i in range(2):
        m = lt.step(batches[i], t=t[i], x0=x0[i])
        res["lora_metrics"].append((float(m["loss"]), float(m["grad_norm"])))
    res["lora"] = {f"{k}::{part}": ab[part].detach().numpy().copy()
                   for k, ab in lt.adapters.items() for part in ("a", "b")}
    res["lora_merged"] = flat(lt.full_params(lt.ema_inference_params()))

    # dropout 0.1: the tp ranks draw the same masks on the whole activations,
    # so the whole leaves stay equal on every rank after a step
    dcfg = dataclasses.replace(cfg, transformer=dataclasses.replace(cfg.transformer,
                                                                    dropout=0.1))
    td = Trainer(dcfg, params(), mesh=dp2tp2, device="cpu", **{**TRAINER_KW, "warmup_steps": 0})
    td.step(batches[0], t=t[0], x0=x0[0])
    res["dropout_whole"] = {p: x for p, x in flat(td.state.params).items()
                            if td.state.shard_dims[p] is None}

    res["cli"] = cli.main(cli_args(out_dir, "cli_mesh") + ["--dp", "2", "--tp", "2"])
    return res


def cli_args(out_dir, name):
    return ["--synthetic", "2", "--random-init", "--config", os.path.join(out_dir, "cfg.json"),
            "--batch-size", "4", "--device", "cpu", "--ema", "0.9", "--log-every", "0",
            "--ckpt-dir", os.path.join(out_dir, name, "ckpt"),
            "--export-dir", os.path.join(out_dir, name, "export")]


# ---------------------------------------------------------------------------
# JAX's side, in this process while the world runs
# ---------------------------------------------------------------------------


def write_inputs(out_dir):
    """The fp32 params, JAX's t / x0 draws, the adapters and the config."""
    import jax
    import jax.numpy as jnp

    from sam_audio_tpu.checkpoint import save_params
    from sam_audio_tpu.config import tiny_test_config
    from sam_audio_tpu.models.sam_audio import sam_audio_init
    from sam_audio_tpu.train import lora as jlora

    cfg = tiny_test_config()
    params = sam_audio_init(jax.random.PRNGKey(0), cfg)
    save_params(os.path.join(out_dir, "params.npz"), params)
    draws = {}
    for i, rng in enumerate(step_rngs()):
        t_rng, n_rng, _ = jax.random.split(rng, 3)
        x1 = np_batch(cfg, 20 + i)["target_latents"]
        draws[f"t{i}"] = np.array(jax.random.uniform(t_rng, (x1.shape[0],), jnp.float32))
        draws[f"x0_{i}"] = np.array(jax.random.normal(n_rng, x1.shape, jnp.float32))
    np.savez(os.path.join(out_dir, "draws.npz"), **draws)
    jad = jlora.lora_init(jax.random.PRNGKey(1), params, rank=LORA_KW["rank"],
                          targets=jlora.TARGET_PRESETS["attention"])
    rng = np.random.RandomState(3)
    np.savez(os.path.join(out_dir, "adapters.npz"), **{
        f"{k}::{part}": (np.asarray(ab["a"]) if part == "a"
                         else (0.05 * rng.randn(*ab["b"].shape)).astype(np.float32))
        for k, ab in jad.items() for part in ("a", "b")})
    with open(os.path.join(out_dir, "cfg.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f)


def step_rngs():
    import jax

    return jax.random.split(jax.random.PRNGKey(13), N_STEPS)


def jax_train(out_dir):
    import jax
    import jax.numpy as jnp

    from sam_audio_tpu.checkpoint import load_params
    from sam_audio_tpu.config import tiny_test_config
    from sam_audio_tpu.train import flow_matching as jfm
    from sam_audio_tpu.train import lora as jlora

    cfg = tiny_test_config()
    params = load_params(os.path.join(out_dir, "params.npz"))
    rngs = step_rngs()
    ref = {"metrics": []}
    jt = jfm.Trainer(cfg, jax.tree_util.tree_map(jnp.array, params), **TRAINER_KW)
    for i in range(N_STEPS):
        m = jt.step(np_batch(cfg, 20 + i), rngs[i])
        ref["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
    ref["params"] = jax.tree_util.tree_map(np.asarray, jt.state.params)
    ref["ema"] = jax.tree_util.tree_map(np.asarray, jt.ema_inference_params())

    lt = jlora.LoRATrainer(cfg, jax.tree_util.tree_map(jnp.array, params),
                           rng=jax.random.PRNGKey(1), **LORA_KW)
    z = np.load(os.path.join(out_dir, "adapters.npz"))
    adapters = {}
    for name in z.files:
        key, _, part = name.rpartition("::")
        adapters.setdefault(key, {})[part] = jnp.asarray(z[name])
    lt.state = lt.state._replace(params=adapters,
                                 ema_params=jax.tree_util.tree_map(jnp.array, adapters))
    ref["lora_metrics"] = []
    for i in range(2):
        m = lt.step(np_batch(cfg, 20 + i), rngs[i])
        ref["lora_metrics"].append((float(m["loss"]), float(m["grad_norm"])))
    ref["lora"] = {f"{k}::{part}": np.asarray(ab[part])
                   for k, ab in jax.device_get(lt.state.params).items() for part in ("a", "b")}
    ref["lora_merged"] = jax.tree_util.tree_map(np.asarray, lt.ema_inference_params())
    return ref


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from sam_audio_tpu_torch.train import __main__ as cli

    out_dir = str(tmp_path_factory.mktemp("parallel_train"))
    write_inputs(out_dir)
    ctx = spawn_world(port_train, out_dir)
    try:
        ref = jax_train(out_dir)
        # the same command line in one process: the mesh run must equal it
        ref["cli"] = cli.main(cli_args(out_dir, "cli_one"))
    finally:
        ranks = join_world(ctx, out_dir)
    return ranks, ref, out_dir


def assert_flat_close(got, ref_tree, paths=None):
    from sam_audio_tpu_torch.utils import tree_leaves_with_path

    want = dict(tree_leaves_with_path(ref_tree))
    assert set(got) == set(want)
    for path, x in got.items():
        np.testing.assert_allclose(x, np.asarray(want[path]), err_msg=path, **TOL)


def test_dp2_tp2_trainer_steps_match_jax(results):
    ranks, ref, _ = results
    for r in ranks:
        assert r["local_wq_rows"] == 16      # 32 rows split over tp2
        for (loss, gnorm), (jloss, jgnorm) in zip(r["metrics"], ref["metrics"]):
            np.testing.assert_allclose(loss, jloss, **TOL)
            np.testing.assert_allclose(gnorm, jgnorm, **TOL)
        np.testing.assert_allclose(r["step3_dp2tp2"], ref["metrics"][2], **TOL)
        assert_flat_close(r["params_dp2tp2"], ref["params"])
        assert_flat_close(r["ema_dp2tp2"], ref["ema"])
    assert max(g for _, g in ref["metrics"]) >= TRAINER_KW["grad_clip"]   # the clip triggered


@pytest.mark.parametrize("mesh", ["dp4", "tp4"])
def test_resharded_restore_continues_like_jax(results, mesh):
    ranks, ref, out_dir = results
    assert sorted(os.listdir(os.path.join(out_dir, "ckpt"))) == ["2"]
    for r in ranks:
        np.testing.assert_allclose(r[f"step3_{mesh}"], ref["metrics"][2], **TOL)
        assert_flat_close(r[f"params_{mesh}"], ref["params"])
        assert_flat_close(r[f"ema_{mesh}"], ref["ema"])


def test_dropout_keeps_whole_leaves_equal_across_ranks(results):
    ranks, _, _ = results
    whole = ranks[0]["dropout_whole"]
    assert len(whole) > 10
    for r in ranks[1:]:
        for path, x in whole.items():
            np.testing.assert_array_equal(r["dropout_whole"][path], x, err_msg=path)
    start = dict(np.load(os.path.join(results[2], "params.npz")))
    moved = [p for p, x in whole.items()
             if p.startswith("transformer/") and not np.array_equal(x, start[p])]
    assert moved   # the step moved the whole DiT leaves it trained


def test_dp2_tp2_lora_steps_match_jax(results):
    ranks, ref, _ = results
    for r in ranks:
        for got, want in zip(r["lora_metrics"], ref["lora_metrics"]):
            np.testing.assert_allclose(got, want, **TOL)
        for key, x in ref["lora"].items():
            np.testing.assert_allclose(r["lora"][key], x, err_msg=key, **TOL)
        assert_flat_close(r["lora_merged"], ref["lora_merged"])


def test_train_cli_on_a_dp2_tp2_mesh_equals_one_process(results):
    from sam_audio_tpu_torch.checkpoint import load_params
    from sam_audio_tpu_torch.utils import tree_leaves_with_path

    ranks, ref, out_dir = results
    assert ref["cli"] == 0 and all(r["cli"] == 0 for r in ranks)
    assert sorted(os.listdir(os.path.join(out_dir, "cli_mesh", "ckpt"))) == ["1", "2"]
    one = dict(tree_leaves_with_path(load_params(
        os.path.join(out_dir, "cli_one", "export", "params.npz"))))
    mesh = dict(tree_leaves_with_path(load_params(
        os.path.join(out_dir, "cli_mesh", "export", "params.npz"))))
    assert set(one) == set(mesh)
    for path, x in one.items():
        np.testing.assert_allclose(mesh[path].numpy(), x.numpy(), err_msg=path, **TOL)
