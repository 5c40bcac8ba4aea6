"""Parallelism in the PyTorch port (parallel/, ops/ring_attention.py,
SAMAudio.shard / sp_mesh) against the JAX package, fp32 on the CPU.

The sharding rules are held against JAX's on every leaf of the tiny
SAMAudio tree, its int8 and int4 trees and a PE tree. One 4-rank gloo world
(torch.multiprocessing, spawned once for the module) computes the port's
sharded results while this process computes JAX's: ring attention against
JAX's on a 4-device CPU mesh and against sdpa, with padding; dit_apply_sp
with a ragged tail inside the last shard and its gradients against jax.grad;
dp2 x tp2 separate at k=1 and k=2, int8 under tp2 and dp1 x tp4 (heads split
mid-head) against JAX's separate with the same injected noise; the PE encode
under tp2, exact and int8; an sp4 separate against the unsharded one; and
the errors of make_mesh, ring_attention and dit_apply_sp. Bound 1e-4 (the
bound of the port's parity tests), unless a line says otherwise.
"""

import datetime
import os
import pickle
import socket

import numpy as np
import pytest
import torch

TOL = dict(rtol=1e-4, atol=1e-4)
WORLD = 4


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_world(task, out_dir):
    """Start WORLD gloo ranks running `task(rank, out_dir)`; each pickles
    its result to out_dir/rank<r>.pkl. Returns the process context."""
    import torch.multiprocessing as mp

    return mp.spawn(_worker, args=(_free_port(), out_dir, task), nprocs=WORLD, join=False)


def join_world(ctx, out_dir, timeout_s=300):
    """Wait for every rank (a rank's exception is raised here) and return
    the per-rank results."""
    try:
        for _ in range(timeout_s // 5):
            if ctx.join(timeout=5):
                break
        else:
            raise AssertionError(f"the gloo world did not finish in {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = []
    for rank in range(WORLD):
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _worker(rank, port, out_dir, task):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=200))
    try:
        res = task(rank, out_dir)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


# ---------------------------------------------------------------------------
# Shared inputs (numpy seeds, so that both processes build them alike)
# ---------------------------------------------------------------------------

SP_DIT = dict(dim=32, n_heads=4, n_layers=3, dropout=0.0, context_dim=16,
              max_positions=64, frequency_embedding_dim=8, out_channels=6, in_channels=None)


def ring_inputs():
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(2, 16, 2, 8).astype(np.float32) for _ in range(3))
    mask = np.ones((2, 16), bool)
    mask[0, 6:] = False      # a tail spanning three shards
    mask[1, ::5] = False     # scattered keys in every shard
    return q, k, v, mask


def sp_inputs():
    """test_sp_dit.py's inputs: a ragged tail inside the last shard."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 16, SP_DIT["dim"]).astype(np.float32)
    time = rng.rand(2).astype(np.float32)
    memory = rng.randn(2, 5, SP_DIT["context_dim"]).astype(np.float32)
    pad = np.ones((2, 16), bool)
    pad[1, 13:] = False
    mem_mask = np.ones((2, 5), bool)
    mem_mask[0, 3:] = False
    return x, time, memory, pad, mem_mask


def separate_batch(proc_cls, samples=(77, 50)):
    proc = proc_cls(audio_hop_length=8, audio_sampling_rate=8000)
    rng = np.random.RandomState(7)
    audios = [rng.randn(1, n).astype(np.float32) * 0.2 for n in samples]
    return proc(descriptions=["a dog barking", "rain on a roof"][:len(samples)],
                audios=audios)


def separate_noise(batch, k=1):
    return np.random.RandomState(8).randn(
        len(batch.descriptions) * k, batch.anchor_alignment.shape[-1], 8).astype(np.float32)


def pe_frames(vcfg):
    return np.random.RandomState(9).randn(4, 3, vcfg.image_size,
                                          vcfg.image_size).astype(np.float32) * 0.5


# ---------------------------------------------------------------------------
# The port's side, on every rank of the world
# ---------------------------------------------------------------------------


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def port_inference(rank, out_dir):
    from sam_audio_tpu_torch import SAMAudio, SAMAudioProcessor
    from sam_audio_tpu_torch.checkpoint import load_params
    from sam_audio_tpu_torch.config import TransformerConfig, tiny_test_config
    from sam_audio_tpu_torch.models.pe_clip import encode_images
    from sam_audio_tpu_torch.ops.quant import quantize_pe_params
    from sam_audio_tpu_torch.ops.ring_attention import ring_attention
    from sam_audio_tpu_torch.parallel import comm
    from sam_audio_tpu_torch.parallel.mesh import (
        Mesh, make_mesh, process_allgather, shard_batch, shard_params)
    from sam_audio_tpu_torch.parallel.sp import dit_apply_sp, gather_sequence
    from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer
    from sam_audio_tpu_torch.utils import tree_leaves_with_path

    res = {}
    sp = Mesh({"sp": WORLD})
    dp2tp2 = make_mesh(dp=2, tp=2)
    tp4 = make_mesh(dp=1, tp=4)
    res["coords"] = (dp2tp2.index, sp.index, tp4.index)
    res["allgather"] = process_allgather({"rank": np.array([rank]), "x": torch.ones(2) * rank})
    rows = torch.arange(8)[:, None]
    res["rows"] = (shard_batch({"a": rows}, dp2tp2)["a"].flatten().tolist(),
                   shard_batch({"a": rows}, dp2tp2, process_local=True)["a"].shape[0])

    # ring attention: this rank's block, and the gradients through the ring
    q, k, v, mask = (torch.from_numpy(a) for a in ring_inputs())
    for t in (q, k, v):
        t.requires_grad_(True)
    out = ring_attention(q, k, v, sp, key_padding_mask=mask)
    grads = torch.autograd.grad((out ** 2).sum(), [q, k, v])
    res["ring"] = out.detach().numpy()
    res["ring_grads"] = [comm.all_reduce(g, sp.group("sp")).numpy() for g in grads]
    res["err_ring"] = _error(lambda: ring_attention(q[:, :14], k[:, :14], v[:, :14], sp))

    # the sequence-parallel DiT and its gradients
    tcfg = TransformerConfig(**SP_DIT)
    params = load_params(os.path.join(out_dir, "dit.npz"))
    for _, leaf in tree_leaves_with_path(params):
        leaf.requires_grad_(True)
    x, time, memory, pad, mem_mask = (torch.from_numpy(a) for a in sp_inputs())
    kw = dict(cfg=tcfg, mesh=sp, padding_mask=pad, memory=memory, memory_padding_mask=mem_mask)
    blk = dit_apply_sp(params, x, time, **kw)
    leaves = [leaf for _, leaf in tree_leaves_with_path(params)]
    loss = (blk ** 2).sum() / (blk.shape[0] * x.shape[1] * blk.shape[-1])   # the global mean
    grads = torch.autograd.grad(loss, leaves)
    res["sp_out"] = gather_sequence(blk.detach(), sp).numpy()
    res["sp_grads"] = {path: g.numpy() for (path, _), g in zip(tree_leaves_with_path(params),
                                                                grads)}
    res["err_sp_div"] = _error(lambda: dit_apply_sp(params, x[:, :14], time, cfg=tcfg,
                                                    mesh=sp, memory=memory))
    res["err_sp_mem"] = _error(lambda: dit_apply_sp(params, x, time, cfg=tcfg, mesh=sp))

    # separate() sharded over (dp, tp), from the JAX package's snapshot
    snap = os.path.join(out_dir, "snapshot")
    tok = ByteFallbackTokenizer(tiny_test_config().text_encoder.vocab_size)

    def model(mesh=None, bits=None):
        m = SAMAudio.from_pretrained(snap, device="cpu", allow_random_towers=True, tokenizer=tok)
        if bits:
            m.quantize(bits)
        return m.shard(mesh) if mesh is not None else m

    batch = separate_batch(SAMAudioProcessor)
    m22 = model(dp2tp2)
    assert m22.params["transformer"]["layers"]["attention"]["wq"]["weight"].shape[-2] == 16
    for k_ in (1, 2):
        r = m22.separate(batch, noise=separate_noise(batch), reranking_candidates=k_)
        res[f"sep_k{k_}"] = (r.target, r.residual)
    r = model(dp2tp2, bits=8).separate(batch, noise=separate_noise(batch))
    res["sep_int8"] = (r.target, r.residual)
    r = model(tp4).separate(batch, noise=separate_noise(batch))
    res["sep_tp4"] = (r.target, r.residual)
    res["err_quantize_after_shard"] = _error(lambda: m22.quantize(8))

    # a clip past the direct limit streams through windows under shard()
    # (two windows a call: the B*k rows split over dp)
    stream_batch = separate_batch(SAMAudioProcessor, samples=(400,))
    outs = []
    for m in (model(), model(dp2tp2)):
        m.streaming_batch_windows = 2
        outs.append(m.separate(stream_batch, generator=torch.Generator().manual_seed(4),
                               max_direct_seconds=0.02).target[0])
    res["sep_stream"] = outs

    # shard() covers an attached PE vision tower
    from sam_audio_tpu_torch.models.pe_clip import PerceptionEncoder

    video = (np.random.RandomState(10).rand(2, 3, 30, 40) * 255).astype(np.uint8)
    encs = []
    for mesh in (None, dp2tp2):
        m = model()
        m.vision_encoder = PerceptionEncoder.init_random(
            tiny_test_config().vision_encoder, seed=0, device="cpu", compute_dtype=torch.float32)
        if mesh is not None:
            m.shard(mesh)
            res["vision_fc1_rows"] = m.vision_encoder.params["layers"]["mlp"]["fc1"][
                "weight"].shape[-2]
            res["vision_mesh"] = m.vision_encoder.mesh is mesh
        encs.append(m.vision_encoder([video]).numpy())
    res["vision_encode"] = encs

    # the sequence-parallel trunk inside separate() (16 frames over 4 ranks)
    long_batch = separate_batch(SAMAudioProcessor, samples=(128,))
    noise = separate_noise(long_batch)
    plain = model().separate(long_batch, noise=noise)
    m_sp = model()
    m_sp.sp_mesh = sp
    r = m_sp.separate(long_batch, noise=noise)
    res["sep_sp"] = (plain.target, r.target)

    # the PE-Core encode under tp2, exact and int8
    vcfg = tiny_test_config().vision_encoder
    pe = load_params(os.path.join(out_dir, "pe.npz"))
    frames = torch.from_numpy(pe_frames(vcfg))
    for name, tree in (("pe", pe), ("pe_int8", quantize_pe_params(pe))):
        with comm.use_tp(dp2tp2.group("tp")):
            res[name] = encode_images(shard_params(tree, dp2tp2), frames, vcfg).numpy()
    res["pe_fc1_rows"] = shard_params(pe, dp2tp2)["layers"]["mlp"]["fc1"]["weight"].shape[-2]
    return res


# ---------------------------------------------------------------------------
# JAX's side, in this process while the world runs
# ---------------------------------------------------------------------------


def jax_inference(out_dir):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh

    from sam_audio_tpu.config import TransformerConfig, tiny_test_config
    from sam_audio_tpu.models.dit import dit_apply, dit_init
    from sam_audio_tpu.models.pe_clip import encode_images, pe_clip_init
    from sam_audio_tpu.models.sam_audio import SAMAudio as JaxSAMAudio
    from sam_audio_tpu.ops.attention import sdpa
    from sam_audio_tpu.ops.quant import quantize_pe_params
    from sam_audio_tpu.ops.ring_attention import ring_attention
    from sam_audio_tpu.processor import SAMAudioProcessor
    from sam_audio_tpu.text_tokenizer import ByteFallbackTokenizer

    ref = {}
    q, k, v, mask = (jnp.asarray(a) for a in ring_inputs())
    mesh4 = JaxMesh(np.asarray(jax.devices("cpu")[:WORLD]), axis_names=("sp",))
    ref["ring"] = np.asarray(ring_attention(q, k, v, mesh4, key_padding_mask=mask))
    ref["ring_sdpa"] = np.asarray(sdpa(q, k, v, key_padding_mask=mask))
    ref["ring_grads"] = [np.asarray(g) for g in jax.grad(
        lambda q_, k_, v_: jnp.sum(sdpa(q_, k_, v_, key_padding_mask=mask) ** 2),
        argnums=(0, 1, 2))(q, k, v)]

    tcfg = TransformerConfig(**SP_DIT)
    params = jax.tree_util.tree_map(np.asarray, dit_init(jax.random.PRNGKey(0), tcfg))
    x, time, memory, pad, mem_mask = (jnp.asarray(a) for a in sp_inputs())

    def loss(p):
        out = dit_apply(p, x, time, cfg=tcfg, padding_mask=pad, memory=memory,
                        memory_padding_mask=mem_mask)
        return jnp.mean(out ** 2), out

    (_, out), grads = jax.value_and_grad(loss, has_aux=True)(params)
    ref["sp_out"] = np.asarray(out)
    ref["sp_grads"] = jax.tree_util.tree_map(np.asarray, grads)

    cfg = tiny_test_config()
    jm = JaxSAMAudio.init_random(jax.random.PRNGKey(0), cfg,
                                 tokenizer=ByteFallbackTokenizer(cfg.text_encoder.vocab_size))
    batch = separate_batch(SAMAudioProcessor)
    for k_ in (1, 2):
        r = jm.separate(batch, noise=separate_noise(batch), reranking_candidates=k_)
        ref[f"sep_k{k_}"] = ([np.asarray(t) for t in r.target],
                             [np.asarray(t) for t in r.residual])
    jm.quantize(8)
    r = jm.separate(batch, noise=separate_noise(batch))
    ref["sep_int8"] = ([np.asarray(t) for t in r.target], [np.asarray(t) for t in r.residual])

    vcfg = cfg.vision_encoder
    pe = pe_clip_init(jax.random.PRNGKey(0), vcfg)
    frames = jnp.asarray(pe_frames(vcfg))
    ref["pe"] = np.asarray(encode_images(pe, frames, vcfg))
    ref["pe_int8"] = np.asarray(encode_images(quantize_pe_params(pe), frames, vcfg))
    return ref


def write_inputs(out_dir):
    """The JAX package's snapshot, DiT and PE trees that both sides read."""
    import jax

    from sam_audio_tpu.checkpoint import save_params
    from sam_audio_tpu.config import TransformerConfig, tiny_test_config
    from sam_audio_tpu.models.dit import dit_init
    from sam_audio_tpu.models.pe_clip import pe_clip_init
    from sam_audio_tpu.models.sam_audio import SAMAudio as JaxSAMAudio
    from sam_audio_tpu.text_tokenizer import ByteFallbackTokenizer

    cfg = tiny_test_config()
    JaxSAMAudio.init_random(jax.random.PRNGKey(0), cfg, tokenizer=ByteFallbackTokenizer(
        cfg.text_encoder.vocab_size)).save_pretrained(os.path.join(out_dir, "snapshot"))
    save_params(os.path.join(out_dir, "dit.npz"),
                dit_init(jax.random.PRNGKey(0), TransformerConfig(**SP_DIT)))
    save_params(os.path.join(out_dir, "pe.npz"),
                pe_clip_init(jax.random.PRNGKey(0), cfg.vision_encoder))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("parallel"))
    write_inputs(out_dir)
    ctx = spawn_world(port_inference, out_dir)
    try:
        ref = jax_inference(out_dir)
    finally:
        ranks = join_world(ctx, out_dir)
    return ranks, ref


# ---------------------------------------------------------------------------
# Rules (no processes)
# ---------------------------------------------------------------------------


def _jax_tree(tree):
    """The tree's leaf shapes (jax.eval_shape: nothing is computed)."""
    import functools

    import jax

    from sam_audio_tpu.config import tiny_test_config
    from sam_audio_tpu.models.pe_clip import pe_clip_init
    from sam_audio_tpu.models.sam_audio import sam_audio_init
    from sam_audio_tpu.ops.quant import quantize_sam_audio_params

    cfg = tiny_test_config()
    key = jax.random.PRNGKey(0)
    if tree == "pe":
        return jax.eval_shape(functools.partial(pe_clip_init, cfg=cfg.vision_encoder), key)
    params = jax.eval_shape(functools.partial(sam_audio_init, cfg=cfg), key)
    if tree == "sam_audio":
        return params
    return jax.eval_shape(functools.partial(quantize_sam_audio_params,
                                            bits=8 if tree == "int8" else 4), params)


@pytest.mark.parametrize("tree", ["sam_audio", "int8", "int4", "pe"])
def test_partition_specs_match_jax_on_every_leaf(tree):
    import jax

    from sam_audio_tpu.parallel.mesh import _path_str
    from sam_audio_tpu.parallel.mesh import params_pspec_tree as jax_specs
    from sam_audio_tpu_torch.checkpoint import unflatten
    from sam_audio_tpu_torch.parallel.mesh import param_partition_spec, params_pspec_tree
    from sam_audio_tpu_torch.utils import tree_leaves_with_path

    params = _jax_tree(tree)
    want, shapes = {}, {}
    jax.tree_util.tree_map_with_path(
        lambda path, s: want.__setitem__(_path_str(path), tuple(s)), jax_specs(params),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    jax.tree_util.tree_map_with_path(
        lambda path, x: shapes.__setitem__(_path_str(path), x.shape), params)
    port_tree = unflatten({p: torch.zeros(shape) for p, shape in shapes.items()})
    leaves = dict(tree_leaves_with_path(port_tree))
    assert set(leaves) == set(want)
    split = 0
    for path, x in leaves.items():
        spec = param_partition_spec(path, x.ndim)
        assert spec == want[path], path
        split += "tp" in spec
    assert split > 0
    specs = params_pspec_tree(port_tree)
    assert specs["layers" if tree == "pe" else "transformer"] is not None
    if tree == "int4":   # the packed int4 leaves match no rule
        assert all("tp" not in want[p] for p in want if p.endswith(("/w4", "/w4_scale")))


def test_make_mesh_errors_match_jax():
    from sam_audio_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from sam_audio_tpu_torch.parallel.mesh import make_mesh, shard_dim

    msg = r"make_mesh: a 0x(\d+) \(dp x tp\) mesh is impossible with \d+ device\(s\)"
    with pytest.raises(ValueError, match=msg):
        jax_make_mesh(tp=16)     # 8 devices: dp = 8 // 16 = 0
    with pytest.raises(ValueError, match=msg):
        make_mesh(tp=2)          # one rank: dp = 1 // 2 = 0
    with pytest.raises(AssertionError, match="needs 2 devices, have 1"):
        make_mesh(dp=2)
    mesh = make_mesh()
    assert (mesh.shape, mesh.index, mesh.group("dp"), mesh.group("tp")) == (
        {"dp": 1, "tp": 1}, {"dp": 0, "tp": 0}, None, None)
    assert shard_dim("transformer/layers/attention/wq/weight", (2, 32, 32), mesh) is None


# ---------------------------------------------------------------------------
# The world's results
# ---------------------------------------------------------------------------


def test_ring_attention_matches_jax_ring_and_sdpa(results):
    ranks, ref = results
    got = np.concatenate([r["ring"] for r in ranks], axis=1)
    np.testing.assert_allclose(got, ref["ring"], **TOL)
    np.testing.assert_allclose(got, ref["ring_sdpa"], **TOL)
    from sam_audio_tpu_torch.ops.attention import sdpa

    q, k, v, mask = (torch.from_numpy(a) for a in ring_inputs())
    np.testing.assert_allclose(got, sdpa(q, k, v, key_padding_mask=mask).numpy(), **TOL)
    # differentiable through the ring shift: the gradients summed over the
    # ranks are sdpa's
    for r in ranks:
        for got_g, want_g in zip(r["ring_grads"], ref["ring_grads"]):
            np.testing.assert_allclose(got_g, want_g, **TOL)


def test_dit_apply_sp_and_its_gradients_match_jax(results):
    ranks, ref = results
    from sam_audio_tpu_torch.utils import tree_leaves_with_path

    pad = sp_inputs()[3]
    for r in ranks:
        np.testing.assert_allclose(r["sp_out"][pad], ref["sp_out"][pad], **TOL)
    want = dict(tree_leaves_with_path(ref["sp_grads"]))
    for r in ranks:
        assert set(r["sp_grads"]) == set(want)
        for path, g in r["sp_grads"].items():
            np.testing.assert_allclose(g, want[path], err_msg=path, **TOL)


@pytest.mark.parametrize("key", ["sep_k1", "sep_k2", "sep_int8", "sep_tp4"],
                         ids=["dp2tp2-k1", "dp2tp2-k2", "int8-tp2", "tp4-split-heads"])
def test_sharded_separate_matches_jax(results, key):
    ranks, ref = results
    want = ref["sep_int8" if key == "sep_int8" else ("sep_k1" if key == "sep_tp4" else key)]
    for r in ranks:   # every rank returns the same result
        for got, exp in zip(r[key], want):
            for a, b in zip(got, exp):
                assert a.shape == b.shape
                np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("key", ["sep_sp", "sep_stream", "vision_encode"],
                         ids=["sp4-separate", "streamed-under-shard", "shard-covers-pe"])
def test_sharded_paths_match_the_unsharded_port(results, key):
    """sp4 separate (16 frames, 4 a rank), a clip streamed through 4
    windows after shard(), the PE tower shard() places: each equals the
    unsharded port (held against JAX in the other tests)."""
    ranks, _ = results
    for r in ranks:
        plain, sharded = r[key]
        np.testing.assert_allclose(sharded[0], plain[0], **TOL)
    assert all(r["vision_fc1_rows"] == 32 and r["vision_mesh"] for r in ranks)


@pytest.mark.parametrize("key", ["pe", "pe_int8"])
def test_pe_encode_under_tp_matches_jax(results, key):
    ranks, ref = results
    # int8: per-token activation scales over the whole row (a max over tp)
    for r in ranks:
        assert r["pe_fc1_rows"] == 32   # 64 hidden units split over tp2
        np.testing.assert_allclose(r[key], ref[key], **TOL)


def test_mesh_layout_batches_and_process_allgather(results):
    """rank = d * tp + t (JAX's reshape(dp, tp)); the dp block of a global
    batch; JAX's process_allgather (a leading process axis)."""
    ranks, _ = results
    for rank, r in enumerate(ranks):
        assert r["coords"] == ({"dp": rank // 2, "tp": rank % 2}, {"sp": rank},
                               {"dp": 0, "tp": rank})
        assert r["rows"] == (list(range(4 * (rank // 2), 4 * (rank // 2) + 4)), 8)
        np.testing.assert_array_equal(r["allgather"]["rank"], [[0], [1], [2], [3]])
        np.testing.assert_array_equal(r["allgather"]["x"], np.arange(4)[:, None] * np.ones(2))


def test_parallel_errors_match_jax(results):
    ranks, _ = results
    r = ranks[0]
    assert "sequence length 14 must divide over sp=4" in r["err_ring"]
    assert "must divide over sp=4" in r["err_sp_div"]
    assert "requires text memory" in r["err_sp_mem"]
    assert "quantize() before shard()" in r["err_quantize_after_shard"]
