"""The port's quantized serving modes against the JAX package's (fp32, CPU):
bit-identical quantization, the int8 and int4 linears, kernel 4's plain
version against the Pallas kernel in interpret mode, nn.linear's dispatch,
and the tiny model's separate() after quantize(4) and quantize(8).

Tolerances: 1e-5 for one product (the same sums in another order); 1e-4 for
separate() (PARITY.md's bound for converted weights)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_audio_tpu.config import tiny_test_config as jax_tiny_config
from sam_audio_tpu.models.sam_audio import SAMAudio as JaxSAMAudio
from sam_audio_tpu.ops import quant as JQ
from sam_audio_tpu.ops.int4_matmul import matmul_int4 as jax_matmul_int4
from sam_audio_tpu.processor import SAMAudioProcessor as JaxProcessor
from sam_audio_tpu.text_tokenizer import ByteFallbackTokenizer as JaxByteTokenizer
from sam_audio_tpu_torch import SAMAudio, SAMAudioProcessor, tiny_test_config
from sam_audio_tpu_torch.checkpoint import cast_matmul_weights, params_from_numpy
from sam_audio_tpu_torch.ops import nn as N
from sam_audio_tpu_torch.ops import quant as TQ
from sam_audio_tpu_torch.ops.int4_matmul import (
    RESIDENT_BLOCKS,
    ROW_TILE,
    token_tile,
    matmul_int4,
    matmul_int4_plain,
    split_plan,
    unpack_int4,
)
from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(24, 256), (3, 32, 256), (8, 160)],
                         ids=["2d", "stacked", "odd-group"])
def test_quantize_is_bit_identical_to_jax(shape, bits):
    w = (np.random.RandomState(len(shape)).randn(*shape) * 0.1).astype(np.float32)
    b = np.random.RandomState(1).randn(shape[-2]).astype(np.float32)
    jq = {8: JQ.quantize_linear, 4: JQ.quantize_linear_int4}[bits]
    tq = {8: TQ.quantize_linear, 4: TQ.quantize_linear_int4}[bits]
    ref = _np(jq({"weight": jnp.asarray(w), "bias": jnp.asarray(b)}))
    out = tq({"weight": torch.tensor(w), "bias": torch.tensor(b)})
    assert set(out) == set(ref)
    for key in ref:
        got = out[key].numpy()
        assert got.dtype == ref[key].dtype and got.shape == ref[key].shape, key
        np.testing.assert_array_equal(got, ref[key], err_msg=key)
    if bits == 4 and shape == (8, 160):
        assert out["w4_scale"].shape == (8, 2)   # 160 % 128 != 0 -> group 80


def test_linear_int8_matches_jax():
    rng = np.random.RandomState(0)
    p = {"weight": rng.randn(24, 48).astype(np.float32),
         "bias": rng.randn(24).astype(np.float32)}
    x = rng.randn(5, 7, 48).astype(np.float32)
    q = _np(JQ.quantize_linear({k: jnp.asarray(v) for k, v in p.items()}))
    ref = np.asarray(JQ.linear_int8(q, jnp.asarray(x)))
    out = TQ.linear_int8(params_from_numpy(q), torch.tensor(x))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(N.linear(params_from_numpy(q), torch.tensor(x)).numpy(),
                               ref, **TOL)


@pytest.mark.parametrize("out_in,tokens", [((32, 256), 5), ((64, 384), 3), ((8, 160), 4)],
                         ids=["g128", "three-groups", "g80"])
def test_matmul_int4_plain_matches_pallas_and_xla_paths(out_in, tokens):
    rng = np.random.RandomState(out_in[0])
    q = _np(JQ.quantize_linear_int4(
        {"weight": jnp.asarray(rng.randn(*out_in).astype(np.float32) * 0.1)}))
    x = rng.randn(tokens, out_in[1]).astype(np.float32)
    got = matmul_int4_plain(torch.tensor(x), torch.tensor(q["w4"]),
                            torch.tensor(q["w4_scale"])).numpy()
    assert got.shape == (tokens, out_in[0])
    if out_in[1] % 128 == 0:   # the Pallas kernel takes 128-lane groups
        pallas = jax_matmul_int4(jnp.asarray(x), q["w4"], q["w4_scale"], interpret=True)
        np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    xla = JQ.linear_int4(q, jnp.asarray(x), jnp.float32)   # dequantize, then matmul
    np.testing.assert_allclose(got, np.asarray(xla), **TOL)
    # the wrapper takes the plain version for CPU tensors, uncounted
    n = matmul_int4.launches
    np.testing.assert_array_equal(matmul_int4(torch.tensor(x), torch.tensor(q["w4"]),
                                              torch.tensor(q["w4_scale"])).numpy(), got)
    assert matmul_int4.launches == n


@pytest.mark.parametrize("tokens", [1, 14, 250, 2000])
@pytest.mark.parametrize("groups", [1, 6, 16, 43])
def test_split_plan_covers_every_group_once(groups, tokens):
    for half in (1024, 2752, 100):
        plan = split_plan(tokens, half, groups)
        assert 1 <= len(plan) <= groups
        covered = [g for first, end in plan for g in range(first, end)]
        assert covered == list(range(groups))          # each group once, in order
        assert all(end > first for first, end in plan)  # no empty split
        tiles = -(-half // ROW_TILE) * -(-tokens // token_tile(tokens))
        assert len(plan) == 1 or tiles * len(plan) <= RESIDENT_BLOCKS
    # the serving shapes at 250 tokens fill most of one wave; (5504, 2048)
    # is 86 tiles in both bodies (fp32 too takes 128-token tiles): one wave,
    # unsplit
    if tokens == 250 and groups >= 6:
        assert len(split_plan(tokens, 1024, groups)) == 4
    if tokens == 250:
        assert len(split_plan(tokens, 2752, groups)) == 1


def _split_bf16x3(x):
    """x (fp32) as kernel 4's fp32 body splits it on the card: hi = rn(x) in
    bf16 (rounded toward zero where rn would pass bf16's largest), mid =
    rn(x - hi), lo = rn(x - hi - mid); an infinite or NaN x is hi alone."""
    hi = x.to(torch.bfloat16)
    toward_zero = (x.view(torch.int32) & -65536).view(torch.float32).to(torch.bfloat16)
    hi = torch.where(torch.isinf(hi) & torch.isfinite(x), toward_zero, hi)
    r1 = torch.where(torch.isfinite(x), x - hi.float(), torch.zeros_like(x))
    mid = r1.to(torch.bfloat16)
    return hi, mid, (r1 - mid.float()).to(torch.bfloat16)


def test_bf16x3_split_recovers_x():
    """hi + mid + lo is x exactly for normal x down to 2^-100 (the three
    planes hold its 24 significant bits) and within 2^-134 below (bf16's
    subnormal step): ±0 keep their sign, subnormals, and the largest floats
    (hi stops at bf16's largest) stay finite."""
    rng = np.random.RandomState(0)
    tiny, big = np.finfo(np.float32).tiny, np.finfo(np.float32).max
    x = np.concatenate([
        rng.randn(4096) * 10.0 ** rng.randint(-30, 30, 4096),
        [0.0, -0.0, tiny, -tiny, tiny / 3, -tiny / 7, 1e-45, 3e-39, big, -big, big * 0.99997,
         1.0 + 2.0 ** -8, 1.0 + 2.0 ** -9 + 2.0 ** -23, 1.0 - 2.0 ** -24]]).astype(np.float32)
    xt = torch.tensor(x)
    hi, mid, lo = _split_bf16x3(xt)
    assert all(bool(torch.isfinite(p).all()) for p in (hi, mid, lo))
    err = (hi.double() + mid.double() + lo.double() - xt.double()).abs()
    assert float(err[xt.abs() >= 2.0 ** -100].max()) == 0.0
    assert float(err.max()) <= 2.0 ** -134
    assert torch.equal(torch.signbit(hi[x == 0]), torch.signbit(xt[x == 0]))
    assert float(hi[-3]) == 1.0 and float(mid[-3]) == 2.0 ** -8   # a tie rounds to even
    inf = torch.tensor([np.inf, -np.inf, np.nan])
    assert torch.equal(_split_bf16x3(inf)[1], torch.zeros(3, dtype=torch.bfloat16))


def test_int4_three_bf16_planes_hold_the_fp32_contract_where_one_plane_does_not():
    """Kernel 4's fp32 body emulated at the DiT's (2048, 2048) and 250
    tokens, groups of 128: each group's partial lo . W + mid . W + hi . W
    (products of a bf16 plane and an int4 weight are exact in fp32) is
    scaled and summed in fp32, within 1e-5 of float64; with the hi plane
    alone it misses 1e-4."""
    rng = np.random.RandomState(1)
    m, k, n = 250, 2048, 2048
    x = torch.tensor(rng.randn(m, k).astype(np.float32))
    q = TQ.quantize_linear_int4({"weight": torch.tensor(
        (rng.randn(n, k) / k ** 0.5).astype(np.float32))})
    w = torch.cat(unpack_int4(q["w4"])).float()
    s = q["w4_scale"]
    planes = [p.float() for p in _split_bf16x3(x)]
    ref = torch.zeros(m, n, dtype=torch.float64)
    three, one = torch.zeros(m, n), torch.zeros(m, n)
    for g in range(s.shape[1]):
        cols = slice(128 * g, 128 * (g + 1))
        wt = w[:, cols].t()
        ref += (x[:, cols].double() @ wt.double()) * s[:, g].double()
        part = planes[2][:, cols] @ wt
        part = part + planes[1][:, cols] @ wt
        three += (part + planes[0][:, cols] @ wt) * s[:, g]
        one += (planes[0][:, cols] @ wt) * s[:, g]
    assert float((three.double() - ref).abs().max()) < 1e-5
    assert float((one.double() - ref).abs().max()) > 1e-4


@pytest.mark.parametrize("groups,tokens", [(6, 14), (16, 250), (43, 5)])
def test_split_wise_plain_sum_equals_plain(groups, tokens):
    """What the split kernel computes: the plain version over each split's
    groups, added in fp32 in split order, equals the plain version."""
    rng = np.random.RandomState(groups)
    din = groups * 128
    q = TQ.quantize_linear_int4({"weight": torch.tensor(
        rng.randn(64, din).astype(np.float32) * 0.1)})
    x = torch.tensor(rng.randn(tokens, din).astype(np.float32) * 0.1)   # |y| < 1
    total = torch.zeros(tokens, 64)
    plan = split_plan(tokens, 2048, groups)[:groups]
    if len(plan) == 1:   # a plan of one split proves nothing: cut it in three
        plan = [(s * groups // 3, (s + 1) * groups // 3) for s in range(3)]
    for first, end in plan:
        cols = slice(first * 128, end * 128)
        total = total + matmul_int4_plain(x[:, cols], q["w4"][:, cols],
                                          q["w4_scale"][:, first:end])
    ref = matmul_int4_plain(x, q["w4"], q["w4_scale"])
    np.testing.assert_allclose(total.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)


def test_linear_dispatches_on_quantized_keys():
    rng = np.random.RandomState(3)
    p = {"weight": rng.randn(16, 128).astype(np.float32) * 0.1,
         "bias": rng.randn(16).astype(np.float32)}
    x = rng.randn(2, 3, 128).astype(np.float32)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    for bits, jq, jlin in ((8, JQ.quantize_linear, JQ.linear_int8),
                           (4, JQ.quantize_linear_int4, JQ.linear_int4)):
        q = _np(jq({k: jnp.asarray(v) for k, v in p.items()}))
        ref = np.asarray(jlin(q, jnp.asarray(x), jnp.float32))
        out = N.linear(TQ._QUANTIZERS[bits](tp), torch.tensor(x), torch.float32)
        assert out.shape == (2, 3, 16)
        np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_cast_matmul_weights_leaves_quantized_leaves():
    cfg = tiny_test_config()
    from sam_audio_tpu_torch.models.init import sam_audio_init

    p = sam_audio_init(cfg, torch.Generator().manual_seed(0), "cpu")
    for bits, keys in ((4, ("w4", "w4_scale")), (8, ("w8", "w_scale"))):
        q = cast_matmul_weights(TQ.quantize_sam_audio_params(p, bits), torch.bfloat16)
        wq = q["transformer"]["layers"]["attention"]["wq"]
        assert {wq[k].dtype for k in keys} == {TQ._QUANTIZERS[bits](
            p["transformer"]["layers"]["attention"]["wq"])[k].dtype for k in keys}
        assert "weight" not in wq and q["proj"][keys[0]].dtype in (torch.uint8, torch.int8)
        assert q["transformer"]["output"]["weight"].dtype == torch.bfloat16


def _models(tmp_path, bits, via_snapshot):
    """The JAX tiny model quantized by the JAX package, and the port's model:
    quantized by the port from the same snapshot, or loaded from a snapshot
    of the JAX-quantized tree."""
    cfg = jax_tiny_config()
    tok = JaxByteTokenizer(cfg.text_encoder.vocab_size)
    jm = JaxSAMAudio.init_random(jax.random.PRNGKey(0), cfg, tokenizer=tok)
    if not via_snapshot:
        jm.save_pretrained(str(tmp_path))
    jm.quantize(bits)
    if via_snapshot:
        jm.save_pretrained(str(tmp_path))
    tm = SAMAudio.from_pretrained(str(tmp_path), device="cpu", allow_random_towers=True,
                                  tokenizer=ByteFallbackTokenizer(cfg.text_encoder.vocab_size))
    if not via_snapshot:
        tm.quantize(bits)
    key = {8: "w8", 4: "w4"}[bits]
    assert key in tm.params["transformer"]["layers"]["feed_forward"]["w2"]
    assert key in tm.params["proj"]
    return cfg, jm, tm


@pytest.mark.parametrize("via_snapshot", [False, True], ids=["port-quantizes",
                                                             "jax-quantized-snapshot"])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantized_separate_matches_jax(tmp_path, bits, via_snapshot):
    cfg, jm, tm = _models(tmp_path, bits, via_snapshot)
    rng = np.random.RandomState(bits)
    audios = [rng.randn(1, 77).astype(np.float32) * 0.2,
              rng.randn(1, 50).astype(np.float32) * 0.2]
    kw = dict(audio_hop_length=cfg.audio_codec.hop_length,
              audio_sampling_rate=cfg.audio_codec.sample_rate)
    jb = JaxProcessor(**kw)(descriptions=["a dog", "rain"], audios=audios)
    tb = SAMAudioProcessor(**kw)(descriptions=["a dog", "rain"], audios=audios)
    noise = rng.randn(2, jb.anchor_alignment.shape[-1],
                      2 * cfg.audio_codec.codebook_dim).astype(np.float32)
    ref = jm.separate(jb, noise=noise)
    out = tm.separate(tb, noise=noise)
    for i in range(2):
        np.testing.assert_allclose(out.target[i], np.asarray(ref.target[i]),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(out.residual[i], np.asarray(ref.residual[i]),
                                   rtol=1e-4, atol=1e-4)
