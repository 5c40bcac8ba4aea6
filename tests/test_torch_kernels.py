"""The port's three kernel modules: each plain PyTorch version against the
JAX package's Pallas kernel run in interpret mode on the same numpy inputs.
The CUDA kernels themselves are tested in test_torch_cuda.py.

Tolerances: fp32 1e-5 for the residual unit — the same algorithm, summed in
another order. fp32 1e-4 for the two attention kernels, the port-vs-JAX
bound: their softmax goes through torch's vectorised CPU exp, which is not
correctly rounded and in rare processes differs from a float64 exp by up to
1.5e-4 relative on one thread's share of a tensor (2.7e-5 at the output). bf16
2e-2 (attention) / 5e-2 (residual unit) — both sides round q', k', p (or s1,
h, s2) to bf16 at the same points, but a value that lands near a rounding
boundary in one sum order can round the other way (one bf16 ulp is 2^-8 of
the value), and that step propagates through the next product."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_audio_tpu.models.dacvae import _residual_unit_init
from sam_audio_tpu.ops.flash_attention import flash_attention as jax_flash
from sam_audio_tpu.ops.fused_attention import fused_glue_attention as jax_fused
from sam_audio_tpu.ops.fused_conv import fused_residual_unit as jax_res_unit
from sam_audio_tpu.ops.rope import precompute_rope as jax_rope
from sam_audio_tpu_torch.checkpoint import params_from_numpy
from sam_audio_tpu_torch.ops import _build
from sam_audio_tpu_torch.ops.flash_attention import (
    DEFAULT_MASK_VALUE,
    flash_attention,
    flash_attention_plain,
)
from sam_audio_tpu_torch.ops.conv import snake_f32
from sam_audio_tpu_torch.ops.fused_attention import (
    _norm_rope,
    fused_glue_attention,
    fused_glue_attention_plain,
    fused_glue_attention_split_keys,
)
from sam_audio_tpu_torch.ops.fused_conv import (
    bf16_chunk,
    conv1_chunk,
    fp32_chunk,
    fused_residual_unit,
    fused_residual_unit_plain,
    padded_width,
    prepared_operands,
    residual_unit_operands,
    split_tf32,
    tile_weights,
    tile_weights_fp32,
)
from sam_audio_tpu_torch.ops.rope import precompute_rope

B, T, H, D = 2, 200, 2, 128   # T not a multiple of 128; B*H = 4


def _qkv(seed, t=T, b=B):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, t, H, D).astype(np.float32) for _ in range(3))
    mask = np.ones((b, t), bool)
    mask[0, t * 3 // 4:] = False   # padded batch row
    if b > 1:
        mask[1, :] = False         # fully masked row
    return q, k, v, mask


def _to_jax(x, dtype):
    return jnp.asarray(x).astype(dtype)


def _to_torch(x, dtype):
    return torch.tensor(x).to(dtype)


DTYPES = [(jnp.float32, torch.float32, 1e-4), (jnp.bfloat16, torch.bfloat16, 2e-2)]


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES, ids=["fp32", "bf16"])
def test_fused_glue_attention_plain_matches_pallas_interpret(jdt, tdt, tol):
    q, k, v, mask = _qkv(0)
    rng = np.random.RandomState(1)
    qw = (1 + 0.1 * rng.randn(D)).astype(np.float32)
    kw = (1 + 0.1 * rng.randn(D)).astype(np.float32)
    cj, sj = jax_rope(D, T, 20000)
    ct, st = precompute_rope(D, T, 20000)
    ref = jax_fused(*(_to_jax(x, jdt) for x in (q, k, v)), qw, kw, cj, sj,
                    jnp.asarray(mask), eps=1e-5, interpret=True)
    out = fused_glue_attention_plain(*(_to_torch(x, tdt) for x in (q, k, v)),
                                     torch.tensor(qw), torch.tensor(kw), ct, st,
                                     torch.tensor(mask), eps=1e-5)
    assert out.dtype == tdt and out.shape == (B, T, H, D)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)
    # the fully masked row averages V over the 128-padded key length
    vt = _to_torch(v, tdt).float()
    np.testing.assert_allclose(out[1].float().numpy(),
                               (vt[1].sum(0) / 256).expand(T, H, D).numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES, ids=["fp32", "bf16"])
def test_flash_attention_plain_matches_pallas_interpret(jdt, tdt, tol):
    q, k, v, mask = _qkv(2)
    ref = jax_flash(*(_to_jax(x, jdt) for x in (q, k, v)),
                    key_padding_mask=jnp.asarray(mask), interpret=True)
    out = flash_attention_plain(*(_to_torch(x, tdt) for x in (q, k, v)),
                                torch.tensor(mask))
    assert out.dtype == tdt and out.shape == (B, T, H, D)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_attention_no_mask_equals_all_true_mask(tdt):
    q, k, v, _ = _qkv(4, t=150)
    q, k, v = (_to_torch(x, tdt) for x in (q, k, v))
    out = flash_attention(q, k, v, key_padding_mask=None)
    ref = flash_attention(q, k, v, key_padding_mask=torch.ones(B, 150, dtype=torch.bool))
    assert torch.equal(out, ref)


def _unit_params(c, seed):
    import jax

    p = jax.tree_util.tree_map(np.asarray,
                               _residual_unit_init(jax.random.PRNGKey(seed), c, 1))
    rng = np.random.RandomState(seed)
    for name in ("snake1", "snake2"):  # non-trivial alphas
        p[name]["alpha"] = (0.5 + rng.rand(1, c, 1)).astype(np.float32)
    return p


@pytest.mark.parametrize("dilation", [1, 3, 9])
@pytest.mark.parametrize("jdt,tdt,tol", [(jnp.float32, torch.float32, 1e-5),
                                         (jnp.bfloat16, torch.bfloat16, 5e-2)],
                         ids=["fp32", "bf16"])
def test_residual_unit_plain_matches_pallas_interpret(dilation, jdt, tdt, tol):
    c, t = 16, 300
    p = _unit_params(c, seed=dilation)
    x = np.random.RandomState(dilation).randn(2, c, t).astype(np.float32)
    ref = jax_res_unit(p, jnp.asarray(x), dilation, compute_dtype=jdt, interpret=True)
    assert ref is not None
    out = fused_residual_unit(params_from_numpy(p), torch.tensor(x), dilation,
                              compute_dtype=tdt)
    assert out.dtype == tdt and out.shape == (2, c, t)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def test_wrappers_refuse_other_devices():
    q = torch.zeros(1, 4, 1, 128, device="meta")
    w = torch.ones(128, device="meta")
    with pytest.raises(ValueError):
        fused_glue_attention(q, q, q, w, w, w[:64][None], w[:64][None])
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    p = params_from_numpy(_unit_params(32, 0), device="meta")
    with pytest.raises(ValueError):
        fused_residual_unit(p, torch.zeros(1, 32, 8, device="meta"), 1)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all(tmp_path)


def test_cpu_calls_do_not_count_launches():
    q, k, v, mask = _qkv(3, t=16, b=1)
    before = (fused_glue_attention.launches, flash_attention.launches)
    flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v))
    assert (fused_glue_attention.launches, flash_attention.launches) == before


@pytest.mark.parametrize("t", [1, 63, 200, 257, 512])
def test_split_key_softmax_matches_plain(t):
    """The bf16 kernel's one-pass softmax (per-warpgroup max and sum, one
    exchange) computes the plain version's function: fp32 within 1e-6, with
    a padded row, a fully masked row and a row with holes."""
    q, k, v, mask = _qkv(5, t=t, b=3)
    mask[2, ::3] = False
    rng = np.random.RandomState(6)
    qw, kw = (torch.tensor((1 + 0.1 * rng.randn(D)).astype(np.float32)) for _ in range(2))
    cos, sin = precompute_rope(D, t, 20000)
    args = [torch.tensor(x) for x in (q, k, v)] + [qw, kw, cos, sin, torch.tensor(mask)]
    ref = fused_glue_attention_plain(*args)
    out = fused_glue_attention_split_keys(*args)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("c,nc,nc1", [(32, 32, 32), (64, 64, 64), (96, 96, 96),
                                      (128, 128, 128), (192, 192, 96), (256, 256, 128),
                                      (384, 128, 128), (512, 128, 128), (768, 128, 128),
                                      (160, 32, 32), (224, 32, 32), (40, 64, 64), (16, 32, 32),
                                      (4, 32, 32), (8, 32, 32), (12, 32, 32), (24, 32, 32),
                                      (48, 64, 64), (80, 96, 96), (170, 32, 32),
                                      (200, 32, 32), (300, 32, 32), (0, 0, 0)])
def test_bf16_chunk_plan(c, nc, nc1):
    """One fused kernel (chunk = C) for the widths it has products for, its
    1x1 in two passes above 128; other units split into k7 and 1x1 kernels
    over output-channel chunks that divide C. A width that is not a multiple
    of 32 runs as the next multiple of 32: fused up to 128, else split at
    32."""
    assert bf16_chunk(c) == nc
    assert conv1_chunk(c) == nc1


def _unswizzle(tiles, nc):
    pieces = tiles.reshape(-1, nc, 8, 8)
    src = torch.arange(8)[None, :] ^ (torch.arange(nc) % 8)[:, None]
    return torch.gather(pieces, 2, src[None, :, :, None].expand_as(pieces)).reshape(-1, nc, 64)


def _untile(tiles, c):
    """tile_weights inverted: (w7 (7, cp, nci * 64), w1 (cp, nci * 64)) as
    float, cp = padded_width(c)."""
    nc, nc1, cp, nci = bf16_chunk(c), conv1_chunk(c), padded_width(c), -(-c // 64)
    n7 = (cp // nc) * nci * 7
    part7 = _unswizzle(tiles[:n7 * nc * 64], nc).float()
    part1 = _unswizzle(tiles[n7 * nc * 64:], nc1).float()
    w7 = part7.reshape(cp // nc, nci, 7, nc, 64).permute(2, 0, 3, 1, 4).reshape(7, cp, nci * 64)
    w1 = part1.reshape(cp // nc1, nci, nc1, 64).permute(0, 2, 1, 3).reshape(cp, nci * 64)
    return w7, w1


@pytest.mark.parametrize("c", [32, 96, 192, 256, 384, 4, 48, 80, 200])
def test_tile_weights_order_and_swizzle(c):
    """Slice ((n * nci + kc) * 7 + j) is tap j, output channels of k7 chunk n,
    input channels 64 kc .. 64 kc + 63 (zero past C); the 1x1 slices follow by
    1x1 chunks; piece p of row r is stored at p ^ (r % 8). The output rows run
    to padded_width(C), zero past C."""
    g = torch.Generator().manual_seed(c)
    w7, w1 = torch.randn(7, c, c, generator=g), torch.randn(c, c, generator=g)
    nc, nc1 = bf16_chunk(c), conv1_chunk(c)
    cp, nci = padded_width(c), -(-c // 64)
    tiles = tile_weights(w7, w1, nc, nc1)
    n7 = (cp // nc) * nci * 7
    assert tiles.dtype == torch.bfloat16
    assert tiles.numel() == n7 * nc * 64 + (cp // nc1) * nci * nc1 * 64
    part7 = _unswizzle(tiles[:n7 * nc * 64], nc).float()
    part1 = _unswizzle(tiles[n7 * nc * 64:], nc1).float()
    pad7 = torch.nn.functional.pad(w7, (0, nci * 64 - c, 0, cp - c)).bfloat16().float()
    pad1 = torch.nn.functional.pad(w1, (0, nci * 64 - c, 0, cp - c)).bfloat16().float()
    for kc in range(nci):
        cols = slice(64 * kc, 64 * kc + 64)
        for n in range(cp // nc):
            for j in range(7):
                assert torch.equal(part7[(n * nci + kc) * 7 + j],
                                   pad7[j, n * nc:(n + 1) * nc, cols])
        for n in range(cp // nc1):
            assert torch.equal(part1[n * nci + kc], pad1[n * nc1:(n + 1) * nc1, cols])
    u7, u1 = _untile(tiles, c)
    assert torch.equal(u7, pad7) and torch.equal(u1, pad1)


@pytest.mark.parametrize("c", [4, 12, 48, 80, 200])
@pytest.mark.parametrize("dilation", [1, 9])
def test_padded_operands_compute_the_unit(c, dilation):
    """What the bf16 kernel is given for a width that is not a multiple of
    32 (the tiles, biases and alpha pairs of prepared_operands, padded to
    padded_width(C)) computes the unit on C channels: the plain version on
    the padded operands, with x padded by zero channels, gives the plain
    version's result in its first C rows and exact zeros in the rest (fp32
    over the bf16-rounded weights, 1e-5)."""
    p = params_from_numpy(_unit_params(c, seed=c + dilation))
    tiles, b7, b1, a1, a2 = prepared_operands(p, torch.bfloat16)
    cp = padded_width(c)
    assert b7.shape == b1.shape == (cp,) and a1.shape == a2.shape == (cp, 2)
    assert not b7[c:].any() and not b1[c:].any()
    assert torch.equal(a1[c:, 0], torch.ones(cp - c)) and torch.equal(a2[c:, 0], torch.ones(cp - c))
    w7, w1 = _untile(tiles, c)
    assert not w7[:, c:].any() and not w7[:, :, c:].any()
    assert not w1[c:].any() and not w1[:, c:].any()
    x = torch.tensor(np.random.RandomState(c).randn(2, c, 77).astype(np.float32))
    xp = torch.nn.functional.pad(x, (0, 0, 0, cp - c))
    padded = fused_residual_unit_plain(xp, w7[:, :, :cp].contiguous(), b7, w1[:, :cp].contiguous(),
                                       b1, a1[:, 0], a2[:, 0], dilation)
    _, _, b7c, _, b1c, a1c, a2c = residual_unit_operands(p, x, torch.float32)
    ref = fused_residual_unit_plain(x, w7[:, :c, :c].contiguous(), b7c, w1[:c, :c].contiguous(),
                                    b1c, a1c, a2c, dilation)
    assert not padded[:, c:].any()
    np.testing.assert_allclose(padded[:, :c].numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_prepared_operands_made_once_per_unit():
    """The card's operands are built once per unit and dtype (no weight copy
    a launch), and again when a weight changes in place."""
    p = params_from_numpy(_unit_params(64, 3))
    a = prepared_operands(p, torch.bfloat16)
    assert prepared_operands(p, torch.bfloat16) is a
    _, w7, b7, w1, b1, a1, a2 = residual_unit_operands(p, torch.zeros(1, 64, 1),
                                                       torch.bfloat16)
    assert torch.equal(a[0], tile_weights(w7, w1, 64, 64))
    pairs = [torch.stack([al, 1.0 / (al + 1e-9)], -1) for al in (a1, a2)]
    for got, want in zip(a[1:], [b7, b1] + pairs):
        assert torch.equal(got, want)
    assert prepared_operands(p, torch.float32) is not a
    p["conv2"]["weight"].mul_(2)
    b = prepared_operands(p, torch.bfloat16)
    assert b is not a
    p["conv1"]["bias"].add_(1)
    assert prepared_operands(p, torch.bfloat16) is not b


# ---- the fp32 bodies' split-TF32 ("3xTF32") arithmetic, on the CPU ----


def test_split_tf32_recovers_x():
    """x = hi + lo with hi and lo TF32 (the low 13 mantissa bits zero), hi
    rounded to nearest with ties away from zero (cvt.rna.tf32.f32):
    |hi + lo - x| <= 2^-22 |x| for normal x, and at most half TF32's smallest
    step (2^-137) below that; ±0, subnormals, the largest floats (whose
    rounding would overflow: hi stops at TF32's largest) and inf."""
    rng = np.random.RandomState(0)
    tiny, big = np.finfo(np.float32).tiny, np.finfo(np.float32).max
    x = np.concatenate([
        rng.randn(4096) * 10.0 ** rng.randint(-30, 30, 4096),
        [0.0, -0.0, tiny, -tiny, tiny / 3, -tiny / 7, 1e-45, 3e-39, big, -big,
         big * 0.99997, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12, 1.0 - 2.0 ** -24]]).astype(np.float32)
    xt = torch.tensor(x)
    hi, lo = split_tf32(xt)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = (hi.double() + lo.double() - xt.double()).abs()
    bound = torch.maximum(xt.double().abs() * 2.0 ** -22, torch.tensor(2.0 ** -137, dtype=torch.float64))
    assert bool((err <= bound).all())
    assert torch.equal(torch.signbit(hi[x == 0]), torch.signbit(xt[x == 0]))
    assert float(hi[-3]) == 1.0 + 2.0 ** -10   # a tie rounds away from zero
    assert torch.equal(split_tf32(torch.tensor([np.inf, -np.inf]))[0],
                       torch.tensor([np.inf, -np.inf]))


@pytest.mark.parametrize("c,nc", [(4, 32), (32, 32), (48, 64), (64, 64), (80, 96), (96, 96),
                                  (128, 128), (192, 96), (200, 32), (384, 128), (512, 128),
                                  (768, 128), (1000, 128), (0, 0)])
def test_fp32_chunk_plan(c, nc):
    """One kernel (chunk = the padded width) up to 64 channels; wider units
    split into k7 and 1x1 kernels over output-channel chunks that divide
    the padded width."""
    assert fp32_chunk(c) == nc


@pytest.mark.parametrize("c", [8, 64, 80, 192, 200])
def test_tile_weights_fp32_order_and_swizzle(c):
    """Slice ((n * nci + kc) * 7 + j) is tap j, output channels of chunk n,
    input channels 32 kc .. 32 kc + 31 (zero past C), split into hi then lo;
    the 1x1 slices follow by the same chunks; the four-channel piece p of
    row r is stored at p ^ (r % 8); rows run to padded_width(C), zero past C;
    hi + lo is each weight within 2^-22."""
    g = torch.Generator().manual_seed(c)
    w7, w1 = torch.randn(7, c, c, generator=g), torch.randn(c, c, generator=g)
    nc, cp = fp32_chunk(c), padded_width(c)
    nci, n7 = cp // 32, (cp // nc) * (cp // 32) * 7
    tiles = tile_weights_fp32(w7, w1, nc)
    assert tiles.dtype == torch.float32
    assert tiles.numel() == (n7 + (cp // nc) * nci) * 2 * nc * 32
    pieces = tiles.reshape(-1, 2, nc, 8, 4)
    src = torch.arange(8)[None, :] ^ (torch.arange(nc) % 8)[:, None]
    slices = torch.gather(pieces, 3, src[None, None, :, :, None].expand_as(pieces))
    slices = slices.reshape(-1, 2, nc, 32)
    pad7 = torch.nn.functional.pad(w7, (0, cp - c, 0, cp - c))
    pad1 = torch.nn.functional.pad(w1, (0, cp - c, 0, cp - c))
    for kc in range(nci):
        cols = slice(32 * kc, 32 * kc + 32)
        for n in range(cp // nc):
            rows = slice(n * nc, (n + 1) * nc)
            for j in range(7):
                hi, lo = slices[(n * nci + kc) * 7 + j]
                assert torch.equal(hi, split_tf32(pad7[j, rows, cols])[0])
                assert torch.equal(lo, split_tf32(pad7[j, rows, cols])[1])
            hi, lo = slices[n7 + n * nci + kc]
            assert torch.equal(hi, split_tf32(pad1[rows, cols])[0])
            err = (hi.double() + lo.double() - pad1[rows, cols].double()).abs()
            assert bool((err <= pad1[rows, cols].double().abs() * 2.0 ** -22).all())


def _split_card(x):
    """An operand as the kernels split it on the card: hi = rna(x) in TF32,
    lo = x - hi of which a TF32 product reads the upper 19 bits (taken here
    as truncated, the worse of the ways hardware may read them)."""
    hi = split_tf32(x)[0]
    return hi, ((x - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the fp32 attention body computes it: each operand split in
    TF32 and three products (lo . hi, hi . lo, hi . hi) summed in fp32; a
    product of two TF32 values is exact in fp32."""
    (ah, al), (bh, bl) = _split_card(a), _split_card(b)
    return (al @ bh + ah @ bl) + ah @ bh


def test_3xtf32_holds_the_fp32_contract_where_one_tf32_product_does_not():
    """The split the fp32 bodies run (the weights split on the host, the
    rest on the card), emulated in plain torch and held against float64 at
    the two contractions of the main path: the residual
    unit's dilated k7 conv over 7 x 768 inputs (the decoder's widest unit;
    weights at 1/sqrt(C), |h| up to ~8) within 1e-5, and the attention's
    q' k'^T over D = 128 and p . v over 512 keys after `_norm_rope`, the
    whole softmax(q' k'^T / sqrt(D)) v within 1e-5. One TF32 product (hi .
    hi alone) misses the kernels' 1e-4 at both."""
    rng = np.random.RandomState(0)
    c, t, dil = 768, 64, 9
    x = torch.tensor(rng.randn(1, c, t).astype(np.float32))
    alpha = torch.tensor((0.5 + rng.rand(c, 1)).astype(np.float32))
    w = torch.tensor(((rng.rand(c, c, 7) * 2 - 1) / c ** 0.5).astype(np.float32))
    s1 = snake_f32(x, alpha, False)

    def conv(u, v):
        return torch.nn.functional.conv1d(u, v, padding=3 * dil, dilation=dil)

    ref = conv(s1.double(), w.double())
    (sh, sl), (wh, wl) = _split_card(s1), split_tf32(w)
    three = (conv(sl, wh) + conv(sh, wl)) + conv(sh, wh)
    assert float((three.double() - ref).abs().max()) < 1e-5
    assert float((conv(sh, wh).double() - ref).abs().max()) > 1e-4

    b, t, h = 1, 512, 2
    q, k, v = (torch.tensor(rng.randn(b, t, h, D).astype(np.float32)) for _ in range(3))
    qw, kw = (torch.tensor((1 + 0.1 * rng.randn(D)).astype(np.float32)) for _ in range(2))
    cos, sin = precompute_rope(D, t, 20000)
    qn = _norm_rope(q, qw, cos, sin, 1e-5).transpose(1, 2)
    kt = _norm_rope(k, kw, cos, sin, 1e-5).permute(0, 2, 3, 1)
    vh = v.transpose(1, 2)
    out64 = torch.softmax(qn.double() @ kt.double() / D ** 0.5, -1) @ vh.double()
    out3 = _mm_3xtf32(torch.softmax(_mm_3xtf32(qn, kt) / D ** 0.5, -1), vh)
    assert float((out3.double() - out64).abs().max()) < 1e-5
    one = split_tf32(qn)[0] @ split_tf32(kt)[0]
    out1 = split_tf32(torch.softmax(one / D ** 0.5, -1))[0] @ split_tf32(vh)[0]
    assert float((out1.double() - out64).abs().max()) > 1e-4


def _flash_tiles(q, k, v, mask, mm):
    """Kernel 2's fp32 body as it computes, in plain torch: 64-key tiles over
    the keys padded to a multiple of 128, q . k^T and p . v through `mm`, the
    online softmax in base 2 with the mask constant added after the scaling
    (unscaled), p unrounded, each tile's p . v added to the rescaled running
    output. q: (b, h, sq, D); k, v: (b, h, sk, D); mask: (b, sk) bool."""
    sk = k.shape[2]
    pad = -(-sk // 128) * 128 - sk
    kp, vp = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (k, v))
    keep = torch.nn.functional.pad(mask, (0, pad))[:, None, None, :]
    scale_log2 = D ** -0.5 * float(np.log2(np.e))
    m = torch.full(q.shape[:3] + (1,), float("-inf"))
    l = torch.zeros(q.shape[:3] + (1,))
    o = torch.zeros(q.shape)
    for k0 in range(0, kp.shape[2], 64):
        x = mm(q, kp[:, :, k0:k0 + 64].transpose(-1, -2)) * scale_log2
        x = torch.where(keep[..., k0:k0 + 64], x, x + DEFAULT_MASK_VALUE)
        m_next = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha, p = torch.exp2(m - m_next), torch.exp2(x - m_next)
        l, m = alpha * l + p.sum(-1, keepdim=True), m_next
        o = o * alpha + mm(p, vp[:, :, k0:k0 + 64])
    return o / torch.where(l == 0, torch.ones_like(l), l)


@pytest.mark.parametrize("sk", [1125, 2000])
def test_3xtf32_flash_attention_holds_the_fp32_contract_where_one_tf32_product_does_not(sk):
    """Kernel 2's fp32 body emulated (`_flash_tiles` with `_mm_3xtf32` for
    both products) over 1125 and 2000 keys, a padded row and a fully masked
    row, held against softmax(q k^T / sqrt(D) + mask) v over the padded keys
    in float64 within 1e-5; with one TF32 product for each (hi . hi) it
    misses 1e-4. q and k have std 1.5 (logits of std 2.25, a peakier softmax
    than unit inputs give, as trained attention has)."""
    rng = np.random.RandomState(sk)
    b, h, sq = 2, 2, 128
    q, k = (torch.tensor(1.5 * rng.randn(b, h, n, D).astype(np.float32)) for n in (sq, sk))
    v = torch.tensor(rng.randn(b, h, sk, D).astype(np.float32))
    mask = torch.ones(b, sk, dtype=torch.bool)
    mask[0, sk * 3 // 4:] = False   # padded row
    mask[1, :] = False              # fully masked row: the mean of V over the padded keys
    pad = -(-sk // 128) * 128 - sk
    kp, vp = (torch.nn.functional.pad(x, (0, 0, 0, pad)).double() for x in (k, v))
    keep = torch.nn.functional.pad(mask, (0, pad))[:, None, None, :]
    logits = q.double() @ kp.transpose(-1, -2) * D ** -0.5
    ref = torch.softmax(torch.where(keep, logits, logits + DEFAULT_MASK_VALUE), -1) @ vp
    torch.testing.assert_close(ref[1], vp[1].mean(1, keepdim=True).expand_as(ref[1]))
    three = _flash_tiles(q, k, v, mask, _mm_3xtf32)
    assert float((three.double() - ref).abs().max()) < 1e-5

    def one(a, b):
        return split_tf32(a)[0] @ split_tf32(b)[0]

    assert float((_flash_tiles(q, k, v, mask, one).double() - ref).abs().max()) > 1e-4
