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
from sam_audio_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from sam_audio_tpu_torch.ops.fused_attention import (
    fused_glue_attention,
    fused_glue_attention_plain,
    fused_glue_attention_split_keys,
)
from sam_audio_tpu_torch.ops.fused_conv import (
    bf16_chunk,
    conv1_chunk,
    fused_residual_unit,
    prepared_operands,
    residual_unit_operands,
    tile_weights,
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
                                      (160, 32, 32), (224, 32, 32), (40, 0, 0), (16, 0, 0)])
def test_bf16_chunk_plan(c, nc, nc1):
    """One fused kernel (chunk = C) for the widths it has products for, its
    1x1 in two passes above 128; other units split into k7 and 1x1 kernels
    over output-channel chunks that divide C."""
    assert bf16_chunk(c) == nc
    assert conv1_chunk(c) == nc1


def _unswizzle(tiles, nc):
    pieces = tiles.reshape(-1, nc, 8, 8)
    src = torch.arange(8)[None, :] ^ (torch.arange(nc) % 8)[:, None]
    return torch.gather(pieces, 2, src[None, :, :, None].expand_as(pieces)).reshape(-1, nc, 64)


@pytest.mark.parametrize("c", [32, 96, 192, 256, 384])
def test_tile_weights_order_and_swizzle(c):
    """Slice ((n * nci + kc) * 7 + j) is tap j, output channels of k7 chunk n,
    input channels 64 kc .. 64 kc + 63 (zero past C); the 1x1 slices follow by
    1x1 chunks; piece p of row r is stored at p ^ (r % 8)."""
    g = torch.Generator().manual_seed(c)
    w7, w1 = torch.randn(7, c, c, generator=g), torch.randn(c, c, generator=g)
    nc, nc1 = bf16_chunk(c), conv1_chunk(c)
    nci = -(-c // 64)
    tiles = tile_weights(w7, w1, nc, nc1)
    n7 = (c // nc) * nci * 7
    assert tiles.dtype == torch.bfloat16
    assert tiles.numel() == n7 * nc * 64 + (c // nc1) * nci * nc1 * 64
    part7 = _unswizzle(tiles[:n7 * nc * 64], nc).float()
    part1 = _unswizzle(tiles[n7 * nc * 64:], nc1).float()
    pad7 = torch.nn.functional.pad(w7, (0, nci * 64 - c)).bfloat16().float()
    pad1 = torch.nn.functional.pad(w1, (0, nci * 64 - c)).bfloat16().float()
    for kc in range(nci):
        cols = slice(64 * kc, 64 * kc + 64)
        for n in range(c // nc):
            for j in range(7):
                assert torch.equal(part7[(n * nci + kc) * 7 + j],
                                   pad7[j, n * nc:(n + 1) * nc, cols])
        for n in range(c // nc1):
            assert torch.equal(part1[n * nci + kc], pad1[n * nc1:(n + 1) * nc1, cols])


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
