"""The port's CUDA kernels on the card: each wrapper, given CUDA tensors,
launches its kernel (its launch counter moves) and agrees with its plain
PyTorch version. Skipped on machines without an NVIDIA GPU. Imports neither
JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Tolerances: fp32 1e-4 (another summation order); bf16 2e-2 for attention
and the int4 product, 5e-2 for the residual unit (a value near a bf16
rounding boundary can round the other way in one sum order, one bf16 ulp
being 2^-8 of it)."""

import pytest
import torch

from sam_audio_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from sam_audio_tpu_torch.ops.fused_attention import (
    fused_glue_attention,
    fused_glue_attention_plain,
)
from sam_audio_tpu_torch.ops.fused_conv import (
    fused_residual_unit,
    fused_residual_unit_plain,
    residual_unit_operands,
)
from sam_audio_tpu_torch.ops.int4_matmul import matmul_int4, matmul_int4_plain
from sam_audio_tpu_torch.ops.quant import quantize_linear_int4
from sam_audio_tpu_torch.ops.rope import precompute_rope

H, D = 2, 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(dev, t, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(2, t, H, D, generator=g, device=dev).to(dtype)
               for _ in range(3))
    mask = torch.ones((2, t), dtype=torch.bool, device=dev)
    mask[0, t * 3 // 4:] = False   # padded batch row
    mask[1, :] = False             # fully masked row
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_cuda_fused_glue_attention_launches_kernel(cuda, dtype, tol):
    q, k, v, mask = _qkv(cuda, 200, dtype, 4)
    w = torch.ones(D, device=cuda)
    cos, sin = precompute_rope(D, 200, 20000, device=cuda)
    n = fused_glue_attention.launches
    out = fused_glue_attention(q, k, v, w, w, cos, sin, mask)
    assert fused_glue_attention.launches == n + 1
    ref = fused_glue_attention_plain(q, k, v, w, w, cos, sin, mask)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def _glue_inputs(dev, b, t, dtype):
    """q, k, v, norm weights, rope tables and a mask: row 0 padded, and where
    the batch has them row 1 fully masked and row 2 with holes."""
    g = torch.Generator(device=dev).manual_seed(t + b)
    q, k, v = (torch.randn(b, t, H, D, generator=g, device=dev).to(dtype) for _ in range(3))
    qw, kw = (1 + 0.1 * torch.randn(D, generator=g, device=dev) for _ in range(2))
    cos, sin = precompute_rope(D, t, 20000, device=dev)
    mask = torch.ones((b, t), dtype=torch.bool, device=dev)
    mask[0, max(1, t * 3 // 4):] = False
    if b > 1:
        mask[1, :] = False
    if b > 2:
        mask[2, ::3] = False
    return q, k, v, qw, kw, cos, sin, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("t", [1, 63, 64, 200, 250, 256, 257, 511, 512])
def test_cuda_fused_glue_attention_lengths_and_batches(cuda, dtype, tol, b, t):
    """Lengths on and off the 64-row query tiles and the 128-key padding (one
    to four key blocks a warpgroup); a fully masked row is the sum of V over
    round_up(T, 128) keys."""
    args = _glue_inputs(cuda, b, t, dtype)
    q, k, v, qw, kw, cos, sin, mask = args
    out = fused_glue_attention(*args)
    ref = fused_glue_attention_plain(*args)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if b > 1:
        want = (v[1].float().sum(0) / (-(-t // 128) * 128)).expand(t, H, D)
        torch.testing.assert_close(out[1].float(), want, rtol=tol, atol=tol)
    assert torch.equal(out, fused_glue_attention(*args)), "two runs differ"


@pytest.mark.cuda
@pytest.mark.parametrize("b,h", [(1, 16), (4, 16), (8, 16), (4, H)])
def test_cuda_fused_glue_attention_fp32_serving_shapes(cuda, b, h):
    """The fp32 body (3xTF32 tensor-core products) at T = 250, the quantized
    serving modes' shape (B = 1 a separate, 4 a streamed group, 8 at k = 8;
    16 heads): within 1e-4 of the plain version, a padded row (and where B
    > 1 a fully masked row, which averages V over the 256 padded keys), two
    runs bit-equal."""
    t = 250
    g = torch.Generator(device=cuda).manual_seed(b * 100 + h)
    q, k, v = (torch.randn(b, t, h, D, generator=g, device=cuda) for _ in range(3))
    qw, kw = (1 + 0.1 * torch.randn(D, generator=g, device=cuda) for _ in range(2))
    cos, sin = precompute_rope(D, t, 20000, device=cuda)
    mask = torch.ones((b, t), dtype=torch.bool, device=cuda)
    mask[0, t * 3 // 4:] = False
    if b > 1:
        mask[1, :] = False
    n = fused_glue_attention.launches
    out = fused_glue_attention(q, k, v, qw, kw, cos, sin, mask)
    assert fused_glue_attention.launches == n + 1
    ref = fused_glue_attention_plain(q, k, v, qw, kw, cos, sin, mask)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    if b > 1:
        torch.testing.assert_close(out[1], (v[1].sum(0) / 256).expand(t, h, D),
                                   rtol=1e-4, atol=1e-4)
    assert torch.equal(out, fused_glue_attention(q, k, v, qw, kw, cos, sin, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [250, 512])
def test_cuda_fused_glue_attention_no_mask_equals_all_true(cuda, dtype, t):
    q, k, v, qw, kw, cos, sin, _ = _glue_inputs(cuda, 2, t, dtype)
    mask = torch.ones((2, t), dtype=torch.bool, device=cuda)
    assert torch.equal(fused_glue_attention(q, k, v, qw, kw, cos, sin),
                       fused_glue_attention(q, k, v, qw, kw, cos, sin, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_cuda_flash_attention_launches_kernel(cuda, dtype, tol):
    q, k, v, mask = _qkv(cuda, 1100, dtype, 5)
    n = flash_attention.launches
    out = flash_attention(q, k, v, mask)
    assert flash_attention.launches == n + 1
    ref = flash_attention_plain(q, k, v, mask)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("s", [1024, 1125, 2000])
def test_cuda_flash_attention_lengths_and_batches(cuda, dtype, tol, b, s):
    """Sequence lengths on and off the 128-key padding and the 64-row tiles;
    a padded row everywhere, a fully masked row where the batch has one."""
    g = torch.Generator(device=cuda).manual_seed(s + b)
    q, k, v = (torch.randn(b, s, H, D, generator=g, device=cuda).to(dtype) for _ in range(3))
    mask = torch.ones((b, s), dtype=torch.bool, device=cuda)
    mask[0, s * 3 // 4:] = False
    if b > 1:
        mask[1, :] = False
        mask[2, ::3] = False   # holes, not only a padded tail
    out = flash_attention(q, k, v, mask)
    ref = flash_attention_plain(q, k, v, mask)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if b > 1:   # the fully masked row: the sum of V over round_up(S, 128) keys
        want = (v[1].float().sum(0) / (-(-s // 128) * 128)).expand(s, H, D)
        torch.testing.assert_close(out[1].float(), want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk", [(1, 1125, 1125), (8, 2000, 2000), (2, 700, 1300),
                                     (3, 1500, 1030)])
def test_cuda_flash_attention_fp32_runs_bit_equal_and_other_key_lengths(cuda, b, sq, sk):
    """The fp32 body: two runs on one input give the same bits, and queries
    and keys of different lengths (a padded row, a fully masked row and
    holes where the batch has them) agree with the plain version."""
    g = torch.Generator(device=cuda).manual_seed(sq + sk)
    q = torch.randn(b, sq, H, D, generator=g, device=cuda)
    k, v = (torch.randn(b, sk, H, D, generator=g, device=cuda) for _ in range(2))
    mask = torch.ones((b, sk), dtype=torch.bool, device=cuda)
    mask[0, sk * 3 // 4:] = False
    if b > 1:
        mask[1, :] = False
    if b > 2:
        mask[2, ::3] = False
    out = flash_attention(q, k, v, mask)
    ref = flash_attention_plain(q, k, v, mask)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    assert torch.equal(out, flash_attention(q, k, v, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_no_mask_equals_all_true(cuda, dtype):
    q, k, v, _ = _qkv(cuda, 1125, dtype, 6)
    mask = torch.ones((2, 1125), dtype=torch.bool, device=cuda)
    assert torch.equal(flash_attention(q, k, v), flash_attention(q, k, v, mask))


def _unit(dev, c, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def u(*shape):
        return (torch.rand(*shape, generator=g, device=dev) * 2 - 1) / shape[1] ** 0.5

    return {"snake1": {"alpha": 0.5 + torch.rand(1, c, 1, generator=g, device=dev)},
            "conv1": {"weight": u(c, c, 7), "bias": u(c, c)[0]},
            "snake2": {"alpha": 0.5 + torch.rand(1, c, 1, generator=g, device=dev)},
            "conv2": {"weight": u(c, c, 1), "bias": u(c, c)[0]}}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
def test_cuda_residual_unit_launches_kernel(cuda, dtype, tol):
    p = _unit(cuda, 96, 7)
    x = torch.randn(2, 96, 5000, device=cuda)
    for dilation in (1, 3, 9):
        n = fused_residual_unit.launches
        out = fused_residual_unit(p, x, dilation, dtype)
        assert fused_residual_unit.launches == n + 1
        ref = fused_residual_unit_plain(*residual_unit_operands(p, x, dtype), dilation)
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("dilation", [1, 3, 9])
@pytest.mark.parametrize("c", [64, 96, 128, 192, 256, 384, 512, 768, 4, 8, 16, 24, 48, 80, 200])
def test_cuda_residual_unit_widths_bf16(cuda, c, dilation, b):
    """Every width of the codec, fused (C <= 128) and split over output-channel
    chunks, at a ragged T; widths that are not multiples of 32 (the JAX
    examples' and tiny_test_config's codecs) padded to the next one; two runs
    give the same bits."""
    p = _unit(cuda, c, c + dilation)
    x = torch.randn(b, c, 3001, generator=torch.Generator(device=cuda).manual_seed(c),
                    device=cuda).to(torch.bfloat16)
    out = fused_residual_unit(p, x, dilation, torch.bfloat16)
    ref = fused_residual_unit_plain(*residual_unit_operands(p, x, torch.bfloat16), dilation)
    torch.testing.assert_close(out.float(), ref.float(), rtol=5e-2, atol=5e-2)
    assert torch.equal(out, fused_residual_unit(p, x, dilation, torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("dilation", [1, 3, 9])
@pytest.mark.parametrize("c", [64, 192, 512, 4, 8, 16, 24, 48, 80, 384, 768, 1000])
def test_cuda_residual_unit_widths_fp32(cuda, c, dilation):
    """The fp32 body (3xTF32 tensor-core products) at widths fused (padded to
    32 or 64) and split over output-channel chunks (1000: padded to 1024),
    at a ragged T; two runs give the same bits."""
    p = _unit(cuda, c, c + dilation)
    x = torch.randn(2, c, 3001, generator=torch.Generator(device=cuda).manual_seed(c),
                    device=cuda)
    out = fused_residual_unit(p, x, dilation, torch.float32)
    ref = fused_residual_unit_plain(*residual_unit_operands(p, x, torch.float32), dilation)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    assert torch.equal(out, fused_residual_unit(p, x, dilation, torch.float32))


# (C, T) of the codec's residual units on a 10 s 48 kHz clip (chip_smoke.py's
# ENCODER_SHAPES + DECODER_SHAPES): the fp32 path's 36 launches a separate
MAIN_SHAPES = [(64, 480000), (128, 240000), (256, 30000), (512, 3000),
               (768, 3000), (384, 30000), (192, 240000), (96, 480000)]


@pytest.mark.cuda
@pytest.mark.parametrize("dilation", [1, 3, 9])
@pytest.mark.parametrize("b,c,t", [(1, c, t) for c, t in MAIN_SHAPES]
                         + [(8, 256, 30000), (8, 384, 30000)])
def test_cuda_residual_unit_main_shapes_fp32(cuda, b, c, t, dilation):
    """The fp32 body at every main-path shape (B = 1; B = 8 at one encoder
    and one decoder shape, the judge's k = 8 encode): one launch counted,
    within 1e-4 of the plain version, two runs bit-equal."""
    p = _unit(cuda, c, c + dilation)
    x = torch.randn(b, c, t, generator=torch.Generator(device=cuda).manual_seed(c + b),
                    device=cuda)
    n = fused_residual_unit.launches
    out = fused_residual_unit(p, x, dilation, torch.float32)
    assert fused_residual_unit.launches == n + 1
    ref = fused_residual_unit_plain(*residual_unit_operands(p, x, torch.float32), dilation)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    del ref
    assert torch.equal(out, fused_residual_unit(p, x, dilation, torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("c", [64, 256])
def test_cuda_residual_unit_shorter_than_halo(cuda, dtype, tol, c):
    """T = 20 at dilation 9: every tap of every row reaches the zero padding
    on one side or the other."""
    p = _unit(cuda, c, 3)
    x = torch.randn(2, c, 20, device=cuda)
    out = fused_residual_unit(p, x, 9, dtype)
    ref = fused_residual_unit_plain(*residual_unit_operands(p, x, dtype), 9)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_residual_unit_refuses_what_it_cannot_take(cuda):
    """Any width runs; a dilation whose halo passes the bf16 kernel's 256
    staged rows does not."""
    with pytest.raises(ValueError):
        fused_residual_unit(_unit(cuda, 40, 1), torch.randn(1, 40, 64, device=cuda), 27)


def _int4(dev, out, din, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return quantize_linear_int4({"weight": 0.1 * torch.randn(out, din, generator=g,
                                                             device=dev)})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("tokens,out,din", [(250, 256, 512), (14, 200, 768), (77, 64, 160)],
                         ids=["k1-tokens", "few-tokens-ragged-out", "group-80"])
def test_cuda_matmul_int4_launches_kernel(cuda, dtype, tol, tokens, out, din):
    q = _int4(cuda, out, din, tokens)
    x = torch.randn(tokens, din, device=cuda).to(dtype)
    n = matmul_int4.launches
    y = matmul_int4(x, q["w4"], q["w4_scale"])
    assert matmul_int4.launches == n + 1 and y.dtype == dtype and y.shape == (tokens, out)
    ref = matmul_int4_plain(x, q["w4"], q["w4_scale"])
    torch.testing.assert_close(y.float(), ref.float(), rtol=tol, atol=tol)


# (out, in) of the DiT's quantized linears at full width
DIT_SHAPES = [(2048, 2048), (5504, 2048), (2048, 5504), (2048, 768)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("tokens", [1, 14, 250, 2000])
@pytest.mark.parametrize("out,din", DIT_SHAPES, ids=lambda v: str(v))
def test_cuda_matmul_int4_dit_shapes(cuda, tokens, out, din, dtype, tol):
    """Every split plan the serving path meets (1 to 16 splits, uneven ones
    over 43 and 6 groups; fp32 tiles of 16 or 64 tokens), and two runs
    giving the same bits."""
    q = _int4(cuda, out, din, tokens + out)
    g = torch.Generator(device=cuda).manual_seed(tokens)
    x = torch.randn(tokens, din, generator=g, device=cuda).to(dtype)
    y = matmul_int4(x, q["w4"], q["w4_scale"])
    assert y.dtype == dtype
    ref = matmul_int4_plain(x, q["w4"], q["w4_scale"])
    torch.testing.assert_close(y.float(), ref.float(), rtol=tol, atol=tol)
    assert torch.equal(y, matmul_int4(x, q["w4"], q["w4_scale"]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("tokens,out,din,group", [(250, 256, 512, 64), (40, 200, 768, 128),
                                                  (9, 72, 96, 32), (300, 136, 2048, 16)],
                         ids=["group-64", "ragged-out", "group-32", "group-16"])
def test_cuda_matmul_int4_groups_and_ragged_rows(cuda, tokens, out, din, group, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(out)
    q = quantize_linear_int4({"weight": 0.1 * torch.randn(out, din, generator=g, device=cuda)},
                             group_size=group)
    assert q["w4_scale"].shape == (out, din // group)
    x = torch.randn(tokens, din, generator=g, device=cuda).to(dtype)
    y = matmul_int4(x, q["w4"], q["w4_scale"])
    ref = matmul_int4_plain(x, q["w4"], q["w4_scale"])
    torch.testing.assert_close(y.float(), ref.float(), rtol=tol, atol=tol)
    assert torch.equal(y, matmul_int4(x, q["w4"], q["w4_scale"]))


@pytest.mark.cuda
def test_cuda_matmul_int4_refuses_other_scales(cuda):
    q = _int4(cuda, 64, 256, 1)
    x = torch.randn(4, 256, device=cuda)
    with pytest.raises(ValueError):
        matmul_int4(x, q["w4"], q["w4_scale"].double())
    with pytest.raises(ValueError):
        matmul_int4(x, q["w4"], q["w4_scale"].t().contiguous().t())


@pytest.mark.cuda
def test_cuda_matmul_int4_refuses_what_it_cannot_take(cuda):
    q = _int4(cuda, 16, 120, 0)   # group 120: not a multiple of 16
    with pytest.raises(ValueError):
        matmul_int4(torch.randn(4, 120, device=cuda), q["w4"], q["w4_scale"])


@pytest.mark.cuda
def test_cuda_residual_unit_at_the_judge_encoder_shape(cuda):
    """The judge's codec encoder at k=8: its first block's units (C=64) on 8
    candidate streams at once, bf16; T cut from 480,000 to 48,000."""
    x = torch.randn(8, 64, 48000, generator=torch.Generator(device=cuda).manual_seed(5),
                    device=cuda).to(torch.bfloat16)
    for dilation in (1, 3, 9):
        p = _unit(cuda, 64, 40 + dilation)
        n = fused_residual_unit.launches
        out = fused_residual_unit(p, x, dilation, torch.bfloat16)
        assert fused_residual_unit.launches == n + 1
        ref = fused_residual_unit_plain(*residual_unit_operands(p, x, torch.bfloat16), dilation)
        torch.testing.assert_close(out.float(), ref.float(), rtol=5e-2, atol=5e-2)


def _cpu_window_noise(seed, item, window, shape, device):
    """The port's window noise drawn on the CPU, so that a model on the card
    and one on the CPU get the same bits."""
    import numpy as np

    state = np.random.SeedSequence([seed, item, window]).generate_state(1, np.uint64)
    g = torch.Generator().manual_seed(int(state[0]))
    return torch.randn(shape, generator=g, dtype=torch.float32).to(device)


@pytest.mark.cuda
def test_cuda_small_model_streams_like_the_cpu(cuda, monkeypatch):
    """A small fp32 model (DiT head_dim 128: the fused attention kernel)
    streams a clip through 3 windows on the card (kernels 1 and 3) and on
    the CPU (their plain versions) with the same window noise."""
    import numpy as np

    from sam_audio_tpu_torch import SAMAudio, SAMAudioProcessor, streaming
    from sam_audio_tpu_torch.config import (
        DACVAEConfig, SAMAudioConfig, T5EncoderConfig, TransformerConfig)
    from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer
    from sam_audio_tpu_torch.utils import tree_map

    cfg = SAMAudioConfig(
        in_channels=96,
        audio_codec=DACVAEConfig(encoder_dim=32, encoder_rates=(2, 4), latent_dim=64,
                                 decoder_dim=128, decoder_rates=(4, 2), codebook_dim=16,
                                 sample_rate=8000),
        text_encoder=T5EncoderConfig(dim=64, num_layers=2, num_heads=4, head_dim=16, d_ff=128,
                                     vocab_size=512),
        transformer=TransformerConfig(dim=256, n_heads=2, n_layers=2, dropout=0.0,
                                      context_dim=256, max_positions=2048,
                                      frequency_embedding_dim=64, out_channels=32),
        span_predictor=None, compute_dtype="float32")
    tok = ByteFallbackTokenizer(512)
    gpu = SAMAudio.init_random(cfg, seed=0, device=cuda, tokenizer=tok)
    cpu = SAMAudio(cfg, tree_map(lambda x: x.cpu(), gpu.params), device="cpu", tokenizer=tok,
                   allow_random_towers=True)
    monkeypatch.setattr(streaming, "_window_noise", _cpu_window_noise)
    rng = np.random.RandomState(0)
    wav = (0.3 * np.sin(np.arange(3200) * 0.05) + 0.05 * rng.randn(3200)).astype(np.float32)
    batch = SAMAudioProcessor(8, 8000)(descriptions=["a tone"], audios=[wav[None]],
                                       anchors=[[("+", 0.1, 0.3)]])
    out = {}
    for name, model in (("gpu", gpu), ("cpu", cpu)):
        torch.manual_seed(3)
        n1, n3 = fused_glue_attention.launches, fused_residual_unit.launches
        out[name] = model.separate(batch, max_direct_seconds=0.2)   # 1600-sample windows
        if name == "gpu":
            assert fused_glue_attention.launches - n1 == 3 * 2 * 32
            assert fused_residual_unit.launches - n3 == 3 * 18
    for a, b in ((out["gpu"].target[0], out["cpu"].target[0]),
                 (out["gpu"].residual[0], out["cpu"].residual[0])):
        assert a.shape == b.shape == (3200,) and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-3)


@pytest.mark.cuda
def test_cuda_small_visual_separate_like_the_cpu(cuda):
    """A small fp32 model with a narrow PE tower and a masked video (k=1) on
    the card (kernels 1 and 3, the tower's cuBLAS products) and on the CPU
    with the same weights and noise."""
    import numpy as np

    from sam_audio_tpu_torch import SAMAudio, SAMAudioProcessor
    from sam_audio_tpu_torch.config import (
        DACVAEConfig, PerceptionEncoderConfig, SAMAudioConfig, T5EncoderConfig,
        TransformerConfig)
    from sam_audio_tpu_torch.models.pe_clip import PerceptionEncoder
    from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer
    from sam_audio_tpu_torch.utils import tree_map

    pe_cfg = PerceptionEncoderConfig(dim=64, width=64, vit_layers=2, vit_heads=2, image_size=56)
    cfg = SAMAudioConfig(
        in_channels=96,
        audio_codec=DACVAEConfig(encoder_dim=32, encoder_rates=(2, 4), latent_dim=64,
                                 decoder_dim=128, decoder_rates=(4, 2), codebook_dim=16,
                                 sample_rate=8000),
        text_encoder=T5EncoderConfig(dim=64, num_layers=2, num_heads=4, head_dim=16, d_ff=128,
                                     vocab_size=512),
        vision_encoder=pe_cfg,
        transformer=TransformerConfig(dim=256, n_heads=2, n_layers=2, dropout=0.0,
                                      context_dim=256, max_positions=2048,
                                      frequency_embedding_dim=64, out_channels=32),
        span_predictor=None, compute_dtype="float32")
    tok = ByteFallbackTokenizer(512)
    gpu = SAMAudio.init_random(cfg, seed=0, device=cuda, tokenizer=tok)
    gpu.params["align_masked_video"]["gate"].fill_(0.5)   # 0 at init: the video would be inert
    gpu.vision_encoder = PerceptionEncoder.init_random(pe_cfg, seed=1, device=cuda,
                                                       compute_dtype=torch.float32)
    cpu = SAMAudio(cfg, tree_map(lambda x: x.cpu(), gpu.params), device="cpu", tokenizer=tok,
                   vision_encoder=PerceptionEncoder(
                       pe_cfg, tree_map(lambda x: x.cpu(), gpu.vision_encoder.params),
                       device="cpu", compute_dtype=torch.float32))
    rng = np.random.RandomState(0)
    wav = (0.3 * np.sin(np.arange(1600) * 0.05) + 0.05 * rng.randn(1600)).astype(np.float32)
    proc = SAMAudioProcessor(8, 8000)
    video = rng.randint(0, 256, (37, 3, 90, 160)).astype(np.uint8)
    mask = (rng.rand(*video.shape) > 0.5).astype(np.uint8)
    batch = proc(descriptions=["a tone"], audios=[wav[None]],
                 masked_videos=proc.mask_videos([video], [mask]))
    noise = rng.randn(1, 200, 32).astype(np.float32)
    n1, n3 = fused_glue_attention.launches, fused_residual_unit.launches
    a = gpu.separate(batch, noise=noise)
    assert fused_glue_attention.launches - n1 == 2 * 32
    assert fused_residual_unit.launches - n3 == 18
    b = cpu.separate(batch, noise=noise)
    for x, y in ((a.target[0], b.target[0]), (a.residual[0], b.residual[0])):
        assert x.shape == y.shape == (1600,) and np.isfinite(x).all()
        np.testing.assert_allclose(x, y, rtol=0, atol=2e-3)


def _small_cfg(compute_dtype="float32"):
    """A small model whose DiT heads are 128 wide (kernel 1), 2 layers,
    8 kHz codec of hop 8."""
    from sam_audio_tpu_torch.config import (
        DACVAEConfig, SAMAudioConfig, T5EncoderConfig, TransformerConfig)

    return SAMAudioConfig(
        in_channels=96,
        audio_codec=DACVAEConfig(encoder_dim=32, encoder_rates=(2, 4), latent_dim=64,
                                 decoder_dim=128, decoder_rates=(4, 2), codebook_dim=16,
                                 sample_rate=8000),
        text_encoder=T5EncoderConfig(dim=64, num_layers=2, num_heads=4, head_dim=16, d_ff=128,
                                     vocab_size=512),
        transformer=TransformerConfig(dim=256, n_heads=2, n_layers=2, dropout=0.0,
                                      context_dim=256, max_positions=2048,
                                      frequency_embedding_dim=64, out_channels=32),
        span_predictor=None, compute_dtype=compute_dtype)


def _small_span_model(dev):
    """A small fp32 model with a narrow native span predictor on `dev`, and
    its copy on the CPU (the same weights)."""
    from sam_audio_tpu_torch import SAMAudio
    from sam_audio_tpu_torch.models.span_predictor import SpanPredictor, SpanPredictorConfig
    from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer
    from sam_audio_tpu_torch.utils import tree_map

    cfg = _small_cfg()
    tok = ByteFallbackTokenizer(512)
    gpu = SAMAudio.init_random(cfg, seed=0, device=dev, tokenizer=tok)
    sp_cfg = SpanPredictorConfig(audio_dim=16, text_dim=64, hidden=64, n_layers=2, n_heads=4,
                                 min_duration_s=0.005)
    gpu.span_predictor = SpanPredictor.init_random(sp_cfg, seed=1, device=dev)
    gpu.params["embed_anchors"]["gate"].fill_(0.5)   # 0 at init: the spans would be inert
    cpu = SAMAudio(cfg, tree_map(lambda x: x.cpu(), gpu.params), device="cpu", tokenizer=tok,
                   span_predictor=SpanPredictor(
                       sp_cfg, tree_map(lambda x: x.cpu(), gpu.span_predictor.params)))
    return gpu, cpu


@pytest.mark.cuda
def test_cuda_span_predictor_like_the_cpu(cuda):
    """The native span predictor's logits on the card (its codec encode
    through kernel 3) against the CPU, then separate(predict_spans=True) on
    both with the same noise: the same spans (no frame within 1e-3 of the
    threshold), targets within 2e-3."""
    import numpy as np

    from sam_audio_tpu_torch import SAMAudioProcessor
    from sam_audio_tpu_torch.models.init import center_span_head

    gpu, cpu = _small_span_model(cuda)
    rng = np.random.RandomState(0)
    wavs = [(0.3 * np.sin(np.arange(1600) * 0.05) + 0.05 * rng.randn(1600)).astype(np.float32),
            (0.2 * rng.randn(1200)).astype(np.float32)]
    proc = SAMAudioProcessor(8, 8000)
    batches = [proc(descriptions=["a tone", "noise"], audios=wavs) for _ in range(2)]
    audios = torch.as_tensor(batches[0].audios)
    mask = np.asarray(batches[0].audio_pad_mask)
    # a random head's logits lie close together: scale it by 20 and centre its bias
    center_span_head([gpu.span_predictor, cpu.span_predictor],
                     cpu.span_predictor.logits(cpu, batches[0], audios).numpy(), mask, scale=20.0)
    n3 = fused_residual_unit.launches
    lg = gpu.span_predictor.logits(gpu, batches[0], audios.to(cuda))
    assert fused_residual_unit.launches - n3 == 6   # one encode: 2 blocks x 3 units
    ref = cpu.span_predictor.logits(cpu, batches[0], audios)
    torch.testing.assert_close(lg.cpu(), ref, rtol=0, atol=2e-3)
    assert float((torch.sigmoid(ref) - 0.5).abs()[torch.as_tensor(mask)].min()) >= 1e-3
    noise = rng.randn(2, 200, 32).astype(np.float32)
    a = gpu.separate(batches[0], noise=noise, predict_spans=True)
    b = cpu.separate(batches[1], noise=noise, predict_spans=True)
    assert batches[0].anchors == batches[1].anchors and any(batches[0].anchors)
    for x, y in ((a.target[0], b.target[0]), (a.residual[1], b.residual[1])):
        assert np.isfinite(x).all()
        np.testing.assert_allclose(x, y, rtol=0, atol=2e-3)


@pytest.mark.cuda
def test_cuda_batcher_serves_a_request(cuda):
    """One request through a ContinuousBatcher of a small model on the card:
    the kernels run on its device thread, and the reply has the clip's
    length."""
    import numpy as np

    from sam_audio_tpu_torch.server import ContinuousBatcher
    from sam_audio_tpu_torch.serving import SeparationRequest

    gpu, _ = _small_span_model(cuda)
    batcher = ContinuousBatcher(gpu, max_batch=2, bucket_seconds=0.1, max_wait_ms=0.0)
    try:
        n1 = fused_glue_attention.launches
        out = batcher.separate(SeparationRequest(
            description="a tone", audio=(0.1 * np.sin(np.arange(1000) * 0.05)).astype(
                np.float32)), timeout=300)
    finally:
        batcher.shutdown(timeout=60)
    assert fused_glue_attention.launches - n1 == 2 * 32
    assert out.target.shape == (1000,) and np.isfinite(out.target).all()
    assert out.metadata == {"bucket": 1600, "batch_size": 1, "dispatch_size": 1}
    assert batcher.stats_snapshot()["requests"] == 1


@pytest.mark.cuda
def test_cuda_eval_run_like_the_cpu(cuda, monkeypatch, tmp_path):
    """run_eval of a small model on the card and on the CPU, with the same
    injected noise and metric towers (2 items of 0.2 s: 200 frames, kernel
    1; kernel 3 in the codec and the judge's encoder), scored once by the
    Judge, the AesPredictor stand-in and CLAP, and once by an
    AudioboxAesthetics (the WavLM tower): the averaged metrics agree within
    2e-3."""
    from sam_audio_tpu_torch import SAMAudioProcessor
    from sam_audio_tpu_torch.eval import main as eval_main
    from sam_audio_tpu_torch.eval.datasets import SyntheticBench
    from sam_audio_tpu_torch.eval.settings import SETTINGS
    from sam_audio_tpu_torch.models.init import inject_noise, small_eval_metrics

    gpu, cpu = _small_span_model(cuda)
    gpu.span_predictor = cpu.span_predictor = None
    codec = gpu.cfg.audio_codec
    monkeypatch.setitem(SETTINGS, "synthetic-card", (SyntheticBench,
                                                     {"seconds": 0.2, "num_items": 2}))
    runs = (("judge", "aesthetic-predictor", "clap"), ("aesthetic-audiobox",))
    res = {}
    for dev, model in ((cuda, gpu), ("cpu", cpu)):
        inject_noise(model, 2 * codec.codebook_dim)
        metrics = small_eval_metrics(codec, dev)
        for names in runs:
            n1, n3 = fused_glue_attention.launches, fused_residual_unit.launches
            res[str(dev), names] = eval_main.run_eval(
                ["synthetic-card"], cache_path=str(tmp_path), batch_size=2, checkpoint_path="",
                reranking_candidates=1, model=model,
                processor=SAMAudioProcessor(codec.hop_length, codec.sample_rate),
                metrics=[metrics[n] for n in names], output_dir=str(tmp_path / str(dev)),
                device=dev)["synthetic-card"]
            if dev is cuda and names == runs[0]:
                assert fused_glue_attention.launches - n1 == 2 * 32
                assert fused_residual_unit.launches - n3 == 6 + 2 * 6 + 6
    for names, n_keys in zip(runs, (9, 4)):
        card, host = res[str(cuda), names], res["cpu", names]
        assert card.keys() == host.keys() and len(host) == n_keys
        for k, v in host.items():
            assert abs(card[k] - v) <= 2e-3 + 2e-3 * abs(v), (k, card[k], v)


def _graph_model(dev, compute_dtype="float32"):
    """The small model on `dev`, a two-row batch with anchors (200 frames:
    kernel 1) and its noise."""
    import numpy as np

    from sam_audio_tpu_torch import SAMAudio, SAMAudioProcessor
    from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer

    model = SAMAudio.init_random(_small_cfg(compute_dtype), seed=0, device=dev,
                                 tokenizer=ByteFallbackTokenizer(512))
    model.params["embed_anchors"]["gate"].fill_(0.5)   # 0 at init: the anchors would be inert
    rng = np.random.RandomState(0)
    wavs = [(0.3 * np.sin(np.arange(1600) * 0.05) + 0.05 * rng.randn(1600)).astype(np.float32),
            (0.2 * rng.randn(1200)).astype(np.float32)]
    batch = SAMAudioProcessor(8, 8000)(descriptions=["a tone", "noise"], audios=wavs,
                                       anchors=[[("+", 0.02, 0.1)], [("-", 0.0, 0.05)]])
    return model, batch, rng.randn(2, 200, 32).astype(np.float32)


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm())


def _captured_field(model, batch, noise, monkeypatch):
    """(evaluate, y, inputs) as separate() hands them to the graph cache."""
    from sam_audio_tpu_torch.models.dit_graph import DiTGraphs

    seen = {}
    real = DiTGraphs.field

    def spy(self, evaluate, y, inputs):
        seen.update(evaluate=evaluate, y=y, inputs=inputs)
        return real(self, evaluate, y, inputs)

    with monkeypatch.context() as m:
        m.setattr(DiTGraphs, "field", spy)
        model.separate(batch, noise=noise)
    return seen["evaluate"], seen["y"], seen["inputs"]


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cuda_dit_graph_replays_the_eager_evaluation(cuda, monkeypatch, compute_dtype):
    """One velocity-field evaluation as separate() hands it to the graph
    cache: the first call (the eager warm-up, then the capture) and replays
    at two (t, y) agree with the eager evaluation on the same inputs (the
    same kernels: bit-identical expected, at most 1e-6 relative), and a
    replay counts kernel 1's launches (2 layers) as the eager one does."""
    from sam_audio_tpu_torch.models.dit_graph import DiTGraphs

    model, batch, noise = _graph_model(cuda, compute_dtype)
    evaluate, y, inputs = _captured_field(model, batch, noise, monkeypatch)
    assert {k for k, x in inputs.items() if x is not None} >= {
        "audio_features", "text_features", "text_mask", "video_features", "anchor_ids",
        "anchor_alignment", "audio_pad_mask", "rope_cos", "rope_sin"}
    graphs = DiTGraphs()
    with torch.inference_mode():
        func = graphs.field(evaluate, y, inputs)
        t = torch.tensor(0.375, device=cuda)
        first = func(t, y)
        for tt, yy in ((t, y), (torch.tensor(0.8125, device=cuda), 0.5 * y + 0.1)):
            n = fused_glue_attention.launches
            got = func(tt, yy)
            assert fused_glue_attention.launches - n == 2
            want = evaluate(tt, yy, **inputs)
            print(f"{compute_dtype} replay at t={float(tt)}: bit-identical "
                  f"{torch.equal(got, want)}, relative difference {_rel(got, want):.3e}")
            assert _rel(got, want) <= 1e-6
        assert _rel(first, evaluate(t, y, **inputs)) <= 1e-6
    assert graphs.captures == 1 and graphs.replays == 2 and len(graphs) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("samples,counter", [(1600, fused_glue_attention),
                                             (8192, flash_attention)])
def test_cuda_dit_graph_replay_kernels_on_the_profiler_trace(cuda, monkeypatch, samples, counter):
    """A replay of a graph captured before the profiler starts shows its
    attention kernels on the device trace: kernel 1 at 200 frames, kernel 2
    at 1,024. One replay executes as many of them there as its launch
    counter adds (one a layer), and a replay's device trace holds what the
    eager evaluation's does."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from sam_audio_tpu_torch import SAMAudioProcessor
    from sam_audio_tpu_torch.models.dit_graph import DiTGraphs

    model, _, _ = _graph_model(cuda)
    rng = np.random.RandomState(1)
    batch = SAMAudioProcessor(8, 8000)(descriptions=["noise"],
                                       audios=[(0.2 * rng.randn(samples)).astype(np.float32)])
    noise = rng.randn(1, samples // 8, 32).astype(np.float32)
    evaluate, y, inputs = _captured_field(model, batch, noise, monkeypatch)
    name = counter.__name__
    t = torch.tensor(0.5, device=cuda)

    def traced(fn):
        n = counter.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        return counter.launches - n, sum(name in k for k in kernels)

    graphs = DiTGraphs()
    with torch.inference_mode():
        func = graphs.field(evaluate, y, inputs)
        func(t, y)                       # the warm-up and the capture
        counted, on_trace = traced(lambda: func(t, y))
        eager = traced(lambda: evaluate(t, y, **inputs))
    print(f"{name}: one replay counted {counted}, on the trace {on_trace}; eager {eager}")
    assert graphs.replays == 1 and counted == on_trace == 2
    assert eager == (2, 2)


@pytest.mark.cuda
def test_cuda_separate_with_graphs_equals_the_eager_ode(cuda, monkeypatch):
    """A separate through the graph cache equals the eager ODE's (at most
    1e-6 relative); a second call of the shape, and an rk4 solve, capture
    nothing; kernel 1 counts 2 layers x 32 evaluations a separate either way;
    (2 x 16 for rk4 at step 0.25); quantize() clears the cache and the
    next separate captures again."""
    from sam_audio_tpu_torch.models.dit_graph import DiTGraphs

    model, batch, noise = _graph_model(cuda)
    graphs = model.dit_graphs
    runs = []
    for ode_opt, evals in ((None, 32), (None, 32), ({"method": "rk4", "step_size": 0.25}, 16)):
        n = fused_glue_attention.launches
        runs.append(model.separate(batch, noise=noise, ode_opt=ode_opt))
        assert fused_glue_attention.launches - n == 2 * evals
        assert graphs.captures == 1 and len(graphs) == 1
    assert graphs.replays == 31 + 32 + 16
    with monkeypatch.context() as m:
        m.setattr(DiTGraphs, "engages", staticmethod(lambda y, sharded: False))
        n = fused_glue_attention.launches
        eager = model.separate(batch, noise=noise)
        assert fused_glue_attention.launches - n == 2 * 32 and graphs.replays == 79
    for res in runs[:2]:
        for i in range(2):
            assert _rel(res.target[i], eager.target[i]) <= 1e-6
            assert _rel(res.residual[i], eager.residual[i]) <= 1e-6
    model.quantize(8)
    assert len(graphs) == 0
    n = fused_glue_attention.launches
    model.separate(batch, noise=noise)
    assert fused_glue_attention.launches - n == 2 * 32 and graphs.captures == 2


@pytest.mark.cuda
def test_cuda_dit_graphs_are_bounded(cuda, monkeypatch):
    """The cache holds at most `MAX_GRAPHS` graphs, least recently used out:
    three lengths through a cache of two capture three times, and the first
    length, evicted, captures again."""
    from sam_audio_tpu_torch import SAMAudioProcessor
    from sam_audio_tpu_torch.models import dit_graph

    monkeypatch.setattr(dit_graph, "MAX_GRAPHS", 2)
    model, _, _ = _graph_model(cuda)
    graphs = model.dit_graphs
    proc = SAMAudioProcessor(8, 8000)
    for n, samples in enumerate((800, 1200, 1600, 800), start=1):
        batch = proc(descriptions=["a tone"], audios=[0.1 * torch.ones(samples).numpy()])
        model.separate(batch, generator=torch.Generator(device=cuda).manual_seed(n))
        assert graphs.captures == n and len(graphs) == min(n, 2)


@pytest.mark.cuda
def test_cuda_dit_graphs_serve_threads(cuda, monkeypatch):
    """Eight threads solve through one graph cache at once, each with its
    own conditioning and state (a short switch interval interleaves them;
    they race for the capture too): the buffers are filled per evaluation
    under the cache's lock, so every velocity is the eager evaluation's of
    that thread's inputs, and one capture serves them all."""
    import sys
    import threading

    from sam_audio_tpu_torch.models.dit_graph import DiTGraphs

    model, batch, noise = _graph_model(cuda)
    evaluate, y, inputs = _captured_field(model, batch, noise, monkeypatch)
    scales = (1.0, 0.5, -1.0, 2.0)
    own = [(dict(inputs, audio_features=inputs["audio_features"] * s), y * s) for s in scales]
    ts = [torch.tensor(v, device=cuda) for v in (0.0, 0.25, 0.5, 0.75)]
    with torch.inference_mode():
        want = [[evaluate(t, yy, **inp) for t in ts] for inp, yy in own]
    graphs = DiTGraphs()
    results, errors = {}, []

    def work(i):
        try:
            inp, yy = own[i % 4]
            func = graphs.field(evaluate, yy, inp)
            results[i] = [func(t, yy) for t in ts]
        except Exception as e:   # reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(th.is_alive() for th in threads) and len(results) == 8
    for i, outs in results.items():
        for got, ref in zip(outs, want[i % 4]):
            assert _rel(got, ref) <= 1e-6
    assert graphs.captures == 1 and graphs.replays == 8 * 4 - 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_cuda_fused_attention_gradient_equals_plain(cuda, dtype, tol):
    """Kernel 1 under autograd: one launch through FusedGlueAttentionFn, and
    the gradients of q, k, v and both norm weights are the plain version's
    (its VJP reruns the plain version on the saved inputs)."""
    q, k, v, qw, kw, cos, sin, mask = _glue_inputs(cuda, 3, 250, dtype)
    inputs = [x.requires_grad_(True) for x in (q, k, v, qw, kw)]
    w = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    n = fused_glue_attention.launches
    out = fused_glue_attention(*inputs, cos, sin, mask)
    assert fused_glue_attention.launches == n + 1 and out.grad_fn is not None
    got = torch.autograd.grad((out.float() * w).sum(), inputs)
    ref = torch.autograd.grad(
        (fused_glue_attention_plain(*inputs, cos, sin, mask).float() * w).sum(), inputs)
    for a, b in zip(got, ref):
        assert a.abs().max() > 0
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_cuda_flash_attention_gradient_equals_plain(cuda, dtype, tol):
    q, k, v, mask = _qkv(cuda, 1100, dtype, 6)
    inputs = [x.requires_grad_(True) for x in (q, k, v)]
    w = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(2),
                    device=cuda)
    n = flash_attention.launches
    out = flash_attention(*inputs, mask)
    assert flash_attention.launches == n + 1 and out.grad_fn is not None
    got = torch.autograd.grad((out.float() * w).sum(), inputs)
    ref = torch.autograd.grad((flash_attention_plain(*inputs, mask).float() * w).sum(), inputs)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_kernels_3_and_4_refuse_a_gradient(cuda):
    """Kernels without a gradient raise rather than cut the graph; under
    no_grad they launch as before."""
    p = _unit(cuda, 64, 3)
    x = torch.randn(1, 64, 400, device=cuda, requires_grad=True)
    n = fused_residual_unit.launches
    with pytest.raises(RuntimeError, match="no gradient"):
        fused_residual_unit(p, x, 3, torch.float32)
    p["conv1"]["weight"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no gradient"):
        fused_residual_unit(p, x.detach(), 3, torch.float32)
    with torch.no_grad():
        fused_residual_unit(p, x, 3, torch.float32)
    assert fused_residual_unit.launches == n + 1
    q = quantize_linear_int4({"weight": torch.randn(256, 256, device=cuda)})
    xi = torch.randn(4, 256, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        matmul_int4(xi, q["w4"], q["w4_scale"])
    with torch.no_grad():
        matmul_int4(xi, q["w4"], q["w4_scale"])


@pytest.mark.cuda
def test_cuda_small_trainer_like_the_cpu(cuda):
    """Two Trainer steps of a small fp32 model (head_dim 128: kernel 1, and
    its gradient through FusedGlueAttentionFn) on the card and on the CPU
    with the same t and x0: every trainable leaf's gradient within 1e-4 of
    its largest CPU value, loss and updated parameters within 2e-3 (no
    warmup, so both steps move them), and every layer's wq gets a gradient
    on the card."""
    import numpy as np

    from sam_audio_tpu_torch.config import tiny_test_config
    from sam_audio_tpu_torch.models.init import sam_audio_init
    from sam_audio_tpu_torch.train.flow_matching import Trainer, flow_matching_loss, synthetic_batch
    from sam_audio_tpu_torch.utils import tree_leaves_with_path, tree_map

    base = tiny_test_config()
    cfg = tiny_test_config(transformer=type(base.transformer)(
        dim=256, n_heads=2, n_layers=2, dropout=0.0, context_dim=256, max_positions=512,
        frequency_embedding_dim=8, out_channels=8))
    params = sam_audio_init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = synthetic_batch(cfg, torch.Generator().manual_seed(1), t_frames=200)
    rng = np.random.RandomState(2)
    draws = [(torch.from_numpy(rng.rand(2).astype(np.float32)),
              torch.from_numpy(rng.randn(2, 200, 8).astype(np.float32))) for _ in range(2)]
    kw = dict(learning_rate=1e-3, lr_schedule="cosine", warmup_steps=0, total_steps=3,
              ema_decay=0.9)
    card = Trainer(cfg, tree_map(lambda x: x.to(cuda), params), device=cuda, **kw)
    host = Trainer(cfg, tree_map(lambda x: x.clone(), params), device="cpu", **kw)
    names = [p for p, x in tree_leaves_with_path(card.state.params) if x.requires_grad]
    grads = []
    for trainer, dev in ((card, cuda), (host, "cpu")):
        loss = flow_matching_loss(trainer.state.params, cfg, tree_map(lambda x: x.to(dev), batch),
                                  t=draws[0][0].to(dev), x0=draws[0][1].to(dev))
        grads.append(dict(zip(names, torch.autograd.grad(loss, trainer.state.trainable,
                                                         allow_unused=True))))
    for name in names:
        gc, gh = grads[0][name], grads[1][name]
        assert (gc is None) == (gh is None), name
        if gh is not None:
            assert float((gc.cpu() - gh).abs().max()) <= 1e-4 * float(gh.abs().max()), name
    g = grads[0]["transformer/layers/attention/wq/weight"]
    assert all(g[i].abs().max() > 0 for i in range(cfg.transformer.n_layers))
    n = fused_glue_attention.launches
    for t, x0 in draws:
        a = card.step(tree_map(lambda x: x.to(cuda), batch), t=t.to(cuda), x0=x0.to(cuda))
        b = host.step(batch, t=t, x0=x0)
        assert abs(float(a["loss"]) - float(b["loss"])) <= 2e-3
    assert fused_glue_attention.launches == n + 2 * 2 * 2   # 2 layers, recomputed, 2 steps
    ref = dict(tree_leaves_with_path(host.state.params))
    for path, x in tree_leaves_with_path(card.state.params):
        torch.testing.assert_close(x.detach().cpu(), ref[path].detach(), rtol=2e-3, atol=2e-3,
                                   msg=path)


def _dp2_rank(rank, port, out_dir):
    """One of two ranks on the card(s): dp2 separate of a small fp32 model
    (kernel 1's shape: two 128-wide heads) and the unsharded one."""
    import numpy as np

    import torch.distributed as dist

    from sam_audio_tpu_torch import SAMAudio, SAMAudioProcessor
    from sam_audio_tpu_torch.config import (
        DACVAEConfig, SAMAudioConfig, T5EncoderConfig, TransformerConfig)
    from sam_audio_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer

    device = init_distributed("cuda", f"127.0.0.1:{port}", 2, rank)
    torch.backends.cuda.matmul.allow_tf32 = False   # as the `cuda` fixture sets
    torch.backends.cudnn.allow_tf32 = False
    try:
        # test_cuda_small_model_streams_like_the_cpu's model: kernel 3's widths
        cfg = SAMAudioConfig(
            in_channels=96,
            audio_codec=DACVAEConfig(encoder_dim=32, encoder_rates=(2, 4), latent_dim=64,
                                     decoder_dim=128, decoder_rates=(4, 2), codebook_dim=16,
                                     sample_rate=8000),
            text_encoder=T5EncoderConfig(dim=64, num_layers=2, num_heads=4, head_dim=16,
                                         d_ff=128, vocab_size=512),
            transformer=TransformerConfig(dim=256, n_heads=2, n_layers=2, dropout=0.0,
                                          context_dim=256, max_positions=2048,
                                          frequency_embedding_dim=64, out_channels=32),
            span_predictor=None, compute_dtype="float32")
        tok = ByteFallbackTokenizer(cfg.text_encoder.vocab_size)
        proc = SAMAudioProcessor(8, 8000)
        rng = np.random.RandomState(0)
        batch = proc(descriptions=["a dog", "rain"],
                     audios=[rng.randn(1, 1600).astype(np.float32) * 0.2,
                             rng.randn(1, 1200).astype(np.float32) * 0.2])
        noise = rng.randn(2, batch.anchor_alignment.shape[-1], 32).astype(np.float32)
        ref = SAMAudio.init_random(cfg, seed=0, device=device, tokenizer=tok).separate(
            batch, noise=noise)
        model = SAMAudio.init_random(cfg, seed=0, device=device, tokenizer=tok)
        model.shard(make_mesh(dp=2, tp=1))
        n = fused_glue_attention.launches
        got = model.separate(batch, noise=noise)
        np.savez(f"{out_dir}/rank{rank}.npz", launches=fused_glue_attention.launches - n,
                 backend=dist.get_backend(), **{f"got{i}": x for i, x in enumerate(got.target)},
                 **{f"ref{i}": x for i, x in enumerate(ref.target)})
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_dp2_separate_equals_the_unsharded_one(cuda, tmp_path):
    """Two ranks on the card (NCCL with two cards, else gloo sharing one,
    parallel/mesh.init_distributed's rule): a dp2 separate of a small fp32
    model, one row a rank, within 1e-4 of the unsharded separate on each
    rank, and kernel 1 launched on both (2 layers x 32 evaluations)."""
    import socket

    import numpy as np
    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mp.spawn(_dp2_rank, args=(port, str(tmp_path)), nprocs=2, join=True)
    for rank in range(2):
        z = np.load(tmp_path / f"rank{rank}.npz")
        assert int(z["launches"]) == 2 * 32
        for i in range(2):
            np.testing.assert_allclose(z[f"got{i}"], z[f"ref{i}"], rtol=1e-4, atol=1e-4)


def test_cuda_trainer_is_refused_without_a_gpu(monkeypatch):
    """With no GPU, a trainer asked for the card raises (no silent CPU
    path). Runs anywhere: the missing GPU is simulated."""
    from sam_audio_tpu_torch.config import tiny_test_config
    from sam_audio_tpu_torch.models.init import sam_audio_init
    from sam_audio_tpu_torch.train.flow_matching import Trainer
    from sam_audio_tpu_torch.train.span import SpanTrainer
    from sam_audio_tpu_torch.models.span_predictor import SpanPredictorConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_test_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, sam_audio_init(cfg, torch.Generator().manual_seed(0), "cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpanTrainer(SpanPredictorConfig(audio_dim=4, text_dim=16, hidden=32, n_layers=1))


def test_cuda_is_refused_without_a_gpu(monkeypatch):
    """With no GPU, asking for the card raises for the PE tower and the
    ImageBind ranker alike (no silent CPU path). Runs anywhere: the missing
    GPU is simulated."""
    from sam_audio_tpu_torch.config import ImageBindRankerConfig, PerceptionEncoderConfig
    from sam_audio_tpu_torch.models.pe_clip import PerceptionEncoder
    from sam_audio_tpu_torch.ranking import create_ranker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PerceptionEncoderConfig(dim=8, width=16, vit_layers=1, vit_heads=2, image_size=28)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PerceptionEncoder.init_random(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PerceptionEncoder(cfg, {}, device="cuda")
    ranker = create_ranker(ImageBindRankerConfig(), allow_random=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ranker.model
