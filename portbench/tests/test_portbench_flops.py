"""The operation counters against a hand count and against torch's own
FlopCounterMode over the program's functions at a tiny configuration."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import flops, weights
from conftest import DATA

CFG = json.loads((DATA / "tiny.json").read_text())


def counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_dit_eval_by_hand():
    # per token and layer: 8 d^2 + 4 d^2 + 6 d f with d = 32, f = 128
    per_token = 8 * 32 * 32 + 4 * 32 * 32 + 6 * 32 * 128
    layer = 10 * per_token + 64 * 4 * 32 * 32 + 4 * 10 * 10 * 32 + 4 * 10 * 64 * 32
    rest = (10 * 2 * (24 + 12 + 8) * 32 + 10 * 2 * 2 * 3 * 32 * 32
            + 64 * 2 * (16 * 32 + 3 * 32 * 32) + 10 * 2 * 32 * 8 + 2 * (2 * 8 * 32 + 32 * 32 + 32 * 192))
    assert flops.dit_eval_flops(CFG, 10, 64) == 2 * layer + rest


def test_residual_units_by_hand():
    enc, dec = flops.residual_units(CFG, 480, 60)
    assert enc == [(4, 480)] * 3 + [(8, 240)] * 3          # rates (2, 4), dim 4
    assert dec == [(8, 240)] * 3 + [(4, 480)] * 3          # rates (4, 2), dim 16


@pytest.fixture(scope="module")
def program():
    from sam_audio_tpu_torch import SAMAudioConfig

    pcfg = SAMAudioConfig.from_dict(CFG)
    return pcfg, weights.sam_audio_weights(CFG, 3, torch.device("cpu"))


def test_dit_eval_against_flop_counter(program):
    from sam_audio_tpu_torch.models.sam_audio import forward

    pcfg, p = program
    b, t, text = 1, 20, 64
    lat = 2 * CFG["audio_codec"]["codebook_dim"]
    args = dict(noisy_audio=torch.randn(b, t, lat), audio_features=torch.randn(b, t, lat),
                text_features=torch.randn(b, text, 16), time=torch.zeros(b),
                masked_video_features=torch.randn(b, 12, t),
                text_mask=torch.ones(b, text, dtype=torch.bool),
                anchor_ids=torch.zeros(b, 2, dtype=torch.long),
                anchor_alignment=torch.zeros(b, t, dtype=torch.long),
                audio_pad_mask=torch.ones(b, t, dtype=torch.bool))
    assert counted(lambda: forward(p, pcfg, **args)) == flops.dit_eval_flops(CFG, t, text)


def test_t5_against_flop_counter(program):
    from sam_audio_tpu_torch.models.t5 import t5_encode

    pcfg, p = program
    ids = torch.randint(0, 200, (1, 64))
    got = counted(lambda: t5_encode(p["text_encoder"], ids, torch.ones(1, 64, dtype=torch.bool),
                                    pcfg.text_encoder))
    assert got == flops.t5_flops(CFG, 64)


def test_codec_against_flop_counter(program):
    from sam_audio_tpu_torch.models import dacvae

    pcfg, p = program
    wav = torch.randn(1, 1, 480)
    assert counted(lambda: dacvae.encode(p["audio_codec"], wav, pcfg.audio_codec)) == \
        flops.codec_encode_flops(CFG, 480)
    z = torch.randn(1, 4, 60)
    assert counted(lambda: dacvae.decode(p["audio_codec"], z, pcfg.audio_codec)) == \
        flops.codec_decode_flops(CFG, 60)


def test_pe_frame_against_flop_counter():
    from sam_audio_tpu_torch.config import PerceptionEncoderConfig
    from sam_audio_tpu_torch.models.pe_clip import encode_images

    ve = PerceptionEncoderConfig(**CFG["vision_encoder"])
    pe = weights.pe_weights(CFG, 3, torch.device("cpu"))
    x = torch.randn(3, 3, ve.image_size, ve.image_size)
    assert counted(lambda: encode_images(pe, x, ve)) == 3 * flops.pe_frame_flops(CFG)


def test_kernel_bounds_follow_chip_smoke():
    g = flops.GroupShape(rows=1, samples=480000, frames=250, text=64)
    cfg = json.loads((DATA.parent.parent / "configs" / "sam-audio-1b.json").read_text())
    ops, nbytes = flops.self_attention_work(cfg, g)
    # chip_smoke.py :417-418 for one launch at (1, 250, 16, 128), 512 launches a group
    assert ops == 512 * 4 * 250 * 250 * 128 * 16
    assert nbytes == 512 * (4 * 250 * 16 * 128 * 2 + 2 * 128 * 4 + 2 * 250 * 128 // 2 * 4 + 250)
    # 36 residual-unit launches a separate (12 encoder, 2 x 12 decoder)
    enc, dec = flops.residual_units(cfg, 480000, 250)
    assert len(enc) + 2 * len(dec) == 36
    assert dec[0] == (768, 3000) and enc[-1] == (512, 3000)
