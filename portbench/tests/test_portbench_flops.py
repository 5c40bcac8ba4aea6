"""The operation counters against a hand count and against torch's own
FlopCounterMode over the program's functions at a tiny configuration."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import flops, weights
from portbench.harness.rankers import clap as clap_ranker
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


# -- the k-candidate path and the CLAP ranker -----------------------------------------

CLAP = json.loads((DATA / "tiny_clap.json").read_text())["clap"]


@pytest.fixture(scope="module")
def clap():
    cfg = {"clap": CLAP}
    return clap_ranker.config(cfg), clap_ranker.weights(cfg, 3, torch.device("cpu"))


def test_clap_audio_against_flop_counter(clap):
    from sam_audio_tpu_torch.models.clap import clap_audio_embed

    c, p = clap
    wav = torch.randn(3, c.n_samples)
    assert counted(lambda: clap_audio_embed(p, c, wav)) == 3 * clap_ranker.audio_flops(CLAP)


def test_clap_text_against_flop_counter(clap):
    from sam_audio_tpu_torch.models.clap import clap_text_embed

    c, p = clap
    ids = torch.randint(3, 200, (2, 12))
    mask = torch.ones(2, 12, dtype=torch.bool)
    assert counted(lambda: clap_text_embed(p, c, ids, mask)) == 2 * clap_ranker.text_flops(CLAP, 12)


def test_candidates_scale_the_ode_and_the_target_decodes_by_hand():
    cfg = dict(CFG, text_ranker={"kind": "clap"}, clap=CLAP)
    one = flops.GroupShape(rows=2, samples=480, frames=60, text=64)
    ranked = flops.GroupShape(rows=2, samples=480, frames=60, text=64, candidates=8, rank_text=12)
    enc, t5 = flops.codec_encode_flops(cfg, 480), flops.t5_flops(cfg, 64)
    dit, dec = 32 * flops.dit_eval_flops(cfg, 60, 64), flops.codec_decode_flops(cfg, 60)
    assert flops.group_flops(cfg, one) == 2 * (enc + t5 + dit + 2 * dec)
    # encode and T5 once an item; 8 solutions and 8 target decodes an item;
    # the kept candidate's residual; 8 audio embeddings and one prompt an item
    assert flops.group_flops(cfg, ranked) == 2 * (enc + t5 + 8 * dit + 9 * dec) + 2 * (
        8 * clap_ranker.audio_flops(CLAP) + clap_ranker.text_flops(CLAP, 12))
    ops1, bytes1 = flops.self_attention_work(cfg, one)
    ops8, bytes8 = flops.self_attention_work(cfg, ranked)
    assert ops8 == 8 * ops1 and bytes8 > 7 * bytes1
    # 16 targets in one launch of 16 rows, the 2 residuals in one of 2
    assert flops.decode_launches(cfg, ranked) == {16: 1, 2: 1}
    assert flops.decode_launches(cfg, one) == {2: 2}
    big = flops.GroupShape(rows=4, samples=480, frames=60, text=64, candidates=8, rank_text=12)
    assert flops.decode_launches(cfg, big) == {16: 2, 4: 1}
    # k candidates with no ranker: candidate 0 is decoded, nothing is scored
    unranked = flops.GroupShape(rows=2, samples=480, frames=60, text=64, candidates=8)
    assert flops.group_flops(CFG, unranked) == 2 * (enc + t5 + 8 * dit + 2 * dec)
    assert flops.rank_flops(CFG, unranked) == 0


def _config(name):
    return json.loads((DATA.parent.parent / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("config, shape, counts", [
    ("sam-audio-1b", dict(rows=16, samples=480000, frames=250, text=64),
     (307238516293632, (4194304000000, 33622540288), 0.03718118024246412)),
    ("sam-audio-1b-visual", dict(rows=2, samples=480000, frames=250, text=64, video_frames=250),
     (230578306760704, (524288000000, 4260620288), 0.004647699685531896)),
    ("sam-audio-1b", dict(rows=4, samples=2208000, frames=1150, text=64),
     (361750536388608, (22187868160000, 38891941888), 0.042758348337938214)),
], ids=["offline-b16-10s", "video-b2-10s", "long-b4-45s"])
def test_k1_cells_count_as_before(config, shape, counts):
    """The three k = 1 cells' group shapes give exactly the numbers the
    counters gave before they learned of candidates."""
    cfg, g = _config(config), flops.GroupShape(**shape)
    assert (flops.group_flops(cfg, g), flops.self_attention_work(cfg, g),
            flops.residual_unit_bound_s(cfg, g)) == counts
