"""The port's own streaming contract, split from tests/test_torch_streaming.py
(whose helpers it shares) so that the two files balance across test
workers: separate()'s dispatch to the windows past the direct limit, the
explicit-noise override, the refusal of predicted spans there, and the
window noise (independent of batch_windows, reproducible from a seeded
generator). fp32, CPU, the tiny model of one `save_pretrained` snapshot."""

import logging

import numpy as np
import pytest
import torch

from sam_audio_tpu_torch import streaming
from test_torch_streaming import WINDOW, _long_batch, _pair, _wav, one_thread  # noqa: F401


def test_separate_past_the_limit_streams(tmp_path):
    """separate() past max_direct_seconds equals separate_streaming, item by
    item, with the seed drawn from the same generator."""
    cfg, _, tm = _pair(tmp_path)
    tm.streaming_window_s = 0.012
    tm.streaming_batch_windows = 2
    batch = _long_batch()
    res = tm.separate(batch, generator=torch.Generator().manual_seed(9),
                      max_direct_seconds=0.012)
    assert res.noise is None
    seed = streaming.base_seed(torch.Generator().manual_seed(9))
    for i, anchors in enumerate(([("+", 0.004, 0.02)], None)):
        # the item's frame-rounded size, as a direct separate trims it
        n = int(batch.sizes[i]) * 8
        ref = streaming.separate_streaming(
            tm, batch.descriptions[i], batch.audios[i, 0, :n], window_s=0.012,
            anchors=anchors, seed=seed, item=i)
        assert res.target[i].shape == (n,)
        np.testing.assert_allclose(res.target[i], ref.target, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res.residual[i], ref.residual, rtol=1e-5, atol=1e-5)
    # the model attribute sets the limit when the argument is absent
    tm.max_direct_seconds = 0.012
    again = tm.separate(batch, generator=torch.Generator().manual_seed(9))
    np.testing.assert_array_equal(again.target[0], res.target[0])


def test_explicit_noise_stays_direct(tmp_path, caplog):
    cfg, _, tm = _pair(tmp_path)
    batch = _long_batch()
    noise = np.random.RandomState(4).randn(2, batch.anchor_alignment.shape[-1], 8
                                           ).astype(np.float32)
    with caplog.at_level(logging.WARNING):
        forced = tm.separate(batch, noise=noise, max_direct_seconds=0.012)
    assert "forces the direct path" in caplog.text
    direct = tm.separate(batch, noise=noise)
    assert forced.noise is not None
    np.testing.assert_array_equal(forced.target[0], direct.target[0])


def test_predict_spans_past_the_limit_raises(tmp_path):
    cfg, _, tm = _pair(tmp_path)
    with pytest.raises(ValueError, match="predict_spans"):
        tm.separate(_long_batch(), predict_spans=True, max_direct_seconds=0.012)
    # a masked video streams with its clip (tests/test_torch_visual.py holds it against JAX)
    res = streaming.separate_streaming(tm, "x", _wav(200), seed=0,
                                       masked_video=np.zeros((1, 3, 4, 4), np.uint8), **WINDOW)
    assert res.num_windows == 3 and res.target.shape == (200,) and np.isfinite(res.target).all()


def test_window_noise_independent_of_grouping_and_reproducible(tmp_path):
    cfg, _, tm = _pair(tmp_path)
    wav = _wav(560)   # 7 windows
    anchors = [("+", 0.01, 0.05)]
    runs = {bw: streaming.separate_streaming(tm, "a dog", wav, anchors=anchors,
                                             generator=torch.Generator().manual_seed(1),
                                             batch_windows=bw, **WINDOW)
            for bw in (1, 3)}
    np.testing.assert_allclose(runs[3].target, runs[1].target, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(runs[3].residual, runs[1].residual, rtol=1e-5, atol=1e-5)
    again = streaming.separate_streaming(tm, "a dog", wav, anchors=anchors,
                                         generator=torch.Generator().manual_seed(1),
                                         batch_windows=3, **WINDOW)
    np.testing.assert_array_equal(again.target, runs[3].target)
    # windows of one item draw other noise, and so do other items
    a = streaming._window_noise(1, 0, 0, (2, 3), "cpu")
    assert not torch.equal(a, streaming._window_noise(1, 0, 1, (2, 3), "cpu"))
    assert not torch.equal(a, streaming._window_noise(1, 1, 0, (2, 3), "cpu"))
    assert torch.equal(a, streaming._window_noise(1, 0, 0, (2, 3), "cpu"))
