"""The eval harness of the PyTorch port against the JAX package (fp32, CPU,
tiny widths, parameter trees bridged by checkpoint.params_from_numpy): each
metric on the same target wavs, their refusal of random weights, the
datasets (SyntheticBench bit for bit, SAMAudioBench's paths, masks and items
on files the test writes, no load_dataset), the settings,
gather_and_average_results single-process and with an injected collective,
iter_batches, run_eval's refusal of keyless metrics across ranks, and the
command line (tests/test_torch_eval_run.py runs the slice as a whole)."""

import dataclasses
import io
import json

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import sam_audio_tpu.eval.datasets as jdatasets
import sam_audio_tpu.video_io as jvideo_io
import sam_audio_tpu_torch.eval.datasets as tdatasets
import sam_audio_tpu_torch.video_io as tvideo_io
from test_torch_clap import JCFG as CLAP_JCFG
from test_torch_clap import TCFG as CLAP_TCFG
from test_torch_imagebind import _light_pair
from test_torch_judge import judge_cfgs, np_tree
from test_torch_wavlm import wavlm_cfgs

from sam_audio_tpu.eval import main as jmain
from sam_audio_tpu.eval import metrics as jmetrics
from sam_audio_tpu.eval import settings as jsettings
from sam_audio_tpu.models import aesthetics as jaes
from sam_audio_tpu.models import clap as jclap
from sam_audio_tpu.models import judge as jjudge
from sam_audio_tpu.processor import SAMAudioJudgeProcessor as JJudgeProcessor
from sam_audio_tpu.processor import SAMAudioProcessor as JProcessor
from sam_audio_tpu.text_tokenizer import ByteFallbackTokenizer as JByteTokenizer
from sam_audio_tpu_torch import SAMAudio, SAMAudioProcessor, tiny_test_config
from sam_audio_tpu_torch.checkpoint import params_from_numpy, save_params
from sam_audio_tpu_torch.eval import main as tmain
from sam_audio_tpu_torch.eval import metrics as tmetrics
from sam_audio_tpu_torch.eval import settings as tsettings
from sam_audio_tpu_torch.models.init import inject_noise
from sam_audio_tpu_torch.models import aesthetics as taes
from sam_audio_tpu_torch.models import clap as tclap
from sam_audio_tpu_torch.models.judge import SAMAudioJudgeModel
from sam_audio_tpu_torch.processor import SAMAudioJudgeProcessor
from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer

TOL = dict(rtol=1e-4, atol=1e-4)
SR = 8000   # the tiny model's and the tiny judge's rate
AES_SMALL = dict(sample_rate=8000, n_fft=128, hop_length=64, n_mels=16, hidden=16, layers=1,
                 heads=2)
DESCRIPTIONS = ["a dog barking", "rain on a roof", "a bell"]


# -- the same metric towers in both packages --------------------------------


def metric_towers(names=("judge", "aesthetic-predictor", "aesthetic-audiobox", "clap",
                          "imagebind")):
    """{name: (JAX metric, port metric)} on bridged weights, CPU."""
    out = {}
    if "judge" in names:
        jcfg, tcfg = judge_cfgs()
        jp = np_tree(jjudge.judge_init(jax.random.PRNGKey(0), jcfg))
        out["judge"] = (
            jmetrics.Judge(model=jjudge.SAMAudioJudgeModel(jcfg, jp),
                           processor=JJudgeProcessor(8, SR, tokenizer=JByteTokenizer(300))),
            tmetrics.Judge(model=SAMAudioJudgeModel(tcfg, params_from_numpy(jp), device="cpu"),
                           processor=SAMAudioJudgeProcessor(8, SR, ByteFallbackTokenizer(300))))
    if "aesthetic-predictor" in names:
        jm = jaes.AesPredictor.init_random(jax.random.PRNGKey(1),
                                           jaes.AestheticsConfig(**AES_SMALL))
        out["aesthetic-predictor"] = (jmetrics.Aesthetic(model=jm), tmetrics.Aesthetic(
            model=taes.AesPredictor(taes.AestheticsConfig(**AES_SMALL),
                                    params_from_numpy(np_tree(jm.params)))))
    if "aesthetic-audiobox" in names:
        wj, wt = wavlm_cfgs("group")
        jm = jaes.AudioboxAesthetics.init_random(jax.random.PRNGKey(2),
                                                 jaes.AudioboxAestheticsConfig(wavlm=wj))
        out["aesthetic-audiobox"] = (jmetrics.Aesthetic(model=jm), tmetrics.Aesthetic(
            model=taes.AudioboxAesthetics(taes.AudioboxAestheticsConfig(wavlm=wt),
                                          params_from_numpy(np_tree(jm.params)))))
    if "clap" in names:
        jp = np_tree(jclap.clap_init(jax.random.PRNGKey(3), CLAP_JCFG))
        out["clap"] = (jmetrics.CLAP(model=jclap.ClapModel(CLAP_JCFG, jp, JByteTokenizer(300))),
                       tmetrics.CLAP(model=tclap.ClapModel(CLAP_TCFG, params_from_numpy(jp),
                                                           ByteFallbackTokenizer(300))))
    if "imagebind" in names:
        tib, jib = _light_pair()
        out["imagebind"] = (jmetrics.ImageBind(model=jib), tmetrics.ImageBind(model=tib))
    return out


@pytest.fixture(scope="module")
def towers():
    return metric_towers()


def metric_inputs():
    rng = np.random.RandomState(0)
    targets = [(rng.randn(n) * 0.1).astype(np.float32) for n in (4000, 6400, 2400)]
    inputs = [(rng.randn(n) * 0.1).astype(np.float32) for n in (4000, 6400, 2400)]
    videos = [rng.randint(0, 255, (6, 3, 40, 48)).astype(np.uint8) for _ in range(3)]
    return dict(target_wavs=targets, input_wavs=inputs, descriptions=DESCRIPTIONS,
                videos=videos, target_wavs_sample_rate=SR)


@pytest.mark.parametrize("name", ["judge", "aesthetic-predictor", "aesthetic-audiobox", "clap",
                                  "imagebind"])
def test_metric_matches_jax(towers, name):
    jm, tm = towers[name]
    kw = metric_inputs()
    ref, got = jm(**kw), tm(**kw)
    assert list(got) == list(ref) == list(tm.keys)
    for key in ref:
        assert all(isinstance(v, float) for v in got[key])
        np.testing.assert_allclose(got[key], ref[key], err_msg=key, **TOL)


def test_metrics_refuse_random_weights(tmp_path):
    for cls in (tmetrics.CLAP, tmetrics.Aesthetic, tmetrics.ImageBind):
        with pytest.raises(ValueError, match="random"):
            cls(device="cpu")
    assert isinstance(tmetrics.Aesthetic(allow_random=True, device="cpu").model,
                      taes.AesPredictor)
    with pytest.raises(FileNotFoundError, match="local judge snapshot"):
        tmetrics.Judge(checkpoint=str(tmp_path / "absent"), device="cpu")
    if not torch.cuda.is_available():   # the entry points default to the card
        with pytest.raises(RuntimeError, match="CUDA"):
            tmetrics.Aesthetic(allow_random=True)


# -- datasets and settings ----------------------------------------------------


@pytest.mark.parametrize("span", [False, True])
def test_synthetic_bench_is_jax_s(span):
    kw = dict(span=span, num_items=5, seconds=0.3)
    jd = jdatasets.SyntheticBench(collate_fn=JProcessor(8, SR), **kw)
    td = tdatasets.SyntheticBench(collate_fn=SAMAudioProcessor(8, SR), **kw)
    assert len(td) == len(jd) == 5 and td.visual is jd.visual is False
    for i in range(5):
        a, b = td[i], jd[i]
        assert (a.description, a.anchors, a.masked_video_frames) == \
            (b.description, b.anchors, b.masked_video_frames)
        assert a.audio_samples.dtype == b.audio_samples.dtype
        np.testing.assert_array_equal(a.audio_samples, b.audio_samples)
    got, ref = td.collate([td[0], td[3]]), jd.collate([jd[0], jd[3]])
    for name in ("audios", "sizes", "wav_sizes", "audio_pad_mask", "anchor_ids",
                 "anchor_alignment"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)
    assert (got.anchors is None) == (not span)


def test_nearest_grid_is_jax_s_and_torch_s():
    for h0 in range(1, 30):
        for h in range(1, 45):
            got = tdatasets._nearest_grid(h, h0)
            np.testing.assert_array_equal(got, jdatasets._nearest_grid(h, h0))
            m = torch.arange(h0, dtype=torch.float32).reshape(1, 1, h0, 1)
            want = F.interpolate(m, size=(h, 1)).numpy().reshape(-1)
            np.testing.assert_array_equal(np.arange(h0, dtype=np.float32)[got], want)


def _bench_pair(root, items, monkeypatch, wav, frames):
    """Both packages' SAMAudioBench over `items`, without load_dataset (the
    constructor is bypassed), their audio and video decoders replaced by
    the given arrays."""
    pair = []
    for mod, vio, proc in ((tdatasets, tvideo_io, SAMAudioProcessor(8, SR)),
                           (jdatasets, jvideo_io, JProcessor(8, SR))):
        ds = object.__new__(mod.SAMAudioBench)
        ds.dataset, ds.cache_path, ds.collate_fn = items, str(root), proc
        ds._span, ds._visual = True, True
        monkeypatch.setattr(mod, "load_audio", lambda path: (wav, 44_100))
        monkeypatch.setattr(vio, "decode_video_frames",
                            lambda path: (frames, np.arange(frames.shape[0]) / 5.0))
        pair.append(ds)
    return pair


def test_sam_audio_bench_paths_masks_and_items(tmp_path, monkeypatch):
    src = tmp_path / "vggsound"
    src.mkdir()
    names = ["vid1.mp4", "vid2_1500_2500.mp4", "vid3_1_2.mp4", "vid4.00001500_00002500.mp4"]
    for n in names:
        (src / n).write_bytes(b"")
    rng = np.random.RandomState(1)
    masklet = (rng.rand(3, 5, 7) > 0.5).astype(np.uint8)
    buf = io.BytesIO()
    np.savez(buf, video_masklet=masklet)
    items = [dict(video_id=f"vid{i + 1}", source_dataset="vggsound", start_offset=1.5,
                  end_offset=2.5, description=f"item {i}", spans=[[0.1, 0.4], [0.6, 0.9]],
                  mask_bytes=buf.getvalue() if i % 2 == 0 else None) for i in range(4)]
    wav = (rng.randn(2, 44_100 * 3) * 0.1).astype(np.float32)
    frames = rng.randint(1, 255, (15, 3, 12, 16)).astype(np.uint8)
    ours, ref = _bench_pair(tmp_path, items, monkeypatch, wav, frames)
    for i, n in enumerate(names):
        path, select = ours._get_path(f"vid{i + 1}", "vggsound", 1.5, 2.5)
        assert (path, select) == ref._get_path(f"vid{i + 1}", "vggsound", 1.5, 2.5)
        assert path == str(src / n) and select is (i == 0)
    assert ours._get_path("absent", "vggsound", 1.5, 2.5)[0].endswith(
        "absent.00001500_00002500.mp4")
    got_items = [ours[i] for i in range(4)]
    for got, want in zip(got_items, (ref[i] for i in range(4))):
        assert (got.description, got.anchors) == (want.description, want.anchors)
        np.testing.assert_array_equal(got.audio_samples, want.audio_samples)
        if want.masked_video_frames is None:
            assert got.masked_video_frames is None
        else:
            np.testing.assert_array_equal(got.masked_video_frames, want.masked_video_frames)
    # item 0 is cut from the whole video: 5 of 15 frames at 5 fps, 1 s of audio
    assert got_items[0].masked_video_frames.shape == (5, 3, 12, 16)
    assert got_items[0].audio_samples.shape == (1, SR)
    assert got_items[2].masked_video_frames.shape == (15, 3, 12, 16)
    batch = ours.collate([got_items[0], got_items[2]])
    assert batch.anchors is not None and batch.masked_video is not None


def test_settings_are_jax_s(tmp_path):
    assert list(tsettings.SETTINGS) == list(jsettings.SETTINGS)
    for name, (cls, kw) in tsettings.SETTINGS.items():
        jcls, jkw = jsettings.SETTINGS[name]
        assert (cls.__name__, kw) == (jcls.__name__, jkw), name
    with pytest.raises(KeyError, match="unknown eval setting") as err:
        tsettings.make_dataset("not-a-setting", cache_path=str(tmp_path), collate_fn=None)
    assert all(name in str(err.value) for name in tsettings.SETTINGS)
    ds = tsettings.make_dataset("synthetic-span", str(tmp_path), SAMAudioProcessor(8, SR))
    assert isinstance(ds, tdatasets.SyntheticBench) and ds._span


# -- aggregation and batching -------------------------------------------------


RANK_ROWS = [[{"a": 1.0, "b": 2.0}, {"a": 3.0, "b": 4.5}],
             [{"a": 5.0, "b": 6.0}],
             [],
             [{"a": 7.0, "b": 8.0}, {"a": 9.25, "b": 10.0}]]


def _collective(rank_rows, keys):
    """A fake all-gather: every rank's [sums..., count] vector."""
    def gather(local):
        vecs = [[sum(r[k] for r in rows) for k in keys] + [len(rows)] for rows in rank_rows]
        np.testing.assert_array_equal(local, vecs[0])
        return np.asarray(vecs, np.float64)
    return gather


def test_gather_and_average_matches_jax():
    rows = [r for rows in RANK_ROWS for r in rows]
    assert tmain.gather_and_average_results(rows) == jmain.gather_and_average_results(rows)
    assert tmain.gather_and_average_results([]) == jmain.gather_and_average_results([]) == {}
    for expected in (None, ["a", "b"]):
        kw = dict(multihost=True, _allgather=_collective(RANK_ROWS, ["a", "b"]),
                  expected_keys=expected)
        got = tmain.gather_and_average_results(RANK_ROWS[0], **kw)
        assert got == jmain.gather_and_average_results(RANK_ROWS[0], **kw)
        assert got == tmain.gather_and_average_results(rows)
        assert all(type(v) is float for v in got.values())
    # an empty rank contributes a vector of the same layout
    empty = tmain.gather_and_average_results(
        [], multihost=True, expected_keys=["b", "a"],
        _allgather=lambda local: np.stack([local, [4.0, 6.0, 2.0]]))
    assert empty == {"a": 2.0, "b": 3.0}


def test_gather_raises_on_keys_outside_expected():
    rows = [{"a": 1.0, "stray": 2.0}]
    with pytest.raises(ValueError, match="stray"):
        tmain.gather_and_average_results(rows, expected_keys=["a"])
    with pytest.raises(ValueError, match="stray"):
        tmain.gather_and_average_results(rows, multihost=True, expected_keys=["a"],
                                         _allgather=lambda x: x[None])
    # JAX drops the key from the multi-rank average and keeps it alone
    assert "stray" not in jmain.gather_and_average_results(
        rows, multihost=True, expected_keys=["a"], _allgather=lambda x: np.asarray(x)[None])
    assert "stray" in jmain.gather_and_average_results(rows, expected_keys=["a"])


class _Counting:
    def __init__(self, n):
        self.n, self.loads = n, []

    visual = False

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.loads.append(i)
        return i

    def collate(self, items):
        return list(items)


@pytest.mark.parametrize("prefetch", [0, 1, 2, 5])
def test_iter_batches_order_and_coverage(prefetch):
    for world in (1, 2, 3):
        got = [list(tmain.iter_batches(_Counting(10), 3, r, world, prefetch=prefetch))
               for r in range(world)]
        ref = [list(jmain.iter_batches(_Counting(10), 3, r, world, prefetch=prefetch))
               for r in range(world)]
        assert got == ref
        assert sorted(i for rank in got for b in rank for i in b) == list(range(10))
        assert all(len(b) <= 3 for rank in got for b in rank)
    assert tmain._shard_indices(10, 3, 4) == jmain._shard_indices(10, 3, 4) == [3, 7]


# -- run_eval ------------------------------------------------------------------


def port_eval(out_dir, **kw):
    """run_eval of the tiny port model and metrics (seeded, CPU) on a
    one-item synthetic setting."""
    jcfg, tcfg = judge_cfgs()
    cfg = tiny_test_config()
    model = inject_noise(SAMAudio.init_random(cfg, seed=0, device="cpu",
                                              tokenizer=ByteFallbackTokenizer(300)),
                         2 * cfg.audio_codec.codebook_dim)
    metrics = [tmetrics.Judge(model=SAMAudioJudgeModel.init_random(tcfg, seed=1, device="cpu"),
                              processor=SAMAudioJudgeProcessor(8, SR, ByteFallbackTokenizer(300))),
               tmetrics.Aesthetic(model=taes.AesPredictor.init_random(
                   taes.AestheticsConfig(**AES_SMALL), seed=2, device="cpu")),
               tmetrics.CLAP(model=tclap.ClapModel.init_random(
                   CLAP_TCFG, seed=3, device="cpu", tokenizer=ByteFallbackTokenizer(300)))]
    tsettings.SETTINGS["synthetic-one"] = (tdatasets.SyntheticBench, {"num_items": 1})
    try:
        return tmain.run_eval(settings=["synthetic-one"], cache_path=out_dir, batch_size=1,
                              checkpoint_path="", reranking_candidates=1, model=model,
                              processor=SAMAudioProcessor(8, SR), metrics=metrics,
                              output_dir=out_dir, device="cpu", **kw)["synthetic-one"]
    finally:
        del tsettings.SETTINGS["synthetic-one"]


def test_run_eval_refuses_keyless_metrics_across_ranks(tmp_path, monkeypatch):
    def keyless(**kw):
        return {"Loudness": [float(np.abs(w).mean()) for w in kw["target_wavs"]]}

    model = SAMAudio.init_random(tiny_test_config(), seed=0, device="cpu",
                                 tokenizer=ByteFallbackTokenizer(300))
    kw = dict(settings=["synthetic"], cache_path=str(tmp_path), batch_size=2,
              checkpoint_path="", reranking_candidates=1, model=model,
              processor=SAMAudioProcessor(8, SR), metrics=[keyless],
              output_dir=str(tmp_path), device="cpu", max_items=1)
    monkeypatch.setattr(tmain, "_rank_world", lambda: (0, 2))
    with pytest.raises(ValueError, match="keyless"):
        tmain.run_eval(**kw)
    monkeypatch.setattr(tmain, "_rank_world", lambda: (0, 1))
    assert list(tmain.run_eval(**kw)["synthetic"]) == ["Loudness"]


def test_command_line_writes_results(tmp_path, monkeypatch):
    path = SAMAudio.init_random(tiny_test_config(), seed=0, device="cpu").save_pretrained(
        str(tmp_path / "snap"))
    jcfg, tcfg = judge_cfgs()
    judge_dir = tmp_path / "judge"
    judge_dir.mkdir()
    with open(judge_dir / "config.json", "w") as f:
        json.dump(dataclasses.asdict(jcfg), f)
    model = SAMAudioJudgeModel.init_random(tcfg, seed=0, device="cpu")
    save_params(str(judge_dir / "params.npz"), model.params)
    monkeypatch.chdir(tmp_path)
    # neither snapshot holds tokenizer files: both loaders get the byte tokenizer
    load_model, load_processor = SAMAudio.from_pretrained, SAMAudioJudgeProcessor.from_pretrained
    monkeypatch.setattr(SAMAudio, "from_pretrained", lambda p, device: load_model(
        p, device=device, tokenizer=ByteFallbackTokenizer(tiny_test_config().text_encoder
                                                          .vocab_size)))
    monkeypatch.setattr(SAMAudioJudgeProcessor, "from_pretrained",
                        lambda p: load_processor(p, allow_fallback_tokenizer=True))
    # Aesthetic and CLAP at their default widths with random weights
    out = tmain.main(["-s", "synthetic", "-p", path, "--device", "cpu", "-b", "2", "-c", "1",
                      "--max-items", "2", "--allow-random-metrics",
                      "--judge-checkpoint", str(judge_dir)])
    with open(tmp_path / "results" / "synthetic.json") as f:
        written = json.load(f)
    assert sorted(written) == sorted(out["synthetic"]) and len(written) == 9
    assert all(np.isfinite(v) for v in out["synthetic"].values())
