"""run_eval of the PyTorch port as a whole: two synthetic settings against
the JAX package's run_eval (fp32, CPU, the same tiny weights and metric
towers, the same injected noise), and a two-process gloo run against the
single-process mean."""

import json
import os
import socket

import numpy as np
import pytest
from test_torch_eval import SR, metric_towers, port_eval

from sam_audio_tpu.eval import main as jmain
from sam_audio_tpu.models.sam_audio import SAMAudio as JaxSAMAudio
from sam_audio_tpu.processor import SAMAudioProcessor as JProcessor
from sam_audio_tpu.text_tokenizer import ByteFallbackTokenizer as JByteTokenizer
from sam_audio_tpu_torch import SAMAudio, SAMAudioProcessor, tiny_test_config
from sam_audio_tpu_torch.eval import main as tmain
from sam_audio_tpu_torch.eval import metrics as tmetrics
from sam_audio_tpu_torch.models.init import inject_noise
from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A tiny model written by the port's save_pretrained (its anchor gate
    opened to 0.5: at init it is 0, which would make the span setting's
    anchors inert), loaded by both packages."""
    cfg = tiny_test_config()
    model = SAMAudio.init_random(cfg, seed=0, device="cpu")
    model.params["embed_anchors"]["gate"].fill_(0.5)
    path = model.save_pretrained(str(tmp_path_factory.mktemp("eval") / "snap"))
    jm = JaxSAMAudio.from_pretrained(path, allow_random_towers=True)
    jm._tokenizer = JByteTokenizer(cfg.text_encoder.vocab_size)
    return jm, path


@pytest.fixture(scope="module")
def towers():
    return metric_towers(("judge", "aesthetic-predictor", "aesthetic-audiobox", "clap"))


def test_run_eval_matches_jax(snapshot, towers, tmp_path):
    jm, path = snapshot
    cfg = tiny_test_config()
    ch = 2 * cfg.audio_codec.codebook_dim
    tm = SAMAudio.from_pretrained(path, device="cpu",
                                  tokenizer=ByteFallbackTokenizer(cfg.text_encoder.vocab_size))
    inject_noise(jm, ch)
    inject_noise(tm, ch)
    names = ("judge", "aesthetic-predictor", "aesthetic-audiobox", "clap")
    kw = dict(settings=["synthetic", "synthetic-span"], cache_path=str(tmp_path), batch_size=2,
              checkpoint_path="", reranking_candidates=1, max_items=2)
    try:
        ref = jmain.run_eval(model=jm, processor=JProcessor(8, SR),
                             metrics=[towers[n][0] for n in names[:2] + names[3:]],
                             output_dir=str(tmp_path / "jax"), **kw)
        got = tmain.run_eval(model=tm, processor=SAMAudioProcessor(8, SR),
                             metrics=[towers[n][1] for n in names[:2] + names[3:]],
                             output_dir=str(tmp_path / "port"), device="cpu", **kw)
    finally:
        del jm.separate   # the fixture's model, unwrapped
    assert list(got) == list(ref) == kw["settings"]
    for setting in kw["settings"]:
        assert list(got[setting]) == list(ref[setting]) and len(got[setting]) == 9
        for key, value in ref[setting].items():
            np.testing.assert_allclose(got[setting][key], value, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{setting}/{key}")
        with open(tmp_path / "port" / f"{setting}.json") as f:
            written = json.load(f)
        with open(tmp_path / "jax" / f"{setting}.json") as f:
            jwritten = json.load(f)
        assert list(written) == list(jwritten)
        for key, text in jwritten.items():
            # three decimals, as JAX writes them: equal to the printed unit
            assert abs(float(written[key]) - float(text)) <= 1e-3 + 1e-4 * abs(float(text)), key
    # the two settings differ (the anchors reach the model)
    assert got["synthetic"] != got["synthetic-span"]
    # the AudioboxAesthetics tower through the same loop
    box = tmain.run_eval(model=tm, processor=SAMAudioProcessor(8, SR),
                         metrics=[towers["aesthetic-audiobox"][1]], device="cpu",
                         output_dir=str(tmp_path / "box"), **{**kw, "settings": ["synthetic"]})
    assert sorted(box["synthetic"]) == sorted(tmetrics.COLUMN_MAP.values())


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gloo_worker(rank, port, out_dir):
    import datetime

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=120))
    try:
        res = port_eval(out_dir)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def test_two_rank_gloo_run_gives_the_single_process_mean(tmp_path):
    """World 2 over one item: rank 1 is empty and still joins the gather;
    both ranks return the single-process mean, and only rank 0 writes."""
    import torch.multiprocessing as mp

    single = port_eval(str(tmp_path / "single"))
    out = str(tmp_path / "dist")
    os.makedirs(out)
    ctx = mp.spawn(_gloo_worker, args=(_free_port(), out), nprocs=2, join=False)
    try:
        for _ in range(30):
            if ctx.join(timeout=10):
                break
        else:
            raise AssertionError("the gloo run did not finish in 300 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    for rank in (0, 1):
        with open(os.path.join(out, f"rank{rank}.json")) as f:
            got = json.load(f)
        assert got.keys() == single.keys() and len(got) == 9
        for k, v in single.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-12, atol=0, err_msg=f"{rank}/{k}")
    assert os.path.exists(os.path.join(out, "synthetic-one.json"))
