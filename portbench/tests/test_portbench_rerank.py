"""The k-candidate path with the CLAP ranker, on the CPU at a tiny size
(tests/data/tiny_clap.json, 4 candidates an item): the reference agrees with
the program on every candidate, every score and the pick; the benchmark's
CLAP tree is the program's; and each fault planted under the timed path,
and the fp8 control, drives a run whose `correct` comes out false."""

import json

import numpy as np
import pytest
import torch

from conftest import DATA, tiny_rerank_cell
from portbench.harness import bench
from portbench.harness.rankers import clap
from portbench.reference import sam_audio_clap

SEED = 4_000_000_117
CFG = json.loads((DATA / "tiny_clap.json").read_text())


def run(cell, seed=SEED, control=None):
    return bench.run_cell(cell, seed, 0.0, False, device="cpu", control=control)


def test_clap_tree_is_the_programs():
    from sam_audio_tpu_torch.models.init import clap_init
    from sam_audio_tpu_torch.utils import tree_leaves_with_path

    theirs = clap_init(clap.config(CFG), torch.Generator().manual_seed(0), torch.device("cpu"))
    ours = clap.weights(CFG, 1, torch.device("cpu"))

    def shapes(t):
        return {p: tuple(x.shape) for p, x in tree_leaves_with_path(t)}

    assert shapes(ours) == shapes(theirs)
    # the one buffer handed to both sides, worked out twice
    assert torch.allclose(ours["audio_branch"]["melW"], theirs["audio_branch"]["melW"],
                          rtol=1e-5, atol=1e-7)


def test_mel_filterbank_is_the_published_one():
    from sam_audio_tpu_torch.ops.mel import mel_filterbank

    ours = sam_audio_clap.mel_filterbank(48000, 1024, 64, 50.0, 14000.0)
    theirs = mel_filterbank(48000, 1024, 64, 50.0, 14000.0, mel_scale="slaney", norm="slaney")
    assert ours.shape == (513, 64)
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-9)


def test_reference_agrees_on_every_candidate_score_and_pick(monkeypatch):
    from sam_audio_tpu_torch.ranking.clap import ClapRanker

    seen, ref_seen = [], []
    real_score = ClapRanker.score_on_device
    real_ref = sam_audio_clap.separate_candidates

    def score(self, targets, sizes, descriptions, mixtures=None):
        out = real_score(self, targets, sizes, descriptions, mixtures)
        seen.append((targets.clone(), list(sizes), out.clone()))
        return out

    def reference(*args, **kw):
        out = real_ref(*args, **kw)
        ref_seen.append(out)
        return out

    monkeypatch.setattr(ClapRanker, "score_on_device", score)
    monkeypatch.setattr(sam_audio_clap, "separate_candidates", reference)
    out = run(tiny_rerank_cell())
    assert out["correct"], out["check"]
    assert out["check"]["rank_gap"]["value"] == 0.0
    targets, sizes, scores = seen[-1]        # the window's one call
    assert len(ref_seen) == targets.shape[0] == 2
    for item, (ref_targets, ref_scores, pick, _) in enumerate(ref_seen):
        got = targets[item, :, : sizes[item]].double()
        err = (got - ref_targets.double()).norm(dim=1) / ref_targets.double().norm(dim=1)
        assert err.max() < 1e-5, err
        np.testing.assert_allclose(scores[item].numpy(), ref_scores.numpy(), atol=1e-6)
        assert pick == int(torch.argmax(scores[item])) == int(torch.argmax(ref_scores))


def test_rank_gap_reads_the_pick():
    out = run(tiny_rerank_cell(requests_per_call=1, max_batch=1))
    assert out["correct"], out["check"]
    assert set(out["check"]) == {"target_rel_err", "residual_rel_err", "rank_gap",
                                 "wrong_length", "non_finite"}


# -- faults planted under the timed path ------------------------------------------


def _ranker_ignored(monkeypatch):
    """The ranker's scores ignored: candidate 0 of every item is kept."""
    from sam_audio_tpu_torch.ranking.clap import ClapRanker

    real = ClapRanker.score_on_device
    monkeypatch.setattr(ClapRanker, "score_on_device",
                        lambda self, *a, **kw: torch.zeros_like(real(self, *a, **kw)))


def _argmin(monkeypatch):
    """The worst-scored candidate kept: argmin in place of argmax."""
    from sam_audio_tpu_torch.ranking.clap import ClapRanker

    real = ClapRanker.score_on_device
    monkeypatch.setattr(ClapRanker, "score_on_device", lambda self, *a, **kw: -real(self, *a, **kw))


def _scores_rotated(monkeypatch):
    """The candidates permuted within an item between scoring and keeping:
    candidate j is kept for the score of candidate j - 1."""
    from sam_audio_tpu_torch.ranking.clap import ClapRanker

    real = ClapRanker.score_on_device
    monkeypatch.setattr(ClapRanker, "score_on_device",
                        lambda self, *a, **kw: torch.roll(real(self, *a, **kw), 1, dims=1))


def _noise_candidate_major(monkeypatch):
    """The group's noise read candidate-major where it was drawn item-major:
    item i's candidate j solves from draw j * B + i, so an item's candidates
    start from another item's noises."""
    import sam_audio_tpu_torch.models.sam_audio as sa

    real = sa.separate_latents

    def permuted(*args, candidates=1, **kw):
        noise = args[7]
        b = noise.shape[0] // candidates
        noise = noise.reshape(candidates, b, *noise.shape[1:]).transpose(0, 1)
        return real(*args[:7], noise.reshape(args[7].shape), *args[8:],
                    candidates=candidates, **kw)

    monkeypatch.setattr(sa, "separate_latents", permuted)


def _state_unchanged(monkeypatch):
    """The ODE returns its state unchanged: the noise is decoded."""
    import sam_audio_tpu_torch.models.sam_audio as sa

    monkeypatch.setattr(sa, "odeint", lambda func, y0, **kw: y0)


@pytest.mark.parametrize("fault", [_ranker_ignored, _argmin, _scores_rotated,
                                   _noise_candidate_major, _state_unchanged],
                         ids=["ranker-ignored", "argmin", "scores-rotated",
                              "noise-candidate-major", "state-unchanged"])
def test_fault_fails_the_check(monkeypatch, fault):
    """Four items of 8 candidates, all checked: a kept candidate that is
    not the best shows in one item at least."""
    fault(monkeypatch)
    out = run(tiny_rerank_cell(candidates=8, requests_per_call=4, max_batch=4, check_rows=8))
    assert not out["correct"], out["check"]


def test_noise_permuted_within_an_item_changes_no_answer(monkeypatch):
    """A permutation of an item's own noises leaves its set of candidates,
    their scores and the kept one as they were: no fault, and the check
    rightly passes it (it compares against the candidate nearest to the
    program's answer, whichever draw that came from)."""
    import sam_audio_tpu_torch.models.sam_audio as sa

    real = sa.separate_latents

    def reversed_within(*args, candidates=1, **kw):
        noise = args[7]
        b = noise.shape[0] // candidates
        noise = noise.reshape(b, candidates, *noise.shape[1:]).flip(1)
        return real(*args[:7], noise.reshape(args[7].shape), *args[8:],
                    candidates=candidates, **kw)

    monkeypatch.setattr(sa, "separate_latents", reversed_within)
    out = run(tiny_rerank_cell())
    assert out["correct"], out["check"]


def test_fp8_control_fails_the_check():
    out = run(tiny_rerank_cell(), control="fp8")
    assert not out["correct"]
    assert out["check"]["target_rel_err"]["value"] > 3e-2
