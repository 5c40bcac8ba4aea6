"""Shared pieces of the benchmark's own tests: the checkout's root on the
path, and a tiny cell (tests/data: a tiny_test_config-sized model with a
PE tower, fp32, two 0.05 s requests a call) that runs on the CPU; and its
reranked twin (`tiny_rerank_cell`: the same model without the tower, 4
candidates an item scored by a tiny CLAP ranker); and a ranker kind the
harness lacks, as the modules a new kind would bring (`install_stub_kind`)."""

import json
import sys
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

DATA = Path(__file__).resolve().parent / "data"


def tiny_cell(config="tiny.json", limits=None, **traffic_overrides):
    from portbench.harness import registry

    bench = registry.manifest()
    traffic = json.loads((DATA / "tiny_traffic.json").read_text())
    traffic.update(traffic_overrides)
    return registry.Cell(
        name="tiny", chips=1, config_name="tiny", traffic_name="tiny",
        config=json.loads((DATA / config).read_text()), traffic=traffic,
        check={"limits": limits or {"target_rel_err": 1e-4, "residual_rel_err": 1e-4,
                                    "wrong_length": 0, "non_finite": 0}},
        end_to_end=[m for m in bench["end_to_end"] if not m["name"].endswith(".video")],
        per_layer=[m for m in bench["per_layer"] if not m["name"].endswith(".video")])


def tiny_rerank_cell(**traffic_overrides):
    traffic = dict(candidates=4, video=None)
    traffic.update(traffic_overrides)
    return tiny_cell("tiny_clap.json", {"target_rel_err": 1e-4, "residual_rel_err": 1e-4,
                                        "rank_gap": 1e-6, "wrong_length": 0, "non_finite": 0},
                     **traffic)


# -- a ranker kind the harness lacks, as new modules ------------------------------


def _stub_distance(audio, mixture, scale):
    """-(1 + |scale|) * || audio - mixture ||, the mixture zero-padded or cut
    to the audio's length."""
    mix = torch.nn.functional.pad(mixture.float(), (0, max(0, audio.shape[-1] - mixture.shape[-1])))
    return -(1 + scale.abs()) * (audio.float() - mix[..., :audio.shape[-1]]).norm(dim=-1)


class StubRanker:
    """The program side: scores on the device, from the mixtures."""

    def __init__(self, params):
        self.params = params

    def supports_on_device(self, sizes, sample_rate):
        return True

    def score_on_device(self, targets, sizes, descriptions, mixtures=None):
        b, k, t = targets.shape
        keep = (torch.arange(t)[None, :] < torch.as_tensor(list(sizes))[:, None]).float()
        mix = mixtures[:, 0, :t] if mixtures.shape[-1] >= t else mixtures[:, 0]
        return _stub_distance(targets * keep[:, None], (mix * keep[:, :mix.shape[-1]])[:, None],
                              self.params["scale"])


def stub_kind(kind="stub"):
    """The plug-in `portbench.harness.rankers.<kind>` of a ranker that scores
    each candidate by its distance to the mixture (one scale drawn from
    seed + 2), reads no prompt and runs one codec encode over the group's
    rows."""
    m = types.ModuleType(f"portbench.harness.rankers.{kind}")

    def weights(cfg, seed, device):
        from portbench.harness.weights import materialize

        return materialize({"scale": ("u", (), 1.0)}, seed + 2, device)

    m.weights = weights
    m.build = lambda cfg, seed, device: StubRanker(weights(cfg, seed, device))
    m.prompt_tokens = lambda cfg, descriptions: 0
    m.flops = lambda cfg, g: 3 * g.rows * g.candidates * g.samples
    m.encoder_launches = lambda cfg, g: {g.rows: 1}
    return m


def stub_reference():
    """The reference module `portbench.reference.stub_ref` of that ranker:
    `score` and `separate_candidates` in plain torch over
    reference/sam_audio.py."""
    from portbench.reference import sam_audio as sa

    m = types.ModuleType("portbench.reference.stub_ref")

    def score(w, cfg, audio, description, mixture):
        return _stub_distance(audio, mixture, w["scale"])

    def separate_candidates(p, cfg, w, wav, description, noise, pad_to, text_pad_to=64,
                            video=None, choose=None):
        velocity, frames = sa.conditioned(p, cfg, wav, description, pad_to, text_pad_to, video)
        targets, scores, latents = [], [], []
        for y0 in noise:
            latents.append(sa.solve(velocity, y0))
            targets.append(sa.decode(p, cfg, latents[-1], frames, 0))
            scores.append(score(w, cfg, targets[-1], description, wav))
        targets, scores = torch.stack(targets), torch.stack(scores)
        i = int(torch.argmax(scores)) if choose is None else int(choose(targets, scores))
        return targets, scores, i, sa.decode(p, cfg, latents[i], frames, 1)

    m.score, m.separate_candidates = score, separate_candidates
    return m


def install_stub_kind(monkeypatch, kind="stub"):
    """The stub's plug-in as ranker kind `kind` and its reference module, put
    where the harness imports them (as new files would be)."""
    monkeypatch.setitem(sys.modules, f"portbench.harness.rankers.{kind}", stub_kind(kind))
    monkeypatch.setitem(sys.modules, "portbench.reference.stub_ref", stub_reference())


@pytest.fixture
def cell():
    return tiny_cell()


@pytest.fixture
def card():
    """Skips unless a CUDA device is present (decided here, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
