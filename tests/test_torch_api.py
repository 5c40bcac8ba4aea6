"""The port's API surface against the JAX package's: the top-level names
(lazy ones included), the one-call tower loaders and the tokenizer's
`from_files` held against JAX's on the same files (1e-4), `Batch.to`, and the
training checkpoint manager's lifecycle (`wait_until_finished`, `close`,
the context manager), as JAX's example uses it. CPU, tiny widths."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sam_audio_tpu
import sam_audio_tpu_torch
from test_torch_convert import CLAP_TINY, IB_TINY, _clap_sd
from torch_imagebind_oracle import tiny_imagebind

from sam_audio_tpu import checkpoint as jckpt
from sam_audio_tpu.models import clap as jclap
from sam_audio_tpu.models import imagebind as jib
from sam_audio_tpu_torch.checkpoint import flatten

TOL = dict(rtol=1e-4, atol=1e-4)

# every name the JAX package exports at its top level (sam_audio_tpu/__init__.py)
JAX_NAMES = ("DACVAEConfig", "SAMAudioConfig", "SAMAudioJudgeConfig", "T5EncoderConfig",
             "TransformerConfig", "parse_ranker_config", "SAMAudio", "SeparationResult",
             "Batch", "SAMAudioJudgeProcessor", "SAMAudioProcessor", "SAMAudioJudgeModel",
             "SeparationPipeline", "SeparationRequest", "SeparationResponse",
             "ContinuousBatcher", "SeparationServer")


@pytest.mark.parametrize("name", JAX_NAMES)
def test_top_level_names_match_jax(name):
    import importlib

    assert hasattr(sam_audio_tpu, name)
    obj = getattr(sam_audio_tpu_torch, name)
    module = obj.__module__
    assert module.startswith("sam_audio_tpu_torch.")
    assert getattr(importlib.import_module(module), name) is obj
    assert name in sam_audio_tpu_torch.__all__


def test_unknown_top_level_name_raises():
    with pytest.raises(AttributeError, match="no_such_name"):
        sam_audio_tpu_torch.no_such_name  # noqa: B018


def _assert_trees_close(ours, ref):
    a, b = flatten(ours), {k: np.asarray(v) for k, v in jckpt.flatten_pytree(ref).items()}
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_allclose(a[k], b[k], err_msg=k, **TOL)


def test_clap_from_torch_checkpoint_matches_jax(tmp_path):
    from sam_audio_tpu_torch.models.clap import ClapConfig, ClapModel

    path = str(tmp_path / "clap.pt")
    torch.save({"state_dict": {k: torch.as_tensor(np.asarray(v)) for k, v in _clap_sd().items()}},
               path)
    ours = ClapModel.from_torch_checkpoint(path, ClapConfig(**CLAP_TINY), device="cpu")
    ref = jclap.ClapModel.from_torch_checkpoint(path, jclap.ClapConfig(**CLAP_TINY))
    _assert_trees_close(ours.params, ref.params)
    assert ours.device == torch.device("cpu")
    wav = (np.random.RandomState(2).randn(2, 8000) * 0.1).astype(np.float32)
    np.testing.assert_allclose(ours.get_audio_embedding(torch.from_numpy(wav)).numpy(),
                               np.asarray(ref.get_audio_embedding(jnp.asarray(wav))), **TOL)
    torch.save({"state_dict": {"mystery.weight": torch.zeros(2)} | {
        k: torch.as_tensor(np.asarray(v)) for k, v in _clap_sd().items()}}, path)
    with pytest.raises(ValueError, match="mystery"):
        ClapModel.from_torch_checkpoint(path, ClapConfig(**CLAP_TINY), device="cpu")


def test_imagebind_huge_from_torch_checkpoint_matches_jax(tmp_path):
    from sam_audio_tpu_torch.models.imagebind import ImageBindHugeConfig, ImageBindHugeModel

    model, _, _ = tiny_imagebind()
    path = str(tmp_path / "imagebind.pth")
    torch.save(model.state_dict(), path)
    ours = ImageBindHugeModel.from_torch_checkpoint(path, ImageBindHugeConfig(**IB_TINY),
                                                    device="cpu")
    ref = jib.ImageBindHugeModel.from_torch_checkpoint(path, jib.ImageBindHugeConfig(**IB_TINY))
    _assert_trees_close(ours.params, ref.params)
    assert ours.device == torch.device("cpu")


def test_roberta_tokenizer_from_files_matches_jax(tmp_path):
    from sam_audio_tpu.text_tokenizer import RobertaBPETokenizer as JaxTokenizer
    from sam_audio_tpu_torch.text_tokenizer import RobertaBPETokenizer

    pieces = ["<s>", "<pad>", "</s>", "<unk>", "a", "d", "o", "g", "Ġ", "Ġd", "og", "Ġdog",
              "b", "r", "k", "ar", "Ġb", "Ġbar", "Ġbark"]
    (tmp_path / "vocab.json").write_text(json.dumps({p: i for i, p in enumerate(pieces)}))
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\nĠ d\no g\nĠd og\nĠ b\na r\nĠb ar\nĠbar k\n")
    args = (str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt"))
    ours, ref = RobertaBPETokenizer.from_files(*args), JaxTokenizer.from_files(*args)
    texts = ["a dog bark", " dog dogs barking", "zebra"]
    for text in texts:
        assert ours.encode_text(text) == ref.encode_text(text)
    for got, want in zip(ours(texts, max_length=8), ref(texts, max_length=8)):
        np.testing.assert_array_equal(got, want)
    assert ours.encode_text(" dog") == [pieces.index("Ġdog")]
    from_dir = RobertaBPETokenizer.from_dir(str(tmp_path))
    assert from_dir.encode_text(texts[1]) == ours.encode_text(texts[1])


def test_batch_to_returns_the_batch():
    from sam_audio_tpu_torch import SAMAudioProcessor

    proc = SAMAudioProcessor(audio_hop_length=8, audio_sampling_rate=8000)
    batch = proc(descriptions=["a dog"], audios=[np.zeros((1, 40), np.float32)])
    assert batch.to("cuda") is batch and batch.to() is batch
    assert isinstance(batch.audios, np.ndarray)


def test_checkpoint_manager_lifecycle_as_in_jax(tmp_path):
    """JAX's example: `with TrainCheckpointManager(...) as mgr:` save,
    `wait_until_finished()`, the steps kept; close() again is harmless and
    the steps restore afterwards."""
    from sam_audio_tpu.train.checkpoints import TrainCheckpointManager as JaxManager
    from sam_audio_tpu_torch import tiny_test_config
    from sam_audio_tpu_torch.models.init import sam_audio_init
    from sam_audio_tpu_torch.train import TrainCheckpointManager, Trainer
    from sam_audio_tpu_torch.train.flow_matching import synthetic_batch

    for name in ("wait_until_finished", "close", "__enter__", "__exit__"):
        assert callable(getattr(JaxManager, name)) and callable(getattr(TrainCheckpointManager,
                                                                        name))
    cfg = tiny_test_config()
    trainer = Trainer(cfg, sam_audio_init(cfg, torch.Generator().manual_seed(0), "cpu"),
                      device="cpu")
    batch = synthetic_batch(cfg, torch.Generator().manual_seed(1), t_frames=8)
    with TrainCheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2) as mgr:
        for _ in range(3):
            trainer.step(batch)
            assert mgr.save(trainer.state, force=True)
        mgr.wait_until_finished()
        assert mgr.all_steps() == [2, 3]
    mgr.close()
    fresh = Trainer(cfg, sam_audio_init(cfg, torch.Generator().manual_seed(0), "cpu"),
                    device="cpu")
    fresh.state = TrainCheckpointManager(str(tmp_path / "ckpt")).restore(fresh.state)
    assert fresh.state.step == 3
    for (path, x), (_, y) in zip(sorted(flatten(fresh.state.params).items()),
                                 sorted(flatten(trainer.state.params).items())):
        np.testing.assert_array_equal(x, y, err_msg=path)
