"""Eval settings: the reference's 14 paper settings plus the hermetic
synthetic ones (counterpart of sam_audio_tpu/eval/settings.py; reference:
eval/dataset/__init__.py:8-70)."""

from __future__ import annotations

from typing import Callable

from sam_audio_tpu_torch.eval.datasets import MUSDB, SAMAudioBench, SyntheticBench


def _bench(span: bool, visual: bool, subset: str):
    return SAMAudioBench, {"span": span, "visual": visual, "subset": subset}


SETTINGS = {
    # text only
    "sfx": _bench(False, False, "others-50:text-only"),
    "speech": _bench(False, False, "speech-clean-50:text-only"),
    "speaker": _bench(False, False, "spk-50:text-only"),
    "music": _bench(False, False, "music-clean-50:text-only"),
    "instr-wild": _bench(False, False, "instr-50:text-only"),
    "instr-pro": (MUSDB, {}),
    # text + span
    "sfx-span": _bench(True, False, "others-50:text+span"),
    "speech-span": _bench(True, False, "speech-clean-50:text+span"),
    "speaker-span": _bench(True, False, "spk-50:text+span"),
    "music-span": _bench(True, False, "music-clean-50:text+span"),
    "instr-wild-span": _bench(True, False, "instr-50:text+span"),
    # visual
    "sfx-visual": _bench(False, True, "others-onscreen-50:visual-only"),
    "speaker-visual": _bench(False, True, "spk-onscreen-50:visual-only"),
    "instr-wild-visual": _bench(False, True, "instr-onscreen-50:visual-only"),
    # hermetic synthetic settings (no downloads)
    "synthetic": (SyntheticBench, {}),
    "synthetic-span": (SyntheticBench, {"span": True}),
}


def make_dataset(setting: str, cache_path: str, collate_fn: Callable):
    """Build a registered eval setting by name; an unknown name raises with
    the list of every setting."""
    try:
        dataset_cls, dataset_kwargs = SETTINGS[setting]
    except KeyError:
        raise KeyError(
            f"unknown eval setting {setting!r}; choose from {sorted(SETTINGS)}") from None
    return dataset_cls(cache_path=cache_path, collate_fn=collate_fn, **dataset_kwargs)
