"""Host-side text tokenization for the T5 encoder.

The reference tokenizes with HF's T5 tokenizer (truncation 512, longest-pad,
reference: sam_audio/model/text_encoder.py:19-27). The HF tokenizer is used
when its files are in the local cache (never fetched over the network);
otherwise a deterministic byte-level tokenizer runs the pipeline hermetically,
gated like random tower weights.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)


class HFTokenizer:
    def __init__(self, name_or_path: str):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(name_or_path,
                                                 local_files_only=True)

    def __call__(self, texts: Sequence[str], max_length: Optional[int] = 512
                 ) -> Tuple[np.ndarray, np.ndarray]:
        enc = self.tok(
            list(texts), truncation=max_length is not None, max_length=max_length,
            padding="longest", return_tensors="np",
        )
        return (enc["input_ids"].astype(np.int32),
                enc["attention_mask"].astype(bool))


class ByteFallbackTokenizer:
    """Deterministic byte-level tokenizer (hermetic fallback).

    Maps UTF-8 bytes to ids [3, 258] with T5-style conventions: pad=0, eos=1
    appended. Not vocabulary-compatible with T5 — use only with randomly
    initialized text encoders (tests/benchmarks), never with converted
    checkpoints.
    """

    pad_id = 0
    eos_id = 1

    def __init__(self, vocab_size: int = 32128):
        self.vocab_size = vocab_size

    def __call__(self, texts: Sequence[str], max_length: Optional[int] = 512
                 ) -> Tuple[np.ndarray, np.ndarray]:
        seqs: List[List[int]] = []
        for t in texts:
            ids = [3 + (b % min(self.vocab_size - 3, 256))
                   for b in t.encode("utf-8")]
            if max_length is not None:
                ids = ids[: max_length - 1]
            ids.append(self.eos_id)
            seqs.append(ids)
        longest = max(len(s) for s in seqs) if seqs else 1
        ids_arr = np.full((len(seqs), longest), self.pad_id, np.int32)
        mask = np.zeros((len(seqs), longest), bool)
        for i, s in enumerate(seqs):
            ids_arr[i, : len(s)] = s
            mask[i, : len(s)] = True
        return ids_arr, mask


def get_text_tokenizer(cfg_or_name, allow_fallback: bool = False):
    """T5 text tokenizer: HF from the local cache -> hermetic byte fallback.

    The fallback is gated exactly like random tower weights: with a real
    converted checkpoint the model must never silently condition on byte-
    level token ids (the reference always tokenizes with the real HF T5
    tokenizer, sam_audio/model/text_encoder.py:14-15)."""
    name = getattr(cfg_or_name, "name", cfg_or_name)
    vocab = getattr(cfg_or_name, "vocab_size", 32128)
    try:
        return HFTokenizer(name)
    except Exception:
        pass  # no transformers or no cached files: gated below
    if not allow_fallback:
        raise RuntimeError(
            f"No tokenizer for '{name}' is available in the local HF cache. "
            "Stage the HF tokenizer files — the reference always loads the "
            "real T5 tokenizer (sam_audio/model/text_encoder.py:14-15). The "
            "byte-level fallback would silently condition the model on "
            "garbage token ids; pass allow_fallback=True (or "
            "allow_random_towers=True on the model) only with randomly-"
            "initialized text towers."
        )
    logger.warning(
        "Falling back to the hermetic ByteFallbackTokenizer for '%s' — "
        "NOT vocabulary-compatible; use only with random-init text "
        "towers.", name,
    )
    return ByteFallbackTokenizer(vocab)
