"""Host-side text tokenization for the T5 encoder and the CLAP text tower.

The reference tokenizes with HF's T5 tokenizer (truncation 512, longest-pad,
reference: sam_audio/model/text_encoder.py:19-27) and CLAP's RoBERTa
tokenizer. The HF tokenizers are used when their files are in the local cache
(never fetched over the network); RoBERTa's BPE also runs from its two
vocabulary files. Otherwise a deterministic byte-level tokenizer runs the
pipeline hermetically, gated like random tower weights.
"""

from __future__ import annotations

import json
import logging
import os
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


class RobertaBPETokenizer:
    """RoBERTa's GPT-2-style byte-level BPE from vocab.json + merges.txt (the
    CLAP text tokenizer; laion_clap tokenizes with HF RobertaTokenizer
    ('roberta-base'), padding='max_length', max_length=77). Special ids follow
    roberta-base: <s>=0, <pad>=1, </s>=2, <unk>=3."""

    bos_id, pad_id, eos_id, unk_id = 0, 1, 2, 3

    def __init__(self, vocab: dict, merges: list):
        import regex

        self.encoder = vocab
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self._cache: dict = {}
        self.pat = regex.compile(
            r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
            r"|\s+(?!\S)|\s+")

    @classmethod
    def from_dir(cls, path: str):
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if line and not line.startswith("#version"):
                    merges.append(tuple(line.split(" ")))
        return cls(vocab, merges)

    def _bpe(self, token: str) -> list:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 62))
            if best not in self.bpe_ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        self._cache[token] = list(word)
        return self._cache[token]

    def encode_text(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in self.pat.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder.get(piece, self.unk_id) for piece in self._bpe(mapped))
        return ids

    def __call__(self, texts: Sequence[str], max_length: Optional[int] = 77
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Pads to max_length, as laion_clap does (to the longest without one)."""
        seqs = []
        for t in texts:
            ids = self.encode_text(t)
            if max_length is not None:
                ids = ids[: max_length - 2]
            seqs.append([self.bos_id] + ids + [self.eos_id])
        longest = max_length if max_length is not None else max(map(len, seqs), default=2)
        ids_arr = np.full((len(seqs), longest), self.pad_id, np.int32)
        mask = np.zeros((len(seqs), longest), bool)
        for i, s in enumerate(seqs):
            ids_arr[i, : len(s)] = s
            mask[i, : len(s)] = True
        return ids_arr, mask


def _bytes_to_unicode() -> dict:
    """GPT-2's reversible byte <-> printable-unicode map."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def get_roberta_tokenizer(vocab_size: int = 50265, allow_fallback: bool = False):
    """The CLAP text tokenizer: BPE files from SAM_AUDIO_ROBERTA_TOKENIZER or
    the package's assets/roberta_tokenizer -> HF 'roberta-base' from the local
    cache -> the byte fallback, gated like random tower weights (with real
    CLAP weights it would score garbage token ids; the reference always uses
    the real tokenizer, sam_audio/ranking/clap.py:30)."""
    for cand in (os.environ.get("SAM_AUDIO_ROBERTA_TOKENIZER"),
                 os.path.join(os.path.dirname(__file__), "assets", "roberta_tokenizer")):
        # only a full file set counts; a partial one falls through to the gate
        if cand and all(os.path.exists(os.path.join(cand, f))
                        for f in ("vocab.json", "merges.txt")):
            return RobertaBPETokenizer.from_dir(cand)
    try:
        return HFTokenizer("roberta-base")
    except Exception:
        if not allow_fallback:
            raise RuntimeError(
                "No RoBERTa tokenizer is available: stage vocab.json + merges.txt "
                "(point SAM_AUDIO_ROBERTA_TOKENIZER at the directory) or cache HF "
                "'roberta-base' locally. Pass allow_fallback=True only with "
                "randomly-initialized towers.")
    logger.warning("Falling back to the hermetic ByteFallbackTokenizer for RoBERTa — "
                   "NOT vocabulary-compatible; use only with random-init text towers.")
    return ByteFallbackTokenizer(vocab_size)


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
