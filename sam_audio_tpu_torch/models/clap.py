"""CLAP (contrastive language-audio pretraining), the text ranker's scorer.

Counterpart of sam_audio_tpu/models/clap.py (reference ranker:
sam_audio/ranking/clap.py:11-86, laion_clap `630k-best.pt`).

  audio: laion_clap's feature pipeline (48 kHz, int16 quantization round
  trip, 10 s repeat-pad / truncate), the HTSAT-tiny tower (models/htsat.py),
  the audio_projection MLP, L2 normalisation.
  text: RoBERTa-base (models/roberta.py) pooler_output, the text_projection
  MLP, L2 normalisation. Score = audio_emb . text_emb.

Weights come from the JAX package's flat npz (checkpoint.load_params), which
its converter writes from a laion_clap checkpoint.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sam_audio_tpu_torch.models.htsat import HTSATConfig, htsat_embed
from sam_audio_tpu_torch.models.roberta import RobertaConfig, roberta_encode
from sam_audio_tpu_torch.ops import nn as N


@dataclass(frozen=True)
class ClapConfig:
    # feature pipeline (laion_clap audio_cfg for HTSAT-tiny at 48 kHz)
    sample_rate: int = 48_000
    duration_s: float = 10.0
    n_fft: int = 1024
    hop_length: int = 480
    n_mels: int = 64
    fmin: float = 50.0
    fmax: float = 14_000.0
    # HTSAT audio tower (tiny: embed 96, depths 2/2/6/2)
    spec_size: int = 256
    patch_size: int = 4
    audio_embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    audio_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 8
    # RoBERTa text tower (base)
    text_vocab: int = 50_265
    text_hidden: int = 768
    text_layers: int = 12
    text_heads: int = 12
    text_intermediate: int = 3072
    max_text_len: int = 77
    # joint space
    embed_dim: int = 512

    @property
    def n_samples(self) -> int:
        return int(self.duration_s * self.sample_rate)

    @property
    def htsat(self) -> HTSATConfig:
        return HTSATConfig(
            sample_rate=self.sample_rate, n_fft=self.n_fft, hop_length=self.hop_length,
            n_mels=self.n_mels, fmin=self.fmin, fmax=self.fmax, spec_size=self.spec_size,
            patch_size=self.patch_size, embed_dim=self.audio_embed_dim,
            depths=self.depths, num_heads=self.audio_heads, window_size=self.window_size)

    @property
    def roberta(self) -> RobertaConfig:
        return RobertaConfig(
            vocab_size=self.text_vocab, hidden_size=self.text_hidden,
            num_layers=self.text_layers, num_heads=self.text_heads,
            intermediate_size=self.text_intermediate)


def _mlp_proj(params, x, compute_dtype=None):
    """laion_clap projection head: Linear -> ReLU -> Linear."""
    return N.linear(params["fc2"], F.relu(N.linear(params["fc1"], x, compute_dtype)),
                    compute_dtype)


def _l2_normalize(emb: torch.Tensor) -> torch.Tensor:
    emb = emb.float()
    return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-8)


def quantize_roundtrip(wav: torch.Tensor) -> torch.Tensor:
    """laion_clap's int16 round trip (reference clap.py:50-57); the cast to
    int16 truncates toward zero."""
    q = (torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)
    return q.float() / 32767.0


def fit_duration(wav: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Repeat-pad short audio / centre-truncate long audio to n_samples
    (laion_clap 'repeatpad' with a deterministic crop). wav: (B, T)."""
    t = wav.shape[-1]
    if t < n_samples:
        wav = wav.repeat(1, int(np.ceil(n_samples / t)))
        t = wav.shape[-1]
    if t > n_samples:
        start = (t - n_samples) // 2
        wav = wav[..., start: start + n_samples]
    return wav


def fit_duration_np(wav: np.ndarray, n_samples: int, rand_trunc: bool = False,
                    rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Host version for one waveform (T,): repeat-pads its true length, as
    laion_clap's per-file pipeline does; rand_trunc=True takes laion_clap's
    `rand_trunc` crop of long audio from a seedable RandomState."""
    wav = np.asarray(wav, np.float32).reshape(-1)
    t = wav.shape[-1]
    if t == 0:
        return np.zeros(n_samples, np.float32)
    if t < n_samples:
        wav = np.tile(wav, int(np.ceil(n_samples / t)))
        t = wav.shape[-1]
    if t > n_samples:
        if rand_trunc:
            start = (rng or np.random).randint(0, t - n_samples + 1)
        else:
            start = (t - n_samples) // 2
        wav = wav[start: start + n_samples]
    return wav


def clap_audio_embed(params, cfg: ClapConfig, wav: torch.Tensor,
                     compute_dtype=None) -> torch.Tensor:
    """wav: (B, T) at cfg.sample_rate -> (B, embed_dim) L2-normalised."""
    wav = quantize_roundtrip(fit_duration(wav, cfg.n_samples))
    emb = htsat_embed(params["audio_branch"], cfg.htsat, wav, compute_dtype)
    return _l2_normalize(_mlp_proj(params["audio_projection"], emb, compute_dtype))


def clap_text_embed(params, cfg: ClapConfig, input_ids, attention_mask,
                    compute_dtype=None) -> torch.Tensor:
    _, pooled = roberta_encode(params["text_branch"], input_ids, attention_mask,
                               cfg.roberta, compute_dtype)
    return _l2_normalize(_mlp_proj(params["text_projection"], pooled, compute_dtype))


class ClapModel:
    """(cfg, params, device) of one CLAP scorer."""

    def __init__(self, cfg: ClapConfig, params, tokenizer=None,
                 allow_fallback_tokenizer: bool = False):
        self.cfg = cfg
        self.params = params
        self._tokenizer = tokenizer
        # random-weight models may tokenize with the byte fallback; converted
        # checkpoints must find a real RoBERTa tokenizer
        self.allow_fallback_tokenizer = allow_fallback_tokenizer

    @property
    def device(self) -> torch.device:
        return self.params["audio_branch"]["melW"].device

    @classmethod
    def init_random(cls, cfg: ClapConfig = ClapConfig(), seed: int = 0, device="cuda",
                    tokenizer=None):
        from sam_audio_tpu_torch.models.init import clap_init
        from sam_audio_tpu_torch.models.sam_audio import resolve_device

        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, clap_init(cfg, gen, dev), tokenizer, allow_fallback_tokenizer=True)

    @classmethod
    def from_torch_checkpoint(cls, path: str, cfg: ClapConfig = ClapConfig(), tokenizer=None,
                              device="cuda"):
        """A laion_clap .pt checkpoint (e.g. 630k-best.pt: {"state_dict": ...}),
        converted by convert.convert_clap_state_dict; a key it does not
        convert raises."""
        from sam_audio_tpu_torch.checkpoint import params_from_numpy
        from sam_audio_tpu_torch.convert import convert_clap_state_dict, load_torch_state_dict
        from sam_audio_tpu_torch.models.sam_audio import resolve_device

        params, unconverted = convert_clap_state_dict(
            load_torch_state_dict(path, key="state_dict"), cfg)
        if unconverted:
            raise ValueError(f"unconverted CLAP keys: {unconverted[:10]}...")
        return cls(cfg, params_from_numpy(params, resolve_device(device)), tokenizer)

    @property
    def tokenizer(self):
        if self._tokenizer is None:
            from sam_audio_tpu_torch.text_tokenizer import get_roberta_tokenizer

            self._tokenizer = get_roberta_tokenizer(
                self.cfg.text_vocab, allow_fallback=self.allow_fallback_tokenizer)
        return self._tokenizer

    def quantize(self):
        """int8 serving mode for the scorer (HTSAT + RoBERTa W8A8, see
        ops/quant.py). Returns self."""
        from sam_audio_tpu_torch.ops.quant import quantize_clap_params

        self.params = quantize_clap_params(self.params)
        return self

    def tokenize(self, texts):
        ids, mask = self.tokenizer(list(texts), max_length=self.cfg.max_text_len)
        return (torch.as_tensor(np.asarray(ids), dtype=torch.long, device=self.device),
                torch.as_tensor(np.asarray(mask), dtype=torch.bool, device=self.device))

    @torch.inference_mode()
    def get_audio_embedding(self, wavs: torch.Tensor) -> torch.Tensor:
        return clap_audio_embed(self.params, self.cfg, wavs)

    @torch.inference_mode()
    def get_text_embedding(self, texts) -> torch.Tensor:
        return clap_text_embed(self.params, self.cfg, *self.tokenize(texts))
