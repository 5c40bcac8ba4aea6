"""Sound-activity ranker: silence detection against the prompt's spans;
counterpart of sam_audio_tpu/ranking/sound_activity.py (host numpy, the
port's own copy).

The reference's pydub pipeline in numpy
(reference: sam_audio/ranking/sound_activity.py:18-129): resample to 24 kHz,
peak-RMS-relative dB threshold (250 ms window / 100 ms hop), pydub-style
non-silent span detection (min_silence 250 ms, seek 10 ms), then span
IoU / recall / precision against the prompt's temporal anchors.

Runs entirely on host CPU, matching the reference's device placement.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from sam_audio_tpu_torch.config import SoundActivityRankerConfig
from sam_audio_tpu_torch.ops.resample import resample_np
from sam_audio_tpu_torch.ranking.ranker import Ranker

_SAMPLE_RATE = 24_000


def _to_int16(wav: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(wav, np.float32) * 32767.0, -32768, 32767).astype(
        np.int16
    )


def _ratio_to_db(ratio: float) -> float:
    if ratio <= 0:
        return -float("inf")
    return 20 * math.log10(ratio)


def _windowed_rms(samples: np.ndarray, win: int, hop: int) -> np.ndarray:
    """RMS of windows [i*hop, i*hop+win) via a cumulative sum of squares —
    vectorized but numerically identical to per-window means."""
    n = len(samples)
    starts = np.arange(0, max(n - win, 0) + 1, hop)
    if starts.size == 0:
        return np.zeros(0)
    cs = np.concatenate([[0.0], np.cumsum(samples.astype(np.float64) ** 2)])
    ends = np.minimum(starts + win, n)
    sums = cs[ends] - cs[starts]
    return np.sqrt(sums / np.maximum(ends - starts, 1))


def get_peak_rms(samples: np.ndarray, sr: int, win_ms=250, hop_ms=100) -> float:
    """Peak windowed RMS relative to max amplitude (reference:
    sound_activity.py:18-30). samples: int16."""
    win = int(sr * win_ms / 1000)
    hop = int(sr * hop_ms / 1000)
    rms = _windowed_rms(samples, win, hop)
    peak = float(rms.max() / 32768.0) if rms.size else -1.0
    return max(peak, 0.0)


def detect_nonsilent(
    wav: np.ndarray,
    sample_rate: int,
    min_sil_ms: int = 250,
    sil_threshold: float = -40,
    threshold_mode: str = "rel_to_max",
    seek_step_ms: int = 10,
) -> List[Tuple[float, float]]:
    """pydub.silence.detect_nonsilent semantics on numpy int16 @24 kHz
    (reference: sound_activity.py:42-69). Returns spans in seconds."""
    assert threshold_mode in ("abs", "rel_to_max")
    if sample_rate != _SAMPLE_RATE:
        wav = resample_np(np.asarray(wav, np.float32), sample_rate, _SAMPLE_RATE)
    samples = _to_int16(wav).reshape(-1)
    if threshold_mode == "rel_to_max":
        peak_rms = get_peak_rms(samples, _SAMPLE_RATE)
        sil_threshold = sil_threshold + _ratio_to_db(peak_rms)

    seg_len_ms = int(len(samples) * 1000 / _SAMPLE_RATE)
    if seg_len_ms < min_sil_ms:
        # pydub: a clip shorter than the minimum silence window can contain
        # no silence, so the WHOLE clip is non-silent (detect_silence
        # returns [] and detect_nonsilent complements it to [0, len]) — an
        # empty return here would zero every sub-250 ms candidate's score
        return ([(0.0, round(seg_len_ms / 1000, 3))] if seg_len_ms > 0
                else [])
    threshold_amp = (10 ** (sil_threshold / 20)) * 32768.0

    # pydub: slide a min_sil_ms window by seek_step; window is silent if its
    # RMS is BELOW the threshold. Vectorized via cumulative sum of squares.
    last_start = seg_len_ms - min_sil_ms
    start_ms_arr = np.arange(0, last_start + 1, seek_step_ms)
    if last_start % seek_step_ms:
        # pydub guarantees the final window [last_start, seg_len] is always
        # scanned even when last_start is not a multiple of seek_step —
        # without it, trailing silence at an unaligned tail goes undetected
        start_ms_arr = np.append(start_ms_arr, last_start)
    s_idx = (start_ms_arr * _SAMPLE_RATE // 1000).astype(np.int64)
    e_idx = ((start_ms_arr + min_sil_ms) * _SAMPLE_RATE // 1000).astype(np.int64)
    e_idx = np.minimum(e_idx, len(samples))
    cs = np.concatenate([[0.0], np.cumsum(samples.astype(np.float64) ** 2)])
    rms = np.sqrt((cs[e_idx] - cs[s_idx]) / np.maximum(e_idx - s_idx, 1))
    silent_starts = start_ms_arr[rms <= threshold_amp].tolist()

    # merge overlapping silent windows into silent ranges
    silent_ranges = []
    prev_i = None
    current_start = None
    for i in silent_starts:
        if current_start is None:
            current_start = i
        elif i - prev_i > seek_step_ms:
            silent_ranges.append((current_start, prev_i + min_sil_ms))
            current_start = i
        prev_i = i
    if current_start is not None:
        silent_ranges.append((current_start, prev_i + min_sil_ms))

    # complement -> non-silent ranges
    nonsilent = []
    prev_end = 0
    for s, e in silent_ranges:
        if s > prev_end:
            nonsilent.append((prev_end, s))
        prev_end = max(prev_end, e)
    if prev_end < seg_len_ms:
        nonsilent.append((prev_end, seg_len_ms))

    return [(round(s / 1000, 3), round(e / 1000, 3)) for s, e in nonsilent]


def compute_iou_recall_precision(hyp_spans, ref_spans):
    """reference: sound_activity.py:72-93."""

    def span_length(span):
        return span[1] - span[0]

    def intersection_length(a, b):
        return max(0, min(a[1], b[1]) - max(a[0], b[0]))

    total_hyp = sum(span_length(s) for s in hyp_spans)
    total_ref = sum(span_length(s) for s in ref_spans)
    total_intersection = sum(
        intersection_length(h, r) for h in hyp_spans for r in ref_spans
    )
    union = total_hyp + total_ref - total_intersection
    return {
        "iou": total_intersection / union if union > 0 else 0,
        "recall": total_intersection / total_ref if total_ref > 0 else 0,
        "precision": total_intersection / total_hyp if total_hyp > 0 else 0,
    }


class SoundActivityRanker(Ranker):
    def __init__(self, config: SoundActivityRankerConfig):
        self.config = config

    def __call__(
        self,
        extracted_audio: Sequence[np.ndarray],  # list of (k, T) candidates
        spans: Sequence[Sequence[Sequence[float]]],  # per item: [[tok, s, e], ...]
        sample_rate: int = 48_000,
        **kwargs,
    ) -> np.ndarray:
        scores = []
        for wavs, current_spans in zip(extracted_audio, spans):
            timestamps = [[span[1], span[2]] for span in current_spans]
            row = []
            for wav in np.asarray(wavs, np.float32):
                hyp = detect_nonsilent(
                    wav, sample_rate,
                    sil_threshold=self.config.sil_threshold,
                    threshold_mode=self.config.threshold_mode,
                )
                row.append(
                    compute_iou_recall_precision(hyp, timestamps)[self.config.metric]
                )
            scores.append(row)
        return np.asarray(scores, np.float32)
