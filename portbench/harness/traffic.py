"""The general traffic generator: a traffic file's parameters and a seed ->
a pool of requests, and the calls a closed loop makes over it.

Every request of a pool has the same length, so every seed gives the same
work in another order: what the seed draws is the sound, the prompt, the
video's picture and its mask box. Mixtures sum two to four of: a harmonic
tone (f0, partials and their decay, vibrato), a band of noise in bursts, a
linear or exponential chirp; each is normalised to a peak drawn in
[0.3, 0.9]. Prompts are 3 to 12 words from the lists below, cut to stay
within `prompt_max_bytes` so that every prompt tokenises to the same padded
width. A video is `fps` frames a second that cut through `scenes` seeded
pictures (noise of a seeded grain and tint), with a bright square drifting
over them; its mask is a seeded box of ones (pixels under it are blanked).

Traffic file keys: `loop` (the loop that drives the program, by name:
portbench/harness/loops/<loop>.py), `requests_per_call`, `max_batch`,
`bucket_seconds`, `text_pad_to`, `candidates` (k), `clip_seconds`, `pool`, `audio_as`
("wav_file": float32 WAVs written to a temporary directory, or "array"),
`video` (null, or {fps, height, width, scenes}), `prompt_max_bytes`,
`warmup_calls`, `trace_calls`, `check_rows`.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

SOUNDS = ["dog", "bark", "piano", "violin", "car", "horn", "siren", "bird", "rain",
          "voice", "man", "woman", "crowd", "drum", "bell", "engine", "wind", "water",
          "guitar", "train", "door", "cat", "baby", "fan", "phone", "alarm", "flute"]
WORDS = ["a", "the", "loud", "soft", "low", "high", "near", "far", "two", "one",
         "with", "and", "in", "on", "short", "long", "deep", "thin", "slow", "fast"]


@dataclass
class Request:
    index: int
    description: str
    wav: np.ndarray                      # (T,) float32 at the codec's rate
    path: Optional[str] = None           # the WAV file the program reads, if any
    frames: Optional[np.ndarray] = None  # (N, 3, H, W) uint8, before masking
    box: Optional[tuple] = None          # (y0, y1, x0, x1) of the mask


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2 ** 63), *stream])


def prompt(rng: np.random.Generator, max_bytes: int) -> str:
    n = int(rng.integers(3, 13))
    words = [str(rng.choice(WORDS)) for _ in range(n - 1)]
    words.insert(int(rng.integers(0, n)), str(rng.choice(SOUNDS)))
    text = " ".join(words)
    while len(text.encode()) > max_bytes:
        words.pop(0 if words[0] not in SOUNDS else -1)
        text = " ".join(words)
    return text


def mixture(rng: np.random.Generator, n: int, sr: int) -> np.ndarray:
    t = np.arange(n, dtype=np.float64) / sr
    out = np.zeros(n, np.float64)
    for _ in range(int(rng.integers(2, 5))):
        kind = int(rng.integers(0, 3))
        if kind == 0:   # harmonic tone with vibrato
            f0 = rng.uniform(80, 800)
            vib = 1 + 0.01 * np.sin(2 * np.pi * rng.uniform(3, 7) * t)
            phase = 2 * np.pi * f0 * np.cumsum(vib) / sr
            decay = rng.uniform(0.3, 0.8)
            # partials by the recurrence sin((h+1)p) = 2 cos(p) sin(hp) - sin((h-1)p)
            two_cos, prev, cur = 2 * np.cos(phase), np.zeros(n), np.sin(phase)
            s = cur.copy()
            for h in range(1, int(rng.integers(3, 9))):
                prev, cur = cur, two_cos * cur - prev
                s += decay ** h * cur
        elif kind == 1:  # noise in bursts
            period = rng.uniform(0.2, 1.5)
            gate = (np.mod(t + rng.uniform(0, period), period) < rng.uniform(0.05, 0.5) * period)
            s = np.convolve(rng.standard_normal(n), np.ones(8) / 8, mode="same") * gate
        else:            # chirp
            f1, f2 = rng.uniform(100, 2000), rng.uniform(2000, 12000)
            dur = n / sr
            if rng.integers(0, 2):
                phase = 2 * np.pi * (f1 * t + (f2 - f1) * t * t / (2 * dur))
            else:
                k = (f2 / f1) ** (1 / dur)
                phase = 2 * np.pi * f1 * (k ** t - 1) / np.log(k)
            s = np.sin(phase)
        out += s / (np.abs(s).max() + 1e-9) * rng.uniform(0.2, 1.0)
    return (out / (np.abs(out).max() + 1e-9) * rng.uniform(0.3, 0.9)).astype(np.float32)


def video(rng: np.random.Generator, n: int, height: int, width: int, scenes: int):
    """(N, 3, H, W) uint8 frames and a mask box (y0, y1, x0, x1). The clip
    cuts through `scenes` seeded pictures in equal parts, each of its own
    grain (noise in blocks of 4 to 64 pixels) and tint, so that what the
    vision tower sees of a frame depends on the frame's place in time; a
    bright square drifts over them."""
    pics = []
    for _ in range(scenes):
        b = int(rng.choice([4, 8, 16, 32, 64]))
        small = rng.integers(0, 256, (3, -(-height // b), -(-width // b)), dtype=np.uint8)
        pic = np.repeat(np.repeat(small, b, axis=1), b, axis=2)[:, :height, :width]
        pics.append((pic * rng.uniform(0.2, 1.0, (3, 1, 1))).astype(np.uint8))
    frames = np.empty((n, 3, height, width), np.uint8)
    side = height // 6
    y, x = rng.integers(0, height - side), rng.integers(0, width - side)
    vy, vx = rng.integers(-3, 4), rng.integers(-3, 4)
    for i in range(n):
        frames[i] = pics[i * scenes // n]
        yi = int(np.clip(y + vy * i, 0, height - side))
        xi = int(np.clip(x + vx * i, 0, width - side))
        frames[i, :, yi: yi + side, xi: xi + side] = 255
    bh, bw = int(rng.integers(height // 4, height // 2)), int(rng.integers(width // 4, width // 2))
    y0, x0 = int(rng.integers(0, height - bh)), int(rng.integers(0, width - bw))
    return frames, (y0, y0 + bh, x0, x0 + bw)


def box_mask(shape, box) -> np.ndarray:
    m = np.zeros(shape, np.uint8)
    y0, y1, x0, x1 = box
    m[..., y0:y1, x0:x1] = 1
    return m


def write_float_wav(path: str, wav: np.ndarray, sr: int):
    """Mono IEEE-float (format 3) WAV."""
    data = np.asarray(wav, "<f4").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 3, 1, sr, sr * 4, 4, 32))
        f.write(b"data" + struct.pack("<I", len(data)) + data)


def make_pool(traffic: dict, seed: int, sample_rate: int, workdir: Optional[str]) -> List[Request]:
    """The pool of `traffic["pool"]` requests of `seed`, made on a few host
    threads (numpy releases the interpreter lock in its loops); request i
    draws from its own stream, so the pool does not depend on the order."""
    from concurrent.futures import ThreadPoolExecutor

    n = int(round(traffic["clip_seconds"] * sample_rate))
    vid = traffic.get("video")

    def make(i: int) -> Request:
        rng = _rng(seed, 1, i)
        req = Request(index=i, description=prompt(rng, int(traffic["prompt_max_bytes"])),
                      wav=mixture(rng, n, sample_rate))
        if traffic["audio_as"] == "wav_file":
            req.path = os.path.join(workdir, f"mix{i:03d}.wav")
            write_float_wav(req.path, req.wav, sample_rate)
        if vid:
            req.frames, req.box = video(rng, int(round(traffic["clip_seconds"] * vid["fps"])),
                                        int(vid["height"]), int(vid["width"]),
                                        int(vid["scenes"]))
        return req

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(make, range(int(traffic["pool"]))))


def call(pool: List[Request], traffic: dict, i: int) -> List[Request]:
    """The requests of the closed loop's i-th call: the pool in order, wrapping."""
    r = int(traffic["requests_per_call"])
    return [pool[(i * r + j) % len(pool)] for j in range(r)]
