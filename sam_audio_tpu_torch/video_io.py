"""Host-side video decode through the ffmpeg command line; counterpart of
sam_audio_tpu/video_io.py (the reference decodes with torchcodec's FFmpeg
VideoDecoder, sam_audio/processor.py:13, 131-155). Frames given as
(N, C, H, W) uint8 arrays do not come here: they are the hermetic path.
"""

from __future__ import annotations

import json
import logging
import shutil
import subprocess
from typing import Tuple

import numpy as np

logger = logging.getLogger(__name__)

DEFAULT_FPS = 25.0


def _stream_fps(meta: dict) -> float:
    """The frame rate a stream declares: r_frame_rate, else avg_frame_rate,
    else nb_frames / duration; 0 when none is known."""
    for field in ("r_frame_rate", "avg_frame_rate"):
        num, _, den = meta.get(field, "0/0").partition("/")
        try:
            rate = float(num) / float(den or 1)
        except (ValueError, ZeroDivisionError):
            rate = 0.0
        if rate > 0:
            return rate
    try:
        return float(meta["nb_frames"]) / float(meta["duration"])
    except (KeyError, ValueError, ZeroDivisionError):
        return 0.0


def decode_video_frames(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (frames (N, C, H, W) uint8, pts in seconds (N,) float64). The
    pts are arange(N) / fps: a constant-frame-rate approximation. A stream
    that declares no rate is taken at 25 fps, with a warning."""
    ffmpeg, ffprobe = shutil.which("ffmpeg"), shutil.which("ffprobe")
    if ffmpeg is None or ffprobe is None:
        raise RuntimeError(f"Cannot decode video {path!r}: ffmpeg/ffprobe not on PATH. "
                           "Pass the frames as (N, C, H, W) uint8 arrays instead.")
    meta = json.loads(subprocess.run(
        [ffprobe, "-v", "error", "-select_streams", "v:0", "-show_entries",
         "stream=width,height,r_frame_rate,avg_frame_rate,nb_frames,duration", "-of", "json",
         path], capture_output=True, text=True, check=True).stdout)["streams"][0]
    w, h = int(meta["width"]), int(meta["height"])
    fps = _stream_fps(meta)
    if fps <= 0:
        logger.warning("video %r declares no frame rate (r_frame_rate, avg_frame_rate, "
                       "nb_frames / duration); assuming %g fps for its timestamps",
                       path, DEFAULT_FPS)
        fps = DEFAULT_FPS
    raw = subprocess.run([ffmpeg, "-v", "error", "-i", path, "-f", "rawvideo", "-pix_fmt",
                          "rgb24", "-"], capture_output=True, check=True).stdout
    frames = np.frombuffer(raw, np.uint8).reshape(-1, h, w, 3)
    frames = np.transpose(frames, (0, 3, 1, 2)).copy()   # NCHW
    return frames, np.arange(frames.shape[0], dtype=np.float64) / fps
