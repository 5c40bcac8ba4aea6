"""The port's host runtime (sam_audio_tpu_torch/runtime/native.py and its
C++ sources in csrc/host/) against the JAX package's
(sam_audio_tpu/runtime/native.py) on the same inputs: the batch planner on
both paths, WAV files of every format the native reader takes (bit-equal),
the resampler (JAX's test bound, rtol 1e-3 / atol 1e-4, against resample_np),
a truncated file, a failed build, and load_audio with ffmpeg out of reach."""

import shutil
import struct
import warnings

import numpy as np
import pytest

from sam_audio_tpu import audio_io as jax_audio_io
from sam_audio_tpu.runtime import native as jax_native
from sam_audio_tpu_torch import audio_io
from sam_audio_tpu_torch.ops.resample import resample_np
from sam_audio_tpu_torch.runtime import native, plan_batches


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the host library")
    assert native.native_available()
    assert jax_native.native_available()
    return native._lib


def test_builds_into_the_ignored_build_dir(lib):
    path = native.library_path()
    assert path.exists() and path.parent.parent == native.BUILD_ROOT
    assert native.BUILD_ROOT.parts[-2:] == ("build", "host")


def test_serving_planner_never_loads_the_library(monkeypatch):
    """The serving layer's planner (`runtime.plan_batches`, which server.py
    and serving.py import) is the plain one: it plans without the library,
    and the native planner is a separate entry point."""
    def refuse():
        raise AssertionError("runtime.plan_batches loaded the host library")

    monkeypatch.setattr(native, "_load", refuse)
    assert plan_batches is not native.plan_batches
    assert native.plan_batches_plain is plan_batches
    assert plan_batches([30, 5, 70, 6], 8, 4, 2) == ([[0, 1], [3], [2]], [32, 32, 96])


def _lengths(seed):
    rng = np.random.RandomState(seed)
    return rng.randint(1, 5000, size=rng.randint(1, 40)).tolist()


@pytest.mark.parametrize("seed,hop,steps,max_batch", [(0, 8, 16, 2), (1, 1920, 1, 4),
                                                      (2, 8, 4, 3), (3, 0, 4, 2),
                                                      (4, 8, 0, 5), (5, -2, 3, 1)])
def test_plan_batches_native_numpy_and_jax_agree(lib, monkeypatch, seed, hop, steps, max_batch):
    """The library's planner, the numpy one and JAX's two give the same
    groups; a unit hop * bucket_steps <= 0 leaves the lengths as they are."""
    lengths = _lengths(seed)
    got = native.plan_batches(lengths, hop, steps, max_batch)
    assert got == plan_batches(lengths, hop, steps, max_batch)
    assert got == jax_native.plan_batches(lengths, hop, steps, max_batch)
    monkeypatch.setattr(jax_native, "_load", lambda: None)
    assert got == jax_native.plan_batches(lengths, hop, steps, max_batch)
    if hop * steps <= 0:
        assert set(got[1]) == set(lengths)
    assert sorted(i for group in got[0] for i in group) == list(range(len(lengths)))
    assert native.plan_batches([], hop, steps, max_batch) == ([], [])


@pytest.mark.parametrize("orig,new,shape", [(16000, 8000, (3, 1600)), (44100, 48000, (1, 441)),
                                            (48000, 16000, (2, 2, 999)), (8000, 8000, (1, 50))])
def test_resample_native_matches_resample_np(lib, orig, new, shape):
    wav = np.random.RandomState(orig % 97).randn(*shape).astype(np.float32) * 0.3
    ours = native.resample_native(wav, orig, new)
    ref = resample_np(wav, orig, new)
    assert ours.shape == ref.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(ours, jax_native.resample_native(wav, orig, new),
                               rtol=1e-6, atol=1e-7)


def test_wav_round_trip(lib, tmp_path):
    wav = np.stack([0.5 * np.sin(np.linspace(0, 50, 4000)),
                    np.linspace(-1.2, 1.2, 4000)]).astype(np.float32)
    path, jax_path = str(tmp_path / "n.wav"), str(tmp_path / "j.wav")
    assert native.write_wav_native(path, wav, 16000)
    assert jax_native.write_wav_native(jax_path, wav, 16000)
    assert open(path, "rb").read() == open(jax_path, "rb").read()
    loaded, sr = native.read_wav_native(path)
    assert sr == 16000 and loaded.shape == (2, 4000)
    np.testing.assert_allclose(loaded, np.clip(wav, -1, 1), atol=1e-4)
    # the numpy reader reads the native writer's file, and the other way round
    np.testing.assert_array_equal(audio_io.read_wav(path)[0], loaded)
    audio_io.write_wav(path, wav[0], 8000)
    loaded, sr = native.read_wav_native(path)
    assert sr == 8000
    np.testing.assert_array_equal(loaded, audio_io.read_wav(path)[0])
    assert not native.write_wav_native(str(tmp_path / "no" / "dir.wav"), wav, 8000)


_GUID_TAIL = bytes.fromhex("000000001000800000aa00389b71")


def _wav_file(path, payload: bytes, channels: int, sr: int, bits: int, fmt: int,
              extensible: bool):
    """A RIFF/WAVE file: a plain fmt chunk of format `fmt`, or an EXTENSIBLE
    one (0xFFFE) whose SubFormat GUID carries `fmt`; a LIST chunk before the
    data, as many writers put one."""
    block = channels * bits // 8
    if extensible:
        fmt_chunk = struct.pack("<HHIIHHHHI", 0xFFFE, channels, sr, sr * block, block, bits,
                                22, bits, 0) + struct.pack("<H", fmt) + _GUID_TAIL
    else:
        fmt_chunk = struct.pack("<HHIIHH", fmt, channels, sr, sr * block, block, bits)
    chunks = (b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk
              + b"LIST" + struct.pack("<I", 5) + b"INFOx\x00"
              + b"data" + struct.pack("<I", len(payload)) + payload)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks)


def _pcm24(x):
    ints = np.round(x * 8388607).astype("<i4").view(np.uint8).reshape(-1, 4)
    return ints[:, :3].tobytes()


def _interleaved(wav):
    return np.ascontiguousarray(wav.T).reshape(-1)


FORMATS = {
    # name: (channels, fmt, bits, extensible, encode)
    "float32_mono": (1, 3, 32, False, lambda w: _interleaved(w).astype("<f4").tobytes()),
    "float32_stereo": (2, 3, 32, False, lambda w: _interleaved(w).astype("<f4").tobytes()),
    "extensible_float32": (2, 3, 32, True, lambda w: _interleaved(w).astype("<f4").tobytes()),
    "extensible_pcm16": (2, 1, 16, True,
                         lambda w: np.round(_interleaved(w) * 32767).astype("<i2").tobytes()),
    "extensible_pcm24": (3, 1, 24, True, lambda w: _pcm24(_interleaved(w))),
}


def _make(tmp_path, name, frames=301, sr=22050):
    channels, fmt, bits, ext, encode = FORMATS[name]
    wav = (0.8 * np.random.RandomState(len(name)).rand(channels, frames) - 0.4).astype(np.float32)
    path = str(tmp_path / f"{name}.wav")
    _wav_file(path, encode(wav), channels, sr, bits, fmt, ext)
    return path, wav


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_native_reader_is_bit_equal_to_jax(lib, tmp_path, name):
    path, wav = _make(tmp_path, name)
    got = native.read_wav_native(path)
    ref = jax_native.read_wav_native(path)
    assert got is not None and ref is not None
    assert got[1] == ref[1] == 22050
    assert got[0].dtype == np.float32 and got[0].shape == wav.shape
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[0], wav, atol=2e-4 if "pcm16" in name else 1e-6)


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_load_audio_reads_them_without_ffmpeg(lib, tmp_path, monkeypatch, name):
    """Python's `wave` rejects these; with no ffmpeg reachable (PATH empty)
    load_audio still returns what JAX's returns, by the native reader."""
    path, _ = _make(tmp_path, name)
    monkeypatch.setenv("PATH", "")
    assert shutil.which("ffmpeg") is None
    got, sr = audio_io.load_audio(path)
    ref, jax_sr = jax_audio_io.load_audio(path)
    assert sr == jax_sr
    np.testing.assert_array_equal(got, ref)


def test_unparsable_files_give_none(lib, tmp_path, monkeypatch):
    """A stereo file cut mid-frame, a float64 WAV and a missing file: None
    from both packages' readers; load_audio then needs ffmpeg and says so."""
    audio_io.write_wav(str(tmp_path / "t.wav"), np.zeros((2, 100), np.float32), 8000)
    blob = open(tmp_path / "t.wav", "rb").read()
    (tmp_path / "t.wav").write_bytes(blob[:-2])
    payload = np.zeros(10, "<f8").tobytes()
    _wav_file(str(tmp_path / "f64.wav"), payload, 1, 8000, 64, 3, False)
    for name in ("t.wav", "f64.wav", "missing.wav"):
        path = str(tmp_path / name)
        assert native.read_wav_native(path) is None
        assert jax_native.read_wav_native(path) is None
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="ffmpeg"):
        audio_io.load_audio(str(tmp_path / "f64.wav"))


def test_load_audio_passes_sample_rate_to_ffmpeg(monkeypatch, tmp_path):
    seen = []

    def fake(path, sample_rate=None):
        seen.append((path, sample_rate))
        return np.zeros((1, 4), np.float32), sample_rate or 44100

    monkeypatch.setattr(audio_io, "_ffmpeg_decode", fake)
    assert audio_io.load_audio("clip.mp3", sample_rate=16000)[1] == 16000
    assert audio_io.load_audio("clip.flac")[1] == 44100
    assert seen == [("clip.mp3", 16000), ("clip.flac", None)]


@pytest.mark.parametrize("compiler", ["false", "no-such-compiler-anywhere"])
def test_failed_build_warns_once_and_falls_back(monkeypatch, tmp_path, compiler):
    """A compiler that fails (or is missing) warns once, with its message; the
    entry points then return JAX's fallbacks and plan_batches its numpy
    groups."""
    monkeypatch.setenv("CXX", compiler)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "host")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    with pytest.warns(RuntimeWarning, match="did not build") as record:
        assert not native.native_available()
    assert len(record) == 1
    assert ("exited 1" if compiler == "false" else "no C++ compiler") in str(record[0].message)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not native.native_available()
        lengths = _lengths(9)
        assert native.plan_batches(lengths, 8, 4, 3) == plan_batches(lengths, 8, 4, 3)
        assert native.read_wav_native(str(tmp_path / "x.wav")) is None
        assert native.resample_native(np.zeros((1, 8), np.float32), 2, 1) is None
        assert native.write_wav_native(str(tmp_path / "x.wav"), np.zeros(8), 8000) is False
