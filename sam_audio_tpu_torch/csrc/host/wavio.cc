// Native audio I/O: WAV decode/encode, on the host.
//
// Role parity with the reference's native media layer (torchcodec, C++/FFmpeg;
// reference: sam_audio/processor.py:13). It decodes the WAVs that Python's
// `wave` module rejects (IEEE float, WAVE_FORMAT_EXTENSIBLE) without ffmpeg,
// and keeps the decode path off the Python interpreter for batch eval and
// serving. The same algorithm as sam_audio_tpu/runtime/wavio.cc. Built by
// sam_audio_tpu_torch/runtime/native.py with g++ at first use.
//
// Exposed C ABI (ctypes-friendly):
//   wav_read_info(path, *sr, *channels, *frames, *bits, *is_float) -> 0/err
//   wav_read_f32(path, out, max_samples) -> samples written (interleaved)
//   wav_write_pcm16(path, data, frames, channels, sr) -> 0/err

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct WavInfo {
  uint32_t sample_rate = 0;
  uint16_t channels = 0;
  uint16_t bits = 0;
  uint16_t format = 0;  // 1 = PCM, 3 = IEEE float
  uint32_t data_offset = 0;
  uint32_t data_bytes = 0;
};

bool parse_header(FILE* f, WavInfo* info) {
  char id[4];
  uint32_t size;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "RIFF", 4) != 0) return false;
  if (fread(&size, 4, 1, f) != 1) return false;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "WAVE", 4) != 0) return false;
  // chunk walk
  while (fread(id, 1, 4, f) == 4 && fread(&size, 4, 1, f) == 1) {
    if (memcmp(id, "fmt ", 4) == 0) {
      uint16_t fmt, ch;
      uint32_t sr, byte_rate;
      uint16_t block_align, bits;
      if (fread(&fmt, 2, 1, f) != 1) return false;
      if (fread(&ch, 2, 1, f) != 1) return false;
      if (fread(&sr, 4, 1, f) != 1) return false;
      if (fread(&byte_rate, 4, 1, f) != 1) return false;
      if (fread(&block_align, 2, 1, f) != 1) return false;
      if (fread(&bits, 2, 1, f) != 1) return false;
      info->format = fmt;
      info->channels = ch;
      info->sample_rate = sr;
      info->bits = bits;
      uint32_t consumed = 16;
      if (fmt == 0xFFFE && size >= 40) {
        // WAVE_FORMAT_EXTENSIBLE (ffmpeg >2ch, sox/DAW float WAVs): the
        // effective format code is the first 2 bytes of the SubFormat GUID.
        // Treating 0xFFFE as int PCM would reinterpret float bit patterns
        // as int32 and return near-zero garbage with no error.
        uint16_t cb, valid_bits, sub_fmt;
        uint32_t mask;
        if (fread(&cb, 2, 1, f) != 1) return false;
        if (fread(&valid_bits, 2, 1, f) != 1) return false;
        if (fread(&mask, 4, 1, f) != 1) return false;
        if (fread(&sub_fmt, 2, 1, f) != 1) return false;
        info->format = sub_fmt;
        consumed = 26;
      }
      if (size > consumed) fseek(f, size - consumed, SEEK_CUR);
    } else if (memcmp(id, "data", 4) == 0) {
      info->data_offset = static_cast<uint32_t>(ftell(f));
      info->data_bytes = size;
      return info->sample_rate != 0;
    } else {
      fseek(f, (size + 1) & ~1u, SEEK_CUR);  // chunks are word-aligned
    }
  }
  return false;
}

}  // namespace

extern "C" {

int wav_read_info(const char* path, int* sample_rate, int* channels,
                  long long* frames, int* bits, int* is_float) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  bool ok = parse_header(f, &info);
  fclose(f);
  if (!ok) return -2;
  int bytes_per = info.bits / 8;
  if (bytes_per == 0 || info.channels == 0) return -3;
  *sample_rate = static_cast<int>(info.sample_rate);
  *channels = info.channels;
  *frames = info.data_bytes / (bytes_per * info.channels);
  *bits = info.bits;
  *is_float = info.format == 3 ? 1 : 0;
  return 0;
}

// Decodes to float32 in [-1, 1], interleaved. Returns samples written or <0.
long long wav_read_f32(const char* path, float* out, long long max_samples) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!parse_header(f, &info)) {
    fclose(f);
    return -2;
  }
  int bytes_per = info.bits / 8;
  long long total = info.data_bytes / bytes_per;
  if (total > max_samples) total = max_samples;
  std::vector<uint8_t> raw(static_cast<size_t>(total) * bytes_per);
  fseek(f, info.data_offset, SEEK_SET);
  size_t got = fread(raw.data(), 1, raw.size(), f);
  fclose(f);
  total = static_cast<long long>(got / bytes_per);

  const uint8_t* p = raw.data();
  if (info.format != 1 && info.format != 3) {
    return -4;  // unresolved/unknown codec (e.g. ADPCM) — never guess PCM
  }
  if (info.format == 3 && info.bits != 32) {
    return -4;  // float64 etc. unsupported; fail instead of int-decoding
  }
  if (info.format == 3 && info.bits == 32) {
    memcpy(out, p, static_cast<size_t>(total) * 4);
  } else if (info.bits == 16) {
    const int16_t* s = reinterpret_cast<const int16_t*>(p);
    for (long long i = 0; i < total; ++i) out[i] = s[i] / 32768.0f;
  } else if (info.bits == 32) {
    const int32_t* s = reinterpret_cast<const int32_t*>(p);
    for (long long i = 0; i < total; ++i) out[i] = s[i] / 2147483648.0f;
  } else if (info.bits == 24) {
    for (long long i = 0; i < total; ++i) {
      int32_t v = p[3 * i] | (p[3 * i + 1] << 8) | (p[3 * i + 2] << 16);
      if (v >= (1 << 23)) v -= (1 << 24);
      out[i] = v / 8388608.0f;
    }
  } else if (info.bits == 8) {
    for (long long i = 0; i < total; ++i) out[i] = (p[i] - 128) / 128.0f;
  } else {
    return -4;
  }
  return total;
}

int wav_write_pcm16(const char* path, const float* data, long long frames,
                    int channels, int sample_rate) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  long long n = frames * channels;
  uint32_t data_bytes = static_cast<uint32_t>(n * 2);
  uint32_t riff_size = 36 + data_bytes;
  uint16_t fmt = 1, ch = static_cast<uint16_t>(channels), bits = 16;
  uint32_t sr = static_cast<uint32_t>(sample_rate);
  uint32_t byte_rate = sr * channels * 2;
  uint16_t block_align = static_cast<uint16_t>(channels * 2);
  uint32_t fmt_size = 16;
  fwrite("RIFF", 1, 4, f);
  fwrite(&riff_size, 4, 1, f);
  fwrite("WAVE", 1, 4, f);
  fwrite("fmt ", 1, 4, f);
  fwrite(&fmt_size, 4, 1, f);
  fwrite(&fmt, 2, 1, f);
  fwrite(&ch, 2, 1, f);
  fwrite(&sr, 4, 1, f);
  fwrite(&byte_rate, 4, 1, f);
  fwrite(&block_align, 2, 1, f);
  fwrite(&bits, 2, 1, f);
  fwrite("data", 1, 4, f);
  fwrite(&data_bytes, 4, 1, f);
  std::vector<int16_t> pcm(static_cast<size_t>(n));
  for (long long i = 0; i < n; ++i) {
    float v = data[i] * 32767.0f;
    if (v > 32767.0f) v = 32767.0f;
    if (v < -32768.0f) v = -32768.0f;
    pcm[static_cast<size_t>(i)] = static_cast<int16_t>(v);
  }
  fwrite(pcm.data(), 2, static_cast<size_t>(n), f);
  fclose(f);
  return 0;
}

}  // extern "C"
