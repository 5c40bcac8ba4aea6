// Native polyphase sinc resampler, on the host.
//
// Same numerics as ops/resample.py (torchaudio-equivalent bandlimited sinc,
// hann window, lowpass_filter_width 6, rolloff 0.99), in C++ for host-side
// preprocessing throughput: ingest resamples on the CPU while the card runs
// the DiT. The same algorithm as sam_audio_tpu/runtime/resample.cc.
//
// C ABI:
//   resample_kernel_size(orig, new, width_out, phases_out, taps_out)
//   resample_f32(in, n_in, orig, new, out, max_out) -> samples written

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <numeric>
#include <utility>
#include <vector>

namespace {

struct Kernel {
  std::vector<float> taps;  // (phases, width_taps)
  int width = 0;            // left pad
  int n_taps = 0;
  int orig = 0;
  int new_freq = 0;
};

int gcd_int(int a, int b) { return b == 0 ? a : gcd_int(b, a % b); }

Kernel build_kernel(int orig_freq, int new_freq, int lowpass_width = 6,
                    double rolloff = 0.99) {
  Kernel k;
  int g = gcd_int(orig_freq, new_freq);
  int orig = orig_freq / g, nf = new_freq / g;
  double base_freq = std::min(orig, nf) * rolloff;
  int width = static_cast<int>(std::ceil(lowpass_width * orig / base_freq));
  int n_taps = 2 * width + orig;
  k.taps.resize(static_cast<size_t>(nf) * n_taps);
  for (int p = 0; p < nf; ++p) {
    for (int j = 0; j < n_taps; ++j) {
      double idx = (j - width) / static_cast<double>(orig);
      double t = (-static_cast<double>(p) / nf + idx) * base_freq;
      if (t < -lowpass_width) t = -lowpass_width;
      if (t > lowpass_width) t = lowpass_width;
      double window = std::cos(t * M_PI / lowpass_width / 2.0);
      window *= window;
      double tp = t * M_PI;
      double sinc = tp == 0.0 ? 1.0 : std::sin(tp) / tp;
      k.taps[static_cast<size_t>(p) * n_taps + j] =
          static_cast<float>(sinc * window * (base_freq / orig));
    }
  }
  k.width = width;
  k.n_taps = n_taps;
  k.orig = orig;
  k.new_freq = nf;
  return k;
}

// Per-(orig, new) kernel cache, mirroring the Python twin's lru_cache
// (ops/resample._sinc_kernel): resample_native loops batch rows in Python
// with one resample_f32 call per row, and rebuilding the O(phases * taps)
// trig table per row erodes exactly the host throughput this path is for.
const Kernel& cached_kernel(int orig_freq, int new_freq) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, Kernel> cache;
  std::lock_guard<std::mutex> lock(mu);
  auto key = std::make_pair(orig_freq, new_freq);
  auto it = cache.find(key);
  if (it == cache.end()) {
    // no eviction: entries are immutable after insert and std::map never
    // invalidates references on insert, so returned refs stay valid for
    // the process lifetime (realistic workloads see a handful of rates)
    it = cache.emplace(key, build_kernel(orig_freq, new_freq)).first;
  }
  return it->second;
}

}  // namespace

extern "C" {

long long resample_out_size(long long n_in, int orig_freq, int new_freq) {
  int g = gcd_int(orig_freq, new_freq);
  long long orig = orig_freq / g, nf = new_freq / g;
  return (n_in * nf + orig - 1) / orig;  // ceil
}

// in: (n_in,) mono float32. Returns number of output samples or <0 on error.
long long resample_f32(const float* in, long long n_in, int orig_freq,
                       int new_freq, float* out, long long max_out) {
  if (orig_freq == new_freq) {
    long long n = n_in < max_out ? n_in : max_out;
    memcpy(out, in, static_cast<size_t>(n) * 4);
    return n;
  }
  const Kernel& k = cached_kernel(orig_freq, new_freq);
  long long target = resample_out_size(n_in, orig_freq, new_freq);
  if (target > max_out) target = max_out;
  // output sample m corresponds to phase p = m % nf, input frame
  // i0 = (m / nf) * orig; taps cover in[i0 - width .. i0 - width + n_taps)
  for (long long m = 0; m < target; ++m) {
    int p = static_cast<int>(m % k.new_freq);
    long long i0 = (m / k.new_freq) * k.orig - k.width;
    const float* taps = &k.taps[static_cast<size_t>(p) * k.n_taps];
    double acc = 0.0;
    int j_start = i0 < 0 ? static_cast<int>(-i0) : 0;
    long long j_end = k.n_taps;
    if (i0 + j_end > n_in) j_end = n_in - i0;
    for (long long j = j_start; j < j_end; ++j) {
      acc += static_cast<double>(taps[j]) * in[i0 + j];
    }
    out[m] = static_cast<float>(acc);
  }
  return target;
}

}  // extern "C"
