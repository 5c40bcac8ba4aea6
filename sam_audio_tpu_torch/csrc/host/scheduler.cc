// Native serving scheduler: length-bucketed batch assembly, on the host.
//
// Serving groups requests into few, well-packed (batch, length-bucket)
// shapes. This C++ scheduler does the bookkeeping off the GIL: given item
// lengths, it assigns each to a bucket (a fixed grid of hop multiples) and
// emits batch groups of one bucket each. The same algorithm as
// sam_audio_tpu/runtime/scheduler.cc.
//
// C ABI:
//   bucket_for_length(length, hop, bucket_steps) -> bucketed length
//   plan_batches(lengths, n, hop, bucket_steps, max_batch,
//                out_bucket, out_order) -> n_batches
//     out_bucket[i]: bucketed length of batch i's items
//     out_order: permutation of [0, n) grouped by batch, batches
//                delimited by out_batch_sizes
//   (see native.py for the ctypes wrapper)

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Round `length` up to a multiple of hop * bucket_steps.
long long bucket_for_length(long long length, long long hop,
                            long long bucket_steps) {
  long long unit = hop * bucket_steps;
  if (unit <= 0) return length;
  return ((length + unit - 1) / unit) * unit;
}

// Groups items into batches of <= max_batch sharing one bucketed length.
// lengths: (n,) int64. out_order: (n,) item indices grouped by batch.
// out_batch_sizes: (n,) per-batch item counts (only first n_batches valid).
// out_buckets: (n,) per-batch bucketed length. Returns n_batches.
long long plan_batches(const long long* lengths, long long n, long long hop,
                       long long bucket_steps, long long max_batch,
                       long long* out_order, long long* out_batch_sizes,
                       long long* out_buckets) {
  std::vector<std::pair<long long, long long>> items;  // (bucket, idx)
  items.reserve(static_cast<size_t>(n));
  for (long long i = 0; i < n; ++i) {
    items.emplace_back(bucket_for_length(lengths[i], hop, bucket_steps), i);
  }
  std::stable_sort(items.begin(), items.end());
  long long n_batches = 0;
  long long pos = 0;
  size_t i = 0;
  while (i < items.size()) {
    long long bucket = items[i].first;
    long long count = 0;
    while (i < items.size() && items[i].first == bucket &&
           count < max_batch) {
      out_order[pos++] = items[i].second;
      ++count;
      ++i;
    }
    out_batch_sizes[n_batches] = count;
    out_buckets[n_batches] = bucket;
    ++n_batches;
  }
  return n_batches;
}

// Padding-waste statistic for a plan: sum(bucket - length) / sum(bucket).
double padding_waste(const long long* lengths, long long n, long long hop,
                     long long bucket_steps) {
  double pad = 0.0, total = 0.0;
  for (long long i = 0; i < n; ++i) {
    long long b = bucket_for_length(lengths[i], hop, bucket_steps);
    pad += static_cast<double>(b - lengths[i]);
    total += static_cast<double>(b);
  }
  return total > 0 ? pad / total : 0.0;
}

}  // extern "C"
