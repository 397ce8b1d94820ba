// Hand-written Hopper kernels of the flat-hash publish matcher.
//
// Replaces the jitted jnp graphs of the JAX package's mqtt_tpu/ops/flat.py:
//
//   K1 flat_probe_ranges   _packed_core + flat_match_ranges_core + _probe_head
//                          (flat.py:1007-1049, 913-950, 786-855)
//   K2 flat_match_compact  _compact_core + _segment_of_slot (flat.py:1052-1161)
//   K3 scatter_rows        _scatter_core (flat.py:1191-1196)
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// (mqtt_tpu_torch/ops/kernels.py loads it with ctypes). Every entry point
// launches on the caller's stream, never synchronises, allocates nothing
// (the wrapper hands in outputs and scratch) and returns cudaGetLastError().
//
// What bounds them on the card: all three move bytes and do little
// arithmetic. K1 is one random 64-byte bucket-row gather per active
// (topic, shape) probe plus the token rows and the output; the design keeps
// each probe to exactly one row read as four 16-byte loads and keeps the
// per-topic reduction (total, overflow) in a warp, so nothing but the
// packed output row returns to device memory. K2 adds an exclusive scan
// over the B*P counts (a tile scan, a scan of the tile sums, then a
// segment-parallel write) whose scratch is four ints per probe. K3 copies
// the whole table (the update is functional) and writes k rows. The probe
// (probe_one) and the block scan live in flat_probe.cuh, shared with
// sharded.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flat_probe.cuh"

namespace {

// One warp per topic; lane l takes shapes l, l+32, ... . start/cnt of
// probe (b, p) land at start_out[b*row_stride + p] / cnt_out[...]; the
// topic's total and overflow flag at total_out[b*tot_stride] and
// ovf_out[b*tot_stride]. last_seg (nullable) collects the index b*P+p of
// the last probe with a non-empty range.
__global__ void __launch_bounds__(kProbeThreads) probe_kernel(
    const int* __restrict__ tokens, int B, int W, int max_levels,
    const uint4* __restrict__ table, uint32_t slot_mask,
    const int* __restrict__ pat_kind, const int* __restrict__ pat_depth,
    const int* __restrict__ pat_mask, int P, int* __restrict__ start_out,
    int* __restrict__ cnt_out, long long row_stride, int* __restrict__ total_out,
    int* __restrict__ ovf_out, long long tot_stride, int* __restrict__ last_seg) {
  const long long b =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (b >= B) return;  // uniform across the warp
  const int L = (W - 2) / 2;
  const int* tok = tokens + b * W;
  const int n = tok[2 * L];
  const bool dollar = tok[2 * L + 1] != 0;
  int total = 0;
  bool ovf = false;
  int last = -1;
  for (int p = lane; p < P; p += kWarp) {
    const ProbeOut r = probe_one(tok, L, max_levels, n, dollar, table, slot_mask,
                                 static_cast<uint32_t>(pat_kind[p]), pat_depth[p],
                                 static_cast<uint32_t>(pat_mask[p]));
    start_out[b * row_stride + p] = r.start;
    cnt_out[b * row_stride + p] = r.cnt;
    total += r.cnt;
    ovf |= r.overflow;
    if (r.cnt > 0) last = p;
  }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    total += __shfl_xor_sync(kFull, total, o);
    last = max(last, __shfl_xor_sync(kFull, last, o));
  }
  ovf = __any_sync(kFull, ovf);
  if (lane == 0) {
    total_out[b * tot_stride] = total;
    ovf_out[b * tot_stride] = ovf ? 1 : 0;
    if (last_seg != nullptr && last >= 0)
      atomicMax(last_seg, static_cast<int>(b * P + last));
  }
}

// Pass 1: exclusive scan inside each tile of kScanThreads counts.
__global__ void __launch_bounds__(kScanThreads) scan_tiles_kernel(
    const int* __restrict__ cnt, long long N, int* __restrict__ offs,
    int* __restrict__ tile_sums) {
  const long long i = static_cast<long long>(blockIdx.x) * kScanThreads + threadIdx.x;
  const int v = i < N ? cnt[i] : 0;
  int tile_total;
  const int incl = block_inclusive_scan(v, &tile_total);
  if (i < N) offs[i] = incl - v;
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = tile_total;
}

// Pass 2 (one block): exclusive scan of the tile sums, in chunks with a
// running carry; the grand total is n_hits, written into the header.
__global__ void __launch_bounds__(kScanThreads) scan_tile_sums_kernel(
    int* __restrict__ tile_sums, int T, int* __restrict__ header, int capacity) {
  int carry = 0;
  for (int base = 0; base < T; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < T ? tile_sums[i] : 0;
    int chunk_total;
    const int incl = block_inclusive_scan(v, &chunk_total);
    if (i < T) tile_sums[i] = carry + incl - v;
    carry += chunk_total;
  }
  if (threadIdx.x == 0) {
    header[0] = carry;
    header[1] = carry > capacity ? 1 : 0;
  }
}

// Pass 3: each non-empty segment writes its sids into its slots below
// capacity. JAX's clip rule: when n_hits > capacity the last slot belongs
// to the LAST non-empty segment overall (scatter-max + cummax), whose
// value there is start[L] + (capacity-1 - offs[L]); every other segment
// leaves that slot alone.
__global__ void write_segments_kernel(
    const int* __restrict__ start, const int* __restrict__ cnt,
    const int* __restrict__ offs, const int* __restrict__ tile_sums, long long N,
    const int* __restrict__ header, const int* __restrict__ last_seg,
    int capacity, int* __restrict__ sids) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int c = cnt[i];
  if (c <= 0) return;
  const int off = offs[i] + tile_sums[i / kScanThreads];
  const int s = start[i];
  const bool clipped = header[0] > capacity;
  if (clipped && i == *last_seg) sids[capacity - 1] = s + (capacity - 1 - off);
  if (off >= capacity) return;
  const int end = min(off + c, clipped ? capacity - 1 : capacity);
  for (int k = off; k < end; ++k) sids[k] = s + (k - off);
}

// Pass 4: slots at and past n_hits read -1.
__global__ void fill_tail_kernel(const int* __restrict__ header, int capacity,
                                 int* __restrict__ sids) {
  const long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k < capacity && k >= header[0]) sids[k] = -1;
}

__global__ void copy_rows_kernel(const uint4* __restrict__ src,
                                 uint4* __restrict__ dst, long long n16) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n16; i += stride)
    dst[i] = src[i];
}

// One thread per 16-byte quarter of an updated row; indices outside
// [0, S) are dropped. Duplicate indices carry identical rows.
__global__ void scatter_rows_kernel(const int* __restrict__ idx, int k,
                                    const uint4* __restrict__ rows, int S,
                                    uint4* __restrict__ dst) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= 4LL * k) return;
  const int i = static_cast<int>(t / 4);
  const int q = static_cast<int>(t % 4);
  const int s = idx[i];
  if (s < 0 || s >= S) return;
  dst[static_cast<size_t>(s) * 4 + q] = rows[static_cast<size_t>(i) * 4 + q];
}

inline unsigned blocks_for(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace

extern "C" {

const char* fm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1: out[B, 2P+2] = starts | counts | total | overflow.
int fm_probe_ranges(const int* tokens, int B, int W, int max_levels,
                    const int* table, int S, const int* pat_kind,
                    const int* pat_depth, const int* pat_mask, int P, int* out,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long ow = 2LL * P + 2;
  probe_kernel<<<blocks_for(static_cast<long long>(B) * kWarp, kProbeThreads),
                 kProbeThreads, 0, st>>>(
      tokens, B, W, max_levels, reinterpret_cast<const uint4*>(table),
      static_cast<uint32_t>(S - 1), pat_kind, pat_depth, pat_mask, P, out,
      out + P, ow, out + 2 * P, out + 2 * P + 1, ow, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// K2: out[2 + 2B + capacity] = n_hits, batch_overflow | totals[B] |
// overflow[B] | sids[capacity]. scratch holds 3*B*P + ceil(B*P/1024) + 1
// ints. P >= 1 and B >= 1 (the wrapper writes the constant output
// otherwise).
int fm_match_compact(const int* tokens, int B, int W, int max_levels,
                     const int* table, int S, const int* pat_kind,
                     const int* pat_depth, const int* pat_mask, int P,
                     int capacity, int* out, int* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long N = static_cast<long long>(B) * P;
  const long long T = (N + kScanThreads - 1) / kScanThreads;
  int* start = scratch;
  int* cnt = start + N;
  int* offs = cnt + N;
  int* tile_sums = offs + N;
  int* last_seg = tile_sums + T;
  int* header = out;
  int* totals = out + 2;
  int* ovf = out + 2 + B;
  int* sids = out + 2 + 2LL * B;
  cudaError_t err = cudaMemsetAsync(last_seg, 0xFF, sizeof(int), st);  // -1
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_kernel<<<blocks_for(static_cast<long long>(B) * kWarp, kProbeThreads),
                 kProbeThreads, 0, st>>>(
      tokens, B, W, max_levels, reinterpret_cast<const uint4*>(table),
      static_cast<uint32_t>(S - 1), pat_kind, pat_depth, pat_mask, P, start,
      cnt, P, totals, ovf, 1, last_seg);
  scan_tiles_kernel<<<static_cast<unsigned>(T), kScanThreads, 0, st>>>(cnt, N, offs,
                                                                      tile_sums);
  scan_tile_sums_kernel<<<1, kScanThreads, 0, st>>>(tile_sums, static_cast<int>(T),
                                                    header, capacity);
  write_segments_kernel<<<blocks_for(N, 256), 256, 0, st>>>(
      start, cnt, offs, tile_sums, N, header, last_seg, capacity, sids);
  fill_tail_kernel<<<blocks_for(capacity, 256), 256, 0, st>>>(header, capacity, sids);
  return static_cast<int>(cudaGetLastError());
}

// K3: out = table with out[idx[i]] = rows[i] (functional: out is a new
// buffer the caller allocated).
int fm_scatter_rows(const int* table, int S, const int* idx, int k,
                    const int* rows, int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n16 = 4LL * S;
  const unsigned copy_blocks =
      static_cast<unsigned>(n16 < 132LL * 8 * 256 ? blocks_for(n16, 256) : 132 * 8);
  copy_rows_kernel<<<copy_blocks, 256, 0, st>>>(
      reinterpret_cast<const uint4*>(table), reinterpret_cast<uint4*>(out), n16);
  if (k > 0)
    scatter_rows_kernel<<<blocks_for(4LL * k, 256), 256, 0, st>>>(
        idx, k, reinterpret_cast<const uint4*>(rows), S,
        reinterpret_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
