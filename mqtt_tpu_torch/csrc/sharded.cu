// Hand-written Hopper kernels of the subscription-sharded matcher.
//
// Replaces the jitted jnp graphs of the JAX package's sharded path:
//
//   K7/K8 match_slots   flat_match_core (mqtt_tpu/ops/flat.py:858-910) and
//                       the shard_map'd step_fn around it
//                       (mqtt_tpu/parallel/sharded.py:631-645): every
//                       shard's probe of one batch tile, expanded to K sid
//                       slots, written straight into the gathered
//                       [S, b, K] layout (on one card the all_gather over
//                       the subs axis is that write)
//   K9 tile_compact     _tile_compact_core (mqtt_tpu/parallel/sharded.py:
//                       93-139) with _segment_of_slot's clip rule
//                       (mqtt_tpu/ops/flat.py:1139-1162)
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// (mqtt_tpu_torch/ops/kernels.py loads it with ctypes). Every entry point
// launches on the caller's stream, never synchronises, allocates nothing
// (the wrapper hands in outputs and scratch) and returns cudaGetLastError().
//
// What bounds them on the card: both move bytes. match_slots reads the
// token rows, one 64-byte bucket row per active probe (probe_one from
// flat_probe.cuh, shared with K1/K2) and writes S*B*K slots; one warp per
// (shard, topic) keeps the probe's prefix sum in registers (a warp scan of
// the counts), so each lane writes its own range's slots and nothing but
// the slot row, the total and the flag reach device memory. JAX's [B, K, P]
// one-hot is a way to say the expansion in jnp, not part of the function,
// and is not carried over. tile_compact reads the [S, b] totals once per
// tile (one block scans them in shared memory: int32, as JAX's cumsum of
// int32 stays int32), then a slot-parallel pass finds each output slot's
// segment by binary search over the scanned offsets and gathers its sid.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flat_probe.cuh"

namespace {

constexpr int kSlotThreads = 256;

// One warp per (shard, topic): blockIdx.y is the shard, lane l takes the
// shapes l, l+32, ... of that shard's (padded) pattern row. Slot k of the
// row is start_p + (k - prev_p) for the probe p whose range [prev_p,
// prev_p + cnt_p) holds k, and -1 past the total. totals are not clipped;
// overflow = saturated probe | spilled hit | totals > ovf_limit.
__global__ void __launch_bounds__(kProbeThreads) match_slots_kernel(
    const int* __restrict__ tokens, int B, int W, int max_levels,
    const uint4* __restrict__ tables, long long NB, uint32_t slot_mask,
    const int* __restrict__ pat_kind, const int* __restrict__ pat_depth,
    const int* __restrict__ pat_mask, int P, int K, int ovf_limit,
    int* __restrict__ out, int* __restrict__ totals,
    uint8_t* __restrict__ overflow) {
  const long long s = blockIdx.y;
  const long long b =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (b >= B) return;  // uniform across the warp
  const int L = (W - 2) / 2;
  const int* tok = tokens + b * W;
  const int n = tok[2 * L];
  const bool dollar = tok[2 * L + 1] != 0;
  const uint4* table = tables + s * NB * 4;
  const int* kind = pat_kind + s * P;
  const int* depth = pat_depth + s * P;
  const int* mask = pat_mask + s * P;
  int* row = out + (s * B + b) * K;
  int carry = 0;  // hits of the probes before this chunk
  bool ovf = false;
  for (int base = 0; base < P; base += kWarp) {
    const int p = base + lane;
    ProbeOut r{0, 0, false};
    if (p < P)
      r = probe_one(tok, L, max_levels, n, dollar, table, slot_mask,
                    static_cast<uint32_t>(kind[p]), depth[p],
                    static_cast<uint32_t>(mask[p]));
    ovf |= r.overflow;
    int incl = r.cnt;
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int prev = carry + incl - r.cnt;
    const int end = min(prev + r.cnt, K);
    for (int k = prev; k < end; ++k) row[k] = r.start + (k - prev);
    carry += __shfl_sync(kFull, incl, kWarp - 1);
  }
  for (int k = min(carry, K) + lane; k < K; k += kWarp) row[k] = -1;
  ovf = __any_sync(kFull, ovf);
  if (lane == 0) {
    totals[s * B + b] = carry;
    overflow[s * B + b] = (ovf || carry > ovf_limit) ? 1 : 0;
  }
}

// K9 pass 1, one block per tile. Segment j = i*S + s (topic-major,
// shard-minor) holds min(totals[s, i], K) pairs; cum[j] is the inclusive
// prefix sum over the tile. Also the row's header and its per-topic
// columns: per_topic[i] = sum_s min(totals[s, i], K), ovf_topic[i] =
// any_s overflow[s, i].
__global__ void __launch_bounds__(kScanThreads) tile_scan_kernel(
    const int* __restrict__ totals, const uint8_t* __restrict__ overflow,
    int S, int bl, int K, int cap, int* __restrict__ cum,
    int* __restrict__ rows, long long row_w) {
  const long long t = blockIdx.x;
  const int* tot = totals + t * S * bl;
  const uint8_t* ovf = overflow + t * S * bl;
  const int n_segs = S * bl;
  int* c = cum + t * n_segs;
  int* row = rows + t * row_w;
  int carry = 0;
  for (int base = 0; base < n_segs; base += kScanThreads) {
    const int j = base + threadIdx.x;
    const int v = j < n_segs ? min(tot[(j % S) * bl + j / S], K) : 0;
    int chunk_total;
    const int incl = block_inclusive_scan(v, &chunk_total);
    if (j < n_segs) c[j] = carry + incl;
    carry += chunk_total;
  }
  for (int i = threadIdx.x; i < bl; i += kScanThreads) {
    int sum = 0;
    int any = 0;
    for (int s = 0; s < S; ++s) {
      sum += min(tot[s * bl + i], K);
      any |= ovf[s * bl + i];
    }
    row[2 + i] = sum;
    row[2 + bl + i] = any ? 1 : 0;
  }
  if (threadIdx.x == 0) {
    row[0] = carry;
    row[1] = carry > cap ? 1 : 0;
  }
}

// First j in [0, n) with c[j] > x (strict = true) or c[j] >= x.
__device__ __forceinline__ int search(const int* __restrict__ c, int n, int x,
                                      bool strict) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int v = c[mid];
    if (strict ? v > x : v >= x)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// K9 pass 2, slot-parallel over (cap slots, tiles). Slot k < n_hits reads
// the segment whose range holds it; on an overflowing tile the last slot
// belongs to the LAST non-empty segment overall (JAX's scatter-max +
// cummax), whose local slot k - offs may be negative: the gather adds K
// once and clamps to [0, K-1], as jnp indexing does.
__global__ void __launch_bounds__(kSlotThreads) tile_pairs_kernel(
    const int* __restrict__ out, const int* __restrict__ cum, int S, int bl,
    int K, int cap, int* __restrict__ rows, long long row_w) {
  const long long t = blockIdx.y;
  const int k = blockIdx.x * kSlotThreads + threadIdx.x;
  if (k >= cap) return;
  const int n_segs = S * bl;
  const int* c = cum + t * n_segs;
  int* row = rows + t * row_w;
  int* pair_shard = row + 2 + 2LL * bl;
  int* pair_sid = pair_shard + cap;
  const int n_hits = c[n_segs - 1];
  if (k >= n_hits) {
    pair_shard[k] = -1;
    pair_sid[k] = -1;
    return;
  }
  const bool clipped = k == cap - 1 && n_hits > cap;
  const int seg = clipped ? search(c, n_segs, n_hits, false) : search(c, n_segs, k, true);
  const int offs = seg > 0 ? c[seg - 1] : 0;
  int slot = min(k - offs, K - 1);
  if (slot < 0) slot = max(slot + K, 0);
  const int s = seg % S;
  const int i = seg / S;
  pair_shard[k] = s;
  pair_sid[k] = out[((t * S + s) * bl + i) * static_cast<long long>(K) + slot];
}

inline unsigned blocks_for(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace

extern "C" {

const char* sh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K7/K8: every shard of the stack tables[S, NB, 16] (patterns [S, P]) on
// the B topics of tokens[B, 2L+2] -> out[S, B, K], totals[S, B],
// overflow[S, B] (bytes 0/1). ovf_slots 0 means K.
int sh_match_slots(const int* tokens, int B, int W, int max_levels,
                   const int* tables, int S, int NB, const int* pat_kind,
                   const int* pat_depth, const int* pat_mask, int P, int K,
                   int ovf_slots, int* out, int* totals, void* overflow,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_for(static_cast<long long>(B) * kWarp, kProbeThreads),
                  static_cast<unsigned>(S));
  match_slots_kernel<<<grid, kProbeThreads, 0, st>>>(
      tokens, B, W, max_levels, reinterpret_cast<const uint4*>(tables), NB,
      static_cast<uint32_t>(NB - 1), pat_kind, pat_depth, pat_mask, P, K,
      ovf_slots != 0 ? ovf_slots : K, out, totals,
      static_cast<uint8_t*>(overflow));
  return static_cast<int>(cudaGetLastError());
}

// K9: T tiles of out[T, S, bl, K], totals[T, S, bl], overflow[T, S, bl]
// -> rows[T, 2 + 2*bl + 2*cap]. scratch holds T*S*bl ints.
int sh_tile_compact(const int* out, const int* totals, const void* overflow,
                    int T, int S, int bl, int K, int cap, int* rows,
                    int* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long row_w = 2 + 2LL * bl + 2LL * cap;
  tile_scan_kernel<<<static_cast<unsigned>(T), kScanThreads, 0, st>>>(
      totals, static_cast<const uint8_t*>(overflow), S, bl, K, cap, scratch,
      rows, row_w);
  const dim3 grid(blocks_for(cap, kSlotThreads), static_cast<unsigned>(T));
  tile_pairs_kernel<<<grid, kSlotThreads, 0, st>>>(out, scratch, S, bl, K, cap,
                                                   rows, row_w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
