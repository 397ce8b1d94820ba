// The probe, scan and look-back helpers shared by the port's matcher
// kernels: flat_match.cu (K1-K3) and sharded.cu (K7-K9) both include this
// header.
//
// probe_lanes is the lane mapping K1, K2 and K7/K8 share. probe_one is the
// device half of the JAX package's _probe_head (mqtt_tpu/ops/flat.py:
// 786-855): one (topic, shape) probe of the flat-hash table, bit for bit.
// block_inclusive_scan is the block-wide int32 prefix sum K9 scans a
// block's segments with. look_back and its status words are the
// single-pass scan across CUDA blocks that K2 and K9 share (a decoupled
// look-back over blocks numbered by an atomic ticket).

#pragma once

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM1 = 0x9E3779B1u;
constexpr uint32_t kM2 = 0x85EBCA77u;
constexpr uint32_t kPlus1 = 0x9E3779B9u;
constexpr uint32_t kPlus2 = 0xC2B2AE3Du;
constexpr uint32_t kKindHash = 0x27D4EB2Fu;
constexpr uint32_t kCntMask = 63u;
constexpr int kNregShift = 6;
constexpr int kNinlShift = 12;
constexpr int kTopWildShift = 18;
constexpr int kLastPlusShift = 19;
constexpr int kSpillShift = 20;
constexpr int kSatShift = 21;

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t mix(uint32_t h, uint32_t t) {
  uint32_t x = h ^ t;
  x = (x << 13) | (x >> 19);
  return x * kM1;
}

// Lanes per topic where lanes map to (topic, pattern) probes (K1, K2, K7/K8): the
// pattern count rounded up to a power of two, at most a warp. A warp then
// takes kWarp / probe_lanes(P) whole topics; its lanes reduce a topic's
// total over an aligned group of that many lanes.
__host__ __device__ __forceinline__ int probe_lanes(int P) {
  int w = 1;
  while (w < P && w < kWarp) w <<= 1;
  return w;
}

struct ProbeOut {
  int start;
  int cnt;
  bool overflow;
};

// One (topic, shape) probe: the dual u32 whole-path hash with the '+'
// sentinels, ONE bucket-row gather (4 x uint4), the 4-way key compare, the
// meta decode and the '#'/'$' rules — bit for bit the JAX probe head,
// including start = base + lo on an invalidated '#' hit and start = 0 on a
// miss or an inactive probe.
__device__ __forceinline__ ProbeOut probe_one(
    const int* __restrict__ tok, int L, int max_levels, int n, bool dollar,
    const uint4* __restrict__ table, uint32_t slot_mask, uint32_t kind,
    int depth, uint32_t plus_mask) {
  ProbeOut r{0, 0, false};
  const bool hash_pat = kind == kKindHash;
  const bool exact_len = depth == n;
  const bool active = hash_pat ? (depth <= n) : exact_len;
  if (!active) return r;  // pads (depth -1) and shapes of other depths
  const uint32_t kd = static_cast<uint32_t>(depth);
  uint32_t h1 = (kd * kM2) ^ kind;
  uint32_t h2 = (kd * kM1) ^ kind;
  for (int d = 0; d < max_levels && d < depth; ++d) {
    const bool plus = d < 32 && ((plus_mask >> d) & 1u);
    const uint32_t t1 = plus ? kPlus1 : static_cast<uint32_t>(tok[d]);
    const uint32_t t2 = plus ? kPlus2 : static_cast<uint32_t>(tok[L + d]);
    h1 = mix(h1, t1);
    h2 = mix(h2, t2);  // lane 2 multiplies by M1 too (flat.py:816)
  }
  const uint4* row = table + static_cast<size_t>(h1 & slot_mask) * 4;
  uint32_t meta = 0, base = 0;
  bool hit = false;
  bool sat = false;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint4 v = __ldg(row + e);
    if (e == 0) sat = (v.z >> kSatShift) & 1u;  // entry-0 meta only
    if (v.x == h1 && v.y == h2) {
      hit = true;
      meta = max(meta, v.z);
      base = max(base, v.w);
    }
  }
  const int ncli = static_cast<int>(meta & kCntMask);
  const int nreg = static_cast<int>((meta >> kNregShift) & kCntMask);
  const int ninl = static_cast<int>((meta >> kNinlShift) & kCntMask);
  const bool top_wild = (meta >> kTopWildShift) & 1u;
  const bool last_plus = (meta >> kLastPlusShift) & 1u;
  const bool spill = (meta >> kSpillShift) & 1u;
  // 'filter/#' matching its exact depth: only via a literal last level
  // (topics.go:612), and without the inline tail (topics.go:615)
  const bool valid = hit && !(hash_pat && exact_len && last_plus);
  int count = (hash_pat && exact_len) ? nreg : nreg + ninl;
  if (!valid) count = 0;
  // $-topics skip the client prefix of top-level-wildcard entries
  const int lo = (dollar && top_wild) ? min(ncli, count) : 0;
  r.cnt = count - lo;
  r.start = static_cast<int>(base) + lo;
  r.overflow = sat || (spill && valid);
  return r;
}

// Inclusive scan of v over the block (blockDim.x a multiple of 32, at
// most 1024); the block's sum goes to *block_total. Two __syncthreads,
// shared scratch of one int per warp.
__device__ __forceinline__ int block_inclusive_scan(int v, int* block_total) {
  __shared__ int warp_sums[kWarp];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int n_warps = blockDim.x / kWarp;
  int x = v;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == kWarp - 1) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < n_warps) warp_sums[lane] = w;
  }
  __syncthreads();
  const int incl = x + (warp > 0 ? warp_sums[warp - 1] : 0);
  *block_total = warp_sums[n_warps - 1];
  __syncthreads();  // warp_sums is reused by the caller's next scan
  return incl;
}

// The single-pass scan across CUDA blocks (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016). A
// block's 64-bit status word holds the launch's epoch (bits 33-63), an
// inclusive flag (bit 32) and a count (bits 0-31): its own aggregate, or,
// once inclusive, the sum of every block up to and including it. The epoch
// tags the words of this launch, so the scratch needs no reset between
// launches on one stream.
constexpr unsigned long long kFlagInclusive = 1ull << 32;
constexpr int kLookback = 8;       // statuses per lane per look-back round

__device__ __forceinline__ unsigned long long status_word(unsigned epoch, bool inclusive, int value) {
  return (static_cast<unsigned long long>(epoch) << 33) | (inclusive ? kFlagInclusive : 0ull) |
         static_cast<unsigned int>(value);
}

__device__ __forceinline__ unsigned long long load_status(unsigned long long* s) {
  return cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>(*s).load(
      cuda::memory_order_relaxed);
}

__device__ __forceinline__ void store_status(unsigned long long* s, unsigned long long v) {
  cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>(*s).store(
      v, cuda::memory_order_relaxed);
}

// Warp 0's look-back for tile > 0: lane l reads the statuses of tiles
// j - 8l .. j - 8l - 7, all loads in flight together; the round ends once
// every tile nearer than the nearest inclusive status has published (the
// unpublished ones are re-read after a short sleep). Returns the sum of the
// predecessors' counts. A tile waits only on tiles whose tickets came
// before its own, which were running when it took its ticket.
__device__ __forceinline__ int look_back(unsigned long long* status, int tile, unsigned epoch, int lane) {
  int excl = 0;
  for (int j = tile - 1;; j -= kWarp * kLookback) {
    unsigned long long st[kLookback];
#pragma unroll
    for (int m = 0; m < kLookback; ++m) {
      const int idx = j - (lane * kLookback + m);
      st[m] = idx >= 0 ? load_status(status + idx) : status_word(epoch, true, 0);
    }
    while (true) {
      int first = INT_MAX;  // the lane's nearest published inclusive status
#pragma unroll
      for (int m = 0; m < kLookback; ++m)
        if (first == INT_MAX && static_cast<unsigned>(st[m] >> 33) == epoch && (st[m] & kFlagInclusive))
          first = lane * kLookback + m;
#pragma unroll
      for (int o = kWarp / 2; o > 0; o >>= 1) first = min(first, __shfl_xor_sync(kFull, first, o));
      bool ready = true;
#pragma unroll
      for (int m = 0; m < kLookback; ++m)
        if (lane * kLookback + m < first && static_cast<unsigned>(st[m] >> 33) != epoch) ready = false;
      if (__all_sync(kFull, ready)) {
        int v = 0;
#pragma unroll
        for (int m = 0; m < kLookback; ++m)
          if (lane * kLookback + m <= first) v += static_cast<int>(static_cast<unsigned int>(st[m]));
#pragma unroll
        for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
        excl += v;
        if (first != INT_MAX) return excl;
        break;
      }
      __nanosleep(100);
#pragma unroll
      for (int m = 0; m < kLookback; ++m)
        if (lane * kLookback + m < first && static_cast<unsigned>(st[m] >> 33) != epoch)
          st[m] = load_status(status + (j - (lane * kLookback + m)));
    }
  }
}

}  // namespace
