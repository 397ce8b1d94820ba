// Hand-written Hopper kernels of the flat-hash publish matcher.
//
// Replaces the jitted jnp graphs of the JAX package's mqtt_tpu/ops/flat.py:
//
//   K1 flat_probe_ranges   _packed_core + flat_match_ranges_core + _probe_head
//                          (flat.py:1007-1049, 913-950, 786-855)
//   K2 flat_match_compact  _compact_core + _segment_of_slot (flat.py:1052-1161)
//   K3 scatter_rows        _scatter_core (flat.py:1191-1196), in place
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// (mqtt_tpu_torch/ops/kernels.py loads it with ctypes). Every entry point
// launches on the caller's stream, never synchronises, allocates nothing
// (the wrapper hands in outputs and scratch) and returns cudaGetLastError().
//
// What bounds them on the card: all three move bytes and do little
// arithmetic. K1 is one random 64-byte bucket-row gather per active
// (topic, shape) probe plus the token rows and the output; at the path's
// batches it is latency-bound: a token-row read, the hash, then the
// dependent row gather. The design gives each (topic, pattern) probe its
// own lane (at P = 4 a warp probes eight topics), reads a warp's token rows
// in one coalesced copy into shared memory before any lane hashes, keeps
// each probe to exactly one row read as four 16-byte loads, reduces the
// total and the overflow flag over the topic's lanes, and writes the
// warp's output rows, one contiguous run, straight from the lanes (staging
// them through shared memory first was slower on the H100). K2 adds an
// exclusive scan over the B*P counts and the compacted write; it is
// latency-bound the same way, so it runs as ONE launch with no memset:
// each CUDA block probes a tile of topics with K1's lane mapping, keeps
// the tile's starts and counts in shared memory, takes its exclusive
// offset by a decoupled look-back over tiles numbered by an atomic
// ticket, writes its segments (a warp striding over each range, so the
// stores coalesce), and the last block to finish writes the header and
// the clip slot; the -1 tail is shared by the blocks that finish after the
// last tile's prefix is known. A batch that fits one block of 32 warps
// (128 topics at P = 8) skips the ticket, the look-back and the done
// counter. Its scratch is four ints per tile. K3 writes k rows into the
// table it is given and copies nothing: a departure from _scatter_core,
// whose table.at[idx].set(rows) makes a new table. The matcher keeps two
// buffers of its table (ops/matcher.py, TorchMatcher.fold) and writes the
// one no batch reads, so the fold moves k x 64 bytes (32 KB at k = 512)
// where the functional copy moved the whole table each way (64 MB at
// S = 2^20); its bytes are k indices, k rows read, k rows written, one
// 16-byte load and store a thread. The probe (probe_one),
// the lane mapping (probe_lanes) and the look-back live in
// flat_probe.cuh, shared with sharded.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flat_probe.cuh"

namespace {

constexpr int kProbeWarps = 4;         // K1: warps a block
constexpr int kCopyInts = 8;           // K1: token ints a lane loads per pass

// K1. Lanes map to (topic, pattern) probes as K2's do: a warp takes G =
// 32 / Pw whole topics, Pw = probe_lanes(P), lane l probing patterns
// l % Pw, l % Pw + 32, ... of topic l / Pw (lanes past P idle, and past B
// probe nothing). The warp first copies its G token rows (G * W ints, one
// contiguous run) into its shared memory with coalesced loads, so no lane
// re-reads a row from L2 for the hash; the pattern fields of its first
// probe are loaded before that copy. The warp's G output rows are one
// contiguous run of G * (2P+2) ints: a store instruction covers the
// starts (or the counts) of all G topics. out holds [B, 2P+2] rows:
// starts | counts | total | overflow.
__global__ void __launch_bounds__(kProbeWarps * kWarp) probe_kernel(
    const int* __restrict__ tokens, int B, int W, int max_levels,
    const uint4* __restrict__ table, uint32_t slot_mask,
    const int* __restrict__ pat_kind, const int* __restrict__ pat_depth,
    const int* __restrict__ pat_mask, int P, int* __restrict__ out) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int Pw = probe_lanes(P);
  const int G = kWarp / Pw;
  const long long ow = 2LL * P + 2;
  int* s_tok = smem + warp * G * W;
  const long long b0 = (static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) + warp) * G;
  if (b0 >= B) return;  // uniform across the warp
  const int nb = static_cast<int>(min(static_cast<long long>(G), B - b0));
  const int t = lane / Pw;
  int p = lane % Pw;
  uint32_t kind = 0, pmask = 0;
  int depth = -1;
  if (p < P) {
    kind = static_cast<uint32_t>(pat_kind[p]);
    depth = pat_depth[p];
    pmask = static_cast<uint32_t>(pat_mask[p]);
  }
  // the copy: each pass issues all its loads before its first store, so a
  // warp's rows (144 ints at P = 4, L = 8) arrive in one round trip
  const int* src = tokens + b0 * W;
  const int n_tok = nb * W;
  for (int base = 0; base < n_tok; base += kWarp * kCopyInts) {
    int v[kCopyInts];
#pragma unroll
    for (int u = 0; u < kCopyInts; ++u) {
      const int i = base + u * kWarp + lane;
      v[u] = i < n_tok ? src[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kCopyInts; ++u) {
      const int i = base + u * kWarp + lane;
      if (i < n_tok) s_tok[i] = v[u];
    }
  }
  __syncwarp();
  int total = 0;
  bool ovf = false;
  int* dst = out + (b0 + t) * ow;
  if (t < nb) {
    const int L = (W - 2) / 2;
    const int* tok = s_tok + t * W;
    const int n = tok[2 * L];
    const bool dollar = tok[2 * L + 1] != 0;
    while (p < P) {
      const ProbeOut r = probe_one(tok, L, max_levels, n, dollar, table, slot_mask, kind, depth, pmask);
      dst[p] = r.start;
      dst[P + p] = r.cnt;
      total += r.cnt;
      ovf |= r.overflow;
      p += kWarp;
      if (p < P) {
        kind = static_cast<uint32_t>(pat_kind[p]);
        depth = pat_depth[p];
        pmask = static_cast<uint32_t>(pat_mask[p]);
      }
    }
  }
  // the topic's total and flag over its aligned group of Pw lanes
  for (int o = Pw / 2; o > 0; o >>= 1) {
    total += __shfl_xor_sync(kFull, total, o);
    ovf |= __shfl_xor_sync(kFull, ovf, o);
  }
  if (lane % Pw == 0 && t < nb) {
    dst[2 * P] = total;
    dst[2 * P + 1] = ovf ? 1 : 0;
  }
}

// K2 in one launch. Lanes map to (topic, pattern) probes: for P <= 32 a
// warp takes G = 32 / P whole topics, lane l probing pattern l % P of topic
// l / P, so all 32 lanes probe (P is a power of two); for P > 32 a warp
// takes one topic and its lanes stride over the patterns. CUDA block t (by
// ticket) takes topics [t*W*G, (t+1)*W*G), W = blockDim.x / 32; smem holds
// their starts and counts. The decoupled look-back (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016;
// look_back and its status words are in flat_probe.cuh, shared with K9)
// gives the tile its exclusive offset. The scratch (see fm_match_compact) holds
// the ticket, the done counter, the last non-empty tile (+1) and the tail
// cursor, then per tile a 64-bit status word and a clip record. A launch of
// one CUDA block needs none of it.
constexpr int kTailChunk = 4096;   // -1 slots per grab of the tail cursor
constexpr int kMaxTileTopics = 1024;  // 32 warps x G = 32 (P = 1)

// -1 over the tail [n_hits, capacity) in chunks taken from *cursor, so the
// blocks that finish after the last tile has its prefix share the work.
__device__ void fill_tail(int* sids, int n_hits, int capacity, int* cursor) {
  __shared__ int s_chunk;
  while (true) {
    __syncthreads();
    if (threadIdx.x == 0) s_chunk = atomicAdd(cursor, 1);
    __syncthreads();
    const long long lo = n_hits + static_cast<long long>(s_chunk) * kTailChunk;
    if (lo >= capacity) return;
    const long long hi = min(static_cast<long long>(capacity), lo + kTailChunk);
    for (long long k = lo + threadIdx.x; k < hi; k += blockDim.x) sids[k] = -1;
  }
}

__global__ void __launch_bounds__(1024) match_compact_kernel(
    const int* __restrict__ tokens, int B, int W_tok, int max_levels,
    const uint4* __restrict__ table, uint32_t slot_mask,
    const int* __restrict__ pat_kind, const int* __restrict__ pat_depth,
    const int* __restrict__ pat_mask, int P, int capacity, int* __restrict__ out,
    int* __restrict__ scratch, unsigned epoch) {
  extern __shared__ int smem[];
  __shared__ int s_tile, s_excl, s_n_hits;
  __shared__ int2 s_record;
  __shared__ int s_total[kMaxTileTopics], s_last_p[kMaxTileTopics];
  __shared__ bool s_is_last;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int Pw = probe_lanes(P);  // lanes per topic
  const int G = kWarp / Pw;       // topics per warp
  const int n_topics = blockDim.x / kWarp * G;  // topics per tile
  const int n_tiles = gridDim.x;
  const bool single = n_tiles == 1;
  int* s_start = smem;
  int* s_cnt = smem + n_topics * P;
  int* ticket = scratch;
  int* done = scratch + 1;
  int* last_tile = scratch + 2;
  int* cursor = scratch + 3;
  unsigned long long* status = reinterpret_cast<unsigned long long*>(scratch + 4);
  int2* records = reinterpret_cast<int2*>(status + n_tiles);
  int* header = out;
  int* totals = out + 2;
  int* ovf_out = out + 2 + B;
  int* sids = out + 2 + 2LL * B;

  // 1. a tile id in start order: a tile waits only on tiles that started
  // before it, never on one that was not yet scheduled
  if (threadIdx.x == 0) s_tile = single ? 0 : atomicAdd(ticket, 1);
  __syncthreads();
  const int tile = s_tile;

  // 2. the probes, as probe_kernel runs them; lt is the topic in the tile
  const int lt = warp * G + lane / Pw;
  const int b = tile * n_topics + lt;
  int total = 0;
  int last = -1;
  bool ovf = false;
  if (b < B) {
    const int L = (W_tok - 2) / 2;
    const int* tok = tokens + static_cast<long long>(b) * W_tok;
    const int n = tok[2 * L];
    const bool dollar = tok[2 * L + 1] != 0;
    for (int p = lane % Pw; p < P; p += kWarp) {
      const ProbeOut r = probe_one(tok, L, max_levels, n, dollar, table, slot_mask,
                                   static_cast<uint32_t>(pat_kind[p]), pat_depth[p],
                                   static_cast<uint32_t>(pat_mask[p]));
      s_start[lt * P + p] = r.start;
      s_cnt[lt * P + p] = r.cnt;
      total += r.cnt;
      ovf |= r.overflow;
      if (r.cnt > 0) last = p;
    }
  }
  // reduce over the topic's lanes (an aligned group of Pw)
  for (int o = Pw / 2; o > 0; o >>= 1) {
    total += __shfl_xor_sync(kFull, total, o);
    last = max(last, __shfl_xor_sync(kFull, last, o));
    ovf |= __shfl_xor_sync(kFull, ovf, o);
  }
  if (lane % Pw == 0) {
    if (b < B) {
      totals[b] = total;
      ovf_out[b] = ovf ? 1 : 0;
    }
    s_total[lt] = total;
    s_last_p[lt] = last;
  }
  __syncthreads();

  // 3. warp 0: the tile-local topic offsets (s_total becomes its exclusive
  // scan), the tile's exclusive offset, and its last non-empty segment
  if (warp == 0) {
    int carry = 0, last_t = -1;
    for (int base = 0; base < n_topics; base += kWarp) {
      const int i = base + lane;
      const int v = i < n_topics ? s_total[i] : 0;
      int incl = v;
#pragma unroll
      for (int o = 1; o < kWarp; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      if (i < n_topics) s_total[i] = carry + incl - v;
      int lt_nz = i < n_topics && s_last_p[i] >= 0 ? i : -1;
#pragma unroll
      for (int o = kWarp / 2; o > 0; o >>= 1) lt_nz = max(lt_nz, __shfl_xor_sync(kFull, lt_nz, o));
      last_t = max(last_t, lt_nz);
      carry += __shfl_sync(kFull, incl, kWarp - 1);
    }
    const int agg = carry;
    int excl = 0;
    if (tile > 0) {
      if (lane == 0) store_status(status + tile, status_word(epoch, false, agg));
      excl = look_back(status, tile, epoch, lane);
    }
    if (lane == 0) {
      if (!single) store_status(status + tile, status_word(epoch, true, excl + agg));
      s_excl = excl;
      s_n_hits = excl + agg;  // the batch's n_hits where this is the last tile
      if (last_t >= 0) {
        // the last non-empty segment is the last one of its topic
        const int p = s_last_p[last_t];
        const int end = last_t + 1 < n_topics ? s_total[last_t + 1] : agg;
        s_record = make_int2(s_start[last_t * P + p], excl + end - s_cnt[last_t * P + p]);
        if (!single) {
          records[tile] = s_record;
          atomicMax(last_tile, tile + 1);
        }
      }
    }
  }
  __syncthreads();

  // 4. the tile's segments, in (topic, pattern) order: a warp's lanes scan
  // their counts, then the warp strides over each range, so stores coalesce
  {
    const int topic_base = s_excl + s_total[lt];  // b >= B: no counts
    int carry = 0;
    for (int p0 = 0; p0 < P; p0 += kWarp) {
      const int p = p0 + lane % Pw;
      const int c = b < B && p < P ? s_cnt[lt * P + p] : 0;
      int incl = c;
      for (int o = 1; o < Pw; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane % Pw >= o) incl += y;
      }
      const int off = topic_base + carry + incl - c;
      const int s0 = c > 0 ? s_start[lt * P + p] : 0;
      unsigned nz = __ballot_sync(kFull, c > 0 && off < capacity);
      while (nz) {
        const int src = __ffs(nz) - 1;
        nz &= nz - 1;
        const int o = __shfl_sync(kFull, off, src);
        const int cc = min(__shfl_sync(kFull, c, src), capacity - o);
        const int s = __shfl_sync(kFull, s0, src);
        for (int k = lane; k < cc; k += kWarp) sids[o + k] = s + k;
      }
      carry += __shfl_sync(kFull, incl, (lane / Pw) * Pw + Pw - 1);
    }
  }

  // 5. one block: it alone writes the header, the clip slot and the tail
  if (single) {
    __syncthreads();
    const int n_hits = s_n_hits;
    if (threadIdx.x == 0) {
      header[0] = n_hits;
      header[1] = n_hits > capacity ? 1 : 0;
      // JAX's clip rule: the last slot belongs to the last non-empty
      // segment overall (scatter-max + cummax)
      if (n_hits > capacity) sids[capacity - 1] = s_record.x + (capacity - 1 - s_record.y);
    }
    for (int k = n_hits + threadIdx.x; k < capacity; k += blockDim.x) sids[k] = -1;
    return;
  }

  // 6. many blocks. One that finds the last tile's prefix published helps
  // with the -1 tail; the last block to finish writes the header and the
  // clip slot, ends the tail, and resets the counters for the next launch.
  // Every natural write to slot capacity-1 is made before its block's
  // fence and done increment, so the last block's clip overwrite lands
  // after it.
  if (threadIdx.x == 0) {
    const unsigned long long fin = load_status(status + n_tiles - 1);
    s_n_hits = (static_cast<unsigned>(fin >> 33) == epoch && (fin & kFlagInclusive))
                   ? static_cast<int>(static_cast<unsigned int>(fin)) : -1;
  }
  __syncthreads();
  if (s_n_hits >= 0) fill_tail(sids, s_n_hits, capacity, cursor);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_is_last = atomicAdd(done, 1) == n_tiles - 1;
  __syncthreads();
  if (!s_is_last) return;
  __threadfence();
  if (threadIdx.x == 0) {
    const unsigned long long fin = load_status(status + n_tiles - 1);
    s_n_hits = static_cast<int>(static_cast<unsigned int>(fin));
  }
  __syncthreads();
  const int n_hits = s_n_hits;
  fill_tail(sids, n_hits, capacity, cursor);
  if (threadIdx.x == 0) {
    header[0] = n_hits;
    header[1] = n_hits > capacity ? 1 : 0;
    if (n_hits > capacity) {
      // JAX's clip rule: the last slot belongs to the last non-empty
      // segment overall (scatter-max + cummax)
      const int2 rec = __ldcg(records + (__ldcg(last_tile) - 1));
      sids[capacity - 1] = rec.x + (capacity - 1 - rec.y);
    }
    *ticket = 0;
    *done = 0;
    *last_tile = 0;
    *cursor = 0;
  }
}

// K3, in place: one thread per 16-byte quarter of an updated row;
// indices outside [0, S) are dropped. Duplicate indices carry identical
// rows.
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

// K1: out[B, 2P+2] = starts | counts | total | overflow. B >= 1. A block
// has four warps (fewer where their G token rows, G * W ints each, pass 48
// KB). The launch goes to the current device, which must be the tensors'.
int fm_probe_ranges(const int* tokens, int B, int W, int max_levels,
                    const int* table, int S, const int* pat_kind,
                    const int* pat_depth, const int* pat_mask, int P, int* out,
                    void* stream) {
  const int G = kWarp / probe_lanes(P);
  const long long n_warps = (B + G - 1LL) / G;
  const size_t warp_bytes = static_cast<size_t>(G) * W * sizeof(int);
  int warps = kProbeWarps;
  while (warps > 1 && warps * warp_bytes > 48 * 1024) warps >>= 1;
  const size_t smem = warps * warp_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  probe_kernel<<<static_cast<unsigned>((n_warps + warps - 1) / warps), warps * kWarp, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      tokens, B, W, max_levels, reinterpret_cast<const uint4*>(table),
      static_cast<uint32_t>(S - 1), pat_kind, pat_depth, pat_mask, P, out);
  return static_cast<int>(cudaGetLastError());
}

// K2: out[2 + 2B + capacity] = n_hits, batch_overflow | totals[B] |
// overflow[B] | sids[capacity]. One launch of ceil(B / (warps * G)) CUDA
// blocks of warps (1-32) warps, G = 32 / min(P, 32) topics per warp, with
// warps * G * P * 8 bytes of dynamic shared memory; P is a power of two.
// scratch holds 4 + 4 * (blocks) ints and is the wrapper's own for this
// stream: zeroed once when allocated, then left zeroed by each launch (the
// counters) or tagged with epoch (the status words), which must differ
// from the previous launch's and not be 0. P >= 1 and B >= 1 (the wrapper
// writes the constant output otherwise).
int fm_match_compact(const int* tokens, int B, int W, int max_levels,
                     const int* table, int S, const int* pat_kind,
                     const int* pat_depth, const int* pat_mask, int P,
                     int capacity, int* out, int* scratch, int warps,
                     unsigned epoch, void* stream) {
  if (warps < 1 || warps > kWarp || P < 1 || (P & (P - 1)) || epoch == 0 || epoch >= (1u << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = kWarp / probe_lanes(P);
  const size_t smem = static_cast<size_t>(warps) * G * P * 2 * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        match_compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long per_block = static_cast<long long>(warps) * G;
  const unsigned tiles = static_cast<unsigned>((B + per_block - 1) / per_block);
  match_compact_kernel<<<tiles, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      tokens, B, W, max_levels, reinterpret_cast<const uint4*>(table),
      static_cast<uint32_t>(S - 1), pat_kind, pat_depth, pat_mask, P, capacity, out,
      scratch, epoch);
  return static_cast<int>(cudaGetLastError());
}

// K3, in place: table[idx[i]] = rows[i] for every i with idx[i] in
// [0, S); nothing else of the table is read or written. table and rows
// are 16-byte aligned.
int fm_scatter_rows(int* table, int S, const int* idx, int k,
                    const int* rows, void* stream) {
  if (k > 0)
    scatter_rows_kernel<<<blocks_for(4LL * k, 256), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        idx, k, reinterpret_cast<const uint4*>(rows), S,
        reinterpret_cast<uint4*>(table));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
