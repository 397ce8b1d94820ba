// Hand-written Hopper kernels of the subscription-sharded matcher.
//
// Replaces the jitted jnp graphs of the JAX package's sharded path:
//
//   K7/K8 match_slots   flat_match_core (mqtt_tpu/ops/flat.py:858-910) and
//                       the shard_map'd step_fn around it
//                       (mqtt_tpu/parallel/sharded.py:631-645): every
//                       shard's probe of T batch tiles, expanded to K sid
//                       slots, written straight into the gathered
//                       [T, S, b, K] layout (on one card the all_gather
//                       over the subs axis is that write)
//   K9 tile_compact     _tile_compact_core (mqtt_tpu/parallel/sharded.py:
//                       93-139) with _segment_of_slot's clip rule
//                       (mqtt_tpu/ops/flat.py:1139-1162)
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// (mqtt_tpu_torch/ops/kernels.py loads it with ctypes). Every entry point
// launches on the caller's stream, never synchronises, allocates nothing
// (the wrapper hands in outputs and scratch) and returns cudaGetLastError().
// The launch goes to the current device, which must be the tensors'.
//
// What bounds them on the card: both move bytes, and at the path's shapes
// both are latency-bound. match_slots reads the token rows, one 64-byte
// bucket row per active probe (probe_one from flat_probe.cuh, shared with
// K1/K2) and writes T*S*b*K slots, which are most of its bytes. It takes
// K1's lane mapping: probe_lanes(P) lanes per topic, so a warp probes G =
// 32 / Pw topics of one shard (8 at P = 4) with every lane busy; the warp's
// G token rows are copied once into shared memory; a segmented shuffle
// scan over the topic's lanes gives each probe its prefix. The warp's G
// slot rows are one contiguous run of G*K ints, staged in shared memory
// (-1 first, then each probe's lane writes its own range) and written out
// with coalesced 16-byte stores; a first design that looked up each slot's
// probe by a search in shared memory spent more on the search than on the
// stores (K7 at B = 4096: 0.0072 ms against 0.0044 staged, PERF.md). One
// launch covers every tile and shard (grid y = T*S). JAX's [B, K, P]
// one-hot is a way to say the expansion in jnp, not part of the function,
// and is not carried over.
//
// tile_compact is one launch of blocks that each own a run of a tile's
// topics (R*S segments, topic-major, shard-minor, each min(total, K)
// pairs): a block reads its [S, R] totals and flags coalesced, writes the
// per-topic columns, scans its segments in shared memory (int32, as JAX's
// cumsum of int32 stays int32), and takes its offset in the tile by a
// decoupled look-back over the tile's blocks (look_back in flat_probe.cuh,
// K2's). It loads its pairs' sids (a shared-memory search finds each
// slot's segment) before the look-back returns, so the loads overlap it,
// then stores them: consecutive threads on consecutive slots, so both
// sides coalesce. Its time is a chain of dependent round trips to memory,
// so the design keeps the chain short: the ticket's atomic overlaps the
// first loads; blocks that take the last tickets write the -1 tail (most
// of the row at the path's capacity) in parallel as soon as every real
// block has published its count; the last real block writes the header, and the clip
// slot once the block holding slot cap-1 has flagged its natural write;
// no block waits for the others to finish and nothing is reset at the end
// (tickets alternate between two counters by launch). A tile that fits
// one block, pairs and tail, takes no ticket and no look-back.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flat_probe.cuh"

namespace {

constexpr int kSlotWarps = 4;          // K7/K8: warps a block
constexpr int kCopyInts = 8;           // K7/K8: token ints a lane loads per pass
constexpr int kCompactThreads = 512;   // K9: threads a block, and its segments
constexpr int kPrefetch = 2;           // K9: pairs a thread loads before the look-back
constexpr int kTailSlots = 8192;       // K9: -1 tail slots a tail block takes at most

// The entry of the sorted offsets prev[0..n) whose range holds slot k: the
// last one with prev[e] <= k (prev[0] is 0 and k is below the last range's
// end).
__device__ __forceinline__ int slot_entry(const int* prev, int n, int k) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (prev[mid] <= k)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// K7/K8's shared memory per warp, in ints: the G slot rows, then the G
// token rows, each run a multiple of 16 bytes.
__host__ __device__ __forceinline__ int slot_warp_ints(int G, int K, int W) {
  return round4(G * K) + round4(G * W);
}

// K7/K8. blockIdx.y is tile * S + shard. Lane l of a warp probes patterns
// l % Pw, l % Pw + 32, ... of topic l / Pw of the warp's G topics (lanes
// past P idle). Slot k of a topic's row is start_p + (k - prev_p) for the
// probe p whose range [prev_p, prev_p + cnt_p) holds k, and -1 from
// min(total, K) on: the warp's rows are staged in shared memory, -1 first,
// each probe's lane writes its own range there, and the warp copies them
// out. totals are not clipped; overflow = saturated probe | spilled hit |
// totals > ovf_limit.
__global__ void __launch_bounds__(kSlotWarps * kWarp) match_slots_kernel(
    const int* __restrict__ tokens, int bl, int W, int max_levels,
    const uint4* __restrict__ tables, long long NB, uint32_t slot_mask,
    const int* __restrict__ pat_kind, const int* __restrict__ pat_depth,
    const int* __restrict__ pat_mask, int S, int P, int K, int ovf_limit, bool vec,
    int* __restrict__ out, int* __restrict__ totals, uint8_t* __restrict__ overflow) {
  extern __shared__ int4 smem4[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int Pw = probe_lanes(P);
  const int G = kWarp / Pw;
  const long long ts = blockIdx.y;
  const int s = static_cast<int>(ts % S);
  const long long t = ts / S;
  const long long i0 = (static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) + warp) * G;
  if (i0 >= bl) return;  // uniform across the warp
  const int nb = static_cast<int>(min(static_cast<long long>(G), bl - i0));
  int* s_row = reinterpret_cast<int*>(smem4) + warp * slot_warp_ints(G, K, W);
  int* s_tok = s_row + round4(G * K);

  // the lane's first pattern, loaded before the token copy so the two
  // round trips overlap
  const int g = lane / Pw;
  const int pl = lane % Pw;
  const int* kind = pat_kind + static_cast<long long>(s) * P;
  const int* depth = pat_depth + static_cast<long long>(s) * P;
  const int* mask = pat_mask + static_cast<long long>(s) * P;
  uint32_t pk = 0, pm = 0;
  int pd = -1;
  if (pl < P) {
    pk = static_cast<uint32_t>(kind[pl]);
    pd = depth[pl];
    pm = static_cast<uint32_t>(mask[pl]);
  }

  // the warp's token rows, one contiguous run, in one round trip
  const int* src = tokens + (t * bl + i0) * W;
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
  // the rows' -1 (vec: K % 4 == 0, so nb * K is a whole number of int4)
  const int n_slots = nb * K;
  if (vec) {
    for (int j = lane * 4; j < n_slots; j += kWarp * 4)
      *reinterpret_cast<int4*>(s_row + j) = make_int4(-1, -1, -1, -1);
  } else {
    for (int j = lane; j < n_slots; j += kWarp) s_row[j] = -1;
  }
  __syncwarp();

  // the probes; a segmented scan over the topic's Pw lanes gives each its
  // prefix, and each lane writes its range of the topic's row
  const bool live = g < nb;
  const int L = (W - 2) / 2;
  const int* tok = s_tok + g * W;
  const int n = live ? tok[2 * L] : 0;
  const bool dollar = live && tok[2 * L + 1] != 0;
  const uint4* table = tables + static_cast<long long>(s) * NB * 4;
  int* row = s_row + g * K;
  int carry = 0;  // the topic's hits in earlier strides of 32 patterns
  bool ovf = false;
  for (int base = 0; base < P; base += kWarp) {
    ProbeOut r{0, 0, false};
    if (live && base + pl < P) r = probe_one(tok, L, max_levels, n, dollar, table, slot_mask, pk, pd, pm);
    if (base + kWarp + pl < P) {
      pk = static_cast<uint32_t>(kind[base + kWarp + pl]);
      pd = depth[base + kWarp + pl];
      pm = static_cast<uint32_t>(mask[base + kWarp + pl]);
    }
    ovf |= r.overflow;
    int incl = r.cnt;
    for (int o = 1; o < Pw; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (pl >= o) incl += y;
    }
    const int prev = carry + incl - r.cnt;
    const int end = min(prev + r.cnt, K);
    for (int k = prev; k < end; ++k) row[k] = r.start + (k - prev);
    carry += __shfl_sync(kFull, incl, g * Pw + Pw - 1);
  }
  const unsigned group = Pw == kWarp ? kFull : ((1u << Pw) - 1u) << (g * Pw);
  const bool any_ovf = (__ballot_sync(kFull, ovf) & group) != 0;
  if (live && pl == 0) {
    totals[ts * bl + i0 + g] = carry;
    overflow[ts * bl + i0 + g] = (any_ovf || carry > ovf_limit) ? 1 : 0;
  }
  __syncwarp();

  // the warp's G slot rows: one contiguous run of nb * K ints
  int* dst = out + (ts * bl + i0) * K;
  if (vec) {
    for (int j = lane * 4; j < n_slots; j += kWarp * 4)
      *reinterpret_cast<int4*>(dst + j) = *reinterpret_cast<const int4*>(s_row + j);
  } else {
    for (int j = lane; j < n_slots; j += kWarp) dst[j] = s_row[j];
  }
}

// The sid a compacted slot reads: slot `slot` of segment seg = i*S + s of
// the tile whose [S, bl, K] slots start at out.
__device__ __forceinline__ int segment_sid(const int* __restrict__ out, int seg, int slot, int S,
                                           int bl, int K) {
  const int s = seg % S;
  const int i = seg / S;
  return out[(static_cast<long long>(s) * bl + i) * K + slot];
}

// K9: the total and flag of index q of run blk's [S, nr] block of a tile
// (q = s * nr + i: coalesced along each shard's row); 0 past the run.
__device__ __forceinline__ void load_segment(const int* __restrict__ tot,
                                             const uint8_t* __restrict__ ovf, int S, int bl,
                                             int R, int blk, int q, int* v, int* f) {
  const long long i0 = static_cast<long long>(blk) * R;
  const int nr = static_cast<int>(min(static_cast<long long>(R), bl - i0));
  if (nr <= 0 || q >= nr * S) return;
  const int s = q / nr;
  const long long at = static_cast<long long>(s) * bl + i0 + (q - s * nr);
  *v = tot[at];
  *f = ovf[at];
}

// K9's clip slot: on an overflowing tile the last slot belongs to the LAST
// non-empty segment overall (JAX's scatter-max + cummax), whose local slot
// cap-1 - offs may be negative: the gather adds K once and clamps to
// [0, K-1], as jnp indexing does. rec = (segment, its offset in the tile).
__device__ __forceinline__ void write_clip(const int* __restrict__ out, int2 rec, int S, int bl,
                                           int K, int cap, int* pair_shard, int* pair_sid) {
  int slot = min(cap - 1 - rec.y, K - 1);
  if (slot < 0) slot = max(slot + K, 0);
  pair_shard[cap - 1] = rec.x % S;
  pair_sid[cap - 1] = segment_sid(out, rec.x, slot, S, bl, K);
}

__device__ __forceinline__ int load_flag(int* f) {
  return cuda::atomic_ref<int, cuda::thread_scope_device>(*f).load(cuda::memory_order_relaxed);
}

__device__ __forceinline__ void store_flag(int* f, int v) {
  cuda::atomic_ref<int, cuda::thread_scope_device>(*f).store(v, cuda::memory_order_relaxed);
}

// The last non-empty segment of the tile, from the last real block's view:
// its own (local id s_last, offset known), else the nearest earlier block's
// record (each block publishes one, tagged with the epoch, before its
// status), whose offset is n_hits less its count: nothing after it has a
// pair. Called by one thread where n_hits > cap.
__device__ __forceinline__ int2 last_segment(unsigned long long* records, int blk, int s_last, int own_offs,
                             int i0, const int* __restrict__ tot, int S, int bl, int K, int n_hits,
                             unsigned epoch) {
  if (s_last >= 0) return make_int2(i0 * S + s_last, own_offs);
  for (int b = blk - 1; b >= 0; --b) {
    unsigned long long rec = load_status(records + b);
    while (static_cast<unsigned>(rec >> 32) != epoch) {
      __nanosleep(100);
      rec = load_status(records + b);
    }
    const int seg = static_cast<int>(static_cast<unsigned>(rec)) - 1;
    if (seg >= 0) return make_int2(seg, n_hits - min(tot[static_cast<long long>(seg % S) * bl + seg / S], K));
  }
  return make_int2(0, 0);  // not reached: n_hits > cap > 0 means some block has a pair
}

// K9. grid (n_real + n_tail blocks per tile, T). A block takes a ticket of
// its tile in start order: a block waits only on blocks that started
// before it. The block with ticket b < n_real owns topics [b*R, b*R + R):
// segments j = i*S + s in topic-major order, each min(totals[s, i], K)
// pairs. Tickets from n_real on are tail blocks: each takes the tile's
// total by a look-back over the real blocks and writes its share of the -1
// tail [n_hits, cap) of both pair arrays. rows[t] = n_hits, n_hits >
// cap | per_topic[bl] | ovf_topic[bl] | pair_shard[cap] | pair_sid[cap].
// The last real block writes the header and, where n_hits > cap, the clip
// slot, after the block whose range holds slot cap-1 has flagged its
// natural write there. Nothing is reset at the end: a launch takes tickets
// from one of two counters per tile by its epoch's parity (consecutive
// launches on the scratch alternate), and block (0, 0) zeroes the other
// one, for every tile the scratch is laid out for, for the next launch;
// the statuses, the records and the flag carry the epoch. A launch of one
// block (one real block, no tail blocks) takes no ticket.
//
// scratch: per tile of tiles_cap, the two ticket counters, the flag and a
// spare int; then per tile and real block a status word and a record
// (epoch << 32 | the block's last non-empty segment + 1, 0 for none).
__global__ void __launch_bounds__(kCompactThreads) tile_compact_kernel(
    const int* __restrict__ out, const int* __restrict__ totals,
    const uint8_t* __restrict__ overflow, int S, int bl, int K, int cap, int R,
    int* __restrict__ rows, long long row_w, int* __restrict__ scratch, int tiles_cap,
    unsigned epoch) {
  extern __shared__ int s_off[];  // R*S: the totals, then their exclusive scan; R*S flags
  __shared__ int s_blk, s_excl, s_last;
  const long long t = blockIdx.y;
  const int n_real = (bl + R - 1) / R;
  const bool single = gridDim.x == 1;
  const int parity = static_cast<int>(epoch & 1u);
  int* ticket = scratch + 4 * t + parity;
  int* flag = scratch + 4 * t + 2;
  unsigned long long* status =
      reinterpret_cast<unsigned long long*>(scratch + 4LL * tiles_cap + 4LL * n_real * t);
  unsigned long long* records = status + n_real;
  const int* tile_out = out + t * S * bl * static_cast<long long>(K);
  const int* tot = totals + t * S * bl;
  const uint8_t* ovf = overflow + t * S * bl;
  int* row = rows + t * row_w;
  int* pair_shard = row + 2 + 2LL * bl;
  int* pair_sid = pair_shard + cap;

  // 1. the ticket. Blocks start about in blockIdx order, so while its
  // atomic is in flight each thread loads its first total and flag for the
  // run of blockIdx.x; a block whose ticket differs reloads.
  if (threadIdx.x == 0) {
    s_blk = single ? 0 : atomicAdd(ticket, 1);
    s_last = -1;
  }
  if (blockIdx.x == 0 && blockIdx.y == 0)
    for (int i = threadIdx.x; i < tiles_cap; i += blockDim.x) scratch[4 * i + (parity ^ 1)] = 0;
  int v0 = 0, f0 = 0;
  load_segment(tot, ovf, S, bl, R, blockIdx.x, threadIdx.x, &v0, &f0);
  __syncthreads();
  const int blk = s_blk;

  // a tail block: its share of [n_hits, cap) once the total is known, by a
  // look-back from just past the last real block (it waits for every real
  // block's aggregate, not for the last one's own look-back)
  if (blk >= n_real) {
    if (threadIdx.x < kWarp) {
      const int n_hits = look_back(status, n_real, epoch, threadIdx.x);
      if (threadIdx.x == 0) s_excl = n_hits;
    }
    __syncthreads();
    const long long n_hits = s_excl;
    const long long n_tail = gridDim.x - n_real;
    const long long chunk = (max(0LL, cap - n_hits) + n_tail - 1) / n_tail;
    const long long lo = n_hits + (blk - n_real) * chunk;
    const long long hi = min(static_cast<long long>(cap), lo + chunk);
    for (long long k = lo + threadIdx.x; k < hi; k += blockDim.x) {
      pair_shard[k] = -1;
      pair_sid[k] = -1;
    }
    return;
  }
  const int i0 = blk * R;
  const int nr = min(R, bl - i0);
  const int n_seg = nr * S;
  if (blk != static_cast<int>(blockIdx.x)) load_segment(tot, ovf, S, bl, R, blk, threadIdx.x, &v0, &f0);

  // 2. the block's totals, clamped at K, and flags into segment order; then
  // the per-topic columns
  int* s_flag = s_off + R * S;
  for (int q = threadIdx.x; q < n_seg; q += blockDim.x) {
    int v = v0, f = f0;
    if (q >= static_cast<int>(blockDim.x)) load_segment(tot, ovf, S, bl, R, blk, q, &v, &f);
    const int s = q / nr;
    const int j = (q - s * nr) * S + s;
    s_off[j] = min(v, K);
    s_flag[j] = f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nr; i += blockDim.x) {
    int sum = 0;
    int any = 0;
    for (int s = 0; s < S; ++s) {
      sum += s_off[i * S + s];
      any |= s_flag[i * S + s];
    }
    row[2 + i0 + i] = sum;
    row[2 + bl + i0 + i] = any ? 1 : 0;
  }
  __syncthreads();

  // 3. s_off becomes the exclusive scan; agg is the block's pair count and
  // s_last its last non-empty segment
  int agg = 0;
  for (int base = 0; base < n_seg; base += blockDim.x) {
    const int j = base + threadIdx.x;
    const int v = j < n_seg ? s_off[j] : 0;
    int chunk;
    const int incl = block_inclusive_scan(v, &chunk);
    if (j < n_seg) {
      s_off[j] = agg + incl - v;
      if (v > 0) atomicMax(&s_last, j);
    }
    agg += chunk;
  }
  __syncthreads();

  // 4. the first kPrefetch * blockDim pairs' sids, loaded before the
  // look-back so the loads overlap it
  int sid[kPrefetch], seg[kPrefetch];
#pragma unroll
  for (int m = 0; m < kPrefetch; ++m) {
    const int q = threadIdx.x + m * blockDim.x;
    seg[m] = 0;
    sid[m] = -1;
    if (q < agg) {
      seg[m] = slot_entry(s_off, n_seg, q);
      sid[m] = segment_sid(tile_out, i0 * S + seg[m], q - s_off[seg[m]], S, bl, K);
    }
  }

  // 5. warp 0: the block's record, then its offset in the tile
  if (threadIdx.x < kWarp) {
    const int lane = threadIdx.x;
    if (lane == 0 && !single)
      store_status(records + blk, (static_cast<unsigned long long>(epoch) << 32) |
                                      static_cast<unsigned>(s_last >= 0 ? i0 * S + s_last + 1 : 0));
    int excl = 0;
    if (blk > 0) {
      if (lane == 0) store_status(status + blk, status_word(epoch, false, agg));
      excl = look_back(status, blk, epoch, lane);
    }
    if (lane == 0) {
      if (!single) store_status(status + blk, status_word(epoch, true, excl + agg));
      s_excl = excl;
    }
  }
  __syncthreads();

  // 6. the pairs below cap: consecutive threads on consecutive slots
  const int excl = s_excl;
  const int lim = min(agg, cap - excl);
#pragma unroll
  for (int m = 0; m < kPrefetch; ++m) {
    const int q = threadIdx.x + m * blockDim.x;
    if (q < lim) {
      pair_shard[excl + q] = (i0 * S + seg[m]) % S;
      pair_sid[excl + q] = sid[m];
    }
  }
  for (int q = threadIdx.x + kPrefetch * blockDim.x; q < lim; q += blockDim.x) {
    const int j = slot_entry(s_off, n_seg, q);
    pair_shard[excl + q] = (i0 * S + j) % S;
    pair_sid[excl + q] = segment_sid(tile_out, i0 * S + j, q - s_off[j], S, bl, K);
  }

  // 7. the block whose range holds slot cap-1 flags its natural write there
  // for the clip (which overwrites it where n_hits > cap)
  const bool holds_last = excl <= cap - 1 && cap - 1 < excl + agg;
  const bool last_real = blk == n_real - 1;
  if (holds_last && !last_real) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) store_flag(flag, static_cast<int>(epoch));
  }
  if (!last_real) return;

  // 8. the last real block: the header, the clip slot, and in a launch of
  // one block the tail
  const int n_hits = excl + agg;
  if (n_hits > cap) {
    __syncthreads();  // this block's own natural write of slot cap-1, if it holds it
    if (threadIdx.x == 0) {
      if (!holds_last) {
        while (load_flag(flag) != static_cast<int>(epoch)) __nanosleep(100);
        __threadfence();
      }
      const int own = s_last >= 0 ? excl + s_off[s_last] : 0;
      write_clip(tile_out, last_segment(records, blk, s_last, own, i0, tot, S, bl, K, n_hits, epoch),
                 S, bl, K, cap, pair_shard, pair_sid);
    }
  }
  if (threadIdx.x == 0) {
    row[0] = n_hits;
    row[1] = n_hits > cap ? 1 : 0;
  }
  if (single)
    for (int k = n_hits + threadIdx.x; k < cap; k += blockDim.x) {
      pair_shard[k] = -1;
      pair_sid[k] = -1;
    }
}

// K9's topics per block: R*S segments fill one block's threads.
inline int compact_run(int S) { return S < kCompactThreads ? kCompactThreads / S : 1; }

inline long long compact_blocks(int S, int bl) {
  const int R = compact_run(S);
  return (bl + R - 1LL) / R;
}

// K9's tail blocks per tile: none where one block takes the tile and the
// whole pair stream, else one per kTailSlots slots of cap.
inline long long tail_blocks(int S, int bl, int cap) {
  if (compact_blocks(S, bl) == 1 && cap <= kTailSlots) return 0;
  return (cap + kTailSlots - 1LL) / kTailSlots;
}

}  // namespace

extern "C" {

const char* sh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K7/K8: every shard of the stack tables[S, NB, 16] (patterns [S, P],
// P >= 1) on T tiles of bl topics, tokens[T*bl, 2L+2] -> out[T, S, bl, K],
// totals[T, S, bl], overflow[T, S, bl] (bytes 0/1), in one launch.
// ovf_slots 0 means K. A block has four warps (fewer where their token rows
// and entries pass 48 KB).
int sh_match_slots(const int* tokens, int T, int bl, int W, int max_levels,
                   const int* tables, int S, int NB, const int* pat_kind,
                   const int* pat_depth, const int* pat_mask, int P, int K,
                   int ovf_slots, int* out, int* totals, void* overflow,
                   void* stream) {
  if (T < 1 || bl < 1 || S < 1 || P < 1 || K < 1 || static_cast<long long>(T) * S > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = kWarp / probe_lanes(P);
  const size_t warp_bytes = static_cast<size_t>(slot_warp_ints(G, K, W)) * sizeof(int);
  int warps = kSlotWarps;
  while (warps > 1 && warps * warp_bytes > 48 * 1024) warps >>= 1;
  const size_t smem = warps * warp_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        match_slots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long n_warps = (bl + G - 1LL) / G;
  const dim3 grid(static_cast<unsigned>((n_warps + warps - 1) / warps),
                  static_cast<unsigned>(T * S));
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  match_slots_kernel<<<grid, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      tokens, bl, W, max_levels, reinterpret_cast<const uint4*>(tables), NB,
      static_cast<uint32_t>(NB - 1), pat_kind, pat_depth, pat_mask, S, P, K,
      ovf_slots != 0 ? ovf_slots : K, vec, out, totals, static_cast<uint8_t*>(overflow));
  return static_cast<int>(cudaGetLastError());
}

// K9's scratch, in ints, for T tiles of [S, bl] laid out for tiles_cap >= T
// tiles: four ints per tile of tiles_cap, then four per tile and real block.
long long sh_tile_compact_scratch(int T, int S, int bl, int tiles_cap) {
  return 4LL * tiles_cap + 4LL * T * compact_blocks(S, bl);
}

// K9: T tiles of out[T, S, bl, K], totals[T, S, bl], overflow[T, S, bl]
// -> rows[T, 2 + 2*bl + 2*cap], in one launch. scratch holds
// sh_tile_compact_scratch(T, S, bl, tiles_cap) ints and is the wrapper's
// own for this stream: zeroed once when allocated, then left zeroed by
// each launch (the counters, at the same place for every launch with the
// same tiles_cap: consecutive launches alternate between two ticket
// counters by the epoch's parity) or tagged with epoch (the status words,
// records and flag). epoch is not 0, below 2^31, and of the other parity
// than the previous launch's on this scratch.
int sh_tile_compact(const int* out, const int* totals, const void* overflow,
                    int T, int S, int bl, int K, int cap, int* rows,
                    int* scratch, int tiles_cap, unsigned epoch, void* stream) {
  if (T < 1 || T > 65535 || tiles_cap < T || S < 1 || bl < 1 || K < 1 || cap < 1 || epoch == 0 ||
      epoch >= (1u << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int R = compact_run(S);
  const size_t smem = 2 * static_cast<size_t>(R) * S * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(compact_blocks(S, bl) + tail_blocks(S, bl, cap)),
                  static_cast<unsigned>(T));
  tile_compact_kernel<<<grid, kCompactThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      out, totals, static_cast<const uint8_t*>(overflow), S, bl, K, cap, R, rows,
      2 + 2LL * bl + 2LL * cap, scratch, tiles_cap, epoch);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
