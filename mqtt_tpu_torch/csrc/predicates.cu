// Hand-written Hopper kernels of the MQTT+ payload-predicate plane.
//
// Replaces the jitted jnp graphs of the JAX package's
// mqtt_tpu/ops/predicates.py:
//
//   K4 rules_eval   rules_eval_core (predicates.py:58-90)
//   K5 agg_reduce   agg_reduce_core (predicates.py:99-117)
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// (mqtt_tpu_torch/ops/kernels.py loads it with ctypes). Every entry point
// launches on the caller's stream, never synchronises, allocates nothing
// and returns cudaGetLastError(). Built without --use_fast_math: the
// comparisons and the mean's division are IEEE float32, as in XLA.
//
// What bounds them on the card:
//
// K4 evaluates every rule on every publish, B*R verdicts, and writes one
// bit each. Its bytes are the packed output (B*R/8) plus a rule table that
// stays in L2. Comparing each feature with each threshold costs two
// compares and an OR per verdict on the 64-lane ALU pipe, about 3x the
// output's write time at the main path's shape (B=4096, R=131072, S=1).
// The design takes that work off the verdicts. A CUDA block of two warps
// owns a tile of 32 packed words (a lane each, 32 rules a word) and one
// chunk of publishes (grid y), sized so the grid fills the card about
// once; it stages the tile's 1024 rules in shared memory with coalesced
// loads and builds the tile's tables once, and its warps take the chunk's
// publishes 32 at a time in turn (8 or 16 where the batch is too small to
// fill the card with runs of 32). Where every rule reads the same feature
// (S = 1), a word's numeric verdicts for a feature f depend only on where
// f falls among the word's 32 thresholds (below, on or above each). So a lane
// sorts its thresholds (a bitonic network in registers) and the tile
// tabulates each word for the 65 regions they cut the line into, plus one
// for a NaN feature; per publish a lane finds f's region by a six-step
// binary search over its sorted thresholds in shared memory and reads the
// word: 8 shared loads and about 20 other instructions per 32 verdicts. At
// S > 1 the rules of a word read different features, and each verdict is
// evaluated on its own from a 5-bit outcome mask (below, equal, above,
// unordered, NaN feature), a rule's fields read once for eight publishes.
// The $CONTAINS/$EQS rows, a few in a hundred in the main path's table,
// take their bits from cmask words. Where a tile's bit-op rules read at
// most 32 distinct words below 64 and are few beside the most in one word
// (a list walked per run costs each entry in turn; a lane's own loop takes
// four of its rules at once), a warp stages those words for 32 publishes
// (loaded while the previous 32 are searched), walks the tile's list of
// bit-op rules with the lanes turned to publishes, and leaves each word's
// bits per publish in shared memory for the word's lane to OR in;
// otherwise each lane reads its own bit-op rules' words from memory, four
// rules at a time. Each warp stores 32 consecutive words of a publish's
// row, one 128-byte segment.
//
// K5 reduces W NaN-padded windows of N samples: one warp per window, lanes
// striding over the samples, then a shuffle tree. It reads W*N floats once
// and is bound by bytes (and at the main path's W=64, N=64 by launch cost).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

// op codes: the shared vocabulary of mqtt_tpu_torch/ops/predicates.py
constexpr int kOpGt = 1;
constexpr int kOpGte = 2;
constexpr int kOpLt = 3;
constexpr int kOpLte = 4;
constexpr int kOpEq = 5;
constexpr int kOpContains = 7;
constexpr int kOpMean = 8;
constexpr int kOpMax = 9;
constexpr int kOpEqs = 11;

constexpr int kRulesWarps = 2;          // warps sharing a tile of 32 words
constexpr int kPad = 33;                // a lane's row of 32 per-rule values, padded against conflicts
constexpr int kRowArea = 32 * kPad;     // one area of K4's shared memory
constexpr int kRegionNan = 65;          // region words: 2 * 32 + 1 regions of the line, then a NaN feature
constexpr int kIlp = 8;                 // publishes a lane keeps in flight
constexpr uint32_t kFillFlag = 1u << 20;   // a list entry whose cmask word lies past W
constexpr uint32_t kNoEntry = 0xFFFFFFFFu;  // before the list's first entry
constexpr int kEntries = 8;                 // list entries a lane takes at once
constexpr int kRulesAtOnce = 4;             // bit-op rules a lane reads at once outside the list
constexpr int kListPerRound = 64;           // list entries worth one round of kRulesAtOnce rules a lane
constexpr int kMaxDevices = 64;             // devices whose launch shape is kept
constexpr int kAggThreads = 256;   // 8 windows per block, one warp each
constexpr unsigned kFull = 0xFFFFFFFFu;

// Outcome bits of a rule: which outcomes of comparing the feature f with
// the threshold t pass. Bit 0: f < t, 1: f == t, 2: f > t, 3: unordered
// (t NaN, f not), 4: f NaN (skip-to-pass). OP_NE and the OP_NONE pad rows
// compute f != t, which is true when unordered. Bit-op rows pass on their
// cmask bit alone, so they have none.
__device__ __forceinline__ uint32_t outcome_bits(int o) {
  switch (o) {
    case kOpGt: return 0b10100u;
    case kOpGte: return 0b10110u;
    case kOpLt: return 0b10001u;
    case kOpLte: return 0b10011u;
    case kOpEq: return 0b10010u;
    case kOpContains:
    case kOpEqs: return 0u;
    default: return 0b11101u;  // OP_NE and the OP_NONE pad rows
  }
}

// K4. A block is kRulesWarps warps sharing one tile of 32 words (a word a
// lane) and one chunk of publishes (blockIdx.y: [y*chunk, (y+1)*chunk),
// chunk a multiple of run), which the warps take run (8, 16 or 32)
// publishes at a time in turn. The tile's tables are built once for the
// block; the warps compute its per-lane registers alike. Lanes past the table's end compute on
// empty rules and store nothing, so every shuffle has all 32 lanes.
template <bool kOneSlot>
__global__ void __launch_bounds__(kRulesWarps * 32) rules_eval_kernel(
    const int* __restrict__ op, const int* __restrict__ slot, const float* __restrict__ thresh,
    const int* __restrict__ cbit, int R, const float* __restrict__ feats, int S,
    const uint32_t* __restrict__ cmask, int W, int B, int chunk, int run, uint32_t* __restrict__ out) {
  // Areas of 32 x kPad words. The tile's: s_cb, each rule's cmask bit in
  // row layout [lane * kPad + k] (then, compact, the list of bit-op
  // rules), and three areas that first hold the staged op, thresh and slot
  // rows; then, at S = 1, the sorted thresholds s_key[e * 32 + lane] (33
  // rows, row 32 a NaN sentinel) and the region words s_word[e * 32 + lane]
  // (66 rows); at S > 1, op becomes each rule's outcome bits and slot its
  // clipped slot, in place. Each warp's: s_cm, a run's staged cmask words
  // (row j: publish j), and s_bits, its bit-op verdicts (row l, column j:
  // word l's bits for publish j).
  __shared__ uint32_t s_mem[(4 + 2 * kRulesWarps) * kRowArea];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* s_cb = s_mem;
  uint32_t* s_op = s_cb + kRowArea;
  uint32_t* s_th = s_op + kRowArea;
  uint32_t* s_sl = s_th + kRowArea;
  uint32_t* s_cm = s_sl + kRowArea + 2 * warp * kRowArea;
  uint32_t* s_bits = s_cm + kRowArea;
  uint32_t* s_key = s_op;
  uint32_t* s_word = s_th;
  const bool lead = warp == 0;  // the warp that writes the tile's tables
  const int words = R >> 5;
  const int w0 = blockIdx.x * 32;
  const int word = w0 + lane;
  const bool live = word < words;
  const int b_begin = blockIdx.y * chunk;
  const int b_end = min(B, b_begin + chunk);

  // 1. stage the tile's 32 x 32 rules with coalesced loads, the warps
  // taking alternate groups of 8 rows: rule u*32 + l of the tile lands in
  // row u, column l (a padded row keeps both these stores and the lanes'
  // row reads free of conflicts)
  {
    const int n_rules = min(32, words - w0) * 32;
    const size_t base = static_cast<size_t>(w0) * 32;
    for (int u0 = 8 * warp; u0 < 32; u0 += 8 * kRulesWarps) {
      int o8[8], c8[8], s8[8];
      float t8[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int o = (u0 + i) * 32 + lane;
        const size_t r = base + (o < n_rules ? o : 0);
        o8[i] = __ldg(op + r);
        t8[i] = __ldg(thresh + r);
        c8[i] = __ldg(cbit + r);
        s8[i] = kOneSlot ? 0 : __ldg(slot + r);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int pos = (u0 + i) * kPad + lane;
        s_cb[pos] = static_cast<uint32_t>(c8[i] < 0 ? 0 : c8[i]);  // jnp.clip(cbit, 0, None)
        s_op[pos] = static_cast<uint32_t>(o8[i]);
        s_th[pos] = __float_as_uint(t8[i]);
        if (!kOneSlot) s_sl[pos] = static_cast<uint32_t>(s8[i] < 0 ? 0 : (s8[i] > S - 1 ? S - 1 : s8[i]));
      }
    }
#pragma unroll
    for (int u = 0; u < 32; ++u) s_bits[u * kPad + lane] = 0u;
  }
  __syncthreads();

  // 2. the lane's word, classified once. S = 1: lt/eq/gt hold the numeric
  // rules passing below / on / above their threshold; nant those whose
  // threshold is NaN (every outcome unordered) and that pass it.
  uint32_t bitops = 0, lt = 0, eq = 0, gt = 0, nant = 0, num = 0;
  float key[32];
  int idx[32];
  uint32_t mrow[32];  // S > 1: the outcome bits, written once every warp has read op
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int pos = lane * kPad + k;
    const uint32_t bit = 1u << k;
    const uint32_t m = live ? outcome_bits(static_cast<int>(s_op[pos])) : 0u;
    const float t = __uint_as_float(s_th[pos]);
    bitops |= live && m == 0 ? bit : 0u;
    num |= m ? bit : 0u;
    idx[k] = k;
    if (kOneSlot) {
      const bool ordered = m && !isnan(t);
      key[k] = ordered ? t : INFINITY;  // the others take no region of their own
      lt |= ordered && (m & 1u) ? bit : 0u;
      eq |= ordered && (m & 2u) ? bit : 0u;
      gt |= ordered && (m & 4u) ? bit : 0u;
      nant |= m && !ordered && (m & 8u) ? bit : 0u;
    } else {
      mrow[k] = m;
    }
  }
  __syncthreads();  // the staged op and thresh rows are read: S = 1 reuses them
  if (!kOneSlot && lead) {
#pragma unroll
    for (int k = 0; k < 32; ++k) s_op[lane * kPad + k] = mrow[k];
  }

  if (kOneSlot && lead) {
    // 3. sort (threshold, rule) ascending: a bitonic network whose indices
    // are all known at compile time, so the pairs stay in registers
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int j = i ^ stride;
          if (j > i) {
            const bool swap = ((i & size) == 0) ? key[i] > key[j] : key[i] < key[j];
            const float kt = swap ? key[j] : key[i];
            key[j] = swap ? key[i] : key[j];
            key[i] = kt;
            const int it = swap ? idx[j] : idx[i];
            idx[j] = swap ? idx[i] : idx[j];
            idx[i] = it;
          }
        }
      }
    }
    // 4. the region words. For f not NaN and lo = #{u < f}: region 2*lo
    // where u_lo > f, 2*lo + 1 where u_lo == f; lo is always the first of
    // a run of equal thresholds. The rules sorted before lo lie below f,
    // those of u_lo's run on it, the rest above it. Regions inside a run
    // cannot occur; their odd words are left unwritten.
    uint32_t below = 0, run = 0, below_run = 0;
    int first = 0;
#pragma unroll
    for (int p = 0; p < 32; ++p) {
      const uint32_t bit = 1u << idx[p];
      if (p > 0 && key[p] != key[p - 1]) {
        first = p;
        run = 0;
        below_run = below;
      }
      run |= bit;
      s_word[(2 * p) * 32 + lane] = (below & gt) | (~below & lt) | nant;
      s_word[(2 * first + 1) * 32 + lane] =
          (below_run & gt) | (run & eq) | (~(below_run | run) & lt) | nant;
      s_key[p * 32 + lane] = __float_as_uint(key[p]);
      below |= bit;
    }
    s_word[64 * 32 + lane] = (below & gt) | (~below & lt) | nant;
    s_key[32 * 32 + lane] = __float_as_uint(NAN);
    s_word[kRegionNan * 32 + lane] = num;  // a NaN feature passes every numeric rule
  }

  // 5. the cmask words the tile's bit-op rules read. Where they are at
  // most 32, all below 64, and the rules are not dense (compact), lane j
  // stages the j-th of them for each publish of a run, and the tile's
  // bit-op rules become one list in s_cb: column of s_cm, shift, word
  // lane, rule; or kFillFlag where the word lies past W (jnp.take's fill
  // mode: all ones). Otherwise s_cb keeps the raw bits and each lane reads
  // its rules' words from memory.
  const uint32_t bit_lanes = __ballot_sync(kFull, bitops != 0);
  uint32_t need_lo = 0, need_hi = 0;
  bool far = false;
  for (uint32_t m = bitops; m; m &= m - 1) {
    const int cw = static_cast<int>(s_cb[lane * kPad + __ffs(m) - 1] >> 5);
    if (cw >= W) continue;
    if (cw < 32) need_lo |= 1u << cw;
    else if (cw < 64) need_hi |= 1u << (cw - 32);
    else far = true;
  }
  __syncthreads();  // every warp has read the raw s_cb rows before the lead rewrites them
  need_lo = __reduce_or_sync(kFull, need_lo);
  need_hi = __reduce_or_sync(kFull, need_hi);
  const int n_lo = __popc(need_lo);
  const int n_need = n_lo + __popc(need_hi);
  // the list is walked one entry at a time for each run; the per-lane
  // loop takes kRulesAtOnce rules of every word at once, so a tile dense
  // in bit-op rules takes the loop
  const int most = static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(__popc(bitops))));
  const int n_bits = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(__popc(bitops))));
  const bool compact = !__any_sync(kFull, far) && n_need <= 32 &&
                       n_bits <= kListPerRound * ((most + kRulesAtOnce - 1) / kRulesAtOnce);
  int my_cw = 0;  // the cmask word lane j stages: the j-th set bit of the need mask
  int n_ent = 0;  // compact: the list's length
  if (compact) {
    if (lane < n_need) {
      uint32_t m = lane < n_lo ? need_lo : need_hi;
      for (int i = lane < n_lo ? lane : lane - n_lo; i > 0; --i) m &= m - 1;
      my_cw = (lane < n_lo ? 0 : 32) + __ffs(m) - 1;
    }
    // the list: lane l's rules at [before, before + popc), built in s_cm
    // (free until the first run) and then copied over s_cb
    const int mine = __popc(bitops);
    int before = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, before, o);
      if (lane >= o) before += y;
    }
    n_ent = __shfl_sync(kFull, before, 31);
    before -= mine;
    for (uint32_t m = lead ? bitops : 0u; m; m &= m - 1) {
      const int k = __ffs(m) - 1;
      const uint32_t cb = s_cb[lane * kPad + k];
      const int cw = static_cast<int>(cb >> 5);
      uint32_t e = kFillFlag;
      if (cw < W) {
        const int col = cw < 32 ? __popc(need_lo & ((1u << cw) - 1u))
                                : n_lo + __popc(need_hi & ((1u << (cw - 32)) - 1u));
        e = (static_cast<uint32_t>(col) << 15) | ((cb & 31u) << 10);
      }
      s_cm[before++] = e | (static_cast<uint32_t>(lane) << 5) | static_cast<uint32_t>(k);
    }
    __syncwarp();
    if (lead)
      for (int i = lane; i < n_ent; i += 32) s_cb[i] = s_cm[i];
  }
  __syncthreads();  // the tables are written; the warps' own areas are theirs

  // 6. the block's publishes, run at a time. Compact: the next run's
  // cmask words are loaded while this run is searched, and stored to s_cm
  // when it starts.
  const size_t row = static_cast<size_t>(words);
  const uint32_t* bits_row = s_bits + lane * kPad;
  uint32_t pf[32];
  const bool stage = bit_lanes && compact && lane < n_need;
  const auto prefetch = [&](int b0) {
    const int nb = min(run, b_end - b0);
    const uint32_t* p = cmask + static_cast<size_t>(b0) * W + my_cw;
#pragma unroll
    for (int i = 0; i < 32; ++i, p += W) pf[i] = i < nb ? __ldg(p) : 0u;
  };
  const int first_run = b_begin + run * warp;
  if (stage && first_run < b_end) prefetch(first_run);
  for (int b0 = first_run; b0 < b_end; b0 += run * kRulesWarps) {
    const int nb = min(run, b_end - b0);
    // S = 1: lane j holds publish b0 + j's feature
    const float fr = kOneSlot ? feats[b0 + min(lane, nb - 1)] : 0.0f;
    if (bit_lanes && compact) {
      // the bit-op pass, lanes as publishes: s_bits row l, column j gets
      // word l's bit-op verdicts for publish j
      if (stage) {
#pragma unroll
        for (int i = 0; i < 32; ++i) s_cm[i * kPad + lane] = pf[i];
        if (b0 + run * kRulesWarps < b_end) prefetch(b0 + run * kRulesWarps);
      }
      __syncwarp();
      // the list is in word-lane order: a word's bits gather in acc, which
      // is stored after each of its entries, so each row of a word with
      // bit-op rules is rewritten whole every run
      const uint32_t* cm_row = s_cm + lane * kPad;
      uint32_t acc = 0, prev = kNoEntry;
      for (int i0 = 0; i0 < n_ent; i0 += kEntries) {
        uint32_t e[kEntries], v[kEntries];
#pragma unroll
        for (int i = 0; i < kEntries; ++i) e[i] = s_cb[min(i0 + i, n_ent - 1)];
#pragma unroll
        for (int i = 0; i < kEntries; ++i) v[i] = cm_row[(e[i] >> 15) & 31u] >> ((e[i] >> 10) & 31u);
#pragma unroll
        for (int i = 0; i < kEntries; ++i) {
          const uint32_t wl = (e[i] >> 5) & 31u;
          const uint32_t hit = (e[i] & kFillFlag) ? 1u : v[i] & 1u;
          acc = (wl == prev ? acc : 0u) | (hit << (e[i] & 31u));
          prev = wl;
          if (i0 + i < n_ent) s_bits[wl * kPad + lane] = acc;
        }
      }
      __syncwarp();
    }
    for (int j = 0; j < nb; j += kIlp) {
      uint32_t w[kIlp];
      if (kOneSlot) {
        float f[kIlp];
        int a[kIlp];  // lane + 32 * lo: lo's row of s_key, this lane's column
#pragma unroll
        for (int q = 0; q < kIlp; ++q) {
          f[q] = __shfl_sync(kFull, fr, (j + q) & 31);
          a[q] = lane;
        }
        // lo = #{u < f}: five halving steps leave it within one of the
        // count, a sixth settles it (rows 0-31; row 32 is the sentinel)
#pragma unroll
        for (int step = 16; step > 0; step >>= 1) {
#pragma unroll
          for (int q = 0; q < kIlp; ++q)
            if (__uint_as_float(s_key[a[q] + (step - 1) * 32]) < f[q]) a[q] += step * 32;
        }
#pragma unroll
        for (int q = 0; q < kIlp; ++q)
          if (__uint_as_float(s_key[a[q]]) < f[q]) a[q] += 32;
#pragma unroll
        for (int q = 0; q < kIlp; ++q) {
          const bool on = __uint_as_float(s_key[a[q]]) == f[q];
          // region 2 * lo + on: row 2 * lo + on of s_word
          const int at = isnan(f[q]) ? kRegionNan * 32 + lane : 2 * a[q] - lane + (on ? 32 : 0);
          w[q] = s_word[at];
        }
      } else {
        // a rule's fields are read once for the kIlp publishes, whose
        // feature loads are then all in flight together
        const float* frow[kIlp];
#pragma unroll
        for (int q = 0; q < kIlp; ++q) {
          w[q] = 0;
          frow[q] = feats + static_cast<size_t>(b0 + min(j + q, nb - 1)) * S;
        }
#pragma unroll 4
        for (int k = 0; k < 32; ++k) {
          const uint32_t sl = s_sl[lane * kPad + k];
          const float t = __uint_as_float(s_th[lane * kPad + k]);
          const uint32_t m = s_op[lane * kPad + k];
#pragma unroll
          for (int q = 0; q < kIlp; ++q) {
            const float f = __ldg(frow[q] + sl);
            const int oc = isnan(f) ? 4 : (f < t ? 0 : (f == t ? 1 : (f > t ? 2 : 3)));
            w[q] |= ((m >> oc) & 1u) << k;
          }
        }
      }
      if (bitops && compact) {
#pragma unroll
        for (int q = 0; q < kIlp; ++q) w[q] |= bits_row[j + q];
      } else if (bitops) {
        // many words, or words past 63: each lane reads its bit-op rules'
        // words from memory (all lanes read one row, so the loads share
        // lines), kRulesAtOnce rules at a time so their loads are in flight
        // together; a slot past the lane's last rule reads word 0 and adds
        // nothing
        for (uint32_t m = bitops; m;) {
          int k[kRulesAtOnce];
          uint32_t cb[kRulesAtOnce];
#pragma unroll
          for (int u = 0; u < kRulesAtOnce; ++u) {
            k[u] = m ? __ffs(m) - 1 : 32;
            cb[u] = m ? s_cb[lane * kPad + k[u]] : 0u;
            m &= m - 1;
          }
#pragma unroll
          for (int u = 0; u < kRulesAtOnce; ++u) {
            const int cw = static_cast<int>(cb[u] >> 5);
#pragma unroll
            for (int q = 0; q < kIlp; ++q) {
              const size_t b = static_cast<size_t>(b0 + min(j + q, nb - 1));
              const uint32_t cword = cw < W ? __ldg(cmask + b * W + cw) : kFull;
              w[q] |= k[u] < 32 ? ((cword >> (cb[u] & 31u)) & 1u) << k[u] : 0u;
            }
          }
        }
      }
      if (live) {
        uint32_t* o = out + static_cast<size_t>(b0 + j) * row + word;
#pragma unroll
        for (int q = 0; q < kIlp; ++q, o += row)
          if (j + q < nb) *o = w[q];
      }
    }
    if (bit_lanes && compact) __syncwarp();  // s_bits and s_cm are read before the next run rewrites them
  }
}

// K5. Whole warps past W leave together.
__global__ void agg_reduce_kernel(const float* __restrict__ vals, const int* __restrict__ ops,
                                  const int* __restrict__ counts, int W, int N,
                                  float* __restrict__ out) {
  const int win = (blockIdx.x * kAggThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (win >= W) return;
  const float* row = vals + static_cast<size_t>(win) * N;
  float s = 0.0f;
  float mx = -INFINITY;
  float mn = INFINITY;
  for (int i = lane; i < N; i += 32) {
    const float v = row[i];
    if (!isnan(v)) {
      s += v;
      mx = v > mx ? v : mx;
      mn = v < mn ? v : mn;
    }
  }
  for (int off = 16; off; off >>= 1) {
    s += __shfl_xor_sync(kFull, s, off);
    const float omx = __shfl_xor_sync(kFull, mx, off);
    const float omn = __shfl_xor_sync(kFull, mn, off);
    mx = omx > mx ? omx : mx;
    mn = omn < mn ? omn : mn;
  }
  if (lane == 0) {
    const int o = ops[win];
    const float mean = s / fmaxf(static_cast<float>(counts[win]), 1.0f);
    out[win] = o == kOpMean ? mean : (o == kOpMax ? mx : mn);
  }
}

}  // namespace

extern "C" {

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K4: out[B, R/32] packed pass bits. R a multiple of 32, S >= 1, W >= 1.
// The grid is (R/32/32 tiles of 32 words) x (chunks of publishes), with as
// many chunks as fill the card's resident blocks once, a chunk holding the
// same number of runs for each warp; a warp takes 32 publishes at a time,
// or 16 or 8 where B is too small to fill the card with runs of 32. Any B
// fits. The
// launch goes to the current device, which must be the tensors'.
int pk_rules_eval(const int* op, const int* slot, const float* thresh, const int* cbit, int R,
                  const float* feats, int S, const uint32_t* cmask, int W, int B, uint32_t* out,
                  void* stream) {
  if (B > 0 && R > 0) {
    const bool one_slot = S == 1;
    const auto kernel = one_slot ? rules_eval_kernel<true> : rules_eval_kernel<false>;
    // resident blocks of each kernel on each device, read once
    static std::atomic<int> resident_of[kMaxDevices][2];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    int resident = resident_of[dev][one_slot].load(std::memory_order_relaxed);
    if (resident == 0) {
      int sms = 0, per_sm = 0;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRulesWarps * 32, 0);
      if (err != cudaSuccess) return static_cast<int>(err);
      resident = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
      resident_of[dev][one_slot].store(resident, std::memory_order_relaxed);
    }
    const long long tiles = ((R >> 5) + 31LL) / 32;
    const long long want = resident / tiles < 1 ? 1 : resident / tiles;  // chunks that fill the card
    // halve the run while that doubles the chunks, so halves each warp's share
    int run = 32;
    while (run > 8 && (B + run - 1LL) / run <= want) run >>= 1;
    const long long span = static_cast<long long>(run) * kRulesWarps;  // a run for each warp
    const long long chunks = (B + span - 1) / span < want ? (B + span - 1) / span : want;
    long long chunk = (B + chunks - 1) / chunks;
    chunk = (chunk + span - 1) / span * span;
    const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>((B + chunk - 1) / chunk));
    kernel<<<grid, kRulesWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        op, slot, thresh, cbit, R, feats, S, cmask, W, B, static_cast<int>(chunk), run, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5: out[W] aggregates of vals[W, N].
int pk_agg_reduce(const float* vals, const int* ops, const int* counts, int W, int N, float* out,
                  void* stream) {
  if (W > 0) {
    const int windows_per_block = kAggThreads / 32;
    const int grid = (W + windows_per_block - 1) / windows_per_block;
    agg_reduce_kernel<<<grid, kAggThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        vals, ops, counts, W, N, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
