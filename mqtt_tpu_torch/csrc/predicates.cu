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
// stays in L2; its operations are the B*R compares, so at the main path's
// shape (B=4096, R=131072) it is operation-bound. The design: one thread per
// rule keeps that rule's op, slot, threshold and contains-bit in registers
// and loops over a run of publishes; each warp's 32 verdicts become one
// packed word with __ballot_sync (bit k = rule 32w+k, the order of the JAX
// packing), so no [B, R] boolean matrix ever reaches device memory.
//
// K5 reduces W NaN-padded windows of N samples: one warp per window, lanes
// striding over the samples, then a shuffle tree. It reads W*N floats once
// and is bound by bytes (and at the main path's W=64, N=64 by launch cost).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

constexpr int kRulesThreads = 256;  // 8 packed words (256 rules) per block
constexpr int kRulesPubs = 16;      // publishes per block (grid y)
constexpr int kAggThreads = 256;    // 8 windows per block, one warp each
constexpr unsigned kFull = 0xFFFFFFFFu;

// K4. Rows past R form whole warps (R is a multiple of 32), so a warp
// leaves together and every __ballot_sync has all 32 lanes.
__global__ void rules_eval_kernel(const int* __restrict__ op, const int* __restrict__ slot,
                                  const float* __restrict__ thresh, const int* __restrict__ cbit,
                                  int R, const float* __restrict__ feats, int S,
                                  const uint32_t* __restrict__ cmask, int W, int B,
                                  uint32_t* __restrict__ out) {
  const int r = blockIdx.x * kRulesThreads + threadIdx.x;
  if (r >= R) return;
  const int o = op[r];
  int s = slot[r];
  s = s < 0 ? 0 : (s > S - 1 ? S - 1 : s);  // jnp.clip(slot, 0, S-1)
  const float t = thresh[r];
  int cb = cbit[r];
  cb = cb < 0 ? 0 : cb;  // jnp.clip(cbit, 0, None)
  const int cw = cb >> 5;
  const uint32_t csh = static_cast<uint32_t>(cb & 31);
  const bool bitop = o == kOpContains || o == kOpEqs;
  const int words = R >> 5;
  const int w = r >> 5;
  const bool lead = (threadIdx.x & 31) == 0;
  const int b0 = blockIdx.y * kRulesPubs;
  const int b1 = min(B, b0 + kRulesPubs);
  for (int b = b0; b < b1; ++b) {
    bool res;
    if (bitop) {
      // jnp.take's fill mode: a word past the mask reads as all ones
      const uint32_t word = cw < W ? cmask[static_cast<size_t>(b) * W + cw] : kFull;
      res = (word >> csh) & 1u;
    } else {
      const float f = feats[static_cast<size_t>(b) * S + s];
      switch (o) {
        case kOpGt: res = f > t; break;
        case kOpGte: res = f >= t; break;
        case kOpLt: res = f < t; break;
        case kOpLte: res = f <= t; break;
        case kOpEq: res = f == t; break;
        default: res = f != t;  // OP_NE and the OP_NONE pad rows
      }
      res = res || isnan(f);  // skip-to-pass
    }
    const uint32_t bits = __ballot_sync(kFull, res);
    if (lead) out[static_cast<size_t>(b) * words + w] = bits;
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
// A batch past the grid's y limit (65535 runs of kRulesPubs publishes) is
// refused with cudaErrorInvalidConfiguration.
int pk_rules_eval(const int* op, const int* slot, const float* thresh, const int* cbit, int R,
                  const float* feats, int S, const uint32_t* cmask, int W, int B, uint32_t* out,
                  void* stream) {
  if (B > 0 && R > 0) {
    const int runs = (B + kRulesPubs - 1) / kRulesPubs;
    if (runs > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
    const dim3 grid((R + kRulesThreads - 1) / kRulesThreads, runs);
    rules_eval_kernel<<<grid, kRulesThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        op, slot, thresh, cbit, R, feats, S, cmask, W, B, out);
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
