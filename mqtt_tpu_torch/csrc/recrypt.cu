// Hand-written Hopper kernel of the tenant re-encryption plane.
//
// Replaces the jitted jnp graph of the JAX package's mqtt_tpu/ops/recrypt.py:
//
//   K6 keystream   keystream_core (recrypt.py:214-257)
//
// AES-128 of N counter blocks, each under the round keys that kidx picks
// from a dense key table. Built with nvcc for sm_90a into a shared library
// with a plain C interface (mqtt_tpu_torch/ops/kernels.py loads it with
// ctypes); the entry point launches on the caller's stream, never
// synchronises, allocates nothing and returns cudaGetLastError().
//
// What bounds it on the card: every block is ten dependent rounds of table
// lookups and XORs over 16 bytes against 48 bytes moved (a 16-byte counter
// in, 16 bytes out, a 4-byte key index; the key table stays in L2), so it
// is operation-bound, and on the path's small launches (2,048 and 32,768
// blocks) latency-bound. The design:
//
// - The fused SubBytes+ShiftRows+MixColumns table T0 is built at compile
//   time from the S-box below (a __device__ constant-initialised array in
//   global memory, not rebuilt from __constant__ by every CUDA block). The
//   other three tables are byte rotations of T0 (__funnelshift_l), and the
//   S-box itself is byte 1 of T0, so a CUDA block stages one 1 KB table.
// - The table is staged into shared memory once per bank (32 copies, 32
//   KB: word 32*x + b holds T0[x]), and lane l reads copy l, so a warp's
//   32 lookups never conflict (Tezcan, "Optimization of Advanced
//   Encryption Standard on Graphics Processing Units", IEEE Access 2021).
//   Each thread loads one word of T0 and writes its 32 copies as 8
//   16-byte stores in a rotated order, so each quarter-warp store hits 8
//   distinct bank groups: staging costs one global load and eight stores
//   per thread, where a per-bank copy loaded from memory would cost eight
//   16-byte loads; at the small shapes it is the same one prologue.
// - Below kOneLaneBlocks blocks, four lanes share an AES block, one
//   32-bit column each; a round takes the three other columns' bytes by
//   __shfl_sync inside the quad, so the fan-out's 2,048 blocks run as 32
//   CUDA blocks on 32 SMs instead of 8 on 8. From kOneLaneBlocks up one
//   thread per AES block already spreads over most SMs, and the quad's
//   shuffles and four times the key loads cost more than they hide (on an
//   H100 80GB HBM3 at 700 W, chip_smoke.py: 32,768 blocks took 0.0058 ms
//   on one lane against 0.0062 on four; 2,048 blocks 0.0036 on four
//   against 0.0050 on one).
// - Each lane loads its key index, its round-key words for all eleven
//   rounds and its counter before the table is staged, so these dependent
//   loads overlap the staging and nothing is loaded inside the rounds.
//
// The state layout is the JAX kernel's (column-major, state[4c+r]; a column
// word holds row r in byte r), so the result is the same bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAesThreads = 256;  // threads per CUDA block; also T0's length
constexpr int kRoundKeyRows = 11;
constexpr int kCopies = 32;  // one copy of T0 per shared-memory bank
constexpr int kOneLaneBlocks = 1 << 14;  // from 64 one-lane CUDA blocks up
constexpr unsigned kFull = 0xFFFFFFFFu;

// the AES S-box (FIPS-197 figure 7)
constexpr uint8_t kSbox[256] = {
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b, 0xfe, 0xd7, 0xab, 0x76,
    0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0, 0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0,
    0xb7, 0xfd, 0x93, 0x26, 0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2, 0xeb, 0x27, 0xb2, 0x75,
    0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0, 0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84,
    0x53, 0xd1, 0x00, 0xed, 0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f, 0x50, 0x3c, 0x9f, 0xa8,
    0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5, 0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2,
    0xcd, 0x0c, 0x13, 0xec, 0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14, 0xde, 0x5e, 0x0b, 0xdb,
    0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c, 0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79,
    0xe7, 0xc8, 0x37, 0x6d, 0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f, 0x4b, 0xbd, 0x8b, 0x8a,
    0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e, 0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e,
    0xe1, 0xf8, 0x98, 0x11, 0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f, 0xb0, 0x54, 0xbb, 0x16,
};

struct Table256 {
  uint32_t w[256];
};

__host__ __device__ constexpr uint32_t xtime(uint32_t s) { return ((s << 1) ^ (0x1Bu * (s >> 7))) & 0xFFu; }

// T0[x] = (2s, s, s, 3s) in bytes 0..3, s = S[x]
__host__ __device__ constexpr Table256 make_t0() {
  Table256 t{};
  for (int i = 0; i < 256; ++i) {
    const uint32_t s = kSbox[i];
    t.w[i] = xtime(s) | (s << 8) | (s << 16) | ((xtime(s) ^ s) << 24);
  }
  return t;
}

__device__ const Table256 kT0 = make_t0();

__device__ __forceinline__ uint32_t rotl(uint32_t v, int k) { return __funnelshift_l(v, v, k); }

// tab points at the lane's own copy: T0[x] is tab[x << 5]
__device__ __forceinline__ uint32_t t0(const uint32_t* tab, uint32_t w, int byte) {
  return tab[((w >> (8 * byte)) & 0xFFu) << 5];
}

// output column of a full round from the four input columns a = c, b = c+1,
// c2 = c+2, d = c+3: T0[a.0] ^ T1[b.1] ^ T2[c.2] ^ T3[d.3]
__device__ __forceinline__ uint32_t round_col(const uint32_t* tab, uint32_t a, uint32_t b,
                                              uint32_t c, uint32_t d) {
  return t0(tab, a, 0) ^ rotl(t0(tab, b, 1), 8) ^ rotl(t0(tab, c, 2), 16) ^ rotl(t0(tab, d, 3), 24);
}

// last round (SubBytes + ShiftRows): S[x] is byte 1 of T0[x]
__device__ __forceinline__ uint32_t last_col(const uint32_t* tab, uint32_t a, uint32_t b,
                                             uint32_t c, uint32_t d) {
  return ((t0(tab, a, 0) >> 8) & 0xFFu) | (t0(tab, b, 1) & 0xFF00u) |
         ((t0(tab, c, 2) << 8) & 0xFF0000u) | ((t0(tab, d, 3) << 16) & 0xFF000000u);
}

// LANES = 4: lane c of a quad holds column c; LANES = 1: a thread holds all
// four. Words are little-endian column words of the [T, 11, 16] key table
// and of the [N, 16] counters and output. The key index, the round keys and
// the counter are loaded before the table is staged, so their latency
// overlaps the staging.
template <int LANES>
__global__ void __launch_bounds__(kAesThreads) keystream_kernel(
    const uint32_t* __restrict__ key_table, int T, const int* __restrict__ kidx,
    const uint32_t* __restrict__ counters, int N, uint32_t* __restrict__ out) {
  __shared__ uint4 tab4[256 * kCopies / 4];
  const long long g = static_cast<long long>(blockIdx.x) * kAesThreads + threadIdx.x;
  const long long n = g / LANES;
  const bool live = n < N;  // LANES = 4: a whole quad is live or not
  const int c = threadIdx.x % LANES;
  // jnp.take along the key axis: a negative index wraps once, and an index
  // still out of range reads the uint8 fill value 0xFF
  int k = live ? kidx[n] : 0;
  if (k < 0) k += T;
  const bool valid = k >= 0 && k < T;
  const uint32_t* rk = key_table + static_cast<size_t>(valid ? k : 0) * kRoundKeyRows * 4;
  // lane c's column of every round key (LANES = 1: all four columns)
  uint4 key[kRoundKeyRows];
  uint4 ctr = make_uint4(0, 0, 0, 0);
  if (live) {
#pragma unroll
    for (int r = 0; r < kRoundKeyRows; ++r) {
      if constexpr (LANES == 4) {
        key[r].x = valid ? __ldg(rk + 4 * r + c) : kFull;
      } else {
        key[r] = valid ? __ldg(reinterpret_cast<const uint4*>(rk) + r)
                       : make_uint4(kFull, kFull, kFull, kFull);
      }
    }
    if constexpr (LANES == 4)
      ctr.x = counters[n * 4 + c];
    else
      ctr = reinterpret_cast<const uint4*>(counters)[n];
  }
  {
    const uint32_t v = kT0.w[threadIdx.x];
    const uint4 q = make_uint4(v, v, v, v);
#pragma unroll
    for (int j = 0; j < kCopies / 4; ++j)
      tab4[threadIdx.x * (kCopies / 4) + ((j + threadIdx.x) & (kCopies / 4 - 1))] = q;
  }
  __syncthreads();
  if (!live) return;
  const uint32_t* tab = reinterpret_cast<const uint32_t*>(tab4) + (threadIdx.x & 31);
  if constexpr (LANES == 4) {
    const unsigned quad = 0xFu << ((threadIdx.x & 31) & ~3u);
    uint32_t w = ctr.x ^ key[0].x;
#pragma unroll
    for (int rnd = 1; rnd < 10; ++rnd) {
      const uint32_t w1 = __shfl_sync(quad, w, (c + 1) & 3, 4);
      const uint32_t w2 = __shfl_sync(quad, w, (c + 2) & 3, 4);
      const uint32_t w3 = __shfl_sync(quad, w, (c + 3) & 3, 4);
      w = round_col(tab, w, w1, w2, w3) ^ key[rnd].x;
    }
    const uint32_t w1 = __shfl_sync(quad, w, (c + 1) & 3, 4);
    const uint32_t w2 = __shfl_sync(quad, w, (c + 2) & 3, 4);
    const uint32_t w3 = __shfl_sync(quad, w, (c + 3) & 3, 4);
    out[n * 4 + c] = last_col(tab, w, w1, w2, w3) ^ key[10].x;
  } else {
    uint32_t w0 = ctr.x ^ key[0].x, w1 = ctr.y ^ key[0].y, w2 = ctr.z ^ key[0].z, w3 = ctr.w ^ key[0].w;
#pragma unroll
    for (int rnd = 1; rnd < 10; ++rnd) {
      const uint32_t n0 = round_col(tab, w0, w1, w2, w3) ^ key[rnd].x;
      const uint32_t n1 = round_col(tab, w1, w2, w3, w0) ^ key[rnd].y;
      const uint32_t n2 = round_col(tab, w2, w3, w0, w1) ^ key[rnd].z;
      const uint32_t n3 = round_col(tab, w3, w0, w1, w2) ^ key[rnd].w;
      w0 = n0;
      w1 = n1;
      w2 = n2;
      w3 = n3;
    }
    uint4 o;
    o.x = last_col(tab, w0, w1, w2, w3) ^ key[10].x;
    o.y = last_col(tab, w1, w2, w3, w0) ^ key[10].y;
    o.z = last_col(tab, w2, w3, w0, w1) ^ key[10].z;
    o.w = last_col(tab, w3, w0, w1, w2) ^ key[10].w;
    reinterpret_cast<uint4*>(out)[n] = o;
  }
}

}  // namespace

extern "C" {

const char* rc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K6: out[N, 16] keystream. key_table [T, 11, 16], counters and out 16-byte
// aligned. lanes (1 or 4; 0 picks by N) is the threads per AES block.
int rc_keystream(const uint8_t* key_table, int T, const int* kidx, const uint8_t* counters, int N,
                 uint8_t* out, int lanes, void* stream) {
  if (lanes == 0) lanes = N >= kOneLaneBlocks ? 1 : 4;
  if (lanes != 1 && lanes != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (N > 0) {
    const long long threads = static_cast<long long>(N) * lanes;
    const unsigned grid = static_cast<unsigned>((threads + kAesThreads - 1) / kAesThreads);
    const uint32_t* kt = reinterpret_cast<const uint32_t*>(key_table);
    const uint32_t* ct = reinterpret_cast<const uint32_t*>(counters);
    uint32_t* o = reinterpret_cast<uint32_t*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (lanes == 4)
      keystream_kernel<4><<<grid, kAesThreads, 0, st>>>(kt, T, kidx, ct, N, o);
    else
      keystream_kernel<1><<<grid, kAesThreads, 0, st>>>(kt, T, kidx, ct, N, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
