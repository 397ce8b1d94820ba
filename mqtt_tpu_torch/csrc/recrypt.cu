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
// is operation-bound. The design: one thread per block; the S-box (the
// FIPS-197 table below, which the tests pin against the S-box that
// mqtt_tpu_torch/ops/recrypt.py builds from the field definition) is turned
// into the four fused SubBytes+ShiftRows+MixColumns tables in shared memory
// by each CUDA block, so a round is 16 shared-memory lookups and 16 XORs on
// four 32-bit column words; counters, round keys and output move as 16-byte
// loads and stores. The state layout is the JAX kernel's (column-major,
// state[4c+r]; a column word holds row r in byte r), so the result is the
// same bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAesThreads = 256;  // one AES block per thread; also the table size
constexpr int kRoundKeyRows = 11;

// the AES S-box (FIPS-197 figure 7)
__constant__ uint8_t kSbox[256] = {
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

__device__ __forceinline__ uint32_t b0(uint32_t w) { return w & 0xFFu; }
__device__ __forceinline__ uint32_t b1(uint32_t w) { return (w >> 8) & 0xFFu; }
__device__ __forceinline__ uint32_t b2(uint32_t w) { return (w >> 16) & 0xFFu; }
__device__ __forceinline__ uint32_t b3(uint32_t w) { return w >> 24; }

__global__ void keystream_kernel(const uint4* __restrict__ key_table, int T,
                                 const int* __restrict__ kidx, const uint4* __restrict__ counters,
                                 int N, uint4* __restrict__ out) {
  __shared__ uint32_t t0[256], t1[256], t2[256], t3[256], sb[256];
  {
    const uint32_t s = kSbox[threadIdx.x];
    const uint32_t s2 = ((s << 1) ^ (0x1Bu * (s >> 7))) & 0xFFu;  // xtime
    const uint32_t s3 = s2 ^ s;
    sb[threadIdx.x] = s;
    t0[threadIdx.x] = s2 | (s << 8) | (s << 16) | (s3 << 24);
    t1[threadIdx.x] = s3 | (s2 << 8) | (s << 16) | (s << 24);
    t2[threadIdx.x] = s | (s3 << 8) | (s2 << 16) | (s << 24);
    t3[threadIdx.x] = s | (s << 8) | (s3 << 16) | (s2 << 24);
  }
  __syncthreads();
  const int n = blockIdx.x * kAesThreads + threadIdx.x;
  if (n >= N) return;
  // jnp.take along the key axis: a negative index wraps once, and an index
  // still out of range reads the uint8 fill value 0xFF
  int k = kidx[n];
  if (k < 0) k += T;
  const bool valid = k >= 0 && k < T;
  const uint4* rk = key_table + static_cast<size_t>(valid ? k : 0) * kRoundKeyRows;
  const uint4 fill = make_uint4(0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu);
  const uint4 c = counters[n];
  uint4 kr = valid ? rk[0] : fill;
  uint32_t w0 = c.x ^ kr.x, w1 = c.y ^ kr.y, w2 = c.z ^ kr.z, w3 = c.w ^ kr.w;
#pragma unroll
  for (int rnd = 1; rnd < 10; ++rnd) {
    kr = valid ? rk[rnd] : fill;
    // output column c takes T_k[byte k of column (c+k) % 4]
    const uint32_t n0 = t0[b0(w0)] ^ t1[b1(w1)] ^ t2[b2(w2)] ^ t3[b3(w3)] ^ kr.x;
    const uint32_t n1 = t0[b0(w1)] ^ t1[b1(w2)] ^ t2[b2(w3)] ^ t3[b3(w0)] ^ kr.y;
    const uint32_t n2 = t0[b0(w2)] ^ t1[b1(w3)] ^ t2[b2(w0)] ^ t3[b3(w1)] ^ kr.z;
    const uint32_t n3 = t0[b0(w3)] ^ t1[b1(w0)] ^ t2[b2(w1)] ^ t3[b3(w2)] ^ kr.w;
    w0 = n0;
    w1 = n1;
    w2 = n2;
    w3 = n3;
  }
  // last round: SubBytes + ShiftRows + AddRoundKey, no MixColumns
  kr = valid ? rk[10] : fill;
  uint4 o;
  o.x = (sb[b0(w0)] | (sb[b1(w1)] << 8) | (sb[b2(w2)] << 16) | (sb[b3(w3)] << 24)) ^ kr.x;
  o.y = (sb[b0(w1)] | (sb[b1(w2)] << 8) | (sb[b2(w3)] << 16) | (sb[b3(w0)] << 24)) ^ kr.y;
  o.z = (sb[b0(w2)] | (sb[b1(w3)] << 8) | (sb[b2(w0)] << 16) | (sb[b3(w1)] << 24)) ^ kr.z;
  o.w = (sb[b0(w3)] | (sb[b1(w0)] << 8) | (sb[b2(w1)] << 16) | (sb[b3(w2)] << 24)) ^ kr.w;
  out[n] = o;
}

}  // namespace

extern "C" {

const char* rc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K6: out[N, 16] keystream. key_table [T, 11, 16], counters and out 16-byte
// aligned.
int rc_keystream(const uint8_t* key_table, int T, const int* kidx, const uint8_t* counters, int N,
                 uint8_t* out, void* stream) {
  if (N > 0) {
    const int grid = (N + kAesThreads - 1) / kAesThreads;
    keystream_kernel<<<grid, kAesThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const uint4*>(key_table), T, kidx,
        reinterpret_cast<const uint4*>(counters), N, reinterpret_cast<uint4*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
