// The checked transport's segment checksum for Hopper (sm_90a), bound
// with ctypes.
//
//   segment_checksum_kernel <- no Pallas kernel: in JAX the fold is XLA
//      ops (icikit/parallel/transport.py:124-146, segment_checksum) that
//      XLA fuses into the exchange. PyTorch has no XOR reduction, so its
//      plain version (ops/cuda_integrity.py) folds by halving in log2(n)
//      launches; the checked rows exist to measure the integrity
//      overhead, and a launch-bound fold would measure the host instead.
//      For a contiguous (p, n) tensor of 1-, 2-, 4- or 8-byte elements it
//      writes out[r] = XOR over i of rotl(lane(x[r, i]), i % 32), where a
//      lane is the element's bits zero-extended to 32 (an 8-byte element
//      folds its high word into its low one first): JAX's fold of rank
//      r's block, bit for bit.
//      Bound: bytes, each element read once: p * n * itemsize at
//      3.35 TB/s (20.0 us for the checked sort's 8 x 2^21 int32).
//      Design for that bound: a (blocks, p) grid of 256 threads, at most
//      the SM count x 8 blocks in all; a thread issues UNROLL 16-byte
//      loads before it folds them (neighbouring threads on neighbouring
//      addresses) where the base is 16-byte aligned and a row is a
//      multiple of 16 bytes, else one element a load; the rotation is
//      one funnel shift; a warp XOR-reduces by shuffles and its lane 0
//      does one atomicXor into out[r], which the entry zeroes first
//      (cudaMemsetAsync on the same stream). n = 0 leaves the zeros and
//      launches nothing.
//
// Every entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int BLOCKS_PER_SM = 8;

__device__ __forceinline__ uint32_t lane32(uint8_t v) { return v; }
__device__ __forceinline__ uint32_t lane32(uint16_t v) { return v; }
__device__ __forceinline__ uint32_t lane32(uint32_t v) { return v; }
__device__ __forceinline__ uint32_t lane32(uint64_t v) {
  return (uint32_t)(v >> 32) ^ (uint32_t)v;
}

// rotate left by s in [0, 31]
__device__ __forceinline__ uint32_t rotl(uint32_t u, uint32_t s) {
  return __funnelshift_l(u, u, s);
}

// the fold of the 16 / sizeof(T) elements of one 16-byte word whose
// first element sits at position pos of its row
template <typename T>
__device__ __forceinline__ uint32_t fold16(uint4 w, int64_t pos) {
  constexpr int E = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&w);
  const uint32_t s0 = (uint32_t)pos & 31u;  // E divides 32: no wrap inside
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < E; ++k) acc ^= rotl(lane32(e[k]), s0 + k);
  return acc;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
segment_checksum_kernel(const T* __restrict__ x, int64_t n,
                        uint32_t* __restrict__ out) {
  const T* row = x + (int64_t)blockIdx.y * n;
  uint32_t acc = 0;
  if (VEC) {
    constexpr int E = 16 / sizeof(T);
    const uint4* v = reinterpret_cast<const uint4*>(row);
    const int64_t nv = n / E;
    const int64_t step = (int64_t)gridDim.x * THREADS * UNROLL;
    for (int64_t j0 = (int64_t)blockIdx.x * THREADS * UNROLL + threadIdx.x;
         j0 < nv; j0 += step) {
      uint4 r[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        r[k] = make_uint4(0u, 0u, 0u, 0u);  // zero lanes fold to 0
        if (j0 + k * THREADS < nv) r[k] = __ldg(v + j0 + k * THREADS);
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k)
        acc ^= fold16<T>(r[k], (j0 + k * THREADS) * E);
    }
  } else {
    const int64_t step = (int64_t)gridDim.x * THREADS;
    for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n;
         i += step)
      acc ^= rotl(lane32(row[i]), (uint32_t)i & 31u);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc ^= __shfl_xor_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0 && acc) atomicXor(out + blockIdx.y, acc);
}

template <typename T, bool VEC>
cudaError_t launch(const void* x, uint32_t* out, int64_t p, int64_t n,
                   int sms, cudaStream_t stream) {
  const int64_t units = VEC ? n * (int64_t)sizeof(T) / 16 : n;
  const int64_t per_block = VEC ? (int64_t)THREADS * UNROLL : THREADS;
  int64_t blocks = (units + per_block - 1) / per_block;
  int64_t cap = (int64_t)sms * BLOCKS_PER_SM / p;
  if (cap < 1) cap = 1;
  if (blocks > cap) blocks = cap;
  dim3 grid((unsigned)blocks, (unsigned)p);
  segment_checksum_kernel<T, VEC><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), n, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool vec, const void* x, uint32_t* out, int64_t p,
                     int64_t n, int sms, cudaStream_t stream) {
  return vec ? launch<T, true>(x, out, p, n, sms, stream)
             : launch<T, false>(x, out, p, n, sms, stream);
}

}  // namespace

extern "C" {

// out (p,) uint32 <- the fold of each row of x (p, n), elements of
// `width` bytes (1, 2, 4 or 8); x contiguous.
int icikit_segment_checksum(const void* x, void* out, int64_t p, int64_t n,
                            int width, int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p < 0 || n < 0 || p > 65535 || sms < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)p * 4, s);
  if (e != cudaSuccess) return (int)e;
  if (p == 0 || n == 0) return 0;
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   (n * width) % 16 == 0;
  uint32_t* o = static_cast<uint32_t*>(out);
  switch (width) {
    case 1: return (int)dispatch<uint8_t>(vec, x, o, p, n, sms, s);
    case 2: return (int)dispatch<uint16_t>(vec, x, o, p, n, sms, s);
    case 4: return (int)dispatch<uint32_t>(vec, x, o, p, n, sms, s);
    case 8: return (int)dispatch<uint64_t>(vec, x, o, p, n, sms, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Registers and local (spill) bytes a thread of each instantiation, in
// the order 8, 16, 32, 64 bits, each 16-byte loads then element loads.
int icikit_integrity_regs(int which, int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e;
  switch (which) {
    case 0: e = cudaFuncGetAttributes(&a, segment_checksum_kernel<uint8_t, true>); break;
    case 1: e = cudaFuncGetAttributes(&a, segment_checksum_kernel<uint8_t, false>); break;
    case 2: e = cudaFuncGetAttributes(&a, segment_checksum_kernel<uint16_t, true>); break;
    case 3: e = cudaFuncGetAttributes(&a, segment_checksum_kernel<uint16_t, false>); break;
    case 4: e = cudaFuncGetAttributes(&a, segment_checksum_kernel<uint32_t, true>); break;
    case 5: e = cudaFuncGetAttributes(&a, segment_checksum_kernel<uint32_t, false>); break;
    case 6: e = cudaFuncGetAttributes(&a, segment_checksum_kernel<uint64_t, true>); break;
    case 7: e = cudaFuncGetAttributes(&a, segment_checksum_kernel<uint64_t, false>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

}  // extern "C"
