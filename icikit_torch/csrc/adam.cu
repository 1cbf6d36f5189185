// One-pass Adam for Hopper (sm_90a), bound with ctypes.
//
//   adam <- _adam_kernel (B12, icikit/ops/adam.py:50, _leaf_update_pallas,
//           pallas_call :71).
//      One pass per parameter leaf: read p (float32), m and v (float32 or
//      bf16) and g (float32, bf16 or fp16, widened in registers), write p,
//      m and v in place. optax.adam with eps_root = 0:
//        m' = b1 m + (1 - b1) g,  v' = b2 v + (1 - b2) g^2,
//        p' = p - lr (m' c1) / (sqrt(v' c2) + eps),
//      float32 arithmetic, each operation rounded once (__fmul_rn,
//      __fadd_rn, __fdiv_rn, __fsqrt_rn: no contraction into FMAs), the
//      moments rounded once on the store. That is the order PyTorch's
//      eager elementwise ops take in the plain version
//      (ops/cuda_adam.adam_leaf_plain), so the two agree bit for bit.
//      lr, c1 = 1/(1 - b1^t) and c2 = 1/(1 - b2^t) are read from a (3,)
//      device tensor and the guard flag `ok` from a device bool (null: no
//      guard), so the train step stays free of host syncs; with ok false
//      the kernel writes nothing (guard="device"'s where(ok, new, old)).
//      The TPU kernel needs a (rows, 128) view whose row count meets the
//      operands' sublane rule (_use_pallas); a thread here takes any
//      element, so every floating leaf goes through this kernel and that
//      gate has nothing left to decide. The TPU's aliasing penalty
//      (adam.py:150-153) has no counterpart: the update is in place.
//      Bound: bytes. At the bench's 211 M parameters with float32 moments
//      and bf16 gradients, 26 B an element, 5.49 GB, 1.64 ms at 3.35 TB/s.
//      A grid-stride loop, one element a thread a step.
//
// The entry returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 132 * 16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename M, typename G>
__global__ void __launch_bounds__(THREADS)
adam_kernel(float* __restrict__ p, M* __restrict__ m, M* __restrict__ v,
            const G* __restrict__ g, const float* __restrict__ sc,
            const bool* __restrict__ ok, int64_t n, float b1, float omb1,
            float b2, float omb2, float eps) {
  if (ok != nullptr && !*ok) return;
  const float lr = sc[0], c1 = sc[1], c2 = sc[2];
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * THREADS) {
    const float gf = to_f(g[i]);
    const float mf = __fadd_rn(__fmul_rn(to_f(m[i]), b1), __fmul_rn(gf, omb1));
    const float vf = __fadd_rn(__fmul_rn(to_f(v[i]), b2),
                               __fmul_rn(__fmul_rn(gf, gf), omb2));
    const float num = __fmul_rn(lr, __fmul_rn(mf, c1));
    const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(vf, c2)), eps);
    p[i] = __fsub_rn(p[i], __fdiv_rn(num, den));
    m[i] = from_f<M>(mf);
    v[i] = from_f<M>(vf);
  }
}

template <typename M, typename G>
int launch(float* p, void* m, void* v, const void* g, const float* sc,
           const bool* ok, int64_t n, float b1, float omb1, float b2,
           float omb2, float eps, cudaStream_t st) {
  int64_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  if (blocks < 1) blocks = 1;
  adam_kernel<M, G><<<(unsigned)blocks, THREADS, 0, st>>>(
      p, static_cast<M*>(m), static_cast<M*>(v), static_cast<const G*>(g),
      sc, ok, n, b1, omb1, b2, omb2, eps);
  return (int)cudaGetLastError();
}

template <typename M>
int launch_g(int gdtype, float* p, void* m, void* v, const void* g,
             const float* sc, const bool* ok, int64_t n, float b1,
             float omb1, float b2, float omb2, float eps, cudaStream_t st) {
  if (gdtype == 0)
    return launch<M, float>(p, m, v, g, sc, ok, n, b1, omb1, b2, omb2, eps,
                            st);
  if (gdtype == 1)
    return launch<M, bf16>(p, m, v, g, sc, ok, n, b1, omb1, b2, omb2, eps, st);
  if (gdtype == 2)
    return launch<M, __half>(p, m, v, g, sc, ok, n, b1, omb1, b2, omb2, eps,
                             st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// p (n,) float32; m, v (n,) in mdtype (0 float32, 1 bfloat16); g (n,) in
// gdtype (0 float32, 1 bfloat16, 2 float16); sc (3,) float32 [lr, c1, c2];
// ok a device bool or null. b1, 1 - b1, b2, 1 - b2 and eps as float32.
int icikit_adam(int mdtype, int gdtype, float* p, void* m, void* v,
                const void* g, const float* sc, const bool* ok, int64_t n,
                float b1, float omb1, float b2, float omb2, float eps,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mdtype == 0)
    return launch_g<float>(gdtype, p, m, v, g, sc, ok, n, b1, omb1, b2, omb2,
                           eps, st);
  if (mdtype == 1)
    return launch_g<bf16>(gdtype, p, m, v, g, sc, ok, n, b1, omb1, b2, omb2,
                          eps, st);
  return (int)cudaErrorInvalidValue;
}

// Kernel attributes for the build log: which 0 float32 moments with bf16
// gradients, 1 bf16 moments with bf16 gradients.
int icikit_adam_regs(int which, int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = which == 0
      ? cudaFuncGetAttributes(&attr, adam_kernel<float, bf16>)
      : cudaFuncGetAttributes(&attr, adam_kernel<bf16, bf16>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
