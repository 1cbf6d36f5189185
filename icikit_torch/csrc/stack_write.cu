// Save-stack writer and reader for Hopper (sm_90a), bound with ctypes.
//
//   stack_write <- _write_kernel (B16, icikit/ops/stack_write.py:89,
//                  stack_write :101, pallas_call :126).
//   stack_read  <- _read_kernel (B16, :96, stack_read :136, pallas_call
//                  :158).
//      stack[i] = x in place, and stack[i] out, for one slice of an
//      (L, ...) stack. On the TPU the slice index rides as a
//      scalar-prefetch operand and the stack is donated
//      (input_output_aliases) so that only the addressed slice moves, and
//      both sides of the copy are layout-pinned (the reason the kernels
//      exist: XLA's scan put layout copies between the stacked save
//      buffers and the backward's operands). Here a buffer has no layout
//      to pin, so what remains is the copy itself: one slice, in place,
//      nothing else of the stack touched. The kernel takes the slice
//      offset i * slice_bytes itself, from the stack's base pointer, and
//      copies bytes of one dtype: the wrapper casts x to the stack's
//      dtype first (JAX's x.astype(stack.dtype), :116).
//      Bound: bytes, one read and one write of the slice: 2 x 16 MiB /
//      3.35 TB/s = 10.0 us for the base train step's residual slice (b 8,
//      s 1024, d 1024, bf16), 5.0 us for a bf16 w1 gradient slice.
//      Design for that bound: a persistent grid (the SMs times the CTAs an
//      SM the occupancy API reports) of 256 threads; a thread issues LOADS
//      16-byte loads before their stores, so LOADS x 16 bytes are in
//      flight a thread, neighbouring threads on neighbouring addresses
//      (a warp moves 512 contiguous bytes a load); the side of the copy
//      that is touched once streams past L2 (ld.global.cs for a read's
//      slice, st.global.cs for a write's), and the side the next layer
//      uses (the input written, the slice read out) keeps its lines. The
//      base pointers and the slice size must be 16-byte aligned (the
//      wrapper raises otherwise): JAX's gate (slice size a multiple of 128
//      elements) makes every slice on the path a multiple of 256 bytes.
//
// Every entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int LOADS = 4;

// SRC_ONCE: the source is touched once (a read's stack slice): it is
// loaded with the streaming hint. Else the destination is (a write's
// slice, read back only in the backward): it is stored with the
// streaming hint, and the source (the layer's input, which the layer
// reads next) keeps its L2 lines.
template <bool SRC_ONCE>
__device__ __forceinline__ void copy16(uint4* __restrict__ dst,
                                       const uint4* __restrict__ src,
                                       int64_t n16) {
  const int64_t step = (int64_t)gridDim.x * THREADS * LOADS;
  for (int64_t j0 = (int64_t)blockIdx.x * THREADS * LOADS + threadIdx.x;
       j0 < n16; j0 += step) {
    uint4 r[LOADS];
#pragma unroll
    for (int k = 0; k < LOADS; ++k)
      if (j0 + k * THREADS < n16)
        r[k] = SRC_ONCE ? __ldcs(src + j0 + k * THREADS)
                        : src[j0 + k * THREADS];
#pragma unroll
    for (int k = 0; k < LOADS; ++k)
      if (j0 + k * THREADS < n16) {
        if (SRC_ONCE)
          dst[j0 + k * THREADS] = r[k];
        else
          __stcs(dst + j0 + k * THREADS, r[k]);
      }
  }
}

// stack + i * slice_bytes <- x
__global__ void __launch_bounds__(THREADS)
stack_write_kernel(unsigned char* __restrict__ stack,
                   const unsigned char* __restrict__ x, int64_t i,
                   int64_t slice_bytes) {
  copy16<false>(reinterpret_cast<uint4*>(stack + i * slice_bytes),
                reinterpret_cast<const uint4*>(x), slice_bytes / 16);
}

// out <- stack + i * slice_bytes
__global__ void __launch_bounds__(THREADS)
stack_read_kernel(const unsigned char* __restrict__ stack,
                  unsigned char* __restrict__ out, int64_t i,
                  int64_t slice_bytes) {
  copy16<true>(reinterpret_cast<uint4*>(out),
               reinterpret_cast<const uint4*>(stack + i * slice_bytes),
               slice_bytes / 16);
}

// The grid for a slice: enough CTAs for one pass, at most the SMs times
// the CTAs an SM holds.
unsigned blocks_for(const void* kernel, int64_t slice_bytes) {
  static int64_t cap = 0;
  if (cap == 0) {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, THREADS, 0);
    cap = (int64_t)(sms > 0 ? sms : 1) * (per > 0 ? per : 1);
  }
  const int64_t per_cta = (int64_t)THREADS * LOADS * 16;
  const int64_t blocks = (slice_bytes + per_cta - 1) / per_cta;
  return (unsigned)(blocks < 1 ? 1 : blocks < cap ? blocks : cap);
}

bool bad_args(const void* a, const void* b, int64_t i, int64_t n_slices,
              int64_t slice_bytes) {
  return i < 0 || i >= n_slices || slice_bytes <= 0 || slice_bytes % 16 ||
         reinterpret_cast<uintptr_t>(a) % 16 ||
         reinterpret_cast<uintptr_t>(b) % 16;
}

}  // namespace

extern "C" {

// stack: n_slices x slice_bytes bytes; x: slice_bytes bytes; i in
// [0, n_slices). Pointers and slice_bytes 16-byte aligned.
int icikit_stack_write(void* stack, const void* x, int64_t i,
                       int64_t n_slices, int64_t slice_bytes, void* stream) {
  if (bad_args(stack, x, i, n_slices, slice_bytes))
    return (int)cudaErrorInvalidValue;
  stack_write_kernel<<<blocks_for((const void*)stack_write_kernel,
                                  slice_bytes),
                       THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned char*>(stack),
      static_cast<const unsigned char*>(x), i, slice_bytes);
  return (int)cudaGetLastError();
}

// out: slice_bytes bytes; as above.
int icikit_stack_read(const void* stack, void* out, int64_t i,
                      int64_t n_slices, int64_t slice_bytes, void* stream) {
  if (bad_args(stack, out, i, n_slices, slice_bytes))
    return (int)cudaErrorInvalidValue;
  stack_read_kernel<<<blocks_for((const void*)stack_read_kernel, slice_bytes),
                      THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(stack),
      static_cast<unsigned char*>(out), i, slice_bytes);
  return (int)cudaGetLastError();
}

// Kernel attributes for the build log: 0 stack_write_kernel, 1
// stack_read_kernel.
int icikit_stack_regs(int which, int* regs, int* local_bytes) {
  const void* fns[] = {(const void*)stack_write_kernel,
                       (const void*)stack_read_kernel};
  if (which < 0 || which >= 2) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fns[which]);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
