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
//      Design for that bound: a grid-stride loop, 16 bytes a thread a
//      step (uint4), neighbouring threads on neighbouring addresses, so
//      each warp moves 512 contiguous bytes a step; up to 16 CTAs of 256
//      threads an SM keep enough loads in flight to stream. The base
//      pointers and the slice size must be 16-byte aligned (the wrapper
//      raises otherwise): JAX's gate (slice size a multiple of 128
//      elements) makes every slice on the path a multiple of 256 bytes.
//
// Every entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 132 * 16;

__device__ __forceinline__ void copy16(uint4* __restrict__ dst,
                                       const uint4* __restrict__ src,
                                       int64_t n16) {
  for (int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x; j < n16;
       j += (int64_t)gridDim.x * THREADS)
    dst[j] = src[j];
}

// stack + i * slice_bytes <- x
__global__ void __launch_bounds__(THREADS)
stack_write_kernel(unsigned char* __restrict__ stack,
                   const unsigned char* __restrict__ x, int64_t i,
                   int64_t slice_bytes) {
  copy16(reinterpret_cast<uint4*>(stack + i * slice_bytes),
         reinterpret_cast<const uint4*>(x), slice_bytes / 16);
}

// out <- stack + i * slice_bytes
__global__ void __launch_bounds__(THREADS)
stack_read_kernel(const unsigned char* __restrict__ stack,
                  unsigned char* __restrict__ out, int64_t i,
                  int64_t slice_bytes) {
  copy16(reinterpret_cast<uint4*>(out),
         reinterpret_cast<const uint4*>(stack + i * slice_bytes),
         slice_bytes / 16);
}

unsigned blocks_for(int64_t slice_bytes) {
  int64_t blocks = (slice_bytes / 16 + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  return (unsigned)(blocks < 1 ? 1 : blocks);
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
  stack_write_kernel<<<blocks_for(slice_bytes), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned char*>(stack),
      static_cast<const unsigned char*>(x), i, slice_bytes);
  return (int)cudaGetLastError();
}

// out: slice_bytes bytes; as above.
int icikit_stack_read(const void* stack, void* out, int64_t i,
                      int64_t n_slices, int64_t slice_bytes, void* stream) {
  if (bad_args(stack, out, i, n_slices, slice_bytes))
    return (int)cudaErrorInvalidValue;
  stack_read_kernel<<<blocks_for(slice_bytes), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
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
