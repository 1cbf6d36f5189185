// Bitonic sorting-network kernels for Hopper (sm_90a), bound with ctypes.
//
// Two kernels carry icikit_torch's sort, one for each TPU kernel of
// icikit/ops/pallas_sort.py:
//
//   K1 net_kernel   <- _net_call   (pallas_sort.py:187-215). One CTA per
//      tile of 2^log2t elements. It runs every (db, strides) round it is
//      given back to back, with every stride below the tile. Strides < 32
//      pair lanes with __shfl_xor_sync, strides in [32, W) pair registers
//      of one thread, strides >= W pair through shared memory with a
//      __syncthreads between stages (W = 32 * E elements per warp).
//   K2 cross_kernel <- _cross_call (pallas_sort.py:218-277). The stages of
//      one merge round whose stride is at least the tile and whose Q-axis
//      bit lies in [lo, hi], in one pass: the array is viewed as
//      (n/span, A, G, B*tile); each CTA loads a (G, cb) block strided by
//      B*tile into shared memory, runs min/max along the bits of G and
//      writes it back.
//
// Direction is the reference's trick (pallas_sort.py:27-40, 150-177):
// every stage is a plain ascending compare-exchange, and a descending
// span is order-reversed at round boundaries (~x for int32, -x for f32),
// with the flip bit taken from the element's global index.
//
// Bound: both kernels stream the array once per launch (one read, one
// write of every element), so on an H100 a launch is bound by memory
// bandwidth: 2 * n * 4 bytes over 3.35 TB/s. K1 also does up to
// log2t * (log2t + 1) / 2 compare-exchange stages per element, which
// shared memory and registers keep off device memory. Both may run in
// place (in == out): a CTA reads its whole block before it writes it,
// and CTAs own disjoint blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int E = 16;           // K1 elements per thread
constexpr int W = 32 * E;       // K1 elements per warp segment
constexpr int MAX_ROUNDS = 32;
constexpr int CROSS_THREADS = 512;

struct Rounds {
  int count;
  int db[MAX_ROUNDS];  // direction bit of the global index; -1 = ascending
  int hi[MAX_ROUNDS];  // log2 of the round's first (largest) stride
  int lo[MAX_ROUNDS];  // log2 of its last stride
};

__device__ __forceinline__ int flip(int x, int bit) { return x ^ -bit; }
__device__ __forceinline__ float flip(float x, int bit) { return bit ? -x : x; }

__device__ __forceinline__ int dir_bit(int64_t g, int db) {
  return db < 0 ? 0 : (int)((g >> db) & 1);
}

// Ascending compare-exchange of a (lower index) and b. Equal keys keep
// their places, so the multiset is preserved bit for bit.
template <typename T>
__device__ __forceinline__ void ce(T& a, T& b) {
  const bool swap = b < a;
  const T lo = swap ? b : a;
  const T hi = swap ? a : b;
  a = lo;
  b = hi;
}

// Stride M * 32: registers r and r | M of one thread.
template <typename T, int M>
__device__ __forceinline__ void reg_stage(T (&v)[E]) {
#pragma unroll
  for (int r = 0; r < E; ++r)
    if ((r & M) == 0) ce(v[r], v[r | M]);
}

// Stride k < 32: lanes l and l ^ k, same register.
template <typename T>
__device__ __forceinline__ void shfl_stage(T (&v)[E], int k, int lane) {
  const bool is_lo = (lane & k) == 0;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const T o = __shfl_xor_sync(0xffffffffu, v[r], k);
    v[r] = is_lo ? ((o < v[r]) ? o : v[r]) : ((v[r] < o) ? o : v[r]);
  }
}

// Stride k >= W through shared memory: pair q -> (i, i + k).
template <typename T>
__device__ __forceinline__ void smem_stage(T* s, int half, int k) {
  for (int q = threadIdx.x; q < half; q += blockDim.x) {
    const int i = ((q & ~(k - 1)) << 1) | (q & (k - 1));
    T a = s[i], b = s[i + k];
    ce(a, b);
    s[i] = a;
    s[i + k] = b;
  }
}

// Thread (warp w, lane l) holds, in register r, the tile element
// w * W + r * 32 + l: loads and stores are coalesced and conflict-free.
template <typename T>
__global__ void __launch_bounds__(1024)
net_kernel(const T* in, T* out, int log2t,
           Rounds rounds) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int half = 1 << (log2t - 1);
  const int lane = threadIdx.x & 31;
  const int seg = (threadIdx.x >> 5) * W + lane;
  const int64_t base = (int64_t)blockIdx.x << log2t;

  T v[E];
#pragma unroll
  for (int r = 0; r < E; ++r) v[r] = in[base + seg + r * 32];
  bool in_regs = true;
  int prev = -1;

  for (int ri = 0; ri < rounds.count; ++ri) {
    const int db = rounds.db[ri];
    if (prev >= 0 || db >= 0) {
      if (!in_regs) {
#pragma unroll
        for (int r = 0; r < E; ++r) v[r] = s[seg + r * 32];
        in_regs = true;
      }
#pragma unroll
      for (int r = 0; r < E; ++r) {
        const int64_t g = base + seg + r * 32;
        v[r] = flip(v[r], dir_bit(g, prev) ^ dir_bit(g, db));
      }
    }
    prev = db;
    for (int j = rounds.hi[ri]; j >= rounds.lo[ri]; --j) {
      const int k = 1 << j;
      if (k >= W) {
        if (in_regs) {
#pragma unroll
          for (int r = 0; r < E; ++r) s[seg + r * 32] = v[r];
          in_regs = false;
          __syncthreads();
        }
        smem_stage(s, half, k);
        __syncthreads();
      } else {
        if (!in_regs) {
#pragma unroll
          for (int r = 0; r < E; ++r) v[r] = s[seg + r * 32];
          in_regs = true;
        }
        if (k < 32) {
          shfl_stage(v, k, lane);
        } else {
          switch (k >> 5) {
            case 1: reg_stage<T, 1>(v); break;
            case 2: reg_stage<T, 2>(v); break;
            case 4: reg_stage<T, 4>(v); break;
            default: reg_stage<T, 8>(v); break;
          }
        }
      }
    }
  }
  if (!in_regs) {
#pragma unroll
    for (int r = 0; r < E; ++r) v[r] = s[seg + r * 32];
  }
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int64_t g = base + seg + r * 32;
    out[g] = flip(v[r], dir_bit(g, prev));
  }
}

// One CTA per (G, cb) block of the (n/span, A, G, B*tile) view.
template <typename T>
__global__ void __launch_bounds__(CROSS_THREADS)
cross_kernel(const T* in, T* out, int64_t span,
             int log2t, int lo_bit, int log2g, int log2cb, int merge_only) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int cb = 1 << log2cb;
  const int g = 1 << log2g;
  const int64_t tile = (int64_t)1 << log2t;
  const int64_t b_lo = (int64_t)1 << lo_bit;
  const int64_t row_stride = b_lo * tile;               // G-axis stride
  const int64_t a_hi = (span >> log2t) >> (log2g + lo_bit);
  const int64_t cols = tile >> log2cb;                  // cb-blocks per tile
  const int64_t f = (int64_t)blockIdx.x / cols;
  const int64_t c = (int64_t)blockIdx.x % cols;
  const int64_t fold = a_hi * b_lo;
  const int64_t blk = f / fold;
  const int64_t a = (f / b_lo) % a_hi;
  const int64_t bb = f % b_lo;
  const int64_t base = blk * span + a * (g * row_stride) + bb * tile + c * cb;
  const int desc = merge_only ? 0 : (int)(blk & 1);
  const int total = g << log2cb;

  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int64_t off = base + (int64_t)(idx >> log2cb) * row_stride + (idx & (cb - 1));
    s[idx] = flip(in[off], desc);
  }
  __syncthreads();
  const int pairs = total >> 1;
  for (int d = g >> 1; d >= 1; d >>= 1) {
    for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
      const int p = q >> log2cb;
      const int col = q & (cb - 1);
      const int rlo = ((p & ~(d - 1)) << 1) | (p & (d - 1));
      T* pa = s + (rlo << log2cb) + col;
      T* pb = pa + (d << log2cb);
      T x = *pa, y = *pb;
      ce(x, y);
      *pa = x;
      *pb = y;
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int64_t off = base + (int64_t)(idx >> log2cb) * row_stride + (idx & (cb - 1));
    out[off] = flip(s[idx], desc);
  }
}

template <typename T>
int launch_net(const void* in, void* out, int64_t n, int log2t,
               const Rounds& rounds, cudaStream_t stream) {
  const int threads = (1 << log2t) / E;
  const size_t smem = sizeof(T) << log2t;
  cudaError_t err = cudaFuncSetAttribute(
      net_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = n >> log2t;
  net_kernel<T><<<(unsigned)blocks, threads, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), log2t, rounds);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cross(const void* in, void* out, int64_t n, int64_t span,
                 int log2t, int lo_bit, int hi_bit, int log2cb,
                 int merge_only, cudaStream_t stream) {
  const int log2g = hi_bit - lo_bit + 1;
  const size_t smem = sizeof(T) << (log2g + log2cb);
  cudaError_t err = cudaFuncSetAttribute(
      cross_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = n >> (log2g + log2cb);
  cross_kernel<T><<<(unsigned)blocks, CROSS_THREADS, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), span, log2t, lo_bit,
      log2g, log2cb, merge_only);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = int32, 1 = float32. Returns cudaGetLastError() after launch.
int icikit_net_pass(int dtype, const void* in, void* out, int64_t n,
                    int log2t, int nrounds, const int* db, const int* hi,
                    const int* lo, void* stream) {
  if (nrounds < 0 || nrounds > MAX_ROUNDS) return (int)cudaErrorInvalidValue;
  Rounds rounds;
  rounds.count = nrounds;
  for (int i = 0; i < nrounds; ++i) {
    rounds.db[i] = db[i];
    rounds.hi[i] = hi[i];
    rounds.lo[i] = lo[i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_net<int>(in, out, n, log2t, rounds, st);
  if (dtype == 1) return launch_net<float>(in, out, n, log2t, rounds, st);
  return (int)cudaErrorInvalidValue;
}

int icikit_cross_pass(int dtype, const void* in, void* out, int64_t n,
                      int64_t span, int log2t, int lo_bit, int hi_bit,
                      int log2cb, int merge_only, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_cross<int>(in, out, n, span, log2t, lo_bit, hi_bit, log2cb,
                             merge_only, st);
  if (dtype == 1)
    return launch_cross<float>(in, out, n, span, log2t, lo_bit, hi_bit,
                               log2cb, merge_only, st);
  return (int)cudaErrorInvalidValue;
}

// Kernel attributes for the build log: registers and spills per thread.
int icikit_kernel_regs(int which, int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = which == 0
      ? cudaFuncGetAttributes(&attr, net_kernel<int>)
      : cudaFuncGetAttributes(&attr, cross_kernel<int>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
