// The int8 matvec for Hopper (sm_90a), bound with ctypes.
//
//   quant_matvec <- _matvec_kernel (B15, icikit/ops/quant.py:108;
//                   quant_matvec, pallas_call :167).
//      out (rows, N) float32 = (x (rows, K) . w8 (N, K)^T) * scale (N,):
//      int8 weights with the contraction last, one float32 scale per
//      output channel applied to the float32 accumulator once. The TPU
//      kernel keeps all of x in VMEM and tiles the output channels; a CTA
//      cannot hold x, so the kernels here tile rows as well as channels,
//      and each weight byte crosses device memory once per row tile.
//      The int8 block is widened to the compute type in shared memory
//      only: device memory streams it at one byte an element.
//
//      Two regimes on the int8 decode path of `base`:
//      - the decode step, rows = b = 8: bytes. wqkv (3072 x 1024) is 3.1
//        MB, 0.94 us at 3.35 TB/s; w_out (32768 x 1024) 33.6 MB, 10.0 us.
//        qmv_bf16_skinny: one CTA per 16 channels, all rows (<= 16) in one
//        m16 tile, the four warps splitting each 256-wide K chunk and
//        summing their partials through shared memory at the end, so
//        N/16 CTAs stream the weights (64 to 2048 on that path).
//      - the prefill, rows = b*s = 4096: operations. About 103 GFLOP a
//        layer (25.8 wqkv, 8.6 wo, 34.4 w1, 34.4 w2), 0.10 ms at 989
//        TFLOP/s. qmv_bf16_tile: a 64 x 64 output tile a CTA, four warps
//        of 16 rows, K in chunks of 64 staged through shared memory.
//      bf16 x runs on the tensor cores (mma.sync m16n8k16, bf16 in, float32
//      accumulate): every int8 value is a bf16 integer, so each product is
//      exact and only the summation order differs from the plain version.
//      float32 x (the card's float32 checks) runs qmv_f32 with plain FMA.
//      No pipelining, no TMA, no wgmma: a simple kernel, right first.
//
// Every entry returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MMA_THREADS = 128;   // bf16: 4 warps
constexpr int F32_THREADS = 256;
constexpr int SKINNY_ROWS = 16;    // rows one m16 tile holds
constexpr int SK_BN = 16;          // skinny: channels a CTA
constexpr int SK_BK = 256;         // skinny: K a chunk, 64 a warp
constexpr int TL_BM = 64, TL_BN = 64, TL_BK = 64;  // tile kernel

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D (16x8, f32) += A (16x16, bf16, row) * B (16x8, bf16, col).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Sixteen int8 weights -> sixteen bf16 (exact) at dst (16-byte aligned).
__device__ __forceinline__ void widen16(uint4 raw, bf16* dst) {
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
  __align__(16) bf16 t[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) t[j] = __float2bfloat16_rn((float)e[j]);
  reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(t)[0];
  reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(t)[1];
}

// rows <= 16, bf16 x. Lane (g = lane/4, c2 = (lane%4)*2) holds rows g and
// g+8 of each mma fragment (PTX ISA m16n8k16 layouts).
__global__ void __launch_bounds__(MMA_THREADS)
qmv_bf16_skinny(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, float* __restrict__ out,
                int64_t rows, int64_t n, int64_t k) {
  constexpr int S = SK_BK + 8;  // row stride (bf16), 16-byte aligned
  __shared__ __align__(16) bf16 xs[SKINNY_ROWS * S];
  __shared__ __align__(16) bf16 ws[SK_BN * S];
  __shared__ float red[4][SKINNY_ROWS][SK_BN];
  const int64_t n0 = (int64_t)blockIdx.x * SK_BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int kw = warp * (SK_BK / 4);
  float acc[SK_BN / 8][4];
#pragma unroll
  for (int t = 0; t < SK_BN / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  for (int64_t k0 = 0; k0 < k; k0 += SK_BK) {
    __syncthreads();  // the previous chunk is consumed
    // K is a multiple of 128: a chunk past its end is zero-filled
    for (int i = threadIdx.x; i < SKINNY_ROWS * SK_BK / 8; i += MMA_THREADS) {
      const int r = i / (SK_BK / 8), c8 = (i % (SK_BK / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < rows && k0 + c8 < k)
        v = *reinterpret_cast<const uint4*>(x + r * k + k0 + c8);
      *reinterpret_cast<uint4*>(xs + r * S + c8) = v;
    }
    for (int i = threadIdx.x; i < SK_BN * SK_BK / 16; i += MMA_THREADS) {
      const int r = i / (SK_BK / 16), c16 = (i % (SK_BK / 16)) * 16;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k0 + c16 < k)
        v = *reinterpret_cast<const uint4*>(w + (n0 + r) * k + k0 + c16);
      widen16(v, ws + r * S + c16);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SK_BK / 4; kk += 16) {
      const bf16* ap = xs + g * S + kw + kk + c2;
      const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * S), ld32(ap + 8),
                             ld32(ap + 8 * S + 8)};
#pragma unroll
      for (int t = 0; t < SK_BN / 8; ++t) {
        const bf16* bp = ws + (t * 8 + g) * S + kw + kk + c2;
        mma_bf16(acc[t], a, ld32(bp), ld32(bp + 8));
      }
    }
  }
#pragma unroll
  for (int t = 0; t < SK_BN / 8; ++t) {
    red[warp][g][t * 8 + c2] = acc[t][0];
    red[warp][g][t * 8 + c2 + 1] = acc[t][1];
    red[warp][g + 8][t * 8 + c2] = acc[t][2];
    red[warp][g + 8][t * 8 + c2 + 1] = acc[t][3];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < SKINNY_ROWS * SK_BN; i += MMA_THREADS) {
    const int r = i / SK_BN, c = i % SK_BN;
    if (r < rows) {
      const float s = red[0][r][c] + red[1][r][c] + red[2][r][c] + red[3][r][c];
      out[r * n + n0 + c] = s * scale[n0 + c];
    }
  }
}

// Any rows, bf16 x: CTA (64-channel tile, 64-row tile); warp w owns rows
// w*16 .. w*16+15 of the tile and all 64 channels.
__global__ void __launch_bounds__(MMA_THREADS)
qmv_bf16_tile(const bf16* __restrict__ x, const int8_t* __restrict__ w,
              const float* __restrict__ scale, float* __restrict__ out,
              int64_t rows, int64_t n, int64_t k) {
  constexpr int S = TL_BK + 8;
  __shared__ __align__(16) bf16 xs[TL_BM * S];
  __shared__ __align__(16) bf16 ws[TL_BN * S];
  const int64_t n0 = (int64_t)blockIdx.x * TL_BN;
  const int64_t m0 = (int64_t)blockIdx.y * TL_BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  float acc[TL_BN / 8][4];
#pragma unroll
  for (int t = 0; t < TL_BN / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  for (int64_t k0 = 0; k0 < k; k0 += TL_BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < TL_BM * TL_BK / 8; i += MMA_THREADS) {
      const int r = i / (TL_BK / 8), c8 = (i % (TL_BK / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + r < rows)
        v = *reinterpret_cast<const uint4*>(x + (m0 + r) * k + k0 + c8);
      *reinterpret_cast<uint4*>(xs + r * S + c8) = v;
    }
    for (int i = threadIdx.x; i < TL_BN * TL_BK / 16; i += MMA_THREADS) {
      const int r = i / (TL_BK / 16), c16 = (i % (TL_BK / 16)) * 16;
      widen16(*reinterpret_cast<const uint4*>(w + (n0 + r) * k + k0 + c16),
              ws + r * S + c16);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TL_BK; kk += 16) {
      const bf16* ap = xs + (warp * 16 + g) * S + kk + c2;
      const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * S), ld32(ap + 8),
                             ld32(ap + 8 * S + 8)};
#pragma unroll
      for (int t = 0; t < TL_BN / 8; ++t) {
        const bf16* bp = ws + (t * 8 + g) * S + kk + c2;
        mma_bf16(acc[t], a, ld32(bp), ld32(bp + 8));
      }
    }
  }
  const int64_t r0 = m0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int t = 0; t < TL_BN / 8; ++t) {
    const int64_t col = n0 + t * 8 + c2;
    const float s0 = scale[col], s1 = scale[col + 1];
    if (r0 < rows)
      *reinterpret_cast<float2*>(out + r0 * n + col) =
          make_float2(acc[t][0] * s0, acc[t][1] * s1);
    if (r1 < rows)
      *reinterpret_cast<float2*>(out + r1 * n + col) =
          make_float2(acc[t][2] * s0, acc[t][3] * s1);
  }
}

// float32 x with plain FMA. Thread (tr, tc) owns rows tr + i*TR and
// channels tc + j*TC of the BM x BN tile; x and the widened weights are
// staged transposed ([k][row], [k][channel]) so a warp reads consecutive
// channels.
template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(F32_THREADS)
qmv_f32(const float* __restrict__ x, const int8_t* __restrict__ w,
        const float* __restrict__ scale, float* __restrict__ out,
        int64_t rows, int64_t n, int64_t k) {
  constexpr int BK = 32, TR = BM / TM, TC = BN / TN;
  static_assert(TR * TC == F32_THREADS, "thread tile");
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN + 1];
  const int64_t n0 = (int64_t)blockIdx.x * BN;
  const int64_t m0 = (int64_t)blockIdx.y * BM;
  const int tr = threadIdx.x / TC, tc = threadIdx.x % TC;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = 0; k0 < k; k0 += BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BK / 4; i += F32_THREADS) {
      const int r = i / (BK / 4), c4 = (i % (BK / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < rows)
        v = *reinterpret_cast<const float4*>(x + (m0 + r) * k + k0 + c4);
      xs[c4][r] = v.x;
      xs[c4 + 1][r] = v.y;
      xs[c4 + 2][r] = v.z;
      xs[c4 + 3][r] = v.w;
    }
    for (int i = threadIdx.x; i < BN * BK / 16; i += F32_THREADS) {
      const int r = i / (BK / 16), c16 = (i % (BK / 16)) * 16;
      const uint4 raw =
          *reinterpret_cast<const uint4*>(w + (n0 + r) * k + k0 + c16);
      const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int j = 0; j < 16; ++j) ws[c16 + j][r] = (float)e[j];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][tr + i * TR];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tc + j * TC];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t row = m0 + tr + i * TR;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t col = n0 + tc + j * TC;
      out[row * n + col] = acc[i][j] * scale[col];
    }
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 x, 1 = bfloat16 x. x (rows, k), w8 (n, k) int8,
// scale (n,) float32, out (rows, n) float32. k % 128 == 0, n % 64 == 0.
int icikit_quant_matvec(int dtype, const void* x, const int8_t* w,
                        const float* scale, float* out, int64_t rows,
                        int64_t n, int64_t k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k % 128 || n % 64 || rows < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && rows <= SKINNY_ROWS) {
    qmv_bf16_skinny<<<(unsigned)(n / SK_BN), MMA_THREADS, 0, st>>>(
        static_cast<const bf16*>(x), w, scale, out, rows, n, k);
  } else if (dtype == 1) {
    const dim3 grid((unsigned)(n / TL_BN), (unsigned)((rows + TL_BM - 1) / TL_BM));
    qmv_bf16_tile<<<grid, MMA_THREADS, 0, st>>>(
        static_cast<const bf16*>(x), w, scale, out, rows, n, k);
  } else if (dtype == 0 && rows <= SKINNY_ROWS) {
    const dim3 grid((unsigned)(n / 32), 1);
    qmv_f32<16, 32, 1, 2><<<grid, F32_THREADS, 0, st>>>(
        static_cast<const float*>(x), w, scale, out, rows, n, k);
  } else if (dtype == 0) {
    const dim3 grid((unsigned)(n / 64), (unsigned)((rows + 63) / 64));
    qmv_f32<64, 64, 4, 4><<<grid, F32_THREADS, 0, st>>>(
        static_cast<const float*>(x), w, scale, out, rows, n, k);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Kernel attributes for the build log: registers and spills per thread.
// which: 0 qmv_bf16_skinny, 1 qmv_bf16_tile, 2 qmv_f32 skinny, 3 qmv_f32.
int icikit_quant_regs(int which, int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err;
  if (which == 0)
    err = cudaFuncGetAttributes(&attr, qmv_bf16_skinny);
  else if (which == 1)
    err = cudaFuncGetAttributes(&attr, qmv_bf16_tile);
  else if (which == 2)
    err = cudaFuncGetAttributes(&attr, qmv_f32<16, 32, 1, 2>);
  else
    err = cudaFuncGetAttributes(&attr, qmv_f32<64, 64, 4, 4>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
