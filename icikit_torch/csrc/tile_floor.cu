// Per-tile cost study of the flash forward for Hopper (sm_90a), bound
// with ctypes.
//
//   tile_mxu    <- _mxu_kernel (B17, icikit/bench/tile_floor.py:37,
//                  pallas_call :174).
//      Both tile products and the least glue between them, no softmax
//      statistics: o = sum over key tiles of bf16(q k^T * scale_log2) v,
//      float32 accumulator, bf16 out (no division).
//   tile_ablate <- _ablate_kernel (B17, :63, pallas_call :199).
//      The online-softmax tile loop with one class of work taken out at a
//      time: USE_EXP2 = false replaces exp2 by a subtraction (alpha =
//      0.1 (m_prev - m_new) + 1, w = s - m), USE_MAX = false the running
//      row max by the constant 8. Four instantiations, the variants
//      softmax_ks1 (both on), no_exp2, no_max and no_exp2_no_max. The
//      statistics start from JAX's m = -1e30, l = 0; l sums the float32
//      w, P V takes w rounded to bf16, out = acc / l in bf16.
//
//   Both keep the tile loop that flash_fwd_bf16 ran until its wgmma
//   redesign as the study's fixed reference, so that the differences
//   between variants decompose that loop: one CTA of four warps
//   (MMA_THREADS) per (batch*head, 64-row Q tile), each warp owning 16 Q
//   rows with its Q fragments in registers; 64-key tiles of K and V^T
//   staged through shared memory with strides KS = D + 8 and VS = BN + 8
//   and a scalar transposed store of V; S = Q K^T and P V on mma.sync
//   m16n8k16 (bf16 in, float32 accumulate), the S accumulators repacked
//   as P's A fragments; row statistics reduced over the 4 lanes of a
//   quad; base 2 with log2(e) folded into the scale. The study's `full`
//   arm is flash_fwd itself, now the wgmma design: its time is no longer
//   the sum of these variants' parts. Unlike flash, the grid is the
//   full rectangle (no causal bound) and every length is a multiple of
//   64 (the wrapper raises otherwise), so nothing is masked. Head dims
//   64 and 128 only. The helpers below (mma_bf16, pack_bf16, ld32) are
//   copies of that loop's helpers (pack_bf16 is still in attention.cu),
//   kept here so that this file builds alone: the build names a library
//   by a hash of its one source.
//   Bound: operations. At b 1, h 8, s 32768, d 64 the rectangle is
//   2,097,152 tiles of 4 * 64 * 64 * 64 FLOP, 2.20 TFLOP, 2.22 ms at
//   989 TFLOP/s (4.45 ms at d 128), against 134 MB of q, k, v and out,
//   0.04 ms at 3.35 TB/s. The design keeps S and P in registers and K/V
//   in shared memory as that loop did; it makes no attempt at the bound
//   (no wgmma, no TMA, no pipelining): it measures that loop as it was.
//
// Every entry returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;            // Q rows a CTA (attention.cu BM)
constexpr int BN = 64;            // keys a tile (attention.cu BN)
constexpr int THREADS = 128;      // 4 warps x 16 rows (MMA_THREADS)

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
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

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The parts of flash_fwd_bf16's loop that every variant shares: Q
// fragments, the staging of a K and a V^T tile, S = Q K^T and P V.
template <int D>
struct TileLoop {
  static constexpr int KS = D + 8;   // K tile row stride (bf16)
  static constexpr int VS = BN + 8;  // V^T tile row stride
  static constexpr size_t SMEM = sizeof(bf16) * (BN * KS + D * VS);

  bf16* ks;
  bf16* vt;
  const bf16* kb;
  const bf16* vb;
  int g, c2;
  uint32_t qa[D / 16][4];

  __device__ __forceinline__ TileLoop(unsigned char* smem, const bf16* q,
                                      const bf16* k, const bf16* v,
                                      int64_t s) {
    ks = reinterpret_cast<bf16*>(smem);
    vt = ks + BN * KS;
    const int64_t bh = blockIdx.y;
    const bf16* qb = q + bh * s * D;
    kb = k + bh * s * D;
    vb = v + bh * s * D;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    g = lane >> 2;
    c2 = (lane & 3) * 2;
    const int64_t r0 = (int64_t)blockIdx.x * BM + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const int col = c * 16 + c2;
      qa[c][0] = ld32(qb + r0 * D + col);
      qa[c][1] = ld32(qb + r1 * D + col);
      qa[c][2] = ld32(qb + r0 * D + col + 8);
      qa[c][3] = ld32(qb + r1 * D + col + 8);
    }
  }

  // Stage the key tile at n0: K row-major, V transposed (flash's stores).
  __device__ __forceinline__ void stage(int64_t n0) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < BN * D / 8; i += THREADS) {
      const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
      const uint4 kv = *reinterpret_cast<const uint4*>(kb + (n0 + r) * D + c8);
      const uint4 vv = *reinterpret_cast<const uint4*>(vb + (n0 + r) * D + c8);
      *reinterpret_cast<uint4*>(ks + r * KS + c8) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[(c8 + e) * VS + r] = ve[e];
    }
    __syncthreads();
  }

  // s = Q K^T for this warp's 16 rows and the tile's 64 keys.
  __device__ __forceinline__ void scores(float (&s)[BN / 8][4]) const {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const bf16* kp = ks + (j * 8 + g) * KS + c * 16 + c2;
        mma_bf16(s[j], qa[c], ld32(kp), ld32(kp + 8));
      }
    }
  }

  // o += bf16(w) V.
  __device__ __forceinline__ void pv(float (&o)[D / 8][4],
                                     const float (&w)[BN / 8][4]) const {
#pragma unroll
    for (int c = 0; c < BN / 16; ++c) {
      const uint32_t pa[4] = {pack_bf16(w[2 * c][0], w[2 * c][1]),
                              pack_bf16(w[2 * c][2], w[2 * c][3]),
                              pack_bf16(w[2 * c + 1][0], w[2 * c + 1][1]),
                              pack_bf16(w[2 * c + 1][2], w[2 * c + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const bf16* vp = vt + (n * 8 + g) * VS + c * 16 + c2;
        mma_bf16(o[n], pa, ld32(vp), ld32(vp + 8));
      }
    }
  }

  // Rows r0 and r1 of this lane: out = bf16(o / l), the TPU kernel's
  // acc / l (flash multiplies by 1 / l instead).
  __device__ __forceinline__ void store(bf16* out, int64_t s,
                                        const float (&o)[D / 8][4], float l0,
                                        float l1) const {
    const int64_t bh = blockIdx.y;
    const int warp = threadIdx.x >> 5;
    const int64_t r0 = (int64_t)blockIdx.x * BM + warp * 16 + g, r1 = r0 + 8;
    bf16* ob = out + bh * s * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + c2;
      *reinterpret_cast<uint32_t*>(ob + r0 * D + col) =
          pack_bf16(o[n][0] / l0, o[n][1] / l0);
      *reinterpret_cast<uint32_t*>(ob + r1 * D + col) =
          pack_bf16(o[n][2] / l1, o[n][3] / l1);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(THREADS)
tile_mxu(const bf16* __restrict__ q, const bf16* __restrict__ k,
         const bf16* __restrict__ v, bf16* __restrict__ out, int64_t s,
         float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileLoop<D> t(smem_raw, q, k, v, s);
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  for (int64_t n0 = 0; n0 < s; n0 += BN) {
    t.stage(n0);
    float w[BN / 8][4];
    t.scores(w);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) w[j][e] *= scale_log2;
    t.pv(o, w);
  }
  t.store(out, s, o, 1.f, 1.f);
}

template <int D, bool USE_EXP2, bool USE_MAX>
__global__ void __launch_bounds__(THREADS)
tile_ablate(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, bf16* __restrict__ out, int64_t s,
            float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileLoop<D> t(smem_raw, q, k, v, s);
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float mx0 = -1e30f, mx1 = -1e30f, l0 = 0.f, l1 = 0.f;
  for (int64_t n0 = 0; n0 < s; n0 += BN) {
    t.stage(n0);
    float w[BN / 8][4];
    t.scores(w);
    float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) w[j][e] *= scale_log2;
      if (USE_MAX) {
        tm0 = fmaxf(tm0, fmaxf(w[j][0], w[j][1]));
        tm1 = fmaxf(tm1, fmaxf(w[j][2], w[j][3]));
      }
    }
    float mn0 = 8.f, mn1 = 8.f;
    if (USE_MAX) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, off));
        tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, off));
      }
      mn0 = fmaxf(mx0, tm0);
      mn1 = fmaxf(mx1, tm1);
    }
    float al0, al1;
    if (USE_EXP2) {
      al0 = exp2f(mx0 - mn0);
      al1 = exp2f(mx1 - mn1);
    } else {
      al0 = (mx0 - mn0) * 0.1f + 1.f;
      al1 = (mx1 - mn1) * 0.1f + 1.f;
    }
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (USE_EXP2) {
        w[j][0] = exp2f(w[j][0] - mn0);
        w[j][1] = exp2f(w[j][1] - mn0);
        w[j][2] = exp2f(w[j][2] - mn1);
        w[j][3] = exp2f(w[j][3] - mn1);
      } else {
        w[j][0] -= mn0;
        w[j][1] -= mn0;
        w[j][2] -= mn1;
        w[j][3] -= mn1;
      }
      rs0 += w[j][0] + w[j][1];
      rs1 += w[j][2] + w[j][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
    mx0 = mn0;
    mx1 = mn1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }
    t.pv(o, w);
  }
  t.store(out, s, o, l0, l1);
}

template <typename KernelT>
int launch(KernelT kernel, size_t smem, const void* q, const void* k,
           const void* v, void* out, int64_t bh, int64_t s, float scale_log2,
           cudaStream_t st) {
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const dim3 grid((unsigned)(s / BM), (unsigned)bh);
  kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), s, scale_log2);
  return (int)cudaGetLastError();
}

template <int D>
int launch_ablate(int use_exp2, int use_max, const void* q, const void* k,
                  const void* v, void* out, int64_t bh, int64_t s,
                  float scale_log2, cudaStream_t st) {
  constexpr size_t smem = TileLoop<D>::SMEM;
  if (use_exp2 && use_max)
    return launch(tile_ablate<D, true, true>, smem, q, k, v, out, bh, s,
                  scale_log2, st);
  if (use_exp2)
    return launch(tile_ablate<D, true, false>, smem, q, k, v, out, bh, s,
                  scale_log2, st);
  if (use_max)
    return launch(tile_ablate<D, false, true>, smem, q, k, v, out, bh, s,
                  scale_log2, st);
  return launch(tile_ablate<D, false, false>, smem, q, k, v, out, bh, s,
                scale_log2, st);
}

bool bad_shape(int64_t bh, int64_t s) { return bh < 1 || s < BM || s % BM; }

}  // namespace

extern "C" {

// q, k, v, out: (bh, s, d) bf16, s a multiple of 64, d 64 or 128.
// scale_log2: the softmax scale with log2(e) folded in.
int icikit_tile_mxu(const void* q, const void* k, const void* v, void* out,
                    int64_t bh, int64_t s, int d, float scale_log2,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(bh, s)) return (int)cudaErrorInvalidValue;
  if (d == 64)
    return launch(tile_mxu<64>, TileLoop<64>::SMEM, q, k, v, out, bh, s,
                  scale_log2, st);
  if (d == 128)
    return launch(tile_mxu<128>, TileLoop<128>::SMEM, q, k, v, out, bh, s,
                  scale_log2, st);
  return (int)cudaErrorInvalidValue;
}

// As icikit_tile_mxu; use_exp2, use_max select the variant.
int icikit_tile_ablate(int use_exp2, int use_max, const void* q, const void* k,
                       const void* v, void* out, int64_t bh, int64_t s, int d,
                       float scale_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(bh, s)) return (int)cudaErrorInvalidValue;
  if (d == 64)
    return launch_ablate<64>(use_exp2, use_max, q, k, v, out, bh, s,
                             scale_log2, st);
  if (d == 128)
    return launch_ablate<128>(use_exp2, use_max, q, k, v, out, bh, s,
                              scale_log2, st);
  return (int)cudaErrorInvalidValue;
}

// Kernel attributes for the build log, by index: 0 tile_mxu<64>, 1
// tile_ablate<64, exp2, max>, 2 tile_ablate<64, -, ->, 3 tile_mxu<128>,
// 4 tile_ablate<128, exp2, max>.
int icikit_tile_floor_regs(int which, int* regs, int* local_bytes) {
  const void* fns[] = {(const void*)tile_mxu<64>,
                       (const void*)tile_ablate<64, true, true>,
                       (const void*)tile_ablate<64, false, false>,
                       (const void*)tile_mxu<128>,
                       (const void*)tile_ablate<128, true, true>};
  if (which < 0 || which >= (int)(sizeof(fns) / sizeof(fns[0])))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fns[which]);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
