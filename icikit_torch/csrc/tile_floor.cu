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
//      time: without EXP2 a subtraction stands for exp2 (alpha = 0.1
//      (m_prev - m_new) + 1, w = s - m_new), without MAX the constant 8
//      for the running row max. Four instantiations, the variants
//      softmax_ks1 (both on), no_exp2, no_max and no_exp2_no_max. The
//      statistics start from JAX's m = -1e30, l = 0; l sums the float32
//      w, P V takes w rounded to bf16, out = acc / l in bf16.
//
//   All five run one tile loop, flash_fwd_bf16's (attention.cu) at its
//   geometry for d <= 128, and differ only in what they do to S between
//   the two products (tile_weights), so that the differences between
//   variants split one tile of that loop's time:
//   - a CTA a (batch*head, 128-row Q tile), 384 threads: two consumer
//     warpgroups of 64 Q rows each and a producer warpgroup, one thread of
//     which loads Q once and keeps a two-stage ring of 128-key K and V
//     tiles full by TMA (2-d tensor maps over the (b*h*s, d) rows, boxes
//     of 64 columns x 128 rows landing in wgmma's 128-byte swizzle);
//     setmaxnreg gives the producer's registers to the consumers (24 and
//     240). K and V each have a full and an empty mbarrier a stage, so a
//     K slot is refilled once its S product is done and a V slot once its
//     P V is;
//   - S = Q K^T on wgmma m64n128k16 with Q and K read K-major by swizzled
//     descriptors; O += P V on wgmma with P as the register A operand,
//     taken from S's accumulator rounded to bf16, and V read MN-major
//     through the transpose bit: no transposed copy of V;
//   - the statistics in base 2 on ex2.approx.ftz, the scale folded into
//     one FMA, the row max reduced over the quad of lanes that hold a row,
//     each lane's share of l summed over the quad once at the end.
//   The loop runs one tile at a time, as flash_fwd_bf16 does (the two
//   consumer warpgroups interleave on their own). A form that issued tile
//   j+1's S before tile j's weights (FlashAttention-3's overlap within a
//   warpgroup) measured slower on the card and is not kept (PERF.md, B17).
//   The grid is the full rectangle (no causal bound, no mask): every
//   length is a multiple of 128 (the wrapper raises otherwise). Head dims
//   64 (one 64-column block, O 32 registers a thread) and 128 (two
//   blocks, O 64).
//   Bound: operations. At b 1, h 8, s 32768, d 64 the rectangle is
//   524,288 tiles of 4 * 128 * 128 * 64 FLOP, 2.20 TFLOP, 2.22 ms at 989
//   TFLOP/s (4.45 ms at d 128), against 134 MB of q, k, v and out, 0.04
//   ms at 3.35 TB/s.
//
// Every entry returns cudaGetLastError() after its launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// The variants: the products alone, then the online softmax whole and
// with exp2, the running max or both taken out.
enum Variant : int { MXU, SOFTMAX, NO_EXP2, NO_MAX, NO_EXP2_NO_MAX, VARIANTS };
__host__ __device__ constexpr bool has_exp2(int v) {
  return v == SOFTMAX || v == NO_MAX;
}
__host__ __device__ constexpr bool has_max(int v) {
  return v == SOFTMAX || v == NO_EXP2;
}

constexpr int ROWS = 128;  // Q rows a CTA: two consumer warpgroups of 64
constexpr int BK = 128;    // keys a tile
constexpr int NS = 2;      // ring stages
constexpr int CT = 256;    // consumer threads
constexpr int NT = CT + 128;  // and the producer warpgroup
constexpr int SW = 128;    // swizzle span in bytes: 64-column blocks
constexpr int SR = BK / 2;  // S accumulator registers a thread
constexpr int QB = ROWS * SW, KB = BK * SW;  // bytes of a column block

template <int D>
struct Geo {
  static constexpr int CB = D * 2 / SW;        // column blocks
  static constexpr int TILE_Q = ROWS * D * 2;  // bytes of the Q tile
  static constexpr int TILE_K = BK * D * 2;    // of a K or a V tile
  // Q, the ring (stage st: K, then V), then the mbarriers: K full, V
  // full, K empty, V empty (a stage each) and Q's; and room to align the
  // tiles to 1024 bytes (the swizzle's period)
  static constexpr int BARS = TILE_Q + 2 * NS * TILE_K;
  static constexpr size_t SMEM = 1024 + BARS + (4 * NS + 1) * 8;
};

// exp2 on the special-function unit, subnormal results flushed to zero
// (flash_fwd_bf16's ex2).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// What variant V does to S between the products, in place, for the
// lane's rows r0 (accumulator elements i with i & 2 == 0) and r0 + 8.
// MXU: w = s * scale_log2. The ablations, JAX's recurrence: m_new the
// running row max (MAX; taken over the unscaled scores, the scale being
// positive) or 8; alpha = exp2(m - m_new), w = exp2(s * scale_log2 -
// m_new) (EXP2) or alpha = 0.1 (m - m_new) + 1, w = s * scale_log2 -
// m_new; l0, l1 the lane's share of the row sums, l = l alpha + sum(w).
// al0, al1 rescale O (1 for MXU).
template <int V, int R>
__device__ __forceinline__ void tile_weights(float (&s)[R], float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& al0, float& al1,
                                             float scale_log2) {
  al0 = al1 = 1.f;
  if constexpr (V == MXU) {
#pragma unroll
    for (int i = 0; i < R; ++i) s[i] *= scale_log2;
  } else {
    float mn0 = 8.f, mn1 = 8.f;
    if constexpr (has_max(V)) {
      float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (i & 2) tm1 = fmaxf(tm1, s[i]);
        else tm0 = fmaxf(tm0, s[i]);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, off));
        tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, off));
      }
      mn0 = fmaxf(m0, tm0 * scale_log2);
      mn1 = fmaxf(m1, tm1 * scale_log2);
    }
    if constexpr (has_exp2(V)) {
      al0 = ex2(m0 - mn0);
      al1 = ex2(m1 - mn1);
    } else {
      al0 = (m0 - mn0) * 0.1f + 1.f;
      al1 = (m1 - mn1) * 0.1f + 1.f;
    }
    const float b0 = -mn0, b1 = -mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float w = fmaf(s[i], scale_log2, i & 2 ? b1 : b0);
      if constexpr (has_exp2(V)) w = ex2(w);
      s[i] = w;
      if (i & 2) rs1 += w;
      else rs0 += w;
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
    m0 = mn0;
    m1 = mn1;
  }
}

// One consumer warpgroup's share of a CTA: its 64 Q rows (qo bytes into
// each Q block), the ring and its barriers, O and the row statistics.
template <int D, int V>
struct Consumer {
  using G = Geo<D>;
  const unsigned char* qs;
  const unsigned char* ring;
  uint64_t *kfull, *vfull, *kempty, *vempty;
  int qo;
  float scale_log2;
  float o[D / 2];
  float m0, m1, l0, l1;

  __device__ __forceinline__ const unsigned char* ks(int j) const {
    return ring + (j % NS) * 2 * G::TILE_K;
  }

  // S = Q K_j^T into s (one wgmma group, committed, not waited for)
  __device__ __forceinline__ void issue_s(float (&s)[SR], int j) const {
    const unsigned char* k = ks(j);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      wgmma_ss<BK, 0, 0>(
          s,
          gmma_desc_sw(qs + kc * 32 / SW * QB + qo + kc * 32 % SW, 16,
                       8 * SW, 1),
          gmma_desc_sw(k + kc * 32 / SW * KB + kc * 32 % SW, 16, 8 * SW, 1),
          kc > 0);
    wg_commit();
  }

  // O += bf16(w) V_j (one wgmma group, committed, not waited for)
  __device__ __forceinline__ void issue_pv(const float (&w)[SR], int j) {
    const unsigned char* v = ks(j) + G::TILE_K;
    wg_fence();
#pragma unroll
    for (int cc = 0; cc < BK / 16; ++cc) {
      uint32_t a[4];
      acc_to_a(a, w, cc);
      wgmma_rs<D, 1>(o, a, gmma_desc_sw(v + cc * 16 * SW, KB, 8 * SW, 1), 1);
    }
    wg_commit();
  }

  // O rescaled by alpha (O's last product must be done)
  __device__ __forceinline__ void rescale(float al0, float al1) {
    if constexpr (V != MXU) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= i & 2 ? al1 : al0;
    }
  }

  // flash_fwd_bf16's loop, one tile at a time
  __device__ __forceinline__ void run(int tiles) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    m0 = m1 = -1e30f;
    l0 = l1 = 0.f;
    for (int j = 0; j < tiles; ++j) {
      const int st = j % NS, ph = (j / NS) & 1;
      float s[SR];
      mbar_wait(kfull + st, ph);
      issue_s(s, j);
      wg_wait<0>();
      fence_regs(s);
      mbar_arrive(kempty + st);  // K_j is read
      float al0, al1;
      tile_weights<V>(s, m0, m1, l0, l1, al0, al1, scale_log2);
      rescale(al0, al1);
      mbar_wait(vfull + st, ph);
      issue_pv(s, j);
      wg_wait<0>();
      fence_regs(o);
      mbar_arrive(vempty + st);  // V_j is read
    }
  }
};

template <int D, int V>
__device__ __forceinline__ void tile_body(const CUtensorMap* tq,
                                          const CUtensorMap* tk,
                                          const CUtensorMap* tv,
                                          bf16* __restrict__ out, int s,
                                          float scale_log2) {
  using G = Geo<D>;
  extern __shared__ __align__(1024) unsigned char tf_smem[];
  unsigned char* qs = tf_smem + ((1024 - (smem_u32(tf_smem) & 1023)) & 1023);
  unsigned char* ring = qs + G::TILE_Q;
  uint64_t* kfull = reinterpret_cast<uint64_t*>(qs + G::BARS);
  uint64_t* vfull = kfull + NS;
  uint64_t* kempty = vfull + NS;
  uint64_t* vempty = kempty + NS;
  uint64_t* qbar = vempty + NS;
  const int q0 = blockIdx.x * ROWS;
  const int row0 = blockIdx.y * s;  // the head's first row in the maps
  const int tiles = s / BK;
  const int wgi = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(kfull + i, 1);
      mbar_init(vfull + i, 1);
      mbar_init(kempty + i, CT);
      mbar_init(vempty + i, CT);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 2) {
    // the producer: Q once, then tile t's K into stage t % NS once S of
    // tile t - NS is done, its V once P V of tile t - NS is
    setmaxnreg_dec<24>();
    if (threadIdx.x == CT) {
      mbar_expect_tx(qbar, G::TILE_Q);
      for (int b = 0; b < G::CB; ++b)
        tma_box2(qs + b * QB, tq, b * SW / 2, row0 + q0, qbar);
      for (int t = 0; t < tiles; ++t) {
        const int st = t % NS, ph = (t / NS - 1) & 1;
        unsigned char* k = ring + st * 2 * G::TILE_K;
        if (t >= NS) mbar_wait(kempty + st, ph);
        mbar_expect_tx(kfull + st, G::TILE_K);
        for (int b = 0; b < G::CB; ++b)
          tma_box2(k + b * KB, tk, b * SW / 2, row0 + t * BK, kfull + st);
        if (t >= NS) mbar_wait(vempty + st, ph);
        mbar_expect_tx(vfull + st, G::TILE_K);
        for (int b = 0; b < G::CB; ++b)
          tma_box2(k + G::TILE_K + b * KB, tv, b * SW / 2, row0 + t * BK,
                   vfull + st);
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  Consumer<D, V> c;
  c.qs = qs;
  c.ring = ring;
  c.kfull = kfull;
  c.vfull = vfull;
  c.kempty = kempty;
  c.vempty = vempty;
  c.qo = wgi * 64 * SW;
  c.scale_log2 = scale_log2;
  mbar_wait(qbar, 0);
  c.run(tiles);

  float l0 = c.l0, l1 = c.l1;
  if constexpr (V != MXU) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
  }
  // rows r0 and r0 + 8 of the lane: out = bf16(acc / l), the TPU kernel's
  // division (flash multiplies by 1 / l); MXU stores acc
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int64_t r0 = (int64_t)row0 + q0 + wgi * 64 + warp * 16 + (lane >> 2);
  const int c2 = (lane & 3) * 2;
  bf16* o0 = out + r0 * D + c2;
  bf16* o1 = o0 + 8 * D;
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
    const float* x = c.o + 4 * t;
    if constexpr (V == MXU) {
      *reinterpret_cast<uint32_t*>(o0 + t * 8) = pack_bf16(x[0], x[1]);
      *reinterpret_cast<uint32_t*>(o1 + t * 8) = pack_bf16(x[2], x[3]);
    } else {
      *reinterpret_cast<uint32_t*>(o0 + t * 8) =
          pack_bf16(x[0] / l0, x[1] / l0);
      *reinterpret_cast<uint32_t*>(o1 + t * 8) =
          pack_bf16(x[2] / l1, x[3] / l1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
tile_mxu(const __grid_constant__ CUtensorMap tq,
         const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
         int s, float scale_log2) {
  tile_body<D, MXU>(&tq, &tk, &tv, out, s, scale_log2);
}

// V: one of SOFTMAX, NO_EXP2, NO_MAX, NO_EXP2_NO_MAX
template <int D, int V>
__global__ void __launch_bounds__(NT, 1)
tile_ablate(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
            int s, float scale_log2) {
  tile_body<D, V>(&tq, &tk, &tv, out, s, scale_log2);
}

// The kernel of variant v at head dim D, for the launch and the
// attribute query alike.
template <int D>
const void* kernel(int v) {
  static const void* const table[VARIANTS] = {
      (const void*)tile_mxu<D>, (const void*)tile_ablate<D, SOFTMAX>,
      (const void*)tile_ablate<D, NO_EXP2>, (const void*)tile_ablate<D, NO_MAX>,
      (const void*)tile_ablate<D, NO_EXP2_NO_MAX>};
  return table[v];
}

// The maps of q, k and v as (b*h*s, d) rows, then variant v's launch.
int launch(int v, const void* q, const void* k, const void* v_, void* out,
           int64_t bh, int64_t s, int d, float scale_log2, cudaStream_t st) {
  if (bh < 1 || bh > 65535 || s < ROWS || s % ROWS || bh * s > INT32_MAX ||
      (d != 64 && d != 128))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  int err = tma_map_2d(&tq, bf, 2, q, bh * s, d, SW / 2, ROWS, sw);
  if (!err) err = tma_map_2d(&tk, bf, 2, k, bh * s, d, SW / 2, BK, sw);
  if (!err) err = tma_map_2d(&tv, bf, 2, v_, bh * s, d, SW / 2, BK, sw);
  if (err) return err;
  const void* fn = d == 64 ? kernel<64>(v) : kernel<128>(v);
  const int smem = (int)(d == 64 ? Geo<64>::SMEM : Geo<128>::SMEM);
  err = (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  bf16* o = static_cast<bf16*>(out);
  int si = (int)s;
  void* args[] = {&tq, &tk, &tv, &o, &si, &scale_log2};
  err = (int)cudaLaunchKernel(fn, dim3((unsigned)(s / ROWS), (unsigned)bh),
                              dim3(NT), args, (size_t)smem, st);
  return err ? err : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, out: (bh, s, d) bf16, s a multiple of 128, d 64 or 128.
// scale_log2: the softmax scale with log2(e) folded in.
int icikit_tile_mxu(const void* q, const void* k, const void* v, void* out,
                    int64_t bh, int64_t s, int d, float scale_log2,
                    void* stream) {
  return launch(MXU, q, k, v, out, bh, s, d, scale_log2,
                static_cast<cudaStream_t>(stream));
}

// As icikit_tile_mxu; use_exp2, use_max select the variant.
int icikit_tile_ablate(int use_exp2, int use_max, const void* q, const void* k,
                       const void* v, void* out, int64_t bh, int64_t s, int d,
                       float scale_log2, void* stream) {
  const int var = use_exp2 ? (use_max ? SOFTMAX : NO_MAX)
                           : (use_max ? NO_EXP2 : NO_EXP2_NO_MAX);
  return launch(var, q, k, v, out, bh, s, d, scale_log2,
                static_cast<cudaStream_t>(stream));
}

// Kernel attributes for the build log, by index 0-9: at d 64 (0-4) and
// 128 (5-9), tile_mxu, then tile_ablate softmax_ks1, no_exp2, no_max and
// no_exp2_no_max.
int icikit_tile_floor_regs(int which, int* regs, int* local_bytes) {
  if (which < 0 || which >= 2 * VARIANTS) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, which < VARIANTS ? kernel<64>(which)
                              : kernel<128>(which - VARIANTS));
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
