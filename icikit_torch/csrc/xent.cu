// Fused softmax cross-entropy head kernels for Hopper (sm_90a), bound
// with ctypes.
//
// The counterparts of icikit/ops/xent.py's TPU kernels, in the four
// flavours of the head (save_exp x fused_bwd):
//
//   xent_fwd      <- _fwd_kernel / _fwd_kernel_save (B9, _fwd_call,
//                    pallas_call :283).
//      Per token: the log-sum-exp of the logits x w^T over the vocabulary
//      and the target logit, with the logits formed chunk by chunk in the
//      kernel's own body and never written out. w is (V, D), the
//      embedding orientation. The TPU keeps a (1024, D) x block resident
//      and walks the vocabulary with an online base-2 max and sum; a CTA
//      here cannot hold such a block, and one CTA per token tile would
//      leave the card idle, so the vocabulary is split across tiles: a
//      tile (128 tokens x 256 vocabulary columns, see logits_body) takes,
//      for each row and each 128-column chunk, the chunk max m_i (base
//      2), sum of exp2(s*log2e - m_i) and target logit (natural units,
//      before the base-2 scale, :98-101), and with `save` writes e =
//      exp2(s*log2e - m_i) in the compute dtype plus m_i. The last of a
//      token tile's epilogues to finish (an atomic count) merges its rows'
//      partials: lse = (M + log2 sum l_i exp2(m_i - M)) * ln2. p = e *
//      exp2(m_i - lse*log2e) holds whatever order the chunks are visited
//      in, so the backward rebuilds the softmax from e and m_i as the
//      TPU's does from its running max.
//      Bound (T 8192, D 1024, V 32768, bf16): 2*T*V*D = 549.8 GFLOP,
//      556 us at 989 TFLOP/s, against ~620 MB written and read: operations.
//
//   xent_dx_saved <- _dx_kernel, saved flavour (_dx_saved_kernel, B10,
//                    _dx_call, pallas_call :374).
//      dx = sum_v g w with g = (e * exp2(m_i - lse*log2e) - onehot) *
//      dnll rebuilt in registers from e and never written out.
//   xent_dw_saved <- _dw_kernel, saved flavour (_dw_saved_kernel, B10,
//                    _dw_call, pallas_call :411).
//      dw = sum_t g^T x, g rebuilt the same way.
//      The TPU keeps (1024, 1024) and (2048, 1024) float32 accumulators
//      in VMEM; a CTA here holds a 128 x 256 output tile in registers,
//      so D is split across CTAs and the grid puts the CTAs that share a
//      token (dx) or vocab (dw) tile next to each other, so that they run
//      together and L2 absorbs the re-read of e (512 MiB at the base
//      preset) instead of device memory; wgmma with g as its register
//      operand, a TMA ring (see xent_dx_bf16). Bound: 549.8 GFLOP each,
//      556 us: operations.
//
//   xent_dx, xent_dw <- _dx_kernel / _dw_kernel with e_ref=None (B10,
//                    recompute flavour, pallas_calls :374, :411 via
//                    _dx_call/_dw_call).
//      dx and dw with g rebuilt from a recomputed logits tile
//      (_g_chunk_recompute) instead of from e: one more 2*T*V*D product
//      (bound 1.11 ms each at the base shapes, operations). bf16 up to D
//      2048: a thread-block cluster along D on wgmma and TMA forms each
//      logits tile once (see xent_recompute_bf16). Past D 2048 a walk
//      over chunks (cuda_xent.recompute_walk; dx: 128-row token tiles
//      enough to fill a wave of the card, dw: as many vocabulary rows)
//      forms each logits tile once too: a chunk's g in bf16 by xent_g's
//      body (icikit_xent_g_cols, its targets in absolute vocabulary
//      units), then its product by the saved flavour's body with g given
//      (xent_dx_g_bf16, xent_dw_g_bf16); the contraction is whole in a
//      chunk, and g's scratch is at most a quarter of (T, V) in bf16.
//
//   xent_g        <- _bwd_kernel (B11, _g_call, pallas_call :312).
//   xent_g_saved  <- _g_saved_kernel (B11, _g_saved_call, :335).
//      The matmul backward (fused_bwd=False): g = (softmax - onehot) * dnll
//      written as a (T, V) tensor in the compute dtype, from a logits tile
//      formed in the kernel (0.556 ms at the base shapes, operations) or
//      from the saved exponentials (an elementwise pass, 2 x 537 MB, 0.32
//      ms, bytes); dx = g w and dw = g^T x are then plain matmuls outside
//      any kernel, as JAX leaves them to XLA (xent.py:469-475).
//
// bf16 xent_fwd and xent_g share one body on wgmma and TMA
// (logits_body: a persistent CTA an SM, 128 x 256 logits tiles, the bf16
// output staged and stored by TMA), as do the saved flavour's dx and dw
// (saved_body); the recompute flavour up to D 2048 runs on wgmma and TMA
// in a cluster along D, and past D 2048 on those two bodies, a launch of
// each a chunk. g is rounded to bf16 to enter the tensor
// cores, where the TPU contracts it in float32 against w.astype(f32)
// (:199-201, :235-237): the tolerance in the tests states the cost.
// float32: 64 x 64 tiles of plain FMA, 4 x 4 a thread.
// Every entry returns cudaGetLastError() after its launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

typedef __nv_bfloat16 bf16;

// the elementwise g pass (bf16)
constexpr int X_THREADS = 256;
// float32 tiles
constexpr int FT = 64;
constexpr int FK = 16;
constexpr int F_THREADS = 256;   // 16 x 16, a 4 x 4 micro tile each
constexpr int FS = FT + 4;

// Four 8x8 bf16 matrices, each delivered transposed (the mma B or A
// fragment of an operand stored with the contraction dimension across
// rows).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The last CTA of token tile `tile` merges its rows' partials (written by
// every CTA of the tile before it bumped the count): thread r < rows.
__device__ void merge_partials(const float* mrun, const float* lpart,
                               const float* tpart, unsigned* counter,
                               float* lse, float* tgt_out, int64_t t0,
                               int rows, int64_t T, int nchunks, int tile) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(counter + tile, 1u) == (unsigned)nchunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int64_t t = t0 + r;
    float m = -INFINITY;
    for (int c = 0; c < nchunks; ++c) m = fmaxf(m, __ldcg(mrun + c * T + t));
    float l = 0.f, tg = 0.f;
    for (int c = 0; c < nchunks; ++c) {
      l += __ldcg(lpart + c * T + t) * exp2f(__ldcg(mrun + c * T + t) - m);
      tg += __ldcg(tpart + c * T + t);
    }
    lse[t] = (m + log2f(l)) * LN2;
    tgt_out[t] = tg;
  }
  if (threadIdx.x == 0) counter[tile] = 0u;  // ready for the next call
}

// ---------------------------------------------------------------------------
// xent_fwd (B9) and xent_g (B11), bf16: one body, logits_body<FWD>, forms
// the logits s = x w^T of a 128-token x 256-vocabulary tile on wgmma and
// hands them to one of two epilogues. Bound: the product's 2 T V D
// operations (0.556 ms at T 8192, D 1024, V 32768).
//
// - The product: two consumer warpgroups of 64 token rows each issue one
//   wgmma m64n256k16 a k16 step, x (A) and w (B) both K-major in the
//   128-byte swizzle, the accumulator (128 floats a thread) in registers.
//   A producer warp (setmaxnreg 40; the consumers 232) keeps a 3-stage
//   ring of 64-wide contraction steps full by TMA, x's 128 x 64 box and
//   w's 256 x 64 box a stage (48 KB), zero past T, V and D, paced by
//   full/empty mbarriers. Three stages leave room for the 64 KB output
//   tile. A CTA of 288 threads without setmaxnreg held 168 registers a
//   thread all the same (nine warps put three on one of the SM's four
//   register-file quarters) and spilled.
// - Persistent: one CTA an SM walks the tiles CTA, CTA + grid, ...; the
//   token tiles of a vocab tile are consecutive, so the CTAs at work
//   share one or two vocab tiles: w streams from device memory about
//   once and x (16 MiB at the base preset) is re-read from L2. The
//   producer fills the ring for the next tile while the consumers run
//   this tile's epilogue: 6-9% faster than one CTA a tile at the base
//   shapes (H100, 700 W). A cluster of two CTAs along T, each bringing
//   half of w's box and multicasting it to both (a third less L2
//   traffic), measured 2-4% slower: L2 does not bound this kernel.
// - xent_fwd's epilogue (_fwd_kernel / _fwd_kernel_save): for each row
//   and each 128-column half (mrun's chunk, cuda_xent.TILE, kept from the
//   first design) the max m_i of s*log2e over the valid columns, e =
//   exp2(s*log2e - m_i), its sum and the target logit (natural units),
//   reduced across the quad by shuffles; the two warpgroups hold separate
//   rows and exchange nothing. The partials mrun, lpart, tpart (V/128, T)
//   go out per chunk, and a second launch, xent_merge, folds each token's
//   chunks into lse = (M + log2 sum l_i exp2(m_i - M)) ln2 and its target
//   logit, reading 25 MB once: a merge inside the kernel, by the last
//   epilogue of a token tile to finish (an atomic count a tile), held
//   every tile on a fence and the atomic's round trip (1.08 ms against
//   g's 0.84 on an H100 at 700 W).
// - xent_g's epilogue (_bwd_kernel): g = (exp2(s*log2e - lse*log2e) -
//   onehot) * dnll, each row's lse, dnll and target loaded as its tile
//   starts, their latency under the products.
// - Both epilogues mask columns only in the vocabulary's last tile and
//   compare columns with a row's target only where it falls in the tile,
//   and take exp2 from the MUFU unit alone (ex2). xent_g's targets count
//   from vbase, the vocabulary row that w's first row holds (the
//   recompute walk's vocabulary chunks; 0 otherwise): a target outside
//   the chunk matches no stored column.
// - The bf16 tile (e with save; g) is staged in shared memory in the
//   128-byte swizzle (a warp's 4-byte pairs fall in 32 distinct banks)
//   and stored by TMA, each warpgroup its 64 rows as four 64 x 64 boxes
//   clipped at T and V: entries outside [0, T) x [0, V) are not stored.
//   The store drains under the next tile's products; a warpgroup waits
//   for it only before it stages its next tile.
constexpr int LT_ROWS = 128;       // tokens a tile: two consumer warpgroups
constexpr int LT_COLS = 256;       // vocabulary columns a tile
constexpr int LT_KT = 64;          // the contraction a step: 128-byte rows
constexpr int LT_NS = 3;           // ring stages
constexpr int LT_THREADS = 384;    // two consumer warpgroups, a producer
constexpr int LT_XBOX = LT_ROWS * 128;              // x's box, 16 KB
constexpr int LT_STAGE = LT_XBOX + LT_COLS * 128;   // and w's, 48 KB
constexpr int LT_OBOX = 64 * 128;                   // a 64 x 64 output box
constexpr int LT_OWG = LT_COLS / 64 * LT_OBOX;      // a warpgroup's rows
constexpr size_t LT_SMEM = 1024 + LT_NS * LT_STAGE + 2 * LT_OWG +
                           2 * LT_NS * sizeof(uint64_t);

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// exp2 by the MUFU unit alone (ex2.approx, within 2 ulp, denormal
// results flushed to zero): the epilogues' one transcendental.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <bool FWD>
__device__ __forceinline__ void logits_body(
    unsigned char* smem, const CUtensorMap* tx, const CUtensorMap* tw,
    const CUtensorMap* tout, const int* __restrict__ tgt,
    const float* __restrict__ lse, const float* __restrict__ dnll,
    float* __restrict__ mrun, float* __restrict__ lpart,
    float* __restrict__ tpart, int64_t T, int64_t V, int64_t D, int store,
    int vbase) {
  unsigned char* ring = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  unsigned char* ostage = ring + LT_NS * LT_STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(ostage + 2 * LT_OWG);
  uint64_t* empty = full + LT_NS;
  // the walk: tile = vt * ntt + tt, from blockIdx.x in steps of gridDim.x
  const int ntt = (int)((T + LT_ROWS - 1) / LT_ROWS);
  const int nvt = (int)((V + LT_COLS - 1) / LT_COLS);
  const int dtt = (int)gridDim.x % ntt, dvt = (int)gridDim.x / ntt;
  const int nk = (int)((D + LT_KT - 1) / LT_KT);
  const int wgi = threadIdx.x >> 7, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < LT_NS; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 2) {
    // the producer: step s of the CTA's walk into stage s % LT_NS once the
    // consumers released step s - LT_NS
    setmaxnreg_dec<40>();
    if (threadIdx.x != 2 * 128) return;
    unsigned s = 0;
    for (int tt = (int)blockIdx.x % ntt, vt = (int)blockIdx.x / ntt;
         vt < nvt; tt += dtt, vt += dvt) {
      if (tt >= ntt) {
        tt -= ntt;
        ++vt;
        if (vt >= nvt) break;
      }
      for (int k = 0; k < nk; ++k, ++s) {
        const int st = (int)(s % LT_NS);
        if (s >= LT_NS) mbar_wait(empty + st, (int)((s / LT_NS - 1) & 1));
        unsigned char* p = ring + st * LT_STAGE;
        mbar_expect_tx(full + st, LT_STAGE);
        tma_box2(p, tx, k * LT_KT, tt * LT_ROWS, full + st);
        tma_box2(p + LT_XBOX, tw, k * LT_KT, vt * LT_COLS, full + st);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int warp = (threadIdx.x >> 5) & 3, g = lane >> 2, c = lane & 3;
  const int rl = warp * 16 + g;  // the warpgroup's rows rl and rl + 8
  const int ra = wgi * 64 + rl;  // of the tile
  const int bar = 1 + wgi;       // the warpgroup's named barrier
  const bool lead = (threadIdx.x & 127) == 0;
  unsigned char* os = ostage + wgi * LT_OWG;
  float acc[LT_COLS / 2];
  unsigned s = 0;
  for (int tt = (int)blockIdx.x % ntt, vt = (int)blockIdx.x / ntt;
       vt < nvt; tt += dtt, vt += dvt) {
    if (tt >= ntt) {
      tt -= ntt;
      ++vt;
      if (vt >= nvt) break;
    }
    const int t0 = tt * LT_ROWS, v0 = vt * LT_COLS;
    // the rows' token data, in flight under the products
    int rel[2];  // the target's column in the tile (out of it: none)
    float l2[2], dn[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = t0 + ra + 8 * hr;
      const bool ok = t < T;
      rel[hr] = ok ? tgt[t] - vbase - v0 : -1;
      l2[hr] = !FWD && ok ? lse[t] * LOG2E : 0.f;
      dn[hr] = !FWD && ok ? dnll[t] : 0.f;
    }
    for (int k = 0; k < nk; ++k, ++s) {
      const int st = (int)(s % LT_NS);
      mbar_wait(full + st, (int)((s / LT_NS) & 1));
      const unsigned char* p = ring + st * LT_STAGE;
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < LT_KT / 16; ++kc)
        wgmma_ss<LT_COLS, 0, 0>(
            acc, gmma_desc_sw(p + wgi * 64 * 128 + kc * 32, 16, 8 * 128, 1),
            gmma_desc_sw(p + LT_XBOX + kc * 32, 16, 8 * 128, 1),
            k > 0 || kc > 0);
      wg_commit();
      wg_wait<1>();
      if (k > 0) mbar_arrive(empty + (int)((s - 1) % LT_NS));
    }
    wg_wait<0>();
    fence_regs(acc);
    // the ring is the next tile's
    mbar_arrive(empty + (int)((s - 1) % LT_NS));

    // thread (warp, g, c) holds rows ra (acc[4j + q]) and ra + 8
    // (acc[4j + 2 + q]), columns 8j + 2c + q; the column masks only in
    // the vocabulary's last tile, the target compares only where a row's
    // target falls in the tile
    const int vl = V - v0 < LT_COLS ? (int)(V - v0) : LT_COLS;
    const bool whole = vl == LT_COLS;
    if (FWD) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int t = t0 + ra + 8 * hr;
        const bool hit = (unsigned)rel[hr] < (unsigned)vl;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float m = -INFINITY, tg = 0.f, l = 0.f;
#pragma unroll
          for (int j = 16 * h; j < 16 * h + 16; ++j)
#pragma unroll
            for (int q = 0; q < 2; ++q)
              if (whole || 8 * j + 2 * c + q < vl)
                m = fmaxf(m, acc[4 * j + 2 * hr + q]);
          if (hit) {
#pragma unroll
            for (int j = 16 * h; j < 16 * h + 16; ++j)
#pragma unroll
              for (int q = 0; q < 2; ++q)
                if (8 * j + 2 * c + q == rel[hr]) tg = acc[4 * j + 2 * hr + q];
          }
          // the max of s*log2e is the max of s, scaled: rounding keeps
          // the order
          m = quad_max(m) * LOG2E;
          tg = quad_sum(tg);
#pragma unroll
          for (int j = 16 * h; j < 16 * h + 16; ++j)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              float& a = acc[4 * j + 2 * hr + q];
              a = whole || 8 * j + 2 * c + q < vl ? ex2(fmaf(a, LOG2E, -m))
                                                  : 0.f;
              l += a;
            }
          l = quad_sum(l);
          if (c == 0 && t < T && 128 * h < vl) {
            const int64_t i = (int64_t)(2 * vt + h) * T + t;
            mrun[i] = m;
            lpart[i] = l;
            tpart[i] = tg;
          }
        }
      }
    } else {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
        for (int j = 0; j < LT_COLS / 8; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            float& a = acc[4 * j + 2 * hr + q];
            a = ex2(fmaf(a, LOG2E, -l2[hr])) * dn[hr];
          }
        if ((unsigned)rel[hr] < (unsigned)LT_COLS) {
#pragma unroll
          for (int j = 0; j < LT_COLS / 8; ++j)
#pragma unroll
            for (int q = 0; q < 2; ++q)
              if (8 * j + 2 * c + q == rel[hr])
                acc[4 * j + 2 * hr + q] -= dn[hr];
        }
      }
    }

    if (store) {
      if (lead) bulk_wait_read<0>();  // the last tile's boxes are read
      bar_sync(bar, 128);
#pragma unroll
      for (int j = 0; j < LT_COLS / 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = rl + 8 * hr;  // r & 7 == g
          *reinterpret_cast<uint32_t*>(os + (j >> 3) * LT_OBOX + r * 128 +
                                       (((j & 7) ^ g) << 4) + 4 * c) =
              pack_bf16(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
        }
      async_proxy_fence();
      bar_sync(bar, 128);
      if (lead && t0 + wgi * 64 < T) {
        for (int j = 0; j < LT_COLS / 64 && 64 * j < vl; ++j)
          tma_store2(tout, os + j * LT_OBOX, v0 + 64 * j, t0 + wgi * 64);
        bulk_commit();
      }
    }
  }
  if (lead && store) bulk_wait_all();
}

__global__ void __launch_bounds__(LT_THREADS, 1)
xent_fwd_bf16(const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap tw,
              const __grid_constant__ CUtensorMap te,
              const int* __restrict__ tgt, float* __restrict__ mrun,
              float* __restrict__ lpart, float* __restrict__ tpart,
              int64_t T, int64_t V, int64_t D, int save) {
  extern __shared__ __align__(1024) unsigned char lt_smem[];
  logits_body<true>(lt_smem, &tx, &tw, &te, tgt, nullptr, nullptr, mrun,
                    lpart, tpart, T, V, D, save, 0);
}

__global__ void __launch_bounds__(LT_THREADS, 1)
xent_g_bf16(const __grid_constant__ CUtensorMap tx,
            const __grid_constant__ CUtensorMap tw,
            const __grid_constant__ CUtensorMap tg,
            const int* __restrict__ tgt, const float* __restrict__ lse,
            const float* __restrict__ dnll, int64_t T, int64_t V,
            int64_t D, int vbase) {
  extern __shared__ __align__(1024) unsigned char lt_smem[];
  logits_body<false>(lt_smem, &tx, &tw, &tg, tgt, lse, dnll, nullptr,
                     nullptr, nullptr, T, V, D, 1, vbase);
}

// xent_fwd's merge (bf16): each token's lse and target logit from its nc
// chunks' partials. MG_SPLIT threads a token, each an online pass over
// its share of the chunks with MG_BATCH of them in flight, combined in
// shared memory; a warp's 32 tokens are consecutive, so its loads are
// whole 128-byte lines.
constexpr int MG_ROWS = 64, MG_SPLIT = 4, MG_BATCH = 16;

__global__ void __launch_bounds__(MG_ROWS * MG_SPLIT)
xent_merge(const float* __restrict__ mrun, const float* __restrict__ lpart,
           const float* __restrict__ tpart, float* __restrict__ lse,
           float* __restrict__ tgt_out, int64_t T, int64_t nc) {
  __shared__ float part[3][MG_SPLIT][MG_ROWS];
  const int r = threadIdx.x % MG_ROWS, sp = threadIdx.x / MG_ROWS;
  const int64_t t = (int64_t)blockIdx.x * MG_ROWS + r;
  const int64_t per = (nc + MG_SPLIT - 1) / MG_SPLIT;
  const int64_t c1 = (sp + 1) * per < nc ? (sp + 1) * per : nc;
  float m = -INFINITY, l = 0.f, tg = 0.f;
  for (int64_t c0 = sp * per; t < T && c0 < c1; c0 += MG_BATCH) {
    float mv[MG_BATCH], lv[MG_BATCH];
#pragma unroll
    for (int q = 0; q < MG_BATCH; ++q) {
      const bool ok = c0 + q < c1;
      const int64_t i = (c0 + q) * T + t;
      mv[q] = ok ? mrun[i] : -INFINITY;
      lv[q] = ok ? lpart[i] : 0.f;
      tg += ok ? tpart[i] : 0.f;
    }
    float bm = m;
#pragma unroll
    for (int q = 0; q < MG_BATCH; ++q) bm = fmaxf(bm, mv[q]);
    l *= exp2f(m - bm);  // 0 at the first batch (m = -inf)
#pragma unroll
    for (int q = 0; q < MG_BATCH; ++q) l += lv[q] * exp2f(mv[q] - bm);
    m = bm;
  }
  part[0][sp][r] = m;
  part[1][sp][r] = l;
  part[2][sp][r] = tg;
  __syncthreads();
  if (sp || t >= T) return;
  float big = -INFINITY, sum = 0.f, tsum = 0.f;
#pragma unroll
  for (int q = 0; q < MG_SPLIT; ++q) big = fmaxf(big, part[0][q][r]);
#pragma unroll
  for (int q = 0; q < MG_SPLIT; ++q) {  // an empty share adds 0
    sum += part[1][q][r] * exp2f(part[0][q][r] - big);
    tsum += part[2][q][r];
  }
  lse[t] = (big + log2f(sum)) * LN2;
  tgt_out[t] = tsum;
}

// g = (e * exp2(m_i - lse*log2e) - onehot(t)) * dnll(t) for the 8
// consecutive vocabulary columns v, v+1, ... of token t held in `raw`.
__device__ __forceinline__ uint4 g8(uint4 raw, int64_t t, int64_t v,
                                    const float* mrun, const int* tgt,
                                    const float* lse, const float* dnll,
                                    int64_t T, int64_t V, int64_t chunk) {
  const float sc = exp2f(mrun[(v / chunk) * T + t] - lse[t] * LOG2E);
  const int64_t target = tgt[t];
  const float dn = dnll[t];
  bf16* el = reinterpret_cast<bf16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float pr = __bfloat162float(el[j]) * sc;
    const float gv = v + j < V ? (pr - (v + j == target ? 1.f : 0.f)) * dn
                               : 0.f;
    el[j] = __float2bfloat16_rn(gv);
  }
  return raw;
}

// ---------------------------------------------------------------------------
// xent_g_saved: g (T, V) from the saved exponentials (_g_saved_kernel), 8
// columns a thread: an elementwise pass, bound by its bytes.
__global__ void __launch_bounds__(X_THREADS)
xent_g_saved_bf16(const bf16* __restrict__ e, const float* __restrict__ mrun,
                  const int* __restrict__ tgt, const float* __restrict__ lse,
                  const float* __restrict__ dnll, bf16* __restrict__ gout,
                  int64_t T, int64_t V, int64_t chunk) {
  const int64_t per_row = V / 8;
  const int64_t n = T * per_row;
  for (int64_t i = (int64_t)blockIdx.x * X_THREADS + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * X_THREADS) {
    const int64_t t = i / per_row, v = (i % per_row) * 8;
    const uint4 raw = *reinterpret_cast<const uint4*>(e + t * V + v);
    *reinterpret_cast<uint4*>(gout + t * V + v) =
        g8(raw, t, v, mrun, tgt, lse, dnll, T, V, chunk);
  }
}

// The recompute flavour of the fused backward (_dx_kernel / _dw_kernel
// with e_ref=None), bf16: out = g op with op = w for dx (T, D) and x for
// dw (V, D), g = (exp2(s*log2e - lse*log2e) - onehot) * dnll rounded to
// bf16 and s = x w^T recomputed a 64-wide step of the other dimension
// (vocabulary for dx, tokens for dw) at a time.
//
// A CTA's registers hold at most a 128 x 256 float32 output tile beside
// the logits, and a row tile's output spans all of D (1024 at the base
// preset), so C = D / 256 CTAs (rounded up to 1, 2, 4 or 8) share a row
// tile. The first design gave each its own 128 x 128 tile and had every
// one recompute the whole logits tile over D: D/128 = 8 rebuilds. Here
// the C CTAs form a thread-block cluster along D. CTA c holds the rows'
// slice c of D (128 x 256, loaded once by TMA) and streams the other
// operand's slice c, 64 rows a step, through a 3-stage TMA ring; a step
// reads the tile once for both products (the TPU's "one fetch, two
// dots"):
//   - the partial logits over its slice, S_c (128 x 64, wgmma m64n64k16,
//     both operands K-major in the 128-byte swizzle), into shared memory
//     in float32;
//   - after a cluster barrier, CTA c sums rows [c*128/C, (c+1)*128/C) of
//     the C partials through distributed shared memory, forms g there
//     (0 outside [0, T) x [0, V)) and writes it in bf16 into every CTA's
//     g tile (the token data in shared memory, copied a step ahead);
//   - after a second cluster barrier, out += g op_c (wgmma m64n128k16 x
//     2, g from registers by ldmatrix, the tile read MN-major through the
//     descriptor's transpose bit).
// The barriers are split (arrive, then wait) around the logits' issue.
// Each logits tile is formed once (rebuild factor 1): 2 x 2 T V D
// operations in all, the bound's (1.11 ms at the base shapes). Two
// warpgroups (64 rows each) run both products and the exchange; thread 0
// issues the ring's copies, each after the cluster barrier that shows
// both warpgroups done with the stage. Every wgmma group has one
// unconditional wait (conditional ones made ptxas serialize the groups),
// yet a group's issue holds its warps for most of its run, so the
// exchange, paced by the cluster's shared-memory network and its
// barriers, runs beside the products rather than under them. Variants
// with a separate exchanger warpgroup, paced by mbarriers that each CTA
// arrives on in every CTA, were slower: their remote arrivals cost more
// than the cluster barriers. D up to RC_CMAX * 256; wider heads take
// the chunk walk (icikit_xent_g_cols, icikit_xent_g_product).

constexpr int RC_ROWS = 128;    // output rows a CTA, two warpgroups
constexpr int RC_DS = 256;      // columns of D a CTA
constexpr int RC_KT = 64;       // the other dimension a step
constexpr int RC_NS = 3;        // ring stages
constexpr int RC_THREADS = 256;
constexpr int RC_CMAX = 8;      // the largest portable cluster
constexpr int RC_SW = 128;      // swizzle bytes: a TMA box is 64 columns
constexpr int RC_CB = RC_DS * 2 / RC_SW;        // column blocks a slice
constexpr int RC_RBOX = RC_ROWS * RC_SW;        // bytes of a row block
constexpr int RC_KBOX = RC_KT * RC_SW;          // bytes of a step's block
constexpr int RC_RTILE = RC_CB * RC_RBOX;       // the rows' slice, 64 KB
constexpr int RC_KTILE = RC_CB * RC_KBOX;       // a stage, 32 KB
constexpr int RC_SST = RC_KT + 4;  // float stride of the partial logits
constexpr int RC_GST = RC_KT + 8;  // bf16 stride of g (ldmatrix: no
                                   // bank conflicts)
constexpr size_t RC_SMEM = 1024 + RC_RTILE + RC_NS * RC_KTILE +
                           sizeof(float) * RC_ROWS * RC_SST +
                           sizeof(bf16) * RC_ROWS * RC_GST +
                           3 * 4 * RC_ROWS + sizeof(uint64_t) * (RC_NS + 1);

// Four 8x8 bf16 matrices, not transposed: the mma A fragment of a 16 x
// 16 tile whose rows lie in shared memory.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// S_c of step i for warpgroup wg's 64 rows (issued, not waited for):
// K-major A (the rows' slice) and B (the step's tile in its stage), the
// 16 k16 steps of the slice in one wgmma group.
__device__ __forceinline__ void rc_logits(float (&s)[RC_KT / 2],
                                          const unsigned char* rs,
                                          const unsigned char* ring,
                                          uint64_t* full, int i, int wg) {
  const unsigned char* ks = ring + (i % RC_NS) * RC_KTILE;
  mbar_wait(full + i % RC_NS, (i / RC_NS) & 1);
  wg_fence();
#pragma unroll
  for (int kc = 0; kc < RC_DS / 16; ++kc)
    wgmma_ss<RC_KT, 0, 0>(
        s,
        gmma_desc_sw(rs + kc * 32 / RC_SW * RC_RBOX + wg * 64 * RC_SW +
                         kc * 32 % RC_SW,
                     16, 8 * RC_SW, 1),
        gmma_desc_sw(ks + kc * 32 / RC_SW * RC_KBOX + kc * 32 % RC_SW, 16,
                     8 * RC_SW, 1),
        kc > 0);
  wg_commit();
}

// The two halves of a cluster barrier: arrive (releasing this thread's
// writes to the cluster) and wait (acquiring every thread's writes before
// their arrive).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// out += g op_c for warpgroup wg (issued, not waited for): g's A
// fragments by ldmatrix, the stage's tile MN-major.
__device__ __forceinline__ void rc_product(float (&o)[2][64],
                                           const bf16* gbuf,
                                           const unsigned char* ks, int wg) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  uint32_t a[RC_KT / 16][4];
#pragma unroll
  for (int cc = 0; cc < RC_KT / 16; ++cc)
    ldsm_x4(a[cc], gbuf + (wg * 64 + warp * 16 + (lane & 15)) * RC_GST +
                       cc * 16 + (lane >> 4) * 8);
  wg_fence();
#pragma unroll
  for (int cc = 0; cc < RC_KT / 16; ++cc)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      wgmma_rs<128, 1>(o[h], a[cc],
                       gmma_desc_sw(ks + h * 2 * RC_KBOX + cc * 16 * RC_SW,
                                    RC_KBOX, 8 * RC_SW, 1),
                       1);
  wg_commit();
}

// Rows [rank*128/C, +128/C) of a step's logits summed over the cluster's C
// partials, then g = (exp2(s*log2e - lse*log2e) - onehot) * dnll rounded
// to bf16 into every CTA's g tile. A thread takes 8/C float4s of a row
// (the same four columns in each), a float4's C remote loads at once.
// Token data: tls (lse), ttg, tdn for the tile's 128 rows (dx) or the
// step's 64 columns (dw); g is 0 outside [0, T) x [0, V).
template <int C, bool DX>
__device__ __forceinline__ void rc_reduce(cg::cluster_group& cl, int rank,
                                          const float* sbuf, bf16* gbuf,
                                          const float* tls, const int* ttg,
                                          const float* tdn, int64_t r0,
                                          int64_t k0, int64_t T, int64_t V) {
  constexpr int RP = RC_ROWS / C, ITEMS = RP * (RC_KT / 4) / RC_THREADS;
  const int tid = threadIdx.x;
#pragma unroll 1
  for (int it = 0; it < ITEMS; ++it) {
    const int e = tid + it * RC_THREADS;
    const int r = rank * RP + e / (RC_KT / 4), c4 = e % (RC_KT / 4) * 4;
    float4 p[C];
#pragma unroll
    for (int q = 0; q < C; ++q)
      p[q] = *reinterpret_cast<const float4*>(
          cl.map_shared_rank(sbuf + r * RC_SST + c4, q));
    float4 acc = p[0];
#pragma unroll
    for (int q = 1; q < C; ++q) {
      acc.x += p[q].x;
      acc.y += p[q].y;
      acc.z += p[q].z;
      acc.w += p[q].w;
    }
    const float sv[4] = {acc.x, acc.y, acc.z, acc.w};
    float gv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int tk = DX ? r : c4 + j;  // the token's slot
      const int64_t t = DX ? r0 + r : k0 + c4 + j;
      const int64_t v = DX ? k0 + c4 + j : r0 + r;
      gv[j] = 0.f;
      if (t < T && v < V) {
        const float pr = exp2f(sv[j] * LOG2E - tls[tk] * LOG2E);
        gv[j] = (pr - (v == (int64_t)ttg[tk] ? 1.f : 0.f)) * tdn[tk];
      }
    }
    const uint2 packed =
        make_uint2(pack_bf16(gv[0], gv[1]), pack_bf16(gv[2], gv[3]));
#pragma unroll
    for (int q = 0; q < C; ++q)
      *reinterpret_cast<uint2*>(
          cl.map_shared_rank(gbuf + r * RC_GST + c4, q)) = packed;
  }
}

// The tokens of slot `slot` (dx: the tile's rows from t0; dw: a step's
// columns from t0), 4-byte copies by threads below n, zero past T.
__device__ __forceinline__ void rc_tokens(float* tls, int* ttg, float* tdn,
                                          const float* lse, const int* tgt,
                                          const float* dnll, int64_t t0,
                                          int n, int64_t T) {
  const int tid = threadIdx.x;
  if (tid < n) {
    const int64_t t = t0 + tid;
    const int ok = t < T ? 4 : 0;
    const int64_t tc = t < T ? t : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(tls + tid)),
                 "l"(lse + tc), "r"(ok));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(ttg + tid)),
                 "l"(tgt + tc), "r"(ok));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(tdn + tid)),
                 "l"(dnll + tc), "r"(ok));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <bool DX>
__global__ void __launch_bounds__(RC_THREADS, 1)
xent_recompute_bf16(const __grid_constant__ CUtensorMap tr,
                    const __grid_constant__ CUtensorMap tk,
                    const int* __restrict__ tgt,
                    const float* __restrict__ lse,
                    const float* __restrict__ dnll, bf16* __restrict__ out,
                    int64_t T, int64_t V, int64_t D) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  extern __shared__ __align__(1024) unsigned char rc_smem[];
  unsigned char* rs =
      rc_smem + ((1024 - (smem_u32(rc_smem) & 1023)) & 1023);
  unsigned char* ring = rs + RC_RTILE;
  float* sbuf = reinterpret_cast<float*>(ring + RC_NS * RC_KTILE);
  bf16* gbuf = reinterpret_cast<bf16*>(sbuf + RC_ROWS * RC_SST);
  // token data: the tile's 128 rows (dx), or two steps' 64 columns (dw)
  float* tls = reinterpret_cast<float*>(gbuf + RC_ROWS * RC_GST);
  float* tdn = tls + RC_ROWS;
  int* ttg = reinterpret_cast<int*>(tdn + RC_ROWS);
  uint64_t* full = reinterpret_cast<uint64_t*>(ttg + RC_ROWS);
  uint64_t* rbar = full + RC_NS;
  const int64_t nrow_all = DX ? T : V, nk_all = DX ? V : T;
  const int64_t r0 = (int64_t)blockIdx.y * RC_ROWS;
  const int d0 = rank * RC_DS;  // the grid's x is the cluster
  const int nk = (int)((nk_all + RC_KT - 1) / RC_KT);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, c2 = (lane & 3) * 2;

  if (tid == 0) {
    for (int i = 0; i < RC_NS; ++i) mbar_init(full + i, 1);
    mbar_init(rbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // dx: the tile's rows; dw: step 0's columns (slot 0; step i's in slot
  // i % 2, each RC_KT wide)
  rc_tokens(tls, ttg, tdn, lse, tgt, dnll, DX ? r0 : 0,
            DX ? RC_ROWS : RC_KT, T);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  auto load_step = [&](int i) {  // the step's tile into stage i % RC_NS
    const int st = i % RC_NS;
    mbar_expect_tx(full + st, RC_KTILE);
    for (int j = 0; j < RC_CB; ++j)
      tma_box2(ring + st * RC_KTILE + j * RC_KBOX, &tk, d0 + j * RC_SW / 2,
               i * RC_KT, full + st);
  };
  if (tid == 0) {
    mbar_expect_tx(rbar, RC_RTILE);
    for (int j = 0; j < RC_CB; ++j)
      tma_box2(rs + j * RC_RBOX, &tr, d0 + j * RC_SW / 2, (int)r0, rbar);
    for (int i = 0; i < RC_NS && i < nk; ++i) load_step(i);
  }

  // The pipeline, one wait a group and none conditional (so that ptxas
  // keeps the groups asynchronous): at step i the logits of step i+1 (of
  // step nk-1 again at the last step, thrown away) run through the
  // exchange of step i, and the product of step i through the store of
  // the next partial.
  float s[RC_KT / 2];
  float o[2][64];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 64; ++j) o[h][j] = 0.f;
  mbar_wait(rbar, 0);
  if (nk > 0) {
    rc_logits(s, rs, ring, full, 0, wg);
    wg_wait<0>();
    fence_regs(s);
  }
  for (int i = 0; i < nk; ++i) {
    // this CTA's partial S_i, float32, into its own shared memory
    const int row = wg * 64 + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < RC_KT / 8; ++j) {
      *reinterpret_cast<float2*>(sbuf + row * RC_SST + 8 * j + c2) =
          make_float2(s[4 * j], s[4 * j + 1]);
      *reinterpret_cast<float2*>(sbuf + (row + 8) * RC_SST + 8 * j + c2) =
          make_float2(s[4 * j + 2], s[4 * j + 3]);
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // dw's tokens
    cluster_arrive();  // A: this CTA's partial (and tokens) in place
    const int nx = i + 1 < nk ? i + 1 : i;
    rc_logits(s, rs, ring, full, nx, wg);  // runs through the exchange
    wg_wait<1>();  // the product of step i-1 has read its stage
    cluster_wait();  // A: every partial in place; every g tile read
    const int slot = DX ? 0 : (i & 1) * RC_KT;
    const int64_t k0 = (int64_t)i * RC_KT;
#define RC_REDUCE(CC)                                                      \
  rc_reduce<CC, DX>(cl, rank, sbuf, gbuf, tls + slot, ttg + slot,          \
                    tdn + slot, r0, k0, T, V)
    if (C == 4) RC_REDUCE(4);
    else if (C == 8) RC_REDUCE(8);
    else if (C == 2) RC_REDUCE(2);
    else RC_REDUCE(1);
#undef RC_REDUCE
    if (!DX && i + 1 < nk)  // the next step's tokens, into the other slot
      rc_tokens(tls + (slot ^ RC_KT), ttg + (slot ^ RC_KT),
                tdn + (slot ^ RC_KT), lse, tgt, dnll, k0 + RC_KT, RC_KT, T);
    cluster_arrive();  // B: g written everywhere; the partials read
    cluster_wait();
    if (tid == 0 && i > 0 && i - 1 + RC_NS < nk) load_step(i - 1 + RC_NS);
    rc_product(o, gbuf, ring + (i % RC_NS) * RC_KTILE, wg);
    wg_wait<1>();  // the logits of step nx are in; the product runs on
    fence_regs(s);
  }
  wg_wait<0>();
  fence_regs(o[0]);
  fence_regs(o[1]);

  // the output tile: rows r0 + wg*64 + warp*16 + g (+8), columns d0 +
  // h*128 + 8j + c2 (+1)
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int64_t rr = r0 + wg * 64 + warp * 16 + g + hf * 8;
        const int64_t col = d0 + h * 128 + 8 * j + c2;
        if (rr < nrow_all && col < D)
          *reinterpret_cast<uint32_t*>(out + rr * D + col) =
              pack_bf16(o[h][4 * j + 2 * hf], o[h][4 * j + 2 * hf + 1]);
      }
}

// ---------------------------------------------------------------------------
// The saved flavour of the fused backward (_dx_saved_kernel /
// _dw_saved_kernel), bf16: out = g op with op = w (V, D) for dx (T, D)
// and x (T, D) for dw (V, D), g = (e * exp2(m_i - lse*log2e) - onehot) *
// dnll rebuilt from the saved exponentials e (T, V), 0 outside [0, T) x
// [0, V), rounded to bf16 for the tensor cores; the contraction (the
// vocabulary for dx, the tokens for dw) 64 a step. Bound: 2 T V D
// operations each, 0.556 ms at the base shapes.
//
// - A CTA owns a 128 x 256 output tile (rows of out: tokens for dx,
//   vocabulary for dw; a 256-column slice of D): two consumer warpgroups
//   of 64 rows, each one m64n256k16 a k16 step; a producer warp keeps
//   a 4-stage TMA ring full (e's 128 x 64 tile: one box of 128 tokens for
//   dx, two boxes of 64 vocabulary columns for dw; op's 64 x 256 slice in
//   four 64-column boxes; all in the 128-byte swizzle, zero past the
//   tensors). g needs no logits, so no cluster and no exchange: the D
//   slices of a row tile sit side by side in the grid and share e's
//   stream through L2 (four at D 1024), e read from device memory once.
// - g is formed in registers: each warp takes e's A fragments of a step
//   by ldmatrix from the stage (plain for dx, whose A is g (t, v);
//   .trans for dw, whose A is g^T (v, t)), rebuilds g pair by pair and
//   feeds it to wgmma as its register operand (op by descriptor,
//   MN-major through the transpose bit, as the recompute kernel's
//   product). A stage's group runs under the next stage's rebuild: two
//   fragment sets, one unconditional wait a group (for the group before),
//   the stage before released then. An odd step count runs one step more
//   past the contraction, zero-filled, with its factors 0.
// - The per-token factors are hoisted: the producer warp writes each
//   stage's A = exp2(m_i - lse*log2e) * dnll (dx: the tile's 128 tokens
//   at the step's chunk of mrun; dw: the step's 64 tokens at the tile's
//   chunk, whose 128 rows lie in one chunk) with the tokens' dnll and
//   targets (dw) into the stage's slot, fetched a step ahead, and arrives
//   on the stage's mbarrier after its writes. A consumer reads its
//   factors from the slot (dx: its two rows', whose targets and dnll sit
//   in registers): g = e * A - (v == target ? dnll : 0), a multiply an
//   element, no global load and no exp2; the compares run only in the
//   steps where a target falls (dx: a vote of the warp's rows; dw: the
//   producer's flag for the tile's rows), a quarter of them at the base
//   shapes, and the two paths give the same bits.
// - GIVEN (xent_dx_g_bf16, xent_dw_g_bf16: the recompute walk's products
//   past D 2048): the stage's tile is g itself, in bf16 (T, V), written
//   by xent_g_bf16. Its ldmatrix fragments go to wgmma as they are: no
//   factors, no compares, and the producer is one thread that only
//   starts the copies (a full barrier counts its expect_tx alone). The
//   step past an odd count reads zeros from both boxes.
constexpr int SV_ROWS = 128;     // output rows a CTA, two warpgroups
constexpr int SV_DS = 256;       // columns of D a CTA
constexpr int SV_KT = 64;        // the contraction a step
constexpr int SV_NS = 4;         // ring stages
constexpr int SV_THREADS = 384;  // two consumer warpgroups, a producer
constexpr int SV_KBOX = SV_KT * 128;           // a 64-column box, 8 KB
constexpr int SV_ETILE = SV_ROWS * SV_KT * 2;  // e's tile, 16 KB
constexpr int SV_STAGE = SV_ETILE + SV_DS / 64 * SV_KBOX;  // and op's
// a stage's slot: A, dnll, target (128 each; dw: target[SV_KT] flags a
// step in which a token targets one of the tile's rows)
constexpr int SV_TOK = 3 * SV_ROWS;
constexpr size_t SV_SMEM = 1024 + SV_NS * SV_STAGE +
                           SV_NS * SV_TOK * sizeof(float) +
                           2 * SV_NS * sizeof(uint64_t);

// One bf16 pair of g: e's pair u times a, less dn at the element whose
// vocabulary index is the target's (hit0, hit1).
__device__ __forceinline__ uint32_t g_pair(uint32_t u, float a0, float a1,
                                           bool hit0, float dn0, bool hit1,
                                           float dn1) {
  float lo = __uint_as_float(u << 16) * a0;
  float hi = __uint_as_float(u & 0xffff0000u) * a1;
  if (hit0) lo -= dn0;
  if (hit1) hi -= dn1;
  return pack_bf16(lo, hi);
}

// dx: the A fragments of a step (g (t, v)) for the lane's rows ra and ra +
// 8 of the tile; e's tile is 128 rows of 128 bytes. rel: target - v0 -
// 2c of each row (negative when the row has none in the step).
template <bool CHECK>
__device__ __forceinline__ void sv_frags_dx(uint32_t (&a)[SV_KT / 16][4],
                                            const unsigned char* es,
                                            const float* tk, int rbase,
                                            int ra, int rela, int relb,
                                            float dna, float dnb) {
  const int lane = threadIdx.x & 31;
  const float aa = tk[ra], ab = tk[ra + 8];
  const int row = rbase + (lane & 15);
#pragma unroll
  for (int cc = 0; cc < SV_KT / 16; ++cc) {
    uint32_t r[4];
    const int ch = 2 * cc + (lane >> 4);
    ldsm_x4(r, reinterpret_cast<const bf16*>(es + row * 128 +
                                             ((ch ^ (row & 7)) << 4)));
    const int k0 = 16 * cc;
    a[cc][0] = g_pair(r[0], aa, aa, CHECK && rela == k0, dna,
                      CHECK && rela == k0 + 1, dna);
    a[cc][1] = g_pair(r[1], ab, ab, CHECK && relb == k0, dnb,
                      CHECK && relb == k0 + 1, dnb);
    a[cc][2] = g_pair(r[2], aa, aa, CHECK && rela == k0 + 8, dna,
                      CHECK && rela == k0 + 9, dna);
    a[cc][3] = g_pair(r[3], ab, ab, CHECK && relb == k0 + 8, dnb,
                      CHECK && relb == k0 + 9, dnb);
  }
}

// dw: the A fragments of a step (g^T (v, t)) for the lane's rows ra and
// ra + 8 of the tile; e's tile is two blocks (the warpgroups' 64
// vocabulary columns) of 64 token rows of 128 bytes; the slot holds the
// step's 64 tokens' A, dnll and target less the tile's first row.
template <bool CHECK>
__device__ __forceinline__ void sv_frags_dw(uint32_t (&a)[SV_KT / 16][4],
                                            const unsigned char* es,
                                            const float* tk, int wgi,
                                            int warp, int ra) {
  const int lane = threadIdx.x & 31, c = lane & 3;
  const int mat = lane >> 3, mr = lane & 7;
  const unsigned char* blk = es + wgi * SV_KBOX;
  const int* tt = reinterpret_cast<const int*>(tk + 2 * SV_ROWS);
#pragma unroll
  for (int cc = 0; cc < SV_KT / 16; ++cc) {
    uint32_t r[4];
    const int t = 16 * cc + (mat >> 1) * 8 + mr;
    const int ch = 2 * warp + (mat & 1);
    ldsm_x4_t(r, reinterpret_cast<const bf16*>(blk + t * 128 +
                                               ((ch ^ (t & 7)) << 4)));
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int tl = 16 * cc + 8 * hf + 2 * c;
      const float2 av = *reinterpret_cast<const float2*>(tk + tl);
      float2 dv = make_float2(0.f, 0.f);
      int2 tv = make_int2(-1, -1);
      if (CHECK) {
        dv = *reinterpret_cast<const float2*>(tk + SV_ROWS + tl);
        tv = *reinterpret_cast<const int2*>(tt + tl);
      }
      a[cc][2 * hf] = g_pair(r[2 * hf], av.x, av.y, CHECK && tv.x == ra,
                             dv.x, CHECK && tv.y == ra, dv.y);
      a[cc][2 * hf + 1] = g_pair(r[2 * hf + 1], av.x, av.y,
                                 CHECK && tv.x == ra + 8, dv.x,
                                 CHECK && tv.y == ra + 8, dv.y);
    }
  }
}

// GIVEN: the A fragments of a step straight from g's tile in the stage
// (dx: g (t, v), 128 rows of 128 bytes; dw: g^T (v, t) from two blocks
// of 64 token rows), as sv_frags_dx / sv_frags_dw load e's.
template <bool DX>
__device__ __forceinline__ void sv_frags_given(uint32_t (&a)[SV_KT / 16][4],
                                               const unsigned char* es,
                                               int wgi, int warp) {
  const int lane = threadIdx.x & 31;
  const int mat = lane >> 3, mr = lane & 7;
  const int row = wgi * 64 + warp * 16 + (lane & 15);
  const unsigned char* blk = es + wgi * SV_KBOX;
#pragma unroll
  for (int cc = 0; cc < SV_KT / 16; ++cc) {
    if (DX) {
      const int ch = 2 * cc + (lane >> 4);
      ldsm_x4(a[cc], reinterpret_cast<const bf16*>(es + row * 128 +
                                                   ((ch ^ (row & 7)) << 4)));
    } else {
      const int t = 16 * cc + (mat >> 1) * 8 + mr;
      const int ch = 2 * warp + (mat & 1);
      ldsm_x4_t(a[cc], reinterpret_cast<const bf16*>(blk + t * 128 +
                                                     ((ch ^ (t & 7)) << 4)));
    }
  }
}

template <bool DX, bool GIVEN>
__device__ __forceinline__ void saved_body(
    unsigned char* smem, const CUtensorMap* te, const CUtensorMap* top,
    const float* __restrict__ mrun, const int* __restrict__ tgt,
    const float* __restrict__ lse, const float* __restrict__ dnll,
    bf16* __restrict__ out, int64_t T, int64_t V, int64_t D, int64_t chunk) {
  unsigned char* ring = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  float* tok = reinterpret_cast<float*>(ring + SV_NS * SV_STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(tok + SV_NS * SV_TOK);
  uint64_t* empty = full + SV_NS;
  const int64_t nrow_all = DX ? T : V, nk_all = DX ? V : T;
  const int64_t r0 = (int64_t)blockIdx.y * SV_ROWS;
  const int d0 = blockIdx.x * SV_DS;
  const int nk = (int)((nk_all + SV_KT - 1) / SV_KT);
  const int nk2 = (nk + 1) & ~1;  // even: the two fragment sets
  const int wgi = threadIdx.x >> 7, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < SV_NS; ++i) {
      // the TMA's expect_tx, and the warp's 32 unless g is given
      mbar_init(full + i, GIVEN ? 1 : 1 + 32);
      mbar_init(empty + i, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 2) {
    // the producer warp: stage i % SV_NS takes step i (its tiles by TMA,
    // its factors by the warp) once the consumers released step i - SV_NS
    setmaxnreg_dec<40>();
    auto load = [&](int i) {  // step i's boxes into stage i % SV_NS
      const int st = i % SV_NS;
      unsigned char* es = ring + st * SV_STAGE;
      mbar_expect_tx(full + st, SV_STAGE);
      if (DX) {
        tma_box2(es, te, i * SV_KT, (int)r0, full + st);
      } else {
        tma_box2(es, te, (int)r0, i * SV_KT, full + st);
        tma_box2(es + SV_KBOX, te, (int)r0 + 64, i * SV_KT, full + st);
      }
      for (int j = 0; j < SV_DS / 64; ++j)
        tma_box2(es + SV_ETILE + j * SV_KBOX, top, d0 + 64 * j, i * SV_KT,
                 full + st);
    };
    if (GIVEN) {
      if (threadIdx.x != 2 * 128) return;
      for (int i = 0; i < nk2; ++i) {
        if (i >= SV_NS) mbar_wait(empty + i % SV_NS, (i / SV_NS - 1) & 1);
        load(i);
      }
      return;
    }
    if (threadIdx.x >= 2 * 128 + 32) return;
    constexpr int Q = DX ? SV_ROWS / 32 : SV_KT / 32;  // tokens a lane
    float pm[Q], pl[Q], pd[Q];
    int pt[Q];
    // dx: the tile's rows, fixed (their lse in base 2); dw: the step's
    // tokens, fetched with m_i
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      pl[q] = pd[q] = 0.f;
      pt[q] = -1;
      if (DX && r0 + lane + 32 * q < T) {
        pl[q] = lse[r0 + lane + 32 * q] * LOG2E;
        pd[q] = dnll[r0 + lane + 32 * q];
      }
    }
    auto fetch = [&](int i) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int64_t t = DX ? r0 + lane + 32 * q
                             : (int64_t)i * SV_KT + lane + 32 * q;
        const int64_t c = DX ? (int64_t)i * SV_KT / chunk : r0 / chunk;
        const bool ok = t < T && i < nk;
        pm[q] = ok ? mrun[c * T + t] : 0.f;
        if (!DX) {
          pl[q] = ok ? lse[t] * LOG2E : 0.f;
          pd[q] = ok ? dnll[t] : 0.f;
          pt[q] = ok ? (int)(tgt[t] - r0) : -1;
        }
      }
    };
    fetch(0);
    for (int i = 0; i < nk2; ++i) {
      const int st = i % SV_NS;
      if (i >= SV_NS) mbar_wait(empty + st, (i / SV_NS - 1) & 1);
      if (lane == 0) load(i);
      float* tk = tok + st * SV_TOK;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int j = lane + 32 * q;
        // 0 past T and at the step past the contraction
        tk[j] = i < nk ? exp2f(pm[q] - pl[q]) * pd[q] : 0.f;
        if (!DX) {
          tk[SV_ROWS + j] = pd[q];
          reinterpret_cast<int*>(tk + 2 * SV_ROWS)[j] = pt[q];
        }
      }
      if (!DX) {
        bool any = false;
#pragma unroll
        for (int q = 0; q < Q; ++q)
          any |= (unsigned)pt[q] < (unsigned)SV_ROWS;
        any = __any_sync(0xffffffffu, any);
        if (lane == 0)
          reinterpret_cast<int*>(tk + 2 * SV_ROWS)[SV_KT] = any;
      }
      if (i + 1 < nk2) fetch(i + 1);  // in flight through the next wait
      mbar_arrive(full + st);
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int warp = (threadIdx.x >> 5) & 3, g = lane >> 2, c = lane & 3;
  const int ra = wgi * 64 + warp * 16 + g;  // and ra + 8, of the tile
  int tga = -1, tgb = -1;  // dx: the rows' targets and dnll
  float dna = 0.f, dnb = 0.f;
  if (DX && !GIVEN) {
    if (r0 + ra < T) {
      tga = tgt[r0 + ra];
      dna = dnll[r0 + ra];
    }
    if (r0 + ra + 8 < T) {
      tgb = tgt[r0 + ra + 8];
      dnb = dnll[r0 + ra + 8];
    }
  }
  float o[128];
#pragma unroll
  for (int j = 0; j < 128; ++j) o[j] = 0.f;
  uint32_t a0[SV_KT / 16][4], a1[SV_KT / 16][4];
  auto stage = [&](int i, uint32_t (&a)[SV_KT / 16][4]) {
    const int st = i % SV_NS;
    mbar_wait(full + st, (i / SV_NS) & 1);
    const unsigned char* es = ring + st * SV_STAGE;
    const float* tk = tok + st * SV_TOK;
    if (GIVEN) {
      sv_frags_given<DX>(a, es, wgi, warp);
    } else if (DX) {
      const int v0 = i * SV_KT;
      const bool hit = __any_sync(
          0xffffffffu, (unsigned)(tga - v0) < (unsigned)SV_KT ||
                           (unsigned)(tgb - v0) < (unsigned)SV_KT);
      if (hit)
        sv_frags_dx<true>(a, es, tk, wgi * 64 + warp * 16, ra,
                          tga - v0 - 2 * c, tgb - v0 - 2 * c, dna, dnb);
      else
        sv_frags_dx<false>(a, es, tk, wgi * 64 + warp * 16, ra, 0, 0, 0.f,
                           0.f);
    } else {
      if (reinterpret_cast<const int*>(tk + 2 * SV_ROWS)[SV_KT])
        sv_frags_dw<true>(a, es, tk, wgi, warp, ra);
      else
        sv_frags_dw<false>(a, es, tk, wgi, warp, ra);
    }
    wg_fence();
#pragma unroll
    for (int cc = 0; cc < SV_KT / 16; ++cc)
      wgmma_rs<256, 1>(o, a[cc],
                       gmma_desc_sw(es + SV_ETILE + cc * 16 * 128, SV_KBOX,
                                    8 * 128, 1),
                       1);
    wg_commit();
    wg_wait<1>();
    if (i > 0) mbar_arrive(empty + (i - 1) % SV_NS);
  };
  for (int i = 0; i < nk2; i += 2) {
    stage(i, a0);
    stage(i + 1, a1);
  }
  wg_wait<0>();
  fence_regs(o);

  // rows r0 + ra (+8), columns d0 + 8j + 2c (+1)
#pragma unroll
  for (int j = 0; j < SV_DS / 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int64_t rr = r0 + ra + hf * 8;
      const int64_t col = d0 + 8 * j + 2 * c;
      if (rr < nrow_all && col < D)
        *reinterpret_cast<uint32_t*>(out + rr * D + col) =
            pack_bf16(o[4 * j + 2 * hf], o[4 * j + 2 * hf + 1]);
    }
}

__global__ void __launch_bounds__(SV_THREADS, 1)
xent_dx_bf16(const __grid_constant__ CUtensorMap te,
             const __grid_constant__ CUtensorMap tw,
             const float* __restrict__ mrun, const int* __restrict__ tgt,
             const float* __restrict__ lse, const float* __restrict__ dnll,
             bf16* __restrict__ dx, int64_t T, int64_t V, int64_t D,
             int64_t chunk) {
  extern __shared__ __align__(1024) unsigned char sv_smem[];
  saved_body<true, false>(sv_smem, &te, &tw, mrun, tgt, lse, dnll, dx, T,
                          V, D, chunk);
}

__global__ void __launch_bounds__(SV_THREADS, 1)
xent_dw_bf16(const __grid_constant__ CUtensorMap te,
             const __grid_constant__ CUtensorMap tx,
             const float* __restrict__ mrun, const int* __restrict__ tgt,
             const float* __restrict__ lse, const float* __restrict__ dnll,
             bf16* __restrict__ dw, int64_t T, int64_t V, int64_t D,
             int64_t chunk) {
  extern __shared__ __align__(1024) unsigned char sv_smem[];
  saved_body<false, false>(sv_smem, &te, &tx, mrun, tgt, lse, dnll, dw, T,
                           V, D, chunk);
}

// The recompute walk's products past D 2048: dx (T, D) = g w from g (T, V)
// and w (V, D); dw (V, D) = g^T x from g (T, V) and x (T, D).
__global__ void __launch_bounds__(SV_THREADS, 1)
xent_dx_g_bf16(const __grid_constant__ CUtensorMap tg,
               const __grid_constant__ CUtensorMap tw,
               bf16* __restrict__ dx, int64_t T, int64_t V, int64_t D) {
  extern __shared__ __align__(1024) unsigned char sv_smem[];
  saved_body<true, true>(sv_smem, &tg, &tw, nullptr, nullptr, nullptr,
                         nullptr, dx, T, V, D, SV_ROWS);
}

__global__ void __launch_bounds__(SV_THREADS, 1)
xent_dw_g_bf16(const __grid_constant__ CUtensorMap tg,
               const __grid_constant__ CUtensorMap tx,
               bf16* __restrict__ dw, int64_t T, int64_t V, int64_t D) {
  extern __shared__ __align__(1024) unsigned char sv_smem[];
  saved_body<false, true>(sv_smem, &tg, &tx, nullptr, nullptr, nullptr,
                          nullptr, dw, T, V, D, SV_ROWS);
}

// ---------------------------------------------------------------------------
// float32 forms with plain FMA (the card's float32 checks). 64 x 64 tiles;
// thread (ty = tid/16, tx = tid%16) owns rows ty + 16i and columns
// tx + 16j, so a row's 16 threads are one half-warp.

__device__ __forceinline__ float g_at(const float* e, const float* mrun,
                                      const int* tgt, const float* lse,
                                      const float* dnll, int64_t t,
                                      int64_t v, int64_t T, int64_t V,
                                      int64_t chunk) {
  if (t >= T || v >= V) return 0.f;
  const float p = e[t * V + v] * exp2f(mrun[(v / chunk) * T + t] -
                                       lse[t] * LOG2E);
  return (p - (v == (int64_t)tgt[t] ? 1.f : 0.f)) * dnll[t];
}

// The float32 logits tile: acc[i][j] = row ty + 16i, column tx + 16j of
// the 64 x 64 tile A B^T (rows of A at a + r * D, of B at b + c * D; rows
// >= nrows of A and >= ncols of B read as zeros). Each contraction step
// starts with a barrier, so a caller may run it in a loop.
__device__ __forceinline__ void logits_tile_f32(float (&acc)[4][4],
                                                float (*as)[FS],
                                                float (*bs)[FS],
                                                const float* a,
                                                const float* b,
                                                int64_t nrows, int64_t ncols,
                                                int64_t D) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int64_t k0 = 0; k0 < D; k0 += FK) {
    __syncthreads();
    for (int i = threadIdx.x; i < FT * FK; i += F_THREADS) {
      const int r = i / FK, k = i % FK;
      const bool kok = k0 + k < D;
      as[k][r] = kok && r < nrows ? a[r * D + k0 + k] : 0.f;
      bs[k][r] = kok && r < ncols ? b[r * D + k0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = as[k][ty + 16 * i];
        bv[i] = bs[k][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
  }
}

__global__ void __launch_bounds__(F_THREADS)
xent_fwd_f32(const float* __restrict__ x, const float* __restrict__ w,
             const int* __restrict__ tgt, float* __restrict__ e,
             float* __restrict__ mrun, float* __restrict__ lpart,
             float* __restrict__ tpart, unsigned* counter,
             float* __restrict__ lse, float* __restrict__ tgt_out,
             int64_t T, int64_t V, int64_t D, int save) {
  __shared__ float as[FK][FS], bs[FK][FS];
  const int64_t t0 = (int64_t)blockIdx.x * FT, v0 = (int64_t)blockIdx.y * FT;
  const int64_t rows = T - t0 < FT ? T - t0 : FT;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[4][4];
  logits_tile_f32(acc, as, bs, x + t0 * D, w + v0 * D, T - t0, V - v0, D);
  const int64_t chunk = blockIdx.y;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    const int64_t t = t0 + row;
    const int64_t target = t < T ? (int64_t)tgt[t] : -1;
    float m = -INFINITY, tg = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t v = v0 + tx + 16 * j;
      if (v < V) {
        if (v == target) tg += acc[i][j];
        m = fmaxf(m, acc[i][j] * LOG2E);
      }
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      tg += __shfl_xor_sync(0xffffffffu, tg, off);
    }
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t v = v0 + tx + 16 * j;
      if (v < V) {
        const float ev = exp2f(acc[i][j] * LOG2E - m);
        l += ev;
        if (save && t < T) e[t * V + v] = ev;
      }
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (tx == 0 && t < T) {
      mrun[chunk * T + t] = m;
      lpart[chunk * T + t] = l;
      tpart[chunk * T + t] = tg;
    }
  }
  merge_partials(mrun, lpart, tpart, counter, lse, tgt_out, t0, (int)rows,
                 T, gridDim.y, blockIdx.x);
}

__global__ void __launch_bounds__(F_THREADS)
xent_dx_f32(const float* __restrict__ e, const float* __restrict__ mrun,
            const float* __restrict__ w, const int* __restrict__ tgt,
            const float* __restrict__ lse, const float* __restrict__ dnll,
            float* __restrict__ dx, int64_t T, int64_t V, int64_t D,
            int64_t chunk) {
  __shared__ float as[FK][FS], bs[FK][FS];
  const int64_t d0 = (int64_t)blockIdx.x * FT, t0 = (int64_t)blockIdx.y * FT;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[4][4] = {};
  for (int64_t k0 = 0; k0 < V; k0 += FK) {
    __syncthreads();
    for (int i = threadIdx.x; i < FT * FK; i += F_THREADS) {
      const int r = i / FK, k = i % FK;
      as[k][r] = g_at(e, mrun, tgt, lse, dnll, t0 + r, k0 + k, T, V, chunk);
      const int kb = i / FT, c = i % FT;
      bs[kb][c] = k0 + kb < V && d0 + c < D ? w[(k0 + kb) * D + d0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = as[k][ty + 16 * i];
        b[i] = bs[k][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t t = t0 + ty + 16 * i, d = d0 + tx + 16 * j;
      if (t < T && d < D) dx[t * D + d] = acc[i][j];
    }
}

__global__ void __launch_bounds__(F_THREADS)
xent_dw_f32(const float* __restrict__ e, const float* __restrict__ mrun,
            const float* __restrict__ x, const int* __restrict__ tgt,
            const float* __restrict__ lse, const float* __restrict__ dnll,
            float* __restrict__ dw, int64_t T, int64_t V, int64_t D,
            int64_t chunk) {
  __shared__ float as[FK][FS], bs[FK][FS];
  const int64_t d0 = (int64_t)blockIdx.x * FT, v0 = (int64_t)blockIdx.y * FT;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[4][4] = {};
  for (int64_t k0 = 0; k0 < T; k0 += FK) {
    __syncthreads();
    for (int i = threadIdx.x; i < FT * FK; i += F_THREADS) {
      const int k = i / FT, c = i % FT;
      as[k][c] = g_at(e, mrun, tgt, lse, dnll, k0 + k, v0 + c, T, V, chunk);
      bs[k][c] = k0 + k < T && d0 + c < D ? x[(k0 + k) * D + d0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = as[k][ty + 16 * i];
        b[i] = bs[k][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t v = v0 + ty + 16 * i, d = d0 + tx + 16 * j;
      if (v < V && d < D) dw[v * D + d] = acc[i][j];
    }
}

// The float32 forms of xent_g, xent_g_saved and the recompute dx/dw.

__device__ __forceinline__ float g_recompute_at(float sv, int64_t t,
                                                int64_t v, const int* tgt,
                                                const float* lse,
                                                const float* dnll, int64_t T,
                                                int64_t V) {
  if (t >= T || v >= V) return 0.f;
  const float p = exp2f(sv * LOG2E - lse[t] * LOG2E);
  return (p - (v == (int64_t)tgt[t] ? 1.f : 0.f)) * dnll[t];
}

__global__ void __launch_bounds__(F_THREADS)
xent_g_f32(const float* __restrict__ x, const float* __restrict__ w,
           const int* __restrict__ tgt, const float* __restrict__ lse,
           const float* __restrict__ dnll, float* __restrict__ gout,
           int64_t T, int64_t V, int64_t D) {
  __shared__ float as[FK][FS], bs[FK][FS];
  const int64_t t0 = (int64_t)blockIdx.x * FT, v0 = (int64_t)blockIdx.y * FT;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[4][4];
  logits_tile_f32(acc, as, bs, x + t0 * D, w + v0 * D, T - t0, V - v0, D);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t t = t0 + ty + 16 * i, v = v0 + tx + 16 * j;
      if (t < T && v < V)
        gout[t * V + v] = g_recompute_at(acc[i][j], t, v, tgt, lse, dnll, T,
                                         V);
    }
}

__global__ void __launch_bounds__(F_THREADS)
xent_g_saved_f32(const float* __restrict__ e, const float* __restrict__ mrun,
                 const int* __restrict__ tgt, const float* __restrict__ lse,
                 const float* __restrict__ dnll, float* __restrict__ gout,
                 int64_t T, int64_t V, int64_t chunk) {
  const int64_t n = T * V;
  for (int64_t i = (int64_t)blockIdx.x * F_THREADS + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * F_THREADS)
    gout[i] = g_at(e, mrun, tgt, lse, dnll, i / V, i % V, T, V, chunk);
}

// CTA (D tile, token tile) for dx, (D tile, vocab tile) for dw, 64 x 64;
// for each 64-wide piece of the other dimension: the logits tile, g into
// shared memory, the operand tile, the product. D/64 CTAs recompute each
// logits tile.
template <bool DX>
__global__ void __launch_bounds__(F_THREADS)
xent_recompute_f32(const float* __restrict__ x, const float* __restrict__ w,
                   const int* __restrict__ tgt,
                   const float* __restrict__ lse,
                   const float* __restrict__ dnll, float* __restrict__ out,
                   int64_t T, int64_t V, int64_t D) {
  __shared__ float as[FK][FS], bs[FK][FS];
  __shared__ float gsm[FT][FS], osm[FT][FS];
  const int64_t d0 = (int64_t)blockIdx.x * FT;
  const int64_t r0 = (int64_t)blockIdx.y * FT;
  const int64_t nrow_all = DX ? T : V, nk_all = DX ? V : T;
  const float* rsrc = (DX ? x : w) + r0 * D;
  const float* ksrc = DX ? w : x;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float oacc[4][4] = {};
  for (int64_t k0 = 0; k0 < nk_all; k0 += FT) {
    float sacc[4][4];
    logits_tile_f32(sacc, as, bs, rsrc, ksrc + k0 * D, nrow_all - r0,
                    nk_all - k0, D);
    for (int i = threadIdx.x; i < FT * FT; i += F_THREADS) {
      const int k = i / FT, c = i % FT;
      osm[k][c] = k0 + k < nk_all && d0 + c < D ? ksrc[(k0 + k) * D + d0 + c]
                                                : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t rr = r0 + ty + 16 * i, kk = k0 + tx + 16 * j;
        gsm[ty + 16 * i][tx + 16 * j] =
            DX ? g_recompute_at(sacc[i][j], rr, kk, tgt, lse, dnll, T, V)
               : g_recompute_at(sacc[i][j], kk, rr, tgt, lse, dnll, T, V);
      }
    __syncthreads();
    for (int k = 0; k < FT; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = gsm[ty + 16 * i][k];
        bv[i] = osm[k][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) oacc[i][j] += av[i] * bv[j];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t r = r0 + ty + 16 * i, d = d0 + tx + 16 * j;
      if (r < nrow_all && d < D) out[r * D + d] = oacc[i][j];
    }
}

inline unsigned tiles(int64_t n, int t) { return (unsigned)((n + t - 1) / t); }

// The TMA map of a (rows, cols) bf16 tensor as {cols, rows}, a box of 64
// columns (128 bytes) and box_rows rows landing in the 128-byte swizzle;
// rows and columns past the tensor's read as zeros.
int rows_map(CUtensorMap* map, const void* p, int64_t rows, int64_t cols,
             int box_rows) {
  return tma_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p, rows, cols,
                    RC_SW / 2, box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The cluster size of the recompute kernel at width D: D / 256 CTAs
// rounded up to a power of two, 0 past RC_CMAX (the chunk walk's
// widths).
int recompute_cluster(int64_t D) {
  int c = 1;
  while ((int64_t)c * RC_DS < D) c *= 2;
  return c <= RC_CMAX ? c : 0;
}

// The saved flavour's launch: e's map (boxes of 128 token rows for dx,
// 64 for dw) and op's (64 rows), a CTA a 128-row tile and a 256-column
// slice of D, the slices of a row tile side by side.
int launch_saved_bf16(int dx_side, const void* e, const float* mrun,
                      const void* op, const int* tgt, const float* lse,
                      const float* dnll, void* out, int64_t T, int64_t V,
                      int64_t D, int64_t chunk, cudaStream_t st) {
  const int64_t rows = dx_side ? T : V;
  if (T < 1 || V < 1 || D < 1 || chunk < 1 || chunk % SV_ROWS ||
      tiles(rows, SV_ROWS) > 65535 || T > INT32_MAX || V > INT32_MAX ||
      D > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  CUtensorMap te, top;
  int err = rows_map(&te, e, T, V, dx_side ? SV_ROWS : SV_KT);
  if (!err) err = rows_map(&top, op, dx_side ? V : T, D, SV_KT);
  if (err) return err;
  auto kernel = dx_side ? xent_dx_bf16 : xent_dw_bf16;
  const cudaError_t ce = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SV_SMEM);
  if (ce != cudaSuccess) return (int)ce;
  kernel<<<dim3(tiles(D, SV_DS), tiles(rows, SV_ROWS)), SV_THREADS, SV_SMEM,
           st>>>(te, top, mrun, tgt, lse, dnll, static_cast<bf16*>(out), T,
                 V, D, chunk);
  return (int)cudaGetLastError();
}

// The recompute walk's product past D 2048 (xent_dx_g_bf16 /
// xent_dw_g_bf16): g's map (boxes of 128 token rows for dx, 64 for dw)
// and op's (64 rows), a CTA a 128-row tile and a 256-column slice of D,
// the slices of a row tile side by side, as launch_saved_bf16.
int launch_g_product_bf16(int dx_side, const void* g, const void* op,
                          void* out, int64_t T, int64_t V, int64_t D,
                          cudaStream_t st) {
  const int64_t rows = dx_side ? T : V;
  if (T < 1 || V < 1 || D < 1 || V % 8 || D % 8 ||
      tiles(rows, SV_ROWS) > 65535 || T > INT32_MAX || V > INT32_MAX ||
      D > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tg, top;
  int err = rows_map(&tg, g, T, V, dx_side ? SV_ROWS : SV_KT);
  if (!err) err = rows_map(&top, op, dx_side ? V : T, D, SV_KT);
  if (err) return err;
  auto kernel = dx_side ? xent_dx_g_bf16 : xent_dw_g_bf16;
  const cudaError_t ce = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SV_SMEM);
  if (ce != cudaSuccess) return (int)ce;
  kernel<<<dim3(tiles(D, SV_DS), tiles(rows, SV_ROWS)), SV_THREADS, SV_SMEM,
           st>>>(tg, top, static_cast<bf16*>(out), T, V, D);
  return (int)cudaGetLastError();
}

int launch_recompute_bf16(int dx_side, const void* x, const void* w,
                          const int* tgt, const float* lse,
                          const float* dnll, void* out, int64_t T,
                          int64_t V, int64_t D, cudaStream_t st) {
  const int C = recompute_cluster(D);
  const int64_t rows = dx_side ? T : V, krows = dx_side ? V : T;
  // past one cluster: the chunk walk, cuda_xent.recompute_walk, over
  // icikit_xent_g_cols and icikit_xent_g_product
  if (!C) return (int)cudaErrorInvalidValue;
  if (rows < 1 || tiles(rows, RC_ROWS) > 65535 || krows > INT32_MAX ||
      rows > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tr, tk;
  int err = rows_map(&tr, dx_side ? x : w, rows, D, RC_ROWS);
  if (!err) err = rows_map(&tk, dx_side ? w : x, krows, D, RC_KT);
  if (err) return err;
  auto kernel =
      dx_side ? xent_recompute_bf16<true> : xent_recompute_bf16<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)RC_SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)C, tiles(rows, RC_ROWS));
  cfg.blockDim = dim3(RC_THREADS);
  cfg.dynamicSmemBytes = RC_SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, tr, tk, tgt, lse, dnll,
                         static_cast<bf16*>(out), T, V, D);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The logits body's launch, xent_fwd (fwd, then xent_merge) or xent_g:
// x's map (boxes of 128 token rows), w's (256 vocabulary rows) and the
// output's (64 x 64 boxes: e with save, g); one CTA an SM, fewer when
// there are fewer tiles; xent_g's targets count from vbase, the
// vocabulary row that w's first row holds. Refuses, before any launch,
// what the maps cannot take: an empty tensor, D or V not a multiple of 8,
// a size past INT32_MAX.
int launch_logits_bf16(int fwd, const void* x, const void* w, const int* tgt,
                       const float* lse, const float* dnll, void* out,
                       float* mrun, float* lpart, float* tpart,
                       float* lse_out, float* tgt_out, int64_t T, int64_t V,
                       int64_t D, int save, int64_t vbase, cudaStream_t st) {
  if (T < 1 || V < 1 || D < 1 || V % 8 || D % 8 || T > INT32_MAX ||
      V > INT32_MAX || D > INT32_MAX || vbase < 0 || vbase > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw, to = {};
  int err = rows_map(&tx, x, T, D, LT_ROWS);
  if (!err) err = rows_map(&tw, w, V, D, LT_COLS);
  if (!err && (!fwd || save)) err = rows_map(&to, out, T, V, 64);
  if (err) return err;
  int64_t grid = (int64_t)tiles(T, LT_ROWS) * tiles(V, LT_COLS);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (sms < grid) grid = sms;
  if (fwd) {
    e = cudaFuncSetAttribute(xent_fwd_bf16,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)LT_SMEM);
    if (e != cudaSuccess) return (int)e;
    xent_fwd_bf16<<<(unsigned)grid, LT_THREADS, LT_SMEM, st>>>(
        tx, tw, to, tgt, mrun, lpart, tpart, T, V, D, save);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    xent_merge<<<tiles(T, MG_ROWS), MG_ROWS * MG_SPLIT, 0, st>>>(
        mrun, lpart, tpart, lse_out, tgt_out, T, (V + 127) / 128);
  } else {
    e = cudaFuncSetAttribute(xent_g_bf16,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)LT_SMEM);
    if (e != cudaSuccess) return (int)e;
    xent_g_bf16<<<(unsigned)grid, LT_THREADS, LT_SMEM, st>>>(
        tx, tw, to, tgt, lse, dnll, T, V, D, (int)vbase);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x (T, D), w (V, D) in dtype; tgt (T,)
// int32; e (T, V) in dtype, written when save; mrun, lpart, tpart
// (V / chunk, T) float32 with chunk = 128 (bf16) or 64 (float32); counter
// (token tiles,) uint32, zero (float32: the merge's count, left at zero;
// bf16 merges in a second launch and leaves it untouched); lse, tgt_out
// (T,) float32. bf16 needs D and V multiples of 8.
int icikit_xent_fwd(int dtype, const void* x, const void* w, const int* tgt,
                    void* e, float* mrun, float* lpart, float* tpart,
                    unsigned* counter, float* lse, float* tgt_out, int64_t T,
                    int64_t V, int64_t D, int save, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_logits_bf16(1, x, w, tgt, nullptr, nullptr, e, mrun, lpart,
                              tpart, lse, tgt_out, T, V, D, save, 0, st);
  if (dtype == 0) {
    xent_fwd_f32<<<dim3(tiles(T, FT), tiles(V, FT)), F_THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), tgt,
        static_cast<float*>(e), mrun, lpart, tpart, counter, lse, tgt_out, T,
        V, D, save);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// e (T, V) and w (V, D) in dtype, mrun (V / chunk, T), tgt, lse, dnll (T,)
// -> dx (T, D) in dtype. bf16: chunk a multiple of 128 (a 128-row tile of
// dw lies in one chunk).
int icikit_xent_dx(int dtype, const void* e, const float* mrun, const void* w,
                   const int* tgt, const float* lse, const float* dnll,
                   void* dx, int64_t T, int64_t V, int64_t D, int64_t chunk,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_saved_bf16(1, e, mrun, w, tgt, lse, dnll, dx, T, V, D,
                             chunk, st);
  if (dtype == 0) {
    xent_dx_f32<<<dim3(tiles(D, FT), tiles(T, FT)), F_THREADS, 0, st>>>(
        static_cast<const float*>(e), mrun, static_cast<const float*>(w), tgt,
        lse, dnll, static_cast<float*>(dx), T, V, D, chunk);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// e (T, V) and x (T, D) in dtype, mrun (V / chunk, T), tgt, lse, dnll (T,)
// -> dw (V, D) in dtype.
int icikit_xent_dw(int dtype, const void* e, const float* mrun, const void* x,
                   const int* tgt, const float* lse, const float* dnll,
                   void* dw, int64_t T, int64_t V, int64_t D, int64_t chunk,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_saved_bf16(0, e, mrun, x, tgt, lse, dnll, dw, T, V, D,
                             chunk, st);
  if (dtype == 0) {
    xent_dw_f32<<<dim3(tiles(D, FT), tiles(V, FT)), F_THREADS, 0, st>>>(
        static_cast<const float*>(e), mrun, static_cast<const float*>(x), tgt,
        lse, dnll, static_cast<float*>(dw), T, V, D, chunk);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x (T, D), w (V, D) in dtype, tgt, lse, dnll (T,) -> g (T, V) in dtype,
// the logits recomputed (the matmul backward's recompute flavour).
int icikit_xent_g(int dtype, const void* x, const void* w, const int* tgt,
                  const float* lse, const float* dnll, void* g, int64_t T,
                  int64_t V, int64_t D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_logits_bf16(0, x, w, tgt, lse, dnll, g, nullptr, nullptr,
                              nullptr, nullptr, nullptr, T, V, D, 1, 0, st);
  if (dtype == 0) {
    xent_g_f32<<<dim3(tiles(T, FT), tiles(V, FT)), F_THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), tgt, lse,
        dnll, static_cast<float*>(g), T, V, D);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// e (T, V) in dtype, mrun (V / chunk, T), tgt, lse, dnll (T,) -> g (T, V)
// in dtype (the matmul backward's saved flavour).
int icikit_xent_g_saved(int dtype, const void* e, const float* mrun,
                        const int* tgt, const float* lse, const float* dnll,
                        void* g, int64_t T, int64_t V, int64_t chunk,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t blocks_max = 132 * 16;
  if (dtype == 1) {
    const int64_t n = T * (V / 8);
    const int64_t nb = (n + X_THREADS - 1) / X_THREADS;
    xent_g_saved_bf16<<<(unsigned)(nb < blocks_max ? nb : blocks_max),
                        X_THREADS, 0, st>>>(
        static_cast<const bf16*>(e), mrun, tgt, lse, dnll,
        static_cast<bf16*>(g), T, V, chunk);
  } else if (dtype == 0) {
    const int64_t nb = (T * V + F_THREADS - 1) / F_THREADS;
    xent_g_saved_f32<<<(unsigned)(nb < blocks_max ? nb : blocks_max),
                       F_THREADS, 0, st>>>(
        static_cast<const float*>(e), mrun, tgt, lse, dnll,
        static_cast<float*>(g), T, V, chunk);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The recompute flavour of the fused backward: x (T, D), w (V, D) in dtype,
// tgt, lse, dnll (T,) -> dx (T, D) when dx_side, else dw (V, D), in dtype.
// bf16 up to D 2048 (one cluster); wider bf16 heads take the chunk walk.
int icikit_xent_recompute(int dtype, int dx_side, const void* x,
                          const void* w, const int* tgt, const float* lse,
                          const float* dnll, void* out, int64_t T, int64_t V,
                          int64_t D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t rows = dx_side ? T : V;
  if (dtype == 1)
    return launch_recompute_bf16(dx_side, x, w, tgt, lse, dnll, out, T, V, D,
                                 st);
  if (dtype == 0) {
    const dim3 grid(tiles(D, FT), tiles(rows, FT));
    auto kernel = dx_side ? xent_recompute_f32<true>
                          : xent_recompute_f32<false>;
    kernel<<<grid, F_THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), tgt, lse,
        dnll, static_cast<float*>(out), T, V, D);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The bf16 recompute flavour past D 2048 (RC_CMAX * 256), where
// icikit_xent_recompute refuses bf16: its two pieces, which
// cuda_xent.recompute_walk runs chunk by chunk. g (T, V) in bf16 from x
// (T, D) and the head's vocabulary rows v0 .. v0+V (w, (V, D), points at
// row v0; the targets are absolute vocabulary ids), lse and dnll (T,), as
// icikit_xent_g (xent_g_bf16).
int icikit_xent_g_cols(const void* x, const void* w, const int* tgt,
                       const float* lse, const float* dnll, void* g,
                       int64_t T, int64_t V, int64_t D, int64_t v0,
                       void* stream) {
  return launch_logits_bf16(0, x, w, tgt, lse, dnll, g, nullptr, nullptr,
                            nullptr, nullptr, nullptr, T, V, D, 1, v0,
                            static_cast<cudaStream_t>(stream));
}

// dx (T, D) = g w from g (T, V) and op = w (V, D) when dx_side, else dw
// (V, D) = g^T x from op = x (T, D), all bf16 (xent_dx_g_bf16,
// xent_dw_g_bf16).
int icikit_xent_g_product(int dx_side, const void* g, const void* op,
                          void* out, int64_t T, int64_t V, int64_t D,
                          void* stream) {
  return launch_g_product_bf16(dx_side, g, op, out, T, V, D,
                               static_cast<cudaStream_t>(stream));
}

// The recompute kernel's clusters that the card holds at once at width
// D (cudaOccupancyMaxActiveClusters) and its cluster size.
int icikit_xent_recompute_clusters(int dx_side, int64_t D, int* clusters,
                                   int* cluster_size) {
  const int C = recompute_cluster(D);
  if (!C) return (int)cudaErrorInvalidValue;
  auto kernel =
      dx_side ? xent_recompute_bf16<true> : xent_recompute_bf16<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)RC_SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)C, 1024);
  cfg.blockDim = dim3(RC_THREADS);
  cfg.dynamicSmemBytes = RC_SMEM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  *cluster_size = C;
  return (int)cudaOccupancyMaxActiveClusters(clusters, (void*)kernel, &cfg);
}

// Kernel attributes for the build log: which 0 xent_fwd bf16, 1 dx bf16,
// 2 dw bf16, 3 xent_fwd f32, 4 xent_g bf16, 5 xent_g_saved bf16, 6 the
// recompute dx bf16, 7 the recompute dw bf16, 8 and 9 the recompute
// walk's products past D 2048 (dx, dw), 10 xent_fwd's merge (bf16).
int icikit_xent_regs(int which, int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err;
  if (which == 0)
    err = cudaFuncGetAttributes(&attr, xent_fwd_bf16);
  else if (which == 1)
    err = cudaFuncGetAttributes(&attr, xent_dx_bf16);
  else if (which == 2)
    err = cudaFuncGetAttributes(&attr, xent_dw_bf16);
  else if (which == 3)
    err = cudaFuncGetAttributes(&attr, xent_fwd_f32);
  else if (which == 4)
    err = cudaFuncGetAttributes(&attr, xent_g_bf16);
  else if (which == 5)
    err = cudaFuncGetAttributes(&attr, xent_g_saved_bf16);
  else if (which == 6)
    err = cudaFuncGetAttributes(&attr, xent_recompute_bf16<true>);
  else if (which == 7)
    err = cudaFuncGetAttributes(&attr, xent_recompute_bf16<false>);
  else if (which == 8)
    err = cudaFuncGetAttributes(&attr, xent_dx_g_bf16);
  else if (which == 9)
    err = cudaFuncGetAttributes(&attr, xent_dw_g_bf16);
  else
    err = cudaFuncGetAttributes(&attr, xent_merge);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
