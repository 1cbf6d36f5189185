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
//      leave the card idle, so the vocabulary is split across CTAs: CTA
//      (token tile, vocab tile) forms its 128 x 128 logits tile, takes
//      each row's tile max m_i (base 2), sum of exp2(s*log2e - m_i) and
//      target logit (natural units, before the base-2 scale, :98-101),
//      and with `save` writes e = exp2(s*log2e - m_i) in the compute
//      dtype plus m_i. The last CTA of a token tile to finish (an atomic
//      count) merges its rows' partials: lse = (M + log2 sum l_i
//      exp2(m_i - M)) * ln2. p = e * exp2(m_i - lse*log2e) holds whatever
//      order the chunks are visited in, so the backward rebuilds the
//      softmax from e and m_i as the TPU's does from its running max.
//      Bound (T 8192, D 1024, V 32768, bf16): 2*T*V*D = 549.8 GFLOP,
//      556 us at 989 TFLOP/s, against ~620 MB written and read: operations.
//
//   xent_dx_saved <- _dx_kernel, saved flavour (_dx_saved_kernel, B10,
//                    _dx_call, pallas_call :374).
//      dx = sum_v g w with g = (e * exp2(m_i - lse*log2e) - onehot) *
//      dnll rebuilt tile by tile in shared memory and never written out.
//   xent_dw_saved <- _dw_kernel, saved flavour (_dw_saved_kernel, B10,
//                    _dw_call, pallas_call :411).
//      dw = sum_t g^T x, g rebuilt the same way.
//      The TPU keeps (1024, 1024) and (2048, 1024) float32 accumulators
//      in VMEM; a CTA here holds a 128 x 128 output tile in registers, so
//      D is split across CTAs and the grid puts the CTAs that share a
//      token (dx) or vocab (dw) tile next to each other, so that they run
//      together and L2 absorbs the re-read of e (512 MiB at the base
//      preset) instead of device memory. Bound: 549.8 GFLOP each, 556 us:
//      operations.
//
//   xent_dx, xent_dw <- _dx_kernel / _dw_kernel with e_ref=None (B10,
//                    recompute flavour, pallas_calls :374, :411 via
//                    _dx_call/_dw_call).
//      dx and dw with g rebuilt from a recomputed logits tile
//      (_g_chunk_recompute) instead of from e: one more 2*T*V*D product
//      (bound 1.11 ms each at the base shapes, operations). A CTA holds a
//      128 x 128 output tile; the rebuild is repeated by each of the D/128
//      CTAs that share a token (dx) or vocab (dw) tile (see
//      xent_recompute_bf16).
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
// bf16: 8 warps a CTA, each a 32 x 64 piece of the 128 x 128 tile, on the
// tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate), the
// operands staged through shared memory by cp.async, double-buffered.
// Operands whose contraction dimension is not contiguous in memory (w in
// dx, e and x in dw) are read with ldmatrix.trans. g is rounded to bf16
// to enter the tensor cores, where the TPU contracts it in float32
// against w.astype(f32) (:199-201, :235-237): the tolerance in the tests
// states the cost. float32: 64 x 64 tiles of plain FMA, 4 x 4 a thread.
// Every entry returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

typedef __nv_bfloat16 bf16;

// bf16 tiles
constexpr int XT = 128;          // rows of a CTA tile
constexpr int XN = 128;          // columns of a CTA tile
constexpr int XK = 32;           // contraction step
constexpr int X_THREADS = 256;   // 8 warps: 4 (rows) x 2 (columns)
constexpr int AS = XK + 8;       // stride of a [rows][XK] stage
constexpr int BS = XN + 8;       // stride of a [XK][cols] stage
// float32 tiles
constexpr int FT = 64;
constexpr int FK = 16;
constexpr int F_THREADS = 256;   // 16 x 16, a 4 x 4 micro tile each
constexpr int FS = FT + 4;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices, each delivered transposed (the mma B or A
// fragment of an operand stored with the contraction dimension across
// rows).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// 16 bytes global -> shared, zero-filled when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Stage a [rows][XK] piece (row r at src + r * ld, columns k0..k0+XK)
// into shared memory with stride AS; rows >= nrows and columns >= ncols
// are zero-filled.
__device__ __forceinline__ void stage_rows_k(bf16* dst, const bf16* src,
                                             int64_t ld, int64_t nrows,
                                             int64_t ncols, int64_t k0) {
  for (int i = threadIdx.x; i < XT * XK / 8; i += X_THREADS) {
    const int r = i / (XK / 8), c8 = (i % (XK / 8)) * 8;
    const bool ok = r < nrows && k0 + c8 < ncols;
    cp_async16(dst + r * AS + c8, ok ? src + r * ld + k0 + c8 : src, ok);
  }
}

// Stage a [XK][XN] piece (contraction row k at src + (k0 + k) * ld,
// columns 0..XN) with stride BS; rows >= nk and columns >= ncols are
// zero-filled.
__device__ __forceinline__ void stage_k_cols(bf16* dst, const bf16* src,
                                             int64_t ld, int64_t k0,
                                             int64_t nk, int64_t ncols) {
  for (int i = threadIdx.x; i < XK * XN / 8; i += X_THREADS) {
    const int r = i / (XN / 8), c8 = (i % (XN / 8)) * 8;
    const bool ok = k0 + r < nk && c8 < ncols;
    cp_async16(dst + r * BS + c8, ok ? src + (k0 + r) * ld + c8 : src, ok);
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[2][8][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;
}

// B fragments of eight n-tiles (this warp's 64 columns) from a [XK][XN]
// stage, k rows kk*16 .. kk*16+15.
__device__ __forceinline__ void b_frags_kn(uint32_t (&b)[8][2],
                                           const bf16* stage, int kk,
                                           int wn) {
  const int lane = threadIdx.x & 31, mat = lane >> 3, r = lane & 7;
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t x[4];
    ldsm_x4_t(x, stage + (kk * 16 + (mat & 1) * 8 + r) * BS + wn * 64 +
                     np * 16 + (mat >> 1) * 8);
    b[2 * np][0] = x[0];
    b[2 * np][1] = x[1];
    b[2 * np + 1][0] = x[2];
    b[2 * np + 1][1] = x[3];
  }
}

// The logits tile: acc (a 128 x 128 tile, this warp's 32 x 64 piece) =
// A B^T over the contraction D, where row r of A is at a + r * D and row c
// of B at b + c * D; rows >= nrows of A and >= ncols of B read as zeros.
// Two-stage cp.async ring in as/bs. The leading barrier lets a caller run
// it in a loop: no warp still reads the ring from the previous call.
__device__ __forceinline__ void logits_tile(float (&acc)[2][8][4],
                                            bf16 (*as)[XT * AS],
                                            bf16 (*bs)[XN * AS],
                                            const bf16* a, const bf16* b,
                                            int64_t nrows, int64_t ncols,
                                            int64_t D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int wm = warp & 3, wn = warp >> 2;
  zero_acc(acc);
  const int nk = (int)((D + XK - 1) / XK);
  __syncthreads();
  stage_rows_k(as[0], a, D, nrows, D, 0);
  stage_rows_k(bs[0], b, D, ncols, D, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    cp_async_wait_all();
    __syncthreads();  // stage s landed; every warp is done with stage s^1
    if (kt + 1 < nk) {
      stage_rows_k(as[s ^ 1], a, D, nrows, D, (int64_t)(kt + 1) * XK);
      stage_rows_k(bs[s ^ 1], b, D, ncols, D, (int64_t)(kt + 1) * XK);
      cp_async_commit();
    }
#pragma unroll
    for (int kk = 0; kk < XK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const bf16* p = as[s] + (wm * 32 + mi * 16 + g) * AS + kk * 16 + c2;
        af[mi][0] = ld32(p);
        af[mi][1] = ld32(p + 8 * AS);
        af[mi][2] = ld32(p + 8);
        af[mi][3] = ld32(p + 8 * AS + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const bf16* p = bs[s] + (wn * 64 + ni * 8 + g) * AS + kk * 16 + c2;
        const uint32_t b0 = ld32(p), b1 = ld32(p + 8);
        mma_bf16(acc[0][ni], af[0], b0, b1);
        mma_bf16(acc[1][ni], af[1], b0, b1);
      }
    }
  }
}

// Store a 128 x 128 bf16 accumulator tile at out + row * ld + col.
__device__ __forceinline__ void store_tile(bf16* out, int64_t ld,
                                           int64_t nrows, int64_t ncols,
                                           const float (&acc)[2][8][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int wm = warp & 3, wn = warp >> 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 32 + mi * 16 + g + h * 8;
        const int col = wn * 64 + ni * 8 + c2;
        if (row < nrows && col < ncols)
          *reinterpret_cast<uint32_t*>(out + row * ld + col) =
              pack_bf16(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
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
// xent_fwd, bf16. Grid (token tiles, vocab tiles): the token tiles of one
// vocab tile are launched together, so w streams from device memory once
// and x (16 MiB at the base preset) is re-read from L2.

__global__ void __launch_bounds__(X_THREADS)
xent_fwd_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
              const int* __restrict__ tgt, bf16* __restrict__ e,
              float* __restrict__ mrun, float* __restrict__ lpart,
              float* __restrict__ tpart, unsigned* counter,
              float* __restrict__ lse, float* __restrict__ tgt_out,
              int64_t T, int64_t V, int64_t D, int save) {
  __shared__ __align__(16) bf16 as[2][XT * AS];
  __shared__ __align__(16) bf16 bs[2][XN * AS];
  __shared__ float rmax[2][XT], rsum[2][XT], rtgt[2][XT];
  const int64_t t0 = (int64_t)blockIdx.x * XT, v0 = (int64_t)blockIdx.y * XN;
  const int64_t rows = T - t0 < XT ? T - t0 : XT;
  const int64_t cols = V - v0 < XN ? V - v0 : XN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int wm = warp & 3, wn = warp >> 2;

  float acc[2][8][4];
  logits_tile(acc, as, bs, x + t0 * D, w + v0 * D, rows, cols, D);

  // Per row of the tile: the target logit (natural units) and the max
  // (base 2) over this warp's 64 columns, then over both column halves.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm * 32 + mi * 16 + g + h * 8;
      const int64_t target = row < rows ? (int64_t)tgt[t0 + row] : -1;
      float m = -INFINITY, tg = 0.f;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = wn * 64 + ni * 8 + c2 + j;
          const float sv = acc[mi][ni][2 * h + j];
          if (col < cols) {
            if (v0 + col == target) tg += sv;
            m = fmaxf(m, sv * LOG2E);
          }
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        tg += __shfl_xor_sync(0xffffffffu, tg, off);
      }
      if ((lane & 3) == 0) {
        rmax[wn][row] = m;
        rtgt[wn][row] = tg;
      }
    }
  __syncthreads();
  // e = exp2(s*log2e - m_i), its row sums, and e written out with `save`
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm * 32 + mi * 16 + g + h * 8;
      const float m = fmaxf(rmax[0][row], rmax[1][row]);
      float l = 0.f;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = wn * 64 + ni * 8 + c2;
        const float e0 =
            col < cols ? exp2f(acc[mi][ni][2 * h] * LOG2E - m) : 0.f;
        const float e1 =
            col + 1 < cols ? exp2f(acc[mi][ni][2 * h + 1] * LOG2E - m) : 0.f;
        l += e0 + e1;
        if (save && row < rows && col < cols)
          *reinterpret_cast<uint32_t*>(e + (t0 + row) * V + v0 + col) =
              pack_bf16(e0, e1);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        l += __shfl_xor_sync(0xffffffffu, l, off);
      if ((lane & 3) == 0) rsum[wn][row] = l;
    }
  __syncthreads();
  const int64_t chunk = blockIdx.y;
  for (int r = threadIdx.x; r < rows; r += X_THREADS) {
    mrun[chunk * T + t0 + r] = fmaxf(rmax[0][r], rmax[1][r]);
    lpart[chunk * T + t0 + r] = rsum[0][r] + rsum[1][r];
    tpart[chunk * T + t0 + r] = rtgt[0][r] + rtgt[1][r];
  }
  merge_partials(mrun, lpart, tpart, counter, lse, tgt_out, t0, (int)rows,
                 T, gridDim.y, blockIdx.x);
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

// The same, in place in shared memory.
__device__ __forceinline__ void rebuild_g8(bf16* p, int64_t t, int64_t v,
                                           const float* mrun,
                                           const int* tgt, const float* lse,
                                           const float* dnll, int64_t T,
                                           int64_t V, int64_t chunk) {
  *reinterpret_cast<uint4*>(p) = g8(*reinterpret_cast<uint4*>(p), t, v,
                                    mrun, tgt, lse, dnll, T, V, chunk);
}

// ---------------------------------------------------------------------------
// xent_dx_saved, bf16: dx (T, D) = g (T, V) w (V, D). Grid (D tiles,
// token tiles): the D tiles of one token tile run together and share
// their e stream through L2.

__global__ void __launch_bounds__(X_THREADS)
xent_dx_bf16(const bf16* __restrict__ e, const float* __restrict__ mrun,
             const bf16* __restrict__ w, const int* __restrict__ tgt,
             const float* __restrict__ lse, const float* __restrict__ dnll,
             bf16* __restrict__ dx, int64_t T, int64_t V, int64_t D,
             int64_t chunk) {
  __shared__ __align__(16) bf16 es[2][XT * AS];
  __shared__ __align__(16) bf16 ws[2][XK * BS];
  const int64_t d0 = (int64_t)blockIdx.x * XN, t0 = (int64_t)blockIdx.y * XT;
  const int64_t rows = T - t0 < XT ? T - t0 : XT;
  const int64_t dcols = D - d0 < XN ? D - d0 : XN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int wm = warp & 3, wn = warp >> 2;

  float acc[2][8][4];
  zero_acc(acc);
  const bf16* eb = e + t0 * V;
  const bf16* wb = w + d0;
  const int nk = (int)((V + XK - 1) / XK);
  stage_rows_k(es[0], eb, V, rows, V, 0);
  stage_k_cols(ws[0], wb, D, 0, V, dcols);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    const int64_t k0 = (int64_t)kt * XK;
    cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < nk) {
      stage_rows_k(es[s ^ 1], eb, V, rows, V, k0 + XK);
      stage_k_cols(ws[s ^ 1], wb, D, k0 + XK, V, dcols);
      cp_async_commit();
    }
    for (int i = threadIdx.x; i < XT * XK / 8; i += X_THREADS) {
      const int r = i / (XK / 8), c8 = (i % (XK / 8)) * 8;
      if (r < rows && k0 + c8 < V)
        rebuild_g8(es[s] + r * AS + c8, t0 + r, k0 + c8, mrun, tgt, lse,
                   dnll, T, V, chunk);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < XK / 16; ++kk) {
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const bf16* p = es[s] + (wm * 32 + mi * 16 + g) * AS + kk * 16 + c2;
        a[mi][0] = ld32(p);
        a[mi][1] = ld32(p + 8 * AS);
        a[mi][2] = ld32(p + 8);
        a[mi][3] = ld32(p + 8 * AS + 8);
      }
      b_frags_kn(b, ws[s], kk, wn);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        mma_bf16(acc[0][ni], a[0], b[ni][0], b[ni][1]);
        mma_bf16(acc[1][ni], a[1], b[ni][0], b[ni][1]);
      }
    }
  }
  store_tile(dx + t0 * D + d0, D, rows, dcols, acc);
}

// ---------------------------------------------------------------------------
// xent_dw_saved, bf16: dw (V, D) = g^T (V, T) x (T, D). Grid (D tiles,
// vocab tiles): the D tiles of one vocab tile run together and share
// their e stream through L2.

__global__ void __launch_bounds__(X_THREADS)
xent_dw_bf16(const bf16* __restrict__ e, const float* __restrict__ mrun,
             const bf16* __restrict__ x, const int* __restrict__ tgt,
             const float* __restrict__ lse, const float* __restrict__ dnll,
             bf16* __restrict__ dw, int64_t T, int64_t V, int64_t D,
             int64_t chunk) {
  __shared__ __align__(16) bf16 es[2][XK * BS];
  __shared__ __align__(16) bf16 xs[2][XK * BS];
  const int64_t d0 = (int64_t)blockIdx.x * XN, v0 = (int64_t)blockIdx.y * XT;
  const int64_t vrows = V - v0 < XT ? V - v0 : XT;
  const int64_t dcols = D - d0 < XN ? D - d0 : XN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int mat = lane >> 3, mr = lane & 7;

  float acc[2][8][4];
  zero_acc(acc);
  const bf16* eb = e + v0;
  const bf16* xb = x + d0;
  const int nk = (int)((T + XK - 1) / XK);
  stage_k_cols(es[0], eb, V, 0, T, vrows);
  stage_k_cols(xs[0], xb, D, 0, T, dcols);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    const int64_t k0 = (int64_t)kt * XK;
    cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < nk) {
      stage_k_cols(es[s ^ 1], eb, V, k0 + XK, T, vrows);
      stage_k_cols(xs[s ^ 1], xb, D, k0 + XK, T, dcols);
      cp_async_commit();
    }
    for (int i = threadIdx.x; i < XK * XT / 8; i += X_THREADS) {
      const int r = i / (XT / 8), c8 = (i % (XT / 8)) * 8;
      if (k0 + r < T && c8 < vrows)
        rebuild_g8(es[s] + r * BS + c8, k0 + r, v0 + c8, mrun, tgt, lse,
                   dnll, T, V, chunk);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < XK / 16; ++kk) {
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)  // g^T fragments: rows v, columns t
        ldsm_x4_t(a[mi], es[s] + (kk * 16 + (mat >> 1) * 8 + mr) * BS +
                             wm * 32 + mi * 16 + (mat & 1) * 8);
      b_frags_kn(b, xs[s], kk, wn);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        mma_bf16(acc[0][ni], a[0], b[ni][0], b[ni][1]);
        mma_bf16(acc[1][ni], a[1], b[ni][0], b[ni][1]);
      }
    }
  }
  store_tile(dw + v0 * D + d0, D, vrows, dcols, acc);
}

// ---------------------------------------------------------------------------
// The recompute flavour and the matmul backward's g (bf16).
//
// g_at_tile: g = (exp2(s*log2e - lse*log2e) - onehot) * dnll for this
// thread's entries of a logits tile `acc` (_g_chunk_recompute), with the
// token of an entry on its row (TOK_ROWS) or on its column; tl2, ttg and
// tdn hold the tile's 128 tokens' lse*log2e, target and dnll. Entries
// outside [0, T) x [0, V) are 0.

template <bool TOK_ROWS>
__device__ __forceinline__ float g_of(float sv, int row, int col,
                                      int64_t t0, int64_t v0, int64_t T,
                                      int64_t V, const float* tl2,
                                      const int* ttg, const float* tdn) {
  const int tr = TOK_ROWS ? row : col;
  const int64_t t = t0 + tr, v = v0 + (TOK_ROWS ? col : row);
  if (t >= T || v >= V) return 0.f;
  const float p = exp2f(sv * LOG2E - tl2[tr]);
  return (p - (v == (int64_t)ttg[tr] ? 1.f : 0.f)) * tdn[tr];
}

// The 128 tokens t0 .. t0+127 of a tile into shared memory.
__device__ __forceinline__ void load_tokens(float* tl2, int* ttg, float* tdn,
                                            const int* tgt, const float* lse,
                                            const float* dnll, int64_t t0,
                                            int64_t T) {
  for (int r = threadIdx.x; r < XT; r += X_THREADS) {
    const bool ok = t0 + r < T;
    tl2[r] = ok ? lse[t0 + r] * LOG2E : 0.f;
    ttg[r] = ok ? tgt[t0 + r] : -1;
    tdn[r] = ok ? dnll[t0 + r] : 0.f;
  }
}

// xent_g: g (T, V) = (softmax(x w^T) - onehot) * dnll in bf16, the logits
// tile formed in the kernel's own body (_bwd_kernel). Grid (token tiles,
// vocab tiles), as xent_fwd.
__global__ void __launch_bounds__(X_THREADS)
xent_g_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
            const int* __restrict__ tgt, const float* __restrict__ lse,
            const float* __restrict__ dnll, bf16* __restrict__ gout,
            int64_t T, int64_t V, int64_t D) {
  __shared__ __align__(16) bf16 as[2][XT * AS];
  __shared__ __align__(16) bf16 bs[2][XN * AS];
  __shared__ float tl2[XT], tdn[XT];
  __shared__ int ttg[XT];
  const int64_t t0 = (int64_t)blockIdx.x * XT, v0 = (int64_t)blockIdx.y * XN;
  const int64_t rows = T - t0 < XT ? T - t0 : XT;
  const int64_t cols = V - v0 < XN ? V - v0 : XN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int wm = warp & 3, wn = warp >> 2;
  load_tokens(tl2, ttg, tdn, tgt, lse, dnll, t0, T);
  float acc[2][8][4];
  logits_tile(acc, as, bs, x + t0 * D, w + v0 * D, rows, cols, D);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 32 + mi * 16 + g + h * 8;
        const int col = wn * 64 + ni * 8 + c2;
        if (row < rows && col < cols) {
          const float g0 = g_of<true>(acc[mi][ni][2 * h], row, col, t0, v0,
                                      T, V, tl2, ttg, tdn);
          const float g1 = g_of<true>(acc[mi][ni][2 * h + 1], row, col + 1,
                                      t0, v0, T, V, tl2, ttg, tdn);
          *reinterpret_cast<uint32_t*>(gout + (t0 + row) * V + v0 + col) =
              pack_bf16(g0, g1);
        }
      }
}

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
// with e_ref=None). CTA (D tile, token tile) for dx, (D tile, vocab tile)
// for dw, a 128 x 128 output tile in registers. For each 128-wide piece
// of the other dimension: the logits tile (x w^T for dx, w x^T for dw)
// through logits_tile; g from it, rounded to bf16, into shared memory;
// then the product's operand (w rows for dx, x rows for dw) staged into
// the logits ring, which is free by then, and the output tile += g op.
// The operand tile that feeds the product is the one the logits tile
// read along D (the TPU's "one fetch, two dots" at D-tile granularity).
// Every D tile of a row of CTAs recomputes the same logits: D/128 times
// the 2 T V D of the rebuild (8 at the base preset's D = 1024), the
// price of holding only a 128 x 128 accumulator a CTA.

constexpr int GS = XN + 8;  // stride of the g tile
constexpr size_t RECOMPUTE_SMEM =
    sizeof(bf16) * (4 * XT * AS + XT * GS) + sizeof(float) * 2 * XT +
    sizeof(int) * XT;

template <bool DX>
__global__ void __launch_bounds__(X_THREADS)
xent_recompute_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const int* __restrict__ tgt,
                    const float* __restrict__ lse,
                    const float* __restrict__ dnll, bf16* __restrict__ out,
                    int64_t T, int64_t V, int64_t D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16 (*as)[XT * AS] = reinterpret_cast<bf16 (*)[XT * AS]>(smem_raw);
  bf16 (*bs)[XN * AS] = reinterpret_cast<bf16 (*)[XN * AS]>(
      smem_raw + sizeof(bf16) * 2 * XT * AS);
  bf16* ostage = reinterpret_cast<bf16*>(smem_raw);  // [128][BS] over as/bs
  bf16* gs = reinterpret_cast<bf16*>(smem_raw + sizeof(bf16) * 4 * XT * AS);
  float* tl2 = reinterpret_cast<float*>(gs + XT * GS);
  float* tdn = tl2 + XT;
  int* ttg = reinterpret_cast<int*>(tdn + XT);
  const int64_t d0 = (int64_t)blockIdx.x * XN;
  const int64_t r0 = (int64_t)blockIdx.y * XT;  // token (dx) or vocab (dw)
  const int64_t nrow_all = DX ? T : V, nk_all = DX ? V : T;
  const int64_t rows = nrow_all - r0 < XT ? nrow_all - r0 : XT;
  const int64_t dcols = D - d0 < XN ? D - d0 : XN;
  const bf16* rsrc = (DX ? x : w) + r0 * D;   // the tile's own rows
  const bf16* ksrc = DX ? w : x;              // rows along the contraction
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int wm = warp & 3, wn = warp >> 2;

  if (DX) load_tokens(tl2, ttg, tdn, tgt, lse, dnll, r0, T);
  float oacc[2][8][4];
  zero_acc(oacc);
  for (int64_t k0 = 0; k0 < nk_all; k0 += XN) {
    const int64_t kn = nk_all - k0 < XN ? nk_all - k0 : XN;
    if (!DX) {
      __syncthreads();  // the previous piece's tokens are consumed
      load_tokens(tl2, ttg, tdn, tgt, lse, dnll, k0, T);
    }
    float sacc[2][8][4];
    logits_tile(sacc, as, bs, rsrc, ksrc + k0 * D, rows, kn, D);
    __syncthreads();  // every warp is done with the ring
#pragma unroll
    for (int q4 = 0; q4 < XN / XK; ++q4)
      stage_k_cols(ostage + q4 * XK * BS, ksrc + d0, D, k0 + q4 * XK,
                   nk_all, dcols);
    cp_async_commit();
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm * 32 + mi * 16 + g + h * 8;
          const int col = wn * 64 + ni * 8 + c2;
          const int64_t t0 = DX ? r0 : k0, v0 = DX ? k0 : r0;
          const float g0 = g_of<DX>(sacc[mi][ni][2 * h], row, col, t0, v0,
                                    T, V, tl2, ttg, tdn);
          const float g1 = g_of<DX>(sacc[mi][ni][2 * h + 1], row, col + 1,
                                    t0, v0, T, V, tl2, ttg, tdn);
          *reinterpret_cast<uint32_t*>(gs + row * GS + col) =
              pack_bf16(g0, g1);
        }
    cp_async_wait_all();
    __syncthreads();  // g and the operand tile are in place
#pragma unroll
    for (int kk = 0; kk < XN / 16; ++kk) {
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const bf16* p = gs + (wm * 32 + mi * 16 + g) * GS + kk * 16 + c2;
        a[mi][0] = ld32(p);
        a[mi][1] = ld32(p + 8 * GS);
        a[mi][2] = ld32(p + 8);
        a[mi][3] = ld32(p + 8 * GS + 8);
      }
      b_frags_kn(b, ostage, kk, wn);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        mma_bf16(oacc[0][ni], a[0], b[ni][0], b[ni][1]);
        mma_bf16(oacc[1][ni], a[1], b[ni][0], b[ni][1]);
      }
    }
  }
  store_tile(out + r0 * D + d0, D, rows, dcols, oacc);
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x (T, D), w (V, D) in dtype; tgt (T,)
// int32; e (T, V) in dtype, written when save; mrun, lpart, tpart
// (V / chunk, T) float32 with chunk = 128 (bf16) or 64 (float32); counter
// (token tiles,) uint32, zero; lse, tgt_out (T,) float32. bf16 needs D
// and V multiples of 8.
int icikit_xent_fwd(int dtype, const void* x, const void* w, const int* tgt,
                    void* e, float* mrun, float* lpart, float* tpart,
                    unsigned* counter, float* lse, float* tgt_out, int64_t T,
                    int64_t V, int64_t D, int save, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    xent_fwd_bf16<<<dim3(tiles(T, XT), tiles(V, XN)), X_THREADS, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), tgt,
        static_cast<bf16*>(e), mrun, lpart, tpart, counter, lse, tgt_out, T,
        V, D, save);
  } else if (dtype == 0) {
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
// -> dx (T, D) in dtype.
int icikit_xent_dx(int dtype, const void* e, const float* mrun, const void* w,
                   const int* tgt, const float* lse, const float* dnll,
                   void* dx, int64_t T, int64_t V, int64_t D, int64_t chunk,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    xent_dx_bf16<<<dim3(tiles(D, XN), tiles(T, XT)), X_THREADS, 0, st>>>(
        static_cast<const bf16*>(e), mrun, static_cast<const bf16*>(w), tgt,
        lse, dnll, static_cast<bf16*>(dx), T, V, D, chunk);
  } else if (dtype == 0) {
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
  if (dtype == 1) {
    xent_dw_bf16<<<dim3(tiles(D, XN), tiles(V, XT)), X_THREADS, 0, st>>>(
        static_cast<const bf16*>(e), mrun, static_cast<const bf16*>(x), tgt,
        lse, dnll, static_cast<bf16*>(dw), T, V, D, chunk);
  } else if (dtype == 0) {
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
  if (dtype == 1) {
    xent_g_bf16<<<dim3(tiles(T, XT), tiles(V, XN)), X_THREADS, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), tgt, lse,
        dnll, static_cast<bf16*>(g), T, V, D);
  } else if (dtype == 0) {
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
int icikit_xent_recompute(int dtype, int dx_side, const void* x,
                          const void* w, const int* tgt, const float* lse,
                          const float* dnll, void* out, int64_t T, int64_t V,
                          int64_t D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t rows = dx_side ? T : V;
  if (dtype == 1) {
    const dim3 grid(tiles(D, XN), tiles(rows, XT));
    auto kernel = dx_side ? xent_recompute_bf16<true>
                          : xent_recompute_bf16<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)RECOMPUTE_SMEM);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, X_THREADS, RECOMPUTE_SMEM, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), tgt, lse,
        dnll, static_cast<bf16*>(out), T, V, D);
  } else if (dtype == 0) {
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

// Kernel attributes for the build log: which 0 xent_fwd bf16, 1 dx bf16,
// 2 dw bf16, 3 xent_fwd f32, 4 xent_g bf16, 5 xent_g_saved bf16, 6 the
// recompute dx bf16, 7 the recompute dw bf16.
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
  else
    err = cudaFuncGetAttributes(&attr, xent_recompute_bf16<false>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
