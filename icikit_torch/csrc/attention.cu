// Attention kernels for Hopper (sm_90a), bound with ctypes.
//
// Six kernels, one for each group of TPU kernels of
// icikit/ops/flash_attention.py that the port's paths run:
//
//   flash_fwd   <- _fwd_kernel (B3, _fwd_call, pallas_call :421),
//                  _fwd_const_kernel (B4, same call) and
//                  _fwd_single_kernel (B5, _fwd_single_call, :349).
//      Causal or full flash-attention forward: out and the per-row
//      log-sum-exp in nats. On the TPU, B5 is the one-K-block case of
//      B3/B4 (no carried statistics); here it is the same loop run once,
//      so one kernel computes all three. One CTA per (batch*head,
//      64-row Q tile); K/V tiles of 64 keys are staged through shared
//      memory and the loop stops at the causal diagonal (_last_valid_k's
//      fetch elision as a loop bound). Online softmax in base 2 with
//      log2(e) folded into the scale, float32 statistics and
//      accumulator; masked entries take the finite NEG_INF
//      (flash_attention.py:93-99), and a ragged last tile is masked
//      (keys) and zero-filled (K and V), so every length runs here.
//      Constant-shift mode (B4, and B5's shift branch :328-335): the
//      weights are exp2(s*scale*log2e - shift) with no running max and
//      no rescale, and lse = shift*ln2 + ln l. The TPU re-runs the whole
//      call online when any lse is non-finite (_fwd_with_fallback, a
//      traced cond); here a CTA that finds a row's l outside [2^-64,
//      2^64] (inf, 0 and NaN among them) redoes its own Q tile with the
//      online softmax, so the caller always gets final, finite (out,
//      lse) with no extra launch and no host sync. The range is stricter
//      than JAX's test: a finite l below it means the row's weights sat
//      in exp2's subnormal range (few significant bits), and one above it
//      lets P V overflow while l does not. bf16: four warps, each owning 16 Q rows, run
//      both products on the tensor cores with mma.sync m16n8k16 (bf16
//      in, fp32 accumulate); P is rounded to bf16 before PV, as the TPU
//      kernel does. float32: the same tiles with plain FMA. Head dims
//      32, 64, 128 and 256. At 256 a warp cannot hold a 16 x 256 float32
//      accumulator (128 registers) beside its Q fragments, so eight warps
//      run the tile: two to each 16-row group, each forming the group's S
//      over all of d and owning half of the output columns (col_groups;
//      the backward kernels split their outputs the same way).
//      Bound (b=8, h=8, s=1024, d=128, bf16, causal): 67.4 MB read and
//      written, 20.1 us at 3.35 TB/s, against 17.2 GFLOP, 17.4 us at
//      989 TFLOP/s: bytes. Each K/V tile is read once per Q tile but
//      from L2; the design keeps S and P out of device memory. wgmma,
//      TMA and a pipelined ring of tiles are later work.
//
//   flash_bwd   <- _bwd_fused_kernel (B6, _bwd_call, pallas_call :701)
//                  and _bwd_fused_tiled_kernel (B7,
//                  _bwd_fused_tiled_call, :653).
//      dq, dk and dv from one recomputation of P per tile (_p_tile:
//      exp2(s*scale*log2e - lse*log2e)): dv = P^T dO, dS = P o (dP -
//      delta) * scale, dq = dS K, dk = dS^T Q, with delta = rowsum(dO o
//      O) - g_lse computed by the caller. One CTA per (batch*head,
//      64-key tile) holds its K and V tile (and K^T) in shared memory
//      and dk, dv in registers, and walks the 32-row Q tiles from the
//      causal diagonal to the end: this loop takes the place of the
//      TPU's sequential grid, whose carried accumulators do not
//      translate to CTAs that run in no order. dq is summed across the
//      CTAs of a head with float32 atomicAdd into a zeroed (b*h, s, d)
//      buffer (the TPU's whole-sequence VMEM dq scratch, :626), so its
//      summation order varies from run to run. bf16: S^T and dP^T are
//      computed key-major, so their mma accumulators are the A
//      fragments of the dv and dk products; P and dS are rounded to
//      bf16 before those products, as on the TPU; dS goes through
//      shared memory, transposed, for dq. float32: plain FMA. One
//      kernel covers B6 (one block, s <= 1024) and B7 (many blocks).
//      Bound (b=8, h=8, s=1024, d=128, bf16, causal): 117.9 MB, 35.2
//      us, against five causal products, 42.9 GFLOP, 43.4 us at 989
//      TFLOP/s: operations.
//
//   flash_bwd_dq  <- _bwd_dq_kernel (B8, _bwd_call, pallas_call :745)
//   flash_bwd_dkv <- _bwd_dkv_kernel (B8, _bwd_call, pallas_call :771).
//      The deterministic two-pass backward the TPU runs past its 48 MB
//      whole-sequence dq scratch (sq*d*4 > _DQ_SCRATCH_BYTES_MAX, :626):
//      no atomics, every output written once. flash_bwd_dq: one CTA per
//      (batch*head, 64-row Q tile), Q and dO fragments and dq in
//      registers, walking the K tiles up to the causal bound; S = Q K^T
//      and dP = dO V^T per tile, dS = P o (dP - delta) * scale rounded to
//      bf16 and dq += dS K against K^T staged in shared memory.
//      flash_bwd_dkv is flash_bwd's kernel with its dq part compiled out
//      (the DQ template flag): one CTA per 64-key tile, dk and dv in
//      registers, Q tiles from the diagonal. Both recompute P from lse
//      in base 2 (_p_tile). The pair forms S and dP twice (seven products
//      where flash_bwd runs five): that is the price of determinism and
//      of no (b*h, s, d) float32 dq buffer.
//      Bound (b=1, h=4, s=131072, d=128, bf16, causal): the function's
//      five causal products, 44.0 TFLOP, 44.5 ms at 989 TFLOP/s
//      (dq alone three of them, dk/dv four): operations.
//
//   decode_step <- _decode_step_kernel (B13, decode_step_attention,
//                  pallas_call :1120).
//   decode_step_q8 <- _decode_step_q8_kernel (B14,
//                  decode_step_attention_q8, pallas_call :1229).
//      One token of decode attention for one (batch*head) row per CTA:
//      split-half RoPE of q and k in float32, rounded back to the input
//      dtype (:1022-1023); the k/v column written at `cur` in place into
//      the caller's caches (the TPU kernel's input_output_aliases); then
//      masked attention over columns t < cur read from the cache, with
//      the t == cur term patched from registers, natural exp, float32
//      softmax, past weights cast to the cache dtype before the value
//      product (:1040), the sum divided by l at the end. The rotation
//      is the TPU kernel's x * cos2 + rot * sin2 with the first product
//      fused into the add (__fmaf_rn), the form XLA compiles it to, so
//      the written column equals the reference's and the plain
//      version's bit for bit.
//      Bound (64 rows, ~544 columns, dh 128, bf16): 17.8 MB of K and V,
//      5.3 us at 3.35 TB/s: bytes. Eight warps stream the columns; a
//      lane holds four contiguous elements of each 128-wide chunk of a
//      row, so a warp reads one coalesced segment a row a chunk and any
//      head dim that is a multiple of 128 runs (JAX's gate). 64 CTAs leave
//      half of the 132 SMs idle; a split-K (flash-decoding) form is a
//      later design.
//      decode_step_q8 is the same step over int8 caches, as the TPU's:
//      q arrives rotated and the fresh column quantized (written in place
//      at cur) and dequantized (the t == cur term); K's per-column float32
//      scale multiplies the int8 logit row, V's folds into the weights
//      before the value product; float32 softmax and output. RoPE, the
//      column's quantization and the scale-row write stay outside the
//      launch, as in JAX. Bound (64 rows, cur 543, dh 128): 8.9 MB of
//      int8 K and V and 0.28 MB of scales, 2.8 us: bytes.
//
// Every entry returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -3.4028234663852886e38f;  // float32 min, finite
constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BM = 64;             // Q rows a CTA
constexpr int BN = 64;             // keys a tile
constexpr int BQB = 32;            // Q rows a backward step
constexpr int MMA_THREADS = 128;   // bf16: 4 warps x 16 rows
constexpr int F32_THREADS = 256;   // f32: 4 threads a row
constexpr int DEC_THREADS = 256;   // decode: 8 warps
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_EPL = 4;         // decode: elements a lane a chunk
constexpr int DEC_CW = 32 * DEC_EPL;  // decode: a row chunk, 128 elements

// Column groups of the bf16 flash kernels: at d = 256 one warp cannot
// hold a 16 x d float32 accumulator (128 registers) beside its operand
// fragments, so two warps share each 16-row (or 16-key) group, each
// owning half of the output columns, and 8 warps run a CTA. Both warps
// of a group form the group's S (and dP) tiles over all of d.
template <int D>
__host__ __device__ constexpr int col_groups() {
  return D > 128 ? 2 : 1;
}

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
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

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ---------------------------------------------------------------------------
// flash_fwd, bf16 on the tensor cores. Warp w owns Q rows (w&3)*16 ..
// +15 of the tile and output columns (w>>2)*DW .. +DW-1 (DW = d /
// col_groups, all of d below 256); lane (g = lane/4, c = lane%4) holds
// rows g and g+8 of every mma fragment (PTX ISA m16n8k16 layouts), so
// the row statistics reduce over the 4 lanes of a group and the S
// accumulators are already P's A fragments. use_shift runs the
// constant-shift pass first and redoes the tile online only when a row's
// sum left [SUM_LO, SUM_HI].

// The shift pass's row sum is kept when it lies in [2^-64, 2^64]: every
// weight that matters is then a normal float and P V cannot overflow.
constexpr float SUM_LO = 0x1p-64f, SUM_HI = 0x1p64f;

__device__ __forceinline__ bool bad_sum(float l) {
  return !(l >= SUM_LO && l <= SUM_HI);  // also inf, 0 and NaN
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS * col_groups<D>())
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ out,
               float* __restrict__ lse, int64_t sq, int64_t sk, int causal,
               float scale_log2, int use_shift, float shift) {
  constexpr int CG = col_groups<D>(), NT = MMA_THREADS * CG;
  constexpr int DW = D / CG;   // output columns a warp
  constexpr int KS = D + 8;    // K tile row stride (bf16), 16-byte aligned
  constexpr int VS = BN + 8;   // V^T tile row stride
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vt = ks + BN * KS;
  const int64_t bh = blockIdx.y;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const bf16* qb = q + bh * sq * D;
  const bf16* kb = k + bh * sk * D;
  const bf16* vb = v + bh * sk * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int cb = (warp >> 2) * DW;  // this warp's first output column
  const int64_t r0 = m0 + (warp & 3) * 16 + g, r1 = r0 + 8;

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    const int col = c * 16 + c2;
    qa[c][0] = r0 < sq ? ld32(qb + r0 * D + col) : 0u;
    qa[c][1] = r1 < sq ? ld32(qb + r1 * D + col) : 0u;
    qa[c][2] = r0 < sq ? ld32(qb + r0 * D + col + 8) : 0u;
    qa[c][3] = r1 < sq ? ld32(qb + r1 * D + col + 8) : 0u;
  }
  float o[DW / 8][4];
  float mx0, mx1, l0, l1;
  const int64_t n_end = causal && m0 + BM < sk ? m0 + BM : sk;
  for (int pass = use_shift ? 0 : 1; pass < 2; ++pass) {
    const bool online = pass == 1;
#pragma unroll
    for (int n = 0; n < DW / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    mx0 = mx1 = online ? -INFINITY : shift;
    l0 = l1 = 0.f;
    for (int64_t n0 = 0; n0 < n_end; n0 += BN) {
      __syncthreads();  // the previous tile is consumed
      for (int i = threadIdx.x; i < BN * D / 8; i += NT) {
        const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
        uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
        if (n0 + r < sk) {
          kv = *reinterpret_cast<const uint4*>(kb + (n0 + r) * D + c8);
          vv = *reinterpret_cast<const uint4*>(vb + (n0 + r) * D + c8);
        }
        *reinterpret_cast<uint4*>(ks + r * KS + c8) = kv;
        const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
        for (int e = 0; e < 8; ++e) vt[(c8 + e) * VS + r] = ve[e];
      }
      __syncthreads();

      float s[BN / 8][4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          const bf16* kp = ks + (j * 8 + g) * KS + c * 16 + c2;
          mma_bf16(s[j], qa[c], ld32(kp), ld32(kp + 8));
        }
      }
      float tm0 = NEG_INF, tm1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t key = n0 + j * 8 + c2 + (e & 1);
          const int64_t row = e < 2 ? r0 : r1;
          float val = s[j][e] * scale_log2;
          if (key >= sk || (causal && key > row)) val = NEG_INF;
          s[j][e] = val;
        }
        tm0 = fmaxf(tm0, fmaxf(s[j][0], s[j][1]));
        tm1 = fmaxf(tm1, fmaxf(s[j][2], s[j][3]));
      }
      float mn0 = shift, mn1 = shift, al0 = 1.f, al1 = 1.f;
      if (online) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, off));
          tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, off));
        }
        mn0 = fmaxf(mx0, tm0);
        mn1 = fmaxf(mx1, tm1);
        al0 = exp2f(mx0 - mn0);
        al1 = exp2f(mx1 - mn1);
      }
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        s[j][0] = exp2f(s[j][0] - mn0);
        s[j][1] = exp2f(s[j][1] - mn0);
        s[j][2] = exp2f(s[j][2] - mn1);
        s[j][3] = exp2f(s[j][3] - mn1);
        rs0 += s[j][0] + s[j][1];
        rs1 += s[j][2] + s[j][3];
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
      if (online) {
#pragma unroll
        for (int n = 0; n < DW / 8; ++n) {
          o[n][0] *= al0;
          o[n][1] *= al0;
          o[n][2] *= al1;
          o[n][3] *= al1;
        }
      }
#pragma unroll
      for (int c = 0; c < BN / 16; ++c) {
        const uint32_t pa[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                                pack_bf16(s[2 * c][2], s[2 * c][3]),
                                pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                                pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
        for (int n = 0; n < DW / 8; ++n) {
          const bf16* vp = vt + (cb + n * 8 + g) * VS + c * 16 + c2;
          mma_bf16(o[n], pa, ld32(vp), ld32(vp + 8));
        }
      }
    }
    if (!online) {
      const bool bad = (r0 < sq && bad_sum(l0)) || (r1 < sq && bad_sum(l1));
      if (!__syncthreads_or(bad)) break;  // every row of the tile is final
    }
  }
  bf16* ob = out + bh * sq * D;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int n = 0; n < DW / 8; ++n) {
    const int col = cb + n * 8 + c2;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * D + col) =
          pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * D + col) =
          pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
  if ((lane & 3) == 0 && cb == 0) {
    if (r0 < sq) lse[bh * sq + r0] = mx0 * LN2 + logf(l0);
    if (r1 < sq) lse[bh * sq + r1] = mx1 * LN2 + logf(l1);
  }
}

// ---------------------------------------------------------------------------
// flash_fwd, float32 with plain FMA (the card's float32 checks). Thread
// (r = tid/4, c = tid%4) owns row r of the tile: keys c, c+4, ... of each
// score tile and output dims c, c+4, ... (interleaved so the four lanes
// of a row read four banks).

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int64_t sq, int64_t sk, int causal,
              float scale_log2, int use_shift, float shift) {
  constexpr int QS = D + 1, PS = BN + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + BM * QS;
  float* vs = ks + BN * QS;
  float* ps = vs + BN * D;
  const int64_t bh = blockIdx.y;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const float* qb = q + bh * sq * D;
  const float* kb = k + bh * sk * D;
  const float* vb = v + bh * sk * D;
  const int r = threadIdx.x >> 2, c = threadIdx.x & 3;
  const int64_t row = m0 + r;

  for (int i = threadIdx.x; i < BM * D; i += F32_THREADS) {
    const int rr = i / D, d = i % D;
    qs[rr * QS + d] = m0 + rr < sq ? qb[(m0 + rr) * D + d] : 0.f;
  }
  float o[D / 4];
  float mx, l;
  const int64_t n_end = causal && m0 + BM < sk ? m0 + BM : sk;
  for (int pass = use_shift ? 0 : 1; pass < 2; ++pass) {
    const bool online = pass == 1;
#pragma unroll
    for (int e = 0; e < D / 4; ++e) o[e] = 0.f;
    mx = online ? -INFINITY : shift;
    l = 0.f;
    for (int64_t n0 = 0; n0 < n_end; n0 += BN) {
      __syncthreads();
      for (int i = threadIdx.x; i < BN * D; i += F32_THREADS) {
        const int rr = i / D, d = i % D;
        const bool ok = n0 + rr < sk;
        ks[rr * QS + d] = ok ? kb[(n0 + rr) * D + d] : 0.f;
        vs[rr * D + d] = ok ? vb[(n0 + rr) * D + d] : 0.f;
      }
      __syncthreads();
      float s[BN / 4];
      float tm = NEG_INF;
#pragma unroll
      for (int i = 0; i < BN / 4; ++i) {
        const int j = c + 4 * i;
        float acc = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) acc += qs[r * QS + d] * ks[j * QS + d];
        const int64_t key = n0 + j;
        float val = acc * scale_log2;
        if (key >= sk || (causal && key > row)) val = NEG_INF;
        s[i] = val;
        tm = fmaxf(tm, val);
      }
      float mn = shift, al = 1.f;
      if (online) {
        tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
        tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 2));
        mn = fmaxf(mx, tm);
        al = exp2f(mx - mn);
      }
      float rs = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 4; ++i) {
        const float p = exp2f(s[i] - mn);
        rs += p;
        ps[r * PS + c + 4 * i] = p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l = l * al + rs;
      mx = mn;
      __syncwarp();  // a row's four threads are lanes of one warp
#pragma unroll
      for (int e = 0; e < D / 4; ++e) o[e] *= al;
      for (int j = 0; j < BN; ++j) {
        const float p = ps[r * PS + j];
#pragma unroll
        for (int e = 0; e < D / 4; ++e) o[e] += p * vs[j * D + e * 4 + c];
      }
    }
    if (!online) {
      const bool bad = row < sq && bad_sum(l);
      if (!__syncthreads_or(bad)) break;
    }
  }
  if (row < sq) {
    float* ob = out + bh * sq * D + row * D;
    const float inv = 1.f / l;
#pragma unroll
    for (int e = 0; e < D / 4; ++e) ob[e * 4 + c] = o[e] * inv;
    if (c == 0) lse[bh * sq + row] = mx * LN2 + logf(l);
  }
}

// ---------------------------------------------------------------------------
// flash_bwd, bf16 on the tensor cores. CTA (batch*head, 64-key tile);
// warp w owns keys (w&3)*16 .. +15 for S^T and dP^T, and columns
// (w>>2)*DW .. +DW-1 of those keys' dk and dv; for dq, Q rows (w&1)*16 ..
// +15 of each 32-row Q tile by a 2/warps share of the head dim. Shared
// memory: K, V (row-major) and K^T for the CTA's life; Q, dO,
// their transposes, dS ([q][key]) and the rows' lse*log2e and delta for
// each Q tile.

template <int D, bool DQ>
__global__ void __launch_bounds__(MMA_THREADS * col_groups<D>())
flash_bwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, bf16* __restrict__ dk,
               bf16* __restrict__ dv, int64_t sq, int64_t sk, int causal,
               float scale_log2, float scale) {
  constexpr int CG = col_groups<D>(), NT = MMA_THREADS * CG;
  constexpr int DW = D / CG;    // dk, dv columns a warp
  constexpr int DQW = D / (2 * CG);  // dq columns a warp
  constexpr int RS = D + 8;     // row-major tiles (K, V, Q, dO)
  constexpr int KTS = BN + 8;   // K^T
  constexpr int QTS = BQB + 8;  // Q^T, dO^T
  constexpr int DSS = BN + 8;   // dS [q][key]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + BN * RS;
  bf16* kt = vs + BN * RS;
  bf16* qs = kt + D * KTS;
  bf16* dos = qs + BQB * RS;
  bf16* qt = dos + BQB * RS;
  bf16* dot = qt + D * QTS;
  bf16* dss = dot + D * QTS;
  float* lse2s = reinterpret_cast<float*>(dss + BQB * DSS);
  float* dels = lse2s + BQB;
  const int64_t bh = blockIdx.y;
  const int64_t n0 = (int64_t)blockIdx.x * BN;
  const bf16* qb = q + bh * sq * D;
  const bf16* dob = dout + bh * sq * D;
  const bf16* kb = k + bh * sk * D;
  const bf16* vb = v + bh * sk * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int kr0 = (warp & 3) * 16 + g;  // this lane's keys: kr0, kr0 + 8
  const int cb = (warp >> 2) * DW;      // this warp's first dk/dv column

  for (int i = threadIdx.x; i < BN * D / 8; i += NT) {
    const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (n0 + r < sk) {
      kv = *reinterpret_cast<const uint4*>(kb + (n0 + r) * D + c8);
      vv = *reinterpret_cast<const uint4*>(vb + (n0 + r) * D + c8);
    }
    *reinterpret_cast<uint4*>(ks + r * RS + c8) = kv;
    *reinterpret_cast<uint4*>(vs + r * RS + c8) = vv;
    const bf16* ke = reinterpret_cast<const bf16*>(&kv);
#pragma unroll
    for (int e = 0; e < 8; ++e) kt[(c8 + e) * KTS + r] = ke[e];
  }
  float dka[DW / 8][4], dva[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int64_t m0 = causal ? n0 : 0; m0 < sq; m0 += BQB) {
    __syncthreads();  // the previous Q tile is consumed
    for (int i = threadIdx.x; i < BQB * D / 8; i += NT) {
      const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
      uint4 qv = make_uint4(0, 0, 0, 0), ov = make_uint4(0, 0, 0, 0);
      if (m0 + r < sq) {
        qv = *reinterpret_cast<const uint4*>(qb + (m0 + r) * D + c8);
        ov = *reinterpret_cast<const uint4*>(dob + (m0 + r) * D + c8);
      }
      *reinterpret_cast<uint4*>(qs + r * RS + c8) = qv;
      *reinterpret_cast<uint4*>(dos + r * RS + c8) = ov;
      const bf16* qe = reinterpret_cast<const bf16*>(&qv);
      const bf16* oe = reinterpret_cast<const bf16*>(&ov);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        qt[(c8 + e) * QTS + r] = qe[e];
        dot[(c8 + e) * QTS + r] = oe[e];
      }
    }
    if (threadIdx.x < BQB) {
      const int64_t row = m0 + threadIdx.x;
      lse2s[threadIdx.x] = row < sq ? lse[bh * sq + row] * LOG2E : 0.f;
      dels[threadIdx.x] = row < sq ? delta[bh * sq + row] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 32 rows
    float st[BQB / 8][4], dpt[BQB / 8][4];
#pragma unroll
    for (int j = 0; j < BQB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const bf16* kp = ks + kr0 * RS + c * 16 + c2;
      const bf16* vp = vs + kr0 * RS + c * 16 + c2;
      const uint32_t ka[4] = {ld32(kp), ld32(kp + 8 * RS), ld32(kp + 8),
                              ld32(kp + 8 * RS + 8)};
      const uint32_t va[4] = {ld32(vp), ld32(vp + 8 * RS), ld32(vp + 8),
                              ld32(vp + 8 * RS + 8)};
#pragma unroll
      for (int j = 0; j < BQB / 8; ++j) {
        const bf16* qp = qs + (j * 8 + g) * RS + c * 16 + c2;
        const bf16* op = dos + (j * 8 + g) * RS + c * 16 + c2;
        mma_bf16(st[j], ka, ld32(qp), ld32(qp + 8));
        mma_bf16(dpt[j], va, ld32(op), ld32(op + 8));
      }
    }
    // P^T and dS^T in place
#pragma unroll
    for (int j = 0; j < BQB / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = j * 8 + c2 + (e & 1);
        const int64_t key = n0 + kr0 + (e >> 1) * 8;
        const int64_t row = m0 + ql;
        float p = exp2f(st[j][e] * scale_log2 - lse2s[ql]);
        if (key >= sk || row >= sq || (causal && key > row)) p = 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - dels[ql]) * scale;
      }
    }
    // dv += P^T dO and dk += dS^T Q (P and dS rounded to bf16)
#pragma unroll
    for (int cc = 0; cc < BQB / 16; ++cc) {
      const uint32_t pa[4] = {pack_bf16(st[2 * cc][0], st[2 * cc][1]),
                              pack_bf16(st[2 * cc][2], st[2 * cc][3]),
                              pack_bf16(st[2 * cc + 1][0], st[2 * cc + 1][1]),
                              pack_bf16(st[2 * cc + 1][2], st[2 * cc + 1][3])};
      const uint32_t sa[4] = {pack_bf16(dpt[2 * cc][0], dpt[2 * cc][1]),
                              pack_bf16(dpt[2 * cc][2], dpt[2 * cc][3]),
                              pack_bf16(dpt[2 * cc + 1][0], dpt[2 * cc + 1][1]),
                              pack_bf16(dpt[2 * cc + 1][2], dpt[2 * cc + 1][3])};
#pragma unroll
      for (int n = 0; n < DW / 8; ++n) {
        const bf16* bo = dot + (cb + n * 8 + g) * QTS + cc * 16 + c2;
        const bf16* bq = qt + (cb + n * 8 + g) * QTS + cc * 16 + c2;
        mma_bf16(dva[n], pa, ld32(bo), ld32(bo + 8));
        mma_bf16(dka[n], sa, ld32(bq), ld32(bq + 8));
      }
    }
    if constexpr (DQ) {
    // dS into shared memory as [q][key], rounded to bf16 (one warp of
    // each column group writes it)
    if (cb == 0) {
#pragma unroll
      for (int j = 0; j < BQB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dss[(j * 8 + c2 + (e & 1)) * DSS + kr0 + (e >> 1) * 8] =
              __float2bfloat16_rn(dpt[j][e]);
    }
    __syncthreads();
    // dq += dS K: Q rows qr, qr + 8 and DQW columns of the head dim a warp
    {
      const int qr = (warp & 1) * 16 + g;
      const int dbase = (warp >> 1) * DQW;
      float acc[DQW / 8][4];
#pragma unroll
      for (int n = 0; n < DQW / 8; ++n)
        acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int c = 0; c < BN / 16; ++c) {
        const bf16* ap = dss + qr * DSS + c * 16 + c2;
        const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * DSS), ld32(ap + 8),
                               ld32(ap + 8 * DSS + 8)};
#pragma unroll
        for (int n = 0; n < DQW / 8; ++n) {
          const bf16* bp = kt + (dbase + n * 8 + g) * KTS + c * 16 + c2;
          mma_bf16(acc[n], a, ld32(bp), ld32(bp + 8));
        }
      }
      const int64_t row0 = m0 + qr, row1 = row0 + 8;
#pragma unroll
      for (int n = 0; n < DQW / 8; ++n) {
        const int col = dbase + n * 8 + c2;
        if (row0 < sq) {
          float* p = dq + (bh * sq + row0) * D + col;
          atomicAdd(p, acc[n][0]);
          atomicAdd(p + 1, acc[n][1]);
        }
        if (row1 < sq) {
          float* p = dq + (bh * sq + row1) * D + col;
          atomicAdd(p, acc[n][2]);
          atomicAdd(p + 1, acc[n][3]);
        }
      }
    }
    }  // DQ
  }
  const int64_t key0 = n0 + kr0, key1 = key0 + 8;
#pragma unroll
  for (int n = 0; n < DW / 8; ++n) {
    const int col = cb + n * 8 + c2;
    if (key0 < sk) {
      *reinterpret_cast<uint32_t*>(dk + (bh * sk + key0) * D + col) =
          pack_bf16(dka[n][0], dka[n][1]);
      *reinterpret_cast<uint32_t*>(dv + (bh * sk + key0) * D + col) =
          pack_bf16(dva[n][0], dva[n][1]);
    }
    if (key1 < sk) {
      *reinterpret_cast<uint32_t*>(dk + (bh * sk + key1) * D + col) =
          pack_bf16(dka[n][2], dka[n][3]);
      *reinterpret_cast<uint32_t*>(dv + (bh * sk + key1) * D + col) =
          pack_bf16(dva[n][2], dva[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// flash_bwd, float32 with plain FMA. CTA (batch*head, 64-key tile);
// thread (kr = tid/4, c = tid%4) owns key kr: entries (kr, c + 4i) of
// each P/dS tile and head dims c, c+4, ... of dk and dv; for dq, thread
// (tid/8, tid%8) owns one Q row of the tile and head dims tid%8 + 8i.

template <int D, bool DQ>
__global__ void __launch_bounds__(F32_THREADS)
flash_bwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, float* __restrict__ dk,
              float* __restrict__ dv, int64_t sq, int64_t sk, int causal,
              float scale_log2, float scale) {
  constexpr int RS = D + 1, PS = BQB + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + BN * RS;
  float* qs = vs + BN * RS;
  float* dos = qs + BQB * RS;
  float* ps = dos + BQB * RS;
  float* dss = ps + BN * PS;
  float* lse2s = dss + BN * PS;
  float* dels = lse2s + BQB;
  const int64_t bh = blockIdx.y;
  const int64_t n0 = (int64_t)blockIdx.x * BN;
  const float* qb = q + bh * sq * D;
  const float* dob = dout + bh * sq * D;
  const float* kb = k + bh * sk * D;
  const float* vb = v + bh * sk * D;
  const int kr = threadIdx.x >> 2, c = threadIdx.x & 3;
  const int64_t key = n0 + kr;

  for (int i = threadIdx.x; i < BN * D; i += F32_THREADS) {
    const int r = i / D, d = i % D;
    const bool ok = n0 + r < sk;
    ks[r * RS + d] = ok ? kb[(n0 + r) * D + d] : 0.f;
    vs[r * RS + d] = ok ? vb[(n0 + r) * D + d] : 0.f;
  }
  float dka[D / 4], dva[D / 4];
#pragma unroll
  for (int e = 0; e < D / 4; ++e) dka[e] = dva[e] = 0.f;

  for (int64_t m0 = causal ? n0 : 0; m0 < sq; m0 += BQB) {
    __syncthreads();
    for (int i = threadIdx.x; i < BQB * D; i += F32_THREADS) {
      const int r = i / D, d = i % D;
      const bool ok = m0 + r < sq;
      qs[r * RS + d] = ok ? qb[(m0 + r) * D + d] : 0.f;
      dos[r * RS + d] = ok ? dob[(m0 + r) * D + d] : 0.f;
    }
    if (threadIdx.x < BQB) {
      const int64_t row = m0 + threadIdx.x;
      lse2s[threadIdx.x] = row < sq ? lse[bh * sq + row] * LOG2E : 0.f;
      dels[threadIdx.x] = row < sq ? delta[bh * sq + row] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < BQB / 4; ++i) {
      const int ql = c + 4 * i;
      const int64_t row = m0 + ql;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        s += ks[kr * RS + d] * qs[ql * RS + d];
        dp += vs[kr * RS + d] * dos[ql * RS + d];
      }
      float p = exp2f(s * scale_log2 - lse2s[ql]);
      if (key >= sk || row >= sq || (causal && key > row)) p = 0.f;
      ps[kr * PS + ql] = p;
      dss[kr * PS + ql] = p * (dp - dels[ql]) * scale;
    }
    __syncthreads();
    for (int ql = 0; ql < BQB; ++ql) {
      const float p = ps[kr * PS + ql], ds = dss[kr * PS + ql];
#pragma unroll
      for (int e = 0; e < D / 4; ++e) {
        dva[e] += p * dos[ql * RS + e * 4 + c];
        dka[e] += ds * qs[ql * RS + e * 4 + c];
      }
    }
    if constexpr (DQ) {
      const int qq = threadIdx.x >> 3, cq = threadIdx.x & 7;
      const int64_t row = m0 + qq;
#pragma unroll
      for (int e = 0; e < D / 8; ++e) {
        const int d = cq + 8 * e;
        float acc = 0.f;
        for (int j = 0; j < BN; ++j) acc += dss[j * PS + qq] * ks[j * RS + d];
        if (row < sq) atomicAdd(dq + (bh * sq + row) * D + d, acc);
      }
    }
  }
  if (key < sk) {
#pragma unroll
    for (int e = 0; e < D / 4; ++e) {
      dk[(bh * sk + key) * D + e * 4 + c] = dka[e];
      dv[(bh * sk + key) * D + e * 4 + c] = dva[e];
    }
  }
}

// ---------------------------------------------------------------------------
// flash_bwd_dq, bf16 on the tensor cores. CTA (batch*head, 64-row Q tile);
// warp w owns Q rows (w&3)*16 .. +15 and dq columns (w>>2)*DW .. +DW-1,
// as in flash_fwd: its Q and dO fragments stay in registers (in shared
// memory at d = 256), and lane (g, c) holds rows g and g+8 of every S,
// dP and dq fragment. Per 64-key tile, in two halves of 32 keys:
// S = Q K^T and dP = dO V^T (K and V row-major in shared memory), dS
// rounded to bf16 is the A fragment of dq += dS K (K^T in shared memory).

template <int D>
__global__ void __launch_bounds__(MMA_THREADS * col_groups<D>())
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int64_t sq, int64_t sk, int causal, float scale_log2,
                  float scale) {
  constexpr int CG = col_groups<D>(), NT = MMA_THREADS * CG;
  constexpr int DW = D / CG;   // dq columns a warp
  // two column groups: the Q and dO fragments of all of d would take
  // 128 registers beside dq's, so they stay in shared memory
  constexpr bool QSMEM = CG > 1;
  constexpr int RS = D + 8;    // K, V, Q, dO tiles (row-major)
  constexpr int KTS = BN + 8;  // K^T tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + BN * RS;
  bf16* kt = vs + BN * RS;
  bf16* qsm = kt + D * KTS;    // QSMEM only
  bf16* osm = qsm + BM * RS;
  const int64_t bh = blockIdx.y;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const bf16* qb = q + bh * sq * D;
  const bf16* ob = dout + bh * sq * D;
  const bf16* kb = k + bh * sk * D;
  const bf16* vb = v + bh * sk * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int rl = (warp & 3) * 16 + g;  // this lane's tile rows: rl, rl + 8
  const int cb = (warp >> 2) * DW;     // this warp's first dq column
  const int64_t r0 = m0 + rl, r1 = r0 + 8;

  uint32_t qa[QSMEM ? 1 : D / 16][4], oa[QSMEM ? 1 : D / 16][4];
  if constexpr (QSMEM) {
    for (int i = threadIdx.x; i < BM * D / 8; i += NT) {
      const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
      uint4 qv = make_uint4(0, 0, 0, 0), ov = make_uint4(0, 0, 0, 0);
      if (m0 + r < sq) {
        qv = *reinterpret_cast<const uint4*>(qb + (m0 + r) * D + c8);
        ov = *reinterpret_cast<const uint4*>(ob + (m0 + r) * D + c8);
      }
      *reinterpret_cast<uint4*>(qsm + r * RS + c8) = qv;
      *reinterpret_cast<uint4*>(osm + r * RS + c8) = ov;
    }
  } else {
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const int col = c * 16 + c2;
      qa[c][0] = r0 < sq ? ld32(qb + r0 * D + col) : 0u;
      qa[c][1] = r1 < sq ? ld32(qb + r1 * D + col) : 0u;
      qa[c][2] = r0 < sq ? ld32(qb + r0 * D + col + 8) : 0u;
      qa[c][3] = r1 < sq ? ld32(qb + r1 * D + col + 8) : 0u;
      oa[c][0] = r0 < sq ? ld32(ob + r0 * D + col) : 0u;
      oa[c][1] = r1 < sq ? ld32(ob + r1 * D + col) : 0u;
      oa[c][2] = r0 < sq ? ld32(ob + r0 * D + col + 8) : 0u;
      oa[c][3] = r1 < sq ? ld32(ob + r1 * D + col + 8) : 0u;
    }
  }
  const float l2_0 = r0 < sq ? lse[bh * sq + r0] * LOG2E : 0.f;
  const float l2_1 = r1 < sq ? lse[bh * sq + r1] * LOG2E : 0.f;
  const float de0 = r0 < sq ? delta[bh * sq + r0] : 0.f;
  const float de1 = r1 < sq ? delta[bh * sq + r1] : 0.f;
  float dqa[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  const int64_t n_end = causal && m0 + BM < sk ? m0 + BM : sk;
  for (int64_t n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < BN * D / 8; i += NT) {
      const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (n0 + r < sk) {
        kv = *reinterpret_cast<const uint4*>(kb + (n0 + r) * D + c8);
        vv = *reinterpret_cast<const uint4*>(vb + (n0 + r) * D + c8);
      }
      *reinterpret_cast<uint4*>(ks + r * RS + c8) = kv;
      *reinterpret_cast<uint4*>(vs + r * RS + c8) = vv;
      const bf16* ke = reinterpret_cast<const bf16*>(&kv);
#pragma unroll
      for (int e = 0; e < 8; ++e) kt[(c8 + e) * KTS + r] = ke[e];
    }
    __syncthreads();

#pragma unroll
    for (int half = 0; half < BN / 32; ++half) {
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          const int kr = half * 32 + j * 8 + g;
          const bf16* kp = ks + kr * RS + c * 16 + c2;
          const bf16* vp = vs + kr * RS + c * 16 + c2;
          if constexpr (QSMEM) {
            const bf16* qp = qsm + rl * RS + c * 16 + c2;
            const bf16* op = osm + rl * RS + c * 16 + c2;
            const uint32_t a[4] = {ld32(qp), ld32(qp + 8 * RS), ld32(qp + 8),
                                   ld32(qp + 8 * RS + 8)};
            const uint32_t o4[4] = {ld32(op), ld32(op + 8 * RS),
                                    ld32(op + 8), ld32(op + 8 * RS + 8)};
            mma_bf16(s[j], a, ld32(kp), ld32(kp + 8));
            mma_bf16(dp[j], o4, ld32(vp), ld32(vp + 8));
          } else {
            mma_bf16(s[j], qa[c], ld32(kp), ld32(kp + 8));
            mma_bf16(dp[j], oa[c], ld32(vp), ld32(vp + 8));
          }
        }
      }
      // P, then dS in place of S
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t key = n0 + half * 32 + j * 8 + c2 + (e & 1);
          const int64_t row = e < 2 ? r0 : r1;
          float p = exp2f(s[j][e] * scale_log2 - (e < 2 ? l2_0 : l2_1));
          if (key >= sk || row >= sq || (causal && key > row)) p = 0.f;
          s[j][e] = p * (dp[j][e] - (e < 2 ? de0 : de1)) * scale;
        }
      }
      // dq += dS K (dS rounded to bf16)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const uint32_t a[4] = {pack_bf16(s[2 * cc][0], s[2 * cc][1]),
                               pack_bf16(s[2 * cc][2], s[2 * cc][3]),
                               pack_bf16(s[2 * cc + 1][0], s[2 * cc + 1][1]),
                               pack_bf16(s[2 * cc + 1][2], s[2 * cc + 1][3])};
#pragma unroll
        for (int n = 0; n < DW / 8; ++n) {
          const bf16* bp =
              kt + (cb + n * 8 + g) * KTS + half * 32 + cc * 16 + c2;
          mma_bf16(dqa[n], a, ld32(bp), ld32(bp + 8));
        }
      }
    }
  }
  bf16* dqb = dq + bh * sq * D;
#pragma unroll
  for (int n = 0; n < DW / 8; ++n) {
    const int col = cb + n * 8 + c2;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(dqb + r0 * D + col) =
          pack_bf16(dqa[n][0], dqa[n][1]);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(dqb + r1 * D + col) =
          pack_bf16(dqa[n][2], dqa[n][3]);
  }
}

// ---------------------------------------------------------------------------
// flash_bwd_dq, float32 with plain FMA. Thread (r = tid/4, c = tid%4) owns
// Q row r of the tile: keys c, c+4, ... of each S/dP tile and head dims
// c, c+4, ... of dq, as in flash_fwd_f32; dS goes through shared memory.

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int64_t sq, int64_t sk, int causal, float scale_log2,
                 float scale) {
  // at d = 256 a 64-key tile of K and V would not fit beside Q and dO
  constexpr int BNK = D > 128 ? 32 : BN;  // keys a tile
  constexpr int QS = D + 1, PS = BNK + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + BM * QS;
  float* ks = dos + BM * QS;
  float* vs = ks + BNK * QS;
  float* ps = vs + BNK * QS;
  const int64_t bh = blockIdx.y;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const float* qb = q + bh * sq * D;
  const float* ob = dout + bh * sq * D;
  const float* kb = k + bh * sk * D;
  const float* vb = v + bh * sk * D;
  const int r = threadIdx.x >> 2, c = threadIdx.x & 3;
  const int64_t row = m0 + r;

  for (int i = threadIdx.x; i < BM * D; i += F32_THREADS) {
    const int rr = i / D, d = i % D;
    const bool ok = m0 + rr < sq;
    qs[rr * QS + d] = ok ? qb[(m0 + rr) * D + d] : 0.f;
    dos[rr * QS + d] = ok ? ob[(m0 + rr) * D + d] : 0.f;
  }
  const float l2 = row < sq ? lse[bh * sq + row] * LOG2E : 0.f;
  const float de = row < sq ? delta[bh * sq + row] : 0.f;
  float dqa[D / 4];
#pragma unroll
  for (int e = 0; e < D / 4; ++e) dqa[e] = 0.f;
  const int64_t n_end = causal && m0 + BM < sk ? m0 + BM : sk;
  for (int64_t n0 = 0; n0 < n_end; n0 += BNK) {
    __syncthreads();
    for (int i = threadIdx.x; i < BNK * D; i += F32_THREADS) {
      const int rr = i / D, d = i % D;
      const bool ok = n0 + rr < sk;
      ks[rr * QS + d] = ok ? kb[(n0 + rr) * D + d] : 0.f;
      vs[rr * QS + d] = ok ? vb[(n0 + rr) * D + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < BNK / 4; ++i) {
      const int j = c + 4 * i;
      float sv = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        sv += qs[r * QS + d] * ks[j * QS + d];
        dp += dos[r * QS + d] * vs[j * QS + d];
      }
      const int64_t key = n0 + j;
      float p = exp2f(sv * scale_log2 - l2);
      if (key >= sk || row >= sq || (causal && key > row)) p = 0.f;
      ps[r * PS + j] = p * (dp - de) * scale;
    }
    __syncwarp();  // a row's four threads are lanes of one warp
    for (int j = 0; j < BNK; ++j) {
      const float ds = ps[r * PS + j];
#pragma unroll
      for (int e = 0; e < D / 4; ++e) dqa[e] += ds * ks[j * QS + e * 4 + c];
    }
  }
  if (row < sq) {
    float* dqb = dq + (bh * sq + row) * D;
#pragma unroll
    for (int e = 0; e < D / 4; ++e) dqb[e * 4 + c] = dqa[e];
  }
}

// ---------------------------------------------------------------------------
// decode_step. Lane l of each warp holds elements [l*DEC_EPL,
// (l+1)*DEC_EPL) of each DEC_CW-wide chunk of a row.

template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, float (&x)[N]) {
  constexpr int BYTES = N * (int)sizeof(T);
  static_assert(BYTES % 8 == 0, "row slice must be 8-byte sized");
  if constexpr (BYTES % 16 == 0) {
    uint4 buf[BYTES / 16];
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) buf[i] = reinterpret_cast<const uint4*>(p)[i];
    const T* e = reinterpret_cast<const T*>(buf);
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = to_f(e[j]);
  } else {
    uint2 buf[BYTES / 8];
#pragma unroll
    for (int i = 0; i < BYTES / 8; ++i) buf[i] = reinterpret_cast<const uint2*>(p)[i];
    const T* e = reinterpret_cast<const T*>(buf);
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = to_f(e[j]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Block-wide reduction through red[DEC_WARPS]; every thread gets the result.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  x = MAX ? warp_max(x) : warp_sum(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float y = red[0];
  for (int w = 1; w < DEC_WARPS; ++w) y = MAX ? fmaxf(y, red[w]) : y + red[w];
  __syncthreads();
  return y;
}

template <typename T>
__global__ void __launch_bounds__(DEC_THREADS)
decode_step_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ cos2,
                   const float* __restrict__ sin2, T* kc, T* vc,
                   T* __restrict__ out, int64_t total, int dh, int64_t cur,
                   int rope, float scale) {
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                  // rotated q (input-dtype values)
  float* kn = qs + dh;              // rotated k
  float* part = kn + dh;            // DEC_WARPS x dh partial sums
  float* red = part + DEC_WARPS * dh;
  float* w = red + DEC_WARPS;       // cur + 1 logits, then weights
  const int64_t rowi = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nch = dh / DEC_CW;
  const T* qr = q + rowi * dh;
  const T* kr = k + rowi * dh;
  const T* vr = v + rowi * dh;
  T* kcr = kc + rowi * total * dh;
  T* vcr = vc + rowi * total * dh;

  for (int d = threadIdx.x; d < dh; d += DEC_THREADS) {
    float qd = to_f(qr[d]), kd = to_f(kr[d]);
    if (rope) {
      // x * cos2 + rot * sin2, rot = [-x2, x1], the first product fused
      const int h = dh / 2;
      const float c = cos2[d], s = sin2[d];
      const float qr_ = d < h ? -to_f(qr[d + h]) : to_f(qr[d - h]);
      const float kr_ = d < h ? -to_f(kr[d + h]) : to_f(kr[d - h]);
      qd = __fmaf_rn(qd, c, __fmul_rn(qr_, s));
      kd = __fmaf_rn(kd, c, __fmul_rn(kr_, s));
    }
    const T kt = from_f<T>(kd);
    qs[d] = to_f(from_f<T>(qd));
    kn[d] = to_f(kt);
    kcr[cur * dh + d] = kt;            // the cache column, in place
    vcr[cur * dh + d] = vr[d];
  }
  __syncthreads();

  for (int64_t t = warp; t < cur; t += DEC_WARPS) {
    float acc = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      const int d0 = ch * DEC_CW + lane * DEC_EPL;
      float kx[DEC_EPL];
      load_row<T, DEC_EPL>(kcr + t * dh + d0, kx);
#pragma unroll
      for (int e = 0; e < DEC_EPL; ++e) acc += qs[d0 + e] * kx[e];
    }
    acc = warp_sum(acc);
    if (lane == 0) w[t] = acc * scale;
  }
  if (warp == 0) {
    float acc = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      const int d0 = ch * DEC_CW + lane * DEC_EPL;
#pragma unroll
      for (int e = 0; e < DEC_EPL; ++e) acc += qs[d0 + e] * kn[d0 + e];
    }
    acc = warp_sum(acc);
    if (lane == 0) w[cur] = acc * scale;
  }
  __syncthreads();

  float m = NEG_INF;
  for (int64_t t = threadIdx.x; t <= cur; t += DEC_THREADS) m = fmaxf(m, w[t]);
  m = block_reduce<true>(m, red);
  float l = 0.f;
  for (int64_t t = threadIdx.x; t <= cur; t += DEC_THREADS) {
    const float e = expf(w[t] - m);
    w[t] = e;
    l += e;
  }
  l = block_reduce<false>(l, red);  // its barrier publishes w[]

  for (int ch = 0; ch < nch; ++ch) {
    const int d0 = ch * DEC_CW + lane * DEC_EPL;
    float acc[DEC_EPL];
#pragma unroll
    for (int e = 0; e < DEC_EPL; ++e) acc[e] = 0.f;
    for (int64_t t = warp; t < cur; t += DEC_WARPS) {
      const float wt = to_f(from_f<T>(w[t]));
      float vx[DEC_EPL];
      load_row<T, DEC_EPL>(vcr + t * dh + d0, vx);
#pragma unroll
      for (int e = 0; e < DEC_EPL; ++e) acc[e] += wt * vx[e];
    }
#pragma unroll
    for (int e = 0; e < DEC_EPL; ++e) part[warp * dh + d0 + e] = acc[e];
  }
  __syncthreads();
  const float w_cur = w[cur];
  for (int d = threadIdx.x; d < dh; d += DEC_THREADS) {
    float sum = 0.f;
    for (int ww = 0; ww < DEC_WARPS; ++ww) sum += part[ww * dh + d];
    sum += w_cur * to_f(vr[d]);
    out[rowi * dh + d] = from_f<T>(sum / l);
  }
}

// ---------------------------------------------------------------------------
// decode_step_q8: decode_step over int8 caches, for one (batch*head) row a
// CTA, with the chunked row walk above (four int8 a lane a chunk, one
// 128-byte segment a warp a row). q arrives rotated and the fresh column
// quantized (kq, vq) and dequantized (kdq, vdq); the scale rows arrive
// holding the fresh column's scale at cur.

__device__ __forceinline__ void load_i8x4(const int8_t* p, float (&x)[4]) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  x[0] = (float)c.x;
  x[1] = (float)c.y;
  x[2] = (float)c.z;
  x[3] = (float)c.w;
}

template <typename T>
__global__ void __launch_bounds__(DEC_THREADS)
decode_step_q8_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                      const int8_t* __restrict__ vq,
                      const float* __restrict__ kdq,
                      const float* __restrict__ vdq, int8_t* kc, int8_t* vc,
                      const float* __restrict__ ksc,
                      const float* __restrict__ vsc, float* __restrict__ out,
                      int64_t total, int dh, int64_t cur, float scale) {
  static_assert(DEC_EPL == 4, "load_i8x4 reads four int8 a lane");
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                  // q in float32
  float* kd = qs + dh;              // the fresh column, dequantized
  float* part = kd + dh;            // DEC_WARPS x dh partial sums
  float* red = part + DEC_WARPS * dh;
  float* w = red + DEC_WARPS;       // cur + 1 logits, then weights
  const int64_t rowi = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nch = dh / DEC_CW;
  int8_t* kcr = kc + rowi * total * dh;
  int8_t* vcr = vc + rowi * total * dh;
  const float* kscr = ksc + rowi * total;
  const float* vscr = vsc + rowi * total;

  for (int d = threadIdx.x; d < dh; d += DEC_THREADS) {
    qs[d] = to_f(q[rowi * dh + d]);
    kd[d] = kdq[rowi * dh + d];
    kcr[cur * dh + d] = kq[rowi * dh + d];  // the int8 column, in place
    vcr[cur * dh + d] = vq[rowi * dh + d];
  }
  __syncthreads();

  // logits: (q . k_t) * kscale_t * scale over t < cur, q . kdq at cur
  for (int64_t t = warp; t < cur; t += DEC_WARPS) {
    float acc = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      const int d0 = ch * DEC_CW + lane * DEC_EPL;
      float kx[DEC_EPL];
      load_i8x4(kcr + t * dh + d0, kx);
#pragma unroll
      for (int e = 0; e < DEC_EPL; ++e) acc += qs[d0 + e] * kx[e];
    }
    acc = warp_sum(acc);
    if (lane == 0) w[t] = acc * kscr[t] * scale;
  }
  if (warp == 0) {
    float acc = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      const int d0 = ch * DEC_CW + lane * DEC_EPL;
#pragma unroll
      for (int e = 0; e < DEC_EPL; ++e) acc += qs[d0 + e] * kd[d0 + e];
    }
    acc = warp_sum(acc);
    if (lane == 0) w[cur] = acc * scale;
  }
  __syncthreads();

  float m = NEG_INF;
  for (int64_t t = threadIdx.x; t <= cur; t += DEC_THREADS) m = fmaxf(m, w[t]);
  m = block_reduce<true>(m, red);
  float l = 0.f;
  for (int64_t t = threadIdx.x; t <= cur; t += DEC_THREADS) {
    const float e = expf(w[t] - m);
    w[t] = e;
    l += e;
  }
  l = block_reduce<false>(l, red);  // its barrier publishes w[]

  // values: the weights times V's column scale, then the int8 rows
  for (int ch = 0; ch < nch; ++ch) {
    const int d0 = ch * DEC_CW + lane * DEC_EPL;
    float acc[DEC_EPL];
#pragma unroll
    for (int e = 0; e < DEC_EPL; ++e) acc[e] = 0.f;
    for (int64_t t = warp; t < cur; t += DEC_WARPS) {
      const float wt = w[t] * vscr[t];
      float vx[DEC_EPL];
      load_i8x4(vcr + t * dh + d0, vx);
#pragma unroll
      for (int e = 0; e < DEC_EPL; ++e) acc[e] += wt * vx[e];
    }
#pragma unroll
    for (int e = 0; e < DEC_EPL; ++e) part[warp * dh + d0 + e] = acc[e];
  }
  __syncthreads();
  const float w_cur = w[cur];
  for (int d = threadIdx.x; d < dh; d += DEC_THREADS) {
    float sum = 0.f;
    for (int ww = 0; ww < DEC_WARPS; ++ww) sum += part[ww * dh + d];
    sum += w_cur * vdq[rowi * dh + d];
    out[rowi * dh + d] = sum / l;
  }
}

template <typename KernelT>
int set_smem(KernelT kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
int launch_flash(int dtype, const void* q, const void* k, const void* v,
                 void* out, float* lse, int64_t bh, int64_t sq, int64_t sk,
                 int causal, float scale_log2, int use_shift, float shift,
                 cudaStream_t st) {
  const dim3 grid((unsigned)((sq + BM - 1) / BM), (unsigned)bh);
  if (dtype == 1) {
    const size_t smem = sizeof(bf16) * (BN * (D + 8) + D * (BN + 8));
    int err = set_smem(flash_fwd_bf16<D>, smem);
    if (err) return err;
    flash_fwd_bf16<D><<<grid, MMA_THREADS * col_groups<D>(), smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, sq, sk,
        causal, scale_log2, use_shift, shift);
  } else if (dtype == 0) {
    const size_t smem =
        sizeof(float) * (BM * (D + 1) + BN * (D + 1) + BN * D + BM * (BN + 1));
    int err = set_smem(flash_fwd_f32<D>, smem);
    if (err) return err;
    flash_fwd_f32<D><<<grid, F32_THREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, sq, sk,
        causal, scale_log2, use_shift, shift);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// DQ: flash_bwd (dq summed into the zeroed float32 buffer by atomics);
// !DQ: flash_bwd_dkv (dk and dv only, dq may be null).
template <int D, bool DQ>
int launch_flash_bwd(int dtype, const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     float* dq, void* dk, void* dv, int64_t bh, int64_t sq,
                     int64_t sk, int causal, float scale_log2, float scale,
                     cudaStream_t st) {
  const dim3 grid((unsigned)((sk + BN - 1) / BN), (unsigned)bh);
  if (dtype == 1) {
    const size_t smem =
        sizeof(bf16) * (2 * BN * (D + 8) + D * (BN + 8) + 2 * BQB * (D + 8) +
                        2 * D * (BQB + 8) + BQB * (BN + 8)) +
        sizeof(float) * 2 * BQB;
    int err = set_smem(flash_bwd_bf16<D, DQ>, smem);
    if (err) return err;
    flash_bwd_bf16<D, DQ><<<grid, MMA_THREADS * col_groups<D>(), smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, dq, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk,
        causal, scale_log2, scale);
  } else if (dtype == 0) {
    const size_t smem = sizeof(float) * (2 * BN * (D + 1) + 2 * BQB * (D + 1) +
                                         2 * BN * (BQB + 1) + 2 * BQB);
    int err = set_smem(flash_bwd_f32<D, DQ>, smem);
    if (err) return err;
    flash_bwd_f32<D, DQ><<<grid, F32_THREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, dq, static_cast<float*>(dk), static_cast<float*>(dv), sq, sk,
        causal, scale_log2, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_flash_bwd_dq(int dtype, const void* q, const void* k,
                        const void* v, const void* dout, const float* lse,
                        const float* delta, void* dq, int64_t bh, int64_t sq,
                        int64_t sk, int causal, float scale_log2, float scale,
                        cudaStream_t st) {
  const dim3 grid((unsigned)((sq + BM - 1) / BM), (unsigned)bh);
  if (dtype == 1) {
    constexpr int CG = col_groups<D>();
    const size_t smem = sizeof(bf16) * (2 * BN * (D + 8) + D * (BN + 8) +
                                        (CG > 1 ? 2 * BM * (D + 8) : 0));
    int err = set_smem(flash_bwd_dq_bf16<D>, smem);
    if (err) return err;
    flash_bwd_dq_bf16<D><<<grid, MMA_THREADS * CG, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, static_cast<bf16*>(dq), sq, sk, causal, scale_log2, scale);
  } else if (dtype == 0) {
    constexpr int BNK = D > 128 ? 32 : BN;  // the kernel's key tile
    const size_t smem =
        sizeof(float) * (2 * BM * (D + 1) + 2 * BNK * (D + 1) + BM * (BNK + 1));
    int err = set_smem(flash_bwd_dq_f32<D>, smem);
    if (err) return err;
    flash_bwd_dq_f32<D><<<grid, F32_THREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), sq, sk, causal, scale_log2, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

size_t decode_smem(int dh, int64_t cur) {
  return sizeof(float) *
         (2 * (size_t)dh + DEC_WARPS * (size_t)dh + DEC_WARPS + cur + 1);
}

template <typename T>
int launch_decode(const void* q, const void* k, const void* v,
                  const float* cos2, const float* sin2, void* kc, void* vc,
                  void* out, int64_t rows, int64_t total, int dh, int64_t cur,
                  int rope, float scale, cudaStream_t st) {
  const size_t smem = decode_smem(dh, cur);
  int err = set_smem(decode_step_kernel<T>, smem);
  if (err) return err;
  decode_step_kernel<T><<<(unsigned)rows, DEC_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cos2, sin2, static_cast<T*>(kc),
      static_cast<T*>(vc), static_cast<T*>(out), total, dh, cur, rope, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_decode_q8(const void* q, const int8_t* kq, const int8_t* vq,
                     const float* kdq, const float* vdq, int8_t* kc,
                     int8_t* vc, const float* ksc, const float* vsc,
                     float* out, int64_t rows, int64_t total, int dh,
                     int64_t cur, float scale, cudaStream_t st) {
  const size_t smem = decode_smem(dh, cur);
  int err = set_smem(decode_step_q8_kernel<T>, smem);
  if (err) return err;
  decode_step_q8_kernel<T><<<(unsigned)rows, DEC_THREADS, smem, st>>>(
      static_cast<const T*>(q), kq, vq, kdq, vdq, kc, vc, ksc, vsc, out,
      total, dh, cur, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q (bh, sq, d), k and v (bh, sk, d),
// out (bh, sq, d), lse (bh, sq) float32. d: 32, 64, 128 or 256.
// use_shift: the constant-shift mode with base-2 shift `shift`.
int icikit_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                     void* out, float* lse, int64_t bh, int64_t sq, int64_t sk,
                     int d, int causal, float scale_log2, int use_shift,
                     float shift, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FWD(D)                                                            \
  launch_flash<D>(dtype, q, k, v, out, lse, bh, sq, sk, causal, scale_log2, \
                  use_shift, shift, st)
  if (d == 128) return FWD(128);
  if (d == 64) return FWD(64);
  if (d == 32) return FWD(32);
  if (d == 256) return FWD(256);
#undef FWD
  return (int)cudaErrorInvalidValue;
}

// dtype as above. q, dout (bh, sq, d), k, v, dk, dv (bh, sk, d) in dtype;
// lse, delta (bh, sq) float32; dq (bh, sq, d) float32, zeroed by the
// caller and summed into. d: 32, 64, 128 or 256.
int icikit_flash_bwd(int dtype, const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     float* dq, void* dk, void* dv, int64_t bh, int64_t sq,
                     int64_t sk, int d, int causal, float scale_log2,
                     float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BWD(D)                                                             \
  launch_flash_bwd<D, true>(dtype, q, k, v, dout, lse, delta, dq, dk, dv, bh, \
                            sq, sk, causal, scale_log2, scale, st)
  if (d == 128) return BWD(128);
  if (d == 64) return BWD(64);
  if (d == 32) return BWD(32);
  if (d == 256) return BWD(256);
#undef BWD
  return (int)cudaErrorInvalidValue;
}

// The two-pass backward. dq (bh, sq, d) in dtype, written once.
int icikit_flash_bwd_dq(int dtype, const void* q, const void* k,
                        const void* v, const void* dout, const float* lse,
                        const float* delta, void* dq, int64_t bh, int64_t sq,
                        int64_t sk, int d, int causal, float scale_log2,
                        float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BDQ(D)                                                           \
  launch_flash_bwd_dq<D>(dtype, q, k, v, dout, lse, delta, dq, bh, sq, sk, \
                         causal, scale_log2, scale, st)
  if (d == 128) return BDQ(128);
  if (d == 64) return BDQ(64);
  if (d == 32) return BDQ(32);
  if (d == 256) return BDQ(256);
#undef BDQ
  return (int)cudaErrorInvalidValue;
}

// dk, dv (bh, sk, d) in dtype, written once.
int icikit_flash_bwd_dkv(int dtype, const void* q, const void* k,
                         const void* v, const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, int64_t bh,
                         int64_t sq, int64_t sk, int d, int causal,
                         float scale_log2, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BKV(D)                                                              \
  launch_flash_bwd<D, false>(dtype, q, k, v, dout, lse, delta, nullptr, dk, \
                             dv, bh, sq, sk, causal, scale_log2, scale, st)
  if (d == 128) return BKV(128);
  if (d == 64) return BKV(64);
  if (d == 32) return BKV(32);
  if (d == 256) return BKV(256);
#undef BKV
  return (int)cudaErrorInvalidValue;
}

// q, k, v, out (rows, dh); caches (rows, total, dh), written at column cur;
// cos2, sin2 (dh,) float32. dh: a positive multiple of 128.
int icikit_decode_step(int dtype, const void* q, const void* k, const void* v,
                       const float* cos2, const float* sin2, void* kc,
                       void* vc, void* out, int64_t rows, int64_t total,
                       int dh, int64_t cur, int rope, float scale,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh < DEC_CW || dh % DEC_CW) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch_decode<bf16>(q, k, v, cos2, sin2, kc, vc, out, rows, total,
                               dh, cur, rope, scale, st);
  if (dtype == 0)
    return launch_decode<float>(q, k, v, cos2, sin2, kc, vc, out, rows, total,
                                dh, cur, rope, scale, st);
  return (int)cudaErrorInvalidValue;
}

// dtype: q's (0 = float32, 1 = bfloat16). q (rows, dh); kq, vq (rows, dh)
// int8, kdq, vdq (rows, dh) float32; caches (rows, total, dh) int8, written
// at column cur; ksc, vsc (rows, total) float32; out (rows, dh) float32.
// dh: a positive multiple of 128.
int icikit_decode_step_q8(int dtype, const void* q, const int8_t* kq,
                          const int8_t* vq, const float* kdq,
                          const float* vdq, int8_t* kc, int8_t* vc,
                          const float* ksc, const float* vsc, float* out,
                          int64_t rows, int64_t total, int dh, int64_t cur,
                          float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh < DEC_CW || dh % DEC_CW) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch_decode_q8<bf16>(q, kq, vq, kdq, vdq, kc, vc, ksc, vsc, out,
                                  rows, total, dh, cur, scale, st);
  if (dtype == 0)
    return launch_decode_q8<float>(q, kq, vq, kdq, vdq, kc, vc, ksc, vsc, out,
                                   rows, total, dh, cur, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Kernel attributes for the build log: registers and spills per thread,
// by index into the table below.
int icikit_attention_regs(int which, int* regs, int* local_bytes) {
  const void* fns[] = {
      (const void*)flash_fwd_bf16<128>,         // 0
      (const void*)flash_fwd_f32<128>,          // 1
      (const void*)decode_step_kernel<bf16>,    // 2
      (const void*)flash_bwd_bf16<128, true>,   // 3
      (const void*)flash_bwd_f32<128, true>,    // 4
      (const void*)flash_bwd_dq_bf16<128>,      // 5
      (const void*)flash_bwd_dq_f32<128>,       // 6
      (const void*)flash_bwd_bf16<128, false>,  // 7
      (const void*)flash_fwd_bf16<256>,         // 8
      (const void*)flash_fwd_f32<256>,          // 9
      (const void*)flash_bwd_bf16<256, true>,   // 10
      (const void*)flash_bwd_f32<256, true>,    // 11
      (const void*)flash_bwd_dq_bf16<256>,      // 12
      (const void*)flash_bwd_dq_f32<256>,       // 13
      (const void*)flash_bwd_bf16<256, false>,  // 14
      (const void*)flash_bwd_f32<256, false>,   // 15
      (const void*)decode_step_q8_kernel<bf16>,   // 16
      (const void*)decode_step_q8_kernel<float>,  // 17
  };
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
