// Attention kernels for Hopper (sm_90a), bound with ctypes.
//
// Two kernels carry icikit_torch's greedy decode, one for each group of
// TPU kernels of icikit/ops/flash_attention.py on that path:
//
//   flash_fwd   <- _fwd_kernel (B3, _fwd_call, pallas_call :421) and
//                  _fwd_single_kernel (B5, _fwd_single_call, :349).
//      Causal or full flash-attention forward: out and the per-row
//      log-sum-exp in nats. On the TPU, B5 is the one-K-block case of
//      B3 (no carried statistics); here it is the same loop run once, so
//      one kernel computes both. One CTA per (batch*head, 64-row Q tile);
//      K/V tiles of 64 keys are staged through shared memory and the
//      loop stops at the causal diagonal (_last_valid_k's fetch elision
//      as a loop bound). Online softmax in base 2 with log2(e) folded
//      into the scale, float32 statistics and accumulator; masked
//      entries take the finite NEG_INF (flash_attention.py:93-99), and a
//      ragged last tile is masked (keys) and zero-filled (K and V), so
//      every length runs here. bf16: four warps, each owning 16 Q rows,
//      run both products on the tensor cores with mma.sync m16n8k16
//      (bf16 in, fp32 accumulate); P is rounded to bf16 before PV, as
//      the TPU kernel does. float32: the same tiles with plain FMA.
//      Bound (b=8, h=8, s=512, d=128, bf16, causal): 33.7 MB read and
//      written, 10 us at 3.35 TB/s, against 4.3 GFLOP, 4.3 us at
//      989 TFLOP/s: bytes. Each K/V tile is read once per Q tile (8
//      times at s=512) but from L2; the design keeps S and P out of
//      device memory. wgmma, TMA and a pipelined ring of tiles are later
//      work.
//
//   decode_step <- _decode_step_kernel (B13, decode_step_attention,
//                  pallas_call :1120).
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
//      5.3 us at 3.35 TB/s: bytes. Eight warps stream the columns with
//      each lane holding dh/32 contiguous elements, so every row read is
//      one coalesced 256-byte segment. 64 CTAs leave half of the 132 SMs
//      idle; a split-K (flash-decoding) form is a later design.
//
// Every entry returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -3.4028234663852886e38f;  // float32 min, finite
constexpr float LN2 = 0.6931471805599453f;
constexpr int BM = 64;             // Q rows a CTA
constexpr int BN = 64;             // keys a tile
constexpr int MMA_THREADS = 128;   // bf16: 4 warps x 16 rows
constexpr int F32_THREADS = 256;   // f32: 4 threads a row
constexpr int DEC_THREADS = 256;   // decode: 8 warps
constexpr int DEC_WARPS = DEC_THREADS / 32;

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
// flash_fwd, bf16 on the tensor cores. Warp w owns Q rows w*16 .. w*16+15
// of the tile; lane (g = lane/4, c = lane%4) holds rows g and g+8 of every
// mma fragment (PTX ISA m16n8k16 layouts), so the row statistics reduce
// over the 4 lanes of a group and the S accumulators are already P's A
// fragments.

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ out,
               float* __restrict__ lse, int64_t sq, int64_t sk, int causal,
               float scale_log2) {
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
  const int64_t r0 = m0 + warp * 16 + g, r1 = r0 + 8;

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    const int col = c * 16 + c2;
    qa[c][0] = r0 < sq ? ld32(qb + r0 * D + col) : 0u;
    qa[c][1] = r1 < sq ? ld32(qb + r1 * D + col) : 0u;
    qa[c][2] = r0 < sq ? ld32(qb + r0 * D + col + 8) : 0u;
    qa[c][3] = r1 < sq ? ld32(qb + r1 * D + col + 8) : 0u;
  }
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float mx0 = -INFINITY, mx1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int64_t n_end = causal && m0 + BM < sk ? m0 + BM : sk;
  for (int64_t n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < BN * D / 8; i += MMA_THREADS) {
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
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, off));
      tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, off));
    }
    const float mn0 = fmaxf(mx0, tm0), mn1 = fmaxf(mx1, tm1);
    const float al0 = exp2f(mx0 - mn0), al1 = exp2f(mx1 - mn1);
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
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }
#pragma unroll
    for (int c = 0; c < BN / 16; ++c) {
      const uint32_t pa[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                              pack_bf16(s[2 * c][2], s[2 * c][3]),
                              pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                              pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const bf16* vp = vt + (n * 8 + g) * VS + c * 16 + c2;
        mma_bf16(o[n], pa, ld32(vp), ld32(vp + 8));
      }
    }
  }
  bf16* ob = out + bh * sq * D;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + c2;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * D + col) =
          pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * D + col) =
          pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
  if ((lane & 3) == 0) {
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
              float scale_log2) {
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
#pragma unroll
  for (int e = 0; e < D / 4; ++e) o[e] = 0.f;
  float mx = -INFINITY, l = 0.f;

  const int64_t n_end = causal && m0 + BM < sk ? m0 + BM : sk;
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
    tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
    tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 2));
    const float mn = fmaxf(mx, tm);
    const float al = exp2f(mx - mn);
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
  if (row < sq) {
    float* ob = out + bh * sq * D + row * D;
    const float inv = 1.f / l;
#pragma unroll
    for (int e = 0; e < D / 4; ++e) ob[e * 4 + c] = o[e] * inv;
    if (c == 0) lse[bh * sq + row] = mx * LN2 + logf(l);
  }
}

// ---------------------------------------------------------------------------
// decode_step. Lane l of each warp holds elements [l*EPL, (l+1)*EPL) of a
// dh = 32*EPL row.

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

template <typename T, int EPL>
__global__ void __launch_bounds__(DEC_THREADS)
decode_step_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ cos2,
                   const float* __restrict__ sin2, T* kc, T* vc,
                   T* __restrict__ out, int64_t total, int64_t cur, int rope,
                   float scale) {
  constexpr int DH = 32 * EPL;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                  // rotated q (input-dtype values)
  float* kn = qs + DH;              // rotated k
  float* part = kn + DH;            // DEC_WARPS x DH partial sums
  float* red = part + DEC_WARPS * DH;
  float* w = red + DEC_WARPS;       // cur + 1 logits, then weights
  const int64_t rowi = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qr = q + rowi * DH;
  const T* kr = k + rowi * DH;
  const T* vr = v + rowi * DH;
  T* kcr = kc + rowi * total * DH;
  T* vcr = vc + rowi * total * DH;

  for (int d = threadIdx.x; d < DH; d += DEC_THREADS) {
    float qd = to_f(qr[d]), kd = to_f(kr[d]);
    if (rope) {
      // x * cos2 + rot * sin2, rot = [-x2, x1], the first product fused
      const int h = DH / 2;
      const float c = cos2[d], s = sin2[d];
      const float qr_ = d < h ? -to_f(qr[d + h]) : to_f(qr[d - h]);
      const float kr_ = d < h ? -to_f(kr[d + h]) : to_f(kr[d - h]);
      qd = __fmaf_rn(qd, c, __fmul_rn(qr_, s));
      kd = __fmaf_rn(kd, c, __fmul_rn(kr_, s));
    }
    const T kt = from_f<T>(kd);
    qs[d] = to_f(from_f<T>(qd));
    kn[d] = to_f(kt);
    kcr[cur * DH + d] = kt;            // the cache column, in place
    vcr[cur * DH + d] = vr[d];
  }
  __syncthreads();

  float qreg[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) qreg[e] = qs[lane * EPL + e];
  for (int64_t t = warp; t < cur; t += DEC_WARPS) {
    float kx[EPL];
    load_row<T, EPL>(kcr + t * DH + lane * EPL, kx);
    float acc = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc += qreg[e] * kx[e];
    acc = warp_sum(acc);
    if (lane == 0) w[t] = acc * scale;
  }
  if (warp == 0) {
    float acc = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc += qreg[e] * kn[lane * EPL + e];
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

  float acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
  for (int64_t t = warp; t < cur; t += DEC_WARPS) {
    const float wt = to_f(from_f<T>(w[t]));
    float vx[EPL];
    load_row<T, EPL>(vcr + t * DH + lane * EPL, vx);
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] += wt * vx[e];
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) part[warp * DH + lane * EPL + e] = acc[e];
  __syncthreads();
  const float w_cur = w[cur];
  for (int d = threadIdx.x; d < DH; d += DEC_THREADS) {
    float sum = 0.f;
    for (int ww = 0; ww < DEC_WARPS; ++ww) sum += part[ww * DH + d];
    sum += w_cur * to_f(vr[d]);
    out[rowi * DH + d] = from_f<T>(sum / l);
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
                 int causal, float scale_log2, cudaStream_t st) {
  const dim3 grid((unsigned)((sq + BM - 1) / BM), (unsigned)bh);
  if (dtype == 1) {
    const size_t smem = sizeof(bf16) * (BN * (D + 8) + D * (BN + 8));
    int err = set_smem(flash_fwd_bf16<D>, smem);
    if (err) return err;
    flash_fwd_bf16<D><<<grid, MMA_THREADS, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, sq, sk,
        causal, scale_log2);
  } else if (dtype == 0) {
    const size_t smem =
        sizeof(float) * (BM * (D + 1) + BN * (D + 1) + BN * D + BM * (BN + 1));
    int err = set_smem(flash_fwd_f32<D>, smem);
    if (err) return err;
    flash_fwd_f32<D><<<grid, F32_THREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, sq, sk,
        causal, scale_log2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, int EPL>
int launch_decode(const void* q, const void* k, const void* v,
                  const float* cos2, const float* sin2, void* kc, void* vc,
                  void* out, int64_t rows, int64_t total, int64_t cur,
                  int rope, float scale, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (2 * 32 * EPL + DEC_WARPS * 32 * EPL + DEC_WARPS + cur + 1);
  int err = set_smem(decode_step_kernel<T, EPL>, smem);
  if (err) return err;
  decode_step_kernel<T, EPL><<<(unsigned)rows, DEC_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cos2, sin2, static_cast<T*>(kc),
      static_cast<T*>(vc), static_cast<T*>(out), total, cur, rope, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q (bh, sq, d), k and v (bh, sk, d),
// out (bh, sq, d), lse (bh, sq) float32. d: 64 or 128.
int icikit_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                     void* out, float* lse, int64_t bh, int64_t sq, int64_t sk,
                     int d, int causal, float scale_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 128)
    return launch_flash<128>(dtype, q, k, v, out, lse, bh, sq, sk, causal,
                             scale_log2, st);
  if (d == 64)
    return launch_flash<64>(dtype, q, k, v, out, lse, bh, sq, sk, causal,
                            scale_log2, st);
  return (int)cudaErrorInvalidValue;
}

// q, k, v, out (rows, dh); caches (rows, total, dh), written at column cur;
// cos2, sin2 (dh,) float32. dh: 128 or 256.
int icikit_decode_step(int dtype, const void* q, const void* k, const void* v,
                       const float* cos2, const float* sin2, void* kc,
                       void* vc, void* out, int64_t rows, int64_t total,
                       int dh, int64_t cur, int rope, float scale,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && dh == 128)
    return launch_decode<bf16, 4>(q, k, v, cos2, sin2, kc, vc, out, rows,
                                  total, cur, rope, scale, st);
  if (dtype == 1 && dh == 256)
    return launch_decode<bf16, 8>(q, k, v, cos2, sin2, kc, vc, out, rows,
                                  total, cur, rope, scale, st);
  if (dtype == 0 && dh == 128)
    return launch_decode<float, 4>(q, k, v, cos2, sin2, kc, vc, out, rows,
                                   total, cur, rope, scale, st);
  if (dtype == 0 && dh == 256)
    return launch_decode<float, 8>(q, k, v, cos2, sin2, kc, vc, out, rows,
                                   total, cur, rope, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Kernel attributes for the build log: registers and spills per thread.
// which: 0 flash_fwd bf16 d128, 1 flash_fwd f32 d128, 2 decode_step bf16
// dh128.
int icikit_attention_regs(int which, int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err;
  if (which == 0)
    err = cudaFuncGetAttributes(&attr, flash_fwd_bf16<128>);
  else if (which == 1)
    err = cudaFuncGetAttributes(&attr, flash_fwd_f32<128>);
  else
    err = cudaFuncGetAttributes(&attr, decode_step_kernel<bf16, 4>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
