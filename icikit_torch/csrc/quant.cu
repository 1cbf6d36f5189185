// The int8 matvec for Hopper (sm_90a), bound with ctypes.
//
//   quant_matvec <- _matvec_kernel (B15, icikit/ops/quant.py:108;
//                   quant_matvec, pallas_call :167).
//      out (rows, N) float32 = (x (rows, K) . w8 (N, K)^T) * scale (N,):
//      int8 weights with the contraction last, one float32 scale per
//      output channel applied to the float32 accumulator once. The TPU
//      kernel keeps all of x in VMEM and tiles the output channels; the
//      prefill's kernel here tiles rows as well, so each weight byte
//      crosses device memory once per row tile. The weights cross device
//      memory at one byte an element and are widened on chip.
//
//      Two regimes on the int8 decode path of `base`:
//      - the decode step, rows = b = 8: bytes. wqkv (3072 x 1024) is 3.1
//        MB, 0.94 us at 3.35 TB/s; w_out (32768 x 1024) 33.6 MB, 10.0 us.
//        qmv_bf16_skinny: the channels on mma's m16 side and the rows on
//        its n8, a 16-channel tile a CTA, K in 64-wide chunks spread over
//        the CTA's eight warps (and, past 64 chunks, over CTAs whose
//        partials the tile's last CTA adds in the same launch); every
//        load of a warp in flight before its first product, the int8
//        widened in registers, x read once a CTA straight into its
//        fragments (the design note above the kernel).
//      - the prefill, rows = b*s = 4096: operations. About 103 GFLOP a
//        layer (25.8 wqkv, 8.6 wo, 34.4 w1, 34.4 w2), 0.10 ms at 989
//        TFLOP/s. qmv_bf16_tile: wgmma with the weights as its register
//        operand, widened there, x by descriptor from a 4-stage TMA
//        ring, a 128-channel x 256-row tile a CTA (the design note
//        above the kernel).
//      bf16 x runs on the tensor cores (bf16 in, float32 accumulate;
//      mma.sync m16n8k16 at rows <= 16, wgmma past): every int8 value is
//      a bf16 integer, so each product is exact and only the summation
//      order differs from the plain version; each kernel's order is
//      fixed, so its result repeats bit for bit. float32 x (the card's
//      float32 checks) runs qmv_f32 with plain FMA.
//
// Every entry returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int F32_THREADS = 256;
constexpr int SKINNY_ROWS = 16;    // rows two n8 tiles hold
constexpr int SK_THREADS = 256;    // skinny: 8 warps
constexpr int SK_WARPS = SK_THREADS / 32;
constexpr int SK_CH = 16;          // skinny: channels a CTA (mma's m16)
constexpr int SK_KC = 64;          // skinny: K a chunk, 16 bytes a lane
// skinny: chunks a warp at most, all in registers at once: 8 at rows <= 8
// (64 a CTA, K 4096 in one CTA), 4 at rows 9-16 (two n-tiles of x)
constexpr int SK_CPW_MAX = 8, SK_CPW_MAX_NT2 = 4;
constexpr int SK_PART = SK_CH * SKINNY_ROWS;  // a split's floats

// D (16x8, f32) += A (16x16, bf16, row) * B (16x8, bf16, col).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes read once: not cached in L1.
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// Four int8 (one word, bytes e0..e3) -> bf16 pairs lo = {e0, e1}, hi =
// {e2, e3}, exactly, in registers: a byte biased to unsigned u is the
// low byte of the float 2^23 + u; less 2^23 + 128 it is the integer,
// whose top 16 bits are its bf16 (at most 8 significant bits).
__device__ __forceinline__ void widen4(uint32_t v, uint32_t& lo,
                                       uint32_t& hi) {
  constexpr float MAGIC = 8388736.f;  // 2^23 + 128
  const uint32_t u = v ^ 0x80808080u;
  const uint32_t f0 = __float_as_uint(
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - MAGIC);
  const uint32_t f1 = __float_as_uint(
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - MAGIC);
  const uint32_t f2 = __float_as_uint(
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - MAGIC);
  const uint32_t f3 = __float_as_uint(
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - MAGIC);
  lo = __byte_perm(f0, f1, 0x7632);
  hi = __byte_perm(f2, f3, 0x7632);
}

// rows <= 16, bf16 x: the decode step. The weights are mma's A operand
// (16 channels x k16, the m16 side) and x^T its B (k16 x 8 rows), so at
// rows 8 every product of m16n8k16 is used (rows 9-16: a second n-tile,
// NT = 2). K is cut into 64-wide chunks. Lane (g = lane/4, c = lane%4)
// of a warp loads 16 bytes of channel g's and of channel g+8's chunk,
// at byte 16c, with one 16-byte ld.global.nc each (L1 not allocated:
// every weight byte is read once), and 32 bytes of x row g (and g+8) at
// element 16c, through L1, which the CTAs of a K range on one SM share;
// x lands straight in its B fragments, once a CTA, with no shared
// memory. The contraction order inside a chunk is free, so step s of the
// chunk's four k16 steps takes word s of the lane's weights (bytes
// 16c+4s .. +3) and the same four elements of x: mma's k positions 2c,
// 2c+1, 2c+8, 2c+9 of the lane are those bytes, and A and B agree.
// Each int8 word widens to two bf16 pairs in registers (widen4), exactly.
//
// A CTA (8 warps) owns one 16-channel tile and a range of `per` chunks
// of K; warp w takes chunks w, w+8, .. (CPW a warp at most: 8 at rows
// <= 8, 4 at 9-16), all its loads issued before its first product, so a
// lane has up to 2 x CPW weight loads in flight and a CTA takes K 4096
// in one round trip. The eight warps' sums meet in shared memory, in
// warp order. Past what a CTA holds, K is split across `splits` CTAs
// (gridDim.y, from cuda_quant.skinny_splits): each CTA's sum goes to a
// float32 workspace and the tile's last CTA (an atomic count, reset to
// 0) adds the splits in split order, scales and writes, so the result
// does not depend on which CTA finishes last. Splitting to fill the SMs
// (two CTAs an SM at N 1024) was slower at every product of the int8
// path: the merge's fence, atomic and read back cost more than the
// extra CTAs won, a launch being one round trip either way.
template <int CPW, int NT>
__global__ void __launch_bounds__(SK_THREADS)
qmv_bf16_skinny(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, float* __restrict__ out,
                float* ws, unsigned* counter, int64_t rows, int64_t n,
                int64_t k) {
  __shared__ float red[SK_WARPS][SK_CH][8 * NT];  // [warp][channel][row]
  __shared__ bool last;
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int64_t nck = k / SK_KC;
  const int64_t per = (nck + splits - 1) / splits;
  const int64_t c0 = split * per;
  const int64_t c1 = c0 + per < nck ? c0 + per : nck;
  const int64_t n0 = (int64_t)tile * SK_CH;
  const int8_t* wr = w + (n0 + g) * k + 16 * c;  // channel g; g+8 at 8k
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  uint4 wa[CPW], wb[CPW], xv[CPW][NT][2];
#pragma unroll
  for (int u = 0; u < CPW; ++u) {
    const int64_t ci = c0 + warp + u * SK_WARPS;
    wa[u] = wb[u] = zero;
    if (ci < c1) {
      wa[u] = ld_stream(wr + ci * SK_KC);
      wb[u] = ld_stream(wr + 8 * k + ci * SK_KC);
    }
  }
#pragma unroll
  for (int u = 0; u < CPW; ++u) {
    const int64_t ci = c0 + warp + u * SK_WARPS;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int64_t r = g + 8 * t;
      xv[u][t][0] = xv[u][t][1] = zero;
      if (ci < c1 && r < rows) {
        const uint4* p =
            reinterpret_cast<const uint4*>(x + r * k + ci * SK_KC + 16 * c);
        xv[u][t][0] = __ldg(p);
        xv[u][t][1] = __ldg(p + 1);
      }
    }
  }

  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
#pragma unroll
  for (int u = 0; u < CPW; ++u) {
    if (c0 + warp + u * SK_WARPS >= c1) break;  // warp-uniform
    const uint32_t ra[4] = {wa[u].x, wa[u].y, wa[u].z, wa[u].w};
    const uint32_t rb[4] = {wb[u].x, wb[u].y, wb[u].z, wb[u].w};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint32_t a[4];
      widen4(ra[s], a[0], a[2]);  // channel g: k 2c, 2c+1 | 2c+8, 2c+9
      widen4(rb[s], a[1], a[3]);  // channel g+8
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const uint4 lo = xv[u][t][0], hi = xv[u][t][1];
        const uint32_t xw[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        mma_bf16(acc[t], a, xw[2 * s], xw[2 * s + 1]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    red[warp][g][8 * t + 2 * c] = acc[t][0];
    red[warp][g][8 * t + 2 * c + 1] = acc[t][1];
    red[warp][g + 8][8 * t + 2 * c] = acc[t][2];
    red[warp][g + 8][8 * t + 2 * c + 1] = acc[t][3];
  }
  __syncthreads();
  const int nr = (int)rows;  // <= 8 * NT
  float* part = ws + ((int64_t)tile * splits + split) * SK_PART;
  for (int i = threadIdx.x; i < SK_CH * nr; i += SK_THREADS) {
    const int r = i / SK_CH, ch = i % SK_CH;
    float s = red[0][ch][r];
#pragma unroll
    for (int ww = 1; ww < SK_WARPS; ++ww) s += red[ww][ch][r];
    if (splits == 1)
      out[r * n + n0 + ch] = s * scale[n0 + ch];
    else
      part[i] = s;
  }
  if (splits == 1) return;

  // the tile's last CTA adds the splits in order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(counter + tile, 1u) == (unsigned)splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* tp = ws + (int64_t)tile * splits * SK_PART;
  for (int i = threadIdx.x; i < SK_CH * nr; i += SK_THREADS) {
    const int r = i / SK_CH, ch = i % SK_CH;
    float s = __ldcg(tp + i);
    for (int sp = 1; sp < splits; ++sp) s += __ldcg(tp + sp * SK_PART + i);
    out[r * n + n0 + ch] = s * scale[n0 + ch];
  }
  if (threadIdx.x == 0) counter[tile] = 0u;  // ready for the next call
}

// rows > 16, bf16 x: the prefill. The product is taken transposed, out^T
// (channels x rows) = w8 (channels x K) . x^T (K x rows), so that the
// weights are wgmma's A operand from registers, widened there without a
// per-element conversion, and x its B operand straight from the TMA tile.
//
// - A CTA owns a 128-channel x 256-row output tile: two consumer
//   warpgroups of 64 channels, each running one m64n256k16 a k16 step
//   (its A fragment against all 256 rows), and a producer
//   warpgroup whose one thread keeps a 4-stage ring full by TMA (full and
//   empty mbarriers a stage; setmaxnreg gives its registers to the
//   consumers). A stage is K 64: x's 256 x 64 tile (32 KB, one box, the
//   128-byte swizzle, rows past `rows` zero-filled) and w8's 128 x 64
//   bytes (8 KB, one box of UINT8, the 64-byte swizzle).
// - The A fragment of lane (g, c) holds k 2c, 2c+1, 2c+8, 2c+9 of each
//   k16 step for channels g and g+8, and x's descriptor fixes k's order,
//   so the lane reads the two words of the channel's 64-byte row that
//   hold those bytes (bytes 16kc + 4(c/2) and 8 further, their chunk
//   moved by the swizzle: the eight rows a warp reads land on 16 banks
//   with no conflict), takes the two bytes of each it needs by one
//   byte-perm and widens the word to two bf16 pairs (widen4: a
//   byte-perm into a float's mantissa and one subtract an element).
// - Each warpgroup holds two A fragment sets and runs one wgmma group a
//   stage with one unconditional wait, for the group before it: the
//   widening of stage i+1 runs under the products of stage i, and the
//   ring's stage i-1 is released once its group is done.
// - The scale sits on the accumulator's rows (channels). The float32 tile
//   goes through shared memory (the ring, free by then; 132-float rows, no
//   bank conflicts) and leaves as whole 512-byte rows of out in 16-byte
//   stores, masked past `rows`.
// - The grid runs the channel tiles of one row tile together: a wave
//   shares x's row tiles and all of w8 through L2.
// Bound: the products (2 rows n k at 989 TFLOP/s: 34.7 us at w1, rows
// 4096); the float32 output (67 MB at w1, 20 us) is the largest stream.
// N must be a multiple of 128 (JAX's gate: N tileable by 128), K of 64.
constexpr int QT_CH = 128;        // channels a CTA, two warpgroups
constexpr int QT_ROWS = 256;      // rows of x a CTA
constexpr int QT_KT = 64;         // K a stage
constexpr int QT_NS = 4;          // ring stages
constexpr int QT_THREADS = 384;   // two consumer warpgroups, a producer
constexpr int QT_XBYTES = QT_ROWS * QT_KT * 2;  // x's tile, 32 KB
constexpr int QT_STAGE = QT_XBYTES + QT_CH * QT_KT;  // and w8's, 8 KB
constexpr int QT_OST = QT_CH + 4;  // float stride of the output stage
constexpr size_t QT_SMEM = 1024 + QT_NS * QT_STAGE + 2 * QT_NS * 8;
static_assert(QT_ROWS * QT_OST * 4 <= QT_NS * QT_STAGE,
              "the output stage lives in the ring");

// The A fragment of one stage for the lane's channels ch and ch + 8 (of
// the tile's 128; w8's 64-byte rows in the 64-byte swizzle: the 16-byte
// chunk j of row r sits at chunk j ^ ((r >> 1) & 3)).
__device__ __forceinline__ void qt_frags(uint32_t (&a)[QT_KT / 16][4],
                                         const unsigned char* ws, int ch,
                                         int c) {
  const uint32_t sel = (c & 1) ? 0x7632u : 0x5410u;
#pragma unroll
  for (int kc = 0; kc < QT_KT / 16; ++kc)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = ch + 8 * hh;
      const unsigned char* p =
          ws + r * QT_KT + ((kc ^ ((r >> 1) & 3)) << 4) + 4 * (c >> 1);
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + 8);
      widen4(__byte_perm(w0, w1, sel), a[kc][hh], a[kc][2 + hh]);
    }
}

__global__ void __launch_bounds__(QT_THREADS, 1)
qmv_bf16_tile(const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap tw,
              const float* __restrict__ scale, float* __restrict__ out,
              int64_t rows, int64_t n, int64_t k) {
  extern __shared__ __align__(1024) unsigned char qt_smem[];
  unsigned char* ring =
      qt_smem + ((1024 - (smem_u32(qt_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + QT_NS * QT_STAGE);
  uint64_t* empty = full + QT_NS;
  const int n0 = blockIdx.x * QT_CH, m0 = blockIdx.y * QT_ROWS;
  const int nk = (int)(k / QT_KT);  // even: k % 128 == 0
  const int wgi = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int i = 0; i < QT_NS; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 2) {
    // the producer: stage i % QT_NS takes K step i once the consumers
    // have released step i - QT_NS
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      for (int i = 0; i < nk; ++i) {
        const int st = i % QT_NS;
        if (i >= QT_NS) mbar_wait(empty + st, (i / QT_NS - 1) & 1);
        unsigned char* xs = ring + st * QT_STAGE;
        mbar_expect_tx(full + st, QT_STAGE);
        tma_box2(xs, &tx, i * QT_KT, m0, full + st);
        tma_box2(xs + QT_XBYTES, &tw, i * QT_KT, n0, full + st);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int ch = wgi * 64 + warp * 16 + g;  // and ch + 8, of the tile
  float o[128];
#pragma unroll
  for (int j = 0; j < 128; ++j) o[j] = 0.f;
  uint32_t a0[QT_KT / 16][4], a1[QT_KT / 16][4];
  // one stage: its fragments, its products (issued), then the wait for
  // the group before, whose stage goes back to the producer
  auto stage = [&](int i, uint32_t (&a)[QT_KT / 16][4]) {
    const int st = i % QT_NS;
    mbar_wait(full + st, (i / QT_NS) & 1);
    const unsigned char* xs = ring + st * QT_STAGE;
    qt_frags(a, xs + QT_XBYTES, ch, c);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < QT_KT / 16; ++kc)
      wgmma_rs<256, 0>(o, a[kc], gmma_desc_sw(xs + kc * 32, 16, 8 * 128, 1),
                       1);
    wg_commit();
    wg_wait<1>();
    if (i > 0) mbar_arrive(empty + (i - 1) % QT_NS);
  };
  for (int i = 0; i < nk; i += 2) {
    stage(i, a0);
    stage(i + 1, a1);
  }
  wg_wait<0>();
  fence_regs(o);

  // the scaled tile, rows x channels, through the ring (both warpgroups'
  // products are done with it)
  bar_sync(1, 2 * 128);
  float* os = reinterpret_cast<float*>(ring);
  const float s0 = scale[n0 + ch], s1 = scale[n0 + ch + 8];
#pragma unroll
  for (int j = 0; j < QT_ROWS / 8; ++j) {
    const int r = 8 * j + 2 * c;
    os[r * QT_OST + ch] = o[4 * j] * s0;
    os[(r + 1) * QT_OST + ch] = o[4 * j + 1] * s0;
    os[r * QT_OST + ch + 8] = o[4 * j + 2] * s1;
    os[(r + 1) * QT_OST + ch + 8] = o[4 * j + 3] * s1;
  }
  bar_sync(1, 2 * 128);
  for (int i = threadIdx.x; i < QT_ROWS * QT_CH / 4; i += 2 * 128) {
    const int r = i / (QT_CH / 4), c4 = i % (QT_CH / 4) * 4;
    if (m0 + r < rows)
      *reinterpret_cast<float4*>(out + (m0 + r) * n + n0 + c4) =
          *reinterpret_cast<const float4*>(os + r * QT_OST + c4);
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

template <int CPW>
void launch_skinny(const bf16* x, const int8_t* w, const float* scale,
                   float* out, float* ws, unsigned* counter, int64_t rows,
                   int64_t n, int64_t k, int splits, cudaStream_t st) {
  const dim3 grid((unsigned)(n / SK_CH), (unsigned)splits);
  if (rows <= 8)
    qmv_bf16_skinny<CPW, 1><<<grid, SK_THREADS, 0, st>>>(
        x, w, scale, out, ws, counter, rows, n, k);
  else if constexpr (CPW <= SK_CPW_MAX_NT2)
    qmv_bf16_skinny<CPW, 2><<<grid, SK_THREADS, 0, st>>>(
        x, w, scale, out, ws, counter, rows, n, k);
}

// qmv_bf16_tile's launch: its two TMA maps, a CTA a 128-channel x
// 256-row tile, the channel tiles of a row tile side by side.
int launch_tile(const bf16* x, const int8_t* w, const float* scale,
                float* out, int64_t rows, int64_t n, int64_t k,
                cudaStream_t st) {
  if (n % QT_CH || (rows + QT_ROWS - 1) / QT_ROWS > 65535 ||
      k > INT32_MAX || n > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  int err = tma_map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, rows, k,
                       QT_KT, QT_ROWS, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = tma_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, n, k, QT_KT,
                     QT_CH, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      qmv_bf16_tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)QT_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(n / QT_CH),
                  (unsigned)((rows + QT_ROWS - 1) / QT_ROWS));
  qmv_bf16_tile<<<grid, QT_THREADS, QT_SMEM, st>>>(tx, tw, scale, out, rows,
                                                  n, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 x, 1 = bfloat16 x. x (rows, k), w8 (n, k) int8,
// scale (n,) float32, out (rows, n) float32. k % 128 == 0, n % 64 == 0;
// bf16 at rows > 16 (qmv_bf16_tile) takes n % 128 == 0 only.
// bf16 at rows <= 16 (qmv_bf16_skinny) splits K across `splits` CTAs a
// 16-channel tile (1 .. k/64, at most 16 chunks of 64 a CTA); with
// splits > 1, ws holds (n/16) * splits * 256 float32 and counter (n/16)
// uint32, zero and left zero. Elsewhere ws, counter and splits are unused.
int icikit_quant_matvec_split(int dtype, const void* x, const int8_t* w,
                              const float* scale, float* out, int64_t rows,
                              int64_t n, int64_t k, float* ws,
                              unsigned* counter, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k % 128 || n % 64 || rows < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && rows <= SKINNY_ROWS) {
    const int64_t nck = k / SK_KC;
    const int64_t per = splits >= 1 ? (nck + splits - 1) / splits : 0;
    const int cpw_max = rows <= 8 ? SK_CPW_MAX : SK_CPW_MAX_NT2;
    if (splits < 1 || splits > nck || splits > 65535 ||
        per > SK_WARPS * cpw_max || (splits > 1 && (!ws || !counter)))
      return (int)cudaErrorInvalidValue;
    const int cpw = (int)((per + SK_WARPS - 1) / SK_WARPS);
    const bf16* xb = static_cast<const bf16*>(x);
    if (cpw == 1)
      launch_skinny<1>(xb, w, scale, out, ws, counter, rows, n, k, splits, st);
    else if (cpw == 2)
      launch_skinny<2>(xb, w, scale, out, ws, counter, rows, n, k, splits, st);
    else if (cpw <= 4)
      launch_skinny<4>(xb, w, scale, out, ws, counter, rows, n, k, splits, st);
    else
      launch_skinny<8>(xb, w, scale, out, ws, counter, rows, n, k, splits, st);
  } else if (dtype == 1) {
    return launch_tile(static_cast<const bf16*>(x), w, scale, out, rows, n,
                       k, st);
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
// which: 0-3 qmv_bf16_skinny<CPW, 1> at CPW 1, 2, 4, 8, 4-6
// qmv_bf16_skinny<CPW, 2> at CPW 1, 2, 4; 7 qmv_bf16_tile, 8 qmv_f32
// skinny, 9 qmv_f32.
int icikit_quant_regs(int which, int* regs, int* local_bytes) {
  const void* fns[] = {
      (const void*)qmv_bf16_skinny<1, 1>, (const void*)qmv_bf16_skinny<2, 1>,
      (const void*)qmv_bf16_skinny<4, 1>, (const void*)qmv_bf16_skinny<8, 1>,
      (const void*)qmv_bf16_skinny<1, 2>, (const void*)qmv_bf16_skinny<2, 2>,
      (const void*)qmv_bf16_skinny<4, 2>, (const void*)qmv_bf16_tile,
      (const void*)qmv_f32<16, 32, 1, 2>, (const void*)qmv_f32<64, 64, 4, 4>,
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
