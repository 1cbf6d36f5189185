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
//      so one kernel computes all three. One CTA per (batch*head, Q
//      tile); K/V tiles are staged through shared memory and the loop
//      stops at the causal diagonal (_last_valid_k's fetch elision as a
//      loop bound). Online softmax in base 2 with
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
//      in exp2's subnormal range (few significant bits, or flushed to
//      zero), and one above it lets P V overflow while l does not.
//      Bound (b=8, h=8, s=1024, d=128, bf16, causal): 67.4 MB read and
//      written, 20.1 us at 3.35 TB/s, against 17.2 GFLOP, 17.4 us at
//      989 TFLOP/s: bytes. (b=1, h=4, s=131072, d=128, causal): two
//      causal products, 17.6 TFLOP, 17.8 ms: operations.
//      bf16:
//      - both products on wgmma (m64nNk16, bf16 in, float32 accumulate):
//        a consumer warpgroup owns 64 Q rows; S = Q K^T reads Q and K
//        K-major from shared memory; S's accumulator, rounded to bf16 (as
//        the TPU kernel rounds P), is the register A operand of O += P V,
//        which reads V MN-major through the descriptor's transpose bit:
//        no transposed copy of V;
//      - a producer warpgroup, one thread of which keeps a ring of two
//        K/V stages full by TMA, a 64-column (128-byte) block of a tile a
//        copy through a 3-d tensor map {d, s, b*h} whose rows past s read
//        as zeros (the ragged edge); full and empty mbarriers a stage pace
//        it against the consumers, with no CTA-wide barrier in the loop;
//        Q is loaded once. setmaxnreg gives the producer's registers to
//        the consumers (24 and 240). The blocks land in wgmma's 128-byte
//        swizzle (64-byte at d = 32), which descriptors read K-major (Q,
//        K) and MN-major (V) alike. A 16-byte box (one core-matrix column
//        a copy, the unswizzled layout) took 1.66x the time at 131072,
//        cp.async by the consumers themselves about 2x;
//      - 128 Q rows (two consumer warpgroups sharing each stage) and
//        128-key tiles where d <= 128; 64 and 64 at d = 256, where O's
//        64 x 256 float32 accumulator would take 128 registers a thread
//        (one warpgroup spilled 364 bytes): two warpgroups form the same
//        S and each keeps half of O's columns (col_groups, as the
//        backward);
//      - the causal work order: the grid starts at the last Q tile (the
//        most key tiles), batch*head the fastest grid index;
//      - only a warp's rows that the causal diagonal or a ragged edge
//        crosses take the per-element mask; the weights come from
//        ex2.approx.ftz with the scale folded into one FMA (exp2f took
//        1.4-7% longer);
//      - in shift mode no max chain and no rescale of O; the redo check
//        is an OR over the consumers (a named barrier), whose verdict
//        reaches the producer through an mbarrier; then both walk the key
//        tiles again, the ring's phases running on.
//      float32: 64-row tiles of 64 keys with plain FMA (the card's
//      float32 check).
//
//   flash_bwd   <- _bwd_fused_kernel (B6, _bwd_call, pallas_call :701)
//                  and _bwd_fused_tiled_kernel (B7,
//                  _bwd_fused_tiled_call, :653).
//   flash_bwd_dq  <- _bwd_dq_kernel (B8, _bwd_call, pallas_call :745)
//   flash_bwd_dkv <- _bwd_dkv_kernel (B8, _bwd_call, pallas_call :771).
//      dq, dk and dv from a recomputation of P per tile (_p_tile:
//      exp2(s*scale*log2e - lse*log2e)): dv = P^T dO, dS = P o (dP -
//      delta) * scale, dq = dS K, dk = dS^T Q, with delta = rowsum(dO o
//      O) - g_lse computed by the caller; P and dS are rounded to bf16
//      before their products, as on the TPU, with float32 accumulation.
//      flash_bwd is one kernel for B6 (one block, s <= 1024) and B7
//      (many blocks): a CTA owns a tile of keys, holds its K and V in
//      shared memory and dk, dv in registers, and walks the Q steps from
//      the causal diagonal to the end; this loop takes the place of the
//      TPU's sequential grid, whose carried accumulators do not
//      translate to CTAs that run in no order. dq is summed across the
//      CTAs of a head with float32 atomicAdd into a zeroed (b*h, s, d)
//      buffer (the TPU's whole-sequence VMEM dq scratch, :626), so its
//      last bits vary from run to run. The adds are 16-byte vector
//      atomics (sm_90): a quarter as many as scalar ones, which set the
//      pace at s = 1024-2048. flash_bwd_dkv is the same kernel
//      with its dq part compiled out (the DQ template flag); with
//      flash_bwd_dq, a CTA owning a tile of Q rows and walking the key
//      tiles up to the causal bound, it is the deterministic two-pass backward
//      the TPU runs past its 48 MB dq scratch (sq*d*4 >
//      _DQ_SCRATCH_BYTES_MAX): no atomics, every output written once,
//      at the price of forming S and dP twice (seven products where
//      flash_bwd runs five). float32: plain FMA, the card's check.
//      Bound: operations. (b=8, h=8, s=1024, d=128, causal): 117.9 MB,
//      35.2 us, against five causal products, 42.9 GFLOP, 43.4 us at 989
//      TFLOP/s. (b=1, h=4, s=131072, d=128, causal): the five causal
//      products, 44.0 TFLOP, 44.5 ms (dq alone three, dk/dv four).
//      What held the first design back was the staging, not the
//      products: synchronous global loads before every step, scalar
//      2-byte stores to build K^T, Q^T and dO^T, scalar 32-bit fragment
//      reads for mma.sync, the mask on every element and 32-row steps, so
//      the tensor cores idled ~90% of the time. The bf16 design now:
//      - every product on wgmma (m64nNk16, bf16 in, float32 accumulate):
//        a warpgroup owns 64 keys (flash_bwd, flash_bwd_dkv) or 64 Q rows
//        (flash_bwd_dq). S^T and dP^T (S and dP) read both operands from
//        shared memory; their accumulators, rounded to bf16, are the
//        register A operands of dv = P^T dO and dk = dS^T Q (dq = dS K),
//        as in FlashAttention-3; flash_bwd's dq = dS K reads dS^T from
//        shared memory;
//      - no transposed copies: the operands that the products need
//        transposed (Q, dO and K as B, dS^T as A) are read MN-major from
//        the row tiles through the descriptor's transpose bit. Tiles are
//        stored as 8 x 8 core matrices (cm_off), the layout a descriptor
//        reads without swizzle, with no padding;
//      - a ring of two shared-memory stages filled by cp.async (16 bytes
//        a copy, a ragged edge zero-filled): the next 64-row Q step (Q,
//        dO, lse, delta) of the key-owning kernel, the next 64-key K/V
//        tile of the dq kernel, is in flight while the current one's
//        products run; one barrier a step (two with flash_bwd's dq);
//      - 128 keys a CTA (two warpgroups) where d <= 128, 64 at d = 256
//        (two warpgroups splitting the columns, col_groups); 128 Q rows a
//        dq CTA where d <= 128 (two warpgroups sharing each K/V stage),
//        64 at d = 256. At d = 128: 145 KiB and 1 CTA an SM for the
//        key-owning kernel (129 KiB without dq), 128 KiB and 1 for dq;
//      - the causal work order: the key-owning grid starts at key tile 0
//        (the most Q steps), the dq grid at the last Q tile (the most key
//        tiles), batch*head the fastest grid index, so the longest CTAs
//        of every head go first and the short ones fill the tail; a dq
//        warpgroup skips a key tile above all its rows;
//      - only a warp's block that the causal diagonal or a ragged edge
//        crosses takes the per-element mask.
//      The dq kernel forms P while dP's product runs (wgmma.wait_group
//      1); the key-owning kernel waits for S^T and dP^T together (the same
//      overlap measured slower there). There is no ping-pong between
//      warpgroups and no producer warp yet: what overlaps is the ring's
//      copies with the products and one warpgroup's softmax with the
//      other's products.

//   decode_step <- _decode_step_kernel (B13, decode_step_attention,
//                  pallas_call :1120).
//   decode_step_q8 <- _decode_step_q8_kernel (B14,
//                  decode_step_attention_q8, pallas_call :1229).
//      One token of decode attention for each (batch*head) row:
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
//      5.3 us at 3.35 TB/s: bytes. A row's past columns are split across
//      CTAs, (rows, splits) with rows x splits >= 2 x the SMs (the
//      wrapper's decode_splits: 5 splits of ~109 columns, 320 CTAs at 64
//      rows), the split's K and V columns sent to L2 as the CTA starts,
//      16-byte loads (8 bf16) eight deep a lane, and the splits' (max,
//      sum, value) partials merged by the row's last CTA in the same
//      launch: one launch a layer a step. A split rounds its bf16
//      weights against its own max (the merge rescales them), where the
//      TPU kernel rounds against the row's: the two agree to a tolerance
//      at bf16, not bit for bit; float32 rounds nothing.
//      decode_step_q8 is the same step over int8 caches, as the TPU's:
//      q arrives rotated and the fresh column quantized (written in place
//      at cur) and dequantized (the t == cur term); K's per-column float32
//      scale multiplies the int8 logit row, V's folds into the weights
//      before the value product; float32 softmax and output. RoPE, the
//      column's quantization and the scale-row write stay outside the
//      launch, as in JAX. Bound (64 rows, cur 543, dh 128): 8.9 MB of
//      int8 K and V and 0.28 MB of scales, 2.8 us: bytes. It runs the
//      same split form and helpers, 16-byte loads (16 int8) eight deep a
//      lane.
//
// Every entry returns cudaGetLastError() after its launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -3.4028234663852886e38f;  // float32 min, finite
constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BM = 64;             // Q rows a CTA
constexpr int BN = 64;             // keys a tile
constexpr int BQB = 32;            // Q rows a float32 backward step
constexpr int F32_THREADS = 256;   // f32: 4 threads a row

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

// 16 (or 4) bytes from global into shared memory without a register
// round trip; the bytes past src_bytes are zero-filled (src_bytes 0: a row
// beyond the tensor, which reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// This thread's copies have landed, and are visible to wgmma's (async
// proxy) reads once the CTA has passed a barrier after.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Plain shared-memory stores made visible to wgmma's reads (with a
// barrier after).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Tiles that wgmma reads are stored as 8 x 8 core matrices (8 rows of 16
// bytes, 128 contiguous bytes), in row-major order of core matrices: the
// 16-byte chunk c8 of row r of a tile with CH chunks a row lies at byte
// cm_off<CH>(r, c8). No padding: a core matrix's eight rows are
// contiguous, so its reads and fills touch all 32 banks.
template <int CH>
__device__ __forceinline__ int cm_off(int r, int c8) {
  return ((r >> 3) * CH + c8) * 128 + (r & 7) * 16;
}

// R rows of a (rows, D) bf16 tensor from row0 into a cm_off tile by
// cp.async, rows past `rows` zero-filled; NT threads. Eight neighbouring
// threads fill one core matrix.
template <int D, int R, int NT>
__device__ __forceinline__ void cp_tile(unsigned char* dst, const bf16* src,
                                        int64_t row0, int64_t rows) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int j = 0; j < (R * CH + NT - 1) / NT; ++j) {
    const int i = j * NT + threadIdx.x;
    if (R * CH % NT != 0 && i >= R * CH) break;
    const int r = (i >> 3) / CH * 8 + (i & 7), c8 = (i >> 3) % CH;
    const bool ok = row0 + r < rows;
    cp_async16(dst + cm_off<CH>(r, c8),
               ok ? src + (row0 + r) * D + c8 * 8 : src, ok ? 16 : 0);
  }
}

// ---------------------------------------------------------------------------
// flash_fwd, bf16 on wgmma. CTA (batch*head, ROWS-row Q tile), the tile
// with the most key tiles first (blockIdx.y = 0 takes the last Q tile):
// RWG * CG consumer warpgroups and one producer warpgroup. Consumer i owns
// Q rows (i % RWG)*64 .. +63 of the tile and their O columns (i / RWG)*DW
// .. +DW-1 (col_groups: at d 256 two warpgroups form the same S and each
// keeps half of O): S = Q K^T (m64nBKk16, Q and K K-major from shared
// memory) and O += P V (P rounded to bf16, the register A operand from S's
// accumulator; V read MN-major through the descriptor's transpose bit), O
// and the row statistics in registers. Thread (warp w, lane g*4 + c)
// holds rows 16w + g and 16w + g + 8 of its 64, so a row's max reduces
// over the 4 lanes of a quad; its sum is kept a lane and reduced once,
// after the last tile. The producer fills Q once and a ring of NS stages
// of K and V by TMA; full/empty mbarriers pace the two sides. use_shift
// runs the constant-shift pass first and redoes the CTA's tile online
// only when a row's sum left [SUM_LO, SUM_HI].

// OR of `pred` over the n threads that reach named barrier id.
__device__ __forceinline__ bool bar_or(int id, int n, bool pred) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred q, p;\nsetp.ne.u32 q, %1, 0;\n"
      "bar.red.or.pred p, %2, %3, q;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(r)
      : "r"((uint32_t)pred), "r"(id), "r"(n)
      : "memory");
  return r != 0;
}

// The shift pass's row sum is kept when it lies in [2^-64, 2^64]: every
// weight that matters is then a normal float and P V cannot overflow.
constexpr float SUM_LO = 0x1p-64f, SUM_HI = 0x1p64f;

__device__ __forceinline__ bool bad_sum(float l) {
  return !(l >= SUM_LO && l <= SUM_HI);  // also inf, 0 and NaN
}

template <int D>
struct Fwd {
  static constexpr int CG = col_groups<D>();
  static constexpr int RWG = D <= 128 ? 2 : 1;  // row warpgroups
  static constexpr int CWG = RWG * CG;          // consumer warpgroups
  static constexpr int ROWS = 64 * RWG;
  static constexpr int NT = 128 * (CWG + 1);    // and the producer's
  // keys a tile; BK >= ROWS, so that every key tile below a CTA's causal
  // bound reaches into every warpgroup's rows
  static constexpr int BK = D <= 128 ? 128 : 64;
  static_assert(BK >= ROWS, "a warpgroup would skip whole key tiles");
  static constexpr int NS = 2;                   // ring stages
  static constexpr int TILE_Q = ROWS * D * 2;
  static constexpr int TILE_K = BK * D * 2;      // bytes of a K or V tile
  // tiles as blocks of SW-byte rows (SW/2 columns) in wgmma's SW-byte
  // swizzle, one TMA box a block; LAYOUT is the descriptors' swizzle code
  static constexpr int SW = D >= 64 ? 128 : 64;
  static constexpr int CB = D * 2 / SW;
  static constexpr int LAYOUT = SW == 128 ? 1 : 2;
  // Q, the ring, then the mbarriers: full and empty a stage, Q's, and the
  // redo decision's (with its flag); and room to align the tiles to 1024
  // bytes (the swizzle's period)
  static constexpr int BARS = TILE_Q + 2 * NS * TILE_K;
  static constexpr size_t smem() { return 1024 + BARS + (2 * NS + 3) * 8; }
};

// exp2 on the special-function unit, subnormal results flushed to zero:
// a weight below 2^-126 of the row's max (or, in shift mode, of 2^shift)
// adds nothing a float32 sum of the row keeps.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// P in place of S for the lane's rows r0 (accumulator elements i with
// i & 2 == 0) and r0 + 8, keys n0 + (i >> 2) * 8 + c2 + (i & 1):
// exp2(s * scale_log2 - m), the scale folded into one FMA, against the
// running max m (ONLINE, taken over the unscaled scores: the scale is
// positive; al0, al1 rescale O) or the constant shift held in mx0, mx1;
// NEG_INF where masked (MASKED: the causal diagonal or the ragged edge
// crosses the warp's rows); l0, l1 are the lane's share of the row sums.
template <bool MASKED, bool ONLINE, int R>
__device__ __forceinline__ void fwd_p(float (&s)[R], float& mx0, float& mx1,
                                      float& l0, float& l1, float& al0,
                                      float& al1, int64_t n0, int c2,
                                      int64_t r0, int64_t sk, int causal,
                                      float scale_log2) {
  float tm0 = NEG_INF, tm1 = NEG_INF;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (MASKED) {
      const int64_t key = n0 + (i >> 2) * 8 + c2 + (i & 1);
      if (key >= sk || (causal && key > r0 + (i & 2) * 4)) s[i] = NEG_INF;
    }
    if (ONLINE) {
      if (i & 2) tm1 = fmaxf(tm1, s[i]);
      else tm0 = fmaxf(tm0, s[i]);
    }
  }
  al0 = al1 = 1.f;
  if (ONLINE) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, off));
      tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, off));
    }
    const float mn0 = fmaxf(mx0, tm0 * scale_log2);
    const float mn1 = fmaxf(mx1, tm1 * scale_log2);
    al0 = ex2(mx0 - mn0);
    al1 = ex2(mx1 - mn1);
    mx0 = mn0;
    mx1 = mn1;
  }
  const float b0 = -mx0, b1 = -mx1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float p = ex2(fmaf(s[i], scale_log2, i & 2 ? b1 : b0));
    s[i] = p;
    if (i & 2) rs1 += p;
    else rs0 += p;
  }
  l0 = l0 * al0 + rs0;
  l1 = l1 * al1 + rs1;
}

template <int D>
__global__ void __launch_bounds__(Fwd<D>::NT, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
               float* __restrict__ lse, int64_t sq, int64_t sk, int causal,
               float scale_log2, int use_shift, float shift) {
  using C = Fwd<D>;
  constexpr int BK = C::BK, NS = C::NS, CT = 128 * C::CWG;
  constexpr int DW = D / C::CG;   // O columns a consumer warpgroup
  constexpr int SW = C::SW, QB = C::ROWS * SW, KB = BK * SW;  // block bytes
  extern __shared__ __align__(1024) unsigned char fwd_smem[];
  unsigned char* qs =
      fwd_smem + ((1024 - (smem_u32(fwd_smem) & 1023)) & 1023);
  unsigned char* ring = qs + C::TILE_Q;  // stage s: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(qs + C::BARS);
  uint64_t* empty = full + NS;
  uint64_t* qbar = empty + NS;
  uint64_t* redo_bar = qbar + 1;
  int* redo_flag = reinterpret_cast<int*>(redo_bar + 1);
  const int bh = blockIdx.x;
  const int64_t m0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * C::ROWS;
  const int wgi = threadIdx.x >> 7;
  const int64_t n_end = causal && m0 + C::ROWS < sk ? m0 + C::ROWS : sk;
  const int64_t tiles = (n_end + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, CT);
    }
    mbar_init(qbar, 1);
    mbar_init(redo_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == C::CWG) {
    // the producer: one thread keeps the ring full by TMA, a column block
    // of a tile a copy; tile t goes to stage t % NS once the consumers
    // have released the tile NS before it
    setmaxnreg_dec<24>();
    if (threadIdx.x == 128 * C::CWG) {
      mbar_expect_tx(qbar, C::TILE_Q);
      for (int j = 0; j < C::CB; ++j)
        tma_box(qs + j * QB, &tq, j * SW / 2, (int)m0, bh, qbar);
      int seq = 0;
      for (int pass = use_shift ? 0 : 1; pass < 2; ++pass) {
        for (int64_t it = 0; it < tiles; ++it, ++seq) {
          const int st = seq % NS;
          if (seq >= NS) mbar_wait(empty + st, (seq / NS - 1) & 1);
          unsigned char* ks = ring + st * 2 * C::TILE_K;
          mbar_expect_tx(full + st, 2 * C::TILE_K);
          for (int j = 0; j < C::CB; ++j) {
            tma_box(ks + j * KB, &tk, j * SW / 2, (int)(it * BK), bh,
                    full + st);
            tma_box(ks + C::TILE_K + j * KB, &tv, j * SW / 2, (int)(it * BK),
                    bh, full + st);
          }
        }
        if (pass == 0) {  // the consumers' verdict on the shift pass
          mbar_wait(redo_bar, 0);
          if (!*redo_flag) break;
        }
      }
    }
    return;
  }

  // the consumers
  setmaxnreg_inc<240>();
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, c2 = (lane & 3) * 2;
  const int rw = (wgi % C::RWG) * 64 + warp * 16;  // the warp's first row
  const int cb = (wgi / C::RWG) * DW;  // the warpgroup's first O column
  const int qo = (rw - warp * 16) * SW;  // its 64 rows in Q
  const int64_t r0 = m0 + rw + g, r1 = r0 + 8;
  mbar_wait(qbar, 0);

  float o[DW / 2];
  float mx0, mx1, l0, l1;
  int seq = 0;
  for (int pass = use_shift ? 0 : 1; pass < 2; ++pass) {
    const bool online = pass == 1;
#pragma unroll
    for (int i = 0; i < DW / 2; ++i) o[i] = 0.f;
    mx0 = mx1 = online ? -INFINITY : shift;
    l0 = l1 = 0.f;
    for (int64_t it = 0; it < tiles; ++it, ++seq) {
      const int64_t n0 = it * BK;
      const int st = seq % NS;
      mbar_wait(full + st, (seq / NS) & 1);
      const unsigned char* ks = ring + st * 2 * C::TILE_K;
      const unsigned char* vs = ks + C::TILE_K;

      // S = Q K^T: the warpgroup's 64 rows x BK keys
      float s[BK / 2];
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        wgmma_ss<BK, 0, 0>(
            s,
            gmma_desc_sw(qs + kc * 32 / SW * QB + qo + kc * 32 % SW, 16,
                         8 * SW, C::LAYOUT),
            gmma_desc_sw(ks + kc * 32 / SW * KB + kc * 32 % SW, 16, 8 * SW,
                         C::LAYOUT),
            kc > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
      // only the diagonal and the ragged last tile take the per-element
      // mask (rows past sq are never written)
      const bool masked = (causal && n0 + BK - 1 > m0 + rw) || n0 + BK > sk;
      float al0, al1;
#define FWD_P(M, O)                                                       \
  fwd_p<M, O>(s, mx0, mx1, l0, l1, al0, al1, n0, c2, r0, sk, causal, \
              scale_log2)
      if (online) {
        if (masked) FWD_P(true, true);
        else FWD_P(false, true);
#pragma unroll
        for (int i = 0; i < DW / 2; ++i) o[i] *= i & 2 ? al1 : al0;
      } else {
        if (masked) FWD_P(true, false);
        else FWD_P(false, false);
      }
#undef FWD_P
      // O += P V (P rounded to bf16; V read MN-major)
      wg_fence();
#pragma unroll
      for (int cc = 0; cc < BK / 16; ++cc) {
        uint32_t a[4];
        acc_to_a(a, s, cc);
        wgmma_rs<DW, 1>(o, a,
                        gmma_desc_sw(vs + cb * 2 / SW * KB + cc * 16 * SW,
                                     KB, 8 * SW, C::LAYOUT),
                        1);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(o);
      mbar_arrive(empty + st);  // the stage is read
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    if (!online) {
      // redo the CTA's tile online when any row's sum left the range
      const bool bad = (r0 < sq && bad_sum(l0)) || (r1 < sq && bad_sum(l1));
      const bool redo = bar_or(1, CT, bad);
      if (threadIdx.x == 0) {
        *redo_flag = redo;
        mbar_arrive(redo_bar);
      }
      if (!redo) break;  // every row of the tile is final
    }
  }

  bf16* ob = out + (int64_t)bh * sq * D;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int t = 0; t < DW / 8; ++t) {
    const int col = cb + t * 8 + c2;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * D + col) =
          pack_bf16(o[4 * t] * inv0, o[4 * t + 1] * inv0);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * D + col) =
          pack_bf16(o[4 * t + 2] * inv1, o[4 * t + 3] * inv1);
  }
  if ((lane & 3) == 0 && cb == 0) {
    if (r0 < sq) lse[(int64_t)bh * sq + r0] = mx0 * LN2 + logf(l0);
    if (r1 < sq) lse[(int64_t)bh * sq + r1] = mx1 * LN2 + logf(l1);
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
// flash_bwd and flash_bwd_dkv, bf16 on wgmma. CTA (batch*head, KEYS-key
// tile), blockIdx.y = 0 first: under the causal mask it walks the most Q
// tiles. Warpgroup i owns keys (i % KWG)*64 .. +63 for S^T and dP^T and
// columns (i / KWG)*DW .. +DW-1 of those keys' dk and dv (col_groups).
// Shared memory, every tile in cm_off order: K and V for the CTA's life;
// a ring of two stages, each one 64-row Q step (Q and dO, the rows' lse
// and delta), filled by cp.async while the other stage's products run;
// and, with DQ, the step's dS^T ([key][q]).

// Keys a CTA (128: two warpgroups, where the registers allow); Q rows a
// step (and a stage of the ring).
template <int D>
__host__ __device__ constexpr int bwd_keys() {
  return D <= 128 ? 128 : 64;
}
constexpr int BQ = 64;

template <int D, bool DQ>
struct BwdKv {
  static constexpr int CG = col_groups<D>();
  static constexpr int KEYS = bwd_keys<D>();
  static constexpr int KWG = KEYS / 64;       // warpgroups a column group
  static constexpr int NWG = KWG * CG;
  static constexpr int NT = 128 * NWG;
  static constexpr int CH = D / 8;            // 16-byte chunks a row
  // S^T and dP^T rows (Q rows) a warpgroup holds at once: where the dk
  // and dv accumulators take 128 registers (d 256, and d 128 beside dq's
  // part) the step runs in halves, so that nothing spills
  static constexpr int QSUB = D > 128 || (DQ && D == 128) ? 32 : 64;
  static constexpr int TILE_Q = BQ * D * 2;   // bytes of a Q or dO tile
  static constexpr int STAGE = 2 * TILE_Q + 2 * BQ * 4;
  static constexpr int TILE_K = KEYS * D * 2;
  static constexpr int DSS = KEYS * BQ * 2;   // dS^T [key][q]
  static constexpr size_t smem() {
    return 2 * TILE_K + 2 * STAGE + (DQ ? DSS : 0);
  }
};

// P^T and dS^T in place of S^T and dP^T for the lane's keys key0 and
// key0 + 8 and the Q rows from q0 of the step at m0 (accumulator element
// i: key row (i >> 1) & 1, column (i >> 2) * 8 + c2 + (i & 1)): P from
// lse in base 2, dS = P o (dP - delta) * scale. MASKED: the causal
// diagonal or a ragged edge crosses the warp's block.
template <bool MASKED, int R>
__device__ __forceinline__ void p_ds_t(float (&st)[R], float (&dpt)[R],
                                       const float* ls, const float* dls,
                                       int q0, int c2, int64_t key0,
                                       int64_t m0, int64_t sq, int64_t sk,
                                       int causal, float scale_log2,
                                       float scale) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int ql = q0 + (i >> 2) * 8 + c2 + (i & 1);
    float p = exp2f(st[i] * scale_log2 - ls[ql] * LOG2E);
    if (MASKED) {
      const int64_t key = key0 + ((i >> 1) & 1) * 8, row = m0 + ql;
      if (key >= sk || row >= sq || (causal && key > row)) p = 0.f;
    }
    st[i] = p;
    dpt[i] = p * (dpt[i] - dls[ql]) * scale;
  }
}

template <int D, bool DQ>
__global__ void __launch_bounds__(BwdKv<D, DQ>::NT)
flash_bwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, bf16* __restrict__ dk,
               bf16* __restrict__ dv, int64_t sq, int64_t sk, int causal,
               float scale_log2, float scale) {
  using C = BwdKv<D, DQ>;
  constexpr int KEYS = C::KEYS, NT = C::NT, CH = C::CH, QSUB = C::QSUB;
  constexpr int DW = D / C::CG;  // dk, dv columns a warpgroup
  constexpr int KS = CH * 128;   // bytes between 8-row groups of a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ks = smem_raw;
  unsigned char* vs = ks + C::TILE_K;
  unsigned char* ring = vs + C::TILE_K;
  unsigned char* dss = ring + 2 * C::STAGE;
  const int64_t bh = blockIdx.x;
  const int64_t n0 = (int64_t)blockIdx.y * KEYS;
  const bf16* qb = q + bh * sq * D;
  const bf16* dob = dout + bh * sq * D;
  const float* lb = lse + bh * sq;
  const float* db = delta + bh * sq;
  const int wgi = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, c2 = (lane & 3) * 2;
  const int kw0 = (wgi % C::KWG) * 64;  // this warpgroup's first key
  const int cb = (wgi / C::KWG) * DW;   // its first dk/dv column
  const int kl = kw0 + warp * 16 + g;   // the lane's keys: kl, kl + 8
  const int64_t key0 = n0 + kl;

  auto load_step = [&](int s, int64_t m0) {
    unsigned char* st = ring + s * C::STAGE;
    cp_tile<D, BQ, NT>(st, qb, m0, sq);
    cp_tile<D, BQ, NT>(st + C::TILE_Q, dob, m0, sq);
    float* ls = reinterpret_cast<float*>(st + 2 * C::TILE_Q);
    const int t = threadIdx.x & (BQ - 1);
    const bool ok = m0 + t < sq;
    if (threadIdx.x < BQ)
      cp_async4(ls + t, ok ? lb + m0 + t : lb, ok ? 4 : 0);
    else if (threadIdx.x < 2 * BQ)
      cp_async4(ls + BQ + t, ok ? db + m0 + t : db, ok ? 4 : 0);
  };

  const int64_t m_begin = causal ? n0 : 0;
  const int64_t steps = m_begin < sq ? (sq - m_begin + BQ - 1) / BQ : 0;
  cp_tile<D, KEYS, NT>(ks, k + bh * sk * D, n0, sk);
  cp_tile<D, KEYS, NT>(vs, v + bh * sk * D, n0, sk);
  if (steps > 0) load_step(0, m_begin);
  cp_async_commit();

  float dka[DW / 2], dva[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int64_t it = 0; it < steps; ++it) {
    const int64_t m0 = m_begin + it * BQ;
    cp_async_wait_all();
    __syncthreads();  // step it has landed; step it-1's stage is free
    if (it + 1 < steps) load_step((it + 1) & 1, m0 + BQ);
    cp_async_commit();
    const unsigned char* qs = ring + (it & 1) * C::STAGE;
    const unsigned char* dos = qs + C::TILE_Q;
    const float* ls = reinterpret_cast<const float*>(qs + 2 * C::TILE_Q);
    const float* dls = ls + BQ;
    // only the diagonal and the ragged edges take the per-element mask
    const bool masked = (causal && n0 + kl - g + 15 > m0) || m0 + BQ > sq ||
                        n0 + kl - g + 16 > sk;

#pragma unroll
    for (int h = 0; h < BQ / QSUB; ++h) {
      // S^T = K Q^T and dP^T = V dO^T: the warpgroup's 64 keys x QSUB rows
      float st[QSUB / 2], dpt[QSUB / 2];
      const int ka = (kw0 / 8) * KS, qa = (h * QSUB / 8) * KS;
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        wgmma_ss<QSUB, 0, 0>(st, gmma_desc(ks + ka + kc * 256, 128, KS),
                             gmma_desc(qs + qa + kc * 256, 128, KS), kc > 0);
        wgmma_ss<QSUB, 0, 0>(dpt, gmma_desc(vs + ka + kc * 256, 128, KS),
                             gmma_desc(dos + qa + kc * 256, 128, KS), kc > 0);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      if (masked)
        p_ds_t<true>(st, dpt, ls, dls, h * QSUB, c2, key0, m0, sq, sk, causal,
                     scale_log2, scale);
      else
        p_ds_t<false>(st, dpt, ls, dls, h * QSUB, c2, key0, m0, sq, sk,
                      causal, scale_log2, scale);
      // dv += P^T dO and dk += dS^T Q (P and dS rounded to bf16; the
      // accumulators of S^T and dP^T are the A fragments)
      wg_fence();
#pragma unroll
      for (int cc = 0; cc < QSUB / 16; ++cc) {
        uint32_t pa[4], sa[4];
        acc_to_a(pa, st, cc);
        acc_to_a(sa, dpt, cc);
        const int off = qa + cc * 2 * KS + (cb / 8) * 128;
        wgmma_rs<DW, 1>(dva, pa, gmma_desc(dos + off, KS, 128), 1);
        wgmma_rs<DW, 1>(dka, sa, gmma_desc(qs + off, KS, 128), 1);
        if constexpr (DQ) {
          // dS^T rows kl, kl + 8 into [key][q], by one column group
          if (cb == 0) {
            const int qc = h * QSUB + cc * 16 + c2;
            auto put = [&](int key, int qq, uint32_t x) {
              *reinterpret_cast<uint32_t*>(dss + cm_off<BQ / 8>(key, qq / 8) +
                                           (qq & 7) * 2) = x;
            };
            put(kl, qc, sa[0]);
            put(kl + 8, qc, sa[1]);
            put(kl, qc + 8, sa[2]);
            put(kl + 8, qc + 8, sa[3]);
          }
        }
      }
      wg_commit();
      wg_wait<0>();
    }
    if constexpr (DQ) {
      // dq += dS K for the step's 64 rows, summed into the float32 buffer
      // by atomics: warpgroup i takes DQN columns, all 64 rows
      constexpr int DQN = D / C::NWG;
      constexpr int DSK = BQ / 8 * 128;  // dS^T bytes between 8 keys
      fence_proxy_async();
      __syncthreads();  // dS^T is complete
      float acc[DQN / 2];
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < KEYS / 16; ++kc)
        wgmma_ss<DQN, 1, 1>(acc, gmma_desc(dss + kc * 2 * DSK, DSK, 128),
                            gmma_desc(ks + kc * 2 * KS + (wgi * DQN / 8) * 128,
                                      KS, 128),
                            kc > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
      // one 16-byte atomic a lane an n-tile: lanes c and c^1 swap halves,
      // the even lane then adds four columns of row g, the odd of g + 8
      const bool even = (lane & 1) == 0;
      const int64_t row = m0 + warp * 16 + g + (even ? 0 : 8);
#pragma unroll
      for (int j = 0; j < DQN / 8; ++j) {
        const float* a = acc + 4 * j;
        const float x0 = __shfl_xor_sync(0xffffffffu, even ? a[2] : a[0], 1);
        const float x1 = __shfl_xor_sync(0xffffffffu, even ? a[3] : a[1], 1);
        if (row < sq)
          atomicAdd(reinterpret_cast<float4*>(
                        dq + (bh * sq + row) * D + wgi * DQN + j * 8 +
                        (c2 & 4)),
                    even ? make_float4(a[0], a[1], x0, x1)
                         : make_float4(x0, x1, a[2], a[3]));
      }
    }
  }
  cp_async_wait_all();
#pragma unroll
  for (int j = 0; j < DW / 8; ++j) {
    const int col = cb + j * 8 + c2;
    if (key0 < sk) {
      *reinterpret_cast<uint32_t*>(dk + (bh * sk + key0) * D + col) =
          pack_bf16(dka[4 * j], dka[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(dv + (bh * sk + key0) * D + col) =
          pack_bf16(dva[4 * j], dva[4 * j + 1]);
    }
    if (key0 + 8 < sk) {
      *reinterpret_cast<uint32_t*>(dk + (bh * sk + key0 + 8) * D + col) =
          pack_bf16(dka[4 * j + 2], dka[4 * j + 3]);
      *reinterpret_cast<uint32_t*>(dv + (bh * sk + key0 + 8) * D + col) =
          pack_bf16(dva[4 * j + 2], dva[4 * j + 3]);
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
// flash_bwd_dq, bf16 on wgmma. CTA (batch*head, ROWS-row Q tile), the tile
// with the most key tiles first (blockIdx.y = 0 takes the last Q tile).
// Warpgroup i forms S and dP for rows (i % RWG)*64 .. +63 and owns their
// dq columns (i / RWG)*DW .. +DW-1 (col_groups); thread (warp w, lane
// g*4 + c) holds rows 16w + g and 16w + g + 8 of its 64. Q and dO stay in
// shared memory; a ring of two stages of 64-key K and V tiles, shared by
// the row warpgroups, is filled by cp.async while the other stage's
// products run (a third stage measured no faster); every tile in cm_off
// order. dS rounded to bf16 is
// the register A operand of dq += dS K, which reads K MN-major.

template <int D>
struct BwdQ {
  static constexpr int CG = col_groups<D>();
  static constexpr int RWG = D <= 128 ? 2 : 1;  // row warpgroups
  static constexpr int ROWS = 64 * RWG;
  static constexpr int NT = 128 * RWG * CG;
  static constexpr int CH = D / 8;
  static constexpr int TILE = BN * D * 2;  // bytes of a 64-row tile
  static constexpr size_t smem() { return 2 * RWG * TILE + 2 * 2 * TILE; }
};

template <int D>
__global__ void __launch_bounds__(BwdQ<D>::NT)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int64_t sq, int64_t sk, int causal, float scale_log2,
                  float scale) {
  using C = BwdQ<D>;
  constexpr int NT = C::NT, TILE = C::TILE, ROWS = C::ROWS;
  constexpr int DW = D / C::CG;   // dq columns a warpgroup
  constexpr int KS = C::CH * 128; // bytes between 8-row groups of a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs = smem_raw;
  unsigned char* dos = qs + C::RWG * TILE;
  unsigned char* ring = dos + C::RWG * TILE;  // stage s: K, then V
  const int64_t bh = blockIdx.x;
  const int64_t m0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * ROWS;
  const bf16* kb = k + bh * sk * D;
  const bf16* vb = v + bh * sk * D;
  const int wgi = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, c2 = (lane & 3) * 2;
  const int rw = (wgi % C::RWG) * 64 + warp * 16;  // the warp's first row
  const int cb = (wgi / C::RWG) * DW;  // the warpgroup's first dq column
  const int qo = (rw - warp * 16) / 8 * KS;  // its 64 rows in Q and dO
  const int64_t r0 = m0 + rw + g, r1 = r0 + 8;
  // the warpgroup's last row: key tiles past it are masked out whole
  const int64_t wg_last = m0 + rw - warp * 16 + 63;

  auto load_kv = [&](int s, int64_t n0) {
    unsigned char* kst = ring + s * 2 * TILE;
    cp_tile<D, BN, NT>(kst, kb, n0, sk);
    cp_tile<D, BN, NT>(kst + TILE, vb, n0, sk);
  };
  const int64_t n_end = causal && m0 + ROWS < sk ? m0 + ROWS : sk;
  const int64_t tiles = (n_end + BN - 1) / BN;
  cp_tile<D, ROWS, NT>(qs, q + bh * sq * D, m0, sq);
  cp_tile<D, ROWS, NT>(dos, dout + bh * sq * D, m0, sq);
  if (tiles > 0) load_kv(0, 0);
  cp_async_commit();
  const float l2_0 = r0 < sq ? lse[bh * sq + r0] * LOG2E : 0.f;
  const float l2_1 = r1 < sq ? lse[bh * sq + r1] * LOG2E : 0.f;
  const float de0 = r0 < sq ? delta[bh * sq + r0] : 0.f;
  const float de1 = r1 < sq ? delta[bh * sq + r1] : 0.f;
  float dqa[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) dqa[i] = 0.f;

  for (int64_t it = 0; it < tiles; ++it) {
    const int64_t n0 = it * BN;
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; tile it-1's stage is free
    if (it + 1 < tiles) load_kv((it + 1) & 1, n0 + BN);
    cp_async_commit();
    if (causal && n0 > wg_last) continue;  // every key above every row
    const unsigned char* ks = ring + (it & 1) * 2 * TILE;
    const unsigned char* vs = ks + TILE;

    // S = Q K^T, then dP = dO V^T: the warpgroup's 64 rows x 64 keys; P
    // is formed while dP runs, then dS in place of S. Only the diagonal
    // and the ragged last tile take the per-element mask (rows past sq
    // are never written).
    float s[BN / 2], dp[BN / 2];
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      wgmma_ss<BN, 0, 0>(s, gmma_desc(qs + qo + kc * 256, 128, KS),
                         gmma_desc(ks + kc * 256, 128, KS), kc > 0);
    wg_commit();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      wgmma_ss<BN, 0, 0>(dp, gmma_desc(dos + qo + kc * 256, 128, KS),
                         gmma_desc(vs + kc * 256, 128, KS), kc > 0);
    wg_commit();
    wg_wait<1>();
    fence_regs(s);
    const bool masked = (causal && n0 + BN - 1 > m0 + rw) || n0 + BN > sk;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const bool lo = (i & 2) == 0;  // row r0, else r1
      float p = exp2f(s[i] * scale_log2 - (lo ? l2_0 : l2_1));
      if (masked) {
        const int64_t key = n0 + (i >> 2) * 8 + c2 + (i & 1);
        if (key >= sk || (causal && key > (lo ? r0 : r1))) p = 0.f;
      }
      s[i] = p;
    }
    wg_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      s[i] = s[i] * (dp[i] - ((i & 2) == 0 ? de0 : de1)) * scale;
    // dq += dS K (dS rounded to bf16)
    wg_fence();
#pragma unroll
    for (int cc = 0; cc < BN / 16; ++cc) {
      uint32_t a[4];
      acc_to_a(a, s, cc);
      wgmma_rs<DW, 1>(dqa, a,
                      gmma_desc(ks + cc * 2 * KS + (cb / 8) * 128, KS, 128),
                      1);
    }
    wg_commit();
    wg_wait<0>();
  }
  cp_async_wait_all();
  bf16* dqb = dq + bh * sq * D;
#pragma unroll
  for (int j = 0; j < DW / 8; ++j) {
    const int col = cb + j * 8 + c2;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(dqb + r0 * D + col) =
          pack_bf16(dqa[4 * j], dqa[4 * j + 1]);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(dqb + r1 * D + col) =
          pack_bf16(dqa[4 * j + 2], dqa[4 * j + 3]);
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
// Warp reductions of the decode steps.

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

// The decode steps, a row's past columns split across CTAs
// (flash-decoding). CTA (row, split) of SPLIT_THREADS threads walks
// columns [split * span, min((split + 1) * span, cur)), span = ceil(cur /
// splits), whose K and V lines it sends to L2 as it starts: Cols<E>::LANES
// lanes cover a 128-wide chunk of a column, 16 bytes a lane, so the CTA
// reads GROUPS columns a load and each lane keeps UNROLL loads in
// flight; a column's dot product reduces over its lanes.
// The split's logits sit in shared memory, then its max m, its sum l of
// exp(logit - m) and its value partial acc[dh] = sum_t w_t v_t (V read
// in a second pass, its lines prefetched into L2 during the first) go to
// a float32 workspace, (dh + 2) floats a split. The last CTA of the row
// (an atomic count, reset to 0 after) adds the t == cur term from the
// fresh column, merges the partials by log-sum-exp and writes the row.
// Split 0 writes the fresh column at cur; no CTA reads column cur from
// the cache.

constexpr int SPLIT_THREADS = 128;                     // 4 warps
constexpr int SPLIT_WARPS = SPLIT_THREADS / 32;

static_assert(SPLIT_THREADS == 128, "a thread a dim of each 128-wide chunk");

// A 16-byte load of cache elements E: EPL elements, LANES lanes a
// 128-wide chunk of a column, GROUPS columns a CTA a load.
template <typename E>
struct Cols {
  static constexpr int EPL = 16 / (int)sizeof(E);
  static constexpr int LANES = 128 / EPL;
  static constexpr int GROUPS = SPLIT_THREADS / LANES;
};

// The elements of a 16-byte load, as floats.
template <typename E>
__device__ __forceinline__ void unpack16(const int4 raw,
                                         float (&x)[Cols<E>::EPL]) {
  const int w[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (sizeof(E) == 1) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      x[j] = (float)((int)((unsigned)w[j >> 2] << (24 - 8 * (j & 3))) >> 24);
  } else if constexpr (sizeof(E) == 2) {  // bf16: the top half of a float
#pragma unroll
    for (int j = 0; j < 8; ++j)
      x[j] = __uint_as_float(j & 1 ? (unsigned)w[j >> 1] & 0xffff0000u
                                   : (unsigned)w[j >> 1] << 16);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = __int_as_float(w[j]);
  }
}

// Reductions over the CTA's SPLIT_THREADS through red[SPLIT_WARPS];
// every thread gets the result.
template <bool MAX>
__device__ __forceinline__ float cta_reduce(float x, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  x = MAX ? warp_max(x) : warp_sum(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float y = red[0];
#pragma unroll
  for (int w = 1; w < SPLIT_WARPS; ++w) y = MAX ? fmaxf(y, red[w]) : y + red[w];
  __syncthreads();
  return y;
}

// Shared memory a split CTA: q (dh), red, the value partials, and the
// split's logits (at least two a split, for the merge's statistics).
size_t split_smem(int dh, int64_t span, int splits) {
  const int64_t wn = span > 2 * splits ? span : 2 * splits;
  return sizeof(float) *
         ((size_t)dh + SPLIT_WARPS + SPLIT_WARPS * 128 + (size_t)wn);
}

// The split's columns of K, then of V, contiguous in the caches, sent to
// L2: the passes below then read L2, the bytes of every split are in
// flight at once, and K's arrive first. The bf16 step sends them as it
// starts, before its RoPE (0.6 us ahead of sending them after RoPE's
// loads, on the card); the int8 step after its first loads. At most
// SPLIT_PREFETCH bytes of each (a
// long split's later V lines go to L2 during the K pass, its later K
// lines are read from device memory).
constexpr int64_t SPLIT_PREFETCH = 64 << 10;

template <typename E>
__device__ __forceinline__ void split_prefetch(const E* kcr, const E* vcr,
                                               int64_t t0, int64_t n,
                                               int dh) {
  const int64_t bytes = n * dh * (int64_t)sizeof(E);
  const int64_t lines =
      ((bytes < SPLIT_PREFETCH ? bytes : SPLIT_PREFETCH) + 127) / 128;
  const char* kb = reinterpret_cast<const char*>(kcr + t0 * dh);
  const char* vb = reinterpret_cast<const char*>(vcr + t0 * dh);
  for (int64_t i = threadIdx.x; i < lines; i += SPLIT_THREADS)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(kb + i * 128));
  for (int64_t i = threadIdx.x; i < lines; i += SPLIT_THREADS)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(vb + i * 128));
}

// w[i] = q . k_{t0 + i} for the split's n columns, a 128-wide chunk of
// each column a pass; the same lane group keeps a column across the
// passes. V's lines at the same offsets go to L2 for the second pass.
template <typename E, int UNROLL>
__device__ __forceinline__ void split_logits(const E* kcr, const E* vcr,
                                             int64_t t0, int64_t n, int dh,
                                             const float* qs, float* w) {
  using C = Cols<E>;
  const int grp = threadIdx.x / C::LANES, li = threadIdx.x % C::LANES;
  for (int ch = 0; ch < dh / 128; ++ch) {
    const int d0 = ch * 128 + li * C::EPL;
    float qv[C::EPL];
#pragma unroll
    for (int j = 0; j < C::EPL; ++j) qv[j] = qs[d0 + j];
    for (int64_t i0 = 0; i0 < n; i0 += C::GROUPS * UNROLL) {
      int4 raw[UNROLL];  // warp-uniform trip count: the shuffles below
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t i = i0 + u * C::GROUPS + grp;
        if (i < n) {
          const int64_t off = (t0 + i) * dh + d0;
          raw[u] = __ldg(reinterpret_cast<const int4*>(kcr + off));
          // one lane a 128-byte line past split_prefetch's window
          if (li % 8 == 0 &&
              (i * dh + d0) * (int64_t)sizeof(E) >= SPLIT_PREFETCH)
            asm volatile("prefetch.global.L2 [%0];\n" ::"l"(vcr + off));
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t i = i0 + u * C::GROUPS + grp;
        float kx[C::EPL];
        unpack16<E>(i < n ? raw[u] : make_int4(0, 0, 0, 0), kx);
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < C::EPL; ++j) acc += qv[j] * kx[j];
#pragma unroll
        for (int off = 1; off < C::LANES; off <<= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (li == 0 && i < n) w[i] = ch ? w[i] + acc : acc;
      }
    }
  }
}

// The split's value partial sum_i w[i] v_{t0 + i} into wsr[2 .. dh + 2),
// a 128-wide chunk of dh a pass: over the lanes of a column's chunk, then
// the warp's lane groups, then the warps (through part).
template <typename E, int UNROLL>
__device__ __forceinline__ void split_values(const E* vcr, int64_t t0,
                                             int64_t n, int dh,
                                             const float* w, float* part,
                                             float* wsr) {
  using C = Cols<E>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = tid / C::LANES, li = tid % C::LANES;
  for (int ch = 0; ch < dh / 128; ++ch) {
    const int d0 = ch * 128 + li * C::EPL;
    float acc[C::EPL];
#pragma unroll
    for (int j = 0; j < C::EPL; ++j) acc[j] = 0.f;
    for (int64_t i0 = 0; i0 < n; i0 += C::GROUPS * UNROLL) {
      int4 raw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t i = i0 + u * C::GROUPS + grp;
        if (i < n)
          raw[u] = __ldg(reinterpret_cast<const int4*>(vcr + (t0 + i) * dh +
                                                      d0));
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t i = i0 + u * C::GROUPS + grp;
        if (i < n) {
          const float wt = w[i];
          float vx[C::EPL];
          unpack16<E>(raw[u], vx);
#pragma unroll
          for (int j = 0; j < C::EPL; ++j) acc[j] += wt * vx[j];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < C::EPL; ++j)
#pragma unroll
      for (int off = C::LANES; off < 32; off <<= 1)
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
    if (lane < C::LANES)
#pragma unroll
      for (int j = 0; j < C::EPL; ++j) part[warp * 128 + li * C::EPL + j] = acc[j];
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int ww = 0; ww < SPLIT_WARPS; ++ww) s += part[ww * 128 + tid];
    wsr[2 + ch * 128 + tid] = s;
    __syncthreads();
  }
}

// After the CTA's partial is written: whether it is the last of `count`
// CTAs to arrive at *ctr (which the last one resets after its merge).
__device__ __forceinline__ bool arrive_last(unsigned* ctr, int count) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ctr, 1u) == (unsigned)count - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The last CTA's merge of a row: the splits' (m, l, acc) at wrow, (dh +
// 2) floats each, and the t == cur term (logit lc, values vcur), by
// log-sum-exp. The splits' maxima and sums come to w[0, 2 splits) in one
// round trip, the maxima then replaced by the rescales; a thread's value
// loads are issued four splits at a time. The sums run in split order.
template <typename TV, typename TO>
__device__ __forceinline__ void merge_splits(const float* wrow, int splits,
                                             int dh, float lc,
                                             const TV* vcur, TO* outr,
                                             float* w) {
  const int tid = threadIdx.x;
  for (int s = tid; s < splits; s += SPLIT_THREADS) {
    w[s] = __ldcg(wrow + s * (dh + 2));
    w[splits + s] = __ldcg(wrow + s * (dh + 2) + 1);
  }
  __syncthreads();
  float mx = lc;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, w[s]);
  __syncthreads();  // every thread has read the maxima
  for (int s = tid; s < splits; s += SPLIT_THREADS) w[s] = expf(w[s] - mx);
  __syncthreads();
  const float ec = expf(lc - mx);
  float lt = ec;
  for (int s = 0; s < splits; ++s) lt += w[splits + s] * w[s];
  for (int d = tid; d < dh; d += SPLIT_THREADS) {
    float sum = 0.f;
#pragma unroll 4
    for (int s = 0; s < splits; ++s)
      sum += __ldcg(wrow + s * (dh + 2) + 2 + d) * w[s];
    sum += ec * to_f(vcur[d]);
    outr[d] = from_f<TO>(sum / lt);
  }
}

// Split-half RoPE of element d of a (dh,) row in float32: x * cos2 + rot
// * sin2, rot = [-x2, x1], the first product fused into the add, as XLA
// compiles the TPU kernel's form; the plain value without rope.
template <typename T>
__device__ __forceinline__ float rope_at(const T* x, const float* cos2,
                                         const float* sin2, int d, int dh,
                                         int rope) {
  const float xd = to_f(x[d]);
  if (!rope) return xd;
  const int h = dh / 2;
  const float rot = d < h ? -to_f(x[d + h]) : to_f(x[d - h]);
  return __fmaf_rn(xd, cos2[d], __fmul_rn(rot, sin2[d]));
}

// decode_step (B13), bf16 or float32 caches. Every CTA rotates q; split 0
// writes the rotated k and v at cur; the merging CTA rotates k again for
// the t == cur term, rounded to T as the written column is. A split's
// past weights exp(logit - m) are rounded to T against the split's own
// max m before the value product, where the TPU kernel rounds them
// against the row's max: at bf16 the two agree to a tolerance, not bit
// for bit (float32 rounds nothing; only the sum order differs).
constexpr int DS_UNROLL = 8;  // 16-byte loads in flight a lane

template <typename T>
__global__ void __launch_bounds__(SPLIT_THREADS)
decode_step_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ cos2,
                   const float* __restrict__ sin2, T* kc, T* vc,
                   T* __restrict__ out, float* ws, unsigned* counter,
                   int64_t total, int dh, int64_t cur, int rope,
                   float scale) {
  extern __shared__ __align__(16) float dsm[];
  float* qs = dsm;                      // rotated q, T values
  float* red = qs + dh;                 // SPLIT_WARPS
  float* part = red + SPLIT_WARPS;      // SPLIT_WARPS x 128 value partials
  float* w = part + SPLIT_WARPS * 128;  // the split's logits, then weights
  const int64_t row = blockIdx.x;
  const int split = blockIdx.y, splits = gridDim.y;
  const int tid = threadIdx.x;
  const T* qr = q + row * dh;
  const T* kr = k + row * dh;
  const T* vr = v + row * dh;
  T* kcr = kc + row * total * dh;
  T* vcr = vc + row * total * dh;
  const int64_t span = (cur + splits - 1) / splits;
  const int64_t t0 = split * span;
  const int64_t t1 = t0 + span < cur ? t0 + span : cur;
  const int64_t n = t1 > t0 ? t1 - t0 : 0;
  split_prefetch(kcr, vcr, t0, n, dh);

  // q and k rotated and rounded to T; this thread's share of the t ==
  // cur logit, which the merging CTA reduces
  float dot = 0.f;
  for (int d = tid; d < dh; d += SPLIT_THREADS) {
    const float qd = to_f(from_f<T>(rope_at(qr, cos2, sin2, d, dh, rope)));
    const T kt = from_f<T>(rope_at(kr, cos2, sin2, d, dh, rope));
    qs[d] = qd;
    dot += qd * to_f(kt);
    if (split == 0) {  // the cache columns, in place
      kcr[cur * dh + d] = kt;
      vcr[cur * dh + d] = vr[d];
    }
  }
  __syncthreads();
  split_logits<T, DS_UNROLL>(kcr, vcr, t0, n, dh, qs, w);
  __syncthreads();

  // the split's max and sum; its weights rounded to T
  float m = -INFINITY;
  for (int64_t i = tid; i < n; i += SPLIT_THREADS) {
    const float lg = w[i] * scale;
    w[i] = lg;
    m = fmaxf(m, lg);
  }
  m = cta_reduce<true>(m, red);
  float l = 0.f;
  for (int64_t i = tid; i < n; i += SPLIT_THREADS) {
    const float e = expf(w[i] - m);
    w[i] = to_f(from_f<T>(e));
    l += e;
  }
  l = cta_reduce<false>(l, red);  // its barrier publishes w[]
  float* wsr = ws + (row * splits + split) * (int64_t)(dh + 2);
  split_values<T, DS_UNROLL>(vcr, t0, n, dh, w, part, wsr);
  if (tid == 0) {
    wsr[0] = m;
    wsr[1] = l;
  }

  if (!arrive_last(counter + row, splits)) return;
  const float lc = cta_reduce<false>(dot, red) * scale;
  merge_splits(ws + row * splits * (int64_t)(dh + 2), splits, dh, lc, vr,
               out + row * dh, w);
  if (tid == 0) counter[row] = 0u;  // ready for the next call
}

// decode_step_q8 (B14): the same step over int8 caches, as the TPU's: q
// arrives rotated and the fresh column quantized (written in place at
// cur by split 0) and dequantized (the t == cur term, kdq and vdq); K's
// per-column float32 scale multiplies the int8 logit row, V's folds into
// the weights before the value product; float32 softmax and output.
constexpr int Q8_UNROLL = 8;

template <typename T>
__global__ void __launch_bounds__(SPLIT_THREADS)
decode_step_q8_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                      const int8_t* __restrict__ vq,
                      const float* __restrict__ kdq,
                      const float* __restrict__ vdq, int8_t* kc, int8_t* vc,
                      const float* __restrict__ ksc,
                      const float* __restrict__ vsc, float* __restrict__ out,
                      float* ws, unsigned* counter, int64_t total, int dh,
                      int64_t cur, float scale) {
  extern __shared__ __align__(16) float q8sm[];
  float* qs = q8sm;                     // q in float32
  float* red = qs + dh;                 // SPLIT_WARPS
  float* part = red + SPLIT_WARPS;      // SPLIT_WARPS x 128 value partials
  float* w = part + SPLIT_WARPS * 128;  // the split's logits, then weights
  const int64_t row = blockIdx.x;
  const int split = blockIdx.y, splits = gridDim.y;
  const int tid = threadIdx.x;
  const int8_t* kcr = kc + row * total * dh;
  const int8_t* vcr = vc + row * total * dh;
  const float* kscr = ksc + row * total;
  const float* vscr = vsc + row * total;
  const int64_t span = (cur + splits - 1) / splits;
  const int64_t t0 = split * span;
  const int64_t t1 = t0 + span < cur ? t0 + span : cur;
  const int64_t n = t1 > t0 ? t1 - t0 : 0;

  if (split == 0)  // the int8 column, in place
    for (int d = tid * 16; d < dh; d += SPLIT_THREADS * 16) {
      *reinterpret_cast<int4*>(kc + (row * total + cur) * dh + d) =
          *reinterpret_cast<const int4*>(kq + row * dh + d);
      *reinterpret_cast<int4*>(vc + (row * total + cur) * dh + d) =
          *reinterpret_cast<const int4*>(vq + row * dh + d);
    }
  // q; this thread's share of the t == cur logit
  float dot = 0.f;
  for (int d = tid; d < dh; d += SPLIT_THREADS) {
    qs[d] = to_f(q[row * dh + d]);
    dot += qs[d] * kdq[row * dh + d];
  }
  split_prefetch(kcr, vcr, t0, n, dh);
  __syncthreads();
  split_logits<int8_t, Q8_UNROLL>(kcr, vcr, t0, n, dh, qs, w);
  __syncthreads();

  // the split's max and sum; V's column scale folds into the weights
  float m = -INFINITY;
  for (int64_t i = tid; i < n; i += SPLIT_THREADS) {
    const float lg = w[i] * kscr[t0 + i] * scale;
    w[i] = lg;
    m = fmaxf(m, lg);
  }
  m = cta_reduce<true>(m, red);
  float l = 0.f;
  for (int64_t i = tid; i < n; i += SPLIT_THREADS) {
    const float e = expf(w[i] - m);
    w[i] = e * vscr[t0 + i];
    l += e;
  }
  l = cta_reduce<false>(l, red);  // its barrier publishes w[]
  float* wsr = ws + (row * splits + split) * (int64_t)(dh + 2);
  split_values<int8_t, Q8_UNROLL>(vcr, t0, n, dh, w, part, wsr);
  if (tid == 0) {
    wsr[0] = m;
    wsr[1] = l;
  }

  if (!arrive_last(counter + row, splits)) return;
  const float lc = cta_reduce<false>(dot, red) * scale;
  merge_splits(ws + row * splits * (int64_t)(dh + 2), splits, dh, lc,
               vdq + row * dh, out + row * dh, w);
  if (tid == 0) counter[row] = 0u;  // ready for the next call
}

template <typename KernelT>
int set_smem(KernelT kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The TMA map of a (bh, s, d) bf16 tensor as {d, s, bh}, a box sw/2
// columns of `rows` rows landing in the sw-byte swizzle; rows past s
// read as zeros.
int tile_map(CUtensorMap* map, const void* p, int64_t bh, int64_t s, int d,
             int rows, int sw) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)(s * d * 2)};
  const cuuint32_t box[3] = {(cuuint32_t)sw / 2, (cuuint32_t)rows, 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<void*>(p), dims, strides, box, estride,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : CU_TENSOR_MAP_SWIZZLE_64B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch_flash(int dtype, const void* q, const void* k, const void* v,
                 void* out, float* lse, int64_t bh, int64_t sq, int64_t sk,
                 int causal, float scale_log2, int use_shift, float shift,
                 cudaStream_t st) {
  if (dtype == 1) {
    using C = Fwd<D>;
    const int64_t tiles = (sq + C::ROWS - 1) / C::ROWS;
    if (tiles > 65535 || bh > INT32_MAX || sq > INT32_MAX || sk > INT32_MAX)
      return (int)cudaErrorInvalidValue;
    CUtensorMap tq, tk, tv;
    int err = tile_map(&tq, q, bh, sq, D, C::ROWS, C::SW);
    if (!err) err = tile_map(&tk, k, bh, sk, D, C::BK, C::SW);
    if (!err) err = tile_map(&tv, v, bh, sk, D, C::BK, C::SW);
    if (!err) err = set_smem(flash_fwd_bf16<D>, C::smem());
    if (err) return err;
    const dim3 grid((unsigned)bh, (unsigned)tiles);
    flash_fwd_bf16<D><<<grid, C::NT, C::smem(), st>>>(
        tq, tk, tv, static_cast<bf16*>(out), lse, sq, sk, causal, scale_log2,
        use_shift, shift);
  } else if (dtype == 0) {
    const dim3 grid((unsigned)((sq + BM - 1) / BM), (unsigned)bh);
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
  if (dtype == 1) {
    using C = BwdKv<D, DQ>;
    const int64_t tiles = (sk + C::KEYS - 1) / C::KEYS;
    if (tiles > 65535) return (int)cudaErrorInvalidValue;
    int err = set_smem(flash_bwd_bf16<D, DQ>, C::smem());
    if (err) return err;
    const dim3 grid((unsigned)bh, (unsigned)tiles);
    flash_bwd_bf16<D, DQ><<<grid, C::NT, C::smem(), st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, dq, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk,
        causal, scale_log2, scale);
  } else if (dtype == 0) {
    const dim3 grid((unsigned)((sk + BN - 1) / BN), (unsigned)bh);
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
  if (dtype == 1) {
    using C = BwdQ<D>;
    const int64_t tiles = (sq + C::ROWS - 1) / C::ROWS;
    if (tiles > 65535) return (int)cudaErrorInvalidValue;
    int err = set_smem(flash_bwd_dq_bf16<D>, C::smem());
    if (err) return err;
    const dim3 grid((unsigned)bh, (unsigned)tiles);
    flash_bwd_dq_bf16<D><<<grid, C::NT, C::smem(), st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, static_cast<bf16*>(dq), sq, sk, causal, scale_log2, scale);
  } else if (dtype == 0) {
    constexpr int BNK = D > 128 ? 32 : BN;  // the kernel's key tile
    const size_t smem =
        sizeof(float) * (2 * BM * (D + 1) + 2 * BNK * (D + 1) + BM * (BNK + 1));
    int err = set_smem(flash_bwd_dq_f32<D>, smem);
    if (err) return err;
    const dim3 grid((unsigned)((sq + BM - 1) / BM), (unsigned)bh);
    flash_bwd_dq_f32<D><<<grid, F32_THREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), sq, sk, causal, scale_log2, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename KernelT>
int occupancy(KernelT kernel, int threads, size_t smem, int* smem_bytes,
              int* ctas_per_sm) {
  int err = set_smem(kernel, smem);
  if (err) return err;
  *smem_bytes = (int)smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, kernel, threads, smem);
}

template <typename T>
int launch_decode(const void* q, const void* k, const void* v,
                  const float* cos2, const float* sin2, void* kc, void* vc,
                  void* out, float* ws, unsigned* counter, int64_t rows,
                  int64_t total, int dh, int64_t cur, int splits, int rope,
                  float scale, cudaStream_t st) {
  const size_t smem = split_smem(dh, (cur + splits - 1) / splits, splits);
  int err = set_smem(decode_step_kernel<T>, smem);
  if (err) return err;
  decode_step_kernel<T><<<dim3((unsigned)rows, (unsigned)splits),
                          SPLIT_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cos2, sin2, static_cast<T*>(kc),
      static_cast<T*>(vc), static_cast<T*>(out), ws, counter, total, dh, cur,
      rope, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_decode_q8(const void* q, const int8_t* kq, const int8_t* vq,
                     const float* kdq, const float* vdq, int8_t* kc,
                     int8_t* vc, const float* ksc, const float* vsc,
                     float* out, float* ws, unsigned* counter, int64_t rows,
                     int64_t total, int dh, int64_t cur, int splits,
                     float scale, cudaStream_t st) {
  const size_t smem = split_smem(dh, (cur + splits - 1) / splits, splits);
  int err = set_smem(decode_step_q8_kernel<T>, smem);
  if (err) return err;
  decode_step_q8_kernel<T><<<dim3((unsigned)rows, (unsigned)splits),
                             SPLIT_THREADS, smem, st>>>(
      static_cast<const T*>(q), kq, vq, kdq, vdq, kc, vc, ksc, vsc, out, ws,
      counter, total, dh, cur, scale);
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

// dtype: 0 = float32, 1 = bfloat16. q, k, v, out (rows, dh); caches
// (rows, total, dh), written at column cur; cos2, sin2 (dh,) float32; ws
// (rows * splits * (dh + 2)) float32 scratch; counter (rows,) uint32,
// zero, left zero. dh: a positive multiple of 128; splits: 1 .. 65535.
int icikit_decode_step_split(int dtype, const void* q, const void* k,
                             const void* v, const float* cos2,
                             const float* sin2, void* kc, void* vc,
                             void* out, float* ws, unsigned* counter,
                             int64_t rows, int64_t total, int dh,
                             int64_t cur, int splits, int rope, float scale,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh < 128 || dh % 128 || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch_decode<bf16>(q, k, v, cos2, sin2, kc, vc, out, ws, counter,
                               rows, total, dh, cur, splits, rope, scale, st);
  if (dtype == 0)
    return launch_decode<float>(q, k, v, cos2, sin2, kc, vc, out, ws,
                                counter, rows, total, dh, cur, splits, rope,
                                scale, st);
  return (int)cudaErrorInvalidValue;
}

// dtype: q's (0 = float32, 1 = bfloat16). q (rows, dh); kq, vq (rows, dh)
// int8, kdq, vdq (rows, dh) float32; caches (rows, total, dh) int8, written
// at column cur; ksc, vsc (rows, total) float32; out (rows, dh) float32;
// ws (rows * splits * (dh + 2)) float32 scratch; counter (rows,) uint32,
// zero, left zero. dh: a positive multiple of 128; splits: 1 .. 65535.
int icikit_decode_step_q8_split(int dtype, const void* q, const int8_t* kq,
                                const int8_t* vq, const float* kdq,
                                const float* vdq, int8_t* kc, int8_t* vc,
                                const float* ksc, const float* vsc,
                                float* out, float* ws, unsigned* counter,
                                int64_t rows, int64_t total, int dh,
                                int64_t cur, int splits, float scale,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh < 128 || dh % 128 || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch_decode_q8<bf16>(q, kq, vq, kdq, vdq, kc, vc, ksc, vsc, out,
                                  ws, counter, rows, total, dh, cur, splits,
                                  scale, st);
  if (dtype == 0)
    return launch_decode_q8<float>(q, kq, vq, kdq, vdq, kc, vc, ksc, vsc,
                                   out, ws, counter, rows, total, dh, cur,
                                   splits, scale, st);
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
      (const void*)flash_bwd_bf16<32, true>,    // 18
      (const void*)flash_bwd_bf16<64, true>,    // 19
      (const void*)flash_bwd_dq_bf16<32>,       // 20
      (const void*)flash_bwd_dq_bf16<64>,       // 21
      (const void*)flash_bwd_bf16<32, false>,   // 22
      (const void*)flash_bwd_bf16<64, false>,   // 23
      (const void*)flash_fwd_bf16<32>,          // 24
      (const void*)flash_fwd_bf16<64>,          // 25
      (const void*)decode_step_kernel<float>,   // 26
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

// The bf16 flash kernels' dynamic shared memory a CTA, as their
// launchers set it, and the CTAs an SM holds at that size. which: 0 =
// flash_bwd, 1 = flash_bwd_dq, 2 = flash_bwd_dkv, 3 = flash_fwd. d: 32,
// 64, 128 or 256.
int icikit_flash_occupancy(int which, int d, int* smem_bytes,
                           int* ctas_per_sm) {
#define OCC(D)                                                             \
  (which == 0   ? occupancy(flash_bwd_bf16<D, true>, BwdKv<D, true>::NT,   \
                            BwdKv<D, true>::smem(), smem_bytes, ctas_per_sm) \
   : which == 1 ? occupancy(flash_bwd_dq_bf16<D>, BwdQ<D>::NT,             \
                            BwdQ<D>::smem(), smem_bytes, ctas_per_sm)        \
   : which == 2 ? occupancy(flash_bwd_bf16<D, false>, BwdKv<D, false>::NT,  \
                            BwdKv<D, false>::smem(), smem_bytes, ctas_per_sm) \
                : occupancy(flash_fwd_bf16<D>, Fwd<D>::NT, Fwd<D>::smem(),  \
                            smem_bytes, ctas_per_sm))
  if (which < 0 || which > 3) return (int)cudaErrorInvalidValue;
  if (d == 128) return OCC(128);
  if (d == 64) return OCC(64);
  if (d == 32) return OCC(32);
  if (d == 256) return OCC(256);
#undef OCC
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
