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
constexpr int BQB = 32;            // Q rows a float32 backward step
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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

// wgmma's shared-memory matrix descriptor, no swizzle: the start address,
// LBO (the byte stride between core matrices along K) and SBO (along M or
// N). A tile in cm_off order read with K along its rows' chunks (K-major:
// Q, K, V, dO as the operands of S and dP) has LBO 128 and SBO CH * 128;
// read with K along its rows (MN-major, the transpose bit set: dO, Q and
// K as the B operands of dv, dk and dq, dS^T as dq's A) LBO CH * 128 and
// SBO 128.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, int lbo,
                                              int sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
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

// wgmma m64nNk16, bf16 in, float32 accumulate, for one warpgroup (128
// threads): D (+)= A B with A (64 x 16) from a descriptor (ss) or from
// registers (rs: warp w holds rows 16w .. 16w+15 as mma.sync m16n8k16's A
// fragment) and B (16 x N) from a descriptor; TA/TB: the operand is
// MN-major. Thread (warp w, lane g*4 + c) holds d[4j .. 4j+3] = rows
// 16w + g and 16w + g + 8, columns 8j + 2c and 8j + 2c + 1, as
// mma.sync's accumulator of n-tile j. scale_d 0 overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 16) wgmma_ss_n16<TA, TB>(d, da, db, scale_d);
  if constexpr (N == 32) wgmma_ss_n32<TA, TB>(d, da, db, scale_d);
  if constexpr (N == 64) wgmma_ss_n64<TA, TB>(d, da, db, scale_d);
  if constexpr (N == 128) wgmma_ss_n128<TA, TB>(d, da, db, scale_d);
}
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (N == 32) wgmma_rs_n32<TB>(d, a, db, scale_d);
  if constexpr (N == 64) wgmma_rs_n64<TB>(d, a, db, scale_d);
  if constexpr (N == 128) wgmma_rs_n128<TB>(d, a, db, scale_d);
}
// wg_fence: before a warpgroup's first wgmma on registers that plain
// instructions wrote. wg_commit closes a group of wgmmas; wg_wait<N>
// returns when at most the last N groups are still running (groups end
// in order). fence_regs then orders the plain instructions that read an
// accumulator after the wait.
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The A fragment (16 x 16, bf16) of k-chunk cc from an accumulator held
// as mma.sync/wgmma n-tiles of 8 columns (d[4j .. 4j+3] for n-tile j).
template <int R>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[R],
                                         int cc) {
  const float* x = d + 8 * cc;
  a[0] = pack_bf16(x[0], x[1]);
  a[1] = pack_bf16(x[2], x[3]);
  a[2] = pack_bf16(x[4], x[5]);
  a[3] = pack_bf16(x[6], x[7]);
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
      (const void*)flash_bwd_bf16<32, true>,    // 18
      (const void*)flash_bwd_bf16<64, true>,    // 19
      (const void*)flash_bwd_dq_bf16<32>,       // 20
      (const void*)flash_bwd_dq_bf16<64>,       // 21
      (const void*)flash_bwd_bf16<32, false>,   // 22
      (const void*)flash_bwd_bf16<64, false>,   // 23
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

// The bf16 backward kernels' dynamic shared memory a CTA, as their
// launchers set it, and the CTAs an SM holds at that size. which: 0 =
// flash_bwd, 1 = flash_bwd_dq, 2 = flash_bwd_dkv. d: 32, 64, 128 or 256.
int icikit_flash_bwd_occupancy(int which, int d, int* smem_bytes,
                               int* ctas_per_sm) {
#define OCC(D)                                                             \
  (which == 0   ? occupancy(flash_bwd_bf16<D, true>, BwdKv<D, true>::NT,   \
                            BwdKv<D, true>::smem(), smem_bytes, ctas_per_sm) \
   : which == 1 ? occupancy(flash_bwd_dq_bf16<D>, BwdQ<D>::NT,             \
                            BwdQ<D>::smem(), smem_bytes, ctas_per_sm)        \
                : occupancy(flash_bwd_bf16<D, false>, BwdKv<D, false>::NT,  \
                            BwdKv<D, false>::smem(), smem_bytes, ctas_per_sm))
  if (which < 0 || which > 2) return (int)cudaErrorInvalidValue;
  if (d == 128) return OCC(128);
  if (d == 64) return OCC(64);
  if (d == 32) return OCC(32);
  if (d == 256) return OCC(256);
#undef OCC
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
