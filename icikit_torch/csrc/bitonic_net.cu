// Bitonic sorting-network kernels for Hopper (sm_90a), bound with ctypes.
//
// Two kernels carry icikit_torch's sort, one for each TPU kernel of
// icikit/ops/pallas_sort.py:
//
//   K1 net_kernel<L>   <- _net_call   (pallas_sort.py:187-215). One CTA per
//      tile of 2^L keys (L 10..15), 32 keys a thread, so 2^(L-5) threads.
//      It runs every (db, strides) round it is given back to back.
//   K2 cross_kernel<G> <- _cross_call (pallas_sort.py:218-277). The stages
//      of one merge round whose stride is at least the tile and whose
//      Q-axis bit lies in [lo, lo + G - 1] (G 1..10), in one pass over the
//      (n/span, A, 2^G, B*tile) view: a CTA takes a (2^G rows, 2^(14-G)
//      columns) block, 2^14 keys, 32 a thread.
//
// Direction is the reference's trick (pallas_sort.py:27-40, 150-177):
// every stage is a plain ascending compare-exchange, and a descending
// span is order-reversed at round boundaries, with the flip bit taken from
// the key's global index. Both kernels work on int32 keys: float32 keys
// ride them through the order-preserving involution
// x ^ ((x >> 31) & 0x7fffffff) on the bit pattern (applied on load and
// undone on store), so a compare-exchange is one int32 min and one max and
// an order reversal is a bitwise NOT, for either dtype.
//
// Bound. Each launch reads and writes the array once: 2 * n * 4 bytes
// over 3.35 TB/s, 0.64 ms at n = 2^28. K1 also does its stages' min/max
// pairs, n ops a stage: at Hopper's int32 issue rate (64 lanes an SM a
// clock: 16.7 T ops/s at 132 SMs and 1.98 GHz) the 105 stages of a 2^14
// tile sort take 1.69 ms at n = 2^28, so the in-tile sort is bound by
// operations and every other launch by bytes. The designs:
//
// K1. Thread t keeps its 32 keys in registers, in one of three windows: in
//   window W0 register j holds tile key
//     ((t >> W0) << (W0 + 5)) | (j << W0) | (t mod 2^W0),
//   so key bits W0..W0+4 are register bits and a stage on one of them is
//   16 min/max pairs inside the thread, with no shuffle and no barrier.
//   The windows are A (W0 = 0), B (W0 = 5) and C (W0 = L - 5); a stage
//   on a bit outside the current window first moves the keys to a window
//   holding it (A or B before C), through shared memory (key e at
//   e + e/32: every window's stores and loads are free of bank
//   conflicts). A and B cover the same 1024 keys a warp, so a move
//   between them needs only __syncwarp; a move to or from C is CTA-wide.
//   Window C's key index is (j << (L-5)) | t, so the tile is read from
//   device memory straight into it with coalesced loads (32 in flight a
//   thread) and written back from it the same way. A round pass
//   (strides 2^(L-1)..1) is C, B, A: three moves; the 2^14 tile sort 24,
//   of which the rounds below stride 2^10 take 11, all but the first
//   inside a warp. Directions are masks over a thread's registers
//   computed once a round from the window, the thread's fixed key bits
//   and the tile index, and applied as one XOR a key where they are
//   uniform over the thread (every round past the fifth).
//
// K2. The memory system is the limit, so the design keeps loads in
//   flight and the stages in registers. With G <= 5 a thread holds all 2^G
//   rows of 32 / 2^G columns, as 16-byte (or narrower) vectors that
//   neighbouring threads take side by side, and every stage is inside the
//   thread: no shared memory. With G > 5 a thread first holds the 2^(G-5)
//   rows of the high row bits for 2^(10-G) adjacent columns and runs those
//   stages, then one exchange through shared memory (64 KiB, swizzled
//   against bank conflicts) gives it 32 rows of one column for the five
//   low bits; stores are coalesced across the warp's columns. Loads and
//   stores carry the streaming hint (.cs): each key is touched once a
//   pass. 512 threads and two CTAs an SM: 128 KiB of loads in flight an
//   SM at the first touch.
//
// Both may run in place (in == out): a CTA reads its whole block before
// it writes it, and CTAs own disjoint blocks. Every entry returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KEYS = 32;              // keys a thread, both kernels
constexpr int NET_LOG2_MIN = 10;
constexpr int NET_LOG2_MAX = 15;
constexpr int MAX_ROUNDS = 32;
constexpr int CROSS_THREADS = 512;
constexpr int CROSS_LOG2_BLOCK = 14;  // keys a K2 CTA: CROSS_THREADS * KEYS
constexpr int CROSS_G_MAX = 10;

struct Rounds {
  int count;
  int db[MAX_ROUNDS];  // direction bit of the global index; -1 = ascending
  int hi[MAX_ROUNDS];  // log2 of the round's first (largest) stride
  int lo[MAX_ROUNDS];  // log2 of its last stride
};

// float32 bit pattern <-> an int32 key of the same order (an involution;
// -0.0 sorts just below 0.0).
__device__ __forceinline__ int fkey(int x) { return x ^ ((x >> 31) & 0x7fffffff); }

// Ascending compare-exchange of a (lower index) and b.
__device__ __forceinline__ void ce(int& a, int& b) {
  const int lo = min(a, b), hi = max(a, b);
  a = lo;
  b = hi;
}

// ---------------------------------------------------------------- K1

// Shared-memory image of the tile: key e at e + e / 32.
__device__ __forceinline__ int pad(int e) { return e + (e >> 5); }

// The key bits of thread t outside window w0 (register 0's key).
__device__ __forceinline__ int win_base(int t, int w0) {
  return ((t >> w0) << (w0 + 5)) | (t & ((1 << w0) - 1));
}

// Register j's key is win_base | (j << W0), and its padded address is
// pad(win_base) + (j << W0) + ((j << W0) >> 5): a constant offset a
// register, folded into the instruction.
template <int W0>
__device__ __forceinline__ void win_store(int* s, const int (&v)[KEYS], int t) {
  int* p = s + pad(win_base(t, W0));
#pragma unroll
  for (int j = 0; j < KEYS; ++j) p[(j << W0) + ((j << W0) >> 5)] = v[j];
}

template <int W0>
__device__ __forceinline__ void win_load(const int* s, int (&v)[KEYS], int t) {
  const int* p = s + pad(win_base(t, W0));
#pragma unroll
  for (int j = 0; j < KEYS; ++j) v[j] = p[(j << W0) + ((j << W0) >> 5)];
}

// Windows 0 (A), 1 (B), 2 (C) and their low bits.
template <int L>
__device__ __forceinline__ int win_low(int w) {
  return w == 0 ? 0 : (w == 1 ? 5 : L - 5);
}

// The window for a stage on key bit `bit` when the keys are in window
// cur: cur if it holds the bit, else A or B (a warp's own keys, no CTA
// barrier) if one holds it, else C.
template <int L>
__device__ __forceinline__ int win_of(int bit, int cur) {
  const int lo = win_low<L>(cur);
  if (bit >= lo && bit < lo + 5) return cur;
  return bit >= 10 ? 2 : (bit >= 5 ? 1 : 0);
}

// Move the keys from window `from` to window `to` through shared memory.
// A and B hold the same keys a warp; C spans the CTA.
template <int L>
__device__ __forceinline__ void move(int* s, int (&v)[KEYS], int t, int from,
                                     int to) {
  if (from == 2)
    __syncthreads();  // every thread's last reads of the image are done
  else
    __syncwarp();
  if (from == 0)
    win_store<0>(s, v, t);
  else if (from == 1)
    win_store<5>(s, v, t);
  else
    win_store<L - 5>(s, v, t);
  if (from == 2 || to == 2)
    __syncthreads();
  else
    __syncwarp();
  if (to == 0)
    win_load<0>(s, v, t);
  else if (to == 1)
    win_load<5>(s, v, t);
  else
    win_load<L - 5>(s, v, t);
}

// Stage on register bit M: registers j and j | 2^M.
template <int M>
__device__ __forceinline__ void reg_stage(int (&v)[KEYS]) {
#pragma unroll
  for (int j = 0; j < KEYS; ++j)
    if ((j & (1 << M)) == 0) ce(v[j], v[j | (1 << M)]);
}

// Stages on register bits top, top - 1, ..., bot (4 >= top >= bot >= 0),
// one branch for the run.
__device__ __forceinline__ void stages(int (&v)[KEYS], int top, int bot) {
  switch (top) {
    case 4:
      reg_stage<4>(v);
      if (bot == 4) break;
      [[fallthrough]];
    case 3:
      reg_stage<3>(v);
      if (bot == 3) break;
      [[fallthrough]];
    case 2:
      reg_stage<2>(v);
      if (bot == 2) break;
      [[fallthrough]];
    case 1:
      reg_stage<1>(v);
      if (bot == 1) break;
      [[fallthrough]];
    default:
      reg_stage<0>(v);
  }
}

// Register bit m of the key index, as a mask over registers.
__device__ __forceinline__ uint32_t reg_bit_mask(int m) {
  switch (m) {
    case 0: return 0xaaaaaaaau;
    case 1: return 0xccccccccu;
    case 2: return 0xf0f0f0f0u;
    case 3: return 0xff00ff00u;
    default: return 0xffff0000u;
  }
}

// Bit d of each register's global key index (d < 0: none), a mask over
// registers: bits of the tile index, register bits of the window, or the
// thread's fixed bits.
template <int L>
__device__ __forceinline__ uint32_t dir_mask(int d, int w0, int base,
                                             unsigned tile) {
  if (d < 0) return 0u;
  if (d >= L) return (d - L < 32 && ((tile >> (d - L)) & 1)) ? ~0u : 0u;
  if (d >= w0 && d < w0 + 5) return reg_bit_mask(d - w0);
  return ((base >> d) & 1) ? ~0u : 0u;
}

// Order-reverse the registers whose mask bit is set (bitwise NOT).
__device__ __forceinline__ void flip(int (&v)[KEYS], uint32_t mask) {
  if (mask == 0u) return;
  if (mask == ~0u) {
#pragma unroll
    for (int j = 0; j < KEYS; ++j) v[j] = ~v[j];
    return;
  }
#pragma unroll
  for (int j = 0; j < KEYS; ++j) v[j] ^= -(int)((mask >> j) & 1u);
}

// 2048 threads an SM, so 64 registers a thread; at L = 10 (one warp a
// CTA) 64 registers spill, and 16 CTAs an SM leave it 128.
template <int L>
__global__ void __launch_bounds__(1 << (L - 5), L > 10 ? 1024 >> (L - 5) : 16)
net_kernel(const int* in, int* out, const __grid_constant__ Rounds rounds,
           int f32) {
  extern __shared__ int s[];
  constexpr int WC = L - 5;
  const int t = threadIdx.x;
  const unsigned tile = blockIdx.x;
  const int* src = in + ((int64_t)tile << L);
  int v[KEYS];
#pragma unroll
  for (int j = 0; j < KEYS; ++j) v[j] = __ldcs(src + ((j << WC) | t));
  if (f32) {
#pragma unroll
    for (int j = 0; j < KEYS; ++j) v[j] = fkey(v[j]);
  }
  int cur = 2, prev = -1;
  for (int r = 0; r < rounds.count; ++r) {
    const int db = rounds.db[r];
    const int w0 = win_low<L>(cur);
    const int base = win_base(t, w0);
    flip(v, dir_mask<L>(prev, w0, base, tile) ^
                dir_mask<L>(db, w0, base, tile));
    prev = db;
    // the round's stages, a run of them a window
    const int lo = rounds.lo[r];
    for (int b = rounds.hi[r]; b >= lo;) {
      const int w = win_of<L>(b, cur);
      if (w != cur) {
        move<L>(s, v, t, cur, w);
        cur = w;
      }
      const int wl = win_low<L>(w);
      const int stop = lo > wl ? lo : wl;
      stages(v, b - wl, stop - wl);
      b = stop - 1;
    }
  }
  const int w0 = win_low<L>(cur);
  flip(v, dir_mask<L>(prev, w0, win_base(t, w0), tile));
  if (cur != 2) move<L>(s, v, t, cur, 2);
  if (f32) {
#pragma unroll
    for (int j = 0; j < KEYS; ++j) v[j] = fkey(v[j]);
  }
  int* dst = out + ((int64_t)tile << L);
#pragma unroll
  for (int j = 0; j < KEYS; ++j) __stcs(dst + ((j << WC) | t), v[j]);
}

// ---------------------------------------------------------------- K2

template <int G>
struct Cross {
  static constexpr bool TWO = G > 5;            // an exchange for 5 low bits
  static constexpr int GH = TWO ? G - 5 : G;    // row bits of layout 1
  static constexpr int R1 = 1 << GH;            // rows a thread, layout 1
  static constexpr int W1 = KEYS / R1;          // columns a thread, layout 1
  static constexpr int VW = W1 < 4 ? W1 : 4;    // keys a vector access
  static constexpr int NV = W1 / VW;            // vectors a row
  static constexpr int LOG2C = CROSS_LOG2_BLOCK - G;
  static constexpr int C = 1 << LOG2C;          // columns of the block
  static constexpr int CG = C / W1;             // column groups (16 or 512)
  static constexpr int SMEM_WORDS =
      !TWO ? 0 : (C == 16 ? (16 << G) + (16 << (G - 5)) : (C << G));
};

// The exchange's image of (row, col): 16 words of padding after every 32
// rows for 16 columns (G 10), else the column XOR-swizzled inside its
// 32-word group by its group and the row's parity. Either way layout 1's
// stores (16 column groups x 2 rows a warp) and layout 2's loads (32
// adjacent columns a warp, or 16 x 2 rows) hit 32 banks.
template <int G>
__device__ __forceinline__ int cross_at(int row, int col) {
  using X = Cross<G>;
  if constexpr (X::C == 16)
    return row * 16 + col + 16 * (row >> 5);
  else
    return row * X::C + (col ^ ((col >> 5) | ((row & 1) * (X::W1 / 2))));
}

// A super column s of the view (its column and the groups of 2^G rows
// above it, flattened) at row 0: the view is (n >> (log2rs + G) groups,
// 2^G rows, 2^log2rs columns), rows 2^log2rs apart.
template <int G>
__device__ __forceinline__ int64_t col_addr(int64_t s, int log2rs) {
  return ((s >> log2rs) << (log2rs + G)) | (s & (((int64_t)1 << log2rs) - 1));
}

// VW keys at p (16-byte aligned for 4, 8-byte for 2), streamed.
template <int VW>
__device__ __forceinline__ void ld_vec(const int* p, int* v) {
  if constexpr (VW == 4) {
    const int4 x = __ldcs(reinterpret_cast<const int4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else if constexpr (VW == 2) {
    const int2 x = __ldcs(reinterpret_cast<const int2*>(p));
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = __ldcs(p);
  }
}

template <int VW>
__device__ __forceinline__ void st_vec(int* p, const int* v) {
  if constexpr (VW == 4)
    __stcs(reinterpret_cast<int4*>(p), make_int4(v[0], v[1], v[2], v[3]));
  else if constexpr (VW == 2)
    __stcs(reinterpret_cast<int2*>(p), make_int2(v[0], v[1]));
  else
    __stcs(p, v[0]);
}

template <int G>
__global__ void __launch_bounds__(CROSS_THREADS, 2)
cross_kernel(const int* in, int* out, int log2rs, int log2span,
             int merge_only, int f32) {
  using X = Cross<G>;
  extern __shared__ int s[];
  const int64_t row_stride = (int64_t)1 << log2rs;  // the G axis' stride
  const int t = threadIdx.x;
  const int cg = t % X::CG;
  const int lr = X::TWO ? t / X::CG : 0;
  const int64_t col0 = (int64_t)blockIdx.x << X::LOG2C;
  // layout 1: rows (k << 5) | lr (or k); the thread's NV vectors of VW
  // columns each. With the exchange they are its W1 adjacent columns
  // cg * W1 + w (C <= 2^8 columns, inside one group, so one span flip m
  // for the CTA); without it vector q takes columns (q * CG + cg) * VW,
  // so that a warp's accesses are contiguous, each at its own group's
  // address and flip (a vector's VW <= 4 columns share a group)
  int64_t at[X::NV];
  int m[X::NV];
#pragma unroll
  for (int q = 0; q < X::NV; ++q) {
    at[q] = X::TWO ? col_addr<G>(col0 + cg * X::W1, log2rs) + q * X::VW
                   : col_addr<G>(col0 + (q * X::CG + cg) * X::VW, log2rs);
    m[q] = merge_only ? 0 : -(int)((at[q] >> log2span) & 1);
  }

  int v[X::R1][X::W1];
#pragma unroll
  for (int k = 0; k < X::R1; ++k) {
    const int64_t row = X::TWO ? (k << 5) | lr : k;
#pragma unroll
    for (int q = 0; q < X::NV; ++q)
      ld_vec<X::VW>(in + at[q] + row * row_stride, &v[k][q * X::VW]);
  }
#pragma unroll
  for (int k = 0; k < X::R1; ++k)
#pragma unroll
    for (int w = 0; w < X::W1; ++w)
      v[k][w] = (f32 ? fkey(v[k][w]) : v[k][w]) ^ m[w / X::VW];
#pragma unroll
  for (int b = X::GH - 1; b >= 0; --b)
#pragma unroll
    for (int k = 0; k < X::R1; ++k)
      if ((k & (1 << b)) == 0)
#pragma unroll
        for (int w = 0; w < X::W1; ++w) ce(v[k][w], v[k | (1 << b)][w]);

  if constexpr (X::TWO) {
    // the exchange: layout 2 holds rows (hr << 5) | k of column c2
#pragma unroll
    for (int k = 0; k < X::R1; ++k)
#pragma unroll
      for (int w = 0; w < X::W1; ++w)
        s[cross_at<G>((k << 5) | lr, cg * X::W1 + w)] = v[k][w];
    __syncthreads();
    const int c2 = t % X::C, hr = t / X::C;
    int u[KEYS];
#pragma unroll
    for (int k = 0; k < KEYS; ++k) u[k] = s[cross_at<G>((hr << 5) | k, c2)];
    reg_stage<4>(u);
    reg_stage<3>(u);
    reg_stage<2>(u);
    reg_stage<1>(u);
    reg_stage<0>(u);
    int* dst = out + col_addr<G>(col0 + c2, log2rs) +
               (int64_t)(hr << 5) * row_stride;
#pragma unroll
    for (int k = 0; k < KEYS; ++k) {
      const int x = u[k] ^ m[0];
      __stcs(dst + k * row_stride, f32 ? fkey(x) : x);
    }
  } else {
#pragma unroll
    for (int k = 0; k < X::R1; ++k) {
#pragma unroll
      for (int w = 0; w < X::W1; ++w) {
        const int x = v[k][w] ^ m[w / X::VW];
        v[k][w] = f32 ? fkey(x) : x;
      }
#pragma unroll
      for (int q = 0; q < X::NV; ++q)
        st_vec<X::VW>(out + at[q] + k * row_stride, &v[k][q * X::VW]);
    }
  }
}

// ------------------------------------------------------------ launches

template <int L>
int launch_net(const int* in, int* out, int64_t n, const Rounds& rounds,
               int f32, cudaStream_t stream) {
  const int smem = (int)sizeof(int) * ((1 << L) + (1 << (L - 5)));
  cudaError_t err = cudaFuncSetAttribute(
      net_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  net_kernel<L><<<(unsigned)(n >> L), 1 << (L - 5), smem, stream>>>(
      in, out, rounds, f32);
  return (int)cudaGetLastError();
}

template <int G>
int launch_cross(const int* in, int* out, int64_t n, int log2rs, int log2span,
                 int merge_only, int f32, cudaStream_t stream) {
  const int smem = (int)sizeof(int) * Cross<G>::SMEM_WORDS;
  cudaError_t err = cudaFuncSetAttribute(
      cross_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cross_kernel<G><<<(unsigned)(n >> CROSS_LOG2_BLOCK), CROSS_THREADS, smem,
                    stream>>>(in, out, log2rs, log2span, merge_only, f32);
  return (int)cudaGetLastError();
}

template <int... Ls>
struct NetTable {
  static int run(int log2t, const int* in, int* out, int64_t n,
                 const Rounds& r, int f32, cudaStream_t st) {
    int rc = (int)cudaErrorInvalidValue;
    ((log2t == Ls ? (rc = launch_net<Ls>(in, out, n, r, f32, st), 0) : 0),
     ...);
    return rc;
  }
  static cudaError_t attrs(int log2t, cudaFuncAttributes* a) {
    cudaError_t rc = cudaErrorInvalidValue;
    ((log2t == Ls ? (rc = cudaFuncGetAttributes(a, net_kernel<Ls>), 0) : 0),
     ...);
    return rc;
  }
};

template <int... Gs>
struct CrossTable {
  static int run(int g, const int* in, int* out, int64_t n, int log2rs,
                 int log2span, int merge_only, int f32, cudaStream_t st) {
    int rc = (int)cudaErrorInvalidValue;
    ((g == Gs ? (rc = launch_cross<Gs>(in, out, n, log2rs, log2span,
                                       merge_only, f32, st),
                 0)
              : 0),
     ...);
    return rc;
  }
  static cudaError_t attrs(int g, cudaFuncAttributes* a) {
    cudaError_t rc = cudaErrorInvalidValue;
    ((g == Gs ? (rc = cudaFuncGetAttributes(a, cross_kernel<Gs>), 0) : 0),
     ...);
    return rc;
  }
};

using Nets = NetTable<10, 11, 12, 13, 14, 15>;
using Crosses = CrossTable<1, 2, 3, 4, 5, 6, 7, 8, 9, 10>;

}  // namespace

extern "C" {

// dtype: 0 = int32, 1 = float32 (the same kernel on the keys' image).
// log2t in [10, 15]; n a multiple of 2^log2t.
int icikit_net_pass(int dtype, const void* in, void* out, int64_t n,
                    int log2t, int nrounds, const int* db, const int* hi,
                    const int* lo, void* stream) {
  if (nrounds < 0 || nrounds > MAX_ROUNDS || (dtype != 0 && dtype != 1) ||
      log2t < NET_LOG2_MIN || log2t > NET_LOG2_MAX || n <= 0 ||
      n % ((int64_t)1 << log2t))
    return (int)cudaErrorInvalidValue;
  Rounds rounds;
  rounds.count = nrounds;
  for (int i = 0; i < nrounds; ++i) {
    if (db[i] < -1 || hi[i] >= log2t || lo[i] < 0)
      return (int)cudaErrorInvalidValue;
    rounds.db[i] = db[i];
    rounds.hi[i] = hi[i];
    rounds.lo[i] = lo[i];
  }
  return Nets::run(log2t, static_cast<const int*>(in), static_cast<int*>(out),
                   n, rounds, dtype, static_cast<cudaStream_t>(stream));
}

// The block width K2 takes for a pass of log2g bits: log2 of its columns,
// or -1 where it takes no such pass.
int icikit_cross_log2cb(int log2g) {
  return log2g < 1 || log2g > CROSS_G_MAX ? -1 : CROSS_LOG2_BLOCK - log2g;
}

// The Q-axis bits [lo_bit, hi_bit] of a span's merge round; log2cb must be
// icikit_cross_log2cb(hi_bit - lo_bit + 1); span a power of two; n a
// multiple of span and of 2^14 (a CTA's block); in and out 16-byte
// aligned.
int icikit_cross_pass(int dtype, const void* in, void* out, int64_t n,
                      int64_t span, int log2t, int lo_bit, int hi_bit,
                      int log2cb, int merge_only, void* stream) {
  const int g = hi_bit - lo_bit + 1;
  if ((dtype != 0 && dtype != 1) || lo_bit < 0 || log2t < 0 ||
      log2cb != icikit_cross_log2cb(g) || span <= 0 || (span & (span - 1)) ||
      log2t + hi_bit + 1 > 62 || ((int64_t)1 << (log2t + hi_bit + 1)) > span ||
      n % ((int64_t)1 << CROSS_LOG2_BLOCK) || n % span ||
      reinterpret_cast<uintptr_t>(in) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  int log2span = 0;
  while (((int64_t)1 << log2span) < span) ++log2span;
  return Crosses::run(g, static_cast<const int*>(in), static_cast<int*>(out),
                      n, log2t + lo_bit, log2span, merge_only, dtype,
                      static_cast<cudaStream_t>(stream));
}

// Kernel attributes for the build log: which 0..5 is net_kernel<10 +
// which>, 6..15 cross_kernel<which - 5>.
int icikit_kernel_regs(int which, int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = which < 6 ? Nets::attrs(which + 10, &attr)
                                    : Crosses::attrs(which - 5, &attr);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
