// One-pass Adam for Hopper (sm_90a), bound with ctypes.
//
//   adam_tree <- _adam_kernel (B12, icikit/ops/adam.py:50, _leaf_update_pallas,
//                pallas_call :71).
//      One pass over every floating leaf of a parameter tree: read p
//      (float32), m and v (each float32 or bf16, one pair for the launch:
//      the template's M and V) and g
//      (float32, bf16 or fp16, a leaf's own, widened in registers), write
//      p, m and v in place. optax.adam with eps_root = 0:
//        m' = b1 m + (1 - b1) g,  v' = b2 v + (1 - b2) g^2,
//        p' = p - lr (m' c1) / (sqrt(v' c2) + eps),
//      float32 arithmetic, each operation rounded once (__fmul_rn,
//      __fadd_rn, __fdiv_rn, __fsqrt_rn: no contraction into FMAs), the
//      moments rounded once on the store. That is the order PyTorch's
//      eager elementwise ops take in the plain version
//      (ops/cuda_adam.adam_leaf_plain), so the two agree bit for bit.
//      lr, c1 = 1/(1 - b1^t) and c2 = 1/(1 - b2^t) are read from a (3,)
//      device tensor and the guard flag `ok` from a device bool (null: no
//      guard), once a CTA, so the train step stays free of host syncs;
//      with ok false the kernel writes nothing (guard="device"'s
//      where(ok, new, old)). The TPU kernel needs a (rows, 128) view whose
//      row count meets the operands' sublane rule (_use_pallas) and runs
//      one pallas_call a leaf; here every floating leaf takes this kernel,
//      and the TPU's aliasing penalty (adam.py:150-153) has no counterpart:
//      the update is in place.
//
//      Bound: bytes, 26 B an element with float32 moments and bf16
//      gradients (28 B with float32 gradients): 5.49 GB, 1.64 ms at
//      3.35 TB/s at the bench's 211 M parameters. Design for that bound:
//      - one launch a tree: the leaves ride in a table passed by value
//        (__grid_constant__, MAX_LEAVES a launch, inside the 4 KiB
//        parameter limit), cut into chunks of `chunk` elements that never
//        span two leaves; a persistent grid (the SMs times the CTAs an SM
//        the occupancy API reports) walks the chunks, so a norm gain of a
//        thousand elements costs a chunk, not a launch and its ramp;
//      - the bytes move on the bulk-copy engine: one thread of a producer
//        warp keeps a ring of NS shared-memory stages full, a tile of TILE
//        elements of p, m, v and g a stage, with cp.async.bulk
//        global->shared signed for on the stage's full mbarrier; the CT
//        consumer threads update a tile in shared memory, 8 elements a
//        thread as 16-byte vectors, and one of them writes p, m and v back
//        with cp.async.bulk shared->global in a bulk group, releasing the
//        stage (its empty mbarrier) once those stores have read it. Up to
//        NS tiles (128 KiB with float32 moments) are in flight an SM with
//        no registers held for them; a register design (16-byte
//        ld.global.cs, 224 B in flight a thread) streamed 6-7% slower;
//      - a leaf whose four pointers reach a common 16-byte boundary within
//        `head` < 8 elements takes those elements and its last n % 8 as
//        scalars through registers, as does a leaf whose pointers never
//        align (head -1) for all its elements.
//
// The entry returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int CT = 256;                 // consumer threads
constexpr int THREADS = CT + 32;        // and a producer warp
constexpr int TILE = 2048;              // elements a stage
constexpr int NS = 4;                   // stages
constexpr int VEC = 8;                  // elements a consumer a step
constexpr int MAX_LEAVES = 48;
constexpr int ROW = 8;                  // int64 fields a leaf in the table

struct Leaf {
  float* p;
  void* m;
  void* v;
  const void* g;
  int64_t n;       // elements
  int64_t chunk0;  // the leaf's first chunk in the launch
  int32_t gcode;   // 0 float32, 1 bf16, 2 fp16
  int32_t head;    // scalar elements before the aligned body; -1: none
};

struct Table {
  Leaf leaf[MAX_LEAVES];
  int64_t chunks;  // chunks of the launch
  int32_t count;   // leaves
  int32_t chunk;   // elements a chunk, a multiple of VEC
};

// A stage: TILE elements of p (float32), m (M), v (V) and g (up to 4 B).
template <typename M, typename V>
__host__ __device__ constexpr int stage_bytes() {
  return TILE * (4 + (int)sizeof(M) + (int)sizeof(V) + 4);
}

struct Hyper {
  float b1, omb1, b2, omb2, eps, lr, c1, c2;
};

// The update of one element, in the plain version's order.
__device__ __forceinline__ void update(float& p, float& m, float& v, float g,
                                       const Hyper& h) {
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(g, h.omb1));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(g, g), h.omb2));
  const float num = __fmul_rn(h.lr, __fmul_rn(m, h.c1));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.c2)), h.eps);
  p = __fsub_rn(p, __fdiv_rn(num, den));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Elements [a, b) of a leaf as scalars, a consumer an element a step.
template <typename M, typename V, typename G>
__device__ __forceinline__ void scalar_range(float* p, M* m, V* v,
                                             const G* g, int64_t a,
                                             int64_t b, const Hyper& h) {
  for (int64_t i = a + threadIdx.x; i < b; i += CT) {
    float pf = p[i], mf = to_f(m[i]), vf = to_f(v[i]);
    update(pf, mf, vf, to_f(g[i]), h);
    p[i] = pf;
    m[i] = from_f<M>(mf);
    v[i] = from_f<V>(vf);
  }
}

// 8 elements of T as 32-bit words: 8 for float32, 4 for a 16-bit type.
template <typename T> struct Raw {
  static constexpr int W = (int)sizeof(T) * VEC / 4;
  uint32_t w[W];
};

// Element k (a constant after unrolling) widened to float32, exactly.
__device__ __forceinline__ float elem(const Raw<float>& r, int k) {
  return __uint_as_float(r.w[k]);
}
__device__ __forceinline__ float elem(const Raw<bf16>& r, int k) {
  const uint32_t w = r.w[k >> 1];
  return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
}
__device__ __forceinline__ float elem(const Raw<__half>& r, int k) {
  const uint32_t w = r.w[k >> 1];
  return __half2float(
      __ushort_as_half((unsigned short)((k & 1) ? (w >> 16) : (w & 0xffffu))));
}
// Element k set from float32, rounded once as from_f rounds.
__device__ __forceinline__ void put(Raw<float>& r, int k, float x) {
  r.w[k] = __float_as_uint(x);
}
__device__ __forceinline__ void put(Raw<bf16>& r, int k, float x) {
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(x));
  uint32_t& w = r.w[k >> 1];
  w = (k & 1) ? ((w & 0xffffu) | (b << 16)) : ((w & 0xffff0000u) | b);
}

// mbarriers and the bulk-copy engine (sm_90).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(b)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

template <typename T>
__device__ __forceinline__ void lds8(Raw<T>& r, const void* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int q = 0; q < Raw<T>::W / 4; ++q) {
    const uint4 t = s[q];
    r.w[4 * q] = t.x;
    r.w[4 * q + 1] = t.y;
    r.w[4 * q + 2] = t.z;
    r.w[4 * q + 3] = t.w;
  }
}
template <typename T>
__device__ __forceinline__ void sts8(void* dst, const Raw<T>& r) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int q = 0; q < Raw<T>::W / 4; ++q)
    d[q] = make_uint4(r.w[4 * q], r.w[4 * q + 1], r.w[4 * q + 2],
                      r.w[4 * q + 3]);
}

// One group of 8 elements of a stage, in place in shared memory.
template <typename M, typename V, typename G>
__device__ __forceinline__ void group_smem(unsigned char* st, int j,
                                           const Hyper& h) {
  constexpr int mb = (int)sizeof(M), vb = (int)sizeof(V);
  unsigned char* sp = st + 32 * j;
  unsigned char* sm = st + 4 * TILE + mb * 8 * j;
  unsigned char* sv = st + (4 + mb) * TILE + vb * 8 * j;
  const unsigned char* sg = st + (4 + mb + vb) * TILE +
                            (int)sizeof(G) * 8 * j;
  Raw<float> rp;
  Raw<M> rm;
  Raw<V> rv;
  Raw<G> rg;
  lds8(rp, sp);
  lds8(rm, sm);
  lds8(rv, sv);
  lds8(rg, sg);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    float pf = elem(rp, k), mf = elem(rm, k), vf = elem(rv, k);
    update(pf, mf, vf, elem(rg, k), h);
    put(rp, k, pf);
    put(rm, k, mf);
    put(rv, k, vf);
  }
  sts8(sp, rp);
  sts8(sm, rm);
  sts8(sv, rv);
}

template <typename M, typename V, typename G>
__device__ __forceinline__ void leaf_scalars(const Leaf& L, int64_t a,
                                             int64_t b, const Hyper& h) {
  scalar_range(L.p, static_cast<M*>(L.m), static_cast<V*>(L.v),
               static_cast<const G*>(L.g), a, b, h);
}

template <typename M, typename V>
__device__ __forceinline__ void scalars_any(const Leaf& L, int64_t a,
                                            int64_t b, const Hyper& h) {
  if (L.gcode == 0)
    leaf_scalars<M, V, float>(L, a, b, h);
  else if (L.gcode == 1)
    leaf_scalars<M, V, bf16>(L, a, b, h);
  else
    leaf_scalars<M, V, __half>(L, a, b, h);
}

template <typename M, typename V>
__global__ void __launch_bounds__(THREADS)
adam_tree_kernel(const __grid_constant__ Table tab,
                 const float* __restrict__ sc, const bool* __restrict__ ok,
                 float b1, float omb1, float b2, float omb2, float eps) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[NS], empty[NS];
  __shared__ float s_sc[3];
  __shared__ int s_ok;
  if (threadIdx.x == 0) {
    s_ok = ok == nullptr || *ok;
    s_sc[0] = sc[0];
    s_sc[1] = sc[1];
    s_sc[2] = sc[2];
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (!s_ok) return;
  const bool producer = threadIdx.x >= CT;
  if (producer && threadIdx.x != CT) return;
  const Hyper h{b1, omb1, b2, omb2, eps, s_sc[0], s_sc[1], s_sc[2]};
  const int mb = (int)sizeof(M), vb = (int)sizeof(V);
  constexpr int SB = stage_bytes<M, V>();
  // producer and consumers walk the same chunks and tiles; seq numbers
  // the CTA's tiles, tile seq on stage seq % NS
  int li = 0;  // a CTA's chunks rise, so its leaf only moves forward
  int64_t seq = 0;
  for (int64_t c = blockIdx.x; c < tab.chunks; c += gridDim.x) {
    while (li + 1 < tab.count && c >= tab.leaf[li + 1].chunk0) ++li;
    const Leaf L = tab.leaf[li];
    const int64_t k = c - L.chunk0;
    const int64_t base = L.head < 0 ? 0 : L.head;
    const int64_t a = base + k * tab.chunk;
    const int64_t b = a + tab.chunk < L.n ? a + tab.chunk : L.n;
    if (L.head < 0) {
      if (!producer) scalars_any<M, V>(L, a, b, h);
      continue;
    }
    if (!producer && k == 0 && base > 0) scalars_any<M, V>(L, 0, base, h);
    const int64_t body = (b - a) / VEC * VEC;
    const int gb = L.gcode == 0 ? 4 : 2;
    for (int64_t t0 = 0; t0 < body; t0 += TILE, ++seq) {
      const int cnt = (int)(body - t0 < TILE ? body - t0 : TILE);
      const int s = (int)(seq % NS);
      unsigned char* st = ring + s * SB;
      const int64_t e = a + t0;
      if (producer) {
        // the stage is free once the tile NS before has been written back
        if (seq >= NS) mbar_wait(empty + s, (int)(((seq / NS) - 1) & 1));
        mbar_expect_tx(full + s, cnt * (4 + mb + vb + gb));
        bulk_load(st, L.p + e, 4 * cnt, full + s);
        bulk_load(st + 4 * TILE, static_cast<M*>(L.m) + e, mb * cnt,
                  full + s);
        bulk_load(st + 4 * TILE + mb * TILE, static_cast<V*>(L.v) + e,
                  vb * cnt, full + s);
        bulk_load(st + 4 * TILE + (mb + vb) * TILE,
                  static_cast<const unsigned char*>(L.g) + e * gb, gb * cnt,
                  full + s);
        continue;
      }
      // the consumers: update the tile in place, then one of them writes
      // it back once every consumer's stores are visible to the engine
      mbar_wait(full + s, (int)((seq / NS) & 1));
      const int j = threadIdx.x;
      if (j < cnt / VEC) {
        if (L.gcode == 0)
          group_smem<M, V, float>(st, j, h);
        else if (L.gcode == 1)
          group_smem<M, V, bf16>(st, j, h);
        else
          group_smem<M, V, __half>(st, j, h);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, %0;\n" ::"n"(CT) : "memory");
      if (threadIdx.x == 0) {
        bulk_store(L.p + e, st, 4 * cnt);
        bulk_store(static_cast<M*>(L.m) + e, st + 4 * TILE, mb * cnt);
        bulk_store(static_cast<V*>(L.v) + e, st + 4 * TILE + mb * TILE,
                   vb * cnt);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        if (seq >= 1) {
          // the previous tile's stores have read its stage: release it
          asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
          mbar_arrive(empty + (int)((seq - 1) % NS));
        }
      }
    }
    if (!producer) scalars_any<M, V>(L, a + body, b, h);
  }
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The persistent grid: the SMs times the CTAs an SM holds.
template <typename M, typename V>
int64_t grid_cap() {
  static int64_t cap = 0;
  if (cap == 0) {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(adam_tree_kernel<M, V>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         NS * stage_bytes<M, V>());
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, adam_tree_kernel<M, V>, THREADS, NS * stage_bytes<M, V>());
    cap = (int64_t)(sms > 0 ? sms : 1) * (per > 0 ? per : 1);
  }
  return cap;
}

int64_t elem_bytes(int code) { return code == 0 ? 4 : 2; }

// The moment dtypes of a launch (mdtype): 0 float32 m and v, 1 bf16 m
// and v, 2 float32 m and bf16 v, 3 bf16 m and float32 v; the bytes an
// element of m (which 0) or v (which 1).
int64_t moment_bytes(int mdtype, int which) {
  const bool bf = mdtype == 1 || (mdtype == 2 && which == 1) ||
                  (mdtype == 3 && which == 0);
  return bf ? 2 : 4;
}

// The host's table, checked: codes, heads, alignment of the vector body
// and the chunk prefix sums; false where any is wrong.
bool fill(Table& tab, int mdtype, const int64_t* rows, int count,
          int64_t chunk) {
  if (count < 1 || count > MAX_LEAVES || chunk <= 0 || chunk % VEC ||
      chunk > (1 << 30))
    return false;
  const int64_t mb = moment_bytes(mdtype, 0), vb = moment_bytes(mdtype, 1);
  int64_t total = 0;
  for (int i = 0; i < count; ++i) {
    const int64_t* r = rows + (int64_t)ROW * i;
    Leaf& L = tab.leaf[i];
    L.p = reinterpret_cast<float*>(r[0]);
    L.m = reinterpret_cast<void*>(r[1]);
    L.v = reinterpret_cast<void*>(r[2]);
    L.g = reinterpret_cast<const void*>(r[3]);
    L.n = r[4];
    L.chunk0 = r[5];
    L.gcode = (int32_t)r[6];
    L.head = (int32_t)r[7];
    if (L.n < 1 || L.chunk0 != total || r[6] < 0 || r[6] > 2 || r[7] < -1 ||
        r[7] >= VEC || r[7] > L.n)
      return false;
    const int64_t base = L.head < 0 ? 0 : L.head;
    if (L.head >= 0 &&
        ((r[0] + 4 * base) % 16 || (r[1] + mb * base) % 16 ||
         (r[2] + vb * base) % 16 || (r[3] + elem_bytes(L.gcode) * base) % 16))
      return false;
    const int64_t rest = L.n - base;
    total += rest > 0 ? (rest + chunk - 1) / chunk : 1;
  }
  tab.chunks = total;
  tab.count = count;
  tab.chunk = (int32_t)chunk;
  return true;
}

// h: the hyperparameters (its lr, c1, c2 unused: the kernel reads them).
template <typename M, typename V>
int launch(const Table& tab, const float* sc, const bool* ok, const Hyper& h,
           cudaStream_t st) {
  const int64_t cap = grid_cap<M, V>();
  const int64_t grid = tab.chunks < cap ? tab.chunks : cap;
  adam_tree_kernel<M, V><<<(unsigned)grid, THREADS,
                           NS * stage_bytes<M, V>(), st>>>(
      tab, sc, ok, h.b1, h.omb1, h.b2, h.omb2, h.eps);
  return (int)cudaGetLastError();
}

// The kernel of each mdtype.
cudaError_t attrs(int mdtype, cudaFuncAttributes* a) {
  switch (mdtype) {
    case 0: return cudaFuncGetAttributes(a, adam_tree_kernel<float, float>);
    case 1: return cudaFuncGetAttributes(a, adam_tree_kernel<bf16, bf16>);
    case 2: return cudaFuncGetAttributes(a, adam_tree_kernel<float, bf16>);
    case 3: return cudaFuncGetAttributes(a, adam_tree_kernel<bf16, float>);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// mdtype: the moments' dtypes (0 float32 m and v, 1 bf16 m and v, 2
// float32 m and bf16 v, 3 bf16 m and float32 v). rows: count
// leaves of 8 int64 each: p, m, v and g as device addresses, n, the
// leaf's first chunk, g's dtype code (0 float32, 1 bfloat16, 2 float16)
// and head (-1 or the scalar elements before the 16-byte aligned body).
// chunk: elements a chunk. sc (3,) float32 [lr, c1, c2]; ok a device
// bool or null. b1, 1 - b1, b2, 1 - b2 and eps as float32.
int icikit_adam_tree(int mdtype, const int64_t* rows, int count,
                     int64_t chunk, const float* sc, const bool* ok, float b1,
                     float omb1, float b2, float omb2, float eps,
                     void* stream) {
  Table tab;
  if (mdtype < 0 || mdtype > 3 || !fill(tab, mdtype, rows, count, chunk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Hyper h{b1, omb1, b2, omb2, eps, 0.f, 0.f, 0.f};
  switch (mdtype) {
    case 0: return launch<float, float>(tab, sc, ok, h, st);
    case 1: return launch<bf16, bf16>(tab, sc, ok, h, st);
    case 2: return launch<float, bf16>(tab, sc, ok, h, st);
    default: return launch<bf16, float>(tab, sc, ok, h, st);
  }
}

// Kernel attributes for the build log: which is an mdtype.
int icikit_adam_regs(int which, int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = attrs(which, &attr);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
