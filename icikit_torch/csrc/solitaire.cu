// The peg-solitaire DFS for Hopper (sm_90a), bound with ctypes.
//
//   solve_dfs_kernel (I2) <- no Pallas kernel: in JAX the DFS is a
//      lax.while_loop under vmap, one XLA program a batch
//      (icikit/models/solitaire/game.py:242-313, _solve_one and
//      solve_batch). A plain PyTorch version has to step the batch from
//      the host, some 25 small ops a DFS step and up to max_steps steps
//      a batch (ops/cuda_solitaire.py); one launch a batch is the
//      counterpart of one device program a batch.
//      One thread a board at a time runs solitaire_dfs.cuh's
//      solve_lane, which computes _solve_one bit for bit and says how
//      (the node's untried moves carried on the path, the parent's entry
//      loaded as a step starts, one predicated update a step, a warp's
//      steps in groups). The path is 25 slots of 16 + 4 bytes a thread
//      in shared memory, column-major by thread: 32,000 bytes a block
//      of 64.
//      A step issues some 38 instructions on the integer pipe (52 in
//      all, cuobjdump -sass), at half a warp-instruction a clock on a
//      scheduler, so two long warps on one scheduler each step at half
//      speed. The grid is therefore at most BLOCKS_PER_SM
//      blocks of two warps an SM, one warp a scheduler; a block takes a
//      contiguous range of boards, its lanes start on its first 64 and
//      each lane whose board stops takes the range's next (a counter in
//      shared memory).
//      Bound: the dependent chain of one step times max steps (the
//      critical path), or the operations of all steps over the card's
//      32-bit rate, whichever is larger (chip_smoke.py, phase 27). Once
//      its block's range is spent a lane idles until its warp's slowest
//      board is done: the card's own form of the imbalance the
//      schedulers absorb.
//
// Every entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "solitaire_dfs.cuh"

namespace {

constexpr int THREADS = 64;
constexpr int BLOCKS_PER_SM = 2;

__global__ void __launch_bounds__(THREADS)
solve_dfs_kernel(const dfs::Batch bt, int64_t n, int64_t per_block) {
  __shared__ dfs::Moves path_moves[dfs::SLOTS * THREADS];
  __shared__ uint32_t path_togs[dfs::SLOTS * THREADS];
  __shared__ unsigned taken;  // boards of the range handed out
  const int64_t first = (int64_t)blockIdx.x * per_block;
  const int count = (int)(first + per_block < n ? per_block : n - first);
  if (threadIdx.x == 0) taken = THREADS;
  __syncthreads();
  // lanes without a board stay in the loop, stopped, so a warp votes
  // whole
  dfs::solve_lane(bt, first, count, threadIdx.x, path_moves + threadIdx.x,
                  path_togs + threadIdx.x, THREADS,
                  [&]() { return (int)atomicAdd(&taken, 1u); });
}

}  // namespace

extern "C" {

// Solve n boards: pegs, playable (n,) uint32 in; solved (n,) uint8,
// n_moves, steps, status (n,) int32 and moves (n, 25) int32 out, all
// contiguous. max_steps >= 0 (a negative budget is 0).
int icikit_solve_dfs(const void* pegs, const void* playable, int64_t n,
                     int max_steps, void* solved, void* n_moves, void* moves,
                     void* steps, void* status, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int64_t wave =
      std::min((n + THREADS - 1) / THREADS, (int64_t)sms * BLOCKS_PER_SM);
  const int64_t per_block = (n + wave - 1) / wave;
  const int64_t blocks = (n + per_block - 1) / per_block;  // none empty
  if (per_block > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const dfs::Batch bt{static_cast<const uint32_t*>(pegs),
                      static_cast<const uint32_t*>(playable),
                      max_steps < 0 ? 0 : max_steps,
                      static_cast<uint8_t*>(solved),
                      static_cast<int32_t*>(n_moves),
                      static_cast<int32_t*>(moves),
                      static_cast<int32_t*>(steps),
                      static_cast<int32_t*>(status)};
  solve_dfs_kernel<<<(unsigned)blocks, THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(bt, n, per_block);
  return (int)cudaGetLastError();
}

// Registers, local (spill) bytes and static shared bytes a thread
// block of the kernel.
int icikit_solitaire_regs(int which, int* regs, int* local_bytes,
                          int* shared_bytes) {
  if (which != 0) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, solve_dfs_kernel);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *shared_bytes = (int)a.sharedSizeBytes;
  return 0;
}

}  // extern "C"
