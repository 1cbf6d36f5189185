// The peg-solitaire DFS for Hopper (sm_90a), bound with ctypes.
//
//   solve_dfs_kernel (I2) <- no Pallas kernel: in JAX the DFS is a
//      lax.while_loop under vmap, one XLA program a batch
//      (icikit/models/solitaire/game.py:242-313, _solve_one and
//      solve_batch). A plain PyTorch version has to step the batch from
//      the host, some 25 small ops a DFS step and up to max_steps steps
//      a batch (ops/cuda_solitaire.py); one launch a batch is the
//      counterpart of one device program a batch.
//      It computes _solve_one for every board bit for bit: solved,
//      n_moves, moves (-1 past n_moves), steps (one a loop iteration,
//      at most max_steps) and status, with JAX's move order (the first
//      valid move m = cell * 4 + dir at or past the node's resume
//      index) and its dead-end rule (one peg wins, else exhaust at
//      depth 0, else backtrack).
//      Design: one thread a board. The node is held in registers: the
//      pegs mask, the depth and the resume index. The valid moves of a
//      direction are one mask over the 25 cells, formed bit-parallel
//      (holes & geom_d & pegs shifted by the jumped cell & pegs shifted
//      by the jumping cell); the first move at or past the resume index
//      is the least of four (__ffs(mask_d & cells >= lo_d) - 1) * 4 + d.
//      The path is the only stack: a move is undone exactly (the hole
//      refilled, the two cells emptied), so backtracking needs the move
//      taken at the parent and nothing else; the path is 25 bytes a
//      thread in shared memory, column-major by thread (one byte a
//      depth for each of the block's 64 threads).
//      Bound: the dependent chain of one step times max steps (the
//      critical path), or the operations of all steps over the card's
//      32-bit rate, whichever is larger (chip_smoke.py, phase 27). A warp
//      runs until its slowest board is done: lanes that finish early
//      idle (the card's own form of the imbalance the schedulers
//      absorb), and a 20,000-board batch is only 313 blocks of 64.
//
// Every entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;
constexpr int CELLS = 25;
constexpr int MAX_DEPTH = 25;
constexpr int N_MOVES = 100;
constexpr int RUNNING = 0, SOLVED = 1, EXHAUSTED = 2, STEP_LIMIT = 3;

// cells whose move in direction d keeps its jumping peg on the board:
// d 0 jumps from (i+2, j), 1 from (i-2, j), 2 from (i, j+2), 3 from
// (i, j-2) (game.py's _DIRS)
constexpr uint32_t GEOM0 = 0x0007FFFu, GEOM1 = 0x1FFFC00u;
constexpr uint32_t GEOM2 = 0x0739CE7u, GEOM3 = 0x1CE739Cu;

// the least move index m = c * 4 + d >= resume whose direction-d move
// is valid at cell c, or N_MOVES when there is none
__device__ __forceinline__ int first_move(uint32_t cur, uint32_t holes,
                                          int resume) {
  const int rc = resume >> 2, rd = resume & 3;
  // cells c with c * 4 + d >= resume: c >= rc, and c > rc for d < rd
  const uint32_t v0 = GEOM0 & holes & (cur >> 5) & (cur >> 10) &
                      (0xFFFFFFFFu << (rc + (rd > 0)));
  const uint32_t v1 = GEOM1 & holes & (cur << 5) & (cur << 10) &
                      (0xFFFFFFFFu << (rc + (rd > 1)));
  const uint32_t v2 = GEOM2 & holes & (cur >> 1) & (cur >> 2) &
                      (0xFFFFFFFFu << (rc + (rd > 2)));
  const uint32_t v3 = GEOM3 & holes & (cur << 1) & (cur << 2) &
                      (0xFFFFFFFFu << rc);
  const int m0 = v0 ? (__ffs(v0) - 1) * 4 : N_MOVES;
  const int m1 = v1 ? (__ffs(v1) - 1) * 4 + 1 : N_MOVES;
  const int m2 = v2 ? (__ffs(v2) - 1) * 4 + 2 : N_MOVES;
  const int m3 = v3 ? (__ffs(v3) - 1) * 4 + 3 : N_MOVES;
  return min(min(m0, m1), min(m2, m3));
}

// the cells a move touches: the hole it fills, the peg it jumps and the
// peg that jumps; d's cell step is 5, -5, 1, -1 (packed as int8s)
__device__ __forceinline__ void move_cells(int m, uint32_t& dest,
                                           uint32_t& gone) {
  const int c = m >> 2;
  const int step = (int)(int8_t)(0xFF01FB05u >> ((m & 3) * 8));
  dest = 1u << c;
  gone = (1u << (c + step)) | (1u << (c + 2 * step));
}

__global__ void __launch_bounds__(THREADS)
solve_dfs_kernel(const uint32_t* __restrict__ pegs,
                 const uint32_t* __restrict__ playable, int64_t n,
                 int max_steps, uint8_t* __restrict__ solved,
                 int32_t* __restrict__ n_moves, int32_t* __restrict__ moves,
                 int32_t* __restrict__ steps_out,
                 int32_t* __restrict__ status_out) {
  __shared__ uint8_t path[MAX_DEPTH * THREADS];
  const int64_t b = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (b >= n) return;
  uint8_t* my = path + threadIdx.x;
  uint32_t cur = pegs[b];
  const uint32_t play = playable[b];
  int depth = 0, resume = 0, steps = 0, status = RUNNING;
  while (steps < max_steps) {
    ++steps;
    const int m = first_move(cur, play & ~cur, resume);
    if (m < N_MOVES) {  // descend into the first untried valid move
      uint32_t dest, gone;
      move_cells(m, dest, gone);
      my[depth * THREADS] = (uint8_t)m;
      ++depth;
      cur = (cur | dest) & ~gone;
      resume = 0;
      continue;
    }
    // dead end: one peg wins (game.py:286-297), else exhaust or undo
    if (__popc(cur) == 1) {
      status = SOLVED;
      break;
    }
    if (depth == 0) {
      status = EXHAUSTED;
      break;
    }
    --depth;
    const int back = my[depth * THREADS];
    uint32_t dest, gone;
    move_cells(back, dest, gone);
    cur = (cur & ~dest) | gone;
    resume = back + 1;
  }
  if (status == RUNNING) status = STEP_LIMIT;
  const bool won = status == SOLVED;
  solved[b] = won ? 1 : 0;
  n_moves[b] = won ? depth : 0;
  steps_out[b] = steps;
  status_out[b] = status;
  int32_t* row = moves + b * MAX_DEPTH;
#pragma unroll
  for (int k = 0; k < MAX_DEPTH; ++k)
    row[k] = (won && k < depth) ? (int32_t)my[k * THREADS] : -1;
}

static_assert(CELLS * 4 == N_MOVES, "four directions a cell");

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
  const int64_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  solve_dfs_kernel<<<(unsigned)blocks, THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pegs),
      static_cast<const uint32_t*>(playable), n,
      max_steps < 0 ? 0 : max_steps, static_cast<uint8_t*>(solved),
      static_cast<int32_t*>(n_moves), static_cast<int32_t*>(moves),
      static_cast<int32_t*>(steps), static_cast<int32_t*>(status));
  return (int)cudaGetLastError();
}

// Registers and local (spill) bytes a thread of the kernel.
int icikit_solitaire_regs(int which, int* regs, int* local_bytes) {
  if (which != 0) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, solve_dfs_kernel);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

}  // extern "C"
