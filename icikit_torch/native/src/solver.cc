/* Native peg-solitaire DFS solver + threaded work-queue batch entry.
 *
 * The host-side compute backend of the DLB study: the same exhaustive
 * DFS the reference runs per rank (game.cc:121-138), iterative over an
 * explicit stack, with the same (i, j, dir) move enumeration order as
 * validMoveList (game.cc:99-107) — so its solutions are bit-identical
 * to both the reference solver's and the card kernel's
 * (csrc/solitaire.cu). The batch entry
 * is the native master/worker: an atomic chunk cursor plays the server
 * (main.cc:83-103), a thread per core plays the clients — the pull
 * model with the message tags collapsed into shared-memory control
 * flow.
 */
#include "icikit.h"

#include <atomic>
#include <thread>
#include <vector>

namespace {

const int kDim = 5;
const int kCells = kDim * kDim;
const int kMoves = kCells * 4;
const int kMaxDepth = kCells;

struct MoveTables {
  uint32_t dest[kMoves];
  uint32_t mid[kMoves];
  uint32_t far_[kMoves];
  bool geom[kMoves];
  MoveTables() {
    const int di[4] = {1, -1, 0, 0};
    const int dj[4] = {0, 0, 1, -1};
    for (int c = 0; c < kCells; ++c) {
      int i = c / kDim, j = c % kDim;
      for (int d = 0; d < 4; ++d) {
        int m = c * 4 + d;
        int fi = i + 2 * di[d], fj = j + 2 * dj[d];
        dest[m] = 1u << c;
        mid[m] = 0;
        far_[m] = 0;
        geom[m] = fi >= 0 && fi < kDim && fj >= 0 && fj < kDim;
        if (geom[m]) {
          mid[m] = 1u << ((i + di[d]) * kDim + (j + dj[d]));
          far_[m] = 1u << (fi * kDim + fj);
        }
      }
    }
  }
};

const MoveTables T;

inline bool valid_move(uint32_t pegs, uint32_t playable, int m) {
  return T.geom[m] && (pegs & T.mid[m]) && (pegs & T.far_[m]) &&
         (playable & T.dest[m]) && !(pegs & T.dest[m]);
}

}  // namespace

extern "C" int ik_solve(uint32_t pegs, uint32_t playable, int64_t max_steps,
                        int32_t* n_moves, int32_t* moves, int64_t* steps) {
  uint32_t stack_pegs[kMaxDepth + 1];
  int32_t resume[kMaxDepth + 1];
  int32_t path[kMaxDepth];
  int depth = 0;
  stack_pegs[0] = pegs;
  resume[0] = 0;
  int64_t nodes = 0;
  *n_moves = 0;

  for (;;) {
    if (++nodes > max_steps) {
      *steps = nodes - 1;
      return 2; /* step limit */
    }
    uint32_t cur = stack_pegs[depth];
    int m = resume[depth];
    while (m < kMoves && !valid_move(cur, playable, m)) m++;
    if (m < kMoves) { /* descend into first untried valid move */
      resume[depth] = m + 1;
      path[depth] = m;
      depth++;
      stack_pegs[depth] = (cur | T.dest[m]) & ~(T.mid[m] | T.far_[m]);
      resume[depth] = 0;
      continue;
    }
    /* dead end: win iff exactly one peg (game.cc:124-125) */
    if (__builtin_popcount(cur) == 1) {
      *n_moves = depth;
      for (int k = 0; k < depth; ++k) moves[k] = path[k];
      *steps = nodes;
      return 1;
    }
    if (depth == 0) {
      *steps = nodes;
      return 0; /* exhausted */
    }
    depth--;
  }
}

extern "C" int ik_solve_batch_w(const uint32_t* pegs,
                                const uint32_t* playable, int64_t n_boards,
                                int64_t max_steps, int n_threads,
                                int chunk_size, uint8_t* solved,
                                int32_t* n_moves, int32_t* moves,
                                int64_t* steps, int32_t* board_worker) {
  if (n_boards <= 0) return 0;
  if (chunk_size <= 0) chunk_size = 8; /* reference chunk_size, main.cc:15 */
  if (n_threads <= 0) {
    unsigned hw = std::thread::hardware_concurrency();
    n_threads = hw ? (int)hw : 1;
  }
  std::atomic<int64_t> cursor(0);

  /* board_worker (nullable): which pool worker solved each board —
   * the per-worker telemetry the DLB study needs to compare the live
   * queue against simulate_schedule's virtual-clock replay. */
  auto client = [&](int wid) {
    for (;;) {
      int64_t start = cursor.fetch_add(chunk_size); /* work_need -> chunk */
      if (start >= n_boards) return;                /* terminate */
      int64_t end = start + chunk_size;
      if (end > n_boards) end = n_boards;
      for (int64_t b = start; b < end; ++b) {
        int st = ik_solve(pegs[b], playable[b], max_steps, &n_moves[b],
                          &moves[b * kMaxDepth], &steps[b]);
        solved[b] = st == 1 ? 1 : 0;
        if (board_worker) board_worker[b] = wid;
      }
    }
  };

  std::vector<std::thread> pool;
  for (int t = 1; t < n_threads; ++t) pool.emplace_back(client, t);
  client(0); /* the server solves too (main.cc:115-132) */
  for (auto& t : pool) t.join();
  return 0;
}

/* Pre-r5 entry kept for ABI stability (no worker telemetry). */
extern "C" int ik_solve_batch(const uint32_t* pegs, const uint32_t* playable,
                              int64_t n_boards, int64_t max_steps,
                              int n_threads, int chunk_size, uint8_t* solved,
                              int32_t* n_moves, int32_t* moves,
                              int64_t* steps) {
  return ik_solve_batch_w(pegs, playable, n_boards, max_steps, n_threads,
                          chunk_size, solved, n_moves, moves, steps,
                          nullptr);
}
