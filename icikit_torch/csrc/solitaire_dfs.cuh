// One lane's peg-solitaire DFS, for the card and for the host.
//
// solitaire.cu runs solve_lane once a thread (the path in shared
// memory, column-major by thread). The header includes no CUDA header,
// so tests/test_torch_solitaire_host_dfs.py compiles it with g++ and
// runs one lane over every board (path stride 1), with stubs for the
// card's __ffs, __popc, __any_sync and __reduce_min_sync.
//
// A board's search computes JAX's _solve_one (icikit/models/solitaire/
// game.py:242-308) bit for bit: solved, n_moves, moves (-1 past
// n_moves), steps (one a loop iteration, at most max_steps) and status,
// with JAX's move order (the first valid move m = cell * 4 + dir at or
// past the node's resume index) and its dead-end rule (one peg wins,
// else exhaust at depth 0, else backtrack).
//
// Design: a DFS step is one dependent chain, and a warp issues its
// integer instructions at half a warp-instruction a clock, so the step
// keeps both its chain and its instruction count short, and the same in
// every lane of a warp.
// - A node carries its untried valid moves as four 25-bit cell masks,
//   one a direction. A descend forms the child's masks once
//   (bit-parallel: holes, geometry, the board shifted by the jumped and
//   the jumping cell); the next move is the lowest cell of their union
//   and the lowest direction holding it, which is JAX's first valid move
//   past the old resume index. There is no resume index and no mask is
//   formed again on a backtrack.
// - The path is the only stack: entry k holds node k's untried moves
//   (the chosen one cleared, 16 bytes) and the three cells its move
//   toggles (4 bytes), so a backtrack pops the parent's moves and undoes
//   the move exactly. The move index itself is not kept: the output row
//   replays the toggles from the start, and a move's hole is the one of
//   its three cells that is empty before it.
// - Every step loads the parent's entry as it starts, so the load's
//   latency passes under the step's own work: a backtrack uses it at the
//   step's end, a descend drops it. A descend stores the new entry,
//   which does not stall. (A form that kept the top entry in registers
//   and the move index on the path took some 16 more selects a step and
//   nearly twice the cycles.)
// - Descend and dead end are one predicated update, with no branch: the
//   lanes of a warp never split. The lanes step in groups of UNROLL; one
//   vote between two groups asks whether a board stopped, and only then
//   do the lanes write their stopped boards and take new ones.
// - A move fills one hole and empties two cells, none past cell 24, so
//   popc(cur) == popc(pegs) - depth: JAX's win test, popc(cur) == 1, is
//   depth == popc(pegs) - 1.

#pragma once

#include <stdint.h>

// The card's build marks the functions __device__ only: nvcc refuses a
// __host__ __device__ function that calls __ffs, __popc, __any_sync or
// __reduce_min_sync, which exist only on the card. A host build brings
// its own.
#ifdef __CUDACC__
#define DFS_FN __device__ __forceinline__
#else
#define DFS_FN inline
#endif

namespace dfs {

constexpr int MAX_DEPTH = 25;
constexpr int SLOTS = MAX_DEPTH;  // entries -1..23 (a board's depth <= 23)
constexpr int SOLVED = 1, EXHAUSTED = 2, STEP_LIMIT = 3;
constexpr int UNROLL = 32;  // steps between two votes of a warp

// cells whose move in direction d keeps its jumping peg on the board:
// d 0 jumps from (i+2, j), 1 from (i-2, j), 2 from (i, j+2), 3 from
// (i, j-2) (game.py's _DIRS)
constexpr uint32_t GEOM0 = 0x0007FFFu, GEOM1 = 0x1FFFC00u;
constexpr uint32_t GEOM2 = 0x0739CE7u, GEOM3 = 0x1CE739Cu;

// a path entry's untried moves, one cell mask a direction
struct alignas(16) Moves {
  uint32_t m0, m1, m2, m3;
};

// JAX's move index c * 4 + d of the move that toggles cells tog from
// pegs x: its hole c is the toggled cell empty in x; d is 0 or 1 for a
// vertical jump, 2 or 3 for a horizontal one, odd when the hole is the
// highest of the three cells
DFS_FN int32_t move_index(uint32_t tog, uint32_t x) {
  const uint32_t dest = tog & ~x;
  const bool vertical = (tog & ((dest << 5) | (dest >> 5))) != 0;
  const bool high = dest != (tog & (0u - tog));
  return (__ffs(dest) - 1) * 4 + (vertical ? 0 : 2) + (high ? 1 : 0);
}

struct Board {
  uint32_t cur;             // the node's pegs
  uint32_t g0, g1, g2, g3;  // playable & GEOMd: where a move may land
  uint32_t a0, a1, a2, a3;  // the node's untried valid moves
  uint32_t live;            // ~0 while the board runs, else 0
  int depth, win, steps;
  Moves* moves;    // entry k's moves at moves[(k + 1) * stride]
  uint32_t* togs;  // and its move's cells at togs[(k + 1) * stride]
  int stride;

  // the valid moves at pegs c, one mask a direction: a hole (playable,
  // empty) with pegs on the next two cells of the direction
  DFS_FN void form(uint32_t c, uint32_t& v0, uint32_t& v1, uint32_t& v2,
                   uint32_t& v3) const {
    const uint32_t r5 = c & (c >> 5), r1 = c & (c >> 1);  // a peg pair
    v0 = g0 & ~c & (r5 >> 5);
    v1 = g1 & ~c & (r5 << 10);
    v2 = g2 & ~c & (r1 >> 1);
    v3 = g3 & ~c & (r1 << 2);
  }

  DFS_FN void start(uint32_t pegs, uint32_t playable, bool running) {
    cur = pegs;
    g0 = playable & GEOM0;
    g1 = playable & GEOM1;
    g2 = playable & GEOM2;
    g3 = playable & GEOM3;
    form(cur, a0, a1, a2, a3);
    live = running ? ~0u : 0u;
    depth = steps = 0;
    win = __popc(pegs) - 1;
  }

  // One DFS step, JAX's loop body. A lane that has stopped takes no
  // move and stays at its terminal depth, so the step leaves it as it
  // is.
  DFS_FN void step() {
    const Moves p = moves[depth * stride];  // the parent's entry
    const uint32_t ptog = togs[depth * stride];
    const uint32_t a012 = a0 | a1 | a2;
    const uint32_t any = (a012 | a3) & live;
    const uint32_t lsb = any & (0u - any);  // the next move's hole
    // lsb in the lowest direction that holds it, 0 in the others
    const uint32_t h0 = a0 & lsb, h1 = a1 & lsb & ~a0;
    const uint32_t h2 = a2 & lsb & ~(a0 | a1), h3 = lsb & ~a012;
    const uint32_t tog = (h0 + (h1 >> 10)) * 0x421u + (h2 + (h3 >> 2)) * 7u;
    const bool has = any != 0;
    const bool pop = !has && depth != win && depth != 0;
    const uint32_t c = cur ^ tog ^ (pop ? ptog : 0u);
    uint32_t v0, v1, v2, v3;
    form(c, v0, v1, v2, v3);
    if (has) {  // push this node's entry
      const int k = (depth + 1) * stride;
      moves[k] = Moves{a0 ^ h0, a1 ^ h1, a2 ^ h2, a3 ^ h3};
      togs[k] = tog;
    }
    a0 = has ? v0 : p.m0;
    a1 = has ? v1 : p.m1;
    a2 = has ? v2 : p.m2;
    a3 = has ? v3 : p.m3;
    cur = c;
    depth += (int)has - (int)pop;
    steps -= (int)live;  // live is ~0, -1 as an int, while it runs
    live = (has || pop) ? ~0u : 0u;
  }
};

// A launch's boards and its five outputs (JAX's solve_batch).
struct Batch {
  const uint32_t* pegs;
  const uint32_t* playable;
  int max_steps;
  uint8_t* solved;
  int32_t* n_moves;
  int32_t* moves;
  int32_t* steps;
  int32_t* status;
};

// Write board b's row of the five outputs from its stopped (or capped)
// search, replaying the path's toggles for the moves of a win.
DFS_FN void write_row(const Batch& out, int64_t b, const Board& s) {
  const bool running = s.live != 0;
  const bool won = !running && s.depth == s.win;
  out.solved[b] = won ? 1 : 0;
  out.n_moves[b] = won ? s.depth : 0;
  out.steps[b] = s.steps;
  out.status[b] = running ? STEP_LIMIT : won ? SOLVED : EXHAUSTED;
  int32_t* row = out.moves + b * MAX_DEPTH;
  uint32_t x = out.pegs[b];
#pragma unroll
  for (int k = 0; k < MAX_DEPTH; ++k) {
    int32_t m = -1;
    if (won && k < s.depth) {
      const uint32_t tog = s.togs[(k + 1) * s.stride];
      m = move_index(tog, x);
      x ^= tog;
    }
    row[k] = m;
  }
}

// One lane's boards: the block's range starts at board first and holds
// count boards; the lane takes offset i first (none when i >= count),
// then the offset next() hands out each time its board stops or
// reaches max_steps. The lanes of a warp step together, in groups of
// UNROLL steps, or one step while a running board has fewer steps left
// (left, the same in every lane). Between two groups one vote asks
// whether a board stopped; only then are the stopped and capped boards
// written and replaced and left taken again (a reduction).
// The path: SLOTS entries, slot k at moves[k * stride] and
// togs[k * stride] (slot 0 stands for the root's parent).
template <class Next>
DFS_FN void solve_lane(const Batch& bt, int64_t first, int count, int i,
                       Moves* moves, uint32_t* togs, int stride,
                       Next next) {
  Board s;
  s.moves = moves;
  s.togs = togs;
  s.stride = stride;
  s.start(i < count ? bt.pegs[first + i] : 0u,
          i < count ? bt.playable[first + i] : 0u, i < count);
  unsigned left = 0;
  for (;;) {
    if (left == 0) {
      // a board can stop before its first step (max_steps 0)
      while (i < count && (s.live == 0 || s.steps >= bt.max_steps)) {
        write_row(bt, first + i, s);
        i = next();
        s.start(i < count ? bt.pegs[first + i] : 0u,
                i < count ? bt.playable[first + i] : 0u, i < count);
      }
      left = __reduce_min_sync(
          0xFFFFFFFFu, i < count ? (unsigned)(bt.max_steps - s.steps) : ~0u);
      if (left == ~0u) break;  // no lane holds a board
    }
    if (left >= UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) s.step();
      left -= UNROLL;
    } else {
      s.step();
      left -= 1;
    }
    if (__any_sync(0xFFFFFFFFu, s.live == 0 && i < count)) left = 0;
  }
}

}  // namespace dfs
