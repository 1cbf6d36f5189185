/* icikit_torch native runtime — C ABI (libicikit_torch.so).
 *
 * The port's own copy of the host runtime of icikit/native/src: the
 * counterpart of the reference's C++ runtime layer
 * (Dynamic-Load-Balancing/src/utilities.{h,cc}): crash containment,
 * watchdog, monotonic timing, plus the host-side pieces around the
 * card's compute path — a fast dataset parser and a native
 * peg-solitaire DFS solver the scheduler uses as a host work-queue
 * backend and as the yardstick of the card's DFS kernel
 * (csrc/solitaire.cu). Exposed as a plain C ABI so Python binds via
 * ctypes.
 */
#ifndef ICIKIT_TORCH_NATIVE_H
#define ICIKIT_TORCH_NATIVE_H

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

/* guard.cc — signal traps + runaway-job watchdog (reference chopsigs_,
 * utilities.cc:49-58). Returns 0 on success. */
int ik_install_traps(void);

/* Restore default signal dispositions (undo ik_install_traps). */
int ik_restore_traps(void);
/* Arm (or re-arm) the watchdog alarm; 0 disarms (reference alarm(sleep_time),
 * utilities.cc:57). */
void ik_watchdog(unsigned seconds);
/* Number of trapped fatal signals seen (for tests: handlers normally
 * terminate, but SIGALRM with ik_watchdog_soft(1) only counts). */
int ik_trap_count(void);
/* Soft mode: trapped signals increment the counter instead of exiting
 * (so tests can exercise the handler without dying). */
void ik_watchdog_soft(int enable);

/* timer.cc — monotonic clock (reference get_timer over MPI_Wtime,
 * utilities.cc:61-68; reset-on-read semantics live in Python). */
double ik_monotonic_s(void);
int64_t ik_monotonic_ns(void);

/* dataset.cc — parse a reference-format dataset buffer (count line +
 * 25-char '0'/'1'/'2' board rows, Dynamic-Load-Balancing/src/main.cc:49-66)
 * into peg/playable bitmasks. Returns the number of boards parsed, or
 * a negative error code:
 *  -1 empty/garbled header, -2 bad row length/char, -3 fewer rows than
 *  the header promises, -4 capacity too small. */
int64_t ik_parse_boards(const char* text, size_t len,
                        uint32_t* pegs, uint32_t* playable,
                        int64_t capacity);

/* solver.cc — iterative exhaustive DFS over a 25-cell bitmask board,
 * identical (i, j, dir) move order to the reference validMoveList
 * (game.cc:99-107) and to the card's DFS kernel (csrc/solitaire.cu). Returns 1 solved, 0 exhausted,
 * 2 step limit. n_moves/moves/steps are outputs; moves must hold 25. */
int ik_solve(uint32_t pegs, uint32_t playable, int64_t max_steps,
             int32_t* n_moves, int32_t* moves, int64_t* steps);

/* Solve a batch with an OpenMP-free thread pool + atomic work queue —
 * the native master/worker (reference Server/Client, main.cc:34-193,
 * with tags collapsed into an atomic cursor). chunk_size games are
 * claimed per pull. Outputs are per-board. Returns 0. */
int ik_solve_batch(const uint32_t* pegs, const uint32_t* playable,
                   int64_t n_boards, int64_t max_steps, int n_threads,
                   int chunk_size, uint8_t* solved, int32_t* n_moves,
                   int32_t* moves /* n_boards*25 */, int64_t* steps);

/* Primary entry (r5): ik_solve_batch plus per-board worker telemetry.
 * board_worker (nullable, n_boards) receives the pool worker id that
 * solved each board — 0 is the server thread, 1..n_threads-1 the pool
 * threads. The legacy ik_solve_batch forwards here with nullptr. */
int ik_solve_batch_w(const uint32_t* pegs, const uint32_t* playable,
                     int64_t n_boards, int64_t max_steps, int n_threads,
                     int chunk_size, uint8_t* solved, int32_t* n_moves,
                     int32_t* moves /* n_boards*25 */, int64_t* steps,
                     int32_t* board_worker);

/* markov.cc — synthetic-corpus generator (the trainer's data loader).
 * Fills out[batch][seq+1] with an order-2 Markov chain over [0, vocab):
 * successor table and all draws derive from splitmix64 finalizers of
 * (table_seed, stream_seed, indices), so the stream is a pure function
 * of the seeds — the Python fallback implements the identical
 * arithmetic and produces bit-equal corpora. n_threads 0 = hardware
 * concurrency; rows parallelize freely (draws are per-(row, pos)).
 * Returns 0, or -1 on bad arguments. */
int ik_markov_fill(int32_t vocab, int32_t branch, uint64_t table_seed,
                   uint64_t stream_seed, int64_t batch, int64_t seq,
                   int n_threads, int32_t* out);

#ifdef __cplusplus
}
#endif

#endif /* ICIKIT_TORCH_NATIVE_H */
