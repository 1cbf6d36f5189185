/* Synthetic-corpus generator: order-2 Markov chain, seed-pure.
 *
 * The reference generates benchmark inputs with a deterministic
 * seed-chained RNG so any process count sees the same global sequence
 * (Parallel-Sorting/src/psort.cc:575-614). The trainer's corpus keeps
 * that property: every value is a splitmix64
 * finalizer of (seed, index) — no chain, so rows fill in parallel and
 * the Python fallback (vectorized uint64 numpy) matches bit-for-bit.
 */
#include "icikit.h"

#include <cstdint>
#include <thread>
#include <vector>

namespace {

inline uint64_t mix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

/* uniform in [0, 1): top 53 bits, exactly as the numpy fallback */
inline double u01(uint64_t x) {
  return static_cast<double>(x >> 11) * (1.0 / 9007199254740992.0);
}

}  // namespace

extern "C" int ik_markov_fill(int32_t vocab, int32_t branch,
                              uint64_t table_seed, uint64_t stream_seed,
                              int64_t batch, int64_t seq, int n_threads,
                              int32_t* out) {
  if (vocab <= 0 || branch <= 0 || batch < 0 || seq < 1 || !out)
    return -1;
  /* geometric-ish branch CDF: weights branch..1 */
  std::vector<double> cum(branch);
  double total = 0.0;
  for (int j = 0; j < branch; ++j) total += branch - j;
  double acc = 0.0;
  for (int j = 0; j < branch; ++j) {
    acc += (branch - j) / total;
    cum[j] = acc;
  }

  auto succ = [=](int64_t a, int64_t b, int64_t j) -> int32_t {
    uint64_t h = mix64(table_seed ^ mix64((uint64_t)(a * vocab + b))
                       ^ (uint64_t)j * 0xD6E8FEB86659FD93ull);
    return (int32_t)(h % (uint64_t)vocab);
  };

  auto fill_rows = [&](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
      int32_t* row = out + r * (seq + 1);
      /* hash the (small-integer) stream seed: adjacent raw seeds would
       * otherwise yield shifted-identical draw streams (base + t) */
      uint64_t base = mix64(stream_seed) ^ mix64((uint64_t)r);
      row[0] = (int32_t)(mix64(base ^ 0x243F6A8885A308D3ull)
                         % (uint64_t)vocab);
      row[1] = (int32_t)(mix64(base ^ 0x13198A2E03707344ull)
                         % (uint64_t)vocab);
      for (int64_t t = 2; t <= seq; ++t) {
        double u = u01(mix64(base + (uint64_t)t));
        int pick = 0;
        while (pick < branch - 1 && u >= cum[pick]) ++pick;
        row[t] = succ(row[t - 2], row[t - 1], pick);
      }
    }
  };

  int hw = n_threads > 0 ? n_threads
                         : (int)std::thread::hardware_concurrency();
  if (hw < 1) hw = 1;
  if (hw == 1 || batch < 2 * hw) {
    fill_rows(0, batch);
    return 0;
  }
  std::vector<std::thread> pool;
  int64_t per = (batch + hw - 1) / hw;
  for (int i = 0; i < hw; ++i) {
    int64_t r0 = i * per, r1 = std::min<int64_t>(batch, r0 + per);
    if (r0 >= r1) break;
    pool.emplace_back(fill_rows, r0, r1);
  }
  for (auto& t : pool) t.join();
  return 0;
}
