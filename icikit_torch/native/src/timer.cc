/* Monotonic timing (reference C11, utilities.cc:61-68).
 *
 * The reference wraps MPI_Wtime in a reset-on-read stopwatch; here the
 * clock source is CLOCK_MONOTONIC and the stopwatch/reporting protocol
 * (fence -> read) lives in icikit_torch.utils.timing.
 */
#include "icikit.h"

#include <time.h>

double ik_monotonic_s(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (double)ts.tv_sec + (double)ts.tv_nsec * 1e-9;
}

int64_t ik_monotonic_ns(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (int64_t)ts.tv_sec * 1000000000LL + (int64_t)ts.tv_nsec;
}
