/* Crash containment + watchdog (reference C10, utilities.cc:18-58).
 *
 * The reference traps SIGBUS/SEGV/ILL/SYS/FPE/ALRM into an error line
 * plus MPI_Abort so a crashing rank cannot wedge the batch queue. The
 * single-process runtime keeps the same discipline: fatal signals
 * produce one diagnostic line and a hard exit (an async device runtime
 * can otherwise hang on a wedged device thread). A soft mode lets tests
 * exercise the handler without dying.
 */
#include "icikit.h"

#include <signal.h>
#include <stdio.h>
#include <stdlib.h>
#include <unistd.h>

static volatile sig_atomic_t g_soft = 0;
static volatile sig_atomic_t g_traps = 0;

static const char* signame(int sig) {
  switch (sig) {
    case SIGBUS:  return "a bus error";
    case SIGSEGV: return "a segmentation violation";
    case SIGILL:  return "an illegal instruction";
    case SIGSYS:  return "an illegal system call";
    case SIGFPE:  return "a floating point exception";
    case SIGALRM: return "the watchdog alarm (runaway job)";
    default:      return "an unexpected signal";
  }
}

static void trap_handler(int sig) {
  g_traps = g_traps + 1;
  if (g_soft) return;
  /* write() is async-signal-safe; fprintf is not. */
  const char* pre = "ERROR: icikit terminated due to ";
  const char* name = signame(sig);
  ssize_t r;
  r = write(2, pre, 32);
  size_t n = 0; while (name[n]) n++;
  r = write(2, name, n);
  r = write(2, "\n", 1);
  (void)r;
  _exit(2);
}

static const int kTrapSigs[] = {SIGBUS, SIGSEGV, SIGILL,
                                SIGSYS, SIGFPE, SIGALRM};
#define IK_NTRAPS (sizeof(kTrapSigs) / sizeof(kTrapSigs[0]))
static struct sigaction g_saved[IK_NTRAPS];
static int g_saved_valid = 0;

int ik_install_traps(void) {
  struct sigaction sa;
  sa.sa_handler = trap_handler;
  sigemptyset(&sa.sa_mask);
  sa.sa_flags = 0;
  /* Snapshot every old disposition before installing any: a partial
   * install that failed midway must not leave g_saved half-filled, or
   * a later successful install would snapshot the trap handler itself
   * and ik_restore_traps would "restore" it instead of the original. */
  struct sigaction old[IK_NTRAPS];
  if (!g_saved_valid)
    for (size_t i = 0; i < IK_NTRAPS; ++i)
      if (sigaction(kTrapSigs[i], NULL, &old[i]) != 0) return -1;
  for (size_t i = 0; i < IK_NTRAPS; ++i)
    if (sigaction(kTrapSigs[i], &sa, NULL) != 0) {
      /* roll back the prefix already replaced */
      if (!g_saved_valid)
        for (size_t j = 0; j < i; ++j)
          sigaction(kTrapSigs[j], &old[j], NULL);
      return -1;
    }
  if (!g_saved_valid) {
    for (size_t i = 0; i < IK_NTRAPS; ++i) g_saved[i] = old[i];
    g_saved_valid = 1;
  }
  return 0;
}

/* Undo ik_install_traps: put back the dispositions that were active
 * before the FIRST install (repeat installs don't clobber the saved
 * set), so a host process keeps its own handlers — e.g. pytest's
 * faulthandler — instead of being forced to SIG_DFL. A disarmed
 * process must behave like an untouched one: the trap handler
 * hard-exits, which turns benign teardown-time signals into a
 * truncated-output death (observed: the full suite "failing" with
 * exit 2 after every test passed). */
int ik_restore_traps(void) {
  if (!g_saved_valid) return 0;
  for (size_t i = 0; i < IK_NTRAPS; ++i)
    if (sigaction(kTrapSigs[i], &g_saved[i], NULL) != 0) return -1;
  /* a new install/restore pair must re-snapshot, or it would reinstate
   * this (now stale) set over handlers installed in between */
  g_saved_valid = 0;
  return 0;
}

void ik_watchdog(unsigned seconds) { alarm(seconds); }

int ik_trap_count(void) { return (int)g_traps; }

void ik_watchdog_soft(int enable) { g_soft = enable ? 1 : 0; }
