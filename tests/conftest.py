"""Test configuration: simulate an 8-device mesh on CPU.

The reference could only test multi-rank behavior on a real PBS cluster
(SURVEY.md §4.6); here XLA's host-platform device-count simulation makes
"multi-node without a cluster" an actual capability. These env vars must
be set before jax is imported anywhere.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # force: the env may pre-select a TPU
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

# Plugins (jaxtyping) may import jax before this conftest runs, locking in
# env-derived config defaults — override via the config API, which works
# any time before backend initialization.
jax.config.update("jax_platforms", "cpu")
try:
    jax.config.update("jax_num_cpu_devices", 8)
except AttributeError:
    # jax < 0.5 has no such option; the XLA_FLAGS fallback above
    # already forced the 8-device host-platform simulation
    pass

# Persistent XLA compilation cache (round 14): the module-boundary
# clear_caches() fixture below bounds memory by dropping compiled
# executables — at the price of recompiling shared programs in every
# later module, which makes the near-full suite compile-bound on this
# CPU image. The on-disk cache turns those recompiles into disk hits
# (within one run AND across runs) while the in-memory profile stays
# bounded. ICIKIT_JAX_CACHE=off disables; any other value overrides
# the cache directory.
_cache_dir = os.environ.get("ICIKIT_JAX_CACHE",
                            "/tmp/icikit_jax_cache")
if _cache_dir != "off":
    try:
        jax.config.update("jax_compilation_cache_dir", _cache_dir)
        jax.config.update(
            "jax_persistent_cache_min_compile_time_secs", 0.1)
    except AttributeError:
        pass    # older jax without the persistent cache: no-op

from icikit.utils.mesh import make_mesh  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test (subprocess scale points, "
        "big fixtures)")
    config.addinivalue_line(
        "markers", "chaos: fault-injection soak test (worker death, "
        "stragglers, bit-flips, I/O faults; run via `make chaos`)")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (icikit_torch kernels); "
        "skips without one")


@pytest.fixture(scope="session")
def mesh8():
    return make_mesh(8)


@pytest.fixture(scope="session")
def mesh4():
    return make_mesh(4)


@pytest.fixture(scope="session")
def mesh1():
    return make_mesh(1)


@pytest.fixture(scope="session", autouse=True)
def _check_devices():
    assert jax.device_count() >= 8, (
        "expected >= 8 simulated CPU devices; XLA_FLAGS not applied?")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled-program caches at each module boundary: with ~580
    tests in one process the accumulated executables/tracing caches
    drove the XLA:CPU compiler into a segfault near the end of the
    suite (reproducibly, in a test that passes standalone). Costs some
    recompilation; buys a bounded memory profile."""
    yield
    import gc

    jax.clear_caches()
    gc.collect()


_EXIT_STATUS = [0]
_TESTS_RUN = [0]


def pytest_runtest_logreport(report):
    if report.when == "call":
        _TESTS_RUN[0] += 1


@pytest.hookimpl(trylast=True)
def pytest_sessionfinish(session, exitstatus):
    _EXIT_STATUS[0] = int(exitstatus)


@pytest.hookimpl(trylast=True)
def pytest_unconfigure(config):
    """Skip interpreter teardown: with ~580 tests in one process the
    XLA:CPU runtime segfaults on shutdown (exit 139 — and, before
    guard.disarm() restored signal dispositions, the trap handler's
    exit 2 with truncated output — after every test passed). By
    unconfigure the terminal summary has printed; trylast lets other
    plugins' unconfigure finalizers (log files, coverage) complete
    first, then exit with pytest's own status before the faulty
    destructors run. Scoped: small targeted runs (the dev loop) keep
    normal interpreter shutdown — the crash needs the accumulated
    program count of a near-full suite — so genuine teardown
    regressions stay visible outside full-suite runs. Escape hatch:
    ICIKIT_NO_EARLY_EXIT=1 always restores normal shutdown."""
    if os.environ.get("ICIKIT_NO_EARLY_EXIT"):
        return
    if _TESTS_RUN[0] < 200:  # segfault observed only near ~576 programs
        return
    import logging
    import sys

    logging.shutdown()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(_EXIT_STATUS[0])
