"""Hardened local-socket helpers: a copy of ``icikit.utils.net`` for the
port, which imports nothing of the JAX package. The port's users are the
two-process bring-up (``icikit_torch.examples.multihost``, its test and
``chip_smoke.py``'s two-process phase), which claim a coordinator port
with :func:`free_port` and retry on a fresh one when a child's output
carries one of :data:`PORT_RACE_SIGS`.

JAX's module docstring follows.

Hardened local-socket helpers shared by every test/tool that needs
a port.

Extracted from ``tests/test_multihost.py``'s two-process bring-up test,
which learned these the hard way (both were real flake modes on CI
hosts):

- a plain claim/release of an OS-assigned port leaves the socket in
  ``TIME_WAIT`` on some hosts, so the next binder of that port fails —
  ``SO_REUSEADDR`` on the probe socket (and on the real server socket)
  lets the port rebind immediately;
- port races are transient: two probes can hand out the same port
  before either binder claims it for real. The honest policy is
  retry-on-a-fresh-port a bounded number of times, and only *then*
  treat the failure as environmental.

(The fleet coordinator and transport that use JAX's copy wait for
ROADMAP A11 in the port.)
"""

from __future__ import annotations

import socket

# stderr signatures of a lost port race (vs a structural failure) —
# shared so retry loops in tests and tools agree on what "transient"
# means
PORT_RACE_SIGS = ("Address already in use", "Failed to bind",
                  "errno: 98")


def free_port(host: str = "localhost") -> int:
    """Claim-then-release an OS-assigned port with ``SO_REUSEADDR`` so
    the caller can rebind it immediately. Raises ``OSError`` when no
    local port can be bound at all (callers in tests typically map
    that to a skip — the failure is environmental, not logical)."""
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, 0))
        return s.getsockname()[1]


def server_socket(host: str, port: int, backlog: int = 16,
                  reuse: bool = True) -> socket.socket:
    """A bound, listening TCP socket (``port=0`` = OS-assigned).
    ``SO_REUSEADDR`` by default: a restarted server (the coordinator
    restart-rewarm path) must be able to rebind its old port without
    waiting out ``TIME_WAIT``."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        if reuse:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, port))
        s.listen(backlog)
    except BaseException:
        s.close()
        raise
    return s
