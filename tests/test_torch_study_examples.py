"""The port's study examples on the CPU: ``dryrun_multichip`` (the twin
of ``__graft_entry__.dryrun_multichip``, JAX's asserts) at p = 8 and at
a p that is not a power of two, and ``collectives_study`` (every
allgather and alltoall schedule at p = 8, every record verified) with
the same variants and sizes as JAX's study."""

from __future__ import annotations

import pytest

from icikit_torch.examples import collectives_study
from icikit_torch.examples.dryrun_multichip import dryrun_multichip


@pytest.mark.parametrize("p", [8, 6])
def test_dryrun_multichip_on_the_cpu(p):
    dryrun_multichip(p, device="cpu")


def test_collectives_study_on_the_cpu():
    from icikit.utils.registry import list_algorithms

    import icikit.parallel  # noqa: F401  (registers JAX's families)

    records = collectives_study.study("cpu", runs=1)
    assert all(r.verified for r in records)
    want = {(f, a, m) for f in ("allgather", "alltoall")
            for a in list_algorithms(f) for m in (256, 4096)}
    assert {(r.family, r.algorithm, r.msize) for r in records} == want
    assert {r.p for r in records} == {8}
