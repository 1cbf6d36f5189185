"""icikit_torch.bench.schedule_stats against icikit.bench.schedule_stats.

JAX counts a schedule's communication by walking its jaxpr; the port
runs the same schedule once on ``meta`` tensors and counts the calls it
makes through the transport and the vendor sites. For every (family,
algorithm) registered in both packages at p in {2, 4, 8, 16, 6}, every
sort at p in {2, 4, 8}, and the two rendered tables, the port's
``rounds``, ``calls``, ``bytes_per_dev`` and ``vendor_calls`` equal
JAX's exactly (at p = 6 a power-of-two schedule raises in both). One
parametrised test, a case each.
"""

from __future__ import annotations

import pytest

from icikit.bench import schedule_stats as J
from icikit.utils.mesh import UnsupportedMeshError as JUnsupported
from icikit.utils.registry import list_algorithms as j_list
from icikit_torch.bench import schedule_stats as T
from icikit_torch.utils.mesh import UnsupportedMeshError
from icikit_torch.utils.registry import list_algorithms as t_list

import icikit.parallel  # noqa: F401  (registers JAX's families)
import icikit_torch.parallel  # noqa: F401  (registers the port's)

FAMILIES = ("allgather", "alltoall", "allreduce", "reducescatter",
            "reduce", "scan", "broadcast", "scatter", "gather")
PS = (2, 4, 8, 16, 6)
SORTS = ("bitonic", "sample", "sample_bitonic", "quicksort")
MSIZE = 256
SORT_N = 1 << 14

CASES = ([("collective", f, a, p) for f in FAMILIES
          for a in sorted(set(j_list(f)) & set(t_list(f))) for p in PS]
         + [("sort", None, a, p) for a in SORTS for p in (2, 4, 8)]
         + [("render", None, "collectives", 0),
            ("render", None, "sorts", 0)])


def _counts(st):
    return st.rounds, st.calls, st.bytes_per_dev, st.vendor_calls


def _tables(md: str) -> list:
    """The rendered tables: the family headings and the table rows."""
    return [ln for ln in md.splitlines() if ln.startswith(("|", "###"))]


@pytest.mark.parametrize("kind,family,alg,p", CASES,
                         ids=[f"{k}-{f}-{a}-{p}" for k, f, a, p in CASES])
def test_counts_equal_jax(kind, family, alg, p):
    if kind == "render":
        if alg == "collectives":
            kw = dict(ps=(4, 8, 6), msize=64,
                      families=("allgather", "alltoall", "scan"))
            assert _tables(T.render_markdown(**kw)) == \
                _tables(J.render_markdown(**kw))
        else:
            kw = dict(ps=(2, 4), n=1 << 12)
            assert _tables(T.render_sort_markdown(**kw)) == \
                _tables(J.render_sort_markdown(**kw))
        return
    if kind == "sort":
        got = T.analyze_sort(alg, p, SORT_N)
        want = J.analyze_sort(alg, p, SORT_N)
    else:
        try:
            want = J.analyze_collective(family, alg, p, MSIZE)
        except JUnsupported:
            with pytest.raises(UnsupportedMeshError):
                T.analyze_collective(family, alg, p, MSIZE)
            return
        got = T.analyze_collective(family, alg, p, MSIZE)
    assert (got.family, got.algorithm, got.p, got.msize) == \
        (want.family, want.algorithm, want.p, want.msize)
    assert _counts(got) == _counts(want)
