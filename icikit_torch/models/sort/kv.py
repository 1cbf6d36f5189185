"""Distributed key-value sort and argsort.

The reference sorts bare keys (``Parallel-Sorting/src/psort.cc`` works
on ``double`` arrays only); this is the JAX package's key-value form
(``icikit.models.sort.kv``), built on the sample-sort pipeline (local
sort, splitters, bucket route, final local sort): the routing is
derived from the keys and applied to keys and values alike through the
capacity-padded ragged exchange, and every local sort is stable, so
values follow their keys exactly.

Stability is end to end: equal keys keep their global input order
(``searchsorted`` with ``right=False`` sends every instance of a
splitter value to one bucket, received rows concatenate in source-rank
order, and the local sorts are stable). ``argsort_dist`` rests on it:
sorting (keys, global indices) yields ``torch.argsort(keys,
stable=True)``.

JAX's local sorts here are a stable multi-operand ``lax.sort`` (XLA,
not a Pallas kernel); their counterpart is ``torch.sort(stable=True)``
and a gather, and no kernel of the port runs in this module's sorts.
Validity through the padded exchange is an explicit flag sorted as the
*primary* key (invalid lanes last; a second stable sort), not a
sentinel key value, so keys equal to the dtype's maximum stay paired
with their values. uint32 keys ride as their order-preserving int32
image.

Across processes (a mesh split over ``torch.distributed`` processes)
``keys`` and ``values`` are this process's part, as in ``sort``: the
routing crosses as the sample sort's does, the values ride the same
ragged exchanges, and the result is this process's part of the sorted
pairs.
"""

from __future__ import annotations

import torch

from icikit_torch.models.sort.common import (prepare_blocks,
                                             ragged_all_to_all,
                                             ragged_payload,
                                             rebalance_sorted)
from icikit_torch.models.sort.sample import (bucket_route,
                                             run_with_capacity_retry)
from icikit_torch.ops.cuda_sort import _i32_as_u32, _u32_as_i32
from icikit_torch.parallel.shmap import on_mesh
from icikit_torch.utils.dtypes import sentinel_for
from icikit_torch.utils.mesh import DEFAULT_AXIS


def _sort_kv_local(k: torch.Tensor, v: torch.Tensor, valid=None):
    """Stable sort of each row of ``k`` (rows, n), carrying ``v``; with
    ``valid``, valid lanes first: the order of (not valid, key), as two
    stable sorts, the key's first."""
    k, idx = torch.sort(k, dim=-1, stable=True)
    v = v.gather(-1, idx)
    if valid is None:
        return k, v
    inval = (~valid.gather(-1, idx)).to(torch.int32)
    idx = torch.sort(inval, dim=-1, stable=True).indices
    return k.gather(-1, idx), v.gather(-1, idx)


def sample_sort_kv_shard(k: torch.Tensor, v: torch.Tensor, p: int,
                         cap: int, splitter: str):
    """Rank-vectorised KV sample sort of (p, n_loc) keys and values (or
    under a process view this process's ranks). Returns (keys, values,
    overflow (p,))."""
    rows, n_loc = k.shape
    k, v = _sort_kv_local(k, v)
    if p == 1:
        return k, v, torch.zeros(1, dtype=torch.int32, device=k.device)
    starts, counts = bucket_route(k, p, splitter)
    krows, recv_counts, overflow = ragged_all_to_all(k, starts, counts, cap,
                                                     p)
    # values leg: the same routing, no second count exchange
    vrows = ragged_payload(v, starts, counts, cap, p)
    lane = torch.arange(cap, device=k.device)
    valid = (lane < recv_counts[..., None]).reshape(rows, -1)
    k_flat, v_flat = _sort_kv_local(krows.reshape(rows, -1),
                                    vrows.reshape(rows, -1), valid)
    nvalid = valid.sum(-1)
    in_run = torch.arange(k_flat.shape[1], device=k.device) < nvalid[:, None]
    k_out, v_out = rebalance_sorted(
        torch.where(in_run, k_flat, sentinel_for(k_flat.dtype)), nvalid,
        n_loc, p, values=v_flat)
    return k_out, v_out, overflow


def sort_kv(keys: torch.Tensor, values: torch.Tensor, mesh,
            axis: str = DEFAULT_AXIS, splitter: str = "allgather",
            cap_factor: float = 4.0):
    """Sort flat ``keys`` ascending across the mesh's ranks, carrying
    ``values``.

    Stable: equal keys keep their input order. Returns ``(sorted_keys,
    permuted_values)`` of the input length on the mesh's device.
    ``values`` must be flat with ``values.shape == keys.shape``. Across
    processes both are this process's part, which must fill its ranks
    with equal blocks.
    """
    if keys.shape != values.shape:
        raise ValueError(f"keys {tuple(keys.shape)} and values "
                         f"{tuple(values.shape)} must have identical shapes")
    n = keys.shape[0]
    usgn = keys.dtype == torch.uint32
    if usgn:
        keys = _u32_as_i32(keys)
    k2d, n_loc = prepare_blocks(keys, mesh, axis)
    v2d, _ = prepare_blocks(values, mesh, axis, fill=0)
    p = mesh.shape[axis]
    with on_mesh(mesh, axis):
        k, v, _ = run_with_capacity_retry(
            lambda cap: (lambda a, b: sample_sort_kv_shard(a, b, p, cap,
                                                           splitter)),
            n_loc, p, cap_factor, k2d, v2d)
    k = k.reshape(-1)[:n]
    return (_i32_as_u32(k) if usgn else k), v.reshape(-1)[:n]


def argsort_dist(keys: torch.Tensor, mesh, axis: str = DEFAULT_AXIS,
                 **kw) -> torch.Tensor:
    """Distributed stable argsort: the permutation that sorts ``keys``
    (``torch.argsort(keys, stable=True)``, computed across the ranks),
    as int32. Across processes ``keys`` is this process's part, its
    indices global (process i's part starting at i times its length),
    and the result this process's part of the permutation."""
    procs = getattr(mesh, "procs", 1)
    first = mesh.proc * keys.shape[0] if procs > 1 else 0
    idx = torch.arange(first, first + keys.shape[0], dtype=torch.int32,
                       device=mesh.device)
    _, perm = sort_kv(keys, idx, mesh, axis, **kw)
    return perm
