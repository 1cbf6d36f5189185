"""The rank mesh: p ranks as the leading axis of one tensor.

``icikit`` maps the reference's MPI communicator onto a 1-D
``jax.sharding.Mesh`` with one device per rank. The port keeps all p
ranks on one device instead: rank-local data is a ``(p, n/p)`` tensor,
a per-rank body is written once, vectorised over dim 0, and an exchange
(``parallel.transport.ppermute``) is a gather along that dim. This is
the reference's block decomposition (``psort.cc:556-562``) without a
device per block.

Across OS processes (``parallel.multihost.init_distributed``, the
``mpirun`` analog) the ranks split into equal contiguous ranges: process
i of n holds ranks ``[i * p/n, (i + 1) * p/n)`` as its rows, and an
exchange with a rank of another process crosses the process backend of
``parallel.transport``. :func:`make_mesh` reads the layout from the live
``torch.distributed`` group, as JAX's ``make_mesh`` spans every process's
devices.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

DEFAULT_AXIS = "p"


class UnsupportedMeshError(ValueError):
    """An algorithm's mesh constraint (e.g. power-of-2 rank count) is
    not met. Distinct from generic ValueError so harness code can skip
    constrained variants without masking real errors."""


def is_pow2(n: int) -> bool:
    """True iff n is a positive power of two."""
    return n > 0 and (n & (n - 1)) == 0


def ilog2(n: int) -> int:
    """Exact integer log2; raises for non-powers-of-two."""
    if not is_pow2(n):
        raise ValueError(f"{n} is not a power of two")
    return n.bit_length() - 1


def process_layout() -> tuple[int, int]:
    """(this process's index, process count) in the live
    ``torch.distributed`` group; (0, 1) when none is live."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def split_ranks(p: int, procs: int, proc: int) -> tuple[int, int]:
    """[lo, hi): the ranks process ``proc`` of ``procs`` holds when p
    ranks split into equal contiguous ranges."""
    if p % procs:
        raise ValueError(f"{p} ranks do not divide into {procs} processes")
    if not 0 <= proc < procs:
        raise ValueError(f"process {proc} is not one of {procs}")
    k = p // procs
    return proc * k, (proc + 1) * k


def require_single_process(mesh, what: str) -> None:
    """Refuse a path that has no process backend yet."""
    if getattr(mesh, "procs", 1) > 1:
        raise NotImplementedError(
            f"{what} across processes is not ported yet (ROADMAP A5)")


@dataclass(frozen=True)
class RankMesh:
    """``p`` ranks along ``axis_name`` on ``device``, split across
    ``procs`` processes of which this is ``proc`` (one process: all p
    ranks are its rows)."""
    p: int
    device: str = "cuda"
    axis_name: str = DEFAULT_AXIS
    procs: int = 1
    proc: int = 0

    def __post_init__(self):
        if self.p < 1:
            raise ValueError(f"a mesh needs at least one rank, got {self.p}")
        split_ranks(self.p, self.procs, self.proc)

    @property
    def shape(self) -> dict:
        return {self.axis_name: self.p}

    @property
    def local(self) -> tuple[int, int]:
        """[lo, hi): the ranks this process holds, its rows."""
        return split_ranks(self.p, self.procs, self.proc)


def make_mesh(n_ranks: int = 1, axis_name: str = DEFAULT_AXIS,
              device: str = "cuda") -> RankMesh:
    """The port's ``make_mesh``: ranks on the card unless the caller
    asks for the CPU, split across the processes of a live
    ``torch.distributed`` group."""
    proc, procs = process_layout()
    return RankMesh(n_ranks, device, axis_name, procs, proc)


def mesh_axis_size(mesh: RankMesh, axis_name: str = DEFAULT_AXIS) -> int:
    """Number of ranks along ``axis_name`` (``MPI_Comm_size``)."""
    return mesh.shape[axis_name]


def shard_along(x: torch.Tensor, mesh: RankMesh,
                axis_name: str = DEFAULT_AXIS) -> torch.Tensor:
    """Block-decompose flat ``x`` (length divisible by p) into the
    ``(p, n/p)`` rank layout on the mesh's device; across processes,
    ``x`` is this process's part and p its rank count."""
    p = mesh_axis_size(mesh, axis_name) // mesh.procs
    if x.dim() == 1:
        if x.shape[0] % p:
            raise ValueError(f"length {x.shape[0]} not divisible by p={p}")
        x = x.reshape(p, -1)
    elif x.shape[0] != p:
        raise ValueError(f"leading dim {x.shape[0]} != p={p}")
    return x.to(mesh.device)


def replicate(x: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """Place ``x`` where every rank of the mesh sees it: one buffer on
    the mesh's device (JAX's fully replicated placement)."""
    return x.to(mesh.device)
