"""The rank mesh: p ranks as the leading axis of one tensor.

``icikit`` maps the reference's MPI communicator onto a 1-D
``jax.sharding.Mesh`` with one device per rank. The port keeps all p
ranks on one device instead: rank-local data is a ``(p, n/p)`` tensor,
a per-rank body is written once, vectorised over dim 0, and an exchange
(``parallel.transport.ppermute``) is a gather along that dim. This is
the reference's block decomposition (``psort.cc:556-562``) without a
device per block.
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


@dataclass(frozen=True)
class RankMesh:
    """``p`` ranks along ``axis_name``, all living on ``device``."""
    p: int
    device: str = "cuda"
    axis_name: str = DEFAULT_AXIS

    def __post_init__(self):
        if self.p < 1:
            raise ValueError(f"a mesh needs at least one rank, got {self.p}")

    @property
    def shape(self) -> dict:
        return {self.axis_name: self.p}


def make_mesh(n_ranks: int = 1, axis_name: str = DEFAULT_AXIS,
              device: str = "cuda") -> RankMesh:
    """The port's ``make_mesh``: ranks on the card unless the caller
    asks for the CPU."""
    return RankMesh(n_ranks, device, axis_name)


def mesh_axis_size(mesh: RankMesh, axis_name: str = DEFAULT_AXIS) -> int:
    """Number of ranks along ``axis_name`` (``MPI_Comm_size``)."""
    return mesh.shape[axis_name]


def shard_along(x: torch.Tensor, mesh: RankMesh,
                axis_name: str = DEFAULT_AXIS) -> torch.Tensor:
    """Block-decompose flat ``x`` (length divisible by p) into the
    ``(p, n/p)`` rank layout on the mesh's device."""
    p = mesh_axis_size(mesh, axis_name)
    if x.dim() == 1:
        if x.shape[0] % p:
            raise ValueError(f"length {x.shape[0]} not divisible by p={p}")
        x = x.reshape(p, -1)
    elif x.shape[0] != p:
        raise ValueError(f"leading dim {x.shape[0]} != p={p}")
    return x.to(mesh.device)
