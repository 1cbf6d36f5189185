"""The collective-algorithm library, rank-vectorised.

Every hand-rolled MPI collective of the reference is a
``transport.ppermute`` schedule over the rank axis of one tensor (p
ranks as dim 0, ``utils.mesh.RankMesh``), each the schedule of the
matching ``icikit.parallel`` module; the ``"xla"`` variants keep JAX's
name for the vendor baseline, which here is PyTorch's own op over the
rank axis. Ported so far: the nine families, ``reduceloc``,
``alltoallv`` and the checked transport (``integrity``: ``checked=True``
on allgather, allreduce, alltoall, reducescatter and scan, and the
``checked_*`` twins); ``pt2pt`` and ``multihost`` are later parts of
ROADMAP A5.

Terminology note: the reference calls its *broadcast-semantics*
collective "AllToAll" (an allgather, ``Communication/src/main.cc:38-223``)
and the true transpose collective "AllToAllPersonalized" (``:234-388``).
We use the standard names: ``allgather`` and ``alltoall``.
"""

from icikit_torch.parallel.allgather import (  # noqa: F401
    ALLGATHER_ALGORITHMS,
    all_gather_blocks,
)
from icikit_torch.parallel.alltoall import (  # noqa: F401
    ALLTOALL_ALGORITHMS,
    all_to_all_blocks,
)
from icikit_torch.parallel.alltoallv import (  # noqa: F401
    all_gather_v,
    all_to_all_v,
    ragged_all_to_all,
)
from icikit_torch.parallel.allreduce import (  # noqa: F401
    ALLREDUCE_ALGORITHMS,
    all_reduce,
)
from icikit_torch.parallel.integrity import (  # noqa: F401
    CHECKED_FAMILIES,
    IntegrityError,
    checked_all_gather,
    checked_all_reduce,
    checked_all_to_all,
    checked_reduce_scatter,
    checked_scan,
    quarantine_counts,
)
from icikit_torch.parallel.collops import (  # noqa: F401
    broadcast,
    gather_blocks,
    scatter_blocks,
)
from icikit_torch.parallel.reduce import (  # noqa: F401
    REDUCE_ALGORITHMS,
    reduce_to_root,
)
from icikit_torch.parallel.reduceloc import (  # noqa: F401
    allreduce_loc,
    top_k_dist,
)
from icikit_torch.parallel.reducescatter import (  # noqa: F401
    REDUCESCATTER_ALGORITHMS,
    reduce_scatter,
)
from icikit_torch.parallel.scan import (  # noqa: F401
    SCAN_ALGORITHMS,
    scan_reduce,
)
