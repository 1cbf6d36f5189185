"""Attention schedules: the dense single-device oracle and the
sequence-parallel schedules over a rank axis (ring, ulysses, zigzag),
rank-vectorised on one device."""

from icikit_torch.models.attention.dense import dense_attention  # noqa: F401
from icikit_torch.models.attention.ring import ring_attention  # noqa: F401
from icikit_torch.models.attention.ulysses import (  # noqa: F401
    ulysses_attention,
)
from icikit_torch.models.attention.zigzag import (  # noqa: F401
    zigzag_attention,
)
