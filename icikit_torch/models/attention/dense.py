"""Single-device dense attention oracle — re-export of
``icikit_torch.ops.attention`` under the JAX package's import path."""

from icikit_torch.ops.attention import NEG_INF, dense_attention  # noqa: F401
