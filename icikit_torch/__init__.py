"""icikit_torch — icikit's parallel-computing kernels in PyTorch and CUDA.

A second package beside ``icikit/``: the same algorithms, rebuilt on
PyTorch for one NVIDIA Hopper card, with every TPU kernel of the JAX
package replaced by a hand-written CUDA kernel (sources in ``csrc/``,
built with ``nvcc`` at first use into ``build/``). It imports ``torch``,
never ``jax`` and nothing of ``icikit``.

Ported so far: the distributed bitonic sort (``models.sort``), its two
network kernels (``ops.cuda_sort``) and the headline bench
(``python -m icikit_torch.bench.headline``); greedy decoding of the
transformer (``models.transformer``) with its flash-attention forward
and fused decode-step kernels (``ops.cuda_attention``) and the decode
bench (``python -m icikit_torch.bench.decode``).

Ranks: where ``icikit`` spreads p ranks over p devices of a
``jax.sharding.Mesh``, the port keeps them as the leading axis of one
tensor on one device (``utils.mesh.RankMesh``), so a rank-parallel body
is written once, vectorised over that axis.
"""

from icikit_torch.utils.mesh import RankMesh, make_mesh  # noqa: F401
