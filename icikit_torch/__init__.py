"""icikit_torch — icikit's parallel-computing kernels in PyTorch and CUDA.

A second package beside ``icikit/``: the same algorithms, rebuilt on
PyTorch for one NVIDIA Hopper card, with every TPU kernel of the JAX
package replaced by a hand-written CUDA kernel (sources in ``csrc/``,
built with ``nvcc`` at first use into ``build/``). It imports ``torch``,
never ``jax`` and nothing of ``icikit``.

Ported so far: the four distributed sorts and the key-value sort
(``models.sort``), their two network kernels (``ops.cuda_sort``), the
headline bench (``python -m icikit_torch.bench.headline``) and the
four-sort study (``python -m icikit_torch.bench.sort``); greedy decoding of the
transformer (``models.transformer``) with its flash-attention forward
and fused decode-step kernels (``ops.cuda_attention``) and the decode
bench (``python -m icikit_torch.bench.decode``); the transformer's
train step (``make_train_step``) with the flash backward
(``ops.cuda_attention``), the fused cross-entropy head
(``ops.cuda_xent``) and the train bench
(``python -m icikit_torch.bench.train``); the collective library
(``parallel``: nine families of hand-rolled schedules beside the vendor
baseline, ``reduceloc``, ``alltoallv``) and its bench harness
(``python -m icikit_torch.bench.run``).

Ranks: where ``icikit`` spreads p ranks over p devices of a
``jax.sharding.Mesh``, the port keeps them as the leading axis of one
tensor on one device (``utils.mesh.RankMesh``), so a rank-parallel body
is written once, vectorised over that axis.
"""

from icikit_torch.utils.mesh import RankMesh, make_mesh  # noqa: F401
