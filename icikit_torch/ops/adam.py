"""One-pass Adam, the XLA formulation of ``icikit/ops/adam.py`` as plain
PyTorch.

Semantics are ``optax.adam`` (``scale_by_adam`` with ``eps_root = 0``)::

    m' = b1 m + (1 - b1) g
    v' = b2 v + (1 - b2) g^2
    p' = p - lr (m' c1) / (sqrt(v' c2) + eps),  c1 = 1/(1 - b1^t),
                                                c2 = 1/(1 - b2^t)

in float32 arithmetic whatever the stored dtypes: the gradient and the
moments are widened on load, and the new moments are rounded once on
store, so bf16 moments cost only their storage rounding.

The port updates in place: p, m and v are overwritten (JAX's train step
donates them instead). The default formulation is the one the JAX train
step runs (``FusedAdam(use_pallas=False)``): PyTorch elementwise ops.
``use_pallas=True`` runs every floating leaf through the one-pass CUDA
kernel (``ops.cuda_adam.adam_tree``, the counterpart of the TPU kernel
B12), one launch for the tree, whose plain version is that default
formulation.
"""

from __future__ import annotations

import torch

from icikit_torch.ops import cuda_adam


def adam_scalars(lr, step, b1: float = 0.9, b2: float = 0.999
                 ) -> torch.Tensor:
    """(3,) float32 ``[lr, 1/(1-b1^t), 1/(1-b2^t)]`` for a step count
    ``step`` (1-based, optax's count_inc): a tensor (on the device, no
    host sync) or a number."""
    dev = step.device if isinstance(step, torch.Tensor) else None
    t = torch.as_tensor(step, device=dev).to(torch.float32)
    f1 = torch.tensor(b1, dtype=torch.float32, device=t.device)
    f2 = torch.tensor(b2, dtype=torch.float32, device=t.device)
    c1 = 1.0 / (1.0 - torch.pow(f1, t))
    c2 = 1.0 / (1.0 - torch.pow(f2, t))
    lr_t = torch.as_tensor(lr, dtype=torch.float32, device=t.device)
    return torch.stack([lr_t.reshape(()), c1.reshape(()), c2.reshape(())])


@torch.no_grad()
def adam_apply(params: dict, m: dict, v: dict, grads: dict, lr, step,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               use_pallas: bool = False, ok=None):
    """Whole-tree Adam, in place. ``lr`` and ``step`` may be tensors on
    the device. Returns ``(params, m, v)``, the same dicts, updated.
    Non-floating leaves are left as they are. ``use_pallas``: the
    floating leaves through the one-pass kernel, one launch for the tree
    (``cuda_adam.adam_tree``), else the PyTorch formulation. ``ok``: a
    bool scalar tensor; where false, nothing is written
    (``guard="device"``)."""
    keys = [k for k in params if torch.is_floating_point(params[k])]
    if not keys:
        return params, m, v
    dev = params[keys[0]].device
    step_t = step if isinstance(step, torch.Tensor) \
        else torch.tensor(step, device=dev)
    scalars = adam_scalars(lr, step_t.to(dev), b1, b2)
    update = (cuda_adam.adam_tree if use_pallas
              else cuda_adam.adam_tree_plain)
    update([params[k] for k in keys], [m[k] for k in keys],
           [v[k] for k in keys], [grads[k] for k in keys], scalars, b1, b2,
           eps, ok)
    return params, m, v
