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
donates them instead). ``use_pallas=True`` asks for the one-pass TPU
kernel (B12), which is not ported yet; the default formulation is the
one the JAX train step runs (``FusedAdam(use_pallas=False)``).
"""

from __future__ import annotations

import torch


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


def _leaf_update(p, m, v, g, scalars, b1: float, b2: float, eps: float,
                 ok=None) -> None:
    """``_leaf_update_xla`` on one leaf, written into p, m and v. With
    ``ok`` (a bool scalar tensor) the update commits only where it is
    true, with no host sync: the on-device skip of ``guard="device"``."""
    lr, c1, c2 = scalars[0], scalars[1], scalars[2]
    g32 = g.float()
    m32 = m.float() * b1 + g32 * (1.0 - b1)
    v32 = v.float() * b2 + (g32 * g32) * (1.0 - b2)
    p_new = p - lr * (m32 * c1) / (torch.sqrt(v32 * c2) + eps)
    m_new, v_new = m32.to(m.dtype), v32.to(v.dtype)
    if ok is not None:
        p_new = torch.where(ok, p_new, p)
        m_new = torch.where(ok, m_new, m)
        v_new = torch.where(ok, v_new, v)
    p.copy_(p_new)
    m.copy_(m_new)
    v.copy_(v_new)


@torch.no_grad()
def adam_apply(params: dict, m: dict, v: dict, grads: dict, lr, step,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               use_pallas: bool = False, ok=None):
    """Whole-tree Adam, in place. ``lr`` and ``step`` may be tensors on
    the device. Returns ``(params, m, v)``, the same dicts, updated.
    Non-floating leaves are left as they are. ``ok``: see
    :func:`_leaf_update`."""
    if use_pallas:
        raise NotImplementedError(
            "adam_apply(use_pallas=True), the one-pass TPU Adam kernel "
            "(B12), is not ported yet (ROADMAP B12); the default "
            "formulation is the one the train step runs")
    scalars = None
    for k in params:
        p = params[k]
        if not torch.is_floating_point(p):
            continue
        if scalars is None:
            step_t = step if isinstance(step, torch.Tensor) \
                else torch.tensor(step, device=p.device)
            scalars = adam_scalars(lr, step_t.to(p.device), b1, b2)
        _leaf_update(p, m[k], v[k], grads[k], scalars, b1, b2, eps, ok)
    return params, m, v
