"""Cross-entropy head kernels on Hopper: wrappers, launch counts, plain
versions.

Three CUDA kernels (``csrc/xent.cu``) carry the train step's default
head (saved exponentials, fused backward):

- ``xent_fwd`` replaces ``icikit/ops/xent.py``'s ``_fwd_kernel`` /
  ``_fwd_kernel_save`` (B9, ``_fwd_call``): per token the lse of the
  logits ``x w^T`` and the target logit, and with ``save`` the shifted
  exponentials e and each chunk's max.
- ``xent_dx_saved`` and ``xent_dw_saved`` replace ``_dx_saved_kernel``
  and ``_dw_saved_kernel`` (B10, ``_dx_call``/``_dw_call``): dx and dw
  from g rebuilt out of e, never written out.

The residual's layout is the port's own: e ``(T, V)`` in the compute
dtype and ``mrun (V / chunk, T)`` float32, the max of each
``chunk``-column piece of a row (the kernels' square CTA tile,
``TILE``: 128 for bf16, 64 for float32). The softmax is
``p = e * exp2(mrun - lse * log2(e))`` whatever the chunk width, which
is all the backward needs.

Beside each kernel stands its plain PyTorch version, the same function
as whole-tensor ops. A wrapper takes the plain version only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from icikit_torch.ops import _build
from icikit_torch.ops.common import LN2, LOG2E

LAUNCHES = {"xent_fwd": 0, "xent_dx_saved": 0, "xent_dw_saved": 0}

# The kernels' square CTA tile: its width on the vocabulary is the chunk
# of mrun, its height the token tile whose CTAs merge their partials.
TILE = {torch.bfloat16: 128, torch.float32: 64}
# The plain versions' chunk width on the CPU (any width gives the same p).
PLAIN_CHUNK = 128


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain versions: whole-tensor ops, any device.


def _pad_cols(a: torch.Tensor, n: int, value: float) -> torch.Tensor:
    return a if a.shape[-1] == n else torch.nn.functional.pad(
        a, (0, n - a.shape[-1]), value=value)


def _row_scale(mrun, lse, chunk: int, v: int) -> torch.Tensor:
    """exp2(m_i - lse * log2(e)) broadcast to ``(T, V)``."""
    m = mrun.t().repeat_interleave(chunk, dim=1)[:, :v]
    return torch.exp2(m - (lse * LOG2E)[:, None])


def xent_fwd_plain(x, w, targets, save: bool, chunk: int = PLAIN_CHUNK):
    """Plain version of ``xent_fwd``: x ``(T, D)``, w ``(V, D)``, int
    targets ``(T,)``. Float32 logits; each ``chunk``-column piece of a
    row takes its own base-2 max m_i and sum of exp2(s log2(e) - m_i);
    lse = (M + log2 sum l_i exp2(m_i - M)) ln 2; the target logit in
    natural units. Returns ``(lse, tgt)`` (``(T,)`` float32) and, with
    ``save``, ``e (T, V)`` in x's dtype and ``mrun (V / chunk, T)``."""
    t, v = x.shape[0], w.shape[0]
    s = torch.matmul(x.float(), w.float().t())
    tgt = s.gather(1, targets.long()[:, None])[:, 0]
    nc = -(-v // chunk)
    sb = _pad_cols(s * LOG2E, nc * chunk, -float("inf")).view(t, nc, chunk)
    m = sb.amax(dim=-1)                                   # (T, nc)
    e = torch.exp2(sb - m[..., None])
    l = e.sum(dim=-1)
    big = m.amax(dim=-1)
    lse = (big + torch.log2((l * torch.exp2(m - big[:, None])).sum(-1))) \
        * LN2
    if not save:
        return lse, tgt
    return (lse, tgt, e.reshape(t, nc * chunk)[:, :v].to(x.dtype),
            m.t().contiguous())


def _g_plain(e, mrun, targets, lse, dnll, chunk: int) -> torch.Tensor:
    """g = (p - onehot) * dnll in float32, p rebuilt from e."""
    v = e.shape[1]
    p = e.float() * _row_scale(mrun, lse, chunk, v)
    onehot = torch.nn.functional.one_hot(targets.long(), v).float()
    return (p - onehot) * dnll.float()[:, None]


def xent_dx_saved_plain(e, mrun, w, targets, lse, dnll,
                        chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """Plain version of ``xent_dx_saved``: dx = g w in float32 (g in
    float32 against w in float32, as the TPU contracts it), cast to e's
    dtype."""
    g = _g_plain(e, mrun, targets, lse, dnll, chunk)
    return torch.matmul(g, w.float()).to(e.dtype)


def xent_dw_saved_plain(e, mrun, x, targets, lse, dnll,
                        chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """Plain version of ``xent_dw_saved``: dw = g^T x in float32, cast
    to x's dtype."""
    g = _g_plain(e, mrun, targets, lse, dnll, chunk)
    return torch.matmul(g.t(), x.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers.


def _check_widths(what: str, dtype, d: int, v: int) -> None:
    if dtype == torch.bfloat16 and (d % 8 or v % 8):
        raise ValueError(f"{what}: the bf16 kernels read 16-byte rows: "
                         f"D={d} and V={v} must be multiples of 8")


def _rows(targets, lse=None, dnll=None):
    """The per-token operands as the kernels take them."""
    out = [targets.to(torch.int32).contiguous()]
    for a in (lse, dnll):
        if a is not None:
            out.append(a.float().contiguous())
    return out


def xent_fwd(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
             save: bool):
    """Head forward: x ``(T, D)``, w ``(V, D)`` (one dtype), int targets
    ``(T,)``. Returns ``(lse, tgt)`` float32 ``(T,)``, and with ``save``
    also ``e (T, V)`` in x's dtype and ``mrun (V / chunk, T)`` float32
    (chunk: ``TILE[dtype]`` on the card, ``PLAIN_CHUNK`` on the CPU).

    The kernel replaces ``icikit/ops/xent.py``'s ``_fwd_kernel`` /
    ``_fwd_kernel_save`` (B9, pallas_call at :283). Bound: the logits
    product, 2 T V D operations over the card's bf16 rate. CPU tensors
    take :func:`xent_fwd_plain`."""
    t, d = x.shape
    v = w.shape[0]
    if w.shape != (v, d) or targets.shape != (t,):
        raise ValueError(f"xent_fwd: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, targets "
                         f"{tuple(targets.shape)} disagree")
    if x.device.type == "cpu":
        return xent_fwd_plain(x, w, targets, save)
    _build.check_operands("xent_fwd", (x, w), x.dtype)
    _check_widths("xent_fwd", x.dtype, d, v)
    (tg,) = _rows(targets)
    tile = TILE[x.dtype]
    dev = x.device
    e = torch.empty((t, v) if save else (0,), dtype=x.dtype, device=dev)
    mrun, lpart, tpart = (torch.empty((-(-v // tile), t),
                                      dtype=torch.float32, device=dev)
                          for _ in range(3))
    counter = torch.zeros((-(-t // tile),), dtype=torch.int32, device=dev)
    lse = torch.empty((t,), dtype=torch.float32, device=dev)
    tgt = torch.empty((t,), dtype=torch.float32, device=dev)
    lib = _build.load("xent")
    rc = lib.icikit_xent_fwd(
        _build.DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(),
        tg.data_ptr(),
        e.data_ptr(), mrun.data_ptr(), lpart.data_ptr(), tpart.data_ptr(),
        counter.data_ptr(), lse.data_ptr(), tgt.data_ptr(), t, v, d,
        int(save), _build.stream(x))
    _build.check(rc, "xent_fwd launch")
    LAUNCHES["xent_fwd"] += 1
    return (lse, tgt, e, mrun) if save else (lse, tgt)


def _backward(which: str, e, mrun, other, targets, lse, dnll):
    t, v = e.shape
    d = other.shape[1]
    rows_other = v if which == "dx" else t
    if other.shape != (rows_other, d) or targets.shape != (t,) \
            or lse.shape != (t,) or dnll.shape != (t,):
        raise ValueError(f"xent_{which}_saved: shapes e {tuple(e.shape)}, "
                         f"operand {tuple(other.shape)}, rows "
                         f"{tuple(targets.shape)} disagree")
    cpu = e.device.type == "cpu"
    if not cpu:
        _build.check_operands(f"xent_{which}_saved", (e, other), e.dtype)
        _build.check_operands(f"xent_{which}_saved mrun", (mrun,),
                              torch.float32)
        _check_widths(f"xent_{which}_saved", e.dtype, d, v)
    chunk = PLAIN_CHUNK if cpu else TILE[e.dtype]
    if mrun.shape != (-(-v // chunk), t):
        raise ValueError(f"xent_{which}_saved: mrun {tuple(mrun.shape)} "
                         f"does not fit e {tuple(e.shape)}")
    if cpu:
        plain = xent_dx_saved_plain if which == "dx" else xent_dw_saved_plain
        return plain(e, mrun, other, targets, lse, dnll, chunk)
    tg, ls, dn = _rows(targets, lse, dnll)
    out = torch.empty((t, d) if which == "dx" else (v, d), dtype=e.dtype,
                      device=e.device)
    lib = _build.load("xent")
    fn = lib.icikit_xent_dx if which == "dx" else lib.icikit_xent_dw
    rc = fn(_build.DTYPE_CODE[e.dtype], e.data_ptr(), mrun.data_ptr(),
            other.data_ptr(), tg.data_ptr(), ls.data_ptr(), dn.data_ptr(),
            out.data_ptr(), t, v, d, chunk, _build.stream(e))
    _build.check(rc, f"xent_{which}_saved launch")
    LAUNCHES[f"xent_{which}_saved"] += 1
    return out


def xent_dx_saved(e, mrun, w, targets, lse, dnll) -> torch.Tensor:
    """dx ``(T, D)`` = g w, g = (e exp2(m_i - lse log2(e)) - onehot) dnll
    rebuilt from the forward's residual. The kernel replaces
    ``icikit/ops/xent.py``'s ``_dx_saved_kernel`` (B10, pallas_call at
    :374). Bound: 2 T V D operations. CPU tensors take
    :func:`xent_dx_saved_plain`."""
    return _backward("dx", e, mrun, w, targets, lse, dnll)


def xent_dw_saved(e, mrun, x, targets, lse, dnll) -> torch.Tensor:
    """dw ``(V, D)`` = g^T x, g rebuilt as for dx. The kernel replaces
    ``icikit/ops/xent.py``'s ``_dw_saved_kernel`` (B10, pallas_call at
    :411). Bound: 2 T V D operations. CPU tensors take
    :func:`xent_dw_saved_plain`."""
    return _backward("dw", e, mrun, x, targets, lse, dnll)
