"""Ring attention: sequence parallelism on a ring of ranks.

The port of ``icikit/models/attention/ring.py``. The communication
schedule is the reference's ring all-to-all
(``Communication/src/main.cc:190-223``): p - 1 neighbour steps, each
rank forwarding the K/V block it just received
(``transport.ppermute`` by ``shift_perm(p, 1)``). Each rank attends its
resident queries against every visiting block with the flash kernels
(``ops.flash_attention.flash_attention_with_lse``: B3/B5 forward, B6/B7
backward with the lse cotangent folded into delta) and merges the
partial results by their log-sum-exp weights, exactly.

Rank-vectorised: a shard function sees the p ranks as dim 0 of ``(p,
n, s, h, d)`` tensors. A visiting block's causal mode depends on the
(step, rank) pair: *diagonal* (the rank's own block, causal), *full*
(a block from the past, unmasked) or *skip* (a block from the future).
The ranks of one mode are folded into the kernel's batch and attend in
one launch; a skipped rank launches nothing and its running (out, lse)
stays as it is, which is JAX's merge with an empty block (lse = -inf,
weight 0) without the -inf. At step 0 every rank sees its own block
(zigzag: its own two chunks), so the running state starts finite and no
merge ever meets -inf: the backward has no NaN to avoid.
"""

from __future__ import annotations

import torch

from icikit_torch.ops.flash_attention import flash_attention_with_lse
from icikit_torch.parallel import transport
from icikit_torch.parallel.shmap import shift_perm
from icikit_torch.utils.mesh import DEFAULT_AXIS, require_single_process

SKIP, DIAG, FULL = 0, 1, 2


def _mode(src: int, dst: int, causal: bool) -> int:
    """The mask of block ``src`` (a global block or chunk id) for the
    queries of block ``dst``."""
    if not causal:
        return FULL
    return DIAG if src == dst else (FULL if src < dst else SKIP)


def _rows(x: torch.Tensor, rows: list) -> torch.Tensor:
    """``x[rows]`` along dim 0: a view for a run of rows."""
    if rows == list(range(rows[0], rows[-1] + 1)):
        return x[rows[0]:rows[-1] + 1]
    return x.index_select(0, transport.index(tuple(rows), x.device))


def _put(x: torch.Tensor, rows: list, y: torch.Tensor) -> torch.Tensor:
    """A new tensor: ``x`` with ``rows`` along dim 0 replaced by ``y``
    (differentiable in both)."""
    if len(rows) == x.shape[0]:
        return y
    return x.index_copy(0, transport.index(tuple(rows), x.device), y)


def _attend(q, k, v, causal: bool, scale: float):
    """Attend ``q (r, n, s, h, d)`` against ``k``/``v (r, n, s, h_kv,
    d)`` row by row in one flash call (the r rows folded into the
    batch). GQA: K/V heads are repeated here, after the ring transfer,
    so the rotating blocks stay at K/V width. Returns ``(o (r, n, s, h,
    d) float32, lse (r, n, h, s) float32)``."""
    r, n, s, h, d = q.shape
    if h % k.shape[3]:
        raise ValueError(f"query heads ({h}) must be a multiple of K/V "
                         f"heads ({k.shape[3]})")
    n_rep = h // k.shape[3]
    if n_rep > 1:
        k = torch.repeat_interleave(k, n_rep, dim=3)
        v = torch.repeat_interleave(v, n_rep, dim=3)
    o, lse = flash_attention_with_lse(
        q.reshape(r * n, s, h, d), k.reshape(r * n, s, h, d),
        v.reshape(r * n, s, h, d), causal=causal, scale=scale)
    return o.float().view(r, n, s, h, d), lse.view(r, n, h, s)


def _merge(o, lse, o_t, lse_t):
    """Fold a normalized partial result into the running one by lse
    weights (JAX's ``_merge``): exact, both sides softmax-normalized over
    their own keys. Both lse are finite here: a skipped block never
    reaches a merge, so JAX's -inf guards have nothing to guard."""
    m = torch.maximum(lse, lse_t)
    w = torch.exp(lse - m)
    w_t = torch.exp(lse_t - m)
    tot = w + w_t

    def bshd(x):  # (..., h, s) weight -> (..., s, h, 1)
        return x.transpose(-1, -2)[..., None]

    return (o * bshd(w / tot) + o_t * bshd(w_t / tot),
            m + torch.log(tot))


def visit(state, q, k, v, modes, scale: float):
    """One step's blocks: ``modes[r]`` is rank r's mask for the block it
    holds now. Ranks of one mode attend in one call; skipped ranks keep
    their state. ``state`` is ``None`` before the first block, which is
    every rank's own (one mode for all ranks), or ``(o, lse)``; returns
    the new state."""
    for mode, causal in ((DIAG, True), (FULL, False)):
        rows = [r for r, m in enumerate(modes) if m == mode]
        if not rows:
            continue
        o_t, lse_t = _attend(_rows(q, rows), _rows(k, rows),
                             _rows(v, rows), causal, scale)
        if state is None:
            state = (o_t, lse_t)
            continue
        o, lse = state
        o_m, lse_m = _merge(_rows(o, rows), _rows(lse, rows), o_t, lse_t)
        state = (_put(o, rows, o_m), _put(lse, rows, lse_m))
    return state


def ring_attention_shard(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         p: int, causal: bool,
                         scale: float | None) -> torch.Tensor:
    """Ring attention over rank-vectorised blocks ``(p, n, s, h, d)``:
    rank r holds sequence block r of each of n rows. GQA: ``k``/``v``
    may carry h_kv < h heads (h_kv dividing h); the un-repeated blocks
    rotate, shrinking ring traffic by h/h_kv."""
    h, d = q.shape[3], q.shape[4]
    if h % k.shape[3]:
        raise ValueError(f"query heads ({h}) must be a multiple of K/V "
                         f"heads ({k.shape[3]})")
    if scale is None:
        scale = d ** -0.5
    state = None
    k_cur, v_cur = k, v
    for t in range(p):
        # rank r holds the block that started at rank (r - t) mod p
        modes = [_mode((r - t) % p, r, causal) for r in range(p)]
        state = visit(state, q, k_cur, v_cur, modes, scale)
        if t < p - 1:
            # the reference's forward-what-you-received ring discipline
            k_cur = transport.ppermute(k_cur, shift_perm(p, 1))
            v_cur = transport.ppermute(v_cur, shift_perm(p, 1))
    return state[0].to(q.dtype)


def to_blocks(x: torch.Tensor, p: int) -> torch.Tensor:
    """A global ``(b, S, h, d)`` tensor as p sequence blocks ``(p, b,
    S/p, h, d)`` (a view)."""
    b, big_s = x.shape[0], x.shape[1]
    return x.view(b, p, big_s // p, *x.shape[2:]).movedim(1, 0)


def from_blocks(x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`to_blocks`."""
    p, b, s = x.shape[:3]
    return x.movedim(0, 1).reshape(b, p * s, *x.shape[3:])


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis: str = DEFAULT_AXIS, causal: bool = False,
                   scale: float | None = None) -> torch.Tensor:
    """Sequence-parallel attention over a ring of ranks.

    Args:
      q, k, v: global ``(batch, S, heads, head_dim)`` tensors, rank r
        holding sequence block r of ``mesh``'s ``axis``; S must divide
        evenly by p.

    Returns:
      ``(batch, S, heads, head_dim)``, numerically equal to
      ``dense_attention(q, k, v, causal)``.
    """
    require_single_process(mesh, "ring attention")
    p = mesh.shape[axis]
    if q.shape[1] % p:
        raise ValueError(f"sequence length {q.shape[1]} must divide "
                         f"evenly over {p} devices")
    return from_blocks(ring_attention_shard(
        to_blocks(q, p), to_blocks(k, p), to_blocks(v, p), p,
        bool(causal), scale))
