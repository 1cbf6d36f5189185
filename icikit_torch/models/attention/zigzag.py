"""Zigzag ring attention: causal-load-balanced sequence parallelism.

The port of ``icikit/models/attention/zigzag.py``. The sequence splits
into 2p chunks and rank r holds the pair (r, 2p - 1 - r), one early and
one late chunk, so every rank has the same causal work; the K/V pairs
rotate on the reference's ring (``Communication/src/main.cc:190-223``)
and the layout moves in and out of zigzag order by two partial
``ppermute`` routes each way, the targeted-``MPI_Send`` analog. Inputs
and outputs are ordinary sequence-ordered blocks.

Rank-vectorised as ``ring``: each (q chunk, k chunk) pair of a step has
a per-rank mode (skip, diagonal, full by global chunk id), and the ranks
of one mode attend in one flash call through ``ring.visit``. At step 0
every rank's modes are the same (its own two chunks); from step 1 on a
pair is full on a run of ranks and skipped on the rest.
"""

from __future__ import annotations

import torch

from icikit_torch.models.attention.ring import (_mode, from_blocks,
                                                ring_attention_shard,
                                                to_blocks, visit)
from icikit_torch.parallel import transport
from icikit_torch.parallel.shmap import rank_where, shift_perm
from icikit_torch.utils.mesh import DEFAULT_AXIS, require_single_process


def _chunk_dev(c: int, p: int) -> int:
    """Owner of global chunk c (of 2p) in zigzag layout: rank
    min(c, 2p-1-c)."""
    return c if c < p else 2 * p - 1 - c


def _to_zigzag(x: torch.Tensor, p: int) -> torch.Tensor:
    """Sequence-ordered blocks ``(p, n, s, ...)`` -> each rank's (early
    chunk r, late chunk 2p-1-r). Rank r's halves are global chunks 2r
    and 2r+1; route A carries every lower half, route B every upper
    half, and a chunk lands early iff its owner has its parity."""
    if p == 1:
        return x
    half = x.shape[2] // 2
    lo, hi = x[:, :, :half], x[:, :, half:]
    recv_a = transport.ppermute(lo, [(r, _chunk_dev(2 * r, p))
                                     for r in range(p)])
    recv_b = transport.ppermute(hi, [(r, _chunk_dev(2 * r + 1, p))
                                     for r in range(p)])
    even = [r % 2 == 0 for r in range(p)]
    early = rank_where(even, recv_a, recv_b)
    late = rank_where(even, recv_b, recv_a)
    return torch.cat([early, late], dim=2)


def _from_zigzag(x: torch.Tensor, p: int) -> torch.Tensor:
    """Inverse of :func:`_to_zigzag`: the two routes reversed."""
    if p == 1:
        return x
    half = x.shape[2] // 2
    early, late = x[:, :, :half], x[:, :, half:]
    even = [r % 2 == 0 for r in range(p)]
    send_a = rank_where(even, early, late)
    send_b = rank_where(even, late, early)
    lo = transport.ppermute(send_a, [(_chunk_dev(2 * r, p), r)
                                     for r in range(p)])
    hi = transport.ppermute(send_b, [(_chunk_dev(2 * r + 1, p), r)
                                     for r in range(p)])
    return torch.cat([lo, hi], dim=2)


def zigzag_attention_shard(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, p: int, causal: bool,
                           scale: float | None) -> torch.Tensor:
    """Zigzag ring attention over rank-vectorised blocks ``(p, n, s, h,
    d)`` in sequence order (the zigzag layout is internal)."""
    s, d = q.shape[2], q.shape[4]
    if scale is None:
        scale = d ** -0.5
    if p == 1 or s < 2 or not causal:
        # nothing to balance: the plain ring does the same math
        return ring_attention_shard(q, k, v, p, causal, scale)
    half = s // 2
    qz, kz, vz = (_to_zigzag(x, p) for x in (q, k, v))
    qc = [qz[:, :, :half], qz[:, :, half:]]
    gq = [[r for r in range(p)], [2 * p - 1 - r for r in range(p)]]
    state = [None, None]
    k_cur, v_cur = kz, vz
    for t in range(p):
        src = [(r - t) % p for r in range(p)]
        gk = [src, [2 * p - 1 - c for c in src]]
        for qi in range(2):
            for ki in range(2):
                modes = [_mode(gk[ki][r], gq[qi][r], True)
                         for r in range(p)]
                state[qi] = visit(
                    state[qi], qc[qi],
                    k_cur[:, :, ki * half:(ki + 1) * half],
                    v_cur[:, :, ki * half:(ki + 1) * half], modes, scale)
        if t < p - 1:
            k_cur = transport.ppermute(k_cur, shift_perm(p, 1))
            v_cur = transport.ppermute(v_cur, shift_perm(p, 1))
    out = torch.cat([state[0][0], state[1][0]], dim=2)
    return _from_zigzag(out, p).to(q.dtype)


def zigzag_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mesh, axis: str = DEFAULT_AXIS, causal: bool = False,
                     scale: float | None = None) -> torch.Tensor:
    """Causal-load-balanced sequence-parallel attention, a drop-in for
    ``ring_attention`` (global ``(batch, S, heads, head_dim)``, exact
    against the dense oracle). S must divide evenly by 2p when causal."""
    require_single_process(mesh, "zigzag attention")
    p = mesh.shape[axis]
    if causal and p > 1:
        if q.shape[1] % (2 * p):
            raise ValueError(
                f"sequence length {q.shape[1]} must divide evenly into "
                f"2*{p} zigzag chunks")
    elif q.shape[1] % p:
        raise ValueError(f"sequence length {q.shape[1]} must divide "
                         f"evenly over {p} devices")
    return from_blocks(zigzag_attention_shard(
        to_blocks(q, p), to_blocks(k, p), to_blocks(v, p), p,
        bool(causal), scale))
