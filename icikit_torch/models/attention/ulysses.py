"""Ulysses sequence parallelism: an all-to-all head <-> sequence re-shard.

The port of ``icikit/models/attention/ulysses.py``. The redistribution
is the reference's all-to-all personalized transpose
(``Communication/src/main.cc:234-388``) with head groups as the blocks:
rank r trades its p head groups for every rank's group r, ending with
the whole sequence for heads ``[r h/p, (r+1) h/p)``, attends locally
(flash by default, the dense oracle on request), and the inverse
all-to-all restores the sequence blocks. Any ``alltoall`` variant of
the port carries the re-shard (``shmap.run_collective``), ``xla`` the
vendor's transpose among them.

Rank-vectorised: a shard function sees the p ranks as dim 0 of ``(p,
n, s, h, d)`` tensors, and the local attention runs every rank's heads
in one call, the ranks folded into the kernel's batch.
"""

from __future__ import annotations

import torch

from icikit_torch.models.attention.ring import from_blocks, to_blocks
from icikit_torch.ops.flash_attention import resolve_attention_impl
from icikit_torch.parallel.shmap import run_collective
from icikit_torch.utils.mesh import (DEFAULT_AXIS, RankMesh,
                                     require_single_process)


def _seq_to_heads(x: torch.Tensor, mesh, axis: str,
                  algorithm: str) -> torch.Tensor:
    """``(p, n, s, h, d)`` sequence blocks -> ``(p, n, p s, h/p, d)``
    head groups."""
    p, n, s, h, d = x.shape
    blocks = x.reshape(p, n, s, p, h // p, d).movedim(3, 1)
    out = run_collective("alltoall", algorithm, mesh, axis, blocks)
    # out[r, j] = rank j's sequence block of head group r
    return out.movedim(1, 2).reshape(p, n, p * s, h // p, d)


def _heads_to_seq(x: torch.Tensor, mesh, axis: str,
                  algorithm: str) -> torch.Tensor:
    """``(p, n, p s, h/p, d)`` head groups -> ``(p, n, s, h, d)``
    sequence blocks."""
    p, n, big_s, hg, d = x.shape
    blocks = x.reshape(p, n, p, big_s // p, hg, d).movedim(2, 1)
    out = run_collective("alltoall", algorithm, mesh, axis, blocks)
    # out[r, j] = rank j's head group of sequence block r
    return out.permute(0, 2, 3, 1, 4, 5).reshape(p, n, big_s // p, p * hg,
                                                 d)


def ulysses_attention_shard(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mesh, axis: str, causal: bool,
                            scale: float | None, algorithm: str,
                            local: str = "flash") -> torch.Tensor:
    """Ulysses attention over rank-vectorised blocks ``(p, n, s, h, d)``
    of ``mesh``'s ``axis`` (a ``RankMesh`` of p ranks in one process).
    GQA K/V cross at their own width where the head groups allow, as in
    JAX."""
    p = mesh.shape[axis]
    h, h_kv = q.shape[3], k.shape[3]
    if h % h_kv:
        raise ValueError(
            f"query heads ({h}) must be a multiple of K/V heads ({h_kv})")
    n_rep = h // h_kv

    def a2a(x):
        return _seq_to_heads(x, mesh, axis, algorithm)

    qh = a2a(q)
    if n_rep == 1 or h_kv % p == 0:
        # rank r's q-head group is served by its own kv-head group: the
        # all-to-all carries 1/n_rep of the K/V bytes
        kh, vh = a2a(k), a2a(v)
        if n_rep > 1:
            kh = torch.repeat_interleave(kh, n_rep, dim=3)
            vh = torch.repeat_interleave(vh, n_rep, dim=3)
    elif p % h_kv == 0:
        # each kv head repeated p/h_kv times before the wire, so rank r
        # receives the one kv head serving all of its h/p query heads
        f = p // h_kv
        kh = a2a(torch.repeat_interleave(k, f, dim=3))
        vh = a2a(torch.repeat_interleave(v, f, dim=3))
        kh = torch.repeat_interleave(kh, h // p, dim=3)
        vh = torch.repeat_interleave(vh, h // p, dim=3)
    else:
        kh = a2a(torch.repeat_interleave(k, n_rep, dim=3))
        vh = a2a(torch.repeat_interleave(v, n_rep, dim=3))
    n, big_s, hg, d = qh.shape[1:]
    ctx = resolve_attention_impl(local)(
        qh.reshape(p * n, big_s, hg, d), kh.reshape(p * n, big_s, hg, d),
        vh.reshape(p * n, big_s, hg, d), causal=causal, scale=scale)
    return _heads_to_seq(ctx.view(p, n, big_s, hg, d), mesh, axis,
                         algorithm)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, axis: str = DEFAULT_AXIS, causal: bool = False,
                      scale: float | None = None, algorithm: str = "xla",
                      local: str = "flash") -> torch.Tensor:
    """Sequence-parallel attention via all-to-all head redistribution.

    Args:
      q, k, v: global ``(batch, S, heads, head_dim)`` tensors, rank r of
        ``mesh``'s ``axis`` holding sequence block r; heads must divide
        evenly by p.
      algorithm: any ``alltoall`` variant ("xla", "wraparound", "naive",
        "ecube", "hypercube").
      local: the single-rank kernel, "flash" or "dense".

    Returns:
      ``(batch, S, heads, head_dim)``, numerically equal to
      ``dense_attention(q, k, v, causal)``.
    """
    require_single_process(mesh, "ulysses attention")
    p = mesh.shape[axis]
    if q.shape[2] % p:
        raise ValueError(
            f"head count {q.shape[2]} must divide evenly over {p} devices")
    if q.shape[1] % p:
        raise ValueError(f"sequence length {q.shape[1]} must divide "
                         f"evenly over {p} devices")
    flat = RankMesh(p, mesh.device, axis)
    return from_blocks(ulysses_attention_shard(
        to_blocks(q, p), to_blocks(k, p), to_blocks(v, p), flat, axis,
        bool(causal), scale, algorithm, local))
