"""The port's twin of ``__graft_entry__.dryrun_multichip``: one pass over
every distributed part on an n-rank mesh at tiny shapes, with JAX's
calls and asserts.

:func:`dryrun_multichip` runs, on the card unless the caller passes
``device="cpu"``: the ring allgather, the hypercube (or wraparound)
alltoall, the ring allreduce, the Hillis-Steele scan and the ragged
``all_to_all_v``; broadcast, scatter, gather and maxloc; the hybrid
(2, p/2) mesh's hierarchical allreduce, allgather and alltoall; the
bitonic sort and ``sort_kv``; one (dp, tp, sp) train step of a small
GQA transformer and its zigzag and Ulysses losses; and the
constant-shift flash forward with its in-kernel fallback.

Left out, because their modules are not ported yet (ROADMAP A8): JAX's
expert-parallel MoE loss and its pipeline (GPipe and 1F1B) losses,
``__graft_entry__.py:227-260``. This twin raises nothing for them and
runs nothing in their place.

Run: ``python -m icikit_torch.examples.dryrun_multichip [--devices 8]
[--device cpu]``
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def dryrun_multichip(n_devices: int, device: str | None = None) -> None:
    """Run every ported distributed part once on ``n_devices`` ranks on
    ``device`` (the card by default); raises on a failed assert."""
    from icikit_torch.parallel import (all_gather_blocks, all_reduce,
                                       all_to_all_blocks, all_to_all_v,
                                       allreduce_loc, broadcast,
                                       gather_blocks, scan_reduce,
                                       scatter_blocks)
    from icikit_torch.utils.mesh import is_pow2, make_mesh, shard_along

    device = device or "cuda"
    p = n_devices
    mesh = make_mesh(p, device=device)
    m = 8

    x = shard_along(torch.arange(p * m, dtype=torch.int32).reshape(p, m),
                    mesh)
    t = shard_along(
        torch.arange(p * p * m, dtype=torch.int32).reshape(p, p, m), mesh)

    ag = all_gather_blocks(x, mesh, algorithm="ring")
    assert tuple(ag.shape) == (p, p, m)

    a2a_alg = "hypercube" if is_pow2(p) else "wraparound"
    a2a = all_to_all_blocks(t, mesh, algorithm=a2a_alg)
    assert np.array_equal(_np(a2a), _np(t).swapaxes(0, 1))

    ar = all_reduce(x, mesh, algorithm="ring")
    assert tuple(ar.shape) == (p, m)

    sc = scan_reduce(x, mesh, algorithm="hillis_steele")
    assert np.array_equal(_np(sc), np.cumsum(_np(x), axis=0))

    # the capacity-padded ragged exchange (MPI_Alltoallv): send j
    # elements to rank j; the counts transpose, the payload lands, no
    # overflow at full capacity
    counts_np = np.tile(np.arange(p, dtype=np.int32), (p, 1))
    L = int(counts_np.sum(axis=1).max())
    seg = np.zeros((p, L), np.int32)
    for d in range(p):
        off = 0
        for j in range(p):
            seg[d, off:off + counts_np[d, j]] = d * p + j
            off += counts_np[d, j]
    rows, rcounts, overflow = all_to_all_v(
        shard_along(torch.from_numpy(seg), mesh),
        shard_along(torch.from_numpy(counts_np), mesh), mesh)
    assert np.array_equal(_np(rcounts), counts_np.T)
    assert int(_np(overflow).max()) == 0
    rows_np = _np(rows)
    for d in range(p):
        for s in range(p):
            assert (rows_np[d, s, :counts_np[s, d]] == s * p + d).all()

    # broadcast / scatter / gather and MAXLOC; the binomial trees need
    # a power-of-2 p, ring and linear cover the rest
    bc_alg = "binomial" if is_pow2(p) else "ring"
    sg_alg = "binomial" if is_pow2(p) else "linear"
    b = broadcast(x, mesh, algorithm=bc_alg)
    assert np.array_equal(_np(b), np.tile(_np(x)[0], (p, 1)))
    buf = torch.arange(p * m, dtype=torch.int32).reshape(p, m) * 3
    sc2 = scatter_blocks(buf.to(device), mesh, algorithm=sg_alg)
    assert np.array_equal(_np(sc2), _np(buf))
    g = gather_blocks(x, mesh, algorithm=sg_alg)
    assert np.array_equal(_np(g)[0], _np(x))
    mv, mi = allreduce_loc(x, mesh, op="maxloc")
    flat = _np(x).ravel()
    assert float(mv) == flat.max() and int(mi) == int(flat.argmax())

    # the multi-host path: a hybrid (dcn, ici) mesh and the two-tier
    # collectives, whenever p factors into 2 x (p/2)
    if p % 2 == 0 and p >= 4:
        from icikit_torch.parallel import (hierarchical_all_gather,
                                           hierarchical_all_reduce,
                                           hierarchical_all_to_all,
                                           make_hybrid_mesh)
        hy = make_hybrid_mesh(dcn_size=2, ici_size=p // 2, device=device,
                              n_ranks=p)
        xh = torch.arange(p * (p // 2), dtype=torch.int32).reshape(
            p, p // 2).to(device)
        hr = hierarchical_all_reduce(xh, hy)
        assert np.array_equal(_np(hr)[0], _np(xh).sum(axis=0))
        hg = hierarchical_all_gather(xh, hy)
        assert np.array_equal(_np(hg)[0], _np(xh))
        th = torch.arange(p * p * 4, dtype=torch.int32).reshape(
            p, p, 4).to(device)
        ha = hierarchical_all_to_all(th, hy)
        assert np.array_equal(_np(ha), _np(th).swapaxes(0, 1))

    from icikit_torch.models.sort import sort as dist_sort
    from icikit_torch.models.sort import sort_kv
    if is_pow2(p):
        keys = torch.arange(p * 64, dtype=torch.int32).flip(0)
        arr = _np(dist_sort(keys.to(device), mesh))
        assert (np.diff(arr) >= 0).all(), \
            "dryrun sort produced unsorted output"

    kk = torch.arange(p * 16, dtype=torch.int32).flip(0) // 2  # duplicates
    vv = torch.arange(p * 16, dtype=torch.int32)
    ks, vs = sort_kv(kk.to(device), vv.to(device), mesh)
    perm = np.argsort(_np(kk), kind="stable")
    assert np.array_equal(_np(ks), _np(kk)[perm])
    assert np.array_equal(_np(vs), _np(vv)[perm])

    # the full train step of a GQA transformer on a (dp, tp, sp) mesh:
    # tp psums, ring attention over sp, the dp gradient reduction, the
    # optimizer update
    from icikit_torch.models.transformer import (TransformerConfig,
                                                 init_params, loss_fn,
                                                 make_model_mesh,
                                                 make_train_step)

    tp = 2 if p % 2 == 0 else 1
    sp = 2 if (p // tp) % 2 == 0 else 1
    dp = p // (tp * sp)
    cfg = TransformerConfig(vocab=64, d_model=32, n_heads=4, d_head=8,
                            d_ff=64, n_layers=2, max_seq=8 * sp,
                            n_kv_heads=2)  # GQA: un-repeated K/V ride sp
    tmesh = make_model_mesh(dp=dp, tp=tp, sp=sp, device=device)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         mesh=tmesh)
    tokens = torch.zeros((2 * dp, cfg.max_seq), dtype=torch.int32,
                         device=device)
    targets = torch.ones((2 * dp, cfg.max_seq), dtype=torch.int32,
                         device=device)
    optimizer, train_step = make_train_step(tmesh, cfg)
    opt_state = optimizer.init(params)
    params, opt_state, loss = train_step(params, opt_state, tokens, targets)
    assert float(loss) > 0.0

    # the zigzag (causal load-balanced) and Ulysses (head-scattering
    # all-to-all) sequence schedules on the same mesh
    if sp > 1:
        zz_cfg = dataclasses.replace(cfg, sequence_schedule="zigzag")
        zz_loss, _ = loss_fn(params, tokens, targets, tmesh, zz_cfg)
        assert float(zz_loss) > 0.0
        if cfg.n_heads % sp == 0:
            ul_cfg = dataclasses.replace(cfg, sequence_schedule="ulysses")
            ul_loss, _ = loss_fn(params, tokens, targets, tmesh, ul_cfg)
            assert float(ul_loss) > 0.0

    # the constant-shift flash forward and its exact fallback: benign
    # inputs take the shifted pass; a q scaled to overflow exp2 around
    # the shift must take the fallback and still agree with the online
    # pass
    from icikit_torch.ops.flash_attention import (_flash_supported,
                                                  flash_attention)
    if _flash_supported(256, 256, 64, True, device):
        gen = torch.Generator(device="cpu").manual_seed(7)
        q, k_, v_ = (torch.randn((1, 256, 4, 64), generator=gen).to(device)
                     for _ in range(3))
        base = flash_attention(q, k_, v_, causal=True)
        shifted = flash_attention(q, k_, v_, causal=True,
                                  softmax_shift=16.0)
        assert np.allclose(_np(base), _np(shifted), atol=2e-2), \
            "shift forward diverged"
        hot = flash_attention(q * 400.0, k_, v_, causal=True,
                              softmax_shift=16.0)
        ref = flash_attention(q * 400.0, k_, v_, causal=True)
        assert np.allclose(_np(hot), _np(ref), atol=2e-2), \
            "shift fallback diverged"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=8,
                    help="ranks of the mesh")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dryrun_multichip(args.devices, args.device)
    print(f"dryrun_multichip({args.devices}) passed on "
          f"{args.device or 'cuda'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
