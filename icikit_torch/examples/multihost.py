"""The two-process bring-up, the ``mpirun`` analog
(``Communication/Data/sub.sh:9-15``, ``MPI_Init`` at
``Communication/src/main.cc:396``): a worker that runs the port's
collectives, point-to-point primitives and sorts with its ranks split
across OS processes, and the launcher that starts the workers.

Each worker joins the ``torch.distributed`` group (``init_distributed``,
gloo), builds the flat mesh of 8 ranks and the (dcn 2, ici 4) hybrid
mesh (four ranks a process), runs every case of :func:`run_cases` on
its rows of the seeded inputs of :func:`inputs` (every family and
variant, ``reduceloc``, ``alltoallv``, a checked ring allreduce clean
and with one drilled bit flip, the hierarchical collectives, pt2pt, the
sample, sample-bitonic, quicksort and checked bitonic sorts and
``sort_kv`` of 2^SORT_LOG2N keys), sorts ``2^log2n`` int32 keys with
``sort(algorithm="bitonic")`` (on the card through the sort kernels,
each process its own rows), counts the inversions across the
processes, writes its rows to ``OUT/rank<i>.npz`` and prints one
``WORKER_RESULT`` JSON line (with the sort and checksum kernels'
launches of each sort case and the drill's integrity counters) and
``WORKER_OK``. The rows of the two processes, stacked, are the
one-process result of the same cases: ``run_cases`` on single-process
meshes computes that.

With ``--mode train`` a worker instead takes TRAIN_STEPS train steps of the
transformer on a (dp, tp, sp) model mesh whose dp ranks split across the
processes (:func:`train_case`: ``TRAIN_CFG``, parameters and tokens from
SEED, this process's batch rows): each process runs its dp ranks' tp x
sp programs, and only the gradient psum and the loss psum over dp cross
the process backend. It writes the loss, the first step's gradients and
the parameters after the steps (global leaves, the same in every
process) to ``OUT/rank<i>.npz``. At dp = 2 every gradient element is a
two-term sum, exact in either order, so both processes hold bitwise the
one-process dp = 2 step's result (``train_case`` on a one-process mesh).

Two processes on the CPU::

    python -m icikit_torch.examples.multihost --port 29511 \\
        --process-id 0 --device cpu --out /tmp/mh &
    python -m icikit_torch.examples.multihost --port 29511 \\
        --process-id 1 --device cpu --out /tmp/mh

or both at once, a fresh port and a retry on a port race::

    python -m icikit_torch.examples.multihost --launch --device cpu \\
        --out /tmp/mh
    python -m icikit_torch.examples.multihost --launch --mode train \\
        --device cpu --out /tmp/mh_train

On one card both processes share it (NCCL refuses two ranks on one
GPU, so the backend is gloo: the tensors and every kernel stay on the
card, and only a block bound for the other process crosses, through
pinned host memory).
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

RANKS = 8
PROCESSES = 2
HYBRID = (2, 4)
ROOT = 5
SEED = 7
# the keys of the sort cases of run_cases: 2^13 a rank, the sort
# kernels' smallest row
SORT_LOG2N = 16
BACKEND_NOTE = "backend: gloo, staged through host"

# The train mode's model: float32, d_model 128 (the fused head's width),
# 32 tokens a row (one float32 backward key tile, so the flash
# backward's dq takes one atomic add an element on the card and the
# step is deterministic), and its default mesh and global batch.
TRAIN_CFG = dict(vocab=256, d_model=128, n_heads=4, d_head=32, d_ff=256,
                 n_layers=2, max_seq=32, compute_dtype="float32",
                 remat_policy="except_attn")
TRAIN_MESH = (2, 1, 1)
TRAIN_BATCH = 4
TRAIN_LR = 1e-2
TRAIN_STEPS = 2


def inputs(m: int, log2n: int) -> dict:
    """The global inputs, every rank's row, from SEED: int32 and float32
    (RANKS, m) operands, (RANKS, RANKS, m / RANKS) alltoall operands,
    the sort's 2^log2n int32 keys, the ragged cases' counts (each
    rank's (RANKS,) send counts, summing to at most m, and its own
    count for ``all_gather_v``), and the sort cases' 2^SORT_LOG2N int32
    keys, spread and with duplicates, with int32 values."""
    rng = np.random.default_rng(SEED)
    n = 1 << SORT_LOG2N
    return {
        "int32": rng.integers(-100, 100, (RANKS, m)).astype(np.int32),
        "float32": rng.standard_normal((RANKS, m)).astype(np.float32),
        "blocks": rng.integers(-100, 100, (RANKS, RANKS, m // RANKS)
                               ).astype(np.int32),
        "keys": rng.integers(-2**31, 2**31 - 1, 1 << log2n,
                             dtype=np.int32),
        "send_counts": rng.integers(0, m // RANKS + 1, (RANKS, RANKS)
                                    ).astype(np.int32),
        "own_counts": rng.integers(0, m + 1, RANKS).astype(np.int32),
        "skeys": rng.integers(-2**31, 2**31 - 1, n, dtype=np.int32),
        "kv_keys": rng.integers(-1000, 1000, n).astype(np.int32),
        "kv_values": np.arange(n, dtype=np.int32),
    }


# (family, algorithm, dtype, op or None, extra keyword arguments)
FLAT = (
    [("allgather", a, "int32", None, {}) for a in
     ("naive", "ring", "recursive_doubling", "recursive_doubling_twins",
      "xla")]
    + [("allgather", "ring", "float32", None, {})]
    + [("allreduce", a, "int32", op, {}) for a in
       ("recursive_doubling", "ring", "xla") for op in ("sum", "max")]
    + [("allreduce", a, "float32", "sum", {}) for a in
       ("recursive_doubling", "ring")]
    + [("reducescatter", a, "int32", "sum", {}) for a in
       ("ring", "recursive_halving", "pairwise", "xla")]
    + [("reducescatter", a, "float32", "sum", {}) for a in
       ("ring", "recursive_halving", "pairwise")]
    + [("reducescatter", "ring", "int32", "min", {})]
    + [("alltoall", a, "int32", None, {}) for a in
       ("wraparound", "naive", "ecube", "hypercube", "xla")]
    + [("scan", a, "int32", "sum", {}) for a in
       ("hillis_steele", "linear", "xla")]
    + [("scan", a, "float32", "sum", {}) for a in
       ("hillis_steele", "linear")]
    + [("scan", "hillis_steele", "int32", "max", {"inclusive": False})]
    + [("reduce", a, "int32", "sum", {"root": ROOT}) for a in
       ("binomial", "xla")]
    + [("reduce", "binomial", "float32", "sum", {"root": ROOT})]
    + [(fam, a, "int32", None, {"root": ROOT})
       for fam, algs in (("broadcast", ("ring", "binomial", "xla")),
                         ("scatter", ("linear", "binomial", "xla")),
                         ("gather", ("linear", "binomial", "xla")))
       for a in algs]
    + [("broadcast", "binomial", "float32", None, {"root": ROOT})]
)

# the sorts of the sort cases beside the bitonic one, and the keys of
# run_cases' result that the cases beyond the families make
SORTS = ("sample", "sample_bitonic", "quicksort")
EXTRA = (("reduceloc/maxloc", "reduceloc/minloc", "all_gather_v/rows",
          "all_gather_v/counts", "all_to_all_v/rows", "all_to_all_v/counts",
          "all_to_all_v/overflow", "checked/allreduce/ring",
          "checked/allreduce/ring/drilled", "checked/sort/bitonic",
          "sort_kv/keys", "sort_kv/values")
         + tuple(f"sort/{a}" for a in SORTS))
# the drill of checked/allreduce/ring/drilled: a bit flip at the first
# exchange of the first attempt
DRILL_SITE = "collective.allreduce"

# (collective, ici algorithm, dcn algorithm, dtype, op or None)
HIER = (
    [("allreduce", i, d, "int32", "sum") for i, d in
     (("ring", "ring"), ("recursive_doubling", "ring"), ("xla", "xla"),
      ("ring", "recursive_doubling"), ("ring", "xla"))]
    + [("allreduce", i, i, "float32", "sum") for i in
       ("ring", "recursive_doubling")]
    + [("allreduce", "ring", "ring", "int32", "max")]
    + [("allgather", a, a, "int32", None) for a in ("ring", "xla")]
    + [("reducescatter", a, a, dt, op) for a, dt, op in
       (("ring", "int32", "sum"), ("ring", "float32", "sum"),
        ("ring", "int32", "max"),
        ("recursive_halving", "int32", "sum"))]
    + [("alltoall", i, d, "int32", None) for i, d in
       (("xla", "xla"), ("hypercube", "wraparound"))]
)


def _name(*parts) -> str:
    return "/".join(str(x) for x in parts if x not in (None, {}))


def run_cases(flat, hybrid, data: dict, record: dict | None = None) -> dict:
    """Every case on this process's rows (all rows in one process):
    ``{name: (rows, ...) tensor}``. ``flat`` is a ``RankMesh`` of RANKS,
    ``hybrid`` a ``HybridMesh`` (2, 4) of the same ranks and device.
    ``record``, when given, gets each sort and checked case's kernel
    launches (``case_launches``) and the drill's integrity counters
    (``drill``)."""
    from icikit_torch import parallel as tp
    from icikit_torch.parallel import pt2pt
    from icikit_torch.parallel.shmap import on_mesh

    lo, hi = flat.local
    dev = flat.device

    def rows(name):
        return torch.from_numpy(data[name][lo:hi]).to(dev)

    entry = {"allgather": tp.all_gather_blocks, "allreduce": tp.all_reduce,
             "reducescatter": tp.reduce_scatter, "scan": tp.scan_reduce,
             "reduce": tp.reduce_to_root, "broadcast": tp.broadcast,
             "gather": tp.gather_blocks}
    out = {}
    for fam, alg, dt, op, kw in FLAT:
        x = rows("blocks" if fam == "alltoall" else dt)
        if fam == "scatter":  # one buffer every rank sees
            x = torch.from_numpy(data[dt]).to(dev)
            got = tp.scatter_blocks(x, flat, algorithm=alg, **kw)
        elif fam == "alltoall":
            got = tp.all_to_all_blocks(x, flat, algorithm=alg)
        elif op is None:
            got = entry[fam](x, flat, algorithm=alg, **kw)
        else:
            got = entry[fam](x, flat, algorithm=alg, op=op, **kw)
        out[_name(fam, alg, dt, op, *sorted(kw.items()))] = got
    hier = {"allreduce": tp.hierarchical_all_reduce,
            "allgather": tp.hierarchical_all_gather,
            "reducescatter": tp.hierarchical_reduce_scatter,
            "alltoall": tp.hierarchical_all_to_all}
    for coll, ici, dcn, dt, op in HIER:
        x = rows("blocks" if coll == "alltoall" else dt)
        kw = {} if op is None else {"op": op}
        out[_name("hier", coll, ici, dcn, dt, op)] = hier[coll](
            x, hybrid, ici_algorithm=ici, dcn_algorithm=dcn, **kw)
    x = rows("int32")
    with on_mesh(flat):
        out["pt2pt/shift2"] = pt2pt.sendrecv_shift(x, RANKS, 2)
        out["pt2pt/xor3"] = pt2pt.sendrecv_xor(x, RANKS, 3)
        out["pt2pt/xor4"] = pt2pt.sendrecv_xor(x, RANKS, 4)
        out["pt2pt/send0to5"] = pt2pt.send_to(x, [(0, 5)])
        out["pt2pt/send6to1"] = pt2pt.send_to(x, [(6, 1)])
        for periodic in (True, False):
            left, right = pt2pt.halo_exchange(x, RANKS, 2, periodic)
            out[f"pt2pt/halo_left/{periodic}"] = left
            out[f"pt2pt/halo_right/{periodic}"] = right
        out["pt2pt/barrier"] = x + pt2pt.barrier(RANKS, dev)[:, None]
    out.update(_extra_cases(flat, data, rows, record))
    return out


def _counted(record, name, run):
    """``run()``, with the sort and checksum kernels' launches of the
    call put in ``record["case_launches"][name]``."""
    from icikit_torch.ops import cuda_integrity, cuda_sort

    cuda_sort.reset_launches()
    cuda_integrity.reset_launches()
    got = run()
    if record is not None:
        record.setdefault("case_launches", {})[name] = {
            **cuda_sort.LAUNCHES, **cuda_integrity.LAUNCHES}
    return got


def _extra_cases(flat, data: dict, rows, record) -> dict:
    """The cases of EXTRA on this process's rows (see :func:`run_cases`);
    a 0-d result stands as one row a rank."""
    from icikit_torch import chaos
    from icikit_torch import parallel as tp
    from icikit_torch.models.sort import sort, sort_kv
    from icikit_torch.parallel import integrity

    lo, hi = flat.local
    dev = flat.device
    k = hi - lo
    out = {}
    x = rows("int32")
    for op in ("maxloc", "minloc"):
        val, idx = tp.allreduce_loc(x, flat, op=op)
        out[f"reduceloc/{op}"] = torch.stack([val, idx]).expand(k, 2)
    own = rows("own_counts")
    out["all_gather_v/rows"], out["all_gather_v/counts"] = tp.all_gather_v(
        x, own, flat, algorithm="ring")
    (out["all_to_all_v/rows"], out["all_to_all_v/counts"],
     out["all_to_all_v/overflow"]) = tp.all_to_all_v(
        x, rows("send_counts"), flat, algorithm="wraparound")
    f = rows("float32")
    out["checked/allreduce/ring"] = _counted(
        record, "checked/allreduce/ring",
        lambda: tp.all_reduce(f, flat, algorithm="ring", checked=True))
    integrity.reset_stats()
    plan = chaos.FaultPlan(schedule={f"corrupt:{DRILL_SITE}": (0,)})
    with chaos.inject(plan):
        out["checked/allreduce/ring/drilled"] = tp.all_reduce(
            f, flat, algorithm="ring", checked=True)
    if record is not None:
        st = integrity.stats()
        record["drill"] = {key: st[key] for key in
                           ("detected", "retries", "recoveries")}
        record["drill"]["fired"] = plan.fired("corrupt", DRILL_SITE)
    n = data["skeys"].size
    part = slice(lo * n // RANKS, hi * n // RANKS)

    def part_of(name):
        return torch.from_numpy(data[name][part]).to(dev)

    keys = part_of("skeys")
    for alg in SORTS:
        out[f"sort/{alg}"] = _counted(
            record, f"sort/{alg}",
            lambda alg=alg: sort(keys, flat, algorithm=alg)).view(k, -1)
    out["checked/sort/bitonic"] = _counted(
        record, "checked/sort/bitonic",
        lambda: sort(keys, flat, algorithm="bitonic", checked=True)
    ).view(k, -1)
    ks, vs = sort_kv(part_of("kv_keys"), part_of("kv_values"), flat)
    out["sort_kv/keys"], out["sort_kv/values"] = ks.view(k, -1), \
        vs.view(k, -1)
    return out


def sort_case(flat, keys: np.ndarray, runs: int) -> tuple:
    """Sort this process's part of ``keys`` with the bitonic sort
    ``runs`` times (the launches and the wire counted on the first),
    count the inversions across the processes. Returns (sorted rows,
    record)."""
    from icikit_torch.models.sort import check_sort, sort
    from icikit_torch.ops import cuda_sort
    from icikit_torch.parallel import transport

    lo, hi = flat.local
    part = keys.reshape(RANKS, -1)[lo:hi].reshape(-1)
    x = torch.from_numpy(part).to(flat.device)
    cuda = x.is_cuda
    seconds, launches, wire = [], None, None
    for i in range(runs):
        _sync(cuda)
        cuda_sort.reset_launches()
        transport.reset_wire()
        t0 = time.perf_counter()
        out = sort(x, flat, algorithm="bitonic")
        _sync(cuda)
        seconds.append(time.perf_counter() - t0)
        if i == 0:
            launches, wire = dict(cuda_sort.LAUNCHES), dict(transport.WIRE)
    out2d = out.reshape(hi - lo, -1)
    inversions = check_sort(out2d, flat)
    host = out.cpu().numpy()
    return out2d, {"n": int(keys.size), "n_local": int(part.size),
                   "sort_s": seconds, "launches": launches, "wire": wire,
                   "inversions": inversions,
                   "sha256": hashlib.sha256(host.tobytes()).hexdigest()}


def train_case(mesh) -> dict:
    """TRAIN_STEPS train steps of ``TRAIN_CFG`` on the model ``mesh``
    (``FusedAdam(TRAIN_LR)``), this process's rows of the
    global TRAIN_BATCH x max_seq tokens from SEED, the parameters drawn
    from SEED on the CPU: ``{"loss": (steps,), "grad/<leaf>": the first
    step's gradient, "param/<leaf>": the parameters after the steps}``
    as numpy arrays, and the kernels' launches of the last step."""
    from icikit_torch.models.transformer import (FusedAdam,
                                                 TransformerConfig,
                                                 init_params,
                                                 loss_and_metrics,
                                                 make_train_step)
    from icikit_torch.ops import cuda_adam, cuda_attention, cuda_xent

    cfg = TransformerConfig(**TRAIN_CFG)
    params = {k: v.to(mesh.device) for k, v in init_params(
        cfg, torch.Generator().manual_seed(SEED), "cpu").items()}
    rng = np.random.default_rng(SEED)
    tok, tgt = (rng.integers(0, cfg.vocab, (TRAIN_BATCH, cfg.max_seq))
                .astype(np.int32) for _ in range(2))
    lo, hi = mesh.local
    rows = slice(lo * TRAIN_BATCH // mesh.dp, hi * TRAIN_BATCH // mesh.dp)
    tok, tgt = (torch.from_numpy(x[rows]).to(mesh.device)
                for x in (tok, tgt))
    _, grads, _ = loss_and_metrics(params, tok, tgt, mesh, cfg)
    out = {f"grad/{k}": g.cpu().numpy() for k, g in grads.items()}
    opt, step = make_train_step(mesh, cfg, FusedAdam(TRAIN_LR))
    st = opt.init(params)
    losses = []
    mods = (cuda_attention, cuda_xent, cuda_adam)
    for _ in range(TRAIN_STEPS):
        for mod in mods:
            mod.reset_launches()
        params, st, loss = step(params, st, tok, tgt)
        losses.append(float(loss))
    out["loss"] = np.asarray(losses, np.float32)
    out.update({f"param/{k}": v.cpu().numpy() for k, v in params.items()})
    launches = {k: n for mod in mods for k, n in mod.LAUNCHES.items() if n}
    return out, launches


def train_worker(args, proc: int, nproc: int) -> dict:
    """The train mode's work in this process: :func:`train_case` on the
    model mesh split across the processes; its arrays to
    ``OUT/rank<proc>.npz``; returns the worker's record."""
    from icikit_torch.models.transformer import make_model_mesh
    from icikit_torch.parallel import transport

    mesh = make_model_mesh(*TRAIN_MESH, device=args.device)
    transport.reset_wire()
    _sync(mesh.device != "cpu")
    t0 = time.perf_counter()
    out, launches = train_case(mesh)
    _sync(mesh.device != "cpu")
    seconds = time.perf_counter() - t0
    os.makedirs(args.out, exist_ok=True)
    np.savez(os.path.join(args.out, f"rank{proc}.npz"), **out)
    return {"process": proc, "processes": nproc, "mode": "train",
            "mesh": list(TRAIN_MESH), "dp_ranks": list(mesh.local),
            "device": args.device, "note": BACKEND_NOTE,
            "loss": out["loss"].tolist(), "train_s": seconds,
            "launches_last_step": launches, "wire": dict(transport.WIRE),
            "sha256": hashlib.sha256(b"".join(
                out[k].tobytes() for k in sorted(out))).hexdigest()}


def _sync(cuda: bool) -> None:
    """Wait for the card, then for every process (the backend's
    barrier), so a timed window starts with all processes ready."""
    if cuda:
        torch.cuda.synchronize()
    if dist.is_initialized():
        dist.barrier()


def worker(args) -> int:
    from icikit_torch.parallel.multihost import (init_distributed,
                                                 make_hybrid_mesh,
                                                 process_info)
    from icikit_torch.utils.mesh import make_mesh

    timeout = datetime.timedelta(seconds=args.timeout)
    live = init_distributed(coordinator_address=f"localhost:{args.port}",
                            num_processes=PROCESSES,
                            process_id=args.process_id, timeout=timeout)
    if not (live and init_distributed() is True):  # idempotent 2nd call
        raise RuntimeError("the process group is not live")
    proc, nproc, _ = process_info()
    if (proc, nproc) != (args.process_id, PROCESSES):
        raise RuntimeError(f"process_info {(proc, nproc)}")
    if args.mode == "train":
        record = train_worker(args, proc, nproc)
        print("WORKER_RESULT " + json.dumps(record), flush=True)
        dist.destroy_process_group()
        print("WORKER_OK", flush=True)
        return 0
    flat = make_mesh(RANKS, device=args.device)
    hybrid = make_hybrid_mesh(device=args.device)
    if hybrid.shape != {"dcn": HYBRID[0], "p": HYBRID[1]}:
        raise RuntimeError(f"hybrid mesh {hybrid.shape}")
    if flat.local != hybrid.local:
        raise RuntimeError(f"flat ranks {flat.local}, hybrid "
                           f"{hybrid.local}")
    data = inputs(args.m, args.log2n)
    t0 = time.perf_counter()
    extra = {}
    rows = {k: v.cpu().numpy() for k, v in
            run_cases(flat, hybrid, data, extra).items()}
    cases_s = time.perf_counter() - t0
    sorted_rows, record = sort_case(flat, data["keys"], args.sort_runs)
    record.update(extra)
    if args.keep_sorted:
        rows["sort/bitonic"] = sorted_rows.cpu().numpy()
    os.makedirs(args.out, exist_ok=True)
    np.savez(os.path.join(args.out, f"rank{proc}.npz"), **rows)
    record.update({"process": proc, "processes": nproc,
                   "ranks": list(flat.local), "device": args.device,
                   "note": BACKEND_NOTE, "cases": len(rows),
                   "cases_s": cases_s})
    print("WORKER_RESULT " + json.dumps(record), flush=True)
    dist.destroy_process_group()
    print("WORKER_OK", flush=True)
    return 0 if record["inversions"] == 0 else 1


def launch(argv: list, out: str, timeout: float, env=None,
           cwd=None) -> list:
    """Start PROCESSES workers with ``argv`` (:func:`worker_argv`) and
    wait for them (``parallel.multihost.launch_processes``). Returns
    ``[(returncode, output)]``."""
    from icikit_torch.parallel.multihost import launch_processes

    return launch_processes("icikit_torch.examples.multihost", argv,
                            PROCESSES, out, timeout, env=env, cwd=cwd)


def worker_result(output: str) -> dict:
    """The ``WORKER_RESULT`` record in a worker's output."""
    line = next(l for l in output.splitlines()
                if l.startswith("WORKER_RESULT "))
    return json.loads(line[len("WORKER_RESULT "):])


def worker_argv(device: str, out: str, m: int, log2n: int,
                sort_runs: int = 1, keep_sorted: bool = True,
                timeout: float = 120) -> list:
    """The worker's options, as :func:`launch` takes them."""
    return (["--device", device, "--out", out, "--m", str(m),
             "--log2n", str(log2n), "--sort-runs", str(sort_runs),
             "--timeout", str(timeout)]
            + (["--keep-sorted"] if keep_sorted else []))


def train_argv(device: str, out: str, timeout: float = 120) -> list:
    """The train mode's worker options, as :func:`launch` takes them."""
    return ["--mode", "train", "--device", device, "--out", out,
            "--timeout", str(timeout)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--port", type=int)
    ap.add_argument("--process-id", type=int)
    ap.add_argument("--launch", action="store_true",
                    help="start both workers on a fresh port and wait")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True)
    ap.add_argument("--m", type=int, default=64,
                    help="elements a rank of the collectives' operands")
    ap.add_argument("--log2n", type=int, default=16)
    ap.add_argument("--sort-runs", type=int, default=1)
    ap.add_argument("--keep-sorted", action="store_true",
                    help="write the sorted rows to the .npz too")
    ap.add_argument("--timeout", type=float, default=120)
    ap.add_argument("--mode", default="collectives",
                    choices=("collectives", "train"))
    args = ap.parse_args(argv)
    if args.m % RANKS:
        ap.error(f"--m must be a multiple of {RANKS}")
    if args.launch:
        argv = (train_argv(args.device, args.out, args.timeout)
                if args.mode == "train" else
                worker_argv(args.device, args.out, args.m, args.log2n,
                            args.sort_runs, args.keep_sorted, args.timeout))
        res = launch(argv, args.out, args.timeout + 60)
        for i, (code, out) in enumerate(res):
            print(f"-- worker {i}: exit {code}\n{out[-4000:]}")
        return 0 if all(c == 0 for c, _ in res) else 1
    if args.port is None or args.process_id is None:
        ap.error("--port and --process-id (or --launch)")
    return worker(args)


if __name__ == "__main__":
    sys.exit(main())
