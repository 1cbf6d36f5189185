"""icikit_torch's multi-process layer against icikit.parallel.multihost.

The same seeded numpy inputs go through JAX's hybrid-mesh collectives
on the simulated 8-device CPU mesh and through the port's on a CPU
``HybridMesh``; each case is bitwise equal (int32 and float32: each
tier runs its family's schedule and combines every element in that
schedule's order). Validation errors match JAX's. Then one real
two-process gloo run (``icikit_torch.examples.multihost``, four ranks a
process): its rows must equal JAX's hierarchical collectives,
point-to-point primitives and bitonic sort bitwise, and the port's
one-process run of the flat families (which ``test_torch_collectives``
holds to JAX).
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from icikit.models.sort import sort as j_sort
from icikit.parallel import multihost as jm
from icikit.parallel import pt2pt as jpt
from icikit.parallel.shmap import shard_map
from icikit.utils.mesh import make_mesh as j_make_mesh
from icikit.utils.mesh import shard_along as j_shard
from icikit_torch import chaos
from icikit_torch import parallel as tp
from icikit_torch.examples import multihost as mh
from icikit_torch.models.sort import sort
from icikit_torch.parallel import multihost as tm
from icikit_torch.parallel import transport
from icikit_torch.utils.mesh import RankMesh, make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hybrid_data(dcn, ici, m, seed=0, dtype="int32"):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-100, 100, size=(dcn * ici, m)).astype(np.int32)
    return rng.standard_normal((dcn * ici, m)).astype(np.float32)


def _meshes(dcn, ici):
    return (jm.make_hybrid_mesh(dcn_size=dcn, ici_size=ici),
            tm.make_hybrid_mesh(dcn, ici, device="cpu"))


def _jx(data, jmesh):
    return j_shard(jnp.asarray(data), jmesh, axis_name=("dcn", "p"))


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(np.ascontiguousarray(got).view(np.uint8),
                          np.ascontiguousarray(want).view(np.uint8))


def test_make_hybrid_mesh_shapes():
    mesh = tm.make_hybrid_mesh(dcn_size=2, device="cpu")
    assert mesh.shape == {"dcn": 2, "p": 4}
    mesh = tm.make_hybrid_mesh(dcn_size=4, ici_size=2, device="cpu")
    assert mesh.shape == {"dcn": 4, "p": 2}
    assert tm.make_hybrid_mesh(device="cpu").shape["dcn"] == 1
    assert mesh.local == (0, 8) and mesh.procs == 1


@pytest.mark.parametrize("dcn,ici", [(3, None), (4, 4)])
def test_make_hybrid_mesh_validates(dcn, ici):
    with pytest.raises(ValueError) as want:
        jm.make_hybrid_mesh(dcn_size=dcn, ici_size=ici)
    with pytest.raises(ValueError) as got:
        tm.make_hybrid_mesh(dcn_size=dcn, ici_size=ici, device="cpu")
    # JAX's message, with the port's ranks in place of devices
    assert str(got.value) == str(want.value).replace("devices", "ranks")


# JAX's grid in int32, and float32 at (2, 4)
ALLREDUCE_CASES = (
    [(dcn, ici, alg, "int32") for dcn, ici in ((2, 4), (4, 2), (2, 2), (1, 8))
     for alg in ("ring", "recursive_doubling", "xla")]
    + [(2, 4, alg, "float32") for alg in ("ring", "recursive_doubling",
                                          "xla")])


@pytest.mark.parametrize("dcn,ici,ici_algorithm,dtype", ALLREDUCE_CASES)
def test_hierarchical_allreduce_sum(dcn, ici, ici_algorithm, dtype):
    jmesh, mesh = _meshes(dcn, ici)
    data = _hybrid_data(dcn, ici, 4 * ici, dtype=dtype)
    got = tp.hierarchical_all_reduce(torch.from_numpy(data), mesh,
                                     ici_algorithm=ici_algorithm)
    want = jm.hierarchical_all_reduce(_jx(data, jmesh), jmesh,
                                      ici_algorithm=ici_algorithm)
    _same(got, want)


@pytest.mark.parametrize("dcn_algorithm", ["ring", "recursive_doubling",
                                           "xla"])
def test_hierarchical_allreduce_dcn_algorithms(dcn_algorithm):
    jmesh, mesh = _meshes(2, 4)
    data = _hybrid_data(2, 4, 16, seed=1)
    got = tp.hierarchical_all_reduce(torch.from_numpy(data), mesh,
                                     dcn_algorithm=dcn_algorithm)
    _same(got, jm.hierarchical_all_reduce(_jx(data, jmesh), jmesh,
                                          dcn_algorithm=dcn_algorithm))


@pytest.mark.parametrize("op", ["max", "min"])
def test_hierarchical_allreduce_minmax(op):
    jmesh, mesh = _meshes(2, 4)
    data = _hybrid_data(2, 4, 8, seed=2)
    got = tp.hierarchical_all_reduce(torch.from_numpy(data), mesh, op=op)
    _same(got, jm.hierarchical_all_reduce(_jx(data, jmesh), jmesh, op=op))


def test_hierarchical_allreduce_rejects_indivisible():
    jmesh, mesh = _meshes(2, 4)
    data = _hybrid_data(2, 4, 8)
    with pytest.raises(ValueError) as want:
        jm.hierarchical_all_reduce(_jx(data, jmesh)[:, :6], jmesh)
    with pytest.raises(ValueError) as got:
        tp.hierarchical_all_reduce(torch.from_numpy(data)[:, :6], mesh)
    assert str(got.value) == str(want.value)


def test_init_distributed_noop_single_process(monkeypatch):
    for v in ("MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    assert tp.init_distributed() is False  # no cluster detectable


def test_cluster_detection_reads_the_environment(monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert not tm._cluster_detectable()
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert tm._cluster_detectable()
    monkeypatch.delenv("MASTER_ADDR")
    assert not tm._cluster_detectable()


def test_process_info_single_process():
    idx, count, local = tp.process_info()
    assert idx == 0 and count == 1 and local >= 1
    assert make_mesh(8, device="cpu").procs == 1


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("dcn,ici", [(2, 4), (4, 2), (1, 8)])
@pytest.mark.parametrize("algorithm", ["ring", "xla"])
def test_hierarchical_all_gather(dcn, ici, algorithm, dtype):
    jmesh, mesh = _meshes(dcn, ici)
    data = _hybrid_data(dcn, ici, 8, seed=3, dtype=dtype)
    got = tp.hierarchical_all_gather(torch.from_numpy(data), mesh,
                                     dcn_algorithm=algorithm,
                                     ici_algorithm=algorithm)
    assert got.shape == (dcn * ici, dcn * ici, 8)
    _same(got, jm.hierarchical_all_gather(
        _jx(data, jmesh), jmesh, dcn_algorithm=algorithm,
        ici_algorithm=algorithm))


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("dcn,ici", [(2, 4), (4, 2)])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_hierarchical_reduce_scatter(dcn, ici, op, dtype):
    jmesh, mesh = _meshes(dcn, ici)
    p = dcn * ici
    data = _hybrid_data(dcn, ici, 2 * p, seed=4, dtype=dtype)
    got = tp.hierarchical_reduce_scatter(torch.from_numpy(data), mesh,
                                         op=op)
    _same(got, jm.hierarchical_reduce_scatter(_jx(data, jmesh), jmesh,
                                              op=op))
    np.testing.assert_array_equal(tp.hier_chunk_index(mesh).numpy(),
                                  jm.hier_chunk_index(jmesh))


def test_hierarchical_reduce_scatter_validates():
    jmesh, mesh = _meshes(2, 4)
    data = _hybrid_data(2, 4, 8, seed=5)
    with pytest.raises(ValueError) as want:
        jm.hierarchical_reduce_scatter(_jx(data, jmesh)[:, :6], jmesh)
    with pytest.raises(ValueError) as got:
        tp.hierarchical_reduce_scatter(torch.from_numpy(data)[:, :6], mesh)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dcn,ici", [(2, 4), (4, 2), (2, 2)])
def test_hierarchical_all_to_all(dcn, ici):
    jmesh, mesh = _meshes(dcn, ici)
    p = dcn * ici
    data = np.random.default_rng(6).integers(
        -100, 100, size=(p, p, 4)).astype(np.int32)
    got = tp.hierarchical_all_to_all(torch.from_numpy(data), mesh)
    want = jm.hierarchical_all_to_all(_jx(data, jmesh), jmesh)
    _same(got, want)
    np.testing.assert_array_equal(got.numpy(), data.swapaxes(0, 1))


@pytest.mark.parametrize("ici,dcn", [("hypercube", "wraparound"),
                                     ("ecube", "naive")])
def test_hierarchical_all_to_all_handrolled_carriers(ici, dcn):
    jmesh, mesh = _meshes(2, 4)
    data = np.random.default_rng(7).integers(
        -100, 100, size=(8, 8, 4)).astype(np.int32)
    got = tp.hierarchical_all_to_all(torch.from_numpy(data), mesh,
                                     ici_algorithm=ici, dcn_algorithm=dcn)
    _same(got, jm.hierarchical_all_to_all(
        _jx(data, jmesh), jmesh, ici_algorithm=ici, dcn_algorithm=dcn))


def test_hierarchical_all_to_all_validates():
    jmesh, mesh = _meshes(2, 4)
    data = np.zeros((8, 7, 4), np.int32)
    with pytest.raises(ValueError) as want:
        jm.hierarchical_all_to_all(_jx(data, jmesh), jmesh)
    with pytest.raises(ValueError) as got:
        tp.hierarchical_all_to_all(torch.from_numpy(data), mesh)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ chaos sites


def test_chaos_sites_registered():
    sites = chaos.registered_sites()
    assert "multihost.init" in sites
    assert {f"multihost.hier.{c}" for c in
            ("allreduce", "allgather", "reducescatter", "alltoall")} <= sites


def test_multihost_init_die_site():
    plan = chaos.FaultPlan(schedule={"die:multihost.init": (0,)})
    with chaos.inject(plan):
        with pytest.raises(chaos.InjectedDeath):
            tp.init_distributed()
        # retry: probe consumed; single-process env stays a no-op
        assert tp.init_distributed() is False
    assert plan.fired("die", "multihost.init") == 1


def test_multihost_hier_die_site():
    mesh = tm.make_hybrid_mesh(2, 2, device="cpu", n_ranks=4)
    x = torch.from_numpy(_hybrid_data(2, 2, 8))
    plan = chaos.FaultPlan(schedule={"die:multihost.hier.allgather": (0,)})
    with chaos.inject(plan):
        with pytest.raises(chaos.InjectedDeath):
            tp.hierarchical_all_gather(x, mesh)
        out = tp.hierarchical_all_gather(x, mesh)
    assert plan.fired("die", "multihost.hier.allgather") == 1
    assert out.shape == (4, 4, 8)


def test_multihost_clean_plan_bitwise_identical():
    mesh = tm.make_hybrid_mesh(2, 2, device="cpu", n_ranks=4)
    data = _hybrid_data(2, 2, 8, dtype="float32")
    x = torch.from_numpy(data)
    calls = (lambda: tp.hierarchical_all_reduce(x, mesh),
             lambda: tp.hierarchical_all_gather(x, mesh),
             lambda: tp.hierarchical_reduce_scatter(x, mesh),
             lambda: tp.hierarchical_all_to_all(x.reshape(4, 4, 2), mesh))
    base = [f() for f in calls]
    plan = chaos.FaultPlan(rates={"die:multihost.*": 0.0,
                                  "delay:multihost.*": 0.0})
    with chaos.inject(plan):
        armed = [f() for f in calls]
    assert plan.log == []
    for a, b in zip(armed, base):
        assert torch.equal(a, b)


# ------------------------------------------- what has no process backend


def test_paths_without_a_process_backend_refuse():
    """A mesh split over processes refuses, before any exchange, the
    paths ROADMAP A5 has not ported across processes: the sp schedules,
    decode whose dp ranks span processes, a flat schedule over one axis
    of a hybrid mesh, and the checked gradient ring. The collectives,
    reduceloc, alltoallv, checked mode and the sorts run there (the
    two-process cases below)."""
    from icikit_torch.models.attention.ring import ring_attention
    from icikit_torch.models.attention.ulysses import ulysses_attention
    from icikit_torch.models.attention.zigzag import zigzag_attention
    from icikit_torch.models.transformer import (TransformerConfig,
                                                 greedy_generate,
                                                 init_params,
                                                 make_train_step)
    from icikit_torch.models.transformer import model as tmodel

    mesh = RankMesh(8, "cpu", procs=2, proc=0)
    qkv = [torch.zeros(1, 16, 8, 4) for _ in range(3)]
    cfg = TransformerConfig(vocab=32, d_model=32, n_heads=4, d_head=8,
                            d_ff=64, n_layers=1, max_seq=8,
                            compute_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    two = tmodel.ModelMesh(2, 1, 1, device="cpu", procs=2, proc=1)
    hybrid = tm.HybridMesh(2, 4, "cpu", procs=2, proc=0)
    x = torch.zeros(4, 8, dtype=torch.int32)
    for call in (
            lambda: ring_attention(*qkv, mesh),
            lambda: zigzag_attention(*qkv, mesh),
            lambda: ulysses_attention(*qkv, mesh),
            lambda: greedy_generate(params, torch.zeros((2, 4), dtype=torch.int32),
                                    two, cfg, n_new=2),
            lambda: make_train_step(two, cfg, guard="device",
                                    grad_check="ring"),
            lambda: tp.all_reduce(x[:2], hybrid, axis="p")):
        with pytest.raises(NotImplementedError, match="ROADMAP A5"):
            call()
    # a process view needs a live group of as many processes
    for call in (lambda: tp.all_reduce(x, mesh),
                 lambda: tp.broadcast(x, mesh),
                 lambda: sort(torch.zeros(32, dtype=torch.int32), mesh,
                              algorithm="sample")):
        with pytest.raises(RuntimeError, match="torch.distributed"):
            call()


def test_process_plan_splits_pairs():
    """A permutation as process 1 of 2 (ranks 4-7) sees it: local pairs
    by one gather, one send and one receive list per peer, in the
    permutation's order, and whether every local rank receives."""
    perm = tuple((j, (j + 2) % 8) for j in range(8))
    ls, ld, sends, recvs, full = transport._proc_plan(perm, 8, 4, 1)
    assert (ls, ld) == ((0, 1), (2, 3))           # 4->6, 5->7
    assert sends == ((0, (2, 3)),)                # 6->0, 7->1
    assert recvs == ((0, (0, 1)),)                # 2->4, 3->5
    assert full
    ls, ld, sends, recvs, full = transport._proc_plan(((0, 5),), 8, 4, 1)
    assert (ls, sends, recvs, full) == ((), (), ((0, (1,)),), False)


# ------------------------------------------- the real two-process run

LOG2N = 16
M = 64


def _jax_hier(coll, ici, dcn, dtype, op, data):
    jmesh = jm.make_hybrid_mesh(dcn_size=2, ici_size=4)
    x = _jx(data["blocks" if coll == "alltoall" else dtype], jmesh)
    fn = {"allreduce": jm.hierarchical_all_reduce,
          "allgather": jm.hierarchical_all_gather,
          "reducescatter": jm.hierarchical_reduce_scatter,
          "alltoall": jm.hierarchical_all_to_all}[coll]
    kw = {} if op is None else {"op": op}
    return fn(x, jmesh, ici_algorithm=ici, dcn_algorithm=dcn, **kw)


def _jax_pt2pt(data):
    mesh8 = j_make_mesh(8)
    x = j_shard(jnp.asarray(data["int32"]), mesh8)

    def run(per_block, n_out=1):
        spec = P("p")
        out = shard_map(lambda b: per_block(b[0]), mesh=mesh8,
                        in_specs=spec,
                        out_specs=spec if n_out == 1 else (spec,) * n_out)(x)
        return out

    want = {
        "pt2pt/shift2": run(lambda b: jpt.sendrecv_shift(b, "p", 8, 2)[None]),
        "pt2pt/xor3": run(lambda b: jpt.sendrecv_xor(b, "p", 8, 3)[None]),
        "pt2pt/xor4": run(lambda b: jpt.sendrecv_xor(b, "p", 8, 4)[None]),
        "pt2pt/send0to5": run(lambda b: jpt.send_to(b, "p", [(0, 5)])[None]),
        "pt2pt/send6to1": run(lambda b: jpt.send_to(b, "p", [(6, 1)])[None]),
        "pt2pt/barrier": run(lambda b: (b + jpt.barrier("p"))[None]),
    }
    for periodic in (True, False):
        left, right = run(lambda b: tuple(
            h[None] for h in jpt.halo_exchange(b, "p", 8, 2, periodic)), 2)
        want[f"pt2pt/halo_left/{periodic}"] = left
        want[f"pt2pt/halo_right/{periodic}"] = right
    return want


def _launch_once(tmp_path_factory):
    """One two-process run of the worker for the whole test session:
    under pytest-xdist the first worker to get here launches it into a
    directory every worker shares, the others wait on its lock and read
    the result. Returns (the worker records, their stacked rows)."""
    import json

    from filelock import FileLock

    from icikit_torch.utils.net import PORT_RACE_SIGS

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    out = base / "torch_two_process_run"
    with FileLock(str(base / "torch_two_process_run.lock")):
        done = out / "done.json"
        if not done.exists():
            # one thread a process: the test workers share the host
            env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
            env.pop("XLA_FLAGS", None)
            try:
                res = mh.launch(mh.worker_argv("cpu", str(out), M, LOG2N),
                                str(out), timeout=150, env=env, cwd=ROOT)
            except OSError as e:  # pragma: no cover - environmental
                res = [(None, f"cannot bind a local port: {e}")]
            done.write_text(json.dumps(res))
        res = json.loads(done.read_text())
    if res[0][0] is None:  # pragma: no cover - environmental
        pytest.skip(res[0][1])
    outs = "\n".join(o for _, o in res)
    if any(c != 0 for c, _ in res) and any(s in outs for s in
                                           PORT_RACE_SIGS):
        pytest.skip("coordinator port kept colliding across 3 fresh "
                    "ports (busy host)")  # pragma: no cover
    for code, text in res:
        assert code == 0, text[-3000:]
        assert "WORKER_OK" in text
    rows = [np.load(out / f"rank{i}.npz") for i in range(2)]
    got = {k: np.concatenate([rows[0][k], rows[1][k]]) for k in rows[0]}
    return [mh.worker_result(o) for _, o in res], got


@pytest.fixture(scope="module")
def two_procs(tmp_path_factory):
    """The two-process run's records and stacked rows, the seeded
    inputs, and the port's one-process run of the same cases."""
    recs, got = _launch_once(tmp_path_factory)
    data = mh.inputs(M, LOG2N)
    # one thread: the test workers share the host, and a thread pool in
    # each oversubscribes it many times over
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = mh.run_cases(make_mesh(8, device="cpu"),
                           tm.make_hybrid_mesh(2, 4, device="cpu"), data)
        one["sort/bitonic"] = sort(torch.from_numpy(data["keys"]),
                                   make_mesh(8, device="cpu")).reshape(8, -1)
    finally:
        torch.set_num_threads(threads)
    return recs, got, data, one


def test_two_process_run_matches_jax_and_one_process(two_procs):
    """The ``mpirun`` analog for real: two OS processes join a gloo
    group, build the flat and hybrid meshes across the process boundary
    and run every case with their ranks split 4 + 4 (exchanges between
    the halves cross processes). Their stacked rows equal JAX's
    hierarchical collectives, pt2pt primitives and bitonic sort of 2^16
    int32 keys bitwise, and the port's one-process run of every case
    (the cases of NEW_CASES are also held to JAX one by one below).
    Skips when no local port can be bound or the coordinator port lost
    three races."""
    recs, got, data, one = two_procs
    assert [r["ranks"] for r in recs] == [[0, 4], [4, 8]]
    assert all(r["inversions"] == 0 for r in recs)
    assert all(r["wire"]["bytes_sent"] > 0 for r in recs)
    assert set(got) == set(one)
    for k, v in one.items():
        _same(torch.from_numpy(got[k]), v.numpy())

    want = _jax_pt2pt(data)
    for coll, ici, dcn, dt, op in mh.HIER:
        want[mh._name("hier", coll, ici, dcn, dt, op)] = _jax_hier(
            coll, ici, dcn, dt, op, data)
    want["sort/bitonic"] = np.asarray(j_sort(
        jnp.asarray(data["keys"]), j_make_mesh(8),
        algorithm="bitonic")).reshape(8, -1)
    for k, v in want.items():
        _same(torch.from_numpy(got[k]), v)


# the cases the process backend gained for broadcast, scatter, gather,
# reduceloc, alltoallv, checked mode and the sorts: each held to JAX
NEW_CASES = tuple(
    mh._name(fam, alg, dt, op, *sorted(kw.items()))
    for fam, alg, dt, op, kw in mh.FLAT
    if fam in ("broadcast", "scatter", "gather")) + mh.EXTRA


def _jax_new_case(name: str, data: dict):
    """JAX's rows of one case of NEW_CASES on the 8-device CPU mesh."""
    from icikit.models.sort import sort_kv as j_sort_kv
    from icikit.parallel import collops as jc
    from icikit.parallel import all_gather_v as j_all_gather_v
    from icikit.parallel import all_reduce as j_all_reduce
    from icikit.parallel import all_to_all_v as j_all_to_all_v
    from icikit.parallel import allreduce_loc as j_allreduce_loc
    from icikit.utils.mesh import replicate as j_replicate

    mesh8 = j_make_mesh(8)

    def sh(a):
        return j_shard(jnp.asarray(a), mesh8)

    parts = name.split("/")
    if parts[0] in ("broadcast", "scatter", "gather"):
        fam, alg, dt = parts[:3]
        fn = {"broadcast": jc.broadcast, "scatter": jc.scatter_blocks,
              "gather": jc.gather_blocks}[fam]
        x = (j_replicate(jnp.asarray(data[dt]), mesh8) if fam == "scatter"
             else sh(data[dt]))
        return fn(x, mesh8, algorithm=alg, root=mh.ROOT)
    if parts[0] == "reduceloc":
        val, idx = j_allreduce_loc(sh(data["int32"]), mesh8, op=parts[1])
        return np.tile(np.asarray([val, idx], np.int32), (8, 1))
    if parts[0] == "all_gather_v":
        out = j_all_gather_v(sh(data["int32"]), sh(data["own_counts"]),
                             mesh8, algorithm="ring")
        return out[("rows", "counts").index(parts[1])]
    if parts[0] == "all_to_all_v":
        out = j_all_to_all_v(sh(data["int32"]), sh(data["send_counts"]),
                             mesh8, algorithm="wraparound")
        return out[("rows", "counts", "overflow").index(parts[1])]
    if parts[0] == "checked" and parts[1] == "allreduce":
        return j_all_reduce(sh(data["float32"]), mesh8, algorithm="ring",
                            checked=True)
    if name == "checked/sort/bitonic":
        return np.asarray(j_sort(jnp.asarray(data["skeys"]), mesh8,
                                 algorithm="bitonic", checked=True)
                          ).reshape(8, -1)
    if parts[0] == "sort_kv":
        out = j_sort_kv(jnp.asarray(data["kv_keys"]),
                        jnp.asarray(data["kv_values"]), mesh8)
        return np.asarray(out[("keys", "values").index(parts[1])]
                          ).reshape(8, -1)
    assert parts[0] == "sort", name
    return np.asarray(j_sort(jnp.asarray(data["skeys"]), mesh8,
                             algorithm=parts[1])).reshape(8, -1)


@pytest.mark.parametrize("case", NEW_CASES)
def test_two_process_case_matches_jax_and_one_process(two_procs, case):
    """Each case the process backend gained, with its ranks split 4 + 4
    across the two processes: the stacked rows equal the port's
    one-process run and JAX's bitwise (a drilled bit flip included:
    the recovered allreduce is the clean one)."""
    _, got, data, one = two_procs
    _same(torch.from_numpy(got[case]), one[case].numpy())
    _same(torch.from_numpy(got[case]), _jax_new_case(case, data))


def test_two_process_drill_detected_and_retried_on_every_process(two_procs):
    """The drilled flip of the checked allreduce lands on one process's
    receive, and both processes see the verdict: each detects it once,
    retries once and recovers."""
    recs = two_procs[0]
    for r in recs:
        assert r["drill"] == {"detected": 1, "retries": 1,
                              "recoveries": 1, "fired": 1}
