"""icikit_torch stands alone: no file of the port (nor chip_smoke.py)
imports jax or icikit, importing the port loads neither, and the
headline bench runs on the CPU when asked and prints bench.py's keys."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "icikit")


def _port_files():
    yield os.path.join(ROOT, "chip_smoke.py")
    for dirpath, dirnames, filenames in os.walk(
            os.path.join(ROOT, "icikit_torch")):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__",
                                                        "build")]
        for f in filenames:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported_roots(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_port_imports_neither_jax_nor_icikit():
    files = list(_port_files())
    assert len(files) > 10
    bad = [(os.path.relpath(p, ROOT), m) for p in files
           for m in _imported_roots(p) if m in FORBIDDEN]
    assert bad == []


def _run(code_or_args, timeout=300):
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, *code_or_args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, icikit_torch, icikit_torch.models.sort, "
            "icikit_torch.bench.headline, icikit_torch.interop, "
            "icikit_torch.parallel, icikit_torch.bench.run, "
            "icikit_torch.bench.harness, icikit_torch.chaos, "
            "icikit_torch.obs, icikit_torch.parallel.integrity, "
            "icikit_torch.ops.cuda_integrity; "
            "print([m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'icikit')])")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "seconds_per_sort",
              "spread_s", "windows", "discarded", "suspect",
              "session_quality", "protocol"}


def test_headline_runs_on_cpu_with_bench_keys():
    r = _run(["-m", "icikit_torch.bench.headline", "--device", "cpu",
              "--log2n", "14"])
    assert r.returncode == 0, r.stderr
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert BENCH_KEYS <= set(rec)
    assert rec["device"] == "cpu" and rec["power_limit"] is None
    assert rec["metric"] == "bitonic_sort_throughput_p1_n2e14_int32"
    assert rec["value"] > 0 and rec["protocol"] == "median-of-windows"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero with no result without CUDA (this
    image has none) — and, copied alone, without the package."""
    if _torch_has_cuda():
        pytest.skip("a CUDA device is present")
    r = _run([os.path.join(ROOT, "chip_smoke.py")])
    assert r.returncode != 0 and '"ok"' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    r = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"})
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_chip_smoke_last_line_names_the_card():
    """The last line's ``kind`` is ``torch.cuda.get_device_name(0)``:
    ``main`` binds that name once and nothing rebinds it (a loop target
    of that name once sent a counter's name there)."""
    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    main = next(f for f in tree.body
                if isinstance(f, ast.FunctionDef) and f.name == "main")
    bound = [n for n in ast.walk(main) if isinstance(n, ast.Name)
             and n.id == "kind" and isinstance(n.ctx, ast.Store)]
    assert len(bound) == 1
    assign = next(a for a in ast.walk(main) if isinstance(a, ast.Assign)
                  and bound[0] in a.targets)
    assert ast.unparse(assign.value) == "torch.cuda.get_device_name(0)"


def _torch_has_cuda():
    import torch
    return torch.cuda.is_available()


def test_interop_keeps_every_dtype():
    import jax.numpy as jnp
    import numpy as np
    import torch

    from icikit_torch.interop import from_jax, to_jax

    rng = np.random.default_rng(0)
    f = rng.standard_normal(33).astype(np.float32)
    cases = [
        (rng.integers(-2**31, 2**31 - 1, 33, dtype=np.int32), torch.int32),
        (rng.integers(0, 2**32, 33, dtype=np.uint32), torch.uint32),
        (f, torch.float32),
        (np.asarray(jnp.asarray(f).astype(jnp.bfloat16)), torch.bfloat16),
        (f.astype(np.float16), torch.float16),
    ]
    for a, tdtype in cases:
        t = from_jax(a)
        assert t.dtype == tdtype
        back = to_jax(t)
        assert back.dtype == a.dtype
        assert np.array_equal(back.view(np.uint8), a.view(np.uint8))
        assert np.array_equal(np.asarray(jnp.asarray(back)).view(np.uint8),
                              a.view(np.uint8))
