"""Build the CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` source is compiled with ``nvcc`` for ``sm_90a`` into
its own shared library under ``icikit_torch/build/``, named by a hash of
its source, so an edited source rebuilds and an unchanged one loads at
once. Sources compile in parallel, one ``nvcc`` each. A failed build
raises: there is no fallback. ``build_sources`` builds other versions of
a library the same way (a source path, an output directory and extra
nvcc flags in the hash), for A/B benches.

The libraries have a plain C interface (no PyTorch headers), so a build
takes seconds. Pointers and the stream pass as ``c_void_p``, sizes as
``c_int64``, scales as ``c_float``; each entry returns
``cudaGetLastError()`` after its launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_libs: dict = {}
BUILD_LOG: dict = {}  # source -> {"seconds", "cached"}

_I64, _I32, _P = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
_F32 = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)

# C signatures, by library.
_SIGNATURES = {
    "bitonic_net": {
        "icikit_net_pass": [_I32, _P, _P, _I64, _I32, _I32, _IP, _IP, _IP,
                            _P],
        "icikit_cross_pass": [_I32, _P, _P, _I64, _I64, _I32, _I32, _I32,
                              _I32, _I32, _P],
        "icikit_kernel_regs": [_I32, _IP, _IP],
    },
    "attention": {
        "icikit_flash_fwd": [_I32, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                             _I32, _I32, _F32, _I32, _F32, _P],
        "icikit_flash_bwd": [_I32, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I64, _I64, _I64, _I32, _I32, _F32, _F32, _P],
        "icikit_flash_bwd_dq": [_I32, _P, _P, _P, _P, _P, _P, _P, _I64,
                                _I64, _I64, _I32, _I32, _F32, _F32, _P],
        "icikit_flash_bwd_dkv": [_I32, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I64, _I64, _I64, _I32, _I32, _F32, _F32,
                                 _P],
        "icikit_decode_step": [_I32, _P, _P, _P, _P, _P, _P, _P, _P, _I64,
                               _I64, _I32, _I64, _I32, _F32, _P],
        "icikit_decode_step_q8": [_I32, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _I64, _I64, _I32, _I64, _F32, _P],
        "icikit_attention_regs": [_I32, _IP, _IP],
        "icikit_flash_occupancy": [_I32, _I32, _IP, _IP],
    },
    "xent": {
        "icikit_xent_fwd": [_I32, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I64, _I64, _I64, _I32, _P],
        "icikit_xent_dx": [_I32, _P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                           _I64, _I64, _P],
        "icikit_xent_dw": [_I32, _P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                           _I64, _I64, _P],
        "icikit_xent_g": [_I32, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                          _P],
        "icikit_xent_g_saved": [_I32, _P, _P, _P, _P, _P, _P, _I64, _I64,
                                _I64, _P],
        "icikit_xent_recompute": [_I32, _I32, _P, _P, _P, _P, _P, _P, _I64,
                                  _I64, _I64, _P],
        "icikit_xent_regs": [_I32, _IP, _IP],
    },
    "adam": {
        "icikit_adam_tree": [_I32, ctypes.POINTER(_I64), _I32, _I64, _P, _P,
                             _F32, _F32, _F32, _F32, _F32, _P],
        "icikit_adam_regs": [_I32, _IP, _IP],
    },
    "quant": {
        "icikit_quant_matvec": [_I32, _P, _P, _P, _P, _I64, _I64, _I64, _P],
        "icikit_quant_regs": [_I32, _IP, _IP],
    },
    "stack_write": {
        "icikit_stack_write": [_P, _P, _I64, _I64, _I64, _P],
        "icikit_stack_read": [_P, _P, _I64, _I64, _I64, _P],
        "icikit_stack_regs": [_I32, _IP, _IP],
    },
    "tile_floor": {
        "icikit_tile_mxu": [_P, _P, _P, _P, _I64, _I64, _I32, _F32, _P],
        "icikit_tile_ablate": [_I32, _I32, _P, _P, _P, _P, _I64, _I64, _I32,
                               _F32, _P],
        "icikit_tile_floor_regs": [_I32, _IP, _IP],
    },
}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the icikit_torch kernels are "
        "built from csrc/ at first use and have no fallback")


def _target(name: str, src: str | None = None, out_dir: str = BUILD_DIR,
            flags=()) -> tuple[str, str]:
    src = src or os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join([*ARCH_FLAGS, *flags])
                                .encode()).hexdigest()[:16]
    return src, os.path.join(out_dir, f"lib{name}-{digest}.so")


def _start(name: str, src: str | None = None, out_dir: str = BUILD_DIR,
           flags=()):
    """Start ``nvcc`` for ``name`` (``csrc/{name}.cu`` unless ``src`` is
    given) unless its library is built; returns (so path, process,
    temporary output, start time), the last three None when the library
    is already built."""
    src, so = _target(name, src, out_dir, flags)
    if os.path.isfile(so):
        return so, None, None, None
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", *flags, "-shared",
           "-Xcompiler", "-fPIC", "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return so, proc, tmp, time.perf_counter()


def _finish(name: str, so: str, proc, tmp, t0, optional: bool = False):
    """Wait for one build started by ``_start``, load the library and
    bind ``name``'s C signatures (only those it exports when
    ``optional``); returns (library, nvcc's output, seconds or None when
    it was built before). nvcc's output is kept beside the library."""
    log = so[:-3] + ".log"
    if proc is None:
        seconds = None
    else:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} "
                               f"(exit {proc.returncode}):\n{out}")
        with open(log, "w") as f:
            f.write(out)
        os.replace(tmp, so)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(so)
    for fn, argtypes in _SIGNATURES[name].items():
        if optional and not hasattr(lib, fn):
            continue
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    output = ""
    if os.path.isfile(log):
        with open(log) as f:
            output = f.read()
    return lib, output, seconds


def build(names=None) -> dict:
    """Build (in parallel) and load the named libraries; returns
    ``{name: ctypes.CDLL}``. Raises RuntimeError on a failed build."""
    names = list(_SIGNATURES) if names is None else list(names)
    with _lock:
        todo = [n for n in names if n not in _libs]
        started = {n: _start(n) for n in todo}
        for n, args in started.items():
            _libs[n], _, seconds = _finish(n, *args)
            BUILD_LOG[n] = {"seconds": seconds or 0.0,
                            "cached": seconds is None}
        return {n: _libs[n] for n in names}


def build_sources(name: str, sources: dict, out_dir: str, flags=()) -> dict:
    """Build (in parallel) other versions of library ``name``:
    ``sources`` maps a key to a source path, each built with the extra
    nvcc ``flags`` into ``out_dir`` (named by a hash of the source and
    the flags) and bound to ``name``'s signatures where it exports them.
    Returns ``{key: (ctypes.CDLL, nvcc's output)}``; the output is the
    one of the build that made the library."""
    flags = tuple(flags)
    paths = {k: _target(name, src, out_dir, flags)[1]
             for k, src in sources.items()}
    started = {}  # one build a library, however many keys name it
    for k, src in sources.items():
        if paths[k] not in started:
            started[paths[k]] = _start(name, src, out_dir, flags)
    built = {so: _finish(name, *args, optional=True)[:2]
             for so, args in started.items()}
    return {k: built[so] for k, so in paths.items()}


def load(name: str):
    """The loaded library ``name``, built at first use."""
    lib = _libs.get(name)
    return lib if lib is not None else build([name])[name]


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


# dtype codes of the attention and cross-entropy entries
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def stream(x: torch.Tensor) -> int:
    """PyTorch's current stream on x's device, as the C entries take it."""
    return torch.cuda.current_stream(x.device).cuda_stream


def check_operands(what: str, tensors, dtype) -> None:
    """Raise unless every tensor is a CUDA tensor of ``dtype`` (float32
    or bfloat16), contiguous and 16-byte aligned."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: expected CUDA or CPU tensors, got "
                             f"{t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{what}: every operand must be {dtype}, got "
                             f"{t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: operands must be contiguous and "
                             f"16-byte aligned")
    if dtype not in DTYPE_CODE:
        raise ValueError(f"{what}: the kernels take float32 or bfloat16, "
                         f"got {dtype}")
