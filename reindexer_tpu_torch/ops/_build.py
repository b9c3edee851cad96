"""Builds and loads the port's CUDA kernels (route: nvcc into a shared
library with a plain C interface, loaded with ctypes).

Each kernel is one source file under `reindexer_tpu_torch/csrc/`, which may
include the shared headers (`csrc/*.cuh`). At its first use in a process,
`load(name)` compiles `csrc/<name>.cu` with nvcc for Hopper (`sm_90a`) into
`build/reindexer_tpu_torch/` at the repository root, named by a hash of the
source, the headers and the flags, so an edited source or header rebuilds and
an unchanged one loads the library already built. Nothing here runs at import
time: the CPU tests import every module on a machine without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "reindexer_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C signature of each kernel's launcher (see the .cu sources)
_LAUNCH_ARGTYPES = {
    "bf_scan": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "bf_select": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "sq8_scan": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "sq8_i8_scan": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "sq8_select": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                   _P],
    "ivf_seg_scan": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "hnsw_beam": [_P] * 19 + [_I] * 10 + [_P],
}
# other C functions a library exports: name -> (argtypes, restype)
_EXTRA_FUNCS = {
    "sq8_select": {"sq8_select_scratch_bytes": ([_I, _I], _L)},
    "ivf_seg_scan": {"ivf_seg_scan_scratch_ints": ([_I, _I, _I], _L)},
    "hnsw_beam": {"hnsw_beam_spill_bytes": ([_I] * 5, _L),
                  "hnsw_descend_spill_bytes": ([_I] * 3, _L),
                  "hnsw_descend_launch": ([_P] * 9 + [_I] * 8 + [_P], _I)},
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> (seconds from nvcc's start to its end, 0.0 when loaded from the
# cache; the compiler's output, which holds ptxas's registers and shared
# memory)
build_info: dict[str, tuple[float, str]] = {}


class Counter:
    """A thread-safe integer count (kernel launches, engine reruns, beam
    steps)."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._n += n

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "reindexer_tpu_torch are built at first use and "
                           "need the CUDA toolkit (CUDA_HOME or PATH)")
    return found


def library_path(name: str) -> Path:
    """Where the library of kernel `name` is built: keyed by the hash of
    its source, the shared headers and the compiler flags."""
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, compiling it first if needed."""
    return load_all([name])[0]


def load_all(names: list[str]) -> list[ctypes.CDLL]:
    """The loaded libraries of `names`. Those not built yet compile at once,
    one nvcc process per source, all started together."""
    with _lock:
        jobs = {}
        for name in names:
            if name in _libs or name in jobs:
                continue
            so = library_path(name)
            if so.exists():
                build_info.setdefault(name, (0.0, ""))
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC_DIR / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs[name] = (so, tmp, proc, time.perf_counter())
        failed = []
        for name, (so, tmp, proc, t0) in jobs.items():
            out = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {name}.cu:\n{out}")
                continue
            os.replace(tmp, so)
            build_info[name] = (time.perf_counter() - t0, out)
        if failed:
            raise RuntimeError("\n".join(failed))
        for name in names:
            if name not in _libs:
                _libs[name] = _bind(name, ctypes.CDLL(str(library_path(name))))
        return [_libs[name] for name in names]


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = _LAUNCH_ARGTYPES[name]
    launch.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    for fn_name, (argtypes, restype) in _EXTRA_FUNCS.get(name, {}).items():
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def check_launch(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{code} ({msg})")
