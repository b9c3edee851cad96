"""Native (C++) host components, built on demand with the system compiler.

Host C++ lanes with the same semantics as their Python code (the scalar
conjunction lane of query/executor.py and the rtree lane of index/rtree.py);
they run on the host, not on the GPU. Modules compile lazily with g++ on
first use into build/reindexer_tpu_torch/ at the repository root (beside the
CUDA kernels of ops/_build.py), named by a hash of the source, the compiler
command and the machine type, so a stale build or one for another machine is
never loaded. They are built for the generic instruction set of the machine
type, so a build runs on any host of that type. When no compiler is
available the callers keep the pure-Python implementations (same semantics,
slower).
"""
from __future__ import annotations

import hashlib
import importlib.util
import os
import platform
import subprocess
import sysconfig
import threading

_BUILD_LOCK = threading.Lock()
_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                          "reindexer_tpu_torch")
_FLAGS = ("-O3", "-funroll-loops", "-fPIC", "-shared", "-std=c++17")


def _command(src: str, out: str) -> list[str]:
    include = sysconfig.get_paths()["include"]
    return [os.environ.get("CXX", "g++"), *_FLAGS, f"-I{include}", src,
            "-o", out]


def _so_path(name: str, src: str) -> str:
    """The library's path: name, then a hash of what the build depends on."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_command("", "")).encode())
    h.update(platform.machine().encode())
    tag = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(_BUILD_DIR, f"{name}-{h.hexdigest()[:16]}{tag}")


def _build(name: str, source: str) -> str:
    src = os.path.join(_DIR, source)
    out = _so_path(name, src)
    if os.path.isfile(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    # build beside the target and rename, so that a process loading the
    # library never sees one half written by another
    tmp = f"{out}.{os.getpid()}.tmp"
    subprocess.run(_command(src, tmp), check=True, capture_output=True)
    os.replace(tmp, out)
    return out


def load(name: str, source: str):
    """Compile (if needed) and import a native module; returns the module or
    None when no compiler is available."""
    with _BUILD_LOCK:
        try:
            path = _build(name, source)
        except (subprocess.CalledProcessError, FileNotFoundError, OSError):
            return None
        spec = importlib.util.spec_from_file_location(name, path)
        if spec is None or spec.loader is None:
            return None
        mod = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(mod)
        except ImportError:
            return None
        return mod
