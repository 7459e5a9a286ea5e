"""Optional native acceleration for the streaming vertex-cut engine.

`_fastcut.c` (shipped next to this module) implements the inner streaming
loop over the same flat numpy buffers the Python engines use: int32 edge
endpoints, a float64 load vector, and replica sets packed as rows of
uint64 bitmask limbs (one limb for p <= 64, a chunked `ceil(p/64)`-limb
row beyond that).  The kernel is compiled on first use with the system C
compiler into the port's own build directory (`build_root()`, never the
JAX package's cache, so the two packages never share a library) and
loaded through ctypes — no extra Python dependencies.  When no compiler
is available the caller falls back to the pure-Python fast engine
transparently.

Set REPRO_NO_NATIVE=1 to disable the native engine (used in CI to test
the fallback path).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

__all__ = ["native_engine", "native_available", "build_root"]

_CACHE: list | None = None  # [fn_or_None], resolved once


def _source_path() -> str:
    return os.path.join(os.path.dirname(__file__), "_fastcut.c")


def build_root() -> str | None:
    """The port's own build directory, `build/repro_torch/` of the checkout
    (the package lives at `src/repro_torch/`), created 0700 at first use.

    Shared by this loader and the CUDA kernel builder
    (`cuda/_build.py`).  It must belong to this user and admit no other
    writer: the library names are predictable, and `ctypes.CDLL` runs
    whatever sits there.  None when that cannot be had.
    """
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))), "build", "repro_torch")
    try:
        os.makedirs(path, mode=0o700, exist_ok=True)
        st = os.stat(path)
    except OSError:
        return None
    if st.st_uid != os.getuid() or st.st_mode & 0o022:
        return None
    return path


def _compiler() -> str | None:
    for cc in (os.environ.get("CC"), "cc", "gcc", "clang"):
        if cc and shutil.which(cc):
            return cc
    return None


def _build() -> ctypes.CDLL | None:
    if os.environ.get("REPRO_NO_NATIVE"):
        return None
    if sys.platform.startswith("win"):
        return None
    src = _source_path()
    if not os.path.exists(src):
        return None
    cc = _compiler()
    if cc is None:
        return None
    cache = build_root()
    if cache is None:
        return None
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(cache, f"fastcut_{digest}.so")
    if not os.path.exists(so_path):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so_path))
        os.close(fd)
        try:
            # plain -O3 keeps IEEE semantics (no -ffast-math), so the
            # native engine stays bit-identical to the Python engines
            subprocess.run([cc, "-O3", "-shared", "-fPIC", "-o", tmp, src],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
        except (OSError, subprocess.SubprocessError):
            if os.path.exists(tmp):
                os.unlink(tmp)
            return None
    try:
        return ctypes.CDLL(so_path)
    except OSError:
        return None


def _resolve():
    lib = _build()
    if lib is None:
        return None
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    fn = lib.stream_cut
    fn.restype = None
    fn.argtypes = [ctypes.c_int64, ctypes.c_int64, i32, i32, f64,
                   ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
                   f64, u64, ctypes.c_int64, i64, i32]
    return fn


def native_engine():
    """The compiled `stream_cut` entry point, or None if unavailable."""
    global _CACHE
    if _CACHE is None:
        _CACHE = [_resolve()]
    return _CACHE[0]


def native_available() -> bool:
    return native_engine() is not None
