"""Build the port's CUDA kernels with `nvcc` and load them with ctypes.

Every `csrc/*.cu` source is compiled for `sm_90a` into one shared library
with a plain C interface, at first use, into `build/repro_torch/` of the
checkout (`_native.build_root()`), named by a hash of the sources and the
flags so that an edited source is rebuilt and a stale library is never
loaded.  The compile goes to a temporary file that is renamed into place,
so processes that build at the same time never load a half-written file.

There is no fallback: without `nvcc`, or when the compile fails, loading
raises.  The wrappers call this only for CUDA tensors.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

from .._native import build_root

__all__ = ["NVCC_FLAGS", "sources", "build_library", "load_library"]

# no --use_fast_math; --fmad=false keeps every add an add (bit-identity
# with the host engines rests on the exact order and rounding of the adds);
# -Xptxas -v reports each kernel's registers, shared memory and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# where nvcc is looked for after PATH
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"

_lib: "ctypes.CDLL | None" = None


def sources() -> list[str]:
    """The kernel sources, `src/repro_torch/csrc/*.cu`, in name order."""
    csrc = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "csrc")
    return sorted(glob.glob(os.path.join(csrc, "*.cu")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), NVCC_FALLBACK):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built, and a CUDA tensor has no other path")


def build_library() -> tuple[str, str]:
    """Compile the kernels if needed; return (library path, compiler log).

    The log is nvcc's output (the ptxas report) when this call compiled,
    and empty when the library was already built.
    """
    srcs = sources()
    if not srcs:
        raise RuntimeError("no CUDA sources found beside the package")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs:
        with open(path, "rb") as f:
            digest.update(f.read())
    root = build_root()
    if root is None:
        raise RuntimeError("no private build directory for the CUDA kernels")
    so_path = os.path.join(root, f"kernels_{digest.hexdigest()[:16]}.so")
    if os.path.exists(so_path):
        return so_path, ""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=root)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so_path, proc.stdout + proc.stderr


def load_library() -> ctypes.CDLL:
    """The built kernel library with every entry's C signature declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library()[0])
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        for name in ("segsum_f64", "segsum_i64"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [vp, vp, i64, vp, i64, vp]
        _lib = lib
    return _lib
