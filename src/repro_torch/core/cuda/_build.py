"""Build the port's CUDA kernels with `nvcc` and load them with ctypes.

Every `csrc/*.cu` source is compiled for `sm_90a` into one shared library
with a plain C interface, at first use, into `build/repro_torch/` of the
checkout (`_native.build_root()`), named by a hash of the sources, the
headers they include (`csrc/*.cuh`) and the flags, so that an edited
source is rebuilt and a stale library is never loaded.  The sources compile at the same time, one nvcc each, and are
linked into a temporary file that is renamed into place, so processes that
build at the same time never load a half-written file.

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

__all__ = ["NVCC_FLAGS", "sources", "headers", "build_library",
           "load_library"]

# no --use_fast_math; --fmad=false keeps every add an add (bit-identity
# with the host engines rests on the exact order and rounding of the adds);
# -Xptxas -v reports each kernel's registers, shared memory and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# where nvcc is looked for after PATH
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"

_lib: "ctypes.CDLL | None" = None


def _csrc() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "csrc")


def sources() -> list[str]:
    """The kernel sources, `src/repro_torch/csrc/*.cu`, in name order."""
    return sorted(glob.glob(os.path.join(_csrc(), "*.cu")))


def headers() -> list[str]:
    """The headers the sources include, `src/repro_torch/csrc/*.cuh`."""
    return sorted(glob.glob(os.path.join(_csrc(), "*.cuh")))


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
    for path in srcs + headers():
        with open(path, "rb") as f:
            digest.update(f.read())
    root = build_root()
    if root is None:
        raise RuntimeError("no private build directory for the CUDA kernels")
    so_path = os.path.join(root, f"kernels_{digest.hexdigest()[:16]}.so")
    if os.path.exists(so_path):
        return so_path, ""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        objs = [os.path.join(tmp, os.path.basename(src) + ".o")
                for src in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(srcs, objs)]
        log = ""
        failed = []
        try:
            for src, proc in zip(srcs, procs):
                out, _ = proc.communicate(timeout=600)
                log += out
                if proc.returncode != 0:
                    failed.append(f"{os.path.basename(src)} "
                                  f"({proc.returncode})")
        finally:
            for proc in procs:      # none outlives a failed build
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
        lib = os.path.join(tmp, "kernels.so")
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", lib,
                               *objs],
                              capture_output=True, text=True, timeout=600)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(lib, so_path)
    return so_path, log + link.stdout + link.stderr


def load_library() -> ctypes.CDLL:
    """The built kernel library with every entry's C signature declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library()[0])
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        f32 = ctypes.c_float
        signatures = {
            # data, ids, m, out, num_segments, scratch, stream
            ("segsum_f64", "segsum_i64"): [vp, vp, i64, vp, i64, vp, vp],
            # q, k, v, out, lse (may be null), B, Sq, Sk, Hq, Hkv, Dqk, Dv,
            # causal, has_window, window, has_softcap, softcap, scale,
            # q_offset, stream
            ("flash_attention_f32", "flash_attention_bf16"):
                [vp, vp, vp, vp, vp, i64, i64, i64, i64, i64, i64, i64, i32,
                 i32, i64, i32, f32, f32, i64, vp],
            # q, k, v, out, dout, lse, delta (scratch), dq, dk, dv, B, Sq,
            # Sk, Hq, Hkv, Dqk, Dv, causal, has_window, window,
            # has_softcap, softcap, scale, q_offset, stream
            ("flash_attention_bwd_f32", "flash_attention_bwd_bf16"):
                [vp] * 10 + [i64, i64, i64, i64, i64, i64, i64, i32, i32,
                             i64, i32, f32, f32, i64, vp],
            # x, a, h0 (may be null), h, h_last, B, S, D, stream
            ("rglru_f32", "rglru_bf16"):
                [vp, vp, vp, vp, vp, i64, i64, i64, vp],
            # x, a, h0, h, dh, dh_last, scratch, dx, da, dh0 (h0, dh_last
            # and dh0 may be null), B, S, D, stream
            ("rglru_bwd_f32", "rglru_bwd_bf16"):
                [vp] * 10 + [i64, i64, i64, vp],
            # r, k, v, w, u, s0, out, s_last, ckpt (s0 and ckpt may be
            # null), B, S, H, Dk, Dv, stream
            ("rwkv6_f32", "rwkv6_bf16"):
                [vp] * 9 + [i64, i64, i64, i64, i64, vp],
            # r, k, v, w, u, dout, ds_last, ckpt, scratch, dr, dk, dv, dw,
            # du, ds0 (dout, ds_last and ds0 may be null), B, S, H, Dk, Dv,
            # stream
            ("rwkv6_bwd_f32", "rwkv6_bwd_bf16"):
                [vp] * 15 + [i64, i64, i64, i64, i64, vp],
        }
        for names, argtypes in signatures.items():
            for name in names:
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
        # m, num_segments -> int64 elements of segsum scratch
        lib.segsum_scratch_len.restype = i64
        lib.segsum_scratch_len.argtypes = [i64, i64]
        # the RWKV6 forward's steps between checkpoints; B, S, H, Dk,
        # Dv -> float32 elements of the backward's scratch
        lib.rwkv6_ckpt_steps.restype = i32
        lib.rwkv6_ckpt_steps.argtypes = []
        lib.rwkv6_bwd_scratch_len.restype = i64
        lib.rwkv6_bwd_scratch_len.argtypes = [i64] * 5
        # the RG-LRU backward's steps a chunk; B, S, D -> float32 elements
        # of its scratch
        lib.rglru_bwd_chunk_steps.restype = i32
        lib.rglru_bwd_chunk_steps.argtypes = []
        lib.rglru_bwd_scratch_len.restype = i64
        lib.rglru_bwd_scratch_len.argtypes = [i64] * 3
        _lib = lib
    return _lib
