"""Time block shapes of the RWKV6 kernel on one NVIDIA GPU.

    python3 tools/rwkv6_sweep.py

Builds copies of `src/repro_torch/csrc/rwkv6.cu` with other block
constants — lanes that share a state column (kParts, with
kRowsPerLane = 64 / kParts), state columns per block (kCols) and time
steps staged per round (kSteps) — one nvcc each with the library's flags,
all at once. Each variant is checked against the plain version at
rwkv6-7b's prefill shape (B=2, S=4096, H=64, Dk=Dv=64, no s0) and decode
shape (B=4, S=1, with s0): S_last bit for bit, out within
1e-5 * max(1, max|out|). Then it is timed with CUDA events (a warm-up,
then the mean of 10 launches at the prefill shape and 200 at the decode
shape), every variant twice in turn. The first variant is the source's
own shape.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

from repro_torch.core._native import build_root  # noqa: E402
from repro_torch.core.cuda import _build  # noqa: E402
from repro_torch.kernels import rwkv6  # noqa: E402

# (kParts, kCols, kSteps); the source's own shape first
VARIANTS = [(8, 16, 16), (4, 16, 16), (4, 32, 16), (8, 8, 16), (2, 32, 16),
            (16, 8, 16), (16, 16, 16), (8, 32, 16), (8, 16, 32)]
SOURCE = {"kParts": 8, "kRowsPerLane": 8, "kCols": 16, "kSteps": 16}
PREFILL = (2, 4096, 64, 64, 64)
DECODE = (4, 1, 64, 64, 64)


def variant_source(text: str, parts: int, cols: int, steps: int) -> str:
    for name, value in (("kParts", parts), ("kRowsPerLane", 64 // parts),
                        ("kCols", cols), ("kSteps", steps)):
        old = f"constexpr int {name} = {SOURCE[name]};"
        if text.count(old) != 1:
            raise RuntimeError(f"{old!r} is not in the source once")
        text = text.replace(old, f"constexpr int {name} = {value};")
    return text


def build(tmp: str) -> dict:
    src = os.path.join(HERE, "..", "src", "repro_torch", "csrc", "rwkv6.cu")
    with open(src) as f:
        text = f.read()
    procs = {}
    for shape in VARIANTS:
        name = "p{}c{}s{}".format(*shape)
        path = os.path.join(tmp, name + ".cu")
        with open(path, "w") as f:
            f.write(variant_source(text, *shape))
        procs[shape] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             os.path.join(tmp, name + ".so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for shape, proc in procs.items():
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {shape}:\n{out}")
        lib = ctypes.CDLL(os.path.join(tmp, "p{}c{}s{}.so".format(*shape)))
        fn = lib.rwkv6_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 5 \
            + [ctypes.c_void_p]
        regs = [line.split("Used ")[1].split(" registers")[0]
                for line in out.splitlines()
                if "Used" in line and "registers" in line]
        print(f"variant kParts={shape[0]} kCols={shape[1]} "
              f"kSteps={shape[2]}: registers per launch entry {regs}",
              flush=True)
        libs[shape] = fn
    return libs


def inputs(B, S, H, Dk, Dv, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = torch.randn((B, S, H, Dk), generator=g, device="cuda")
    k = torch.randn((B, S, H, Dk), generator=g, device="cuda") * 0.3
    v = torch.randn((B, S, H, Dv), generator=g, device="cuda")
    w = torch.rand((B, S, H, Dk), generator=g, device="cuda") * 0.59 + 0.4
    u = torch.randn((H, Dk), generator=g, device="cuda") * 0.1
    s0 = torch.randn((B, H, Dk, Dv), generator=g, device="cuda")
    return r, k, v, w, u, s0


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("rwkv6_sweep: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    root = build_root()
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        libs = build(tmp)
        for shape, reps, with_s0 in ((PREFILL, 10, False),
                                     (DECODE, 200, True)):
            B, S, H, Dk, Dv = shape
            r, k, v, w, u, s0 = inputs(*shape)
            s0 = s0 if with_s0 else None
            want_o, want_s = rwkv6.rwkv6_plain(r, k, v, w, u, s0)
            tol = 1e-5 * max(1.0, float(want_o.abs().max()))
            out = torch.empty_like(v)
            s_last = torch.empty((B, H, Dk, Dv), device="cuda")
            print(f"shape (B, S, H, Dk, Dv)={shape} "
                  f"s0={'given' if with_s0 else 'none'}", flush=True)
            for _ in range(2):
                for vshape, fn in libs.items():
                    def call(fn=fn):
                        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                                w.data_ptr(), u.data_ptr(),
                                s0.data_ptr() if s0 is not None else None,
                                out.data_ptr(), s_last.data_ptr(), B, S, H,
                                Dk, Dv, torch.cuda.current_stream()
                                .cuda_stream)
                        if rc != 0:
                            raise RuntimeError(f"launch failed: {rc}")
                    call()
                    torch.cuda.synchronize()
                    err = float((out - want_o).abs().max())
                    if not torch.equal(s_last, want_s) or err > tol:
                        raise AssertionError(f"variant {vshape} disagrees "
                                             f"with the plain version")
                    ms = cuda_ms(call, reps)
                    print(f"  kParts={vshape[0]} kCols={vshape[1]} "
                          f"kSteps={vshape[2]}: {ms!r} ms (out error "
                          f"{err!r}, S_last equal)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
