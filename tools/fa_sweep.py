"""Time warp layouts of the flash-attention kernel on one NVIDIA GPU.

    python3 tools/fa_sweep.py

Builds copies of `src/repro_torch/csrc/flash_attention.cu` (with
`fa_common.cuh` inlined) with other block constants — warps per block (kWarps, 16 q rows each) and keys per
k tile (kBlockK) — and other unroll factors of the loop over head_dim
that forms the scores, one nvcc each with the library's flags, all at once,
and prints each copy's registers and spills for the float32 head_dim-256
instantiation, and for the source's own layout the tensor-core and
shared-load instructions in the SASS of the head_dim-256 kernels
(`cuobjdump -sass`, where the toolkit has it). Each variant is checked
against the plain version at the serving shape of recurrentgemma-9b
(q [2,3072,16,256], k/v [2,3072,1,256], float32, causal, window 2048) to
2e-5, then timed with CUDA events (a warm-up, then the mean of 10
launches), every variant twice in turn. A variant whose shared memory
does not fit on the card is reported as such. The first variant is the
source's own layout.
"""
from __future__ import annotations

import collections
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

from repro_torch.core._native import build_root  # noqa: E402
from repro_torch.core.cuda import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

# (kWarps, kBlockK, unroll of the scores' loop over head_dim); the
# source's own first
VARIANTS = [(8, 16, 8), (8, 16, 4), (8, 16, 2), (8, 16, 32), (4, 32, 8),
            (4, 16, 8), (2, 32, 8), (2, 16, 8), (6, 16, 8), (4, 64, 8)]
SOURCE = {"kWarps": 8, "kBlockK": 16}
SCORES_LOOP = "#pragma unroll {}\n        for (int d0 = 0; d0 < D; d0 += 8)"
SOURCE_UNROLL = 8
MAIN = dict(B=2, S=3072, Hq=16, Hkv=1, D=256, window=2048)
TOL = 2e-5
# the float32, head_dim-256 instantiation's mangled name
ENTRY = "fa_kernelIfLi256E"


def variant_source(text: str, warps: int, block_k: int,
                   unroll: int) -> str:
    swaps = [(f"constexpr int {name} = {SOURCE[name]};",
              f"constexpr int {name} = {value};")
             for name, value in (("kWarps", warps), ("kBlockK", block_k))]
    swaps.append((SCORES_LOOP.format(SOURCE_UNROLL),
                  SCORES_LOOP.format(unroll)))
    for old, new in swaps:
        if text.count(old) != 1:
            raise RuntimeError(f"{old!r} is not in the source once")
        text = text.replace(old, new)
    return text


def ptxas_report(log: str) -> str:
    """Registers, spills and shared memory of ENTRY from `-Xptxas -v`."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and ENTRY in line:
            rest = " ".join(l.strip() for l in lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", rest)
            spill = re.search(r"(\d+) bytes spill stores", rest)
            return (f"{regs.group(1) if regs else '?'} registers, "
                    f"{spill.group(1) if spill else '?'} bytes spill stores")
    return "no report"


def sass_counts(lib_path: str) -> None:
    """Instruction counts of the head_dim-256 kernels' SASS."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        print("sass: cuobjdump not found", flush=True)
        return
    sass = subprocess.run([cuobjdump, "-sass", lib_path],
                          capture_output=True, text=True, timeout=120).stdout
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.split("\n", 1)[0].strip()
        if "fa_kernel" not in name or "Li256E" not in name:
            continue
        ops = re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", func)
        mma = collections.Counter(op for op in ops if "MMA" in op)
        kind = "bf16" if "bfloat16" in name else "float32"
        print(f"sass {kind} head_dim 256: {len(ops)} instructions, "
              f"{dict(mma)}, LDS {sum(op.startswith('LDS') for op in ops)}",
              flush=True)


def build(tmp: str) -> dict:
    csrc = os.path.join(HERE, "..", "src", "repro_torch", "csrc")
    with open(os.path.join(csrc, "flash_attention.cu")) as f:
        text = f.read()
    with open(os.path.join(csrc, "fa_common.cuh")) as f:
        # inlined, so the block constants it holds can be swapped too
        text = text.replace('#include "fa_common.cuh"', f.read())
    procs = {}
    for shape in VARIANTS:
        name = "w{}k{}u{}".format(*shape)
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
        lib = ctypes.CDLL(os.path.join(tmp, "w{}k{}u{}.so".format(*shape)))
        fn = lib.flash_attention_f32
        fn.restype = ctypes.c_int
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [vp, vp, vp, vp, vp, i64, i64, i64, i64, i64, i64, i32,
                       i32, i64, i32, ctypes.c_float, ctypes.c_float, i64,
                       vp]
        print(f"variant kWarps={shape[0]} kBlockK={shape[1]} "
              f"unroll={shape[2]}: {ptxas_report(out)}", flush=True)
        if shape == VARIANTS[0]:
            sass_counts(os.path.join(tmp, "w{}k{}u{}.so".format(*shape)))
        libs[shape] = fn
    return libs


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
        print("fa_sweep: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    B, S, Hq, Hkv, D, window = (MAIN[k] for k in
                                ("B", "S", "Hq", "Hkv", "D", "window"))
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((B, S, Hq, D), generator=g, device="cuda")
    k = torch.randn((B, S, Hkv, D), generator=g, device="cuda")
    v = torch.randn((B, S, Hkv, D), generator=g, device="cuda")
    want = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    out = torch.empty_like(q)
    root = build_root()
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        libs = build(tmp)
        print(f"shape q [{B},{S},{Hq},{D}] k/v [{B},{S},{Hkv},{D}] float32, "
              f"causal, window {window}", flush=True)
        fits = {}
        for _ in range(2):
            for shape, fn in libs.items():
                def call(fn=fn):
                    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), None, B, S, S, Hq, Hkv, D,
                              1, 1,
                              window, 0, 0.0, D ** -0.5, 0,
                              torch.cuda.current_stream().cuda_stream)
                if fits.get(shape, True):
                    rc = call()
                    fits[shape] = rc == 0
                if not fits[shape]:
                    print(f"  kWarps={shape[0]} kBlockK={shape[1]} "
                          f"unroll={shape[2]}: does not fit (launch "
                          f"refused)", flush=True)
                    continue
                torch.cuda.synchronize()
                err = float((out - want).abs().max())
                if not err <= TOL:
                    raise AssertionError(f"variant {shape} error {err!r}")
                ms = cuda_ms(call, 10)
                print(f"  kWarps={shape[0]} kBlockK={shape[1]} "
                      f"unroll={shape[2]}: {ms!r} ms (max abs error "
                      f"{err!r})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
