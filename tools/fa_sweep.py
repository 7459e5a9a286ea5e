"""Time warp layouts of the flash-attention kernel on one NVIDIA GPU.

    python3 tools/fa_sweep.py [--parent DIR]

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

With `--parent DIR`, a checkout of an earlier commit (its
`src/repro_torch/csrc/flash_attention.cu` with its headers inlined) is
built beside it, and the two are run on the same inputs at the serving
shape and at dbrx-132b's prefill shape (q [2,2048,48,128], k/v
[2,2048,8,128], float32, causal): both checked against the plain
version, whether their outputs are the same bits printed, and each
timed in turns (parent, this, this, parent).  The parent's C entry may
take one head dim (before the (Dqk, Dv) entries) or two.
"""
from __future__ import annotations

import argparse
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
# dbrx-132b's prefill shape, for the comparison with a parent
DBRX = dict(B=2, S=2048, Hq=48, Hkv=8, D=128, window=None)
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


def source(csrc: str) -> str:
    """`flash_attention.cu` of a source directory with `fa_common.cuh`
    inlined, so the block constants it holds can be swapped too and a
    copy builds anywhere."""
    with open(os.path.join(csrc, "flash_attention.cu")) as f:
        text = f.read()
    with open(os.path.join(csrc, "fa_common.cuh")) as f:
        return text.replace('#include "fa_common.cuh"', f.read())


def argtypes(two_dims: bool) -> list:
    """The C entry's arguments: q, k, v, out, lse, B, Sq, Sk, Hq, Hkv,
    the head dim (Dqk, Dv with `two_dims`), causal, has_window, window,
    has_softcap, softcap, scale, q_offset, stream."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    f32 = ctypes.c_float
    return ([vp] * 5 + [i64] * (7 if two_dims else 6)
            + [i32, i32, i64, i32, f32, f32, i64, vp])


def build(tmp: str) -> dict:
    text = source(os.path.join(HERE, "..", "src", "repro_torch", "csrc"))
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
        fn.argtypes = argtypes(True)
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


def parent_entry(parent: str, tmp: str):
    """The parent checkout's float32 forward, built alone: (its C
    function, whether it takes Dqk and Dv)."""
    text = source(os.path.join(parent, "src", "repro_torch", "csrc"))
    path = os.path.join(tmp, "parent.cu")
    with open(path, "w") as f:
        f.write(text)
    so = path[:-3] + ".so"
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-o", so, path], capture_output=True, text=True,
                         timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed on the parent:\n{out.stdout}"
                           f"{out.stderr}")
    two_dims = "int64_t Dv" in text
    fn = ctypes.CDLL(so).flash_attention_f32
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes(two_dims)
    print(f"parent {parent}: {ptxas_report(out.stdout + out.stderr)}",
          flush=True)
    return fn, two_dims


def compare(this_fn, parent_fn, parent_two_dims: bool) -> None:
    """This source's kernel and the parent's on the same inputs at MAIN
    and DBRX: both against the plain version, the same bits or not, and
    the times in turns (parent, this, this, parent)."""
    for shape in (MAIN, DBRX):
        B, S, Hq, Hkv, D, window = (shape[k] for k in
                                    ("B", "S", "Hq", "Hkv", "D", "window"))
        g = torch.Generator(device="cuda").manual_seed(1)
        q = torch.randn((B, S, Hq, D), generator=g, device="cuda")
        k = torch.randn((B, S, Hkv, D), generator=g, device="cuda")
        v = torch.randn((B, S, Hkv, D), generator=g, device="cuda")
        want = fa.flash_attention_plain(q, k, v, causal=True, window=window)
        outs = {"this": torch.empty_like(q), "parent": torch.empty_like(q)}

        def call(who):
            fn, dims = ((this_fn, (D, D)) if who == "this" else
                        (parent_fn, (D, D) if parent_two_dims else (D,)))
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    outs[who].data_ptr(), None, B, S, S, Hq, Hkv, *dims, 1,
                    int(window is not None), window or 0, 0, 0.0,
                    D ** -0.5, 0, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{who} launch failed: CUDA error {rc}")

        for who in outs:
            call(who)
        torch.cuda.synchronize()
        errs = {who: float((out - want).abs().max())
                for who, out in outs.items()}
        if not max(errs.values()) <= TOL:
            raise AssertionError(f"parent comparison error {errs!r}")
        ms = {"parent": [], "this": []}
        for who in ("parent", "this", "this", "parent"):
            ms[who].append(cuda_ms(lambda: call(who), 10))
        print(f"compare q [{B},{S},{Hq},{D}] k/v [{B},{S},{Hkv},{D}] "
              f"float32, causal, window {window}: parent {ms['parent']!r} "
              f"ms, this {ms['this']!r} ms; max abs error {errs!r}; same "
              f"bits {torch.equal(outs['this'], outs['parent'])}",
              flush=True)
        del q, k, v, want, outs
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--parent", default=None,
                    help="a checkout of an earlier commit to compare with")
    args = ap.parse_args(argv)
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
                              D, 1, 1,
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
        del q, k, v, want, out
        torch.cuda.empty_cache()
        if args.parent:
            compare(libs[VARIANTS[0]], *parent_entry(args.parent, tmp))
    return 0


if __name__ == "__main__":
    sys.exit(main())
