"""Time the RG-LRU and RWKV6 backward kernels beside an earlier commit's.

    python3 tools/scan_bwd_sweep.py [--parent DIR] [--reps N] [--variants]

Needs one NVIDIA GPU.  Builds `rglru_bwd.cu` and `rwkv6_bwd.cu` of this
checkout, and with `--parent DIR` (a checkout of an earlier commit, for
example unpacked from `git archive`) the parent's, each into its own
library with the kernel library's flags (`rwkv6_common.cuh` inlined),
and prints each kernel's registers and spills from `-Xptxas -v`.  Then,
at the training paths' layer shapes (RG-LRU: x, a, h, dh [1, 3072,
4096], path B; RWKV6: r, k, v, w, dout [1, 4096, 64, 64], path C, from
the forward kernel's checkpoints) in float32 and bfloat16, it runs this
backward and the parent's on the same inputs, prints how far they are
apart (max |a - b| over max(1, max |b|), each output), and times them
with CUDA events in turns (parent, this, this, parent), the RWKV6
backward beside its scratch in bytes and each of its launches' device
time from `torch.profiler`.  `--variants` also builds the ablations in
VARIANTS from this checkout's `rwkv6_bwd.cu` and times each beside it
at path C in float32 (unchecked: they drop work), and times this one at
8 to 64 heads.  One command gives the numbers that compare the two
designs on one card.  The exit code is 1 when a kernel fails to build,
and a failed launch raises.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from kernel_sweep import (CSRC, build, card_line, cuda_ms,  # noqa: E402
                          entry, ptxas_report, replace_once, sass_counts)

from repro_torch.kernels import rglru, rwkv6  # noqa: E402

V = ctypes.c_void_p
I64 = ctypes.c_int64
RG_SHAPE = (1, 3072, 4096)
RWKV_SHAPE = (1, 4096, 64, 64, 64)
# ablations of this checkout's rwkv6_bwd.cu, timed at path C in float32
# beside it with `--variants` (unchecked but for chunks_of_128_steps):
# each is a list of (text, replacement)
VARIANTS = {
    "chunks_of_128_steps": [("constexpr int kIntervals = 16;",
                             "constexpr int kIntervals = 8;")],
    "no_row_epilogue": [("            if (p < n_pairs && st < len && i < Dk) {",
                         "            if (p < n_pairs && st < len && i < 0) {")],
    "no_publish_sync": [("        cluster.sync();\n        if (n_my == 1) {",
                         "        if (n_my == 1) {")],
    "no_row_shuffles": [(f"                            x[i] += __shfl_xor_sync("
                         f"0xffffffffu, x[i], {o});", "")
                        for o in (2, 4)],
}


def inlined(csrc: str, name: str) -> str:
    """`name` of a source directory with its headers inlined, so that a
    copy builds anywhere."""
    with open(os.path.join(csrc, name)) as f:
        text = f.read()
    for header in re.findall(r'#include "(\w+\.cuh)"', text):
        with open(os.path.join(csrc, header)) as f:
            text = text.replace(f'#include "{header}"', f.read())
    return text


class Lib:
    """One build of the two backward sources: their C entries."""

    def __init__(self, rg_so: str, rwkv_so: str, rg_text: str):
        self.rg_scratch = "rglru_bwd_scratch_len" in rg_text
        n_rg = 10 if self.rg_scratch else 9
        self.rg = {dt: entry(rg_so, f"rglru_bwd_{dt}", [V] * n_rg +
                             [I64, I64, I64, V]) for dt in ("f32", "bf16")}
        self.rwkv = {dt: entry(rwkv_so, f"rwkv6_bwd_{dt}", [V] * 15 +
                               [I64] * 5 + [V]) for dt in ("f32", "bf16")}
        self.rwkv_so = rwkv_so
        self.rwkv_len = ctypes.CDLL(rwkv_so).rwkv6_bwd_scratch_len
        self.rwkv_len.restype = I64
        self.rwkv_len.argtypes = [I64] * 5
        self.rg_len = None
        if self.rg_scratch:
            self.rg_len = ctypes.CDLL(rg_so).rglru_bwd_scratch_len
            self.rg_len.restype = I64
            self.rg_len.argtypes = [I64] * 3


def build_both(csrc: str, tmp: str, label: str):
    """This source directory's two backward files, one library each."""
    texts = {"rglru": inlined(csrc, "rglru_bwd.cu"),
             "rwkv6": inlined(csrc, "rwkv6_bwd.cu")}
    built = build(tmp, texts, label=lambda key: f"{label} {key}")
    if len(built) != 2:
        return None
    for key, (_, log) in built.items():
        names = sorted(set(re.findall(
            r"Compiling entry function '(\w*bwd\w*)'", log)))
        for name in names:
            print(f"ptxas {label} {name}: {ptxas_report(log, name)}",
                  flush=True)
    return Lib(built["rglru"][0], built["rwkv6"][0], texts["rglru"])


def _err(got, want) -> float:
    got, want = got.double(), want.double()
    if want.numel() == 0:
        return 0.0
    return float((got - want).abs().max()) / max(1.0, float(
        want.abs().max()))


def rg_runner(lib: Lib, dtype, x, a, h, dh, dlast):
    B, S, D = x.shape
    dx, da = torch.empty_like(x), torch.empty_like(x)
    scratch = (torch.empty((lib.rg_len(B, S, D),), dtype=torch.float32,
                           device="cuda") if lib.rg_scratch else None)
    fn = lib.rg["f32" if dtype == torch.float32 else "bf16"]
    stream = torch.cuda.current_stream().cuda_stream
    head = [x.data_ptr(), a.data_ptr(), None, h.data_ptr(), dh.data_ptr(),
            dlast.data_ptr()] + ([scratch.data_ptr()] if lib.rg_scratch
                                 else [])

    def run():
        rc = fn(*head, dx.data_ptr(), da.data_ptr(), None, B, S, D, stream)
        if rc != 0:
            raise RuntimeError(f"rglru backward launch: CUDA error {rc}")
    return run, (dx, da)


def rwkv_runner(lib: Lib, dtype, r, k, v, w, u, ckpt, dout):
    B, S, H, Dk = r.shape
    Dv = v.shape[-1]
    n = lib.rwkv_len(B, S, H, Dk, Dv)
    scratch = torch.empty((n,), dtype=torch.float32, device="cuda")
    dr, dk, dw = (torch.empty_like(r) for _ in range(3))
    dv = torch.empty_like(v)
    du = torch.empty((H, Dk), dtype=torch.float32, device="cuda")
    fn = lib.rwkv["f32" if dtype == torch.float32 else "bf16"]
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (r, k, v, w, u, dout)] + [
        None, ckpt.data_ptr(), scratch.data_ptr()] + [
        t.data_ptr() for t in (dr, dk, dv, dw, du)] + [None]

    def run():
        rc = fn(*ptrs, B, S, H, Dk, Dv, stream)
        if rc != 0:
            raise RuntimeError(f"rwkv6 backward launch: CUDA error {rc}")
    return run, (dr, dk, dv, dw, du), 4 * n


def launch_split(fn) -> str:
    """Each kernel's device time in one call of `fn`, from
    torch.profiler (the mean of 5 calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            name = re.search(r"(\w+)(?:<[^>]*>)?\(", ev.key)
            rows.append(f"{name.group(1) if name else ev.key[:40]} "
                        f"{us / 5e3:.4f} ms")
    return "; ".join(rows)


def compare(label: str, runs: dict, outs: dict, reps: int,
            extra: str = "") -> None:
    for run in runs.values():
        run()
    torch.cuda.synchronize()
    if "parent" in outs:
        apart = [_err(a, b) for a, b in zip(outs["this"], outs["parent"])]
        print(f"{label}: this against the parent, scaled, per output: "
              f"{apart!r}", flush=True)
    order = (["parent", "this", "this", "parent"] if "parent" in runs
             else ["this", "this"])
    ms = {who: [] for who in runs}
    for who in order:
        ms[who].append(cuda_ms(runs[who], reps))
    print(f"time {label}: {ms}{extra}", flush=True)


def time_variants(tmp: str, this: Lib, reps: int) -> None:
    """Each of VARIANTS built from this checkout's rwkv6_bwd.cu and timed
    beside it at path C in float32, in turns."""
    os.makedirs(tmp)
    text = inlined(CSRC, "rwkv6_bwd.cu")
    sources = {}
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            src = replace_once(src, old, new)
        sources[name] = src
    built = build(tmp, sources, label=str)
    g = torch.Generator(device="cuda").manual_seed(1)
    B, S, H, Dk, Dv = RWKV_SHAPE
    r, k, w = (torch.randn((B, S, H, Dk), generator=g, device="cuda") * 0.5
               for _ in range(3))
    w = torch.exp(-torch.exp(w - 1.0))
    v = torch.randn((B, S, H, Dv), generator=g, device="cuda") * 0.5
    u = torch.randn((H, Dk), generator=g, device="cuda") * 0.5
    dout = torch.randn((B, S, H, Dv), generator=g, device="cuda")
    _, _, ckpt = rwkv6._launch(r, k, v, w, u, None, with_ckpt=True)
    base, base_out, _ = rwkv_runner(this, torch.float32, r, k, v, w, u,
                                    ckpt, dout)
    base()
    for name, (so, log) in built.items():
        lib = Lib.__new__(Lib)
        lib.rwkv = {"f32": entry(so, "rwkv6_bwd_f32", [V] * 15 + [I64] * 5 +
                                 [V])}
        lib.rwkv_len = this.rwkv_len
        run, out, _ = rwkv_runner(lib, torch.float32, r, k, v, w, u, ckpt,
                                  dout)
        run()
        torch.cuda.synchronize()
        apart = max(_err(a, b) for a, b in zip(out, base_out))
        ms = [cuda_ms(f, reps) for f in (base, run, run, base)]
        print(f"variant {name}: {ptxas_report(log, 'rwkv6_bwd_kernelIf')}; "
              f"apart from this {apart!r}; ms this {ms[0]!r} {ms[3]!r}, "
              f"variant {ms[1]!r} {ms[2]!r}; sass "
              f"{sass_counts(so, 'rwkv6_bwd_kernelIf')}", flush=True)
        print(f"profile variant {name}: {launch_split(run)}", flush=True)
    # heads: how the time grows with the clusters in flight (64 at path C)
    for heads in (8, 16, 32, 48, 64):
        sl = [x[:, :, :heads].contiguous() for x in (r, k, v, w, dout)]
        _, _, ck = rwkv6._launch(*sl[:4], u[:heads].contiguous(), None,
                                 with_ckpt=True)
        run, _, _ = rwkv_runner(this, torch.float32, *sl[:4],
                                u[:heads].contiguous(), ck, sl[4])
        print(f"heads {heads}: this {cuda_ms(run, reps)!r} ms", flush=True)
        del sl, ck
    del r, k, v, w, u, dout, ckpt
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a checkout of an earlier commit")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_bwd_sweep: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {card_line()}", flush=True)
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, csrc in (("this", CSRC), ("parent", None if args.parent
                                              is None else os.path.join(
                                                  args.parent, "src",
                                                  "repro_torch", "csrc"))):
            if csrc is None:
                continue
            os.makedirs(os.path.join(tmp, label))
            lib = build_both(csrc, os.path.join(tmp, label), label)
            if lib is None:
                return 1
            libs[label] = lib
        print(f"sass this rwkv6_bwd_kernel<float>: "
              f"{sass_counts(libs['this'].rwkv_so, 'rwkv6_bwd_kernelIf')}",
              flush=True)
        if args.variants:
            time_variants(os.path.join(tmp, "variants"), libs["this"],
                          args.reps)
        g = torch.Generator(device="cuda").manual_seed(0)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            B, S, D = RG_SHAPE
            x = torch.randn(RG_SHAPE, generator=g, device="cuda").to(dtype)
            a = (0.05 + 0.94 * torch.rand(RG_SHAPE, generator=g,
                                          device="cuda")).to(dtype)
            h, _ = rglru._launch(x, a, None)
            dh = torch.randn(RG_SHAPE, generator=g, device="cuda").to(dtype)
            dlast = torch.randn((B, D), generator=g, device="cuda").to(dtype)
            runs, outs = {}, {}
            for who, lib in libs.items():
                runs[who], outs[who] = rg_runner(lib, dtype, x, a, h, dh,
                                                 dlast)
            compare(f"rglru_bwd {RG_SHAPE} {name}", runs, outs, args.reps)
            del x, a, h, dh, dlast, runs, outs
            torch.cuda.empty_cache()

            B, S, H, Dk, Dv = RWKV_SHAPE
            r, k, w = (torch.randn((B, S, H, Dk), generator=g,
                                   device="cuda") * 0.5 for _ in range(3))
            w = torch.exp(-torch.exp(w - 1.0))      # decays in (0, 1)
            r, k, w = (t.to(dtype) for t in (r, k, w))
            v = (torch.randn((B, S, H, Dv), generator=g, device="cuda")
                 * 0.5).to(dtype)
            u = torch.randn((H, Dk), generator=g, device="cuda") * 0.5
            dout = torch.randn((B, S, H, Dv), generator=g,
                               device="cuda").to(dtype)
            _, _, ckpt = rwkv6._launch(r, k, v, w, u, None, with_ckpt=True)
            runs, outs, nbytes = {}, {}, {}
            for who, lib in libs.items():
                runs[who], outs[who], nbytes[who] = rwkv_runner(
                    lib, dtype, r, k, v, w, u, ckpt, dout)
            compare(f"rwkv6_bwd {RWKV_SHAPE} {name}", runs, outs, args.reps,
                    extra=f"; scratch bytes {nbytes}")
            print(f"profile rwkv6_bwd {name} (this): "
                  f"{launch_split(runs['this'])}", flush=True)
            del r, k, v, w, u, dout, ckpt, runs, outs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
