"""Check and time the flash-attention backward kernel on one NVIDIA GPU.

    python3 tools/fa_bwd_sweep.py [--parent DIR] [--no-checks] [--errors]
                                  [--variants] [--mla-variants] [--apart]

Builds the kernel library (`src/repro_torch/csrc/*.cu`) and prints, for
each backward kernel (`bwd_kernel`'s instantiations and the bf16 (192,
128) body `mla_bwd_kernel`), its registers and spills, ptxas's notes on
it (C75xx: wgmma serialized, and why), and from its SASS (`cuobjdump
-sass`) the HGMMA (`wgmma`) instructions, those that close a group, and
the warpgroup arrives and waits.  Then it holds the backward, through
`flash_attention`'s autograd Function, against the plain version's
autograd in float64 on every head dim (MLA's (192, 128) pair among them)
in both dtypes over layouts that stress its tiles (5e-5 float32, 2e-2
bf16, of max(1, max|g|)), each case twice, bit-identical (skipped with
`--no-checks`), and times it with CUDA events at the training paths'
attention shapes (path A: q, dout [4,2048,15,64], k/v [4,2048,5,64],
causal; path B: [1,3072,16,256] on one kv head, causal, window 2048;
MLA: deepseek-v3's q/k [2,2048,128,192], v 128, causal), float32 and
bfloat16, with each launch's device time from `torch.profiler` (path A
and B in float32, MLA in both).  With `--parent DIR`, a checkout of an
earlier commit (for example unpacked from `git archive`), that
checkout's `flash_attention_bwd.cu` is built beside it and timed at the
same shapes in both dtypes in turns (parent, this, this, parent).
Each time comes with SDPA's backward on the same inputs, in turns.
`--errors` prints dq, dk and dv's errors against float64 at path A's and
B's shapes for this kernel, the parent's and the plain version in
float32.  `--variants` builds copies of this source with other tile
shapes for one instantiation each (`VARIANTS`: owned rows kNo, consumer
warpgroups kWG, P/dS tiles kStoreTiles, ring stages kStages, k-steps a
fence kChunk, of `BwdCfg`), holds each to the library's gradient at path
A (head_dim 64), B (256) or MLA's (192, float32) (1e-4 of max(1,
max|g|) in float32, 2e-2 in bf16) and times it there in turns with the
library; then, as `--mla-variants` alone does, the bf16 (192, 128)
body's (`MLA_VARIANTS` of `MlaCfg`) at MLA's shape.  `--apart` times
copies of the (192, 128) bodies and of float32 (256, 256)'s that each
leave one cost out (`APART`: in float32 the band's streaming, the split
of the streamed tiles, the dQ launch; in bf16 the exp, the streaming, the
mask's element tests, the dK/dQ products) at MLA's shape, and the
float32 ones also at path B's, in turns with the library, never
checked: their gradients are wrong by design.  Every check runs even
after one fails; the exit code is 1 if any failed.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from kernel_sweep import (build, card_line, cuda_ms, entry,  # noqa: E402
                          sass_counts)

from repro_torch.core.cuda import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}
# (B, Sq, Sk, Hq, Hkv, causal, window, softcap, q_offset): groups of 1, 3
# and 16, lengths that are not a multiple of a tile, Sk shorter than a
# tile, a window smaller than a tile, softcap with a static offset
EDGES = [
    (2, 77, 77, 2, 2, True, None, None, 0),
    (1, 150, 150, 15, 5, True, None, None, 0),
    (1, 100, 100, 16, 1, True, 7, None, 0),
    (2, 20, 9, 3, 1, False, None, None, 0),
    (1, 70, 130, 4, 2, True, 48, 30.0, 60),
    (1, 127, 127, 4, 2, True, None, None, 0),
    (1, 129, 200, 2, 2, False, None, None, 0),
    (1, 200, 200, 8, 2, True, 64, None, 0),
]
# (B, S, Hq, Hkv, D, window): the training paths' attention layers
PATH_A = (4, 2048, 15, 5, 64, None)
PATH_B = (1, 3072, 16, 1, 256, 2048)
PATH_MLA = (2, 2048, 128, 128, (192, 128), None)
# each variant's head dim -> the shape it is timed at
VARIANT_SHAPES = {64: PATH_A, 256: PATH_B, 192: PATH_MLA}
# (dtype, head_dim, kNo, kWG, kStoreTiles, kStages, kChunk[, kParts]):
# other tile shapes of one instantiation (head_dim: the wider of Dqk and
# Dv), timed at VARIANT_SHAPES[head_dim].  At float32 (256, 256), whose
# streamed tiles come by column parts: quarters (a ring of four), 16 owned
# rows (one warpgroup with four half stages, or two warpgroups), 2 k-steps
# a chunk.
VARIANTS = [("float32", 64, 48, 2, 1, 4, 1), ("float32", 64, 48, 2, 1, 4, 4),
            ("float32", 64, 64, 1, 2, 4, 4), ("bfloat16", 64, 64, 2, 2, 4, 2),
            ("float32", 192, 32, 1, 2, 2, 2), ("float32", 192, 32, 1, 2, 2, 8),
            ("float32", 256, 32, 1, 1, 4, 1, 4),
            ("float32", 256, 16, 1, 1, 4, 1, 2),
            ("float32", 256, 16, 2, 1, 2, 1, 2),
            ("float32", 256, 32, 1, 1, 2, 2, 2)]
TUNABLES = ("kNo", "kWG", "kStoreTiles", "kStages", "kChunk", "kParts")
# bf16 (192, 128), flash_attention_bwd_mla.cuh's `MlaCfg`: (streamed rows
# kBs, ring stages kStages and tiles read ahead kAhead of the dK/dV launch,
# the same of the dQ launch), timed at PATH_MLA
MLA_VARIANTS = [(32, 4, 3, 64, 3, 2), (32, 6, 4, 64, 3, 1),
                (32, 5, 3, 64, 2, 1)]
MLA_TUNABLES = ("kBs dK/dV", "kStages dK/dV", "kAhead dK/dV", "kBs dQ",
                "kStages dQ", "kAhead dQ")
# timing-only copies of the (192, 128) and float32 (256, 256) bodies,
# whose gradients are wrong by design and never checked: name -> (dtype,
# (old, new) replacements in the inlined source).  float32 (`bwd_kernel`,
# at Dqk >= 192): one_tile streams the band's first tile over and over
# (L2-hot: no band to fetch); no_copy fills each stage once and then only
# completes its barrier (no streaming at all); no_split takes a streamed
# element as its TF32 hi with a zero lo (no split's arithmetic; the
# products stay three); dkdv_only skips the dQ launch (at (256, 256) the
# side stream is still forked and joined).  bf16 (`mla_bwd_kernel`): without the exp, without streaming
# (each stage filled once), without the mask's element tests, without the
# dK/dQ products.
APART = {
    "one_tile": ("float32", [
        ("const int64_t i0 = (t_begin + n % n_band) * kRows;",
         "const int64_t i0 = (t_begin + (DQ >= 192 ? 0 : n % n_band)) * "
         "kRows;")]),
    "no_copy": ("float32", [
        (f"{sp}if (lane == 0) {{\n"
         f"{sp}    mbar_expect_tx(full(s), bytes);",
         f"{sp}if (DQ >= 192 && slot >= C::kStages) {{\n"
         f"{sp}    if (lane == 0) {{\n"
         f"{sp}        mbar_arrive(full(s));\n"
         f"{sp}    }}\n"
         f"{sp}    continue;\n"
         f"{sp}}}\n"
         f"{sp}if (lane == 0) {{\n"
         f"{sp}    mbar_expect_tx(full(s), bytes);")
        for sp in (" " * 16, " " * 20)]),
    "no_split": ("float32", [
        ("struct Frag<float, W, LD> {",
         "struct Frag<float, W, LD> {\n"
         "    __device__ __forceinline__ static void split("
         "float x, uint32_t& hi, uint32_t& lo) {\n"
         "        hi = __float_as_uint(x);\n"
         "        lo = 0u;\n"
         "    }")]),
    "dkdv_only": ("float32", [
        ("    bwd_kernel<T, DQ, DV, true><<<qgrid, C::kThreads, C::kBytes, "
         "stream>>>(",
         "    if (DQ < 192) bwd_kernel<T, DQ, DV, true><<<qgrid, C::kThreads,"
         " C::kBytes, stream>>>(")]),
    "mla_no_exp": ("bfloat16", [("float p = ex2_approx(x2 - L2(j, e));",
                                 "float p = x2 - L2(j, e);")]),
    "mla_no_copy": ("bfloat16", [
        ("        mla_copy<DQ, kBs, C::kThreads>(",
         "        if (m < C::kStages) mla_copy<DQ, kBs, C::kThreads>("),
        ("        mla_copy<DV, kBs, C::kThreads>(",
         "        if (m < C::kStages) mla_copy<DV, kBs, C::kThreads>(")]),
    "mla_no_mask": ("bfloat16", [("        const bool inside =\n",
                                  "        const bool inside = true ||\n")]),
    "mla_no_dkdq": ("bfloat16", [("WgmmaRT<DQ>::mma(",
                                  "if (false) WgmmaRT<DQ>::mma(")]),
}
V = ctypes.c_void_p
I32, I64, F32 = ctypes.c_int, ctypes.c_int64, ctypes.c_float


def _dims(D) -> tuple[int, int]:
    """(Dqk, Dv) of a head dim: an int, or MLA's pair."""
    return D if isinstance(D, tuple) else (D, D)


def _inputs(B, Sq, Sk, Hq, Hkv, D, dtype, seed=0):
    """q, k, v and dout; D is a head dim or a (Dqk, Dv) pair."""
    Dqk, Dv = _dims(D)
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=g, device="cuda").to(dtype)
            for s in ((B, Sq, Hq, Dqk), (B, Sk, Hkv, Dqk), (B, Sk, Hkv, Dv),
                      (B, Sq, Hq, Dv))]


def _err(got, want) -> float:
    want = want.double()
    return float((got.double() - want).abs().max()) / max(
        1.0, float(want.abs().max()))


def check_case(B, Sq, Sk, Hq, Hkv, D, dtype, causal, window, cap,
               q_offset) -> float:
    q, k, v, dout = _inputs(B, Sq, Sk, Hq, Hkv, D, dtype,
                            seed=_dims(D)[0] + Sq)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset)
    runs = []
    for _ in range(2):
        qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
        fa.flash_attention(*qkv, **kw).backward(dout)
        runs.append([x.grad for x in qkv])
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    want = fa.flash_attention_bwd_plain(q.double(), k.double(), v.double(),
                                        dout.double(), **kw)
    err = max(_err(g, w) for g, w in zip(runs[0], want))
    if not same:
        return float("inf")
    return err


def inlined(csrc: str) -> str:
    """`flash_attention_bwd.cu` of a source directory with its headers
    inlined, so that a copy builds anywhere."""
    with open(os.path.join(csrc, "flash_attention_bwd.cu")) as f:
        text = f.read()
    done = set()
    while True:
        m = re.search(r'#include "(\w+\.cuh)"', text)
        if not m:
            return text
        name = m.group(1)
        body = ""
        if name not in done:     # each header once, where first included
            done.add(name)
            with open(os.path.join(csrc, name)) as f:
                body = f.read()
        text = text[:m.start()] + body + text[m.end():]


def variant(text: str, key) -> str:
    """`text` with each tunable of `BwdCfg` set as `key` says for its
    dtype and head dim, and left as it is elsewhere."""
    dt, dim, *values = key
    cond = f"(kF32 == {str(dt == 'float32').lower()} && D == {dim})"
    at = text.index("struct BwdCfg {")
    end = text.index("};", at)
    cfg = text[at:end]
    for name, value in zip(TUNABLES, values):
        m = re.search(rf"static constexpr int {name} =\s*(.+?);", cfg,
                      re.S)
        cfg = cfg.replace(m.group(0), f"static constexpr int {name} = "
                          f"{cond} ? {value} : ({m.group(1)});")
    return text[:at] + cfg + text[end:]


def parent_entry(parent: str, tmp: str):
    """The parent checkout's backward, built alone with its headers
    inlined: ({dtype: C function taking this source's arguments, Dqk and
    Dv included}, whether it takes the dk_h/dv_h scratch)."""
    text = inlined(os.path.join(parent, "src", "repro_torch", "csrc"))
    built = build(tmp, {"parent": text}, label=str)
    if "parent" not in built:
        return None, False
    scratch = "dk_h" in text
    n_ptr = 12 if scratch else 10
    # before (Dqk, Dv) the entry took one head dim
    two = re.search(r"flash_attention_bwd_f32\([^)]*int64_t Dv", text) \
        is not None
    fns = {}
    for dtype, name in ((torch.float32, "flash_attention_bwd_f32"),
                        (torch.bfloat16, "flash_attention_bwd_bf16")):
        fn = entry(built["parent"][0], name,
                   [V] * n_ptr + [I64] * (7 if two else 6) +
                   [I32, I32, I64, I32, F32, F32, I64, V])
        at = n_ptr + 6      # where Dv sits among this source's arguments
        fns[dtype] = fn if two else (
            lambda *a, fn=fn: fn(*a[:at], *a[at + 1:]))
    return fns, scratch


def sdpa_bwd(shape, q, k, v, dout):
    """One PyTorch call for the same gradient: the backward of
    `scaled_dot_product_attention` (explicit mask with a window,
    `is_causal` without), timed only."""
    F = torch.nn.functional
    B, S, Hq, Hkv, D, window = shape
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    kw = {"scale": _dims(D)[0] ** -0.5, "enable_gqa": Hq != Hkv}
    if window is not None:
        pos = torch.arange(S, device="cuda")
        kw["attn_mask"] = ((pos[None, :] <= pos[:, None])
                           & (pos[None, :] > pos[:, None] - window))
    else:
        kw["is_causal"] = True
    ot = F.scaled_dot_product_attention(qt, kt, vt, **kw)
    dt = dout.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(ot, (qt, kt, vt), dt,
                                       retain_graph=True)


def timed(shape, dtype, parent_fns, parent_scratch) -> dict:
    """This backward at `shape`, SDPA's backward and the parent's in
    turns (parent, this, sdpa, sdpa, this, parent; without a parent this,
    sdpa, sdpa, this), with the largest scaled difference of this and
    the parent's gradients."""
    B, S, Hq, Hkv, D, window = shape
    Dqk, Dv = _dims(D)
    q, k, v, dout = _inputs(B, S, S, Hq, Hkv, D, dtype)
    scale = Dqk ** -0.5
    out, lse = fa._launch(q, k, v, True, window, None, scale, 0,
                          with_lse=True)
    this = lambda: fa._launch_bwd(q, k, v, out, dout, lse, True, window,  # noqa
                                  None, scale, 0)
    res = {}
    parent_fn = (parent_fns or {}).get(dtype)
    if parent_fn is not None:
        f32 = dict(dtype=torch.float32, device="cuda")
        delta = torch.empty((B, Hq, S), **f32)
        extra = ([torch.empty((B, S, Hq, Dqk), **f32) for _ in range(2)]
                 if parent_scratch else [])
        grads = [torch.empty_like(x) for x in (q, k, v)]
        ptrs = [x.data_ptr() for x in [q, k, v, out, dout, lse, delta,
                                       *extra, *grads]]
        stream = torch.cuda.current_stream().cuda_stream

        def parent():
            rc = parent_fn(*ptrs, B, S, S, Hq, Hkv, Dqk, Dv, 1,
                           int(window is not None), window or 0, 0, 0.0,
                           scale, 0, stream)
            assert rc == 0, rc
        parent()
        torch.cuda.synchronize()
        mine = this()
        torch.cuda.synchronize()
        res["parent_vs_this"] = max(_err(a, b) for a, b in zip(grads, mine))
        res["same_bits_as_parent"] = all(
            torch.equal(a, b) for a, b in zip(grads, mine))
    calls = {"this": this, "sdpa": sdpa_bwd(shape, q, k, v, dout)}
    order = ("this", "sdpa", "sdpa", "this")
    if parent_fn is not None:
        calls["parent"] = parent
        order = ("parent",) + order + ("parent",)
    ms = {who: [] for who in calls}
    for who in order:
        ms[who].append(cuda_ms(calls[who], 10))
    res["ms"] = ms["this"]
    res["sdpa_ms"] = ms["sdpa"]
    if parent_fn is not None:
        res["parent_ms"] = ms["parent"]
    return res


def time_variants(tmp: str) -> None:
    """Each variant of VARIANTS held to the library and timed beside it at
    its path's shape, in turns."""
    text = inlined(os.path.join(HERE, "..", "src", "repro_torch", "csrc"))
    built = build(tmp, {key: variant(text, key) for key in VARIANTS},
                  label=str)
    for dt, dim in sorted({key[:2] for key in built}):
        B, S, Hq, Hkv, D, window = VARIANT_SHAPES[dim]
        Dqk, Dv = _dims(D)
        dtype = getattr(torch, dt)
        q, k, v, dout = _inputs(B, S, S, Hq, Hkv, D, dtype)
        scale = Dqk ** -0.5
        out, lse = fa._launch(q, k, v, True, window, None, scale, 0,
                              with_lse=True)
        want = fa._launch_bwd(q, k, v, out, dout, lse, True, window, None,
                              scale, 0)
        stream = torch.cuda.current_stream().cuda_stream
        delta = torch.empty((B, Hq, S), dtype=torch.float32, device="cuda")
        runs = {"library": lambda: fa._launch_bwd(
            q, k, v, out, dout, lse, True, window, None, scale, 0)}
        for key, (so, log) in built.items():
            if key[:2] != (dt, dim):
                continue
            tag = "fLi" if dt == "float32" else "13__nv_bfloat16Li"
            lines = log.splitlines()
            regs = [re.search(r"(\d+) bytes spill stores.*Used (\d+) "
                              r"registers", " ".join(lines[i + 1:i + 4]))
                    for i, line in enumerate(lines)
                    if "Compiling entry function" in line
                    and f"bwd_kernelI{tag}{dim}E" in line]
            serial = sum("C751" in line and f"{tag}{dim}E" in line
                         for line in lines)
            name = "flash_attention_bwd_" + ("f32" if dt == "float32"
                                             else "bf16")
            fn = entry(so, name, [V] * 10 + [I64] * 7 + [
                I32, I32, I64, I32, F32, F32, I64, V])
            grads = [torch.empty_like(x) for x in (q, k, v)]
            ptrs = [x.data_ptr() for x in (q, k, v, out, dout, lse, delta,
                                           *grads)]

            def run(fn=fn, ptrs=ptrs):
                return fn(*ptrs, B, S, S, Hq, Hkv, Dqk, Dv, 1,
                          int(window is not None), window or 0, 0, 0.0,
                          scale, 0, stream)
            label = str(dict(zip(TUNABLES, key[2:])))
            rc = run()
            torch.cuda.synchronize()
            if rc != 0:
                rc2 = run()
                torch.cuda.synchronize()
                print(f"variant {dt} D={dim} {label}: launch failed, CUDA "
                      f"error {rc} (again: {rc2})", flush=True)
                continue
            err = max(_err(a, b) for a, b in zip(grads, want))
            print(f"variant {dt} D={dim} {label}: registers "
                  f"{[r.group(2) if r else '?' for r in regs]}, spill "
                  f"stores {[r.group(1) if r else '?' for r in regs]} "
                  f"bytes, "
                  f"serialization notes {serial}, against the library "
                  f"{err!r}", flush=True)
            if err <= (1e-4 if dt == "float32" else 2e-2):
                runs[label] = run
        order = list(runs) + list(runs)[::-1]
        ms = {name: [] for name in runs}
        for name in order:
            ms[name].append(cuda_ms(runs[name], 10))
        for name, t in ms.items():
            print(f"time {dt} D={dim} {name}: {t} ms", flush=True)
        del q, k, v, dout, out, lse, want
        torch.cuda.empty_cache()


def mla_variant(text: str, key) -> str:
    """`text` with `MlaCfg`'s tunables set as `key` (MLA_TUNABLES) says."""
    kbs_kv, st_kv, ahead_kv, kbs_q, st_q, ahead_q = key
    at = text.index("struct MlaCfg {")
    end = text.index("};", at)
    cfg = text[at:end]
    for name, value in (("kBs", f"kDQ ? {kbs_q} : {kbs_kv}"),
                        ("kStages", f"kDQ ? {st_q} : {st_kv}"),
                        ("kAhead", f"kDQ ? {ahead_q} : {ahead_kv}")):
        cfg = re.sub(rf"static constexpr int {name} = [^;]+;",
                     f"static constexpr int {name} = {value};", cfg)
    return text[:at] + cfg + text[end:]


def _ptxas_lines(log: str, part: str) -> list:
    """(registers, spill bytes) of each kernel whose mangled name holds
    `part`, from `-Xptxas -v`."""
    lines = log.splitlines()
    found = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and part in line:
            rest = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", rest)
            spill = re.search(r"(\d+) bytes spill stores", rest)
            found.append((regs.group(1) if regs else "?",
                          spill.group(1) if spill else "?"))
    return found


def _mla_path(dtype, shape=PATH_MLA):
    """Inputs, forward and a library backward call at `shape`."""
    B, S, Hq, Hkv, D, window = shape
    Dqk, Dv = _dims(D)
    q, k, v, dout = _inputs(B, S, S, Hq, Hkv, D, dtype)
    scale = Dqk ** -0.5
    out, lse = fa._launch(q, k, v, True, window, None, scale, 0,
                          with_lse=True)
    delta = torch.empty((B, Hq, S), dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run_entry(fn, grads):
        return fn(*[x.data_ptr() for x in (q, k, v, out, dout, lse, delta,
                                           *grads)],
                  B, S, S, Hq, Hkv, Dqk, Dv, 1, int(window is not None),
                  window or 0, 0, 0.0, scale, 0, stream)
    library = lambda: fa._launch_bwd(q, k, v, out, dout, lse, True,  # noqa
                                     window, None, scale, 0)
    return (q, k, v), library, run_entry


def _in_turns(runs: dict, label: str) -> None:
    order = list(runs) + list(runs)[::-1]
    ms = {name: [] for name in runs}
    for name in order:
        ms[name].append(cuda_ms(runs[name], 10))
    for name, t in ms.items():
        print(f"time {label} {name}: {t} ms", flush=True)


def time_apart(tmp: str) -> None:
    """Each APART copy timed at PATH_MLA in its dtype, and the float32
    ones at PATH_B, in turns with the library (never checked: wrong by
    design), with the registers, spills and HGMMA counts of the kernels it
    changes."""
    text = inlined(os.path.join(HERE, "..", "src", "repro_torch", "csrc"))
    sources = {}
    for name, (_, edits) in APART.items():
        t = text
        for old, new in edits:
            assert old in t, (name, old)
            t = t.replace(old, new)
        sources[name] = t
    built = build(tmp, sources, label=str)
    for dt, label, shape in (("float32", "PATH_MLA", PATH_MLA),
                             ("bfloat16", "PATH_MLA", PATH_MLA),
                             ("float32", "PATH_B", PATH_B)):
        dtype = getattr(torch, dt)
        qkv, library, run_entry = _mla_path(dtype, shape)
        dims = _dims(shape[4])
        part = f"bwd_kernelIfLi{dims[0]}ELi{dims[1]}E" if dt == "float32" \
            else "mla_bwd_kernel"
        runs = {"library": library}
        for name, (so, log) in built.items():
            if APART[name][0] != dt:
                continue
            fn = entry(so, "flash_attention_bwd_" + (
                "f32" if dt == "float32" else "bf16"), [V] * 10 + [I64] * 7
                + [I32, I32, I64, I32, F32, F32, I64, V])
            grads = [torch.empty_like(x) for x in qkv]
            rc = run_entry(fn, grads)
            torch.cuda.synchronize()
            tag = f"fLi{dims[0]}" if dt == "float32" else "mla"
            print(f"apart {name}: {dims} {dt} (dQ, dK/dV) registers "
                  f"and spill bytes {_ptxas_lines(log, part)}; "
                  f"{wgmma_counts(so, tag)}; launch rc {rc}", flush=True)
            if rc == 0:
                runs[name] = lambda fn=fn, grads=grads: run_entry(fn, grads)
        _in_turns(runs, f"apart {dt} {label}")
        del qkv
        torch.cuda.empty_cache()


def time_mla_variants(tmp: str) -> None:
    """Each MLA_VARIANTS copy of the bf16 (192, 128) body held to the
    library's gradient (2e-2 of max(1, max|g|)) and timed beside it at
    PATH_MLA in turns."""
    text = inlined(os.path.join(HERE, "..", "src", "repro_torch", "csrc"))
    built = build(tmp, {key: mla_variant(text, key)
                        for key in MLA_VARIANTS}, label=str)
    qkv, library, run_entry = _mla_path(torch.bfloat16)
    want = library()
    runs = {"library": library}
    for key, (so, log) in built.items():
        fn = entry(so, "flash_attention_bwd_bf16", [V] * 10 + [I64] * 7 + [
            I32, I32, I64, I32, F32, F32, I64, V])
        grads = [torch.empty_like(x) for x in qkv]
        rc = run_entry(fn, grads)
        torch.cuda.synchronize()
        label = str(dict(zip(MLA_TUNABLES, key)))
        err = (max(_err(a, b) for a, b in zip(grads, want)) if rc == 0
               else float("nan"))
        notes = sum("C75" in line and "mla_bwd" in line
                    for line in log.splitlines())
        print(f"mla variant {label}: registers and spill bytes (dQ, "
              f"dK/dV) {_ptxas_lines(log, 'mla_bwd_kernel')}, ptxas notes "
              f"{notes}; {wgmma_counts(so, 'mla')}; launch rc {rc}; "
              f"against the library {err!r}", flush=True)
        if rc == 0 and err <= 2e-2:
            runs[label] = lambda fn=fn, grads=grads: run_entry(fn, grads)
    _in_turns(runs, "mla bfloat16 PATH_MLA")
    torch.cuda.empty_cache()


def wgmma_counts(so: str, part: str = "") -> str:
    """For each backward kernel: its HGMMA (wgmma) instructions, those that
    close a group (`gsb0`), and the warpgroup arrives and waits
    (`WARPGROUP.ARRIVE`, `WARPGROUP.DEPBAR`) in its SASS."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        return "cuobjdump not found"
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, timeout=120).stdout
    out = []
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.split("\n", 1)[0].strip()
        m = re.search(r"bwd_kernelI(\w+?)EEv", name)
        if not m or part not in name:
            continue
        out.append(f"{m.group(1)}: HGMMA {func.count('HGMMA')}, gsb0 "
                   f"{len(re.findall(r'HGMMA[^;]*gsb0', func))}, ARRIVE "
                   f"{func.count('WARPGROUP.ARRIVE')}, DEPBAR "
                   f"{func.count('WARPGROUP.DEPBAR')}")
    return "; ".join(out)


def profile_split(shape, dtype) -> str:
    """Device time of each kernel of one backward call (torch.profiler,
    mean of 5 calls)."""
    from torch.profiler import ProfilerActivity, profile
    B, S, Hq, Hkv, D, window = shape
    q, k, v, dout = _inputs(B, S, S, Hq, Hkv, D, dtype)
    scale = _dims(D)[0] ** -0.5
    out, lse = fa._launch(q, k, v, True, window, None, scale, 0,
                          with_lse=True)
    fa._launch_bwd(q, k, v, out, dout, lse, True, window, None, scale, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fa._launch_bwd(q, k, v, out, dout, lse, True, window, None,
                           scale, 0)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append(f"{ev.key[:70]} {us / 5e3:.4f} ms")
    return "; ".join(rows)


def errors(shape, parent_fn, scratch) -> None:
    """dq, dk, dv of this kernel (and the parent's) against the plain
    version's float64 autograd at `shape`, each scaled by max(1,
    max|g|)."""
    B, S, Hq, Hkv, D, window = shape
    q, k, v, dout = _inputs(B, S, S, Hq, Hkv, D, torch.float32)
    scale = D ** -0.5
    out, lse = fa._launch(q, k, v, True, window, None, scale, 0,
                          with_lse=True)
    mine = fa._launch_bwd(q, k, v, out, dout, lse, True, window, None,
                          scale, 0)
    want = fa.flash_attention_bwd_plain(q.double(), k.double(), v.double(),
                                        dout.double(), causal=True,
                                        window=window)
    plain32 = fa.flash_attention_bwd_plain(q, k, v, dout, causal=True,
                                           window=window)
    res = {"this": [_err(a, b) for a, b in zip(mine, want)],
           "plain float32": [_err(a, b) for a, b in zip(plain32, want)]}
    if parent_fn is not None:
        f32 = dict(dtype=torch.float32, device="cuda")
        delta = torch.empty((B, Hq, S), **f32)
        extra = ([torch.empty((B, S, Hq, D), **f32) for _ in range(2)]
                 if scratch else [])
        grads = [torch.empty_like(x) for x in (q, k, v)]
        rc = parent_fn(*[x.data_ptr() for x in (q, k, v, out, dout, lse,
                                                delta, *extra, *grads)],
                       B, S, S, Hq, Hkv, D, D, 1, int(window is not None),
                       window or 0, 0, 0.0, scale, 0,
                       torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        res["parent"] = [_err(a, b) for a, b in zip(grads, want)] + [rc]
    print(f"errors {shape} float32 (dq, dk, dv) against float64: {res}",
          flush=True)
    del q, k, v, dout, out, lse, mine, want, plain32
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a checkout of an earlier commit")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--no-checks", action="store_true")
    ap.add_argument("--errors", action="store_true")
    ap.add_argument("--apart", action="store_true")
    ap.add_argument("--mla-variants", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fa_bwd_sweep: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {card_line()}", flush=True)
    so, log = _build.build_library()
    notes = {}
    for line in log.splitlines():
        code = re.search(r"\((C7\d+)\)", line)
        name = re.search(r"bwd_kernelI(\w+?)EEv", line)
        if code and name:
            key = (name.group(1), code.group(1))
            notes[key] = notes.get(key, 0) + 1
    for (name, code), count in sorted(notes.items()):
        print(f"ptxas note {code} x{count} in {name}", flush=True)
    for code in sorted({code for _, code in notes}):
        text = next(line for line in log.splitlines() if f"({code})" in line)
        print(f"ptxas {code}: {text.split(' for the function')[0][-200:]}",
              flush=True)
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "bwd_kernel" in line:
            rest = " ".join(p.strip() for p in lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", rest)
            spill = re.search(r"(\d+) bytes spill stores", rest)
            name = re.search(r"bwd_kernelI(\w+?)EEv", line)
            print(f"ptxas {name.group(1) if name else line[-60:]}: "
                  f"{regs.group(1) if regs else '?'} registers, "
                  f"{spill.group(1) if spill else '?'} bytes spill stores",
                  flush=True)
    print("sass:", sass_counts(so, "bwd_kernelIfLi64E"), flush=True)
    print("sass wgmma:", wgmma_counts(so), flush=True)

    failed = 0
    for D in ([] if args.no_checks else fa.HEAD_DIMS + ((192, 128),)):
        for dtype in (torch.float32, torch.bfloat16):
            for B, Sq, Sk, Hq, Hkv, causal, window, cap, off in EDGES:
                case = (B, Sq, Sk, Hq, Hkv, D, str(dtype)[6:], causal,
                        window, cap, off)
                try:
                    err = check_case(B, Sq, Sk, Hq, Hkv, D, dtype, causal,
                                     window, cap, off)
                except Exception as exc:       # noqa: BLE001
                    print(f"check {case}: raised {exc!r}", flush=True)
                    return 1
                ok = err <= TOL[dtype]
                failed += not ok
                print(f"check {case}: scaled error {err!r} "
                      f"{'ok' if ok else 'FAILED'}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "parent"))
        os.makedirs(os.path.join(tmp, "variants"))
        os.makedirs(os.path.join(tmp, "apart"))
        parent_fns, scratch = (
            parent_entry(args.parent, os.path.join(tmp, "parent"))
            if args.parent else (None, False))
        if args.errors:
            for shape in (PATH_A, (1, 2304, 16, 1, 256, 2048), PATH_B):
                errors(shape, (parent_fns or {}).get(torch.float32),
                       scratch)
        if args.variants:
            time_variants(os.path.join(tmp, "variants"))
        if args.variants or args.mla_variants:
            time_mla_variants(os.path.join(tmp, "variants"))
        if args.apart:
            time_apart(os.path.join(tmp, "apart"))
        return _timing(parent_fns, scratch, failed)


def _timing(parent_fns, scratch, failed) -> int:
    for label, shape in (("A", PATH_A), ("B", PATH_B), ("MLA", PATH_MLA)):
        for dtype in (torch.float32, torch.bfloat16):
            if label == "MLA" or dtype == torch.float32:
                print(f"profile path {label} {str(dtype)[6:]}: "
                      f"{profile_split(shape, dtype)}", flush=True)
            res = timed(shape, dtype, parent_fns, scratch)
            print(f"time path {label} {shape} {str(dtype)[6:]}: "
                  f"{ {k: v for k, v in res.items()} }", flush=True)
            torch.cuda.empty_cache()
    return int(failed > 0)


if __name__ == "__main__":
    sys.exit(main())
