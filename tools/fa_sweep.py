"""Check and time the flash-attention forward kernel on one NVIDIA GPU.

    python3 tools/fa_sweep.py [--parent DIR] [--variants] [--apart]
                              [--no-shapes]

Builds `src/repro_torch/csrc/flash_attention.cu` with its headers inlined
and prints, for each instantiation of the forward (`fa_fwd_kernel<T, Dqk,
Dv>`, and a parent's `fa_mma_kernel`, the mma.sync body), its
registers and spills (`-Xptxas -v`) and its SASS counts of
`wgmma` (HGMMA) and `mma.sync` (HMMA) instructions (`cuobjdump -sass`,
where the toolkit has it).  Then at every shape of `chip_smoke.py`'s
kernels line (`SHAPES`: recurrentgemma-9b's serving layer, dbrx-132b's,
deepseek-v3's MLA (192, 128), seamless's encoder, training path A's and
seamless's decode cross attention), in float32 and bfloat16, it holds
the kernel against the plain version (2e-5 float32, 2e-2 bf16), checks
that two calls give the same bits and that the log-sum-exp leaves `out`
as it is, and times it with CUDA events beside
`scaled_dot_product_attention` on the same inputs.

With `--parent DIR`, a checkout of an earlier commit (for example
unpacked from `git archive`), that checkout's `flash_attention.cu` is
built alone beside it (with its own headers), checked the same way at
every shape and dtype, and timed in turns (parent, this, this, parent);
whether the two outputs are the same bits is printed.  `--variants`
builds copies of this source with another tile shape (`VARIANTS`: a
`REPRO_FA_TUNE` line's warpgroups, keys a tile, stages and body; at
recurrentgemma's float32 (256, 256) the bodies tried there) and holds
and times each at its shape in turns with the source's own.
`--apart` times copies that each leave one cost out (`APART`, never
checked: their outputs are wrong by design) at `APART_SHAPES`.
`--no-shapes` skips the checks and times at `SHAPES`.  Every check runs
even after one fails; the exit code is 1 if any failed.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from kernel_sweep import (_build, build, card_line, cuda_ms,  # noqa: E402
                          entry)

sys.path.insert(0, os.path.join(HERE, "..", "src"))
from repro_torch.core._native import build_root  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

CSRC = os.path.join(HERE, "..", "src", "repro_torch", "csrc")
# name: (B, Sq, Sk, Hq, Hkv, (Dqk, Dv), causal, window)
SHAPES = {
    "recurrentgemma": (2, 3072, 3072, 16, 1, (256, 256), True, 2048),
    "dbrx": (2, 2048, 2048, 48, 8, (128, 128), True, None),
    "mla": (2, 2048, 2048, 128, 128, (192, 128), True, None),
    "seamless": (2, 2048, 2048, 16, 16, (64, 64), False, None),
    "path_a": (4, 2048, 2048, 15, 5, (64, 64), True, None),
    "decode": (4, 1, 1000, 16, 16, (64, 64), False, None),
}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# (shape, dtype, warpgroups, keys a tile, stages[, halves]): a
# REPRO_FA_TUNE line of the shape's instantiation set to these (halves 1:
# float32 (256, 256)'s tiles streamed by column halves, 0: whole).  At
# recurrentgemma's float32 (256, 256): one warpgroup by halves, and whole
# tiles (one warpgroup, 16 keys); the earlier mma.sync body is timed as a
# parent's (`--parent`).
VARIANTS = [
    ("recurrentgemma", torch.float32, 1, 32, 2, 1),
    ("recurrentgemma", torch.float32, 1, 16, 2, 0),
    ("mla", torch.float32, 2, 16, 3), ("mla", torch.float32, 1, 32, 2),
    ("dbrx", torch.float32, 2, 32, 3), ("dbrx", torch.float32, 2, 16, 2),
    ("path_a", torch.float32, 2, 32, 2), ("path_a", torch.float32, 2, 64, 3),
    ("recurrentgemma", torch.bfloat16, 2, 32, 3),
    ("dbrx", torch.bfloat16, 2, 64, 3), ("dbrx", torch.bfloat16, 2, 128, 3),
    ("mla", torch.bfloat16, 2, 64, 3), ("mla", torch.bfloat16, 2, 64, 4),
    ("path_a", torch.bfloat16, 2, 128, 3),
    ("path_a", torch.bfloat16, 2, 64, 4),
]
# timing-only copies that each leave one cost out (their outputs are
# wrong by design, never checked), timed at APART_SHAPES in turns with the
# source's own: the ring's refills, the tile's first barrier, the S and
# P.V products, the exponentials, float32's split of K and V
APART = {
    "no_fill": [("fill(i + kStages - 1);", "(void)0;"),
                ("fill(i + kStages);", "(void)0;"),
                ("            if (m < n_tiles) {\n                if (y == 0) {",
                 "            if (m < 1) {\n                if (y == 0) {")],
    "no_qk": [("product<float, kNk, kDq / 8, C::kChunk>(",
               "if (false) product<float, kNk, kDq / 8, C::kChunk>("),
              ("product<float, kNk, 2 * kHs, kC>(",
               "if (false) product<float, kNk, 2 * kHs, kC>("),
              ("WgmmaSS<kNk>::mma(s, sw128_step",
               "if (false) WgmmaSS<kNk>::mma(s, sw128_step")],
    "no_pv": [(f"Wgmma<float, kPn>::mma(o[c], {a}, {b}, 1);",
               f"if (false) Wgmma<float, kPn>::mma(o[c], {a}, {b}, 1);")
              for a, b in (("ph[j]", "dh"), ("ph[j]", "dl"), ("pl[j]", "dh"))]
    + [("WgmmaRT<kPn>::mma(", "if (false) WgmmaRT<kPn>::mma(")],
    "no_exp": [("C::kF32 ? expf(x) : ex2_approx(x * kLog2e)", "x")],
    "no_split": [("it < C::kKBytes / 16 / C::kThreads;", "it < 0;"),
                 ("it < kNk / 8 * 2 * DV / C::kThreads;", "it < 0;"),
                 ("for (int it = 0; it < kPer; ++it) {",
                  "for (int it = 0; it < 0; ++it) {")],
    "no_scale": [("float val = s[4 * j + e] * scale;",
                  "float val = s[4 * j + e]; continue;")],
    "no_softmax": [("r < 2; ++r) {\n                float mx",
                    "r < 0; ++r) {\n                float mx")],
    "no_rescale": [("o[c][4 * j + 2 * r] *= alpha;", ""),
                   ("o[c][4 * j + 2 * r + 1] *= alpha;", "")],
    "no_epilogue": [("        if (row >= Sq) {", "        if (true) {")],
    "no_store": [("                if (col < DV) {",
                  "                if (col < 0) {")],
    "no_sum": [("sum += s[4 * j + e];", "(void)0;")],
    "recip": [("const float denom = (l_run[r] == 0.f) ? 1.f : l_run[r];",
               "const float denom = 1.f / ((l_run[r] == 0.f) ? 1.f : "
               "l_run[r]);"),
              ("o[c][4 * j + 2 * r] / denom", "o[c][4 * j + 2 * r] * denom"),
              ("o[c][4 * j + 2 * r + 1] / denom",
               "o[c][4 * j + 2 * r + 1] * denom")],
}
APART["skeleton"] = (APART["no_qk"] + APART["no_pv"] + APART["no_scale"]
                     + APART["no_softmax"] + APART["no_fill"])
APART_SHAPES = [("dbrx", torch.float32), ("dbrx", torch.bfloat16),
                ("mla", torch.float32), ("mla", torch.bfloat16),
                ("recurrentgemma", torch.float32)]
V, I32, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
    ctypes.c_float
KERNEL = re.compile(r"(fa_fwd_kernel|fa_mma_kernel|fa_kernel)"
                    r"I(f|13__nv_bfloat16)Li(\d+)E(?:Li(\d+)E)?")
failures: list[str] = []


def inlined(csrc: str) -> str:
    """`flash_attention.cu` of a source directory with its headers
    inlined, each once where first included, so a copy builds anywhere."""
    with open(os.path.join(csrc, "flash_attention.cu")) as f:
        text = f.read()
    done = set()
    while True:
        m = re.search(r'#include "(\w+\.cuh)"', text)
        if not m:
            return text
        body = ""
        if m.group(1) not in done:
            done.add(m.group(1))
            with open(os.path.join(csrc, m.group(1))) as f:
                body = f.read()
        text = text[:m.start()] + body + text[m.end():]


def tune_line(text: str, dtype, dims) -> str:
    f32 = "true" if dtype == torch.float32 else "false"
    m = re.search(rf"REPRO_FA_TUNE\({f32}, {dims[0]}, {dims[1]}, "
                  r"\d+, \d+, \d+, \d\)", text)
    if m is None:
        raise RuntimeError(f"no REPRO_FA_TUNE line for {f32} {dims}")
    return m.group(0)


def kernel_name(mangled: str) -> str:
    m = KERNEL.search(mangled)
    if m is None:
        return mangled[:50]
    dt = "float32" if m.group(2) == "f" else "bf16"
    dims = m.group(3) + (f", {m.group(4)}" if m.group(4) else "")
    return f"{m.group(1)}<{dt}, {dims}>"


def report(label: str, so: str, log: str) -> None:
    """Registers and spills of each forward instantiation, and its SASS
    HGMMA and HMMA counts."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line or not KERNEL.search(line):
            continue
        rest = " ".join(part.strip() for part in lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", rest)
        spill = re.search(r"(\d+) bytes spill stores", rest)
        print(f"{label} {kernel_name(line)}: "
              f"{regs.group(1) if regs else '?'} registers, "
              f"{spill.group(1) if spill else '?'} bytes spill stores",
              flush=True)
    for line in lines:
        if "C75" in line:   # ptxas's notes on serialized wgmma
            print(f"{label} ptxas: {line.strip()[:200]}", flush=True)
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        print(f"{label} sass: cuobjdump not found", flush=True)
        return
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, timeout=120).stdout
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.split("\n", 1)[0].strip()
        if not KERNEL.search(name):
            continue
        ops = re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", func)
        print(f"{label} sass {kernel_name(name)}: {len(ops)} instructions, "
              f"HGMMA {sum(op.startswith('HGMMA') for op in ops)}, "
              f"HMMA {sum(op.startswith('HMMA') for op in ops)}, "
              f"LDS {sum(op.startswith('LDS') for op in ops)}, "
              f"STS {sum(op.startswith('STS') for op in ops)}", flush=True)


def entries(so: str, two_dims: bool) -> dict:
    """{dtype: the library's forward entry, called with this source's
    arguments}; an entry of one head dim drops Dv."""
    fns = {}
    for dtype, name in ((torch.float32, "flash_attention_f32"),
                        (torch.bfloat16, "flash_attention_bf16")):
        fn = entry(so, name, [V] * 5 + [I64] * (7 if two_dims else 6) +
                   [I32, I32, I64, I32, F32, F32, I64, V])
        fns[dtype] = fn if two_dims else (
            lambda *a, fn=fn: fn(*a[:11], *a[12:]))
    return fns


def inputs(shape, dtype, seed=1):
    B, Sq, Sk, Hq, Hkv, (Dqk, Dv), _, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Sq, Hq, Dqk), generator=g, device="cuda")
    k = torch.randn((B, Sk, Hkv, Dqk), generator=g, device="cuda")
    v = torch.randn((B, Sk, Hkv, Dv), generator=g, device="cuda")
    return q.to(dtype), k.to(dtype), v.to(dtype)


def caller(fn, shape, q, k, v, out, lse=None):
    B, Sq, Sk, Hq, Hkv, (Dqk, Dv), causal, window = shape

    def call():
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), B, Sq, Sk, Hq, Hkv,
                Dqk, Dv, int(causal), int(window is not None), window or 0,
                0, 0.0, Dqk ** -0.5, 0,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
    return call


def check(label, fn, shape, dtype, q, k, v, want) -> torch.Tensor:
    """One kernel against the plain version: the error, two calls the same
    bits, `out` the same with the log-sum-exp; returns the output."""
    B, Sq, _, Hq = shape[:4]
    out, again, with_lse = (q.new_empty(q.shape[:3] + (shape[5][1],))
                            for _ in range(3))
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device="cuda")
    caller(fn, shape, q, k, v, out)()
    caller(fn, shape, q, k, v, again)()
    caller(fn, shape, q, k, v, with_lse, lse)()
    torch.cuda.synchronize()
    err = float((out.float() - want).abs().max())
    same = torch.equal(out, again) and torch.equal(out, with_lse)
    ok = err <= TOL[dtype] and same and bool(torch.isfinite(lse).all())
    if not ok:
        failures.append(f"{label} {dtype}")
    print(f"  {label}: max abs error {err!r} (tolerance {TOL[dtype]}), "
          f"same bits twice and with lse {same}, lse finite "
          f"{bool(torch.isfinite(lse).all())}{'' if ok else '  FAILED'}",
          flush=True)
    return out


def sdpa(shape, q, k, v):
    """One PyTorch call for the same function (explicit mask with a
    window, `is_causal` without)."""
    F = torch.nn.functional
    _, Sq, Sk, Hq, Hkv, _, causal, window = shape
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kw = {"enable_gqa": Hq != Hkv}
    if window is not None:
        pos_q = torch.arange(Sq, device="cuda")[:, None]
        pos_k = torch.arange(Sk, device="cuda")[None, :]
        kw["attn_mask"] = (pos_k <= pos_q) & (pos_k > pos_q - window)
    elif causal:
        kw["is_causal"] = True
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)


def run_shapes(names, this, parent) -> None:
    for name in names:
        shape = SHAPES[name]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = inputs(shape, dtype)
            want = fa.flash_attention_plain(
                q, k, v, causal=shape[6], window=shape[7]).float()
            print(f"{name} {str(dtype)[6:]}: q {list(q.shape)} k "
                  f"{list(k.shape)} v {list(v.shape)}, causal {shape[6]}, "
                  f"window {shape[7]}", flush=True)
            mine = check("this", this[dtype], shape, dtype, q, k, v, want)
            out = torch.empty_like(mine)
            calls = {"this": caller(this[dtype], shape, q, k, v, out)}
            if parent is not None:
                theirs = check("parent", parent[dtype], shape, dtype, q, k,
                               v, want)
                print(f"  the same bits as the parent "
                      f"{torch.equal(mine, theirs)}", flush=True)
                calls["parent"] = caller(parent[dtype], shape, q, k, v, out)
            ms = {who: [] for who in calls}
            order = (("parent", "this", "this", "parent") if parent
                     else ("this", "this"))
            for who in order:
                ms[who].append(cuda_ms(calls[who], 10))
            lib = cuda_ms(sdpa(shape, q, k, v), 10)
            print(f"  ms: this {ms['this']!r}"
                  + (f", parent {ms['parent']!r}" if parent else "")
                  + f", sdpa {lib!r}", flush=True)
            del q, k, v, want, mine, out
            torch.cuda.empty_cache()


def run_variants(tmp, text, this) -> None:
    sources = {}
    for key in VARIANTS:
        name, dtype, wg, nk, stages, halves = key + (0,) * (6 - len(key))
        line = tune_line(text, dtype, SHAPES[name][5])
        new = re.sub(r"\d+, \d+, \d+, \d\)$",
                     f"{wg}, {nk}, {stages}, {halves})", line)
        sources[key] = text.replace(line, new)
    built = build(tempfile.mkdtemp(dir=tmp), sources, label=str)
    for key, (so, log) in built.items():
        name, dtype, wg, nk, stages, halves = key + (0,) * (6 - len(key))
        label = f"variant {name} {str(dtype)[6:]} kWG={wg} kNk={nk} " \
                f"kStages={stages} halves={halves}"
        shape = SHAPES[name]
        fn = entries(so, True)[dtype]
        q, k, v = inputs(shape, dtype)
        want = fa.flash_attention_plain(q, k, v, causal=shape[6],
                                        window=shape[7]).float()
        print(label, flush=True)
        try:
            mine = check("variant", fn, shape, dtype, q, k, v, want)
        except RuntimeError as e:   # a tile that does not fit
            print(f"  {e}", flush=True)
            continue
        out = torch.empty_like(mine)
        calls = {"variant": caller(fn, shape, q, k, v, out),
                 "this": caller(this[dtype], shape, q, k, v, out)}
        ms = {"variant": [], "this": []}
        for who in ("this", "variant", "variant", "this"):
            ms[who].append(cuda_ms(calls[who], 10))
        print(f"  ms: variant {ms['variant']!r}, this {ms['this']!r}",
              flush=True)
        del q, k, v, want, mine, out
        torch.cuda.empty_cache()


def run_apart(tmp, text, this) -> None:
    sources = {}
    for name, swaps in APART.items():
        copy = text
        for a, b in swaps:   # an anchor may be in one body only, or in
            copy = copy.replace(a, b)   # several: each is replaced
        if copy == text:
            raise RuntimeError(f"no anchor of {name} is in the source")
        sources[name] = copy
    built = build(tempfile.mkdtemp(dir=tmp), sources, label=str)
    for shape_name, dtype in APART_SHAPES:
        shape = SHAPES[shape_name]
        q, k, v = inputs(shape, dtype)
        out = q.new_empty(q.shape[:3] + (shape[5][1],))
        calls = {"this": caller(this[dtype], shape, q, k, v, out)}
        for name, (so, _) in built.items():
            calls[name] = caller(entries(so, True)[dtype], shape, q, k, v,
                                 out)
        ms = {who: [] for who in calls}
        for order in (list(calls), list(calls)[::-1]):
            for who in order:
                ms[who].append(cuda_ms(calls[who], 10))
        print(f"apart {shape_name} {str(dtype)[6:]} (timing only): "
              + ", ".join(f"{who} {t!r}" for who, t in ms.items()),
              flush=True)
        del q, k, v, out
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--parent", default=None,
                    help="a checkout of an earlier commit to compare with")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--apart", action="store_true")
    ap.add_argument("--no-shapes", dest="shapes", action="store_false",
                    help="skip the checks and times at SHAPES")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fa_sweep: no CUDA device", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    text = inlined(CSRC)
    sources = {"this": text}
    if args.parent:
        sources["parent"] = inlined(os.path.join(args.parent, "src",
                                                 "repro_torch", "csrc"))
    # a directory for each batch of builds: ctypes keeps a library loaded by
    # its path, so a path is never built twice
    with tempfile.TemporaryDirectory(dir=build_root()) as tmp:
        built = build(tempfile.mkdtemp(dir=tmp), sources, label=str)
        if "this" not in built:
            return 1
        for who, (so, log) in built.items():
            report(who, so, log)
        this = entries(built["this"][0], True)
        parent = None
        if "parent" in built:
            parent = entries(built["parent"][0],
                             "int64_t Dv" in sources["parent"])
        elif args.parent:
            failures.append("the parent does not build")
        if args.apart:
            run_apart(tmp, text, this)
        if args.shapes:
            run_shapes(list(SHAPES), this, parent)
        if args.variants:
            run_variants(tmp, text, this)
    if failures:
        print(f"FAILED: {failures}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
