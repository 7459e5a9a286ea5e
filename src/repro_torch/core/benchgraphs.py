"""The paper's 10 benchmarks (Table 3/4) as traced dataflow programs.

The paper builds LLVM graphs by (1) compiling to IR, (2) instrumenting with
``rdtsc``/``printf`` to get the *dynamic* trace with per-memory-op timing,
(3) dependency analysis.  We reproduce the same construction with a tiny
trace VM: every executed operation becomes a vertex, SSA/register uses and
memory RAW dependencies become edges, and memory operations are timed by a
reuse-distance cache model standing in for ``rdtsc`` (DESIGN.md §2 records
this substitution).  The resulting graphs are weighted DAGs in execution
order with power-law degree distributions, matching Table 4 qualitatively
(`scale="paper"` lands within ~2x of the published node/edge counts;
`scale="reduced"` keeps CI fast).

Benchmarks: Dijkstra, FFT, K-means, Mandel, MD, NN, Neuron, CNN,
Strassen8 (8x8 matrices), Strassen16 (16x16 matrices).
"""
from __future__ import annotations

import math
import os

import numpy as np

from .graph import IRGraph

__all__ = ["Tracer", "build_graph", "BENCHMARKS", "all_benchmark_names"]

# reuse-distance cache model: (threshold, cycles) — L1 hit, L2 hit, DRAM
_L1_WINDOW, _L1_T = 256, 4.0
_L2_WINDOW, _L2_T = 4096, 12.0
_DRAM_T = 100.0
_REG_T = 1.0  # register-register dependency weight


class _Mem:
    """An alloca'd region: base-pointer node + per-cell metadata."""

    __slots__ = ("base", "cells", "last_gep", "n_geps")

    def __init__(self, base: int, cells: list):
        self.base = base
        self.cells = cells
        self.last_gep = base
        self.n_geps = 0


class Tracer:
    """Dynamic-trace recorder: executes the program while building G.

    `gep_chain_period` controls address-computation structure: every K-th
    access re-anchors at the base pointer (direct indexing), intermediate
    ones chain off the previous gep (pointer-bump idiom).  K=1 gives the
    pure hub-and-spoke shape of the paper's Fig. 5 examples.
    """

    __slots__ = ("src", "dst", "w", "n_nodes", "clock", "name",
                 "gep_chain_period")

    def __init__(self, name: str, gep_chain_period: int = 1):
        self.name = name
        self.gep_chain_period = max(1, gep_chain_period)
        self.src: list[int] = []
        self.dst: list[int] = []
        self.w: list[float] = []
        self.n_nodes = 0
        self.clock = 0

    # -- node/edge primitives ------------------------------------------- #
    def _node(self) -> int:
        nid = self.n_nodes
        self.n_nodes = nid + 1
        self.clock += 1
        return nid

    def _edge(self, s: int, d: int, w: float) -> None:
        self.src.append(s)
        self.dst.append(d)
        self.w.append(w)

    # -- IR ops ----------------------------------------------------------#
    def const(self, val) -> tuple[int, float]:
        return (self._node(), val)

    def bin(self, op: str, a, b):
        """Arithmetic/compare: new node depending on both operands."""
        nid = self._node()
        self._edge(a[0], nid, _REG_T)
        self._edge(b[0], nid, _REG_T)
        x, y = a[1], b[1]
        if op == "+":
            v = x + y
        elif op == "-":
            v = x - y
        elif op == "*":
            v = x * y
        elif op == "/":
            v = x / y if y != 0 else 0.0
        elif op == "<":
            v = float(x < y)
        elif op == "max":
            v = x if x > y else y
        else:
            raise ValueError(op)
        return (nid, v)

    def un(self, op: str, a):
        nid = self._node()
        self._edge(a[0], nid, _REG_T)
        x = a[1]
        if op == "neg":
            v = -x
        elif op == "relu":
            v = x if x > 0 else 0.0
        elif op == "sqrt":
            v = math.sqrt(x) if x > 0 else 0.0
        else:
            raise ValueError(op)
        return (nid, v)

    def alloca(self, n: int, init=0.0):
        """A memory region.  Returns (base_ptr_node, cells) where each cell
        is [last_writer_node, value, last_access_clock].  The base pointer
        register is the LLVM-trace hub: every access computes an address
        from it via a `getelementptr` node (light register edges), which is
        what gives these graphs their power-law degree skew."""
        base = self._node()  # the alloca instruction itself
        return _Mem(base, [[base, init, self.clock] for _ in range(n)])

    def _mem_time(self, cell) -> float:
        age = self.clock - cell[2]
        if age < _L1_WINDOW:
            return _L1_T
        if age < _L2_WINDOW:
            return _L2_T
        return _DRAM_T

    def _gep(self, mem) -> int:
        """Address computation (`getelementptr`).  Compiled loops mix the
        pointer-bump idiom (gep chained off the previous gep) with direct
        indexing off the base pointer; we re-anchor to the base every 8th
        access, which reproduces both the gep chains and the moderate
        base-pointer hubs of real dynamic IR traces."""
        gep = self._node()
        anchor = (mem.base if mem.n_geps % self.gep_chain_period == 0
                  else mem.last_gep)
        self._edge(anchor, gep, _REG_T)
        mem.last_gep = gep
        mem.n_geps += 1
        return gep

    def load(self, mem, i: int):
        cell = mem.cells[i]
        t = self._mem_time(cell)
        gep = self._gep(mem)
        nid = self._node()
        self._edge(gep, nid, _REG_T)     # address -> load
        self._edge(cell[0], nid, t)      # RAW memory dependency, timed
        cell[2] = self.clock
        return (nid, cell[1])

    def store(self, mem, i: int, val) -> None:
        cell = mem.cells[i]
        t = self._mem_time(cell)
        gep = self._gep(mem)
        nid = self._node()
        self._edge(gep, nid, _REG_T)     # address -> store
        self._edge(val[0], nid, t)       # value into memory, timed
        cell[0] = nid
        cell[1] = val[1]
        cell[2] = self.clock

    def graph(self) -> IRGraph:
        return IRGraph(n=self.n_nodes, src=np.array(self.src, np.int32),
                       dst=np.array(self.dst, np.int32),
                       w=np.array(self.w, np.float64), name=self.name)


# ---------------------------------------------------------------------- #
# benchmark programs (paper Table 3 inputs in scale="paper")
# ---------------------------------------------------------------------- #
def _dijkstra(t: Tracer, n: int) -> None:
    rng = np.random.default_rng(0)
    adj_np = rng.integers(1, 100, size=(n, n)).astype(float)
    adj = t.alloca(n * n)
    for i in range(n):
        for j in range(n):
            t.store(adj, i * n + j, t.const(adj_np[i, j]))
    dist = t.alloca(n, init=math.inf)
    done = t.alloca(n)
    t.store(dist, 0, t.const(0.0))
    for _ in range(n):
        best, best_v = -1, math.inf
        for v in range(n):
            dv = t.load(dist, v)
            fv = t.load(done, v)
            c = t.bin("<", dv, t.const(best_v))
            if fv[1] == 0.0 and c[1] == 1.0:
                best, best_v = v, dv[1]
        if best < 0:
            break
        t.store(done, best, t.const(1.0))
        du = t.load(dist, best)
        for v in range(n):
            wuv = t.load(adj, best * n + v)
            cand = t.bin("+", du, wuv)
            dv = t.load(dist, v)
            if cand[1] < dv[1]:
                t.store(dist, v, cand)


def _fft(t: Tracer, n: int) -> None:
    rng = np.random.default_rng(0)
    re = t.alloca(n)
    im = t.alloca(n)
    for i in range(n):
        t.store(re, i, t.const(float(rng.standard_normal())))
        t.store(im, i, t.const(0.0))
    # bit-reversal permutation
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a = t.load(re, i)
            b = t.load(re, j)
            t.store(re, i, b)
            t.store(re, j, a)
            a = t.load(im, i)
            b = t.load(im, j)
            t.store(im, i, b)
            t.store(im, j, a)
    # butterflies
    size = 2
    while size <= n:
        half = size // 2
        step = n // size
        for i in range(0, n, size):
            for k in range(half):
                ang = -2 * math.pi * k * step / n
                wr, wi = t.const(math.cos(ang)), t.const(math.sin(ang))
                ar, ai = t.load(re, i + k), t.load(im, i + k)
                br, bi = t.load(re, i + k + half), t.load(im, i + k + half)
                tr = t.bin("-", t.bin("*", br, wr), t.bin("*", bi, wi))
                ti = t.bin("+", t.bin("*", br, wi), t.bin("*", bi, wr))
                t.store(re, i + k, t.bin("+", ar, tr))
                t.store(im, i + k, t.bin("+", ai, ti))
                t.store(re, i + k + half, t.bin("-", ar, tr))
                t.store(im, i + k + half, t.bin("-", ai, ti))
        size *= 2


def _kmeans(t: Tracer, n: int, k: int = 4, iters: int = 12) -> None:
    rng = np.random.default_rng(0)
    px = t.alloca(n)
    py = t.alloca(n)
    for i in range(n):
        t.store(px, i, t.const(float(rng.standard_normal())))
        t.store(py, i, t.const(float(rng.standard_normal())))
    cx = t.alloca(k)
    cy = t.alloca(k)
    for c in range(k):
        t.store(cx, c, t.load(px, c))
        t.store(cy, c, t.load(py, c))
    assign = t.alloca(n)
    for _ in range(iters):
        for i in range(n):
            xi, yi = t.load(px, i), t.load(py, i)
            best, best_d = 0, math.inf
            for c in range(k):
                dx = t.bin("-", xi, t.load(cx, c))
                dy = t.bin("-", yi, t.load(cy, c))
                d = t.bin("+", t.bin("*", dx, dx), t.bin("*", dy, dy))
                if d[1] < best_d:
                    best, best_d = c, d[1]
            t.store(assign, i, t.const(float(best)))
        sx = t.alloca(k)
        sy = t.alloca(k)
        cnt = t.alloca(k)
        for i in range(n):
            c = int(t.load(assign, i)[1])
            t.store(sx, c, t.bin("+", t.load(sx, c), t.load(px, i)))
            t.store(sy, c, t.bin("+", t.load(sy, c), t.load(py, i)))
            t.store(cnt, c, t.bin("+", t.load(cnt, c), t.const(1.0)))
        for c in range(k):
            nc = t.load(cnt, c)
            if nc[1] > 0:
                t.store(cx, c, t.bin("/", t.load(sx, c), nc))
                t.store(cy, c, t.bin("/", t.load(sy, c), nc))


def _mandel(t: Tracer, npoints: int, max_iter: int = 24) -> None:
    side = int(math.sqrt(npoints))
    out = t.alloca(side * side)
    for i in range(side):
        for j in range(side):
            cre = t.const(-2.0 + 3.0 * i / side)
            cim = t.const(-1.5 + 3.0 * j / side)
            zr, zi = t.const(0.0), t.const(0.0)
            it = 0
            while it < max_iter:
                zr2 = t.bin("*", zr, zr)
                zi2 = t.bin("*", zi, zi)
                mag = t.bin("+", zr2, zi2)
                if mag[1] > 4.0:
                    break
                nzr = t.bin("+", t.bin("-", zr2, zi2), cre)
                zi = t.bin("+", t.bin("*", t.bin("*", t.const(2.0), zr), zi),
                           cim)
                zr = nzr
                it += 1
            t.store(out, i * side + j, t.const(float(it)))


def _md(t: Tracer, n: int) -> None:
    rng = np.random.default_rng(0)
    pos = [t.alloca(n) for _ in range(2)]
    force = [t.alloca(n) for _ in range(2)]
    for d in range(2):
        for i in range(n):
            t.store(pos[d], i, t.const(float(rng.standard_normal())))
    for i in range(n):
        fx, fy = t.const(0.0), t.const(0.0)
        xi, yi = t.load(pos[0], i), t.load(pos[1], i)
        for j in range(n):
            if j == i:
                continue
            dx = t.bin("-", xi, t.load(pos[0], j))
            dy = t.bin("-", yi, t.load(pos[1], j))
            r2 = t.bin("+", t.bin("*", dx, dx), t.bin("*", dy, dy))
            inv = t.bin("/", t.const(1.0), t.bin("+", r2, t.const(1e-3)))
            fx = t.bin("+", fx, t.bin("*", dx, inv))
            fy = t.bin("+", fy, t.bin("*", dy, inv))
        t.store(force[0], i, fx)
        t.store(force[1], i, fy)


def _matmul_fc(t: Tracer, x: list, w_np: np.ndarray, relu: bool) -> list:
    n_in, n_out = w_np.shape
    wmem = t.alloca(n_in * n_out)
    for i in range(n_in):
        for j in range(n_out):
            t.store(wmem, i * n_out + j, t.const(float(w_np[i, j])))
    out = t.alloca(n_out)
    for j in range(n_out):
        acc = t.const(0.0)
        for i in range(n_in):
            acc = t.bin("+", acc,
                        t.bin("*", t.load(x, i), t.load(wmem, i * n_out + j)))
        if relu:
            acc = t.un("relu", acc)
        t.store(out, j, acc)
    return out


def _nn(t: Tracer, n_in: int, hidden: tuple = (64, 64, 64),
        n_out: int = 10) -> None:
    rng = np.random.default_rng(0)
    x = t.alloca(n_in)
    for i in range(n_in):
        t.store(x, i, t.const(float(rng.standard_normal())))
    dims = [n_in, *hidden, n_out]
    for li in range(len(dims) - 1):
        w = rng.standard_normal((dims[li], dims[li + 1])) * 0.1
        x = _matmul_fc(t, x, w, relu=(li < len(dims) - 2))


def _neuron(t: Tracer, n_neurons: int, n_inputs: int = 100) -> None:
    rng = np.random.default_rng(0)
    x = t.alloca(n_inputs)
    for i in range(n_inputs):
        t.store(x, i, t.const(float(rng.standard_normal())))
    out = t.alloca(n_neurons)
    for nr in range(n_neurons):
        w = t.alloca(n_inputs)
        for i in range(n_inputs):
            t.store(w, i, t.const(float(rng.standard_normal() * 0.1)))
        acc = t.const(0.0)
        for i in range(n_inputs):
            acc = t.bin("+", acc, t.bin("*", t.load(x, i), t.load(w, i)))
        t.store(out, nr, t.un("relu", acc))


def _conv2d(t: Tracer, img: list, h: int, w: int, cin: int, cout: int,
            kern_np: np.ndarray) -> tuple[list, int, int]:
    kh = kw = kern_np.shape[2]
    oh, ow = h - kh + 1, w - kw + 1
    kern = t.alloca(cout * cin * kh * kw)
    for idx, val in enumerate(kern_np.ravel()):
        t.store(kern, idx, t.const(float(val)))
    out = t.alloca(cout * oh * ow)
    for co in range(cout):
        for i in range(oh):
            for j in range(ow):
                acc = t.const(0.0)
                for ci in range(cin):
                    for ki in range(kh):
                        for kj in range(kw):
                            px = t.load(img, ci * h * w + (i + ki) * w + (j + kj))
                            kv = t.load(kern, ((co * cin + ci) * kh + ki) * kw + kj)
                            acc = t.bin("+", acc, t.bin("*", px, kv))
                t.store(out, co * oh * ow + i * ow + j, t.un("relu", acc))
    return out, oh, ow


def _pool2(t: Tracer, img: list, c: int, h: int, w: int
           ) -> tuple[list, int, int]:
    oh, ow = h // 2, w // 2
    out = t.alloca(c * oh * ow)
    for ci in range(c):
        for i in range(oh):
            for j in range(ow):
                a = t.load(img, ci * h * w + 2 * i * w + 2 * j)
                b = t.load(img, ci * h * w + 2 * i * w + 2 * j + 1)
                cc = t.load(img, ci * h * w + (2 * i + 1) * w + 2 * j)
                d = t.load(img, ci * h * w + (2 * i + 1) * w + 2 * j + 1)
                t.store(out, ci * oh * ow + i * ow + j,
                        t.bin("max", t.bin("max", a, b), t.bin("max", cc, d)))
    return out, oh, ow


def _cnn(t: Tracer, img_side: int, c1: int = 6, c2: int = 12) -> None:
    rng = np.random.default_rng(0)
    img = t.alloca(img_side * img_side)
    for i in range(img_side * img_side):
        t.store(img, i, t.const(float(rng.standard_normal())))
    x, h, w = _conv2d(t, img, img_side, img_side, 1, c1,
                      rng.standard_normal((c1, 1, 3, 3)) * 0.1)
    x, h, w = _pool2(t, x, c1, h, w)
    x, h, w = _conv2d(t, x, h, w, c1, c2,
                      rng.standard_normal((c2, c1, 3, 3)) * 0.1)
    x, h, w = _pool2(t, x, c2, h, w)
    _matmul_fc(t, x, rng.standard_normal((c2 * h * w, 10)) * 0.1, relu=False)


def _strassen(t: Tracer, size: int, base: int = 2) -> None:
    rng = np.random.default_rng(0)

    def alloc_mat(n, init_np=None):
        m = t.alloca(n * n)
        if init_np is not None:
            for idx, val in enumerate(init_np.ravel()):
                t.store(m, idx, t.const(float(val)))
        return m

    def addsub(a, b, n, op):
        c = alloc_mat(n)
        for i in range(n * n):
            t.store(c, i, t.bin(op, t.load(a, i), t.load(b, i)))
        return c

    def quad(a, n, qi, qj):
        h = n // 2
        q = alloc_mat(h)
        for i in range(h):
            for j in range(h):
                t.store(q, i * h + j, t.load(a, (qi * h + i) * n + (qj * h + j)))
        return q

    def mul(a, b, n):
        if n <= base:
            c = alloc_mat(n)
            for i in range(n):
                for j in range(n):
                    acc = t.const(0.0)
                    for k in range(n):
                        acc = t.bin("+", acc, t.bin("*", t.load(a, i * n + k),
                                                    t.load(b, k * n + j)))
                    t.store(c, i * n + j, acc)
            return c
        h = n // 2
        a11, a12 = quad(a, n, 0, 0), quad(a, n, 0, 1)
        a21, a22 = quad(a, n, 1, 0), quad(a, n, 1, 1)
        b11, b12 = quad(b, n, 0, 0), quad(b, n, 0, 1)
        b21, b22 = quad(b, n, 1, 0), quad(b, n, 1, 1)
        m1 = mul(addsub(a11, a22, h, "+"), addsub(b11, b22, h, "+"), h)
        m2 = mul(addsub(a21, a22, h, "+"), b11, h)
        m3 = mul(a11, addsub(b12, b22, h, "-"), h)
        m4 = mul(a22, addsub(b21, b11, h, "-"), h)
        m5 = mul(addsub(a11, a12, h, "+"), b22, h)
        m6 = mul(addsub(a21, a11, h, "-"), addsub(b11, b12, h, "+"), h)
        m7 = mul(addsub(a12, a22, h, "-"), addsub(b21, b22, h, "+"), h)
        c = alloc_mat(n)
        for i in range(h):
            for j in range(h):
                k = i * h + j
                c11 = t.bin("+", t.bin("-", t.bin("+", t.load(m1, k),
                                                  t.load(m4, k)),
                                       t.load(m5, k)), t.load(m7, k))
                c12 = t.bin("+", t.load(m3, k), t.load(m5, k))
                c21 = t.bin("+", t.load(m2, k), t.load(m4, k))
                c22 = t.bin("+", t.bin("-", t.bin("+", t.load(m1, k),
                                                  t.load(m3, k)),
                                       t.load(m2, k)), t.load(m6, k))
                t.store(c, i * n + j, c11)
                t.store(c, i * n + (j + h), c12)
                t.store(c, (i + h) * n + j, c21)
                t.store(c, (i + h) * n + (j + h), c22)
        return c

    a = alloc_mat(size, rng.standard_normal((size, size)))
    b = alloc_mat(size, rng.standard_normal((size, size)))
    mul(a, b, size)


# ---------------------------------------------------------------------- #
# registry + caching
# ---------------------------------------------------------------------- #
# (builder, paper-scale kwargs, reduced-scale kwargs) — paper Table 3 inputs.
BENCHMARKS: dict = {
    "dijkstra":   (_dijkstra, {"n": 50}, {"n": 12}),
    "fft":        (_fft, {"n": 1024}, {"n": 64}),
    "kmeans":     (_kmeans, {"n": 128, "iters": 12}, {"n": 24, "iters": 4}),
    "mandel":     (_mandel, {"npoints": 4092}, {"npoints": 256}),
    "md":         (_md, {"n": 512}, {"n": 48}),
    "nn":         (_nn, {"n_in": 32, "hidden": (64, 64, 64)},
                   {"n_in": 12, "hidden": (16, 16, 16)}),
    "neuron":     (_neuron, {"n_neurons": 64, "n_inputs": 100},
                   {"n_neurons": 16, "n_inputs": 24}),
    "cnn":        (_cnn, {"img_side": 28}, {"img_side": 10}),
    "strassen8":  (_strassen, {"size": 8}, {"size": 4}),
    "strassen16": (_strassen, {"size": 16}, {"size": 8}),
}


def all_benchmark_names() -> list[str]:
    return list(BENCHMARKS)


def build_graph(name: str, scale: str = "reduced",
                cache_dir: str | None = None) -> IRGraph:
    """Build the dynamic-trace graph for a benchmark.

    With `cache_dir`, the graph is read from (or written to) an `.npz`
    snapshot there, in the layout the JAX package's cache uses."""
    if name not in BENCHMARKS:
        raise ValueError(f"unknown benchmark {name!r}")
    if scale not in ("paper", "reduced"):
        raise ValueError("scale must be 'paper' or 'reduced'")
    path = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        path = os.path.join(cache_dir, f"{name}_{scale}.npz")
        if os.path.exists(path):
            return IRGraph.load_npz(path)
    builder, paper_kw, reduced_kw = BENCHMARKS[name]
    t = Tracer(f"{name}/{scale}")
    builder(t, **(paper_kw if scale == "paper" else reduced_kw))
    g = t.graph()
    if path:
        g.save_npz(path)
    return g
