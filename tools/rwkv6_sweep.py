"""Time register tilings of the RWKV6 kernel on one NVIDIA GPU.

    python3 tools/rwkv6_sweep.py

Builds copies of `src/repro_torch/csrc/rwkv6.cu` with other tile
constants — contiguous rows of the state per lane (kRows; 64 / kRows
lanes share a column group), state columns per lane (kCols), warps per
block (kWarps; a block holds kWarps * 32 / (64 / kRows) * kCols state
columns) and time steps staged and unrolled per round (kSteps) — and
the kernel's
previous design, kept below as `BASELINE_SOURCE` (8 lanes to a state
column with 8 strided rows each, one column per lane, 16 columns and 16
staged steps a block), one nvcc each with the library's flags, all at
once. It prints each one's registers and spills for the float32
instantiation. Each is checked against the plain version at rwkv6-7b's
prefill shape (B=2, S=4096, H=64, Dk=Dv=64, no s0), its decode shape
(B=4, S=1, with s0) and a ragged shape (B=1, S=70, H=3, Dk=40, Dv=20,
with s0): S_last bit for bit, out within 1e-5 * max(1, max|out|). A
variant that does not build, is refused at launch or disagrees is
reported and left out. The rest are timed with CUDA events after a sleep
that lets the host queue every launch (a warm-up, then the mean of 10
launches at the prefill shape and 200 at the decode shape), every variant
twice in turn. The first variant is the source's own tiling.

It also prints the SASS instruction counts of the source's and the
previous design's float32 kernels (the whole kernel and its longest
block, the unrolled round), times ablations — copies of two tilings with
the round's shuffle tree or the u term's butterfly taken out, which no
longer compute the WKV and are not checked — at the prefill shape to show
what those parts cost, and prints the SM clock and power draw under the
source's kernel at the prefill shape.
"""
from __future__ import annotations

import ctypes
import os
import sys
import tempfile

import torch

import kernel_sweep as ks  # (beside this script) puts src/ on the path
from repro_torch.core._native import build_root  # noqa: E402
from repro_torch.kernels import rwkv6  # noqa: E402

# (kRows, kCols, kWarps, kSteps); the source's own first
VARIANTS = [(8, 2, 8, 8), (8, 2, 8, 16), (8, 2, 8, 4), (8, 2, 4, 8),
            (4, 4, 8, 8), (4, 4, 8, 16), (4, 2, 16, 8), (4, 2, 16, 16),
            (8, 4, 4, 8), (2, 8, 8, 8), (2, 4, 16, 8), (16, 2, 4, 8)]
SOURCE = {"kRows": 8, "kCols": 2, "kWarps": 8, "kSteps": 8}
BASELINE = "baseline"
# (name, [(old, new)]) edits of a tiling's source, and the tilings ablated
ABLATIONS = [
    ("no shuffle tree", [("        reduce_round<0>(part, rl);\n", "")]),
    ("no u-term butterfly", [(
        "                p[j] += __shfl_xor_sync(0xffffffffu, p[j], off);\n",
        "")]),
]
ABLATED = [(8, 2, 8, 8), (4, 4, 8, 16)]
PREFILL = (2, 4096, 64, 64, 64)
DECODE = (4, 1, 64, 64, 64)
RAGGED = (1, 70, 3, 40, 20)
TOL = 1e-5
# the float32 instantiation's mangled name
ENTRY = "rwkv6_kernelIf"
ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]


def label(variant) -> str:
    if variant == BASELINE:
        return "previous design (8 strided rows x 1 column a lane)"
    if variant[0] == "ablation":
        return f"ablation '{variant[1]}' of {label(variant[2])}"
    rows, cols, warps, steps = variant
    return (f"kRows={rows} kCols={cols} kWarps={warps} kSteps={steps} "
            f"({warps * 32 // (64 // rows) * cols} columns a block)")


def variant_source(text: str, variant) -> str:
    if variant == BASELINE:
        return BASELINE_SOURCE
    if variant[0] == "ablation":
        text = variant_source(text, variant[2])
        for old, new in dict(ABLATIONS)[variant[1]]:
            text = ks.replace_once(text, old, new)
        return text
    return ks.set_constants(text, SOURCE, variant)


def inputs(B, S, H, Dk, Dv, seed=0):
    """The draws of the JAX package's kernel test, and a normal s0."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = torch.randn((B, S, H, Dk), generator=g, device="cuda")
    k = torch.randn((B, S, H, Dk), generator=g, device="cuda") * 0.3
    v = torch.randn((B, S, H, Dv), generator=g, device="cuda")
    w = torch.rand((B, S, H, Dk), generator=g, device="cuda") * 0.59 + 0.4
    u = torch.randn((H, Dk), generator=g, device="cuda") * 0.1
    s0 = torch.randn((B, H, Dk, Dv), generator=g, device="cuda")
    return r, k, v, w, u, s0


class Case:
    """One shape's inputs, the plain version's outputs and a caller."""

    def __init__(self, shape, with_s0: bool):
        self.shape = shape
        B, S, H, Dk, Dv = shape
        self.r, self.k, self.v, self.w, self.u, s0 = inputs(*shape)
        self.s0 = s0 if with_s0 else None
        self.want_o, self.want_s = rwkv6.rwkv6_plain(
            self.r, self.k, self.v, self.w, self.u, self.s0)
        self.tol = TOL * max(1.0, float(self.want_o.abs().max()))
        self.out = torch.empty_like(self.v)
        self.s_last = torch.empty((B, H, Dk, Dv), device="cuda")

    def call(self, fn) -> int:
        return fn(self.r.data_ptr(), self.k.data_ptr(), self.v.data_ptr(),
                  self.w.data_ptr(), self.u.data_ptr(),
                  self.s0.data_ptr() if self.s0 is not None else None,
                  self.out.data_ptr(), self.s_last.data_ptr(), *self.shape,
                  torch.cuda.current_stream().cuda_stream)

    def check(self, fn) -> str | None:
        """None when the variant agrees with the plain version, else why."""
        self.out.fill_(float("nan"))
        rc = self.call(fn)
        if rc != 0:
            return f"launch refused (CUDA error {rc})"
        torch.cuda.synchronize()
        err = float((self.out - self.want_o).abs().max())
        if not torch.equal(self.s_last, self.want_s):
            return f"S_last differs at {self.shape}"
        if not err <= self.tol:
            return f"out error {err!r} > {self.tol!r} at {self.shape}"
        return None


def main() -> int:
    if not torch.cuda.is_available():
        print("rwkv6_sweep: no CUDA device", file=sys.stderr)
        return 1
    print(ks.card_line(), flush=True)
    with open(os.path.join(ks.CSRC, "rwkv6.cu")) as f:
        text = f.read()
    ablations = [("ablation", name, tile) for tile in ABLATED
                 for name, _ in ABLATIONS]
    with tempfile.TemporaryDirectory(dir=build_root()) as tmp:
        built = ks.build(tmp, {v: variant_source(text, v)
                               for v in VARIANTS + [BASELINE] + ablations},
                         label)
        libs, ablated = {}, {}
        for variant, (so, log) in built.items():
            print(f"variant {label(variant)}: "
                  f"{ks.ptxas_report(log, ENTRY)}", flush=True)
            if variant in (VARIANTS[0], BASELINE):
                print(f"sass {label(variant)}: {ks.sass_counts(so, ENTRY)}",
                      flush=True)
            fn = ks.entry(so, "rwkv6_f32", ARGTYPES)
            (ablated if variant in ablations else libs)[variant] = fn
        cases = {(PREFILL, 10): Case(PREFILL, False),
                 (DECODE, 200): Case(DECODE, True)}
        ragged = Case(RAGGED, True)
        for variant, fn in list(libs.items()):
            why = (ragged.check(fn) or cases[(PREFILL, 10)].check(fn)
                   or cases[(DECODE, 200)].check(fn))
            if why is not None:
                print(f"variant {label(variant)}: left out: {why}",
                      flush=True)
                del libs[variant]
        for (shape, reps), case in cases.items():
            print(f"shape (B, S, H, Dk, Dv)={shape} "
                  f"s0={'given' if case.s0 is not None else 'none'}: S_last "
                  f"equal and out within {case.tol!r} for every variant "
                  f"timed", flush=True)
            for _ in range(2):
                for variant, fn in libs.items():
                    ms = ks.cuda_ms(lambda fn=fn: case.call(fn), reps)
                    print(f"  {label(variant)}: {ms!r} ms", flush=True)
        prefill = cases[(PREFILL, 10)]
        print(f"ablations at {PREFILL} (not checked: they do not compute "
              f"the WKV)", flush=True)
        for variant, fn in ablated.items():
            ms = ks.cuda_ms(lambda fn=fn: prefill.call(fn), 10)
            print(f"  {label(variant)}: {ms!r} ms", flush=True)
        if VARIANTS[0] in libs:
            fn = libs[VARIANTS[0]]
            print(f"under load, {label(VARIANTS[0])} at {PREFILL}: "
                  f"{ks.clock_under_load(lambda: prefill.call(fn))}",
                  flush=True)
    return 0


# The previous design of csrc/rwkv6.cu, built as the baseline variant.
BASELINE_SOURCE = r"""// RWKV6 (Finch) WKV scan for Hopper (sm_90a), bound through a plain C
// interface.
//
// Replaces the TPU kernel `_rwkv6_kernel` of the JAX package
// (src/repro/kernels/rwkv6.py:28, launched at :68).
//
// What it computes: for r, k, w [B, S, H, Dk], v [B, S, H, Dv], u [H, Dk]
// (float32) and an optional s0 [B, H, Dk, Dv] (float32; zeros when
// absent), per head (b, h) with a float32 state S [Dk, Dv] and
// t = 0 .. S-1:
//     out_t = r_t (S + u ⊙ k_t^T v_t)          -> out [B, S, H, Dv]
//     S    <- diag(w_t) S + k_t^T v_t           -> s_last [B, H, Dk, Dv]
// out in the input's type, s_last in float32.  Built with --fmad=false,
// the state update w*S + kv is a multiply and an add, rounded as the plain
// version's two operations are, so s_last is bit-identical to it; out sums
// over Dk in another order and is held to a tolerance.
//
// Design.  The TPU kernel gives one grid program to each (b, h), keeps the
// Dk x Dv state in VMEM and walks time with a rank-1 update and a matvec
// per step.  On Hopper one block per head would leave SMs idle at the
// prefill shape (B*H = 128 heads for 132 SMs) and give each SM one long
// chain.  The Dv columns of the state are independent (column v is updated
// from w, k and v[v] alone), and the only reduction is over Dk for
// out_t[v].  So a block owns kCols columns of one head; kParts neighbouring
// lanes share one column, each lane holding every kParts-th row of it in
// registers for the whole scan, and out_t[v] is summed across those lanes
// with three warp shuffles.  r_t, k_t and w_t (shared by all of a head's
// columns) and the block's v_t are staged for kSteps time steps at a time
// in shared memory with coalesced loads (a row of one (t, h) is Dk
// contiguous elements); the loads of the next round are issued into
// registers before this round's steps run, so their latency is hidden.
// out is staged in shared memory too and written coalesced.
// Lanes of one column read neighbouring words of a staged row, so the
// reads are broadcasts without bank conflicts.
//
// Bound.  Per (b, t, h) it reads r, k, w, v once and writes out once, and
// does about 7*Dk*Dv float32 operations: at the prefill shape (B=2, S=4096,
// H=64, Dk=Dv=64) 673 MB (0.201 ms at 3.35 TB/s) against 1.50e10
// operations (0.224 ms at 67 TFLOP/s), so operations bound it on paper.
// The kernel keeps the state out of device memory, but each lane walks S
// dependent steps and every operand of a step comes through shared memory,
// so in practice it is bound by the shared-memory reads and the dependent
// chain, not by the card's peak.  Tensor cores and the chunked matmul form
// (rwkv6_chunked) are left for a later change.
//
// Build: see flash_attention.cu.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kParts = 8;         // lanes that share one column of S
constexpr int kRowsPerLane = 8;   // rows of that column each lane holds
constexpr int kMaxDk = kParts * kRowsPerLane;  // 64
constexpr int kCols = 16;         // columns of S per block
constexpr int kThreads = kCols * kParts;       // 128
constexpr int kSteps = 16;        // time steps staged per round
constexpr int kRowsPerThread = kSteps * kMaxDk / kThreads;  // staged r/k/w
constexpr int kVPerThread = kSteps * kCols / kThreads;      // staged v/out
static_assert(kSteps * kMaxDk % kThreads == 0 && kThreads % kMaxDk == 0,
              "threads tile a staged row");
static_assert(kSteps * kCols % kThreads == 0, "threads tile v and out");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
    return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ s0,
             T* __restrict__ out, float* __restrict__ s_last, int64_t S,
             int64_t H, int Dk, int Dv) {
    __shared__ float r_s[kSteps][kMaxDk];
    __shared__ float k_s[kSteps][kMaxDk];
    __shared__ float w_s[kSteps][kMaxDk];
    __shared__ float v_s[kSteps][kCols];
    __shared__ float o_s[kSteps][kCols];

    const int tid = threadIdx.x;
    const int part = tid % kParts;
    const int c = tid / kParts;
    const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kCols;
    const int64_t col = col0 + c;
    const int64_t h = blockIdx.y;
    const int64_t b = blockIdx.z;
    const bool live = col < Dv;

    // lane `part` holds rows part, part + kParts, ... of column `col`
    float state[kRowsPerLane];
    float uu[kRowsPerLane];
    const int64_t head = b * H + h;
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) {
        const int row = i * kParts + part;
        const bool ok = live && row < Dk;
        state[i] = (ok && s0 != nullptr) ? s0[(head * Dk + row) * Dv + col]
                                         : 0.0f;
        uu[i] = row < Dk ? u[h * Dk + row] : 0.0f;
    }

    // r[b, t, h, :] starts at ((b*S + t)*H + h)*Dk
    const int64_t rk_step = H * Dk;
    const int64_t v_step = H * Dv;
    const T* rb = r + (b * S * H + h) * Dk;
    const T* kb = k + (b * S * H + h) * Dk;
    const T* wb = w + (b * S * H + h) * Dk;
    const T* vb = v + (b * S * H + h) * Dv;
    T* ob = out + (b * S * H + h) * Dv;

    // A round's operands pass through registers: neighbouring threads load
    // neighbouring elements of a staged row, so a row is one coalesced
    // load, and the next round's loads are in flight while this round
    // computes.
    const int kk = tid % kMaxDk;
    const int t_first = tid / kMaxDk;
    constexpr int kRowsAtOnce = kThreads / kMaxDk;
    float r_n[kRowsPerThread], k_n[kRowsPerThread], w_n[kRowsPerThread];
    float v_n[kVPerThread];
    auto prefetch = [&](int64_t t0) {
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
            const int64_t t = t0 + t_first + j * kRowsAtOnce;
            const bool ok = t < S && kk < Dk;
            const int64_t off = t * rk_step + kk;
            r_n[j] = ok ? to_float(rb[off]) : 0.0f;
            k_n[j] = ok ? to_float(kb[off]) : 0.0f;
            w_n[j] = ok ? to_float(wb[off]) : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < kVPerThread; ++j) {
            const int idx = tid + j * kThreads;
            const int tt = idx / kCols;
            const int64_t cc = col0 + idx % kCols;
            v_n[j] = (t0 + tt < S && cc < Dv)
                ? to_float(vb[(t0 + tt) * v_step + cc]) : 0.0f;
        }
    };

    prefetch(0);
    for (int64_t t0 = 0; t0 < S; t0 += kSteps) {
        const int n = static_cast<int>(S - t0 < kSteps ? S - t0 : kSteps);
        // every reader of the staged rows passed the barrier that ends the
        // previous round's steps
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
            const int tt = t_first + j * kRowsAtOnce;
            r_s[tt][kk] = r_n[j];
            k_s[tt][kk] = k_n[j];
            w_s[tt][kk] = w_n[j];
        }
#pragma unroll
        for (int j = 0; j < kVPerThread; ++j) {
            const int idx = tid + j * kThreads;
            v_s[idx / kCols][idx % kCols] = v_n[j];
        }
        __syncthreads();
        if (t0 + kSteps < S) {
            prefetch(t0 + kSteps);
        }

        for (int tt = 0; tt < n; ++tt) {
            const float vv = v_s[tt][c];
            float acc = 0.0f;
#pragma unroll
            for (int i = 0; i < kRowsPerLane; ++i) {
                const int row = i * kParts + part;
                if (row < Dk) {
                    const float kv = k_s[tt][row] * vv;
                    acc = fmaf(r_s[tt][row], fmaf(uu[i], kv, state[i]), acc);
                    // two rounded operations, as the plain version
                    state[i] = __fadd_rn(__fmul_rn(w_s[tt][row], state[i]),
                                         kv);
                }
            }
#pragma unroll
            for (int lane = 1; lane < kParts; lane *= 2) {
                acc += __shfl_xor_sync(0xffffffffu, acc, lane);
            }
            if (part == 0) {
                o_s[tt][c] = acc;
            }
        }
        __syncthreads();

#pragma unroll
        for (int j = 0; j < kVPerThread; ++j) {
            const int idx = tid + j * kThreads;
            const int tt = idx / kCols;
            const int64_t cc = col0 + idx % kCols;
            if (tt < n && cc < Dv) {
                ob[(t0 + tt) * v_step + cc] = from_float<T>(o_s[tt][idx % kCols]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) {
        const int row = i * kParts + part;
        if (live && row < Dk) {
            s_last[(head * Dk + row) * Dv + col] = state[i];
        }
    }
}

template <typename T>
int launch(const T* r, const T* k, const T* v, const T* w, const float* u,
           const float* s0, T* out, float* s_last, int64_t B, int64_t S,
           int64_t H, int64_t Dk, int64_t Dv, void* stream) {
    if (B <= 0 || H <= 0 || S < 0 || Dk <= 0 || Dv <= 0 || Dk > kMaxDk ||
        B > 65535 || H > 65535 || (Dv + kCols - 1) / kCols > 65535) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid(static_cast<unsigned>((Dv + kCols - 1) / kCols),
                    static_cast<unsigned>(H), static_cast<unsigned>(B));
    rwkv6_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        r, k, v, w, u, s0, out, s_last, S, H, static_cast<int>(Dk),
        static_cast<int>(Dv));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on `stream` without synchronising and returns a CUDA
// error code: 0 when the launch was accepted.  s0 may be null.
int rwkv6_f32(const float* r, const float* k, const float* v, const float* w,
              const float* u, const float* s0, float* out, float* s_last,
              int64_t B, int64_t S, int64_t H, int64_t Dk, int64_t Dv,
              void* stream) {
    return launch<float>(r, k, v, w, u, s0, out, s_last, B, S, H, Dk, Dv,
                         stream);
}

int rwkv6_bf16(const __nv_bfloat16* r, const __nv_bfloat16* k,
               const __nv_bfloat16* v, const __nv_bfloat16* w,
               const float* u, const float* s0, __nv_bfloat16* out,
               float* s_last, int64_t B, int64_t S, int64_t H, int64_t Dk,
               int64_t Dv, void* stream) {
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, out, s_last, B, S, H, Dk,
                                 Dv, stream);
}

}  // extern "C"
"""


if __name__ == "__main__":
    sys.exit(main())
