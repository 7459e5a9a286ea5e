"""Time ring shapes of the RG-LRU kernel on one NVIDIA GPU.

    python3 tools/rglru_sweep.py

Builds copies of `src/repro_torch/csrc/rglru.cu` with other ring
constants — tiles in the ring (kStages), time rows per tile (kSteps) and
warps per block (kWarps, 32 channels each) — and the kernel's previous
design, kept below as `BASELINE_SOURCE` (a thread per channel loading
its own 8 steps ahead, 64 channels a block), one nvcc each with the
library's flags, all at once, and prints each one's registers, spills
and shared memory for the float32 instantiations. Each is checked against
the plain version, h and h_last bit for bit, at recurrentgemma-9b's
serving shape (B=2, S=3072, D=4096 float32) with h0, at (B=1, S=33)
with D=96 and D=33 (the element-wise path), and at S=1 with x = 1 and a
= every float in [0, 1] (the gate of every a); a variant that does not
build, is refused at launch or disagrees is reported and left out. The
rest are timed at the serving shape without h0 with CUDA events after a
sleep that lets the host queue every launch (a warm-up, then the mean of
20 launches), every variant twice in turn, beside the bytes bound (x and
a read once, h and h_last written once, at 3.35 TB/s). The first variant
is the source's own ring. It also prints the SASS instruction counts of
the source's and the previous design's float32 kernels, and the SM clock
and power draw under the source's kernel.
"""
from __future__ import annotations

import ctypes
import os
import sys
import tempfile

import torch

import kernel_sweep as ks  # (beside this script) puts src/ on the path
from repro_torch.core._native import build_root  # noqa: E402
from repro_torch.kernels import rglru  # noqa: E402

# (kStages, kSteps, kWarps); the source's own first
VARIANTS = [(3, 32, 1), (4, 32, 1), (2, 32, 1), (5, 32, 1), (6, 32, 1),
            (3, 16, 1), (4, 16, 1), (6, 16, 1), (3, 32, 2), (3, 32, 4),
            (3, 64, 1), (7, 16, 1)]
SOURCE = {"kStages": 3, "kSteps": 32, "kWarps": 1}
BASELINE = "baseline"
MAIN = (2, 3072, 4096)
CHECKS = [MAIN, (1, 33, 96), (1, 33, 33)]
PEAK_BYTES_PER_S = 3.35e12
# the float32 instantiations' mangled names
ENTRY = "rglru_kernelIf"
ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]


def label(variant) -> str:
    if variant == BASELINE:
        return "previous design (a thread a channel, 8 steps ahead)"
    return "kStages={} kSteps={} kWarps={}".format(*variant)


def smem_kb(variant) -> str:
    if variant == BASELINE:
        return "no shared memory"
    stages, steps, warps = variant
    return f"{warps * (2 * stages + 1) * steps * 32 * 4 / 1024:g} KB shared"


def inputs(B, S, D, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, S, D), generator=g, device="cuda")
    a = torch.rand((B, S, D), generator=g, device="cuda") * 0.94 + 0.05
    h0 = torch.randn((B, D), generator=g, device="cuda")
    return x, a, h0


class Case:
    """One shape's inputs, the plain version's outputs and a caller."""

    def __init__(self, shape, with_h0: bool, xa=None):
        self.shape = shape
        if xa is None:
            self.x, self.a, h0 = inputs(*shape)
        else:
            (self.x, self.a), h0 = xa, None
        self.h0 = h0 if with_h0 else None
        self.want_h, self.want_last = rglru.rglru_plain(self.x, self.a,
                                                        self.h0)
        self.h = torch.empty_like(self.x)
        self.last = torch.empty_like(self.want_last)

    def call(self, fn) -> int:
        return fn(self.x.data_ptr(), self.a.data_ptr(),
                  self.h0.data_ptr() if self.h0 is not None else None,
                  self.h.data_ptr(), self.last.data_ptr(), *self.shape,
                  torch.cuda.current_stream().cuda_stream)

    def check(self, fn) -> str | None:
        """None when the variant equals the plain version, else why."""
        self.h.fill_(float("nan"))
        rc = self.call(fn)
        if rc != 0:
            return f"launch refused (CUDA error {rc})"
        torch.cuda.synchronize()
        if not (torch.equal(self.h, self.want_h)
                and torch.equal(self.last, self.want_last)):
            err = float((self.h - self.want_h).abs().max())
            return f"differs from the plain version ({err!r}) at {self.shape}"
        return None


def every_a() -> Case:
    """S = 1, x = 1 and a = every float in [0, 1], with -0.5, 1.5 and 2 (D
    then a multiple of 4): h is the gate sqrt(clip(1 - a^2, 0, 1)) of every
    a the recurrence can see, held bit for bit."""
    a = torch.arange(0, 0x3F800001, dtype=torch.int32, device="cuda")
    a = torch.cat([a.view(torch.float32),
                   torch.tensor([-0.5, 1.5, 2.0], device="cuda")])
    a = a.view(1, 1, -1)
    return Case(tuple(a.shape), False, (torch.ones_like(a), a))


def main() -> int:
    if not torch.cuda.is_available():
        print("rglru_sweep: no CUDA device", file=sys.stderr)
        return 1
    print(ks.card_line(), flush=True)
    with open(os.path.join(ks.CSRC, "rglru.cu")) as f:
        text = f.read()
    with tempfile.TemporaryDirectory(dir=build_root()) as tmp:
        built = ks.build(tmp, {
            v: BASELINE_SOURCE if v == BASELINE
            else ks.set_constants(text, SOURCE, v)
            for v in VARIANTS + [BASELINE]}, label)
        libs = {}
        for variant, (so, log) in built.items():
            print(f"variant {label(variant)}: "
                  f"{ks.ptxas_report(log, ENTRY)} ({smem_kb(variant)})",
                  flush=True)
            if variant in (VARIANTS[0], BASELINE):
                print(f"sass {label(variant)}: {ks.sass_counts(so, ENTRY)}",
                      flush=True)
            libs[variant] = ks.entry(so, "rglru_f32", ARGTYPES)
        checks = [Case(shape, True) for shape in CHECKS] + [every_a()]
        for variant, fn in list(libs.items()):
            why = next((w for w in (c.check(fn) for c in checks) if w),
                       None)
            if why is not None:
                print(f"variant {label(variant)}: left out: {why}",
                      flush=True)
                del libs[variant]
        del checks
        main_case = Case(MAIN, False)
        B, S, D = MAIN
        bound = 4 * (3 * B * S * D + B * D) / PEAK_BYTES_PER_S * 1e3
        print(f"shape x, a [{B},{S},{D}] float32, no h0 (bound {bound!r} ms, "
              f"bytes); h and h_last equal to the plain version for every "
              f"variant timed", flush=True)
        for _ in range(2):
            for variant, fn in libs.items():
                ms = ks.cuda_ms(lambda fn=fn: main_case.call(fn), 20)
                print(f"  {label(variant)}: {ms!r} ms", flush=True)
        if VARIANTS[0] in libs:
            fn = libs[VARIANTS[0]]
            print(f"under load, {label(VARIANTS[0])}: "
                  f"{ks.clock_under_load(lambda: main_case.call(fn))}",
                  flush=True)
    return 0


# The previous design of csrc/rglru.cu, built as the baseline variant.
BASELINE_SOURCE = r"""// RG-LRU scan for Hopper (sm_90a), bound through a plain C interface.
//
// Replaces the TPU kernel `_rglru_kernel` of the JAX package
// (src/repro/kernels/rglru.py:25, launched at :55).
//
// What it computes: for x, a [B, S, D] and an optional h0 [B, D] (float32;
// zeros when absent), per channel (b, d) and t = 0 .. S-1:
//     b_t = sqrt(clip(1 - a_t^2, 0, 1)) * x_t
//     h_t = a_t * h_{t-1} + b_t
// in float32, with h_t written to h [B, S, D] and the last state to
// h_last [B, D], both in the input's type.  The TPU wrapper computes b_t
// outside its kernel (src/repro/kernels/rglru.py:49-50); this kernel
// computes it inside, from the a_t and x_t it has loaded, with the same
// float32 operations.  Built with --fmad=false, a*h + b is a multiply and
// an add, rounded as the plain version's two operations are.
//
// Design.  The TPU grid tiles (batch, 128 features) and walks time in a
// fori_loop with the state in VMEM.  The recurrence is independent per
// channel, so here one thread owns one channel (b, d), keeps h in a
// register and walks time itself; the 64 threads of a block own 64
// neighbouring channels, so each time step's loads and stores are
// coalesced.  The loop is unrolled by 8 with the loads of the 8 steps
// issued before the dependent chain, so that several loads are in flight.
//
// Bound.  The work is 2 loads and 1 store of the element type per (b, t, d)
// and about 7 float32 operations, so bytes bound it on paper (about
// 0.09 ms for B=2, S=3072, D=4096 at 3.35 TB/s).  In practice it is bound
// by latency: only B*D chains (8,192 at the serving shape, about 2 warps
// per SM) walk S dependent steps, too few to cover the memory latency.
// A chunked scan across time would add parallelism; not done here.
//
// Build: see flash_attention.cu.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 8;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
    return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

__device__ __forceinline__ float step(float h, float a, float x) {
    const float b = sqrtf(fminf(fmaxf(1.0f - a * a, 0.0f), 1.0f)) * x;
    return a * h + b;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const T* __restrict__ x, const T* __restrict__ a,
             const float* __restrict__ h0, T* __restrict__ h,
             T* __restrict__ h_last, int64_t S, int64_t D) {
    const int64_t d = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    const int64_t bi = blockIdx.y;
    if (d >= D) {
        return;
    }
    const int64_t base = bi * S * D + d;
    float state = (h0 != nullptr) ? h0[bi * D + d] : 0.0f;
    int64_t t = 0;
    for (; t + kUnroll <= S; t += kUnroll) {
        float av[kUnroll];
        float xv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            av[u] = to_float(a[base + (t + u) * D]);
            xv[u] = to_float(x[base + (t + u) * D]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            state = step(state, av[u], xv[u]);
            h[base + (t + u) * D] = from_float<T>(state);
        }
    }
    for (; t < S; ++t) {
        state = step(state, to_float(a[base + t * D]), to_float(x[base + t * D]));
        h[base + t * D] = from_float<T>(state);
    }
    h_last[bi * D + d] = from_float<T>(state);
}

template <typename T>
int launch(const T* x, const T* a, const float* h0, T* h, T* h_last,
           int64_t B, int64_t S, int64_t D, void* stream) {
    if (B <= 0 || D <= 0 || S < 0 || B > 65535) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid(static_cast<unsigned>((D + kThreads - 1) / kThreads),
                    static_cast<unsigned>(B));
    rglru_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, a, h0, h, h_last, S, D);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on `stream` without synchronising and returns a CUDA
// error code: 0 when the launch was accepted.  h0 may be null.
int rglru_f32(const float* x, const float* a, const float* h0, float* h,
              float* h_last, int64_t B, int64_t S, int64_t D, void* stream) {
    return launch<float>(x, a, h0, h, h_last, B, S, D, stream);
}

int rglru_bf16(const __nv_bfloat16* x, const __nv_bfloat16* a,
               const float* h0, __nv_bfloat16* h, __nv_bfloat16* h_last,
               int64_t B, int64_t S, int64_t D, void* stream) {
    return launch<__nv_bfloat16>(x, a, h0, h, h_last, B, S, D, stream);
}

}  // extern "C"
"""


if __name__ == "__main__":
    sys.exit(main())
