// RG-LRU scan backward for Hopper (sm_90a), bound through a plain C
// interface.
//
// The TPU kernel `_rglru_kernel` of the JAX package
// (src/repro/kernels/rglru.py:25, launched at :55) has no backward: the
// JAX package trains by differentiating its plain version `rglru_ref`
// (src/repro/kernels/ops.py).  This file computes the same gradient for
// the forward kernel of rglru.cu.  With c(a) = sqrt(clip(1 - a^2, 0, 1)),
// h_t = a_t h_{t-1} + c(a_t) x_t and the cotangents dh [B, S, D] of h and
// dh_last [B, D] of h_last = h_{S-1}, per channel (b, d), backwards in t:
//
//   g_t  = dh_t + a_{t+1} g_{t+1}        (g_{S-1} = dh_{S-1} + dh_last)
//   dx_t = g_t c(a_t)
//   da_t = g_t h_{t-1} + g_t x_t c'(a_t)
//   dh0  = a_0 g_0                        (h_{-1} = h0, or 0)
//
// in float32, h_{t-1} read from the forward's saved h.  c'(a) is taken as
// the plain version's autograd takes it, one rule at a time: sqrt's
// gradient G / (2 c) (infinite, or NaN for G = 0, where c = 0, at a = +-1),
// clip's gradient passed where 0 <= 1 - a^2 <= 1 and 0 elsewhere, and the
// two factors of a*a adding G' a each.
//
// Design.  One thread walks one channel's chain, as in the forward;
// neighbouring threads own neighbouring channels, so every load and store
// of a warp is one contiguous row segment.  The chain is cut into rounds
// of kSteps steps: a round first loads its a, x, h_{t-1} and dh (4 *
// kSteps independent loads in flight a thread), then runs the chain, then
// stores dx and da.
//
// Bound.  4 loads and 2 stores of the element type per (b, t, d) and
// about 15 float32 operations: bytes bound it (about 0.09 ms at B=1,
// S=3072, D=4096 float32 on 3.35 TB/s).
//
// Build: see flash_attention.cu.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSteps = 16;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_kernel(const T* __restrict__ x, const T* __restrict__ a,
                 const float* __restrict__ h0, const T* __restrict__ h,
                 const T* __restrict__ dh, const T* __restrict__ dh_last,
                 T* __restrict__ dx, T* __restrict__ da,
                 float* __restrict__ dh0, int64_t S, int64_t D) {
    const int64_t d = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
    if (d >= D) {
        return;
    }
    const int64_t b = blockIdx.y;
    const int64_t base = b * S * D + d;
    // the gradient reaching h_t from later steps: a_{t+1} g_{t+1}, and
    // dh_last at t = S - 1
    float carry = dh_last != nullptr ? to_float(dh_last[b * D + d]) : 0.f;
    const float first = h0 != nullptr ? h0[b * D + d] : 0.f;
    for (int64_t hi = S; hi > 0; hi -= kSteps) {
        const int64_t lo = hi - kSteps > 0 ? hi - kSteps : 0;
        const int n = static_cast<int>(hi - lo);
        float av[kSteps], xv[kSteps], hv[kSteps], gv[kSteps];
#pragma unroll
        for (int i = 0; i < kSteps; ++i) {
            if (i < n) {
                const int64_t at = base + (lo + i) * D;
                av[i] = to_float(a[at]);
                xv[i] = to_float(x[at]);
                gv[i] = to_float(dh[at]);
                hv[i] = lo + i > 0 ? to_float(h[at - D]) : first;
            }
        }
#pragma unroll
        for (int i = kSteps - 1; i >= 0; --i) {
            if (i < n) {
                const float ai = av[i];
                const float g = gv[i] + carry;
                const float v = 1.0f - ai * ai;
                const float c = sqrtf(fminf(fmaxf(v, 0.0f), 1.0f));
                // sqrt's gradient, then clip's
                const float gc = (v >= 0.0f && v <= 1.0f)
                                     ? (g * xv[i]) / (2.0f * c) : 0.0f;
                const float gaa = -gc;          // of a*a: -(d/dv)
                xv[i] = g * c;                  // dx_t
                av[i] = g * hv[i] + (gaa * ai + gaa * ai);   // da_t
                carry = g * ai;
            }
        }
#pragma unroll
        for (int i = 0; i < kSteps; ++i) {
            if (i < n) {
                const int64_t at = base + (lo + i) * D;
                dx[at] = from_float<T>(xv[i]);
                da[at] = from_float<T>(av[i]);
            }
        }
    }
    if (dh0 != nullptr) {
        dh0[b * D + d] = carry;
    }
}

template <typename T>
int launch(const T* x, const T* a, const float* h0, const T* h, const T* dh,
           const T* dh_last, T* dx, T* da, float* dh0, int64_t B, int64_t S,
           int64_t D, void* stream) {
    if (B <= 0 || D <= 0 || S < 0 || B > 65535 ||
        (D + kThreads - 1) / kThreads > 0x7fffffff) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid(static_cast<unsigned>((D + kThreads - 1) / kThreads),
                    static_cast<unsigned>(B));
    rglru_bwd_kernel<T><<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        x, a, h0, h, dh, dh_last, dx, da, dh0, S, D);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on `stream` without synchronising and returns a CUDA
// error code: 0 when the launch was accepted.  h is the forward's output;
// h0, dh_last and dh0 may be null (no h0: dh0 is not written).
int rglru_bwd_f32(const float* x, const float* a, const float* h0,
                  const float* h, const float* dh, const float* dh_last,
                  float* dx, float* da, float* dh0, int64_t B, int64_t S,
                  int64_t D, void* stream) {
    return launch<float>(x, a, h0, h, dh, dh_last, dx, da, dh0, B, S, D,
                         stream);
}

int rglru_bwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* a,
                   const float* h0, const __nv_bfloat16* h,
                   const __nv_bfloat16* dh, const __nv_bfloat16* dh_last,
                   __nv_bfloat16* dx, __nv_bfloat16* da, float* dh0,
                   int64_t B, int64_t S, int64_t D, void* stream) {
    return launch<__nv_bfloat16>(x, a, h0, h, dh, dh_last, dx, da, dh0, B,
                                 S, D, stream);
}

}  // extern "C"
