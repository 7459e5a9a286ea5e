// RG-LRU scan for Hopper (sm_90a), bound through a plain C interface.
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
