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
// Design: time-parallel.  A step's walk keeps one carry,
// carry = a_t g_t (dh_last before the last step): g_t = dh_t + carry,
// then carry = g_t a_t.  Each channel's time axis is cut into chunks of
// kChunk steps, and a thread takes one (chunk, channel): neighbouring
// threads own neighbouring channels, so every load and store of a warp is
// one contiguous row segment, and path B's [1, 3072, 4096] gives 786,432
// threads where one thread a channel gave 4,096.  The carry leaving a
// chunk [lo, hi) is linear in the carry entering it:
//   carry_out = alpha + beta carry_in,
//   alpha = the chunk walked from a zero carry,  beta = prod_{lo..hi-1} a
// Three launches, each sum in one fixed order:
//   1. rglru_bwd_chunk_kernel: alpha and beta of every chunk but the
//      first (a and dh read, walked backwards; beta multiplied in the
//      same order);
//   2. rglru_bwd_carry_kernel: one thread a channel walks the summaries
//      from the last chunk, carry_in = dh_last there, then
//      carry_in_{j-1} = fmaf(beta_j, carry_in_j, alpha_j), loads issued
//      kBatch chunks ahead;
//   3. rglru_bwd_kernel: each chunk walked again from its true carry with
//      the per-step arithmetic above (a, x, h_{t-1} and dh loaded first, 4
//      * kChunk loads in flight a thread), dx and da stored; the first
//      chunk's final carry is dh0.
// A chain of one chunk (S <= kChunk) takes dh_last as it is, so at S = 1
// the arithmetic is the one-thread walk's, step for step.  No atomics and
// no look-back: two calls give the same bits.
//
// Bound.  The function reads x, a, h and dh and writes dx and da once, 6
// arrays of the element type, and does about 15 float32 operations per
// (b, t, d): bytes bound it (about 0.09 ms at B=1, S=3072, D=4096 float32
// on 3.35 TB/s).  This design reads a and dh twice (launches 1 and 3) and
// moves two float32 summaries a chunk: 8 arrays, about 0.12 ms there.
//
// Build: see flash_attention.cu.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;      // steps a chunk
constexpr int kBatch = 8;       // chunk summaries loaded ahead (launch 2)

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

// Launches 1 and 3 flatten (channel block, chunk) into blockIdx.x, the
// channel block fastest, and take b from blockIdx.y.
struct Place {
    int64_t d, j;
    bool ok;
};

__device__ __forceinline__ Place place(int64_t D, int64_t first_chunk) {
    const int64_t nbd = (D + kThreads - 1) / kThreads;
    const int64_t bx = blockIdx.x;
    const int64_t d = (bx % nbd) * kThreads + threadIdx.x;
    return {d, first_chunk + bx / nbd, d < D};
}

// alpha and beta of chunks 1 .. n_chunks - 1, [B, n_chunks, D] each
template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_chunk_kernel(const T* __restrict__ a, const T* __restrict__ dh,
                       float* __restrict__ alpha, float* __restrict__ beta,
                       int64_t S, int64_t D, int64_t n_chunks) {
    const Place p = place(D, 1);
    if (!p.ok) {
        return;
    }
    const int64_t b = blockIdx.y;
    const int64_t lo = p.j * kChunk;
    const int n = S - lo < kChunk ? static_cast<int>(S - lo) : kChunk;
    const int64_t base = b * S * D + p.d;
    float av[kChunk], gv[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
        if (i < n) {
            const int64_t at = base + (lo + i) * D;
            av[i] = to_float(a[at]);
            gv[i] = to_float(dh[at]);
        }
    }
    float carry = 0.0f, prod = 1.0f;
#pragma unroll
    for (int i = kChunk - 1; i >= 0; --i) {
        if (i < n) {
            const float g = gv[i] + carry;
            carry = g * av[i];
            prod = prod * av[i];
        }
    }
    const int64_t at = (b * n_chunks + p.j) * D + p.d;
    alpha[at] = carry;
    beta[at] = prod;
}

// carry_in of every chunk into alpha's place; dh0 = dh_last when S = 0
template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_carry_kernel(const T* __restrict__ dh_last,
                       float* __restrict__ alpha,
                       const float* __restrict__ beta,
                       float* __restrict__ dh0, int64_t D,
                       int64_t n_chunks) {
    const int64_t d = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
    if (d >= D) {
        return;
    }
    const int64_t b = blockIdx.y;
    const int64_t base = b * n_chunks * D + d;
    float c = dh_last != nullptr ? to_float(dh_last[b * D + d]) : 0.0f;
    for (int64_t j0 = n_chunks - 1; j0 >= 0; j0 -= kBatch) {
        float al[kBatch], be[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
            const int64_t j = j0 - i;
            if (j >= 1) {
                al[i] = alpha[base + j * D];
                be[i] = beta[base + j * D];
            }
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
            const int64_t j = j0 - i;
            if (j >= 0) {
                alpha[base + j * D] = c;        // carry into chunk j
                if (j >= 1) {
                    c = fmaf(be[i], c, al[i]);
                }
            }
        }
    }
    if (n_chunks == 0 && dh0 != nullptr) {
        dh0[b * D + d] = c;
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_kernel(const T* __restrict__ x, const T* __restrict__ a,
                 const float* __restrict__ h0, const T* __restrict__ h,
                 const T* __restrict__ dh, const float* __restrict__ carry_in,
                 T* __restrict__ dx, T* __restrict__ da,
                 float* __restrict__ dh0, int64_t S, int64_t D,
                 int64_t n_chunks) {
    const Place p = place(D, 0);
    if (!p.ok) {
        return;
    }
    const int64_t b = blockIdx.y;
    const int64_t d = p.d;
    const int64_t lo = p.j * kChunk;
    const int n = S - lo < kChunk ? static_cast<int>(S - lo) : kChunk;
    const int64_t base = b * S * D + d;
    // the gradient reaching h_t from later steps: a_{t+1} g_{t+1}, and
    // dh_last at t = S - 1
    float carry = carry_in[(b * n_chunks + p.j) * D + d];
    const float first = h0 != nullptr ? h0[b * D + d] : 0.f;
    float av[kChunk], xv[kChunk], hv[kChunk], gv[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
        if (i < n) {
            const int64_t at = base + (lo + i) * D;
            av[i] = to_float(a[at]);
            xv[i] = to_float(x[at]);
            gv[i] = to_float(dh[at]);
            hv[i] = lo + i > 0 ? to_float(h[at - D]) : first;
        }
    }
#pragma unroll
    for (int i = kChunk - 1; i >= 0; --i) {
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
    for (int i = 0; i < kChunk; ++i) {
        if (i < n) {
            const int64_t at = base + (lo + i) * D;
            dx[at] = from_float<T>(xv[i]);
            da[at] = from_float<T>(av[i]);
        }
    }
    if (p.j == 0 && dh0 != nullptr) {
        dh0[b * D + d] = carry;
    }
}

int64_t n_chunks_of(int64_t S) { return (S + kChunk - 1) / kChunk; }

template <typename T>
int launch(const T* x, const T* a, const float* h0, const T* h, const T* dh,
           const T* dh_last, float* scratch, T* dx, T* da, float* dh0,
           int64_t B, int64_t S, int64_t D, void* stream) {
    const int64_t nbd = (D + kThreads - 1) / kThreads;
    const int64_t n = n_chunks_of(S);
    if (B <= 0 || D <= 0 || S < 0 || B > 65535 || nbd > 0x7fffffff ||
        nbd * n > 0x7fffffff) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* const alpha = scratch;
    float* const beta = scratch + B * n * D;
    if (n > 1) {
        rglru_bwd_chunk_kernel<T><<<dim3(static_cast<unsigned>(nbd * (n - 1)),
                                         static_cast<unsigned>(B)),
                                    kThreads, 0, st>>>(a, dh, alpha, beta, S,
                                                       D, n);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) {
            return static_cast<int>(err);
        }
    }
    rglru_bwd_carry_kernel<T><<<dim3(static_cast<unsigned>(nbd),
                                     static_cast<unsigned>(B)),
                                kThreads, 0, st>>>(dh_last, alpha, beta, dh0,
                                                   D, n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n == 0) {
        return static_cast<int>(err);
    }
    rglru_bwd_kernel<T><<<dim3(static_cast<unsigned>(nbd * n),
                               static_cast<unsigned>(B)),
                          kThreads, 0, st>>>(x, a, h0, h, dh, alpha, dx, da,
                                             dh0, S, D, n);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on `stream` without synchronising and returns a CUDA
// error code: 0 when the launches were accepted.  h is the forward's
// output; h0, dh_last and dh0 may be null (no h0: dh0 is not written);
// scratch holds rglru_bwd_scratch_len(B, S, D) floats.
int rglru_bwd_f32(const float* x, const float* a, const float* h0,
                  const float* h, const float* dh, const float* dh_last,
                  float* scratch, float* dx, float* da, float* dh0,
                  int64_t B, int64_t S, int64_t D, void* stream) {
    return launch<float>(x, a, h0, h, dh, dh_last, scratch, dx, da, dh0, B,
                         S, D, stream);
}

int rglru_bwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* a,
                   const float* h0, const __nv_bfloat16* h,
                   const __nv_bfloat16* dh, const __nv_bfloat16* dh_last,
                   float* scratch, __nv_bfloat16* dx, __nv_bfloat16* da,
                   float* dh0, int64_t B, int64_t S, int64_t D,
                   void* stream) {
    return launch<__nv_bfloat16>(x, a, h0, h, dh, dh_last, scratch, dx, da,
                                 dh0, B, S, D, stream);
}

// The float32 scratch of the backward (alpha and beta of every chunk), in
// elements.
int64_t rglru_bwd_scratch_len(int64_t B, int64_t S, int64_t D) {
    return 2 * B * n_chunks_of(S) * D;
}

// The steps of a chunk.
int rglru_bwd_chunk_steps(void) { return kChunk; }

}  // extern "C"
