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
// float32 operations in the same order.  Built with --fmad=false, every
// multiply and add is rounded on its own as the plain version's are, so h
// and h_last equal the plain version's bit for bit.
//
// Design.  The TPU grid tiles (batch, 128 features) and walks time in a
// fori_loop with the state in VMEM.  The recurrence is independent per
// channel, and splitting one channel's chain across time would change its
// rounding (h_t = local_t + prod(a) h_start) and read x and a twice, so
// here one thread owns one channel (b, d) and walks all of time itself.
// At the serving shape that is only B*D = 8,192 chains, so the bytes in
// flight, not the threads, must hide the memory latency: each warp streams
// its 32 neighbouring channels through a ring of kStages tiles in shared
// memory, a tile being kSteps time rows of x and of a, filled by 16-byte
// `cp.async` copies kStages - 1 tiles ahead of the tile being computed
// (24 KB in flight a warp at the defaults).  The warp computes a tile from
// shared memory (a lane reads its own channel: no bank conflicts): first
// every b_t of the tile, which do not depend on h, then the chain, a
// multiply and an add a step, so the square roots' latency is paid once
// a tile and not once a step (the square root is a branch-free one that
// rounds as sqrtf does, shown on every float a in [0, 1] by the tests).
// It stages h in shared memory and writes it back as 16-byte stores.  The warps of
// a block are independent, so a warp synchronises with __syncwarp alone.
// Rows that are not 16-byte aligned (D * sizeof(T) not a multiple of 16,
// or an operand's address not 16-byte aligned) take the same ring with
// plain element loads and stores: the launch picks the path from the
// shapes and pointers.
//
// Bound.  The work is 2 loads and 1 store of the element type per (b, t, d)
// and about 8 float32 operations, so bytes bound it (about 0.09 ms for
// B=2, S=3072, D=4096 float32 at 3.35 TB/s).  The dependent chain of a
// channel is a multiply and an add per step (about 15 us over 3,072 steps),
// well under that.  Measured on an H100 (tools/rglru_sweep.py), it takes
// about 0.125 ms there, about 72 % of the memory rate.
//
// Build: see flash_attention.cu.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 1;         // warps per block, each on 32 channels
constexpr int kSteps = 32;        // time rows per tile
constexpr int kStages = 3;        // tiles in the ring
constexpr int kLanes = 32;
constexpr int kThreads = kWarps * kLanes;
static_assert(kStages >= 2, "a ring holds the tile in use and one ahead");
static_assert(kSteps % 8 == 0, "a tile's 16-byte chunks tile the warp");

template <typename T>
constexpr size_t smem_bytes() {
    // per warp: the ring (x and a) and the staged h
    return static_cast<size_t>(kWarps) * (2 * kStages + 1) * kSteps *
           kLanes * sizeof(T);
}

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

// sqrt(x) rounded to nearest, for x = 0 and for a normal x in [2^-100,
// 2^100]: an approximate reciprocal root and one Newton step put y within
// an ulp of the root, and Tuckerman's test picks the rounded root among y
// and its neighbours from the signs of y*up - x and y*down - x (exact
// signs through fmaf).  It has no branch: sqrtf checks for inputs outside
// that range with one, which would end a block of code at every step and
// serialise the steps' square roots.
__device__ __forceinline__ float sqrt_rn(float x) {
    float r;
    asm("rsqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
    float y = x * r;
    y = fmaf(fmaf(-y, y, x), 0.5f * r, y);
    const float up = __int_as_float(__float_as_int(y) + 1);
    const float down = __int_as_float(__float_as_int(y) - 1);
    y = fmaf(y, up, -x) < 0.0f ? up : (fmaf(y, down, -x) >= 0.0f ? down : y);
    return x > 0.0f ? y : 0.0f;
}

// sqrt(clip(1 - a^2, 0, 1)): b_t is this times x_t, and h_t = a_t h + b_t.
// The clipped value is 0 or at least 2^-24 (1 - a^2 for a float a^2 < 1),
// inside sqrt_rn's range, where it equals sqrtf.
__device__ __forceinline__ float gate(float a) {
    return sqrt_rn(fminf(fmaxf(1.0f - a * a, 0.0f), 1.0f));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(at),
                 "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// kVec: rows and pointers 16-byte aligned, so tiles move as 16-byte chunks
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const T* __restrict__ x, const T* __restrict__ a,
             const float* __restrict__ h0, T* __restrict__ h,
             T* __restrict__ h_last, int64_t S, int64_t D) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements a chunk
    constexpr int kChunks = kLanes / kPer;                   // chunks a row
    constexpr int kTile = kSteps * kLanes;                   // elements
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int warp = threadIdx.x / kLanes;
    const int lane = threadIdx.x % kLanes;
    T* const ring = reinterpret_cast<T*>(smem_raw) +
                    static_cast<int64_t>(warp) * (2 * kStages + 1) * kTile;
    T* const hs = ring + 2 * kStages * kTile;   // [kSteps][32]

    const int64_t d0 = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) *
                       kLanes;
    if (d0 >= D) {
        return;     // a whole warp past D (no block-wide barrier follows)
    }
    const int64_t bi = blockIdx.y;
    const int64_t d = d0 + lane;
    const bool live = d < D;
    const T* xb = x + bi * S * D + d0;
    const T* ab = a + bi * S * D + d0;
    T* hb = h + bi * S * D + d0;

    // tile `tile` into ring slot `slot`: rows t of x then of a
    auto load = [&](int64_t tile, int slot) {
        T* dst = ring + static_cast<int64_t>(slot) * 2 * kTile;
        const int64_t t0 = tile * kSteps;
        if constexpr (kVec) {
#pragma unroll
            for (int j = 0; j < 2 * kSteps * kChunks / kLanes; ++j) {
                const int c = lane + j * kLanes;
                const int arr = c / (kSteps * kChunks);
                const int tt = (c / kChunks) % kSteps;
                const int e = (c % kChunks) * kPer;
                if (t0 + tt < S && d0 + e < D) {
                    cp_async16(dst + arr * kTile + tt * kLanes + e,
                               (arr ? ab : xb) + (t0 + tt) * D + e);
                }
            }
        } else {
#pragma unroll 4
            for (int tt = 0; tt < kSteps; ++tt) {
                if (t0 + tt < S && live) {
                    dst[tt * kLanes + lane] = xb[(t0 + tt) * D + lane];
                    dst[kTile + tt * kLanes + lane] = ab[(t0 + tt) * D + lane];
                }
            }
        }
    };

    float state = (h0 != nullptr && live) ? h0[bi * D + d] : 0.0f;
    const int64_t tiles = (S + kSteps - 1) / kSteps;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < tiles) {
            load(s, s);
        }
        cp_async_commit();
    }
    for (int64_t tile = 0; tile < tiles; ++tile) {
        // the slot of tile - 1 was read by every lane before the barrier
        // that ended that tile's compute
        const int64_t ahead = tile + kStages - 1;
        if (ahead < tiles) {
            load(ahead, static_cast<int>(ahead % kStages));
        }
        cp_async_commit();
        cp_async_wait<kStages - 1>();   // this lane's copies of `tile`
        __syncwarp();                   // ... and every lane's
        const T* xs = ring + (tile % kStages) * 2 * kTile;
        const T* as = xs + kTile;
        const int64_t t0 = tile * kSteps;
        const int n = static_cast<int>(S - t0 < kSteps ? S - t0 : kSteps);
        // b_t of the whole tile first (independent of h), so the chain
        // below is a multiply and an add a step; rows past n are computed
        // from stale values and never written
        float av[kSteps], bv[kSteps];
#pragma unroll
        for (int tt = 0; tt < kSteps; ++tt) {
            av[tt] = to_float(as[tt * kLanes + lane]);
            bv[tt] = gate(av[tt]) * to_float(xs[tt * kLanes + lane]);
        }
#pragma unroll
        for (int tt = 0; tt < kSteps; ++tt) {
            if (tt < n) {
                state = av[tt] * state + bv[tt];
            }
            hs[tt * kLanes + lane] = from_float<T>(state);
        }
        __syncwarp();                   // hs is complete
        if constexpr (kVec) {
#pragma unroll
            for (int j = 0; j < kSteps * kChunks / kLanes; ++j) {
                const int c = lane + j * kLanes;
                const int tt = c / kChunks;
                const int e = (c % kChunks) * kPer;
                if (tt < n && d0 + e < D) {
                    *reinterpret_cast<uint4*>(hb + (t0 + tt) * D + e) =
                        *reinterpret_cast<const uint4*>(hs + tt * kLanes + e);
                }
            }
        } else {
            for (int tt = 0; tt < n; ++tt) {
                if (live) {
                    hb[(t0 + tt) * D + lane] = hs[tt * kLanes + lane];
                }
            }
        }
        // the next tile's compute overwrites hs only after the barrier
        // that follows its wait
    }
    cp_async_wait<0>();
    if (live) {
        h_last[bi * D + d] = from_float<T>(state);
    }
}

bool aligned16(const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, bool kVec>
int launch_as(const T* x, const T* a, const float* h0, T* h, T* h_last,
              int64_t B, int64_t S, int64_t D, cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<T>();
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            rglru_kernel<T, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) {
            return static_cast<int>(err);
        }
    }
    const int64_t per_block = static_cast<int64_t>(kWarps) * kLanes;
    const dim3 grid(static_cast<unsigned>((D + per_block - 1) / per_block),
                    static_cast<unsigned>(B));
    rglru_kernel<T, kVec><<<grid, kThreads, smem, stream>>>(x, a, h0, h,
                                                           h_last, S, D);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* x, const T* a, const float* h0, T* h, T* h_last,
           int64_t B, int64_t S, int64_t D, void* stream) {
    if (B <= 0 || D <= 0 || S < 0 || B > 65535 ||
        (D + kWarps * kLanes - 1) / (kWarps * kLanes) > 0x7fffffff) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if ((D * static_cast<int64_t>(sizeof(T))) % 16 == 0 && aligned16(x) &&
        aligned16(a) && aligned16(h)) {
        return launch_as<T, true>(x, a, h0, h, h_last, B, S, D, s);
    }
    return launch_as<T, false>(x, a, h0, h, h_last, B, S, D, s);
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
