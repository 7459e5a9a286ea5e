// RWKV6 (Finch) WKV scan for Hopper (sm_90a), bound through a plain C
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
