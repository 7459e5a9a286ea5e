// RWKV6 (Finch) WKV scan backward for Hopper (sm_90a), bound through a
// plain C interface.
//
// The TPU kernel `_rwkv6_kernel` of the JAX package
// (src/repro/kernels/rwkv6.py:28, launched at :68) has no backward: the
// JAX package trains by differentiating its plain forms (`rwkv6_chunked`,
// src/repro/kernels/ops.py:133-157).  This file computes the gradient of
// the forward kernel of rwkv6.cu.  With P_t the state before step t
// (P_0 = s0, or zeros), per head (b, h):
//     out_t = r_t (P_t + u ⊙ k_t^T v_t),   P_{t+1} = diag(w_t) P_t + k_t^T v_t
// and G_t = dL/dP_{t+1} (G_{S-1} = dS_last, or zeros), backwards in t:
//     dr_t = P_t dout_t^T + u ⊙ k_t (v_t · dout_t)
//     dk_t = G_t v_t^T     + r_t ⊙ u (v_t · dout_t)
//     dv_t = k_t G_t       + (sum_i r_t u k_t) dout_t
//     dw_t = sum_j G_t[:, j] ⊙ P_t[:, j]
//     du   = sum_{b,t} r_t ⊙ k_t (v_t · dout_t)
//     G_{t-1} = diag(w_t) G_t + r_t^T dout_t,   ds0 = G_{-1}
// in float32, whatever the input type; dout and dS_last may be absent
// (zeros).  Nothing here divides by w, so w = 0 and tiny w are as safe as
// any other: P_t comes from the forward's checkpoints, not from running
// the state backwards.
//
// Design.  Three kernels, launched in order on one stream by one entry.
//
// 1. rwkv6_bwd_state_kernel walks the state and its gradient.  A block
//    holds 16 columns of one head's state (grid ceil(Dv/16) x H x B, so
//    B=1 at rwkv6-7b's width still gives 256 blocks) with two threads a
//    row, each owning 8 columns of P and of G in registers.  It walks the
//    forward's checkpoint intervals (kCkptSteps = 16 steps) in
//    reverse: it stages the interval's r, k, w rows and the block's v and
//    dout columns in shared memory (loaded into registers one interval
//    ahead), reloads P from the interval's checkpoint, recomputes the
//    interval's states forward with the forward's rounding (so they are
//    the forward's states bit for bit) into a thread-private slice of
//    shared memory, then runs the interval's steps backwards.  Per step a
//    thread adds its 8 columns' shares of P_t dout_t, G_t v_t and
//    G_t ⊙ P_t, its row partner adds the other 8 (one shuffle each), and
//    the pair writes the block's share of the three row sums; k_t G_t is
//    summed over the warp's 16 rows by a reduce-scatter shuffle tree (8
//    shuffles a thread), and over the block's 4 warps once an interval.
// 2. rwkv6_bwd_reduce_kernel adds the column groups' shares of dr, dk and
//    dw in group order, and the u terms, which depend on (b, t, h) alone
//    (v_t · dout_t and sum_i r_t u k_t, one warp a step), and writes the
//    gradients in the input type; each warp keeps its own steps' share of
//    du.
// 3. rwkv6_bwd_du_kernel adds those shares in a fixed order.
// No atomics anywhere, and every sum has one order: two calls give the
// same bits.
//
// Bound.  Per (b, t, h) the gradient reads r, k, w, v and dout once and
// writes dr, dk, dv and dw once, and takes about 13*Dk*Dv float32
// operations (the recompute's 3, dr's, dk's and dw's multiply-add pairs,
// dv's 2 and G's 3): at one rwkv6-7b layer (B=1, S=4096, H=64, Dk=Dv=64)
// 0.60 GB (0.18 ms at 3.35 TB/s) against 1.4e10 operations (0.21 ms at 67
// TFLOP/s), so operations bound it.  This design moves more than that: it
// reads the checkpoints (Dk*Dv*4 bytes every 16 steps, 0.27 GB at that
// shape), writes and reads the column groups' row sums (3 x 4 float32
// shares a row, about 0.8 GB) and keeps two warps an SM's scheduler; its
// time is in PERF.md.
//
// Build: see flash_attention.cu.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rwkv6_common.cuh"

namespace {

constexpr int kMaxDk = 64;              // rows of the state (the forward's)
constexpr int kChunk = kCkptSteps;      // steps an interval
constexpr int kCols = 8;                // state columns a thread
constexpr int kThreads = 2 * kMaxDk;    // two threads a row
constexpr int kBlockCols = 2 * kCols;   // state columns a block
constexpr int kWarps = kThreads / 32;
constexpr int kRkwPerThread = kChunk * kMaxDk / kThreads;    // of r, k, w
constexpr int kVdPerThread = kChunk * kBlockCols / kThreads;  // of v, dout
constexpr int kRedWarps = 8;            // reduce kernel: warps a block
constexpr int kRedSteps = 64;           // reduce kernel: steps a block

static_assert(kCols == 8, "the dv shuffle tree halves 8 values 3 times");
static_assert(kThreads % kMaxDk == 0 && kThreads % kBlockCols == 0,
              "threads tile a staged row");
static_assert(kRedSteps % kRedWarps == 0, "warps share a block's steps");

// shared memory of the state kernel, in floats: the thread-private states
// of an interval [kChunk][2 float4s][kThreads] (a warp's float4s are
// contiguous), the staged r, k, w [3][kChunk][kMaxDk] and v, dout
// [2][kChunk][kBlockCols], and the warps' dv shares [kWarps][kChunk]
// [kBlockCols]
constexpr int kPFloats = kChunk * kCols * kThreads;
constexpr int kRkwFloats = 3 * kChunk * kMaxDk;
constexpr int kVdFloats = 2 * kChunk * kBlockCols;
constexpr int kDvFloats = kWarps * kChunk * kBlockCols;
constexpr size_t kSmemBytes =
    sizeof(float) * (kPFloats + kRkwFloats + kVdFloats + kDvFloats);

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

// The sum over a warp's 32 lanes, every lane ending with the same bits.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
        x += __shfl_xor_sync(0xffffffffu, x, off);
    }
    return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rwkv6_bwd_state_kernel(const T* __restrict__ r, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ w,
                       const T* __restrict__ dout,
                       const float* __restrict__ ds_last,
                       const float* __restrict__ ckpt,
                       float* __restrict__ part, float* __restrict__ dv_state,
                       float* __restrict__ ds0, int64_t S, int64_t H, int Dk,
                       int Dv) {
    extern __shared__ __align__(16) float smem[];
    float4* const p_s = reinterpret_cast<float4*>(smem);   // [kChunk][2][T]
    float* const rkw_s = smem + kPFloats;                   // [3][kChunk][64]
    float* const vd_s = rkw_s + kRkwFloats;                 // [2][kChunk][16]
    float* const dv_s = vd_s + kVdFloats;                   // [W][kChunk][16]

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int row = tid / 2;
    const int half = tid % 2;
    const int64_t cg = blockIdx.x;
    const int64_t ncg = gridDim.x;
    const int64_t h = blockIdx.y;
    const int64_t b = blockIdx.z;
    const int64_t head = b * H + h;
    const int64_t bcol0 = cg * kBlockCols;          // the block's first column
    const int64_t col0 = bcol0 + half * kCols;      // this thread's first
    const int64_t n_ckpt = (S + kChunk - 1) / kChunk;
    const int64_t n_rows = static_cast<int64_t>(gridDim.z) * S * H * Dk;

    // what a thread stages: r, k, w at row kk of steps s_rkw + j * stride,
    // v and dout at column cc of steps s_vd + j * stride
    const int kk = tid % kMaxDk;
    const int s_rkw = tid / kMaxDk;
    constexpr int kRkwStride = kThreads / kMaxDk;
    const int cc = tid % kBlockCols;
    const int s_vd = tid / kBlockCols;
    constexpr int kVdStride = kThreads / kBlockCols;
    float r_n[kRkwPerThread], k_n[kRkwPerThread], w_n[kRkwPerThread];
    float v_n[kVdPerThread], d_n[kVdPerThread], p_n[kCols];
    auto prefetch = [&](int64_t n) {
        const int64_t t0 = n * kChunk;
        const int64_t left = S - t0;
#pragma unroll
        for (int j = 0; j < kRkwPerThread; ++j) {
            const int s = s_rkw + j * kRkwStride;
            const bool ok = kk < Dk && s < left;
            const int64_t at = ((b * S + t0 + s) * H + h) * Dk + kk;
            r_n[j] = ok ? to_float(r[at]) : 0.0f;
            k_n[j] = ok ? to_float(k[at]) : 0.0f;
            w_n[j] = ok ? to_float(w[at]) : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < kVdPerThread; ++j) {
            const int s = s_vd + j * kVdStride;
            const bool ok = bcol0 + cc < Dv && s < left;
            const int64_t at = ((b * S + t0 + s) * H + h) * Dv + bcol0 + cc;
            v_n[j] = ok ? to_float(v[at]) : 0.0f;
            d_n[j] = ok && dout != nullptr ? to_float(dout[at]) : 0.0f;
        }
        const float* cp = ckpt + ((head * n_ckpt + n) * Dk + row) *
                                     static_cast<int64_t>(Dv);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
            p_n[c] = row < Dk && col0 + c < Dv ? cp[col0 + c] : 0.0f;
        }
    };

    float G[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
        G[c] = ds_last != nullptr && row < Dk && col0 + c < Dv
            ? ds_last[(head * Dk + row) * Dv + col0 + c] : 0.0f;
    }

    prefetch(n_ckpt - 1);
    for (int64_t n = n_ckpt - 1; n >= 0; --n) {
        // every reader of the staged rows and of dv_s is past the previous
        // interval
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kRkwPerThread; ++j) {
            const int at = (s_rkw + j * kRkwStride) * kMaxDk + kk;
            rkw_s[at] = r_n[j];
            rkw_s[kChunk * kMaxDk + at] = k_n[j];
            rkw_s[2 * kChunk * kMaxDk + at] = w_n[j];
        }
#pragma unroll
        for (int j = 0; j < kVdPerThread; ++j) {
            const int at = (s_vd + j * kVdStride) * kBlockCols + cc;
            vd_s[at] = v_n[j];
            vd_s[kChunk * kBlockCols + at] = d_n[j];
        }
        float P[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
            P[c] = p_n[c];
        }
        __syncthreads();
        if (n > 0) {
            prefetch(n - 1);     // in flight while this interval runs
        }
        const int64_t t0 = n * kChunk;
        const int len = S - t0 < kChunk ? static_cast<int>(S - t0) : kChunk;
        const float* rs = rkw_s + row;
        const float* ks = rkw_s + kChunk * kMaxDk + row;
        const float* ws = rkw_s + 2 * kChunk * kMaxDk + row;
        const float* vs = vd_s + half * kCols;
        const float* ds = vd_s + kChunk * kBlockCols + half * kCols;

        // the interval's states P_t, as the forward rounds them
#pragma unroll
        for (int s = 0; s < kChunk; ++s) {
            if (s < len) {
                p_s[(s * 2) * kThreads + tid] =
                    make_float4(P[0], P[1], P[2], P[3]);
                p_s[(s * 2 + 1) * kThreads + tid] =
                    make_float4(P[4], P[5], P[6], P[7]);
                const float kr = ks[s * kMaxDk];
                const float wr = ws[s * kMaxDk];
#pragma unroll
                for (int c = 0; c < kCols; ++c) {
                    P[c] = __fadd_rn(__fmul_rn(wr, P[c]),
                                     kr * vs[s * kBlockCols + c]);
                }
            }
        }

        // its steps backwards
#pragma unroll
        for (int s = kChunk - 1; s >= 0; --s) {
            if (s < len) {
                const float4 p0 = p_s[(s * 2) * kThreads + tid];
                const float4 p1 = p_s[(s * 2 + 1) * kThreads + tid];
                const float Pt[kCols] = {p0.x, p0.y, p0.z, p0.w,
                                         p1.x, p1.y, p1.z, p1.w};
                const float rr = rs[s * kMaxDk];
                const float kr = ks[s * kMaxDk];
                const float wr = ws[s * kMaxDk];
                float a_dr = 0.0f, a_dk = 0.0f, a_dw = 0.0f;
                float kg[kCols];
#pragma unroll
                for (int c = 0; c < kCols; ++c) {
                    const float vv = vs[s * kBlockCols + c];
                    const float dd = ds[s * kBlockCols + c];
                    a_dr = fmaf(Pt[c], dd, a_dr);
                    a_dk = fmaf(G[c], vv, a_dk);
                    a_dw = fmaf(G[c], Pt[c], a_dw);
                    kg[c] = kr * G[c];
                    G[c] = fmaf(wr, G[c], rr * dd);       // G_{t-1}
                }
                // the row's other 8 columns
                a_dr += __shfl_xor_sync(0xffffffffu, a_dr, 1);
                a_dk += __shfl_xor_sync(0xffffffffu, a_dk, 1);
                a_dw += __shfl_xor_sync(0xffffffffu, a_dw, 1);
                if (half == 0 && row < Dk) {
                    const int64_t at = ((b * S + t0 + s) * H + h) * Dk + row;
                    part[(0 * ncg + cg) * n_rows + at] = a_dr;
                    part[(1 * ncg + cg) * n_rows + at] = a_dk;
                    part[(2 * ncg + cg) * n_rows + at] = a_dw;
                }
                // k_t G_t over the warp's 16 rows (lane bits 1..4), as a
                // reduce-scatter: at lane bit 4, 3 and 2 the lane keeps half
                // of its values (the upper half when the bit is set) and
                // adds its partner's copy of them, then bit 1 adds the last
                // value whole.  The lane ends with column 4*b4 + 2*b3 + b2
                // of its half.
#pragma unroll
                for (int lv = 0; lv < 3; ++lv) {
                    const int bit = 4 - lv;
                    const int hv = 4 >> lv;
                    const bool hi = (lane >> bit) & 1;
#pragma unroll
                    for (int j = 0; j < hv; ++j) {
                        const float send = hi ? kg[j] : kg[j + hv];
                        const float keep = hi ? kg[j + hv] : kg[j];
                        kg[j] = keep +
                                __shfl_xor_sync(0xffffffffu, send, 1 << bit);
                    }
                }
                kg[0] += __shfl_xor_sync(0xffffffffu, kg[0], 2);
                if (((lane >> 1) & 1) == 0) {
                    const int col = 4 * ((lane >> 4) & 1) +
                                    2 * ((lane >> 3) & 1) + ((lane >> 2) & 1);
                    dv_s[(warp * kChunk + s) * kBlockCols + half * kCols +
                         col] = kg[0];
                }
            }
        }
        __syncthreads();
        // the warps' shares of k_t G_t, in warp order
        for (int o = tid; o < kChunk * kBlockCols; o += kThreads) {
            const int s = o / kBlockCols;
            const int c = o % kBlockCols;
            if (s < len && bcol0 + c < Dv) {
                float sum = dv_s[s * kBlockCols + c];
#pragma unroll
                for (int wp = 1; wp < kWarps; ++wp) {
                    sum += dv_s[(wp * kChunk + s) * kBlockCols + c];
                }
                dv_state[((b * S + t0 + s) * H + h) * Dv + bcol0 + c] = sum;
            }
        }
    }
    if (ds0 != nullptr && row < Dk) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
            if (col0 + c < Dv) {
                ds0[(head * Dk + row) * Dv + col0 + c] = G[c];
            }
        }
    }
}

// One warp a step (b, t, h): the column groups' shares of dr, dk, dw added
// in group order, the u terms, dv's two parts; the warp's share of du over
// its steps into du_part [B * gridDim.x * kRedWarps][H][Dk].
template <typename T>
__global__ void __launch_bounds__(kRedWarps * 32)
rwkv6_bwd_reduce_kernel(const T* __restrict__ r, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ u,
                        const float* __restrict__ part,
                        const float* __restrict__ dv_state,
                        T* __restrict__ dr, T* __restrict__ dk,
                        T* __restrict__ dv, T* __restrict__ dw,
                        float* __restrict__ du_part, int64_t S, int64_t H,
                        int Dk, int Dv, int ncg) {
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    const int64_t tb = blockIdx.x;
    const int64_t h = blockIdx.y;
    const int64_t b = blockIdx.z;
    const int64_t n_rows = static_cast<int64_t>(gridDim.z) * S * H * Dk;
    constexpr int kSlots = kMaxDk / 32;
    float ui[kSlots], du_acc[kSlots];
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
        const int i = lane + 32 * q;
        ui[q] = i < Dk ? u[h * Dk + i] : 0.0f;
        du_acc[q] = 0.0f;
    }
    for (int m = 0; m < kRedSteps / kRedWarps; ++m) {
        const int64_t t = tb * kRedSteps + warp + m * kRedWarps;
        if (t >= S) {
            break;
        }
        const int64_t row = (b * S + t) * H + h;
        float vd = 0.0f;
        if (dout != nullptr) {
            for (int j = lane; j < Dv; j += 32) {
                vd = fmaf(to_float(v[row * Dv + j]),
                          to_float(dout[row * Dv + j]), vd);
            }
        }
        vd = warp_sum(vd);
        float ri[kSlots], ki[kSlots];
        float ruk = 0.0f;
#pragma unroll
        for (int q = 0; q < kSlots; ++q) {
            const int i = lane + 32 * q;
            ri[q] = i < Dk ? to_float(r[row * Dk + i]) : 0.0f;
            ki[q] = i < Dk ? to_float(k[row * Dk + i]) : 0.0f;
            ruk = fmaf(ri[q] * ui[q], ki[q], ruk);
        }
        ruk = warp_sum(ruk);
#pragma unroll
        for (int q = 0; q < kSlots; ++q) {
            const int i = lane + 32 * q;
            if (i < Dk) {
                const int64_t at = row * Dk + i;
                float s_dr = 0.0f, s_dk = 0.0f, s_dw = 0.0f;
                for (int g = 0; g < ncg; ++g) {
                    s_dr += part[(0 * static_cast<int64_t>(ncg) + g) * n_rows
                                 + at];
                    s_dk += part[(1 * static_cast<int64_t>(ncg) + g) * n_rows
                                 + at];
                    s_dw += part[(2 * static_cast<int64_t>(ncg) + g) * n_rows
                                 + at];
                }
                dr[at] = from_float<T>(fmaf(ui[q] * ki[q], vd, s_dr));
                dk[at] = from_float<T>(fmaf(ri[q] * ui[q], vd, s_dk));
                dw[at] = from_float<T>(s_dw);
                du_acc[q] = fmaf(ri[q] * ki[q], vd, du_acc[q]);
            }
        }
        for (int j = lane; j < Dv; j += 32) {
            const float dd = dout != nullptr ? to_float(dout[row * Dv + j])
                                             : 0.0f;
            dv[row * Dv + j] = from_float<T>(fmaf(ruk, dd,
                                                  dv_state[row * Dv + j]));
        }
    }
    const int64_t slot = (b * gridDim.x + tb) * kRedWarps + warp;
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
        const int i = lane + 32 * q;
        if (i < Dk) {
            du_part[(slot * H + h) * Dk + i] = du_acc[q];
        }
    }
}

// du[h, i] = the shares of every (b, block, warp), in that order
__global__ void rwkv6_bwd_du_kernel(const float* __restrict__ du_part,
                                    float* __restrict__ du, int64_t n_part,
                                    int64_t HDk) {
    const int64_t at = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
    if (at >= HDk) {
        return;
    }
    float sum = 0.0f;
    for (int64_t p = 0; p < n_part; ++p) {
        sum += du_part[p * HDk + at];
    }
    du[at] = sum;
}

int64_t n_groups(int64_t Dv) { return (Dv + kBlockCols - 1) / kBlockCols; }

int64_t n_step_blocks(int64_t S) { return (S + kRedSteps - 1) / kRedSteps; }

template <typename T>
int launch(const T* r, const T* k, const T* v, const T* w, const float* u,
           const T* dout, const float* ds_last, const float* ckpt,
           float* scratch, T* dr, T* dk, T* dv, T* dw, float* du, float* ds0,
           int64_t B, int64_t S, int64_t H, int64_t Dk, int64_t Dv,
           void* stream) {
    if (B <= 0 || H <= 0 || S <= 0 || Dk <= 0 || Dv <= 0 || Dk > kMaxDk ||
        B > 65535 || H > 65535 ||
        n_groups(Dv) > 65535 || n_step_blocks(S) > 0x7fffffff) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    // the scratch: the column groups' row sums, k G summed over the rows,
    // the warps' du shares (rwkv6_bwd_scratch_len)
    float* const part = scratch;
    float* const dv_state = part + 3 * n_groups(Dv) * B * S * H * Dk;
    float* const du_part = dv_state + B * S * H * Dv;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaFuncSetAttribute(
        rwkv6_bwd_state_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    const int ncg = static_cast<int>(n_groups(Dv));
    rwkv6_bwd_state_kernel<T><<<dim3(ncg, static_cast<unsigned>(H),
                                     static_cast<unsigned>(B)),
                                kThreads, kSmemBytes, st>>>(
        r, k, v, w, dout, ds_last, ckpt, part, dv_state, ds0, S, H,
        static_cast<int>(Dk), static_cast<int>(Dv));
    err = cudaGetLastError();
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    const int64_t n_tb = n_step_blocks(S);
    rwkv6_bwd_reduce_kernel<T><<<dim3(static_cast<unsigned>(n_tb),
                                      static_cast<unsigned>(H),
                                      static_cast<unsigned>(B)),
                                 kRedWarps * 32, 0, st>>>(
        r, k, v, dout, u, part, dv_state, dr, dk, dv, dw, du_part, S, H,
        static_cast<int>(Dk), static_cast<int>(Dv), ncg);
    err = cudaGetLastError();
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    const int64_t HDk = H * Dk;
    rwkv6_bwd_du_kernel<<<static_cast<unsigned>((HDk + 255) / 256), 256, 0,
                          st>>>(du_part, du, B * n_tb * kRedWarps, HDk);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on `stream` without synchronising and returns a CUDA
// error code: 0 when the launches were accepted.  ckpt is what the
// forward wrote when it was given one (every kCkptSteps steps); dout,
// ds_last and ds0 may be null (no ds0: it is not written); scratch holds
// rwkv6_bwd_scratch_len(...) floats.  dr, dk, dw [B, S, H, Dk] and dv
// [B, S, H, Dv] in the input type; du [H, Dk] and ds0 [B, H, Dk, Dv]
// float32.  S > 0.
int rwkv6_bwd_f32(const float* r, const float* k, const float* v,
                  const float* w, const float* u, const float* dout,
                  const float* ds_last, const float* ckpt, float* scratch,
                  float* dr, float* dk, float* dv, float* dw, float* du,
                  float* ds0, int64_t B, int64_t S, int64_t H, int64_t Dk,
                  int64_t Dv, void* stream) {
    return launch<float>(r, k, v, w, u, dout, ds_last, ckpt, scratch, dr, dk,
                         dv, dw, du, ds0, B, S, H, Dk, Dv, stream);
}

int rwkv6_bwd_bf16(const __nv_bfloat16* r, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, const __nv_bfloat16* w,
                   const float* u, const __nv_bfloat16* dout,
                   const float* ds_last, const float* ckpt, float* scratch,
                   __nv_bfloat16* dr, __nv_bfloat16* dk, __nv_bfloat16* dv,
                   __nv_bfloat16* dw, float* du, float* ds0, int64_t B,
                   int64_t S, int64_t H, int64_t Dk, int64_t Dv,
                   void* stream) {
    return launch<__nv_bfloat16>(r, k, v, w, u, dout, ds_last, ckpt, scratch,
                                 dr, dk, dv, dw, du, ds0, B, S, H, Dk, Dv,
                                 stream);
}

// The float32 scratch of the backward, in elements.
int64_t rwkv6_bwd_scratch_len(int64_t B, int64_t S, int64_t H, int64_t Dk,
                              int64_t Dv) {
    return 3 * n_groups(Dv) * B * S * H * Dk + B * S * H * Dv +
           B * n_step_blocks(S) * kRedWarps * H * Dk;
}

}  // extern "C"
