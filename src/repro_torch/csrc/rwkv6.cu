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
// per step.  Here the state lives in registers, tiled over the lanes: a
// lane owns kRows *contiguous* rows by kCols columns of one head's state,
// kLanesPerCol = 64 / kRows lanes share a column group and split Dk
// between them, and a block holds kBlockCols columns of one head.  Per
// element and step the lane does four float32 instructions:
//     kv = k*v;  acc = fmaf(r, S, acc);  S = __fadd_rn(__fmul_rn(w, S), kv)
// since out_t[c] = sum_rows r S_old[row, c] + v_t[c] (sum_rows r u k): the
// u term depends on (b, t, h) alone, so it is summed once per step by
// the threads that stage the step's rows, and added when out is written.
// r_t, k_t, w_t (shared by all of a head's columns) and the block's v_t
// are staged in shared memory as float (bf16 is converted while staging)
// for kSteps time steps a round, double-buffered, with the next round's
// loads issued into registers before this round's steps run: one
// __syncthreads a round.  A lane reads its rows as float4s and uses each
// value kCols times from registers; lanes are ordered so that a quarter
// warp holds lanes of neighbouring column groups, which read the same row
// chunk (a broadcast), so the 16-byte loads do not conflict without any
// padding.  The steps of a round are unrolled and keep their column sums
// in registers: no step writes shared memory or shuffles, so the loads
// of later steps are issued early and a step's state update never waits
// on an earlier step's sums.  At the end of the round one shuffle tree
// adds the kSteps * kCols sums over the lanes of a column, as a
// reduce-scatter (each level halves what a lane sends, so a lane ends
// with kSteps * kCols / kLanesPerCol totals), and out goes through shared
// memory to coalesced stores.
//
// Bound.  Per (b, t, h) it reads r, k, w, v once and writes out once, and
// does about 7*Dk*Dv float32 operations (as counted for the bound; the
// kernel issues 4 instructions per element and step, 2 of them the
// multiply-add pair of the rounded update): at the prefill shape (B=2,
// S=4096, H=64, Dk=Dv=64) 673 MB (0.201 ms at 3.35 TB/s) against 1.50e10
// operations (0.224 ms at 67 TFLOP/s), so operations bound it on paper;
// the floor of 4 instructions per element and step is about 0.27 ms at
// the card's 1980 MHz.  Measured on an H100 (tools/rwkv6_sweep.py), it
// takes about 0.7 ms there and is bound by instruction issue: its SASS
// issues about 7 instructions per element and step (the 4 above, the
// shared loads, and a round's shuffle tree, staging and stores), the 128
// heads' state fills only 8 warps an SM (two a scheduler), and about half
// of the issue slots go to stalls that a round's barrier and the shared
// loads' latency expose.  Tilings with more columns a lane load less but
// leave one warp a scheduler, and were slower in the sweep.
//
// Checkpoints for the backward (rwkv6_bwd.cu).  Given a non-null `ckpt`,
// the kernel also stores the float32 state before every kCkptSteps-th
// step (rwkv6_common.cuh), P_{n*kCkptSteps} for n = 0 .. ceil(S /
// kCkptSteps) - 1, into ckpt [B, H, n, Dk, Dv] (the first is s0, or
// zeros).  That is a second instantiation (kCkpt = true), picked by the
// launch: the stores sit at the top of every other round and change no
// arithmetic, so out and s_last are bit-identical to a launch without
// them, and a null `ckpt` launches the kernel without the stores,
// unchanged.  kCkptSteps = 16: the backward keeps the states of one
// interval in shared memory (16 steps of a 64-row by 16-column tile are
// 64 KB) and recomputes each interval once from its checkpoint.  The
// checkpoints take B*H*ceil(S/16)*Dk*Dv*4 bytes: 256 MB for one rwkv6-7b
// layer and 4,096-token sequence, four times the 64 MB that 64 steps
// between checkpoints would take, written at about 1 KB a head and step
// beside the 1.25 KB the step reads and writes.
//
// Not done here: the chunked matmul form (rwkv6_chunked) on tensor cores.
// It carries the state across a chunk as a product, which breaks the
// bit-identity of s_last with the plain version, and in float32 it would
// need split TF32 products to meet 1e-5.  That is a change of contract.
//
// Build: see flash_attention.cu.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rwkv6_common.cuh"

namespace {

constexpr int kMaxDk = 64;
constexpr int kRows = 8;          // contiguous rows of the state per lane
constexpr int kCols = 2;          // columns of the state per lane
constexpr int kWarps = 8;         // warps per block
constexpr int kSteps = 8;         // time steps staged per round
constexpr int kLanesPerCol = kMaxDk / kRows;          // lanes sharing a column
constexpr int kGroups = 32 / kLanesPerCol;            // column groups a warp
constexpr int kBlockCols = kWarps * kGroups * kCols;  // columns of S a block
constexpr int kThreads = kWarps * 32;
constexpr int kRkwPerThread = kSteps * kMaxDk / kThreads;  // staged r/k/w
constexpr int kVPerThread = kSteps * kBlockCols / kThreads;  // staged v/out

constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x / 2); }
constexpr int kLevels = log2i(kLanesPerCol);         // levels of the tree
constexpr int kPart = kSteps * kCols;                // a lane's sums a round
constexpr int kTotals = kPart / kLanesPerCol;        // totals it ends with

static_assert(kMaxDk % kRows == 0 && 32 % kLanesPerCol == 0,
              "the lanes of a column tile Dk inside one warp");
static_assert(kRows % 2 == 0, "rows are read as float4s or float2s");
static_assert((1 << kLevels) == kLanesPerCol && (kPart & (kPart - 1)) == 0,
              "powers of two");
static_assert(kPart >= kLanesPerCol, "every lane ends with a total");
static_assert(kCkptSteps % kSteps == 0, "a checkpoint starts a round");
static_assert(kThreads % kMaxDk == 0 && kSteps * kMaxDk % kThreads == 0,
              "threads tile a staged row");
static_assert(kSteps * kBlockCols % kThreads == 0 &&
              kThreads % kBlockCols == 0, "threads tile v and out");

// shared memory, in floats, each double-buffered: r/k/w, v, out, and the
// two 32-row halves of sum_rows r u k
constexpr int kRkwFloats = 3 * kSteps * kMaxDk;
constexpr int kVFloats = kSteps * kBlockCols;
constexpr int kUFloats = 2 * kSteps;
constexpr size_t kSmemBytes =
    sizeof(float) * 2 * (kRkwFloats + 2 * kVFloats + kUFloats);

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

// N contiguous floats from shared memory, as float4s when N % 4 == 0 (the
// address then 16-byte aligned), else as float2s or one by one
template <int N>
__device__ __forceinline__ void load_row(float (&dst)[N], const float* src) {
    if constexpr (N % 4 == 0) {
#pragma unroll
        for (int i = 0; i < N; i += 4) {
            const float4 q = *reinterpret_cast<const float4*>(src + i);
            dst[i] = q.x;
            dst[i + 1] = q.y;
            dst[i + 2] = q.z;
            dst[i + 3] = q.w;
        }
    } else if constexpr (N % 2 == 0) {
#pragma unroll
        for (int i = 0; i < N; i += 2) {
            const float2 q = *reinterpret_cast<const float2*>(src + i);
            dst[i] = q.x;
            dst[i + 1] = q.y;
        }
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i) {
            dst[i] = src[i];
        }
    }
}

// Level LV of the shuffle tree that adds a round's sums over the
// kLanesPerCol lanes of a column group (lane bit LV of `rl`, xor distance
// kGroups << LV).  It is a reduce-scatter: at each level the lane keeps
// half of its values (the upper half when its bit is set) and adds its
// partner's copy of them, so a round of kSteps * kCols sums costs
// kPart - kTotals shuffles a lane, and every lane ends with kTotals of the
// totals.  Each total is the pairwise sum ((p0 + p1) + (p2 + p3)) + ...
// over `rl`.
template <int LV>
__device__ __forceinline__ void reduce_round(float (&vals)[kPart], int rl) {
    if constexpr (LV < kLevels) {
        constexpr int off = kGroups << LV;
        constexpr int half = kPart >> (LV + 1);
        const bool hi = (rl >> LV) & 1;
#pragma unroll
        for (int j = 0; j < half; ++j) {
            const float send = hi ? vals[j] : vals[j + half];
            const float keep = hi ? vals[j + half] : vals[j];
            vals[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
        reduce_round<LV + 1>(vals, rl);
    }
}

// The kSteps steps of a round (the first n of them unless kFull): the
// state update, and this lane's share of sum_rows r_t S_old for its kCols
// columns, into part[t * kCols + c].  Nothing here writes shared memory,
// so the loads of later steps may be issued early, and no step waits on
// another's sums.
template <bool kFull>
__device__ __forceinline__ void round_steps(float (&state)[kRows][kCols],
                                            float (&part)[kPart],
                                            const float* rs, const float* vs,
                                            int n) {
#pragma unroll
    for (int tt = 0; tt < kSteps; ++tt) {
        if (kFull || tt < n) {
            float rr[kRows], kr[kRows], wr[kRows], vv[kCols];
            load_row(rr, rs + tt * kMaxDk);
            load_row(kr, rs + (kSteps + tt) * kMaxDk);
            load_row(wr, rs + (2 * kSteps + tt) * kMaxDk);
            load_row(vv, vs + tt * kBlockCols);
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
#pragma unroll
                for (int c = 0; c < kCols; ++c) {
                    float& acc = part[tt * kCols + c];
                    acc = i == 0 ? rr[0] * state[0][c]
                                 : fmaf(rr[i], state[i][c], acc);
                    // two rounded operations, as the plain version
                    state[i][c] = __fadd_rn(__fmul_rn(wr[i], state[i][c]),
                                            kr[i] * vv[c]);
                }
            }
        } else {
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
                part[tt * kCols + c] = 0.0f;
            }
        }
    }
}

// one block an SM: the grid is B * H * ceil(Dv / kBlockCols) blocks, about
// the card's SM count at the prefill shape, so ptxas may use every register
template <typename T, bool kCkpt>
__global__ void __launch_bounds__(kThreads, 1)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ s0,
             T* __restrict__ out, float* __restrict__ s_last,
             float* __restrict__ ckpt, int64_t S, int64_t H, int Dk,
             int Dv) {
    extern __shared__ __align__(16) float smem[];
    float* const rkw_s = smem;                        // [2][3][kSteps][64]
    float* const v_s = smem + 2 * kRkwFloats;         // [2][kSteps][cols]
    float* const o_s = v_s + 2 * kVFloats;            // [2][kSteps][cols]
    float* const u_s = o_s + 2 * kVFloats;            // [2][2][kSteps]

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int rl = lane / kGroups;          // which rows: rl*kRows ...
    const int cg = lane % kGroups;          // which column group
    const int bcol = (tid / 32) * kGroups * kCols + cg * kCols;  // in block
    const int row0 = rl * kRows;
    const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kBlockCols;
    const int64_t h = blockIdx.y;
    const int64_t b = blockIdx.z;
    const int64_t head = b * H + h;

    float state[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int row = row0 + i;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
            const int64_t col = col0 + bcol + c;
            state[i][c] = (s0 != nullptr && row < Dk && col < Dv)
                ? s0[(head * Dk + row) * Dv + col] : 0.0f;
        }
    }

    // r[b, t, h, :] starts at ((b*S + t)*H + h)*Dk
    const int64_t rk_step = H * Dk;
    const int64_t v_step = H * Dv;
    const T* rb = r + (b * S * H + h) * Dk;
    const T* kb = k + (b * S * H + h) * Dk;
    const T* wb = w + (b * S * H + h) * Dk;
    const T* vb = v + (b * S * H + h) * Dv;
    T* ob = out + (b * S * H + h) * Dv;
    const int steps = static_cast<int>(S);     // the launch checks the range

    // A round's operands pass through registers: neighbouring threads load
    // neighbouring elements of a staged row, so a row is one coalesced
    // load, and the next round's loads are in flight while this round
    // computes.  Rows past Dk, columns past Dv and steps past S stage as 0.
    // A thread's elements sit at fixed 32-bit offsets from the round's
    // first row, so a load costs no 64-bit address arithmetic.
    const int kk = tid % kMaxDk;
    const int t_first = tid / kMaxDk;
    constexpr int kRowsAtOnce = kThreads / kMaxDk;
    const int cv = tid % kBlockCols;        // this thread's column of v, out
    const int tv_first = tid / kBlockCols;
    constexpr int kVRowsAtOnce = kThreads / kBlockCols;
    const bool rk_ok = kk < Dk;
    const bool v_ok = col0 + cv < Dv;
    const int rk_off = t_first * static_cast<int>(rk_step) + kk;
    const int rk_stride = kRowsAtOnce * static_cast<int>(rk_step);
    const int v_off = tv_first * static_cast<int>(v_step) + cv;
    const int v_stride = kVRowsAtOnce * static_cast<int>(v_step);
    const float uk = rk_ok ? u[h * Dk + kk] : 0.0f;
    float r_n[kRkwPerThread], k_n[kRkwPerThread], w_n[kRkwPerThread];
    float v_n[kVPerThread];
    auto prefetch = [&](int t0) {
        const int left = steps - t0;     // steps of the round in range
        const int64_t at = t0 * rk_step;
        const T* rr = rb + at;
        const T* kr = kb + at;
        const T* wr = wb + at;
#pragma unroll
        for (int j = 0; j < kRkwPerThread; ++j) {
            const bool ok = rk_ok && t_first + j * kRowsAtOnce < left;
            const int off = rk_off + j * rk_stride;
            r_n[j] = ok ? to_float(rr[off]) : 0.0f;
            k_n[j] = ok ? to_float(kr[off]) : 0.0f;
            w_n[j] = ok ? to_float(wr[off]) : 0.0f;
        }
        const T* vr = vb + col0 + t0 * v_step;
#pragma unroll
        for (int j = 0; j < kVPerThread; ++j) {
            const bool ok = v_ok && tv_first + j * kVRowsAtOnce < left;
            v_n[j] = ok ? to_float(vr[v_off + j * v_stride]) : 0.0f;
        }
    };
    auto stage = [&](int buf) {
        float* rs = rkw_s + buf * kRkwFloats;
#pragma unroll
        for (int j = 0; j < kRkwPerThread; ++j) {
            const int at = (t_first + j * kRowsAtOnce) * kMaxDk + kk;
            rs[at] = r_n[j];
            rs[kSteps * kMaxDk + at] = k_n[j];
            rs[2 * kSteps * kMaxDk + at] = w_n[j];
        }
#pragma unroll
        for (int j = 0; j < kVPerThread; ++j) {
            v_s[buf * kVFloats + tid + j * kThreads] = v_n[j];
        }
        // sum_rows r u k of the staged steps: a warp holds 32 rows of a
        // step (lanes in row order), adds them pairwise with xor 1, 2, 4,
        // 8, 16, and lane 0 writes the half; out adds the two halves
        float p[kRkwPerThread];
#pragma unroll
        for (int j = 0; j < kRkwPerThread; ++j) {
            p[j] = r_n[j] * uk * k_n[j];
        }
#pragma unroll
        for (int off = 1; off < 32; off *= 2) {
#pragma unroll
            for (int j = 0; j < kRkwPerThread; ++j) {
                p[j] += __shfl_xor_sync(0xffffffffu, p[j], off);
            }
        }
        if (lane == 0) {
#pragma unroll
            for (int j = 0; j < kRkwPerThread; ++j) {
                u_s[(buf * 2 + kk / 32) * kSteps + t_first +
                    j * kRowsAtOnce] = p[j];
            }
        }
    };

    // this lane's totals at the end of a round are the sums first ..
    // first + kTotals - 1 of the round, step-major: their steps and their
    // places in the staged out
    int first = 0;
#pragma unroll
    for (int lv = 0; lv < kLevels; ++lv) {
        first += ((rl >> lv) & 1) ? kPart >> (lv + 1) : 0;
    }
    int total_t[kTotals], total_at[kTotals];
#pragma unroll
    for (int j = 0; j < kTotals; ++j) {
        total_t[j] = (first + j) / kCols;
        total_at[j] = total_t[j] * kBlockCols + bcol + (first + j) % kCols;
    }

    prefetch(0);
    stage(0);
    __syncthreads();
    int buf = 0;
    for (int t0 = 0; t0 < steps; t0 += kSteps, buf ^= 1) {
        const int n = steps - t0 < kSteps ? steps - t0 : kSteps;
        if constexpr (kCkpt) {
            if (t0 % kCkptSteps == 0) {     // the state before step t0
                const int64_t n_ckpt = (S + kCkptSteps - 1) / kCkptSteps;
                float* cp = ckpt + (head * n_ckpt + t0 / kCkptSteps) * Dk *
                                       static_cast<int64_t>(Dv);
#pragma unroll
                for (int i = 0; i < kRows; ++i) {
                    const int row = row0 + i;
#pragma unroll
                    for (int c = 0; c < kCols; ++c) {
                        const int64_t col = col0 + bcol + c;
                        if (row < Dk && col < Dv) {
                            cp[row * static_cast<int64_t>(Dv) + col] =
                                state[i][c];
                        }
                    }
                }
            }
        }
        const bool more = t0 + kSteps < steps;
        if (more) {
            prefetch(t0 + kSteps);
        }
        const float* rs = rkw_s + buf * kRkwFloats + row0;
        const float* vs = v_s + buf * kVFloats;
        float* os = o_s + buf * kVFloats;
        float part[kPart];
        if (n == kSteps) {
            round_steps<true>(state, part, rs, vs + bcol, n);
        } else {
            round_steps<false>(state, part, rs, vs + bcol, n);
        }
        reduce_round<0>(part, rl);
        // out = the total + v (sum_rows r u k)
        const float* us = u_s + buf * 2 * kSteps;
#pragma unroll
        for (int j = 0; j < kTotals; ++j) {
            os[total_at[j]] = fmaf(vs[total_at[j]],
                                   us[total_t[j]] + us[kSteps + total_t[j]],
                                   part[j]);
        }
        if (more) {
            stage(buf ^ 1);
        }
        // the staged rows of the next round are in place, and this round's
        // out is complete; every reader of the other buffers is past the
        // previous barrier
        __syncthreads();
        T* orow = ob + col0 + t0 * v_step;
#pragma unroll
        for (int j = 0; j < kVPerThread; ++j) {
            if (v_ok && tv_first + j * kVRowsAtOnce < n) {
                orow[v_off + j * v_stride] =
                    from_float<T>(os[tid + j * kThreads]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int row = row0 + i;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
            const int64_t col = col0 + bcol + c;
            if (row < Dk && col < Dv) {
                s_last[(head * Dk + row) * Dv + col] = state[i][c];
            }
        }
    }
}

template <typename T, bool kCkpt>
int launch_as(const T* r, const T* k, const T* v, const T* w, const float* u,
              const float* s0, T* out, float* s_last, float* ckpt, int64_t B,
              int64_t S, int64_t H, int64_t Dk, int64_t Dv, void* stream) {
    // steps and a round's offsets are 32-bit
    if (B <= 0 || H <= 0 || S < 0 || Dk <= 0 || Dv <= 0 || Dk > kMaxDk ||
        B > 65535 || H > 65535 ||
        (Dv + kBlockCols - 1) / kBlockCols > 65535 ||
        2 * kSteps * H * (Dv > Dk ? Dv : Dk) >= (int64_t{1} << 31) ||
        S >= (int64_t{1} << 31) - kSteps) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (kSmemBytes > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            rwkv6_kernel<T, kCkpt>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(kSmemBytes));
        if (err != cudaSuccess) {
            return static_cast<int>(err);
        }
    }
    const dim3 grid(static_cast<unsigned>((Dv + kBlockCols - 1) / kBlockCols),
                    static_cast<unsigned>(H), static_cast<unsigned>(B));
    rwkv6_kernel<T, kCkpt><<<grid, kThreads, kSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
        r, k, v, w, u, s0, out, s_last, ckpt, S, H, static_cast<int>(Dk),
        static_cast<int>(Dv));
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* r, const T* k, const T* v, const T* w, const float* u,
           const float* s0, T* out, float* s_last, float* ckpt, int64_t B,
           int64_t S, int64_t H, int64_t Dk, int64_t Dv, void* stream) {
    return ckpt != nullptr
        ? launch_as<T, true>(r, k, v, w, u, s0, out, s_last, ckpt, B, S, H,
                             Dk, Dv, stream)
        : launch_as<T, false>(r, k, v, w, u, s0, out, s_last, nullptr, B, S,
                              H, Dk, Dv, stream);
}

}  // namespace

extern "C" {

// Each entry launches on `stream` without synchronising and returns a CUDA
// error code: 0 when the launch was accepted.  s0 may be null; ckpt may be
// null, and otherwise receives the checkpoints for the backward, [B, H,
// ceil(S / rwkv6_ckpt_steps()), Dk, Dv] float32.
int rwkv6_f32(const float* r, const float* k, const float* v, const float* w,
              const float* u, const float* s0, float* out, float* s_last,
              float* ckpt, int64_t B, int64_t S, int64_t H, int64_t Dk,
              int64_t Dv, void* stream) {
    return launch<float>(r, k, v, w, u, s0, out, s_last, ckpt, B, S, H, Dk,
                         Dv, stream);
}

int rwkv6_bf16(const __nv_bfloat16* r, const __nv_bfloat16* k,
               const __nv_bfloat16* v, const __nv_bfloat16* w,
               const float* u, const float* s0, __nv_bfloat16* out,
               float* s_last, float* ckpt, int64_t B, int64_t S, int64_t H,
               int64_t Dk, int64_t Dv, void* stream) {
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, out, s_last, ckpt, B, S,
                                 H, Dk, Dv, stream);
}

// The steps between two checkpoints.
int rwkv6_ckpt_steps(void) { return kCkptSteps; }

}  // extern "C"
