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
// Design.  Four launches.
//
// Time-parallel G.  G obeys a linear recurrence, element by element:
// G_{t-1} = w_t G_t + r_t dout_t.  Time is cut into chunks of kIntervals
// checkpoint intervals (256 steps).  Launch 1 computes, for every chunk
// but the first, the G its steps produce from a zero G, as a sum of
// decayed outer products (a small matrix product on the CUDA cores), and
// the product of its w; launch 2, one thread a state element, walks those
// summaries from the last chunk (dS_last there) and writes the G that
// enters each chunk (float32 scratch, 17.3 MB at path C's layer).  Every
// chunk then runs on its own: path C's layer gives 64 heads x 16 chunks
// x 2 ranks = 2,048 blocks where one head walked 4,096 steps in a row.
//
// Launch 3, the main kernel: one thread-block cluster a (b, h, chunk);
// its R ranks split the state's columns into groups of 32 (R = 2 at Dv =
// 64; R is the power of two that covers ceil(Dv / 32) groups, at most 8,
// and a rank walks several groups in turn when Dv > 256, keeping their G
// in the chunk's scratch).  A block of 256 threads holds its group's 64
// rows x 32 columns, two rows and four columns a thread, eight threads a
// row pair; 128 registers a thread, two blocks an SM.  The block walks
// its chunk's checkpoint intervals (kCkptSteps = 16 steps) in reverse.
// An interval's r, k, w rows, the group's v and dout columns and its
// columns of the checkpoint arrive by `cp.async` (16-byte copies, zeros
// past the edges) into one of two buffers while the other interval is
// computed.  The interval runs in two halves of 8 steps, the later first:
// the thread recomputes the half's states forward from the checkpoint
// with the forward's rounding (so they are the forward's states bit for
// bit) into 64 registers, then runs the half's steps backwards.  Per step
// a thread adds its columns' shares of P_t dout_t, G_t v_t and G_t ⊙ P_t
// (fmaf, column order) for its two rows, the row pair's 8 threads add
// theirs (9 shuffles, the first level splitting the two rows), and two
// of them push each row's record (the block's shares and the rank's
// share of v_t · dout_t, 16 bytes) into the shared memory of the rank
// that owns the row (distributed shared memory); k_t G_t is summed over
// a row pair in the thread, over the warp's 4 row pairs by a
// reduce-scatter shuffle tree (3 shuffles) into shared memory, and over
// the block's 8 warps, in warp order, when the interval ends: dv_t =
// that + (sum_i r u k) dout_t is whole inside the block and is written
// there.  After a cluster barrier (release: the records are in place),
// rank q adds the records of its rows in rank order from its own shared
// memory, adds the u terms and writes dr, dk and dw in the input type; a
// relaxed cluster barrier an interval keeps a rank from pushing records
// a peer still reads (the release form would also wait for every global
// store in flight).  A full interval runs without a step's guard (only a
// ragged last interval checks its length).  Each thread keeps du's share
// of its (step slot, row) over the chunk; at the end the slots are added
// in order into du's per-(b, h, chunk) shares, which launch 4 adds over
// b and the chunks in order.  No atomics anywhere, and every sum has one
// order: two calls give the same bits.  The scratch is the chunks' G,
// the products of w and du's shares, B * H * chunks * Dk * (Dv + 2)
// floats.
//
// Bound.  Per (b, t, h) the gradient reads r, k, w, v and dout once and
// writes dr, dk, dv and dw once, and takes about 13*Dk*Dv float32
// operations (the recompute's 3, dr's, dk's and dw's multiply-add pairs,
// dv's 2 and G's 3): at one rwkv6-7b layer (B=1, S=4096, H=64, Dk=Dv=64)
// 0.60 GB (0.18 ms at 3.35 TB/s) against 1.4e10 operations (0.21 ms at 67
// TFLOP/s), so operations bound it.  This design also reads the
// checkpoints (Dk*Dv*4 bytes every 16 steps, 0.27 GB at that shape),
// recomputes 22 of an interval's 16 states' updates, and issues about as
// many shuffles, selects and adds for the sums over threads as
// arithmetic: instruction issue and the interval's barriers bound it;
// its time is in PERF.md (tools/scan_bwd_sweep.py times it beside an
// earlier commit's).
//
// Build: see flash_attention.cu.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "rwkv6_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDk = 64;              // rows of the state (the forward's)
constexpr int kChunk = kCkptSteps;      // steps an interval
constexpr int kHalf = kChunk / 2;       // steps whose states a thread holds
constexpr int kIntervals = 16;          // intervals a time chunk
constexpr int kBatch = 8;               // chunk summaries loaded ahead
constexpr int kCols = 4;                // state columns a thread
constexpr int kRowsT = 2;               // state rows a thread
constexpr int kColThreads = 8;          // threads a row pair (lane bits 0-2)
constexpr int kGroupCols = kCols * kColThreads;  // columns a rank's group
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPairsPerWarp = 32 / kColThreads;  // row pairs (lane bits 3-4)
constexpr int kMaxRanks = 8;            // the portable cluster size
constexpr int kPairs = kChunk * kMaxDk / kThreads;  // epilogue (step, row)s
constexpr int kChunkCols = 64;          // launch 1: columns a block

static_assert(kWarps * kPairsPerWarp * kRowsT == kMaxDk,
              "the warps' row pairs cover the state's rows");
static_assert(kCols == 4 && kRowsT == 2 && kColThreads == 8 &&
              kPairsPerWarp == 4,
              "the shuffle trees pair lane bits 0-2 (a row pair's threads) "
              "and 3-4 (a warp's row pairs)");
static_assert(kChunk * kGroupCols == 2 * kThreads,
              "v·dout: a thread adds two columns of a step");
static_assert(kChunk == 2 * kWarps, "ruk: a warp sums two steps");
static_assert(2 * kHalf == kChunk, "an interval runs in two halves");
static_assert(kChunk * kMaxDk % kThreads == 0,
              "launch 1: whole rows of r, w and dout a thread");

// shared memory.  The staged rows of an interval, in T as loaded: r, k,
// w [3][kChunk][kMaxDk] and the first group's v, dout [2][kChunk]
// [kGroupCols], two buffers (the next interval's copies land in one while
// the other is read); for bfloat16 also their float32 conversion (float32
// reads the staged buffer as it is).  In floats: the checkpoint's P for
// the block's columns [2 buffers][kMaxDk][kGroupCols]; the warps' k G
// shares [kWarps][kChunk][kGroupCols]; the row records [kChunk][kMaxDk]
// [4] (the shares of dr, dk, dw and the rank's v·dout) that peers read;
// v·dout and sum_i r u k of the interval's steps [2][kChunk].
constexpr int kRkw = 3 * kChunk * kMaxDk;           // elements
constexpr int kVd = 2 * kChunk * kGroupCols;
constexpr int kStaged = kRkw + kVd;
constexpr int kP0Floats = kMaxDk * kGroupCols;
constexpr int kDvFloats = kWarps * kChunk * kGroupCols;
// the records a rank receives: [source rank][kChunk][its rows][4]; the
// ranks' rows, R * ceil(Dk / R), are at most kMaxDk + kMaxRanks - 1
constexpr int kRsFloats = kChunk * (kMaxDk + kMaxRanks) * 4;

template <typename T>
constexpr size_t smem_bytes() {
    return 2 * kStaged * sizeof(T) +
           (sizeof(T) == sizeof(float) ? 0 : kStaged * sizeof(float)) +
           sizeof(float) * (2 * kP0Floats + kDvFloats + kRsFloats +
                            2 * kChunk + kMaxDk);
}
static_assert(kDvFloats >= kChunk * kMaxDk, "du's slots reuse dv_s");
static_assert((kStaged * 2) % 16 == 0, "the staged buffers keep 16 bytes");

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

// 16 bytes from global to shared memory, asynchronously; zeros where `ok`
// is false (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
    const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(at),
                 "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A cluster barrier that orders no memory: for a rank to wait until its
// peers are past reading its shared memory (their reads have been used
// before they arrive).  The release form, cluster.sync(), also fences
// every global store still in flight, which costs microseconds right
// after an epilogue's stores.
__device__ __forceinline__ void cluster_sync_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The sum over each aligned group of 2 * `from` lanes (xor `from`, then
// half of it, down to 1), every lane of a group ending with the same bits.
__device__ __forceinline__ float lanes_sum(float x, int from) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
        if (off <= from) {
            x += __shfl_xor_sync(0xffffffffu, x, off);
        }
    }
    return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
rwkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ w,
                 const float* __restrict__ u, const T* __restrict__ dout,
                 const float* __restrict__ ckpt, float* __restrict__ gend,
                 float* __restrict__ du_part, T* __restrict__ dr,
                 T* __restrict__ dk, T* __restrict__ dv, T* __restrict__ dw,
                 float* __restrict__ ds0, int64_t S, int64_t H, int Dk,
                 int Dv, int n_my, int vec, int64_t n_tc) {
    constexpr bool kF32 = sizeof(T) == sizeof(float);
    constexpr int kE = 16 / static_cast<int>(sizeof(T));    // a 16-byte unit
    cg::cluster_group cluster = cg::this_cluster();
    extern __shared__ __align__(16) float smem[];
    T* const raw = reinterpret_cast<T*>(smem);              // [2][kStaged]
    float* const cvt = smem + (2 * kStaged * sizeof(T)) / sizeof(float);
    float* const p0_s = cvt + (kF32 ? 0 : kStaged);         // [2][64][32]
    float* const dv_s = p0_s + 2 * kP0Floats;               // [W][kChunk][32]
    float* const rs_s = dv_s + kDvFloats;                   // [R][kChunk][..][4]
    float* const vdp_s = rs_s + kRsFloats;                  // [kChunk]
    float* const ruk_s = vdp_s + kChunk;                    // [kChunk]
    float* const u_s = ruk_s + kChunk;                      // [64]

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int cq = lane % kColThreads;          // columns cq*4 .. cq*4+3
    const int row0 = warp * kPairsPerWarp * kRowsT + (lane / kColThreads) *
                     kRowsT;                    // rows row0, row0 + 1
    const bool b0 = lane & 1;
    // the k G tree's lane bits, and the column of it a lane ends with
    const bool hi4 = (lane >> 4) & 1;
    const bool hi3 = (lane >> 3) & 1;
    const int kg_col = cq * kCols + 2 * hi4 + hi3;
    const int q = static_cast<int>(cluster.block_rank());
    const int R = static_cast<int>(cluster.num_blocks());
    const int64_t head = blockIdx.z;            // b * H + h
    const int64_t h = head % H;
    const int64_t b = head / H;
    const int64_t n_ckpt = (S + kChunk - 1) / kChunk;
    // the block's time chunk: intervals [n_lo, n_hi), and where its G
    // enters (G_t for its last step; launch 2 wrote it) and is kept
    const int64_t chunk = blockIdx.y;
    const int64_t n_lo = chunk * kIntervals;
    const int64_t n_hi = n_lo + kIntervals < n_ckpt ? n_lo + kIntervals
                                                    : n_ckpt;
    float* const g_chunk = gend + (head * n_tc + chunk) * Dk *
                                      static_cast<int64_t>(Dv);
    // the epilogue's (step, row) pairs: rank q owns rows [e_lo, e_lo +
    // rows_per)
    const int rows_per = (Dk + R - 1) / R;
    const int e_lo = q * rows_per;
    const int n_pairs = kChunk * rows_per;
    // the row whose record this lane writes (lanes with cq 0 and 1), and
    // where it goes: the owner rank's shared memory, this rank's slot
    const bool writer = (lane & (kColThreads - 2)) == 0;
    const int row_w = row0 + b0;
    float* const rs_row = writer && row_w < Dk
        ? cluster.map_shared_rank(rs_s, row_w / rows_per) +
              (q * kChunk * rows_per + row_w % rows_per) * 4
        : nullptr;

    auto row_at = [&](int64_t t, int i) -> int64_t {     // r, k, w [.., i]
        return ((b * S + t) * H + h) * Dk + i;
    };
    auto col_at = [&](int64_t t, int64_t col) -> int64_t {  // v, dout
        return ((b * S + t) * H + h) * Dv + col;
    };
    auto ckpt_at = [&](int64_t n, int i, int64_t col) -> int64_t {
        return ((head * n_ckpt + n) * Dk + i) * static_cast<int64_t>(Dv) +
               col;
    };
    // group g's v and dout of interval n into `to` (synchronously)
    auto load_vd = [&](int64_t n, int g, T* to) {
        for (int x = tid; x < kChunk * kGroupCols; x += kThreads) {
            const int64_t t = n * kChunk + x / kGroupCols;
            const int64_t col = static_cast<int64_t>(g) * kGroupCols +
                                x % kGroupCols;
            const bool ok = col < Dv && t < S;
            to[x] = ok ? v[col_at(t, col)] : from_float<T>(0);
            to[kChunk * kGroupCols + x] =
                ok && dout != nullptr ? dout[col_at(t, col)]
                                      : from_float<T>(0);
        }
    };
    // group g's checkpoint of interval n into `to` [64][32]
    auto load_p0 = [&](int64_t n, int g, float* to) {
        for (int x = tid; x < kMaxDk * kGroupCols; x += kThreads) {
            const int i = x / kGroupCols;
            const int64_t col = static_cast<int64_t>(g) * kGroupCols +
                                x % kGroupCols;
            to[x] = i < Dk && col < Dv ? ckpt[ckpt_at(n, i, col)] : 0.0f;
        }
    };
    // interval n's r, k, w rows, the first group's v and dout and its
    // checkpoint into buffer bi: as 16-byte asynchronous copies where the
    // shape allows (`vec`), else loaded and stored here
    auto stage = [&](int64_t n, int bi) {
        T* const to = raw + bi * kStaged;
        float* const p_to = p0_s + bi * kP0Floats;
        const int64_t t0 = n * kChunk;
        const int g0 = q * n_my;
        if (vec) {
            constexpr int kUnits = kChunk * kMaxDk / kE;   // of r, k or w
            for (int x = tid; x < kUnits; x += kThreads) {
                const int st = x / (kMaxDk / kE);
                const int i = (x % (kMaxDk / kE)) * kE;
                const bool ok = i < Dk && t0 + st < S;
                const int64_t at = ok ? row_at(t0 + st, i) : 0;
                cp_async16(to + st * kMaxDk + i, r + at, ok);
                cp_async16(to + kChunk * kMaxDk + st * kMaxDk + i, k + at,
                           ok);
                cp_async16(to + 2 * kChunk * kMaxDk + st * kMaxDk + i,
                           w + at, ok);
            }
            constexpr int kVdUnits = kChunk * kGroupCols / kE;
            for (int x = tid; x < kVdUnits; x += kThreads) {
                const int st = x / (kGroupCols / kE);
                const int c = (x % (kGroupCols / kE)) * kE;
                const int64_t col = static_cast<int64_t>(g0) * kGroupCols + c;
                const bool ok = col < Dv && t0 + st < S;
                const int64_t at = ok ? col_at(t0 + st, col) : 0;
                cp_async16(to + kRkw + st * kGroupCols + c, v + at, ok);
                cp_async16(to + kRkw + kChunk * kGroupCols + st * kGroupCols +
                               c, dout != nullptr ? dout + at : v,
                           ok && dout != nullptr);
            }
            constexpr int kPUnits = kMaxDk * kGroupCols / 4;
            for (int x = tid; x < kPUnits; x += kThreads) {
                const int i = x / (kGroupCols / 4);
                const int c = (x % (kGroupCols / 4)) * 4;
                const int64_t col = static_cast<int64_t>(g0) * kGroupCols + c;
                const bool ok = i < Dk && col < Dv;
                cp_async16(p_to + i * kGroupCols + c,
                           ckpt + (ok ? ckpt_at(n, i, col) : 0), ok);
            }
        } else {
            for (int x = tid; x < kChunk * kMaxDk; x += kThreads) {
                const int st = x / kMaxDk;
                const int i = x % kMaxDk;
                const bool ok = i < Dk && t0 + st < S;
                const int64_t at = ok ? row_at(t0 + st, i) : 0;
                to[x] = ok ? r[at] : from_float<T>(0);
                to[kChunk * kMaxDk + x] = ok ? k[at] : from_float<T>(0);
                to[2 * kChunk * kMaxDk + x] = ok ? w[at] : from_float<T>(0);
            }
            load_vd(n, g0, to + kRkw);
            load_p0(n, g0, p_to);
        }
    };
    auto g_col = [&](int g, int c) -> int64_t {
        return static_cast<int64_t>(g) * kGroupCols + cq * kCols + c;
    };
    auto g_ok = [&](int g, int rr, int c) {
        return row0 + rr < Dk && g_col(g, c) < Dv;
    };
    auto g_at = [&](int g, int rr, int c) -> int64_t {   // in g_chunk
        return (row0 + rr) * static_cast<int64_t>(Dv) + g_col(g, c);
    };

    // a rank that walks several groups keeps their G in g_chunk
    float G[kRowsT][kCols];
#pragma unroll
    for (int rr = 0; rr < kRowsT; ++rr) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
            G[rr][c] = g_ok(q * n_my, rr, c) ? g_chunk[g_at(q * n_my, rr, c)]
                                             : 0.0f;
        }
    }
    float du_acc[kPairs];
#pragma unroll
    for (int m = 0; m < kPairs; ++m) {
        du_acc[m] = 0.0f;
    }

    if (tid < kMaxDk) {
        u_s[tid] = tid < Dk ? u[h * Dk + tid] : 0.0f;
    }
    stage(n_hi - 1, static_cast<int>((n_hi - 1) & 1));
    cp_async_commit();
    for (int64_t n = n_hi - 1; n >= n_lo; --n) {
        const int64_t t0 = n * kChunk;
        const int len = S - t0 < kChunk ? static_cast<int>(S - t0) : kChunk;
        const int buf = static_cast<int>(n & 1);
        // every thread is past the previous interval, the last reader of
        // the buffer the next interval's copies go to
        __syncthreads();
        if (n > n_lo) {
            stage(n - 1, buf ^ 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        // this interval's copies are in place for every thread, and every
        // rank is past reading the records of the previous interval
        __syncthreads();
        cluster_sync_relaxed();
        float* rkw_s;
        if constexpr (kF32) {
            rkw_s = reinterpret_cast<float*>(raw + buf * kStaged);
        } else {
            for (int x = tid; x < kStaged; x += kThreads) {
                cvt[x] = to_float(raw[buf * kStaged + x]);
            }
            __syncthreads();
            rkw_s = cvt;
        }
        float* const vd_s = rkw_s + kRkw;                   // [2][kChunk][32]
        float* const p0_b = p0_s + buf * kP0Floats;
        // sum_i r_i u_i k_i of the interval's steps: a warp sums two steps
        // over its lanes, each lane rows lane and lane + 32
#pragma unroll
        for (int m = 0; m < 2; ++m) {
            const int st = 2 * warp + m;
            float ruk = 0.0f;
#pragma unroll
            for (int qq = 0; qq < 2; ++qq) {
                const int i = lane + 32 * qq;
                ruk = fmaf(rkw_s[st * kMaxDk + i] * u_s[i],
                           rkw_s[kChunk * kMaxDk + st * kMaxDk + i], ruk);
            }
            ruk = lanes_sum(ruk, 16);
            if (lane == 0) {
                ruk_s[st] = ruk;
            }
        }
        const float* rs = rkw_s + row0;
        const float* ks = rkw_s + kChunk * kMaxDk + row0;
        const float* ws = rkw_s + 2 * kChunk * kMaxDk + row0;
        float* const dv_w = dv_s + warp * kChunk * kGroupCols + kg_col;
        const float* vsp = vd_s + cq * kCols;
        const float* dsp = vd_s + kChunk * kGroupCols + cq * kCols;

        // dv of group g: the warps' shares of k_t G_t in warp order, and
        // the u term
        auto dv_epilogue = [&](int g) {
            for (int x = tid; x < kChunk * kGroupCols; x += kThreads) {
                const int st = x / kGroupCols;
                const int c = x % kGroupCols;
                const int64_t col = static_cast<int64_t>(g) * kGroupCols + c;
                if (st < len && col < Dv) {
                    float sum = dv_s[x];
#pragma unroll
                    for (int wp = 1; wp < kWarps; ++wp) {
                        sum += dv_s[wp * kChunk * kGroupCols + x];
                    }
                    dv[col_at(t0 + st, col)] = from_float<T>(
                        fmaf(ruk_s[st], vd_s[kChunk * kGroupCols + x], sum));
                }
            }
        };

        for (int j = 0; j < n_my; ++j) {
            const int g = q * n_my + j;
            if (j > 0) {
                // the previous group's dv is written; its v, dout and k G
                // shares are no longer read
                __syncthreads();
                if constexpr (kF32) {
                    load_vd(n, g, reinterpret_cast<T*>(vd_s));
                } else {
                    for (int x = tid; x < kChunk * kGroupCols;
                         x += kThreads) {
                        const int64_t tt = t0 + x / kGroupCols;
                        const int64_t col = static_cast<int64_t>(g) *
                                                kGroupCols + x % kGroupCols;
                        const bool ok = col < Dv && tt < S;
                        vd_s[x] = ok ? to_float(v[col_at(tt, col)]) : 0.0f;
                        vd_s[kChunk * kGroupCols + x] =
                            ok && dout != nullptr
                                ? to_float(dout[col_at(tt, col)]) : 0.0f;
                    }
                }
                load_p0(n, g, p0_b);
                __syncthreads();
            }
            if (n_my > 1) {
#pragma unroll
                for (int rr = 0; rr < kRowsT; ++rr) {
#pragma unroll
                    for (int c = 0; c < kCols; ++c) {
                        G[rr][c] = g_ok(g, rr, c) ? g_chunk[g_at(g, rr, c)]
                                                  : 0.0f;
                    }
                }
            }
            // the group's share of v_t · dout_t: a thread's two products
            // (columns c and c + 16) added, then over 16 lanes, then over a
            // rank's groups in order
            {
                const int st = tid / (kGroupCols / 2);
                const int c = tid % (kGroupCols / 2);
                const float* vr = vd_s + st * kGroupCols;
                const float* dr_ = vd_s + kChunk * kGroupCols +
                                   st * kGroupCols;
                const float pv = lanes_sum(
                    vr[c] * dr_[c] + vr[c + kGroupCols / 2] *
                                         dr_[c + kGroupCols / 2], 8);
                if (c == 0) {
                    vdp_s[st] = j == 0 ? pv : vdp_s[st] + pv;
                }
            }
            __syncthreads();

            // The interval in two halves of kHalf steps, the later first:
            // its states P_t recomputed from the checkpoint with the
            // forward's rounding (so they are the forward's states bit for
            // bit) into registers, then its steps run backwards.  A full
            // interval runs without a step's guard, and the first of a
            // rank's groups writes its row records where a later one adds.
            auto steps = [&](auto full, auto first, auto half) {
                constexpr bool kFull = decltype(full)::value;
                constexpr bool kFirst = decltype(first)::value;
                constexpr int kLo = decltype(half)::value * kHalf;
                float Pst[kHalf][kRowsT][kCols];
                float P[kRowsT][kCols];
#pragma unroll
                for (int rr = 0; rr < kRowsT; ++rr) {
                    const float4 p4 = *reinterpret_cast<const float4*>(
                        p0_b + (row0 + rr) * kGroupCols + cq * kCols);
                    P[rr][0] = p4.x;
                    P[rr][1] = p4.y;
                    P[rr][2] = p4.z;
                    P[rr][3] = p4.w;
                }
#pragma unroll
                for (int st = 0; st < kLo + kHalf - 1; ++st) {
                    if (kFull || st < len) {
                        const float2 k2 = *reinterpret_cast<const float2*>(
                            ks + st * kMaxDk);
                        const float2 w2 = *reinterpret_cast<const float2*>(
                            ws + st * kMaxDk);
                        const float4 vv = *reinterpret_cast<const float4*>(
                            vsp + st * kGroupCols);
                        const float kr[kRowsT] = {k2.x, k2.y};
                        const float wr[kRowsT] = {w2.x, w2.y};
                        const float vc4[kCols] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
                        for (int rr = 0; rr < kRowsT; ++rr) {
#pragma unroll
                            for (int c = 0; c < kCols; ++c) {
                                if (st >= kLo) {
                                    Pst[st - kLo][rr][c] = P[rr][c];
                                }
                                P[rr][c] = __fadd_rn(
                                    __fmul_rn(wr[rr], P[rr][c]),
                                    kr[rr] * vc4[c]);
                            }
                        }
                    }
                }
#pragma unroll
                for (int rr = 0; rr < kRowsT; ++rr) {
#pragma unroll
                    for (int c = 0; c < kCols; ++c) {
                        Pst[kHalf - 1][rr][c] = P[rr][c];
                    }
                }
#pragma unroll
                for (int st = kLo + kHalf - 1; st >= kLo; --st) {
                    if (kFull || st < len) {
                        const float2 r2 = *reinterpret_cast<const float2*>(
                            rs + st * kMaxDk);
                        const float2 k2 = *reinterpret_cast<const float2*>(
                            ks + st * kMaxDk);
                        const float2 w2 = *reinterpret_cast<const float2*>(
                            ws + st * kMaxDk);
                        const float4 vv = *reinterpret_cast<const float4*>(
                            vsp + st * kGroupCols);
                        const float4 d4 = *reinterpret_cast<const float4*>(
                            dsp + st * kGroupCols);
                        const float rq[kRowsT] = {r2.x, r2.y};
                        const float kr[kRowsT] = {k2.x, k2.y};
                        const float wr[kRowsT] = {w2.x, w2.y};
                        const float vc4[kCols] = {vv.x, vv.y, vv.z, vv.w};
                        const float dd[kCols] = {d4.x, d4.y, d4.z, d4.w};
                        float a[kRowsT][3];
                        float kg[kCols];
#pragma unroll
                        for (int rr = 0; rr < kRowsT; ++rr) {
                            const float* Pt = Pst[st - kLo][rr];
                            a[rr][0] = a[rr][1] = a[rr][2] = 0.0f;
#pragma unroll
                            for (int c = 0; c < kCols; ++c) {
                                a[rr][0] = fmaf(Pt[c], dd[c], a[rr][0]);
                                a[rr][1] = fmaf(G[rr][c], vc4[c], a[rr][1]);
                                a[rr][2] = fmaf(G[rr][c], Pt[c], a[rr][2]);
                            }
                        }
#pragma unroll
                        for (int c = 0; c < kCols; ++c) {
                            kg[c] = fmaf(kr[1], G[1][c], kr[0] * G[0][c]);
#pragma unroll
                            for (int rr = 0; rr < kRowsT; ++rr) {
                                G[rr][c] = fmaf(wr[rr], G[rr][c],
                                                rq[rr] * dd[c]);  // G_{t-1}
                            }
                        }
                        // the row pair's 8 threads: lane bit 0 splits the
                        // two rows (the lane keeps its bit's row and adds
                        // its partner's copy of it), bits 1 and 2 add
                        // whole; lanes 0 and 1 of a row pair end with the
                        // sums of its first and second row
                        float x[3];
#pragma unroll
                        for (int i = 0; i < 3; ++i) {
                            const float send = b0 ? a[0][i] : a[1][i];
                            const float keep = b0 ? a[1][i] : a[0][i];
                            x[i] = keep +
                                   __shfl_xor_sync(0xffffffffu, send, 1);
                        }
#pragma unroll
                        for (int i = 0; i < 3; ++i) {
                            x[i] += __shfl_xor_sync(0xffffffffu, x[i], 2);
                        }
#pragma unroll
                        for (int i = 0; i < 3; ++i) {
                            x[i] += __shfl_xor_sync(0xffffffffu, x[i], 4);
                        }
                        if (rs_row != nullptr) {
                            // the row's record, into the shared memory of
                            // the rank that owns the row: the block's
                            // shares, and the rank's v·dout of the step
                            // so far
                            float4* at = reinterpret_cast<float4*>(
                                rs_row + st * rows_per * 4);
                            if (kFirst) {
                                *at = make_float4(x[0], x[1], x[2],
                                                  vdp_s[st]);
                            } else {
                                const float4 o = *at;
                                *at = make_float4(o.x + x[0], o.y + x[1],
                                                  o.z + x[2], vdp_s[st]);
                            }
                        }
                        // k_t G_t over the warp's 4 row pairs (lane bits 4
                        // and 3), as a reduce-scatter: at each bit the
                        // lane keeps half of its values (the upper half
                        // when the bit is set) and adds its partner's copy
                        // of them.  The lane ends with column
                        // 2*b4 + b3 of its four.
#pragma unroll
                        for (int jj = 0; jj < 2; ++jj) {
                            const float send = hi4 ? kg[jj] : kg[jj + 2];
                            const float keep = hi4 ? kg[jj + 2] : kg[jj];
                            kg[jj] = keep +
                                     __shfl_xor_sync(0xffffffffu, send, 16);
                        }
                        {
                            const float send = hi3 ? kg[0] : kg[1];
                            const float keep = hi3 ? kg[1] : kg[0];
                            kg[0] = keep +
                                    __shfl_xor_sync(0xffffffffu, send, 8);
                        }
                        dv_w[st * kGroupCols] = kg[0];
                    }
                }
            };
            auto both_halves = [&](auto full, auto first) {
                steps(full, first, std::integral_constant<int, 1>{});
                steps(full, first, std::integral_constant<int, 0>{});
            };
            if (len == kChunk) {
                if (j == 0) {
                    both_halves(std::true_type{}, std::true_type{});
                } else {
                    both_halves(std::true_type{}, std::false_type{});
                }
            } else if (j == 0) {
                both_halves(std::false_type{}, std::true_type{});
            } else {
                both_halves(std::false_type{}, std::false_type{});
            }
            if (n_my > 1) {
#pragma unroll
                for (int rr = 0; rr < kRowsT; ++rr) {
#pragma unroll
                    for (int c = 0; c < kCols; ++c) {
                        if (g_ok(g, rr, c)) {
                            g_chunk[g_at(g, rr, c)] = G[rr][c];
                        }
                    }
                }
                __syncthreads();
                dv_epilogue(g);
            }
        }

        // every rank's records of the interval are in place (no global
        // store is in flight here but those of the previous interval)
        cluster.sync();
        if (n_my == 1) {
            dv_epilogue(q);
        }
#pragma unroll
        for (int m = 0; m < kPairs; ++m) {
            const int p = tid + m * kThreads;
            const int st = p / rows_per;
            const int i = e_lo + p % rows_per;
            if (p < n_pairs && st < len && i < Dk) {
                // every rank's record of the row, pushed here, added in
                // rank order
                float s_dr = 0.0f, s_dk = 0.0f, s_dw = 0.0f, vd = 0.0f;
#pragma unroll
                for (int r0 = 0; r0 < kMaxRanks; r0 += 4) {
                    float4 sh[4];
#pragma unroll
                    for (int x = 0; x < 4; ++x) {
                        if (r0 + x < R) {
                            sh[x] = *reinterpret_cast<const float4*>(
                                rs_s + (((r0 + x) * kChunk + st) * rows_per +
                                        i - e_lo) * 4);
                        }
                    }
#pragma unroll
                    for (int x = 0; x < 4; ++x) {
                        if (r0 + x == 0) {
                            s_dr = sh[0].x;
                            s_dk = sh[0].y;
                            s_dw = sh[0].z;
                            vd = sh[0].w;
                        } else if (r0 + x < R) {
                            s_dr += sh[x].x;
                            s_dk += sh[x].y;
                            s_dw += sh[x].z;
                            vd += sh[x].w;
                        }
                    }
                }
                const float ri = rkw_s[st * kMaxDk + i];
                const float ki = rkw_s[kChunk * kMaxDk + st * kMaxDk + i];
                const float ui = u_s[i];
                const int64_t at = row_at(t0 + st, i);
                dr[at] = from_float<T>(fmaf(ui * ki, vd, s_dr));
                dk[at] = from_float<T>(fmaf(ri * ui, vd, s_dk));
                dw[at] = from_float<T>(s_dw);
                du_acc[m] = fmaf(ri * ki, vd, du_acc[m]);
            }
        }
    }
    // no rank leaves while a peer may still read its shared memory
    cluster_sync_relaxed();
    if (ds0 != nullptr && chunk == 0) {
        for (int j = 0; j < n_my; ++j) {
            const int g = q * n_my + j;
#pragma unroll
            for (int rr = 0; rr < kRowsT; ++rr) {
#pragma unroll
                for (int c = 0; c < kCols; ++c) {
                    if (g_ok(g, rr, c)) {
                        ds0[(head * Dk + row0 + rr) * Dv + g_col(g, c)] =
                            n_my > 1 ? g_chunk[g_at(g, rr, c)] : G[rr][c];
                    }
                }
            }
        }
    }
    // du's share of (b, h, chunk): the step slots of each row in order
    float* const du_s = dv_s;                       // [kChunk][rows_per]
#pragma unroll
    for (int m = 0; m < kPairs; ++m) {
        const int p = tid + m * kThreads;
        if (p < n_pairs) {
            du_s[p] = du_acc[m];
        }
    }
    __syncthreads();
    if (tid < rows_per && e_lo + tid < Dk) {
        float sum = du_s[tid];
        for (int st = 1; st < kChunk; ++st) {
            sum += du_s[st * rows_per + tid];
        }
        du_part[(head * n_tc + chunk) * Dk + e_lo + tid] = sum;
    }
}

// Launch 1: for each time chunk [lo, hi) but the first, G walked from
// zero over it, which is a sum of outer products: the recurrence gives
// G_{lo-1} = sum_t c_t dout_t^T with c_t = r_t ⊙ prod_{lo <= u < t} w_u.
// Per row a running product D (D = 1 at lo; c_t = r_t D, then D = D w_t)
// gives c_t, and each output is added over t in ascending order by fmaf
// (a thread holds 4 rows x 4 columns); the chunk's product of w, D at
// hi, goes to decay.  Grid: (64-column tiles, chunks - 1, B * H).
template <typename T>
__global__ void __launch_bounds__(kThreads)
rwkv6_bwd_chunk_kernel(const T* __restrict__ r, const T* __restrict__ w,
                       const T* __restrict__ dout, float* __restrict__ gend,
                       float* __restrict__ decay, int64_t S, int64_t H,
                       int Dk, int Dv, int64_t n_tc) {
    constexpr int kPer = kChunk * kMaxDk / kThreads;     // r, w, dout a thread
    static_assert(kChunkCols == kMaxDk && kChunkCols == 16 * 4 &&
                      kThreads == 16 * 16,
                  "a 16 x 16 thread grid of 4 x 4 tiles");
    __shared__ __align__(16) float rw_s[2][kChunk][kMaxDk];
    __shared__ __align__(16) float c_s[kChunk][kMaxDk];
    __shared__ __align__(16) float d_s[kChunk][kChunkCols];
    const int tid = threadIdx.x;
    const int ty = tid / 16;                    // rows 4*ty .. 4*ty + 3
    const int tx = tid % 16;                    // columns 4*tx .. 4*tx + 3
    const int64_t g = blockIdx.x;
    const int64_t chunk = blockIdx.y + 1;
    const int64_t head = blockIdx.z;
    const int64_t h = head % H;
    const int64_t b = head / H;
    const int64_t n_ckpt = (S + kChunk - 1) / kChunk;
    const int64_t n_lo = chunk * kIntervals;
    const int64_t n_hi = n_lo + kIntervals < n_ckpt ? n_lo + kIntervals
                                                    : n_ckpt;
    // an interval's r and w rows and dout columns, loaded one interval
    // ahead into registers
    float r_n[kPer], w_n[kPer], d_n[kPer];
    auto prefetch = [&](int64_t n) {
        const int64_t t0 = n * kChunk;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
            const int x = tid + j * kThreads;
            const int64_t t = t0 + x / kMaxDk;
            const int i = x % kMaxDk;
            const bool ok = i < Dk && t < S;
            const int64_t at = ((b * S + t) * H + h) * Dk + i;
            r_n[j] = ok ? to_float(r[at]) : 0.0f;
            w_n[j] = ok ? to_float(w[at]) : 0.0f;
            const int64_t col = g * kChunkCols + i;
            const bool okd = dout != nullptr && col < Dv && t < S;
            d_n[j] = okd ? to_float(dout[((b * S + t) * H + h) * Dv + col])
                         : 0.0f;
        }
    };
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            acc[a][c] = 0.0f;
        }
    }
    float D = 1.0f;                             // row tid's product (tid < 64)
    prefetch(n_lo);
    for (int64_t n = n_lo; n < n_hi; ++n) {
        const int64_t t0 = n * kChunk;
        const int len = S - t0 < kChunk ? static_cast<int>(S - t0) : kChunk;
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
            const int x = tid + j * kThreads;
            rw_s[0][x / kMaxDk][x % kMaxDk] = r_n[j];
            rw_s[1][x / kMaxDk][x % kMaxDk] = w_n[j];
            d_s[x / kMaxDk][x % kMaxDk] = d_n[j];
        }
        __syncthreads();
        if (n + 1 < n_hi) {
            prefetch(n + 1);     // in flight while this interval runs
        }
        if (tid < kMaxDk) {
            for (int st = 0; st < len; ++st) {
                c_s[st][tid] = rw_s[0][st][tid] * D;
                D = D * rw_s[1][st][tid];
            }
        }
        __syncthreads();
        for (int st = 0; st < len; ++st) {
            const float4 c4 = *reinterpret_cast<const float4*>(
                &c_s[st][4 * ty]);
            const float4 d4 = *reinterpret_cast<const float4*>(
                &d_s[st][4 * tx]);
            const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
            const float dv4[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
            for (int a = 0; a < 4; ++a) {
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    acc[a][c] = fmaf(cv[a], dv4[c], acc[a][c]);
                }
            }
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        const int row = 4 * ty + a;
        if (row < Dk) {
            float* const out = gend + ((head * n_tc + chunk) * Dk + row) *
                                          static_cast<int64_t>(Dv);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int64_t col = g * kChunkCols + 4 * tx + c;
                if (col < Dv) {
                    out[col] = acc[a][c];
                }
            }
        }
    }
    if (g == 0 && tid < Dk) {
        decay[(head * n_tc + chunk) * Dk + tid] = D;
    }
}

// Launch 2: one thread a state element walks the chunks from the last,
// G = dS_last (or 0) there and G of chunk c - 1 = fmaf(decay_c, G of
// chunk c, launch 1's walk of chunk c), and writes each chunk's entering
// G over launch 1's walk (read first), loads issued kBatch chunks ahead.
__global__ void __launch_bounds__(kThreads)
rwkv6_bwd_carry_kernel(const float* __restrict__ ds_last,
                       float* __restrict__ gend,
                       const float* __restrict__ decay, int64_t n_elems,
                       int Dk, int Dv, int64_t n_tc) {
    const int64_t at = static_cast<int64_t>(blockIdx.x) * kThreads +
                       threadIdx.x;
    if (at >= n_elems) {
        return;
    }
    const int64_t DkDv = static_cast<int64_t>(Dk) * Dv;
    const int64_t head = at / DkDv;
    const int64_t e = at % DkDv;
    const int64_t i = e / Dv;
    float G = ds_last != nullptr ? ds_last[at] : 0.0f;
    for (int64_t c0 = n_tc - 1; c0 >= 0; c0 -= kBatch) {
        float bl[kBatch], de[kBatch];
#pragma unroll
        for (int x = 0; x < kBatch; ++x) {
            const int64_t c = c0 - x;
            if (c >= 1) {
                bl[x] = gend[(head * n_tc + c) * DkDv + e];
                de[x] = decay[(head * n_tc + c) * Dk + i];
            }
        }
#pragma unroll
        for (int x = 0; x < kBatch; ++x) {
            const int64_t c = c0 - x;
            if (c >= 0) {
                gend[(head * n_tc + c) * DkDv + e] = G;
                if (c >= 1) {
                    G = fmaf(de[x], G, bl[x]);
                }
            }
        }
    }
}

// Launch 4: du[h, i] = the shares of every (b, chunk), b first, in order
__global__ void rwkv6_bwd_du_kernel(const float* __restrict__ du_part,
                                    float* __restrict__ du, int64_t B,
                                    int64_t H, int64_t Dk, int64_t n_tc) {
    const int64_t at = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
    if (at >= H * Dk) {
        return;
    }
    const int64_t h = at / Dk;
    const int64_t i = at % Dk;
    float sum = 0.0f;
    for (int64_t b = 0; b < B; ++b) {
        for (int64_t c = 0; c < n_tc; ++c) {
            const float x = du_part[((b * H + h) * n_tc + c) * Dk + i];
            sum = b == 0 && c == 0 ? x : sum + x;
        }
    }
    du[at] = sum;
}

// the ranks of a head's cluster and the column groups a rank walks
int n_ranks(int64_t Dv) {
    const int64_t groups = (Dv + kGroupCols - 1) / kGroupCols;
    int R = 1;
    while (R < groups && R < kMaxRanks) {
        R *= 2;
    }
    return R;
}

int64_t n_mine(int64_t Dv) {
    const int64_t groups = (Dv + kGroupCols - 1) / kGroupCols;
    const int R = n_ranks(Dv);
    return (groups + R - 1) / R;
}

int64_t n_time_chunks(int64_t S) {
    const int64_t n_ckpt = (S + kChunk - 1) / kChunk;
    return (n_ckpt + kIntervals - 1) / kIntervals;
}

// gend [B * H, chunks, Dk, Dv], decay and du's shares [B * H, chunks, Dk]
int64_t scratch_len(int64_t B, int64_t S, int64_t H, int64_t Dk,
                    int64_t Dv) {
    return B * H * n_time_chunks(S) * Dk * (Dv + 2);
}

// whether the staging copies may move 16-byte units: rows and columns
// that are whole units, and every array 16-byte aligned
template <typename T>
bool vec_ok(const T* r, const T* k, const T* v, const T* w, const T* dout,
            const float* ckpt, int64_t Dk, int64_t Dv) {
    const int64_t e = 16 / static_cast<int64_t>(sizeof(T));
    auto aligned = [](const void* p) {
        return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
    };
    return Dk % e == 0 && Dv % e == 0 && Dv % 4 == 0 && aligned(r) &&
           aligned(k) && aligned(v) && aligned(w) && aligned(dout) &&
           aligned(ckpt);
}

template <typename T>
int launch(const T* r, const T* k, const T* v, const T* w, const float* u,
           const T* dout, const float* ds_last, const float* ckpt,
           float* scratch, T* dr, T* dk, T* dv, T* dw, float* du, float* ds0,
           int64_t B, int64_t S, int64_t H, int64_t Dk, int64_t Dv,
           void* stream) {
    const int64_t n_tc = n_time_chunks(S);
    const int64_t groups = (Dv + kGroupCols - 1) / kGroupCols;
    if (B <= 0 || H <= 0 || S <= 0 || Dk <= 0 || Dv <= 0 || Dk > kMaxDk ||
        B * H > 65535 || n_tc > 65535 || groups > 0x7fffffff) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    float* const gend = scratch;
    float* const decay = gend + B * H * n_tc * Dk * Dv;
    float* const du_part = decay + B * H * n_tc * Dk;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (n_tc > 1) {
        rwkv6_bwd_chunk_kernel<T><<<dim3(static_cast<unsigned>(
                                             (Dv + kChunkCols - 1) /
                                             kChunkCols),
                                         static_cast<unsigned>(n_tc - 1),
                                         static_cast<unsigned>(B * H)),
                                    kThreads, 0, st>>>(
            r, w, dout, gend, decay, S, H, static_cast<int>(Dk),
            static_cast<int>(Dv), n_tc);
        err = cudaGetLastError();
        if (err != cudaSuccess) {
            return static_cast<int>(err);
        }
    }
    const int64_t n_elems = B * H * Dk * Dv;
    rwkv6_bwd_carry_kernel<<<static_cast<unsigned>(
                                 (n_elems + kThreads - 1) / kThreads),
                             kThreads, 0, st>>>(
        ds_last, gend, decay, n_elems, static_cast<int>(Dk),
        static_cast<int>(Dv), n_tc);
    err = cudaGetLastError();
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    constexpr size_t kSmem = smem_bytes<T>();
    err = cudaFuncSetAttribute(
        rwkv6_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmem));
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    const int R = n_ranks(Dv);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(R), static_cast<unsigned>(n_tc),
                       static_cast<unsigned>(B * H));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(R);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, rwkv6_bwd_kernel<T>, r, k, v, w, u, dout,
                             ckpt, gend, du_part, dr, dk, dv, dw, ds0, S, H,
                             static_cast<int>(Dk), static_cast<int>(Dv),
                             static_cast<int>(n_mine(Dv)),
                             static_cast<int>(vec_ok(r, k, v, w, dout, ckpt,
                                                     Dk, Dv)),
                             n_tc);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    rwkv6_bwd_du_kernel<<<static_cast<unsigned>((H * Dk + 255) / 256), 256,
                          0, st>>>(du_part, du, B, H, Dk, n_tc);
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
    return scratch_len(B, S, H, Dk, Dv);
}

}  // extern "C"
