// Flash attention (forward) for Hopper (sm_90a), bound through a plain C
// interface.
//
// Replaces the TPU kernel `_fa_kernel` of the JAX package
// (src/repro/kernels/flash_attention.py:29, launched at :120).
//
// What it computes: for q [B, Sq, Hq, Dqk], k [B, Sk, Hkv, Dqk] and
// v [B, Sk, Hkv, Dv] (the JAX package's layout, read in place with row
// strides Hq*Dqk, Hkv*Dqk and Hkv*Dv; nothing is repeated or transposed in
// device memory), out [B, Sq, Hq, Dv] with
// out[b, i, h] = softmax_j(s_ij) . v[b, j, h']
// with h' = h / (Hq / Hkv) (GQA), s_ij = (q_i . k_j) * scale, then the
// optional tanh softcap s = tanh(s / cap) * cap, then the mask: j < Sk,
// j <= pos_i when causal, j > pos_i - window when windowed, where
// pos_i = q_offset + i.  A masked score is -1e30, not -inf, as in the TPU
// kernel; the softmax is the online one (running max m, running sum l and
// the accumulator, all float32), and a row whose sum is 0 divides by 1.
// k tiles wholly outside the causal / window band of a warpgroup's rows
// are not visited: the TPU kernel visits them, and its rescale
// alpha = exp(m_prev - m_new) wipes what they added (or they add exactly
// 0), so the result is the same.  Rows of the k and v tiles past Sk are
// zeros (0 * garbage would be NaN).  float32 or bfloat16 in, float32
// inside, out in the input's type.  With `lse` it also writes each row's
// log-sum-exp m + log(l) (+inf where l = 0) for the backward
// (flash_attention_bwd.cu); `out` is the same either way.
//
// Bound.  Every unmasked (query, key) pair costs 2*(Dqk + Dv) operations.
// float32 runs as split TF32, three TF32 products for each: at
// recurrentgemma-9b's serving shape (B=2, S=3072, 16 heads, 1 kv head,
// head_dim 256, window 2048) 4.1e11 operations over 495 TFLOP/s = 0.83 ms;
// bf16 at the bf16 rate, a sixth of that.
//
// Previous design: mma.sync m16n8, 8 warps of 16 q rows and
// 16-key tiles, where every warp split every K and V element it read into
// TF32 hi and lo (most of its instructions), 237 registers at D = 256:
// 3.31 ms at the serving shape, 25 % of its bound, and 3.2-3.6 % slower
// than SDPA at MLA's (192, 128) (H100 80GB HBM3, 700 W; PERF.md).  It
// ran float32 at D = 256 until the D-halved body below replaced it.
//
// This design (warpgroup products, `wgmma`, hopper_common.cuh), timed
// part by part with tools/fa_sweep.py --apart (PERF.md):
// - A block is kWG consumer warpgroups of 64 q rows each (`wgmma`'s M)
//   and no producer: ptxas holds a block of 288 or more threads to 168
//   registers (PERF.md), and 256 get 255.  Each warpgroup forms
//   S = Q K^T (N = kNk keys) and O += P V (N = Dv) for its own rows.
// - bf16 (FlashAttention-3's operand roles): Q in shared memory in the
//   128-byte swizzled K-major layout, S with A and B in shared memory
//   (`WgmmaSS`); P goes from S's accumulator into A registers as it stands
//   (the accumulator's layout is A's), and V is read MN-major as it lands
//   (`WgmmaRT`: B transposed), so nothing is re-laid by the threads.
// - float32: `.tf32` takes only K-major operands and no transpose, so
//   each tile is split once by the block when it lands, and no warp
//   splits what another has split: K lands in the swizzled layout and is
//   split in place (its TF32 hi written over it, lo beside it); V lands
//   as rows and is written transposed (keys along the row) as hi and lo
//   tiles, in the key order that makes S's accumulator fragment P's A
//   fragment without a shuffle (within 8 keys, k index t <-> key 2t,
//   t + 4 <-> key 2t + 1).  Q stays in shared memory as float32 with the
//   contraction index permuted within each 8 (d t and t + 4 side by side,
//   one 8-byte load for both A registers of a row) and is split into A
//   registers a chunk of k-steps ahead of its products (`product`): Q's
//   hi and lo for 64 rows at D = 256 would take 128 KB, and as A
//   registers 256 registers a thread.  Each product is hi.hi, hi.lo,
//   lo.hi (hi rounded to nearest, lo passed whole: the tensor core reads
//   it rounded toward zero), into one float32 accumulator.  The splits
//   run while the tensor cores work: V(i)'s while S(i) runs, K(i+1)'s
//   while O(i) runs (the split took 25-29 % of the time before).
// - No product sits in a branch: a tile that hides all of a warpgroup's
//   rows still runs its products, with P = 0 and the softmax state left
//   as it is; otherwise ptxas serializes every wgmma (C7518).  The mask
//   and the softcap are decided once a tile (`body`): a tile inside the
//   band for all of a warpgroup's rows skips the element tests, which take
//   int32 offsets from the warpgroup's first position.
// - Copies: a ring of kStages stages filled with 16-byte cp.async (zeros
//   past Sk, and past the head dim where a row is padded to 128 bytes)
//   by every thread, each a fixed chunk of a 128-byte row block in rows
//   a fixed step apart (`copy_tile`: an add and a compare a copy; the
//   copies' address arithmetic had cost 15-28 %); one __syncthreads a
//   tile keeps the warpgroups in step (three in float32, around the
//   splits).  q tiles are walked last to first, so the causal tiles with
//   the most keys start first.
// - Tile shapes (`Tune`, timed by tools/fa_sweep.py --variants): float32
//   two warpgroups, 64-key tiles below D = 128, 32 at 128, 16 at (192,
//   128) (the Q rows of two warpgroups take 100 KB there); bf16 two
//   warpgroups and 128 keys (64 at D = 256, where O takes 128
//   registers).
// - float32 at D = 256 (`kHalves`): whole split tiles beside two
//   warpgroups' Q (132 KB padded) do not fit, and one warpgroup with
//   16-key tiles (S on m64n16 products) was slower than the previous
//   body.  So each K and V tile of 32 keys streams as two 128-column
//   halves through a ring of two 16 KB halves (K swizzled, V as rows),
//   and the block splits each half into a slot of its own (a hi and a lo
//   half: K's in the swizzled layout, V^T's transposed), slot h for half
//   h: S sums K's halves in one accumulator (k-steps of half 0 from slot
//   0, then half 1's from slot 1), O's pieces 0-1 take V^T's half 0 and
//   pieces 2-3 half 1.  Q is stored unpadded (128 KB), each 16-byte chunk
//   of a row at chunk c ^ (row % 8) so that the fragment loads stay free
//   of conflicts.  V(i) lands while S(i) runs and K(i+1) while O(i) runs;
//   the splits run between barriers (the slots are shared by both
//   warpgroups; splitting each half under the other half's products, six
//   barriers a tile, was no faster on an H100: 2.17 against 2.12-2.15 ms).
// Every sum has one order, so two calls give the same bits.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -Xcompiler -fPIC -c, then linked -shared (see
//        core/cuda/_build.py).
#include <type_traits>

#include "fa_common.cuh"
#include "hopper_common.cuh"

namespace {

// A launch's tile shape: kWG warpgroups of 64 q rows, kNk keys a tile,
// kStages stages of the ring, and HALVES 1 for float32 at D = 256, each K
// and V tile streamed as two 128-column halves (the ring then holds
// kStages halves)
template <bool kF32, int DQ, int DV>
struct Tune;
#define REPRO_FA_TUNE(F32, DQ, DV, WG, NK, STAGES, HALVES)                   \
    template <>                                                               \
    struct Tune<F32, DQ, DV> {                                                \
        static constexpr int kWG = WG, kNk = NK, kStages = STAGES;            \
        static constexpr bool kHalves = HALVES;                               \
    };
REPRO_FA_TUNE(true, 16, 16, 2, 64, 2, 0)
REPRO_FA_TUNE(true, 32, 32, 2, 64, 2, 0)
REPRO_FA_TUNE(true, 64, 64, 2, 64, 2, 0)
REPRO_FA_TUNE(true, 128, 128, 2, 32, 2, 0)
REPRO_FA_TUNE(true, 192, 128, 2, 16, 2, 0)
REPRO_FA_TUNE(true, 256, 256, 2, 32, 2, 1)
REPRO_FA_TUNE(false, 16, 16, 2, 128, 2, 0)
REPRO_FA_TUNE(false, 32, 32, 2, 128, 2, 0)
REPRO_FA_TUNE(false, 64, 64, 2, 128, 2, 0)
REPRO_FA_TUNE(false, 128, 128, 2, 128, 2, 0)
REPRO_FA_TUNE(false, 192, 128, 2, 128, 2, 0)
REPRO_FA_TUNE(false, 256, 256, 2, 64, 2, 0)
#undef REPRO_FA_TUNE

template <typename T, int DQ, int DV>
struct FwdCfg {
    static constexpr bool kF32 = std::is_same<T, float>::value;
    using Tn = Tune<kF32, DQ, DV>;
    static constexpr int kWG = Tn::kWG;
    static constexpr int kNk = Tn::kNk;
    static constexpr int kStages = Tn::kStages;
    static constexpr bool kHalves = Tn::kHalves;
    static constexpr int kEs = static_cast<int>(sizeof(T));
    static constexpr int kThreads = 128 * kWG;
    static constexpr int kBlockQ = 64 * kWG;
    // a swizzled row is at least 128 bytes: Q and K are padded with zeros
    // to kDq columns, bf16 V to kDvp (O's extra columns are not stored)
    static constexpr int kRow = 128 / kEs;
    static constexpr int kDq = DQ < kRow ? kRow : DQ;
    static constexpr int kDvp = kF32 ? DV : (DV < kRow ? kRow : DV);
    // O's products: pieces of kPn columns (float32 Wgmma up to 64, bf16
    // WgmmaRT 64 or 128)
    static constexpr int kPn = kF32 ? (DV < 64 ? DV : 64)
                                    : (kDvp < 128 ? kDvp : 128);
    static constexpr int kPieces = kDvp / kPn;
    static constexpr int kK = kF32 ? 8 : 16;      // wgmma's K
    static constexpr int kChunk = kDq / kK < 4 ? kDq / kK : 4;
    // float32 Q rows: kDq and 8 floats (fragment loads free of conflicts)
    static constexpr int kLdQ = kDq + 8;
    static constexpr int kQBytes =
        kF32 ? kBlockQ * kLdQ * 4 : kBlockQ * kDq * kEs;
    static constexpr int kKBytes = kNk * kDq * kEs;      // a stage's K
    static constexpr int kVBytes = kNk * kDvp * kEs;     // and its V
    static constexpr int kStage = kKBytes + kVBytes;
    // float32: K's lo tile and V^T's hi and lo (DV rows of kNkp keys, at
    // least 32: one 128-byte row)
    static constexpr int kNkp = kNk < 32 ? 32 : kNk;
    static constexpr int kVtBytes = DV * kNkp * 4;
    static constexpr int kOffStages = (kQBytes + 1023) / 1024 * 1024;
    static constexpr int kOffKlo = kOffStages + kStages * kStage;
    static constexpr int kOffVt = kOffKlo + (kF32 ? kKBytes : 0);
    // kHalves: Q unpadded (rows swizzled in 16-byte chunks instead), a
    // ring of kStages halves of kHw columns (K swizzled, V as rows), and
    // two slots of a hi and a lo half (K's split, or V^T's: kHw rows of
    // kNk keys), slot h for half h
    static constexpr int kHw = DQ / 2;
    static constexpr int kHalf = kNk * kHw * 4;
    static constexpr int kOffLand = kBlockQ * kDq * 4;
    static constexpr int kOffSlots = kOffLand + kStages * kHalf;
    static constexpr int kBytes =
        kHalves ? kOffSlots + 4 * kHalf + 1024
                : kOffVt + (kF32 ? 2 * kVtBytes : 0) + 1024;   // alignment
    static_assert(!kHalves || (kF32 && DQ == 256 && DV == 256 &&
                               kNk == 32 && kHalf % 1024 == 0),
                  "halves: float32 at (256, 256), a V^T half one "
                  "128-byte row of keys");
    static_assert(kKBytes % 1024 == 0 && kVBytes % 1024 == 0 &&
                      kVtBytes % 1024 == 0,
                  "swizzled tiles start on 1024 bytes");
    static_assert(kNk % 16 == 0 && kNk <= (kF32 ? 64 : 128), "N of S");
    static_assert(kStages >= 2, "a tile loads while another is computed");
    static_assert((kDq / kK) % kChunk == 0, "chunks of whole k-steps");
    static_assert(kBytes <= 232448, "shared memory of a block");
};

// rows [row0, row0 + Rows) of a head (row stride `stride` elements) into
// shared memory at `dst`, Wp >= W columns a row: in the 128-byte swizzled
// layout (column blocks of Rows x 128 bytes), or as plain rows of Wp; zeros
// past column W and from row `valid` on (no address past it is formed).
// 16 bytes a copy: a thread keeps one 16-byte chunk of a 128-byte row
// block and takes rows Threads / 8 apart (a multiple of 8, so its
// swizzled chunk is the same in every row), so a copy costs an add and a
// compare besides the cp.async
template <typename T, int W, int Wp, int Rows, int Threads, bool kSwizzle>
__device__ __forceinline__ void copy_tile(unsigned char* dst, const T* head,
                                          int64_t stride, int64_t row0,
                                          int64_t valid) {
    constexpr int kEs = static_cast<int>(sizeof(T));
    constexpr int kPer = 16 / kEs;
    constexpr int kRowBytes = Wp * kEs;
    constexpr int kCpb = kRowBytes < 128 ? kRowBytes / 16 : 8;
    constexpr int kBlocks = kRowBytes < 128 ? 1 : kRowBytes / 128;
    constexpr int kStep = Threads / kCpb;
    static_assert(!kSwizzle || (kRowBytes % 128 == 0 && kStep % 8 == 0),
                  "swizzled rows of whole 128-byte blocks");
    const int xc = static_cast<int>(threadIdx.x) % kCpb;
    const int r0 = static_cast<int>(threadIdx.x) / kCpb;
    const uint32_t chunk = kSwizzle ? ((xc ^ (r0 & 7)) << 4) : (xc << 4);
    const int64_t left = valid - row0 - r0;   // rows of this thread's own
    const T* src = head + (row0 + r0) * stride + xc * kPer;
    const int64_t step = static_cast<int64_t>(kStep) * stride;
#pragma unroll
    for (int pass = 0; pass < (Rows + kStep - 1) / kStep; ++pass) {
        const int r = r0 + pass * kStep;
        if (Rows % kStep != 0 && r >= Rows) {
            break;
        }
        const bool row_ok = pass * kStep < left;
#pragma unroll
        for (int cb = 0; cb < kBlocks; ++cb) {
            const bool ok = row_ok && (cb * 8 + xc) * kPer < W;
            const uint32_t off =
                kSwizzle ? cb * Rows * 128 + r * 128 + chunk
                         : r * kRowBytes + cb * 128 + chunk;
            cp_async16(dst + off,
                       ok ? src + pass * step + cb * (128 / kEs) : head, ok);
        }
    }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float a, float b) {
    // round to nearest even, as astype does
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, int DQ, int DV>
__global__ void __launch_bounds__(FwdCfg<T, DQ, DV>::kThreads, 1)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              float* __restrict__ lse, int64_t Sq, int64_t Sk, int Hq,
              int Hkv, int causal, int has_window, int64_t window,
              int has_softcap, float softcap, float scale,
              int64_t q_offset) {
    using C = FwdCfg<T, DQ, DV>;
    constexpr int kNk = C::kNk, kStages = C::kStages, kDq = C::kDq;
    constexpr int kPn = C::kPn, kPieces = C::kPieces;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    unsigned char* stages = smem + C::kOffStages;

    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) >> 5;   // within the warpgroup
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    // the last q tile first: under a causal mask it has the most keys
    const int64_t q0 =
        static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * C::kBlockQ;
    const int h = blockIdx.y;
    const int64_t b = blockIdx.z;
    const int hk = h / (Hq / Hkv);
    // per position: q and k rows are DQ wide, v and out rows DV
    const int64_t q_stride = static_cast<int64_t>(Hq) * DQ;
    const int64_t k_stride = static_cast<int64_t>(Hkv) * DQ;
    const int64_t v_stride = static_cast<int64_t>(Hkv) * DV;
    const int64_t o_stride = static_cast<int64_t>(Hq) * DV;
    const T* qb = q + (b * Sq * Hq + h) * DQ;
    const T* kb = k + (b * Sk * Hkv + hk) * DQ;
    const T* vb = v + (b * Sk * Hkv + hk) * DV;
    T* ob = out + (b * Sq * Hq + h) * DV;

    // the k tiles the block's rows can see
    const int64_t rows = (Sq - q0 < C::kBlockQ) ? (Sq - q0) : C::kBlockQ;
    const int64_t pos_lo = q_offset + q0;
    const int64_t pos_hi = pos_lo + rows - 1;
    int64_t k_begin = 0;
    int64_t k_end = Sk;
    if (causal && pos_hi + 1 < k_end) {
        k_end = pos_hi + 1;
    }
    if (has_window && pos_lo - window + 1 > k_begin) {
        k_begin = pos_lo - window + 1;
    }
    const int64_t t_begin = k_begin / kNk;
    const int64_t n_tiles =
        k_end > k_begin ? (k_end + kNk - 1) / kNk - t_begin : 0;

    // tile m of the band into stage m % kStages: K swizzled, V swizzled
    // (bf16, read MN-major) or as rows (float32, transposed by the split)
    auto fill = [&](int64_t m) {
        const int64_t k0 = (t_begin + m) * kNk;
        unsigned char* st = stages + (m % kStages) * C::kStage;
        copy_tile<T, DQ, kDq, kNk, C::kThreads, true>(st, kb, k_stride, k0,
                                                      Sk);
        if constexpr (C::kF32) {
            copy_tile<T, DV, DV, kNk, C::kThreads, false>(
                st + C::kKBytes, vb, v_stride, k0, Sk);
        } else {
            copy_tile<T, DV, C::kDvp, kNk, C::kThreads, true>(
                st + C::kKBytes, vb, v_stride, k0, Sk);
        }
    };

    // kHalves: half hh of tile m's K (y 0) or V (y 1) into the ring's
    // half hh (one cp.async group)
    auto fill_half = [&](int64_t m, int y, int hh) {
        if constexpr (C::kHalves) {
            const int64_t k0 = (t_begin + m) * kNk;
            unsigned char* dst = smem + C::kOffLand + hh * C::kHalf;
            if (m < n_tiles) {
                if (y == 0) {
                    copy_tile<T, C::kHw, C::kHw, kNk, C::kThreads, true>(
                        dst, kb + hh * C::kHw, k_stride, k0, Sk);
                } else {
                    copy_tile<T, C::kHw, C::kHw, kNk, C::kThreads, false>(
                        dst, vb + hh * C::kHw, v_stride, k0, Sk);
                }
            }
            cp_async_commit();
        }
    };

    // Q of the block's rows (zeros past Sq and past DQ)
    if constexpr (C::kHalves) {
        // as below, and each 16-byte chunk c of a row r stored at chunk
        // c ^ (r % 8) of its 128 bytes: no padding, and a warp's fragment
        // loads still touch every bank evenly
        for (int i = threadIdx.x; i < C::kBlockQ * (kDq / 8);
             i += C::kThreads) {
            const int r = i / (kDq / 8);
            const int s = i % (kDq / 8);
            float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f), x1 = x0;
            if (q0 + r < Sq) {
                const float* src = reinterpret_cast<const float*>(qb) +
                                   (q0 + r) * q_stride + 8 * s;
                x0 = *reinterpret_cast<const float4*>(src);
                x1 = *reinterpret_cast<const float4*>(src + 4);
            }
            unsigned char* row = smem + r * kDq * 4 + (s >> 2) * 128;
            const int c = 2 * (s & 3);
            *reinterpret_cast<float4*>(row + ((c ^ (r & 7)) << 4)) =
                make_float4(x0.x, x1.x, x0.y, x1.y);
            *reinterpret_cast<float4*>(row + (((c + 1) ^ (r & 7)) << 4)) =
                make_float4(x0.z, x1.z, x0.w, x1.w);
        }
    } else if constexpr (C::kF32) {
        // 8 floats a thread: d 8s..8s+7 of a row stored as d 8s, 8s+4,
        // 8s+1, 8s+5, 8s+2, 8s+6, 8s+3, 8s+7
        float* qs = reinterpret_cast<float*>(smem);
        for (int i = threadIdx.x; i < C::kBlockQ * (kDq / 8);
             i += C::kThreads) {
            const int r = i / (kDq / 8);
            const int s = i % (kDq / 8);
            float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f), x1 = x0;
            if (q0 + r < Sq && 8 * s < DQ) {
                const float* src = reinterpret_cast<const float*>(qb) +
                                   (q0 + r) * q_stride + 8 * s;
                x0 = *reinterpret_cast<const float4*>(src);
                x1 = *reinterpret_cast<const float4*>(src + 4);
            }
            float* dst = qs + r * C::kLdQ + 8 * s;
            *reinterpret_cast<float4*>(dst) =
                make_float4(x0.x, x1.x, x0.y, x1.y);
            *reinterpret_cast<float4*>(dst + 4) =
                make_float4(x0.z, x1.z, x0.w, x1.w);
        }
    } else {
        for (int w = 0; w < C::kWG; ++w) {
            copy_tile<T, DQ, kDq, 64, C::kThreads, true>(
                smem + w * 64 * kDq * C::kEs, qb, q_stride, q0 + 64 * w, Sq);
        }
    }
    // the ring's first tiles: bf16 refills a stage at the top of the next
    // tile, float32 once the tile's S and split are past it
    constexpr int kAhead = C::kF32 ? kStages : kStages - 1;
    if constexpr (C::kHalves) {
        fill_half(0, 0, 0);
        fill_half(0, 0, 1);
    } else {
        for (int64_t m = 0; m < kAhead; ++m) {
            if (m < n_tiles) {
                fill(m);
            }
            cp_async_commit();   // one group a tile, empty or not
        }
    }

    // this warpgroup's rows [wq0, wq0 + 64), of which wrows < Sq; this
    // thread's are 16 * warp + g and that + 8
    const int64_t wq0 = q0 + 64 * wg;
    const int64_t wrows = Sq - wq0 < 64 ? (Sq > wq0 ? Sq - wq0 : 0) : 64;
    const int64_t wpos_lo = q_offset + wq0;
    const int64_t wpos_hi = wpos_lo + (wrows > 0 ? wrows : 1) - 1;
    const int64_t my_pos[2] = {wpos_lo + 16 * warp + g,
                               wpos_lo + 16 * warp + g + 8};

    float o[kPieces][kPn / 2];
#pragma unroll
    for (int c = 0; c < kPieces; ++c) {
#pragma unroll
        for (int i = 0; i < kPn / 2; ++i) {
            o[c][i] = 0.f;
        }
    }
    float m_run[2] = {kNegInf, kNegInf};
    float l_run[2] = {0.f, 0.f};
    constexpr float kLog2e = 1.4426950408889634f;

    const uint32_t q_addr = smem_u32(smem);
    const float* qw = reinterpret_cast<const float*>(smem) +
                      (64 * wg + 16 * warp) * C::kLdQ;
    const uint32_t klo_addr = smem_u32(smem + C::kOffKlo);
    const uint32_t vt_addr = smem_u32(smem + C::kOffVt);

    // float32's split of a tile, by every thread: K in place (its TF32 hi
    // over the raw value, lo in its own tile), and V into V^T's hi and lo
    // tiles, thread item (key group kg, parity p, column d) taking keys
    // 8kg + p + 2j, j < 4, which sit side by side in V^T's key order
    auto split_k = [&](int64_t m) {
        uint32_t* kh = reinterpret_cast<uint32_t*>(
            stages + (m % kStages) * C::kStage);
        uint32_t* kl = reinterpret_cast<uint32_t*>(smem + C::kOffKlo);
        static_assert(C::kKBytes / 16 % C::kThreads == 0, "whole rounds");
#pragma unroll
        for (int it = 0; it < C::kKBytes / 16 / C::kThreads; ++it) {
            const int x = threadIdx.x + it * C::kThreads;
            const float4 raw = reinterpret_cast<const float4*>(kh)[x];
            uint4 hi;
            uint4 lo;
            split(raw.x, hi.x, lo.x);
            split(raw.y, hi.y, lo.y);
            split(raw.z, hi.z, lo.z);
            split(raw.w, hi.w, lo.w);
            reinterpret_cast<uint4*>(kh)[x] = hi;
            reinterpret_cast<uint4*>(kl)[x] = lo;
        }
    };
    auto split_v = [&](int64_t m) {
        const float* vr = reinterpret_cast<const float*>(
            stages + (m % kStages) * C::kStage + C::kKBytes);
        unsigned char* vt = smem + C::kOffVt;
        static_assert(kNk / 8 * 2 * DV % C::kThreads == 0, "whole rounds");
#pragma unroll
        for (int it = 0; it < kNk / 8 * 2 * DV / C::kThreads; ++it) {
            const int x = threadIdx.x + it * C::kThreads;
            const int d = x % DV;
            const int p = (x / DV) & 1;
            const int kg = x / (2 * DV);
            uint4 hi;
            uint4 lo;
            const float* src = vr + (8 * kg + p) * DV + d;
            split(src[0], hi.x, lo.x);
            split(src[2 * DV], hi.y, lo.y);
            split(src[4 * DV], hi.z, lo.z);
            split(src[6 * DV], hi.w, lo.w);
            const uint32_t off = sw128_offset(DV, d, 32 * kg + 16 * p);
            *reinterpret_cast<uint4*>(vt + off) = hi;
            *reinterpret_cast<uint4*>(vt + C::kVtBytes + off) = lo;
        }
    };
    // kHalves: the ring's K halves split into the slots' hi and lo halves
    // (the same swizzled layout), and its V halves into V^T's (as split_v)
    const uint32_t slot_addr = smem_u32(smem + C::kOffSlots);
    auto split_k_half = [&](int hh) {
        if constexpr (C::kHalves) {
            constexpr int kPer = C::kHalf / 16 / C::kThreads;
            static_assert(kPer * 16 * C::kThreads == C::kHalf, "rounds");
            const float4* src = reinterpret_cast<const float4*>(
                smem + C::kOffLand + hh * C::kHalf);
            uint4* dst = reinterpret_cast<uint4*>(smem + C::kOffSlots +
                                                  hh * 2 * C::kHalf);
#pragma unroll
            for (int it = 0; it < kPer; ++it) {
                const int x = threadIdx.x + it * C::kThreads;
                const float4 raw = src[x];
                uint4 hi;
                uint4 lo;
                split(raw.x, hi.x, lo.x);
                split(raw.y, hi.y, lo.y);
                split(raw.z, hi.z, lo.z);
                split(raw.w, hi.w, lo.w);
                dst[x] = hi;
                dst[x + C::kHalf / 16] = lo;
            }
        }
    };
    auto split_v_half = [&](int hh) {
        if constexpr (C::kHalves) {
            constexpr int kHw = C::kHw;
            constexpr int kPer = kNk / 8 * 2 * kHw / C::kThreads;
            static_assert(kPer * C::kThreads == kNk / 8 * 2 * kHw, "rounds");
            const float* vr = reinterpret_cast<const float*>(
                smem + C::kOffLand + hh * C::kHalf);
            unsigned char* vt = smem + C::kOffSlots + hh * 2 * C::kHalf;
#pragma unroll
            for (int it = 0; it < kPer; ++it) {
                const int x = threadIdx.x + it * C::kThreads;
                const int d = x % kHw;
                const int p = (x / kHw) & 1;
                const int kg = x / (2 * kHw);
                uint4 hi;
                uint4 lo;
                const float* src = vr + (8 * kg + p) * kHw + d;
                split(src[0], hi.x, lo.x);
                split(src[2 * kHw], hi.y, lo.y);
                split(src[4 * kHw], hi.z, lo.z);
                split(src[6 * kHw], hi.w, lo.w);
                const uint32_t off = sw128_offset(kHw, d, 32 * kg + 16 * p);
                *reinterpret_cast<uint4*>(vt + off) = hi;
                *reinterpret_cast<uint4*>(vt + C::kHalf + off) = lo;
            }
        }
    };
    if constexpr (C::kF32 && !C::kHalves) {
        if (n_tiles > 0) {   // tile 0's K, published by the loop's barrier
            cp_async_wait<kStages - 1>();
            __syncthreads();
            split_k(0);
            fence_proxy_async();
        }
    }

    // P's A registers: float32 hi and lo a k-step of 8 keys, bf16 pairs a
    // k-step of 16
    uint32_t ph[C::kF32 ? kNk / 8 : 1][4], pl[C::kF32 ? kNk / 8 : 1][4];
    uint32_t pa[C::kF32 ? 1 : kNk / 16][4];
    const uint64_t dq = sw128_desc(q_addr + wg * 64 * kDq * C::kEs, 64, 0);
    for (int64_t i = 0; i < n_tiles; ++i) {
        const int64_t k0 = (t_begin + i) * kNk;
        unsigned char* st = stages + (i % kStages) * C::kStage;
        const uint32_t k_addr = smem_u32(st);
        if constexpr (C::kHalves) {
            cp_async_wait<0>();   // this thread's copies of K(i)
            __syncthreads();   // every copy is in; O(i-1) is done everywhere
            split_k_half(0);
            split_k_half(1);
            fence_proxy_async();
            __syncthreads();   // the slots hold K(i); the ring is free
            fill_half(i, 1, 0);   // V(i) lands while S(i) runs
            fill_half(i, 1, 1);
        } else if constexpr (C::kF32) {
            __syncthreads();   // K(i) is split; tile i-1 is done everywhere
        } else {
            cp_async_wait<kStages - 2>();   // this thread's copies of tile i
            fence_proxy_async();   // before the tensor cores read them
            __syncthreads();   // every copy of tile i is in; tile i-1 is done
            if (i + kStages - 1 < n_tiles) {   // into the stage tile i-1 held
                fill(i + kStages - 1);
            }
            cp_async_commit();
        }

        // the tile against this warpgroup's rows: hidden (its products
        // still run, with P = 0, so that no product sits in a branch),
        // inside, or masked element by element
        const bool hidden = wrows == 0 || (causal && k0 > wpos_hi) ||
                            (has_window && k0 + kNk - 1 <= wpos_lo - window);
        const bool inside =
            k0 + kNk <= Sk && (!causal || k0 + kNk - 1 <= wpos_lo) &&
            (!has_window || k0 > wpos_lo + 63 - window);

        // S = Q K^T over kDq; float32: while the block splits V(i) (V^T is
        // free: O(i-1) is done everywhere), after which the stage of tile
        // i is free and takes tile i + kStages
        float s[kNk / 2];
        if constexpr (C::kHalves) {
            // over K's two halves into one accumulator: k-steps of half 0
            // from slot 0, then half 1's from slot 1
            constexpr int kHs = C::kHw / 8;   // k-steps a half
            constexpr int kC = C::kChunk;
            const uint64_t dk0 = sw128_desc(slot_addr, kNk, 0);
            const unsigned char* qr =
                smem + (64 * wg + 16 * warp + g) * kDq * 4;
            const int gx = g ^ (t >> 1);
            // Q's A registers of k-step kq: d 8kq + 2t, + 1 as stored, in
            // chunk 2kq + t / 2 with its low 3 bits XOR the row's (g)
            auto qfrag = [&](int kq, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
                const int at = 128 * (kq >> 2) + 16 * ((2 * (kq & 3)) ^ gx) +
                               8 * (t & 1);
                const float2 r0 = *reinterpret_cast<const float2*>(qr + at);
                const float2 r1 = *reinterpret_cast<const float2*>(
                    qr + 8 * kDq * 4 + at);
                split(r0.x, hi[0], lo[0]);
                split(r1.x, hi[1], lo[1]);
                split(r0.y, hi[2], lo[2]);
                split(r1.y, hi[3], lo[3]);
            };
            // K's hi (copy 0) or lo of k-step kq: slot kq / kHs
            auto kdesc = [&](int kq, int copy) {
                return sw128_step(
                    dk0 + ((kq / kHs) * 2 + copy) * (C::kHalf >> 4), kNk,
                    32 * (kq % kHs));
            };
            product<float, kNk, 2 * kHs, kC>(
                s,
                [&](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
                    qfrag(kk, hi, lo);
                },
                [&](int kk, int copy) { return kdesc(kk, copy); }, false);
            wgmma_wait<0>();
            fence_regs(s);
        } else if constexpr (C::kF32) {
            const uint64_t dkh = sw128_desc(k_addr, kNk, 0);
            const uint64_t dkl = sw128_desc(klo_addr, kNk, 0);
            product<float, kNk, kDq / 8, C::kChunk>(
                s,
                [&](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
                    const float2 r0 = *reinterpret_cast<const float2*>(
                        qw + g * C::kLdQ + 8 * kk + 2 * t);
                    const float2 r1 = *reinterpret_cast<const float2*>(
                        qw + (g + 8) * C::kLdQ + 8 * kk + 2 * t);
                    split(r0.x, hi[0], lo[0]);
                    split(r1.x, hi[1], lo[1]);
                    split(r0.y, hi[2], lo[2]);
                    split(r1.y, hi[3], lo[3]);
                },
                [&](int kk, int copy) {
                    return sw128_step(copy ? dkl : dkh, kNk, 32 * kk);
                },
                false);
            split_v(i);
            wgmma_wait<0>();
            fence_regs(s);
            fence_proxy_async();
            __syncthreads();   // V^T is in; S(i) is done everywhere
            if (i + kStages < n_tiles) {
                fill(i + kStages);
            }
            cp_async_commit();
        } else {
            const uint64_t dk = sw128_desc(k_addr, kNk, 0);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kDq / 16; ++kk) {
                WgmmaSS<kNk>::mma(s, sw128_step(dq, 64, 32 * kk),
                                  sw128_step(dk, kNk, 32 * kk),
                                  kk > 0 ? 1 : 0);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(s);
        }

        // the mask of element (row r of this thread's two, key k0 + c):
        // its key minus its position is d0 + c - 8r, visible when c <
        // k_valid, d <= 0 (causal) and d > -window
        constexpr int64_t kLim = int64_t(1) << 30;
        auto clamp = [](int64_t x) {
            return static_cast<int>(x < -kLim ? -kLim
                                              : (x > kLim ? kLim : x));
        };
        const int d0 = clamp(k0 - my_pos[0]);
        const int k_valid = clamp(Sk - k0);
        const int d_lo = has_window ? clamp(-window)
                                    : -2 * static_cast<int>(kLim);

        // scale, softcap and mask, then the online softmax, O's rescale
        // and P in A registers; the mask and the softcap are decided once
        // a tile
        auto body = [&](auto masked, auto capped) {
            constexpr bool kMasked = decltype(masked)::value;
            constexpr bool kCapped = decltype(capped)::value;
            // element 4j + e is row e / 2 of this thread's two, key
            // k0 + 8j + 2t + e % 2
#pragma unroll
            for (int j = 0; j < kNk / 8; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float val = s[4 * j + e] * scale;
                    if constexpr (kCapped) {
                        val = tanhf(val / softcap) * softcap;
                    }
                    if constexpr (kMasked) {
                        const int c = 8 * j + 2 * t + (e & 1);
                        const int d = d0 + c - 8 * (e >> 1);
                        const bool ok = c < k_valid &&
                                        (!causal || d <= 0) && d > d_lo;
                        val = ok ? val : kNegInf;
                    }
                    s[4 * j + e] = val;
                }
            }
            // the two rows, each spread over the 4 threads of a quad
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                float mx = kNegInf;
#pragma unroll
                for (int j = 0; j < kNk / 8; ++j) {
                    mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r],
                                         s[4 * j + 2 * r + 1]));
                }
                mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
                mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
                const float m_new = fmaxf(m_run[r], mx);
                float sum = 0.f;
#pragma unroll
                for (int j = 0; j < kNk / 8; ++j) {
#pragma unroll
                    for (int e = 2 * r; e < 2 * r + 2; ++e) {
                        const float x = s[4 * j + e] - m_new;
                        s[4 * j + e] =
                            C::kF32 ? expf(x) : ex2_approx(x * kLog2e);
                        sum += s[4 * j + e];
                    }
                }
                sum += __shfl_xor_sync(kFullMask, sum, 1);
                sum += __shfl_xor_sync(kFullMask, sum, 2);
                const float dm = m_run[r] - m_new;
                const float alpha =
                    C::kF32 ? expf(dm) : ex2_approx(dm * kLog2e);
                l_run[r] = alpha * l_run[r] + sum;
                m_run[r] = m_new;
#pragma unroll
                for (int c = 0; c < kPieces; ++c) {
#pragma unroll
                    for (int j = 0; j < kPn / 8; ++j) {
                        o[c][4 * j + 2 * r] *= alpha;
                        o[c][4 * j + 2 * r + 1] *= alpha;
                    }
                }
            }
        };
        if (hidden) {
#pragma unroll
            for (int i2 = 0; i2 < kNk / 2; ++i2) {
                s[i2] = 0.f;
            }
        } else if (inside) {
            if (has_softcap) {
                body(std::false_type{}, std::true_type{});
            } else {
                body(std::false_type{}, std::false_type{});
            }
        } else {
            if (has_softcap) {
                body(std::true_type{}, std::true_type{});
            } else {
                body(std::true_type{}, std::false_type{});
            }
        }

        // O += P V over the tile's keys
#pragma unroll
        for (int c = 0; c < kPieces; ++c) {
            fence_regs(o[c]);
        }
        if constexpr (C::kF32) {
            // k-step j is keys 8j..8j+7, k index t <-> key 8j + 2t and
            // t + 4 <-> 8j + 2t + 1: S's fragment as it stands
#pragma unroll
            for (int j = 0; j < kNk / 8; ++j) {
                split(s[4 * j], ph[j][0], pl[j][0]);
                split(s[4 * j + 2], ph[j][1], pl[j][1]);
                split(s[4 * j + 1], ph[j][2], pl[j][2]);
                split(s[4 * j + 3], ph[j][3], pl[j][3]);
                fence_regs(ph[j]);
                fence_regs(pl[j]);
            }
            if constexpr (C::kHalves) {
                // O's pieces 0-1 from slot 0 (V^T half 0), pieces 2-3 from
                // slot 1
                constexpr int kPh = kPieces / 2;
                auto o_half = [&](int hh) {
                    wgmma_fence();
#pragma unroll
                    for (int j = 0; j < kNk / 8; ++j) {
#pragma unroll
                        for (int c2 = 0; c2 < kPh; ++c2) {
                            const int c = hh * kPh + c2;
                            const uint32_t at = slot_addr +
                                                hh * 2 * C::kHalf +
                                                c2 * kPn * 128;
                            const uint64_t dh =
                                sw128_desc(at, C::kHw, 32 * j);
                            const uint64_t dl =
                                sw128_desc(at + C::kHalf, C::kHw, 32 * j);
                            Wgmma<float, kPn>::mma(o[c], ph[j], dh, 1);
                            Wgmma<float, kPn>::mma(o[c], ph[j], dl, 1);
                            Wgmma<float, kPn>::mma(o[c], pl[j], dh, 1);
                        }
                    }
                    wgmma_commit();
                };
                cp_async_wait<0>();   // this thread's copies of V(i)
                __syncthreads();   // every copy is in; S(i) done everywhere
                split_v_half(0);
                split_v_half(1);
                fence_proxy_async();
                __syncthreads();   // the slots hold V^T(i); the ring is free
                fill_half(i + 1, 0, 0);   // K(i+1) lands while O(i) runs
                fill_half(i + 1, 0, 1);
                o_half(0);
                o_half(1);
                wgmma_wait<0>();
#pragma unroll
                for (int j = 0; j < kNk / 8; ++j) {
                    fence_regs(ph[j]);
                    fence_regs(pl[j]);
                }
#pragma unroll
                for (int c = 0; c < kPieces; ++c) {
                    fence_regs(o[c]);
                }
                continue;
            }
            wgmma_fence();
#pragma unroll
            for (int j = 0; j < kNk / 8; ++j) {
#pragma unroll
                for (int c = 0; c < kPieces; ++c) {
                    // V^T rows (d) kPn c.., keys 8j..: hi, then lo
                    const uint64_t dh =
                        sw128_desc(vt_addr + c * kPn * 128, DV, 32 * j);
                    const uint64_t dl = sw128_desc(
                        vt_addr + C::kVtBytes + c * kPn * 128, DV, 32 * j);
                    Wgmma<float, kPn>::mma(o[c], ph[j], dh, 1);
                    Wgmma<float, kPn>::mma(o[c], ph[j], dl, 1);
                    Wgmma<float, kPn>::mma(o[c], pl[j], dh, 1);
                }
            }
            wgmma_commit();
            // O(i) runs while the block splits K(i+1)
            if (i + 1 < n_tiles) {
                cp_async_wait<kStages - 1>();   // this thread's tile i+1
                __syncthreads();   // every copy of tile i+1 is in
                split_k(i + 1);
                fence_proxy_async();
            }
            wgmma_wait<0>();
#pragma unroll
            for (int j = 0; j < kNk / 8; ++j) {
                fence_regs(ph[j]);
                fence_regs(pl[j]);
            }
        } else {
            // k-step kk is keys 16kk..16kk+15: a0, a1 keys 2t, 2t+1 of
            // rows g, g + 8, a2, a3 the same 8 keys on
#pragma unroll
            for (int j = 0; j < kNk / 8; ++j) {
                pa[j >> 1][2 * (j & 1)] = pack_bf16(s[4 * j], s[4 * j + 1]);
                pa[j >> 1][2 * (j & 1) + 1] =
                    pack_bf16(s[4 * j + 2], s[4 * j + 3]);
            }
#pragma unroll
            for (int kk = 0; kk < kNk / 16; ++kk) {
                fence_regs(pa[kk]);
            }
            // V's tile MN-major: 64 columns a block of kNk x 128 bytes,
            // k-step kk its rows 16kk.. (2048 bytes, 128 units, on)
            const uint64_t dv =
                sw128_desc_mn(k_addr + C::kKBytes, kNk * 128);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kNk / 16; ++kk) {
#pragma unroll
                for (int c = 0; c < kPieces; ++c) {
                    WgmmaRT<kPn>::mma(
                        o[c], pa[kk],
                        dv + 128 * kk + c * (kPn / 64) * kNk * 8, 1);
                }
            }
            wgmma_commit();
            wgmma_wait<0>();
#pragma unroll
            for (int kk = 0; kk < kNk / 16; ++kk) {
                fence_regs(pa[kk]);
            }
        }
#pragma unroll
        for (int c = 0; c < kPieces; ++c) {
            fence_regs(o[c]);
        }
    }
    cp_async_wait<0>();   // no copy outlives the block

    // o[c][4j + e]: row e / 2 of this thread's two, column kPn c + 8j +
    // 2t + e % 2
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int64_t row = wq0 + 16 * warp + g + 8 * r;
        if (row >= Sq) {
            continue;
        }
        if (lse != nullptr && t == 0) {
            // log of the row's softmax denominator, for the backward; +inf
            // where no key was visited (the row's P is 0 there)
            lse[(b * Hq + h) * Sq + row] =
                l_run[r] == 0.f ? __int_as_float(0x7f800000)
                                : m_run[r] + logf(l_run[r]);
        }
        const float denom = (l_run[r] == 0.f) ? 1.f : l_run[r];
        T* dst = ob + row * o_stride;
#pragma unroll
        for (int c = 0; c < kPieces; ++c) {
#pragma unroll
            for (int j = 0; j < kPn / 8; ++j) {
                const int col = c * kPn + 8 * j + 2 * t;
                if (col < DV) {
                    store2<T>(dst + col, o[c][4 * j + 2 * r] / denom,
                              o[c][4 * j + 2 * r + 1] / denom);
                }
            }
        }
    }
}

template <typename T, int DQ, int DV>
int launch(const T* q, const T* k, const T* v, T* out, float* lse, int64_t B,
           int64_t Sq, int64_t Sk, int64_t Hq, int64_t Hkv, int causal,
           int has_window, int64_t window, int has_softcap, float softcap,
           float scale, int64_t q_offset, void* stream) {
    using C = FwdCfg<T, DQ, DV>;
    const int smem = C::kBytes;
    cudaError_t err = cudaFuncSetAttribute(
        fa_fwd_kernel<T, DQ, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) {   // returned here, so cleared for later calls
        cudaGetLastError();
        return static_cast<int>(err);
    }
    const dim3 grid(static_cast<unsigned>((Sq + C::kBlockQ - 1) / C::kBlockQ),
                    static_cast<unsigned>(Hq), static_cast<unsigned>(B));
    fa_fwd_kernel<T, DQ, DV><<<grid, C::kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
        q, k, v, out, lse, Sq, Sk, static_cast<int>(Hq),
        static_cast<int>(Hkv), causal, has_window, window, has_softcap,
        softcap, scale, q_offset);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* out, float* lse, int64_t B,
             int64_t Sq, int64_t Sk, int64_t Hq, int64_t Hkv, int64_t Dqk,
             int64_t Dv, int causal, int has_window, int64_t window,
             int has_softcap, float softcap, float scale, int64_t q_offset,
             void* stream) {
    if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
        Hq > 65535 || B > 65535) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (Dqk == 192 && Dv == 128) {   // MLA
        return launch<T, 192, 128>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv,
                                   causal, has_window, window, has_softcap,
                                   softcap, scale, q_offset, stream);
    }
    if (Dqk != Dv) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
#define REPRO_FA_CASE(DIM)                                                    \
    case DIM:                                                                 \
        return launch<T, DIM, DIM>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv,    \
                                   causal, has_window, window, has_softcap,  \
                                   softcap, scale, q_offset, stream);
    switch (Dqk) {
        REPRO_FA_CASE(16)
        REPRO_FA_CASE(32)
        REPRO_FA_CASE(64)
        REPRO_FA_CASE(128)
        REPRO_FA_CASE(256)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef REPRO_FA_CASE
}

}  // namespace

extern "C" {

// Each entry launches on `stream` without synchronising and returns a CUDA
// error code: 0 when the launch was accepted.  q and k have head dim Dqk,
// v and out Dv; (Dqk, Dv) must be (D, D) with D 16, 32, 64, 128 or 256, or
// (192, 128); q, k, v and out 16-byte aligned.  lse may be null; when
// given, it receives each row's log-sum-exp [B, Hq, Sq] (float32) for the
// backward (flash_attention_bwd.cu), and `out` is the same either way.
int flash_attention_f32(const float* q, const float* k, const float* v,
                        float* out, float* lse, int64_t B, int64_t Sq,
                        int64_t Sk, int64_t Hq, int64_t Hkv, int64_t Dqk,
                        int64_t Dv, int causal,
                        int has_window, int64_t window, int has_softcap,
                        float softcap, float scale, int64_t q_offset,
                        void* stream) {
    return dispatch<float>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, Dqk, Dv,
                           causal, has_window, window, has_softcap, softcap,
                           scale, q_offset, stream);
}

int flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, __nv_bfloat16* out,
                         float* lse, int64_t B, int64_t Sq, int64_t Sk,
                         int64_t Hq, int64_t Hkv, int64_t Dqk, int64_t Dv,
                         int causal,
                         int has_window,
                         int64_t window, int has_softcap, float softcap,
                         float scale, int64_t q_offset, void* stream) {
    return dispatch<__nv_bfloat16>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv,
                                   Dqk, Dv, causal, has_window, window,
                                   has_softcap, softcap, scale, q_offset,
                                   stream);
}

}  // extern "C"
