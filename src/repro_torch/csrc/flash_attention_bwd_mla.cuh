// The flash-attention backward at MLA's head dims, (Dqk, Dv) = (192, 128),
// in bf16: a body of its own for Hopper, included by flash_attention_bwd.cu,
// whose `dispatch` sends bf16 (192, 128) here (float32 (192, 128) and every
// (D, D) run its `bwd_kernel`).
//
// It replaces, as that file's body does, the gradient of the TPU kernel
// `_fa_kernel` (src/repro/kernels/flash_attention.py:29), which the JAX
// package differentiates through `attention_ref`; the arithmetic is the
// one set out at the head of flash_attention_bwd.cu (P, D_i, dP, dS, dQ,
// dK, dV with the forward's mask, scale and softcap), at Dqk = 192 (S, dK,
// dQ) and Dv = 128 (dP, dV, D_i).
//
// Bound.  6*192 + 4*128 = 1,664 operations an unmasked (query, key) pair,
// 0.904 ms in bf16 at deepseek-v3's [2, 2048, 128, 192/128], causal.  This
// design forms S and dP twice (dQ's own launch): 2,304 a pair, 1.25 ms.
//
// What held the (192, 128) instantiation of `bwd_kernel` back (10.59-10.78
// ms there on an H100, tools/fa_bwd_sweep.py): its owned rows are the N of
// every product and the streamed tiles A from registers, so in bf16 it
// runs N = 64 products with one consumer warpgroup a block (the exp and
// the P/dS stores never overlap the tensor cores; its dK/dV launch spilled
// 984 bytes at 255 registers), writes P and dS through shared memory, and
// streams the whole band for each 64 owned rows (~10.7 GB of L2 reads at
// that shape).  This body takes 4.31-4.41 ms there (dK/dV 2.44, dQ 1.69);
// timing-only copies (at 4.50 ms) put the streaming at 0.60 ms of it, the
// exp at 0.13, the mask's element tests at 0.19, the dK/dQ products at 1.0.
// float32 keeps `bwd_kernel` (flash_attention_bwd.cu, point 2): TF32 takes
// no transpose, and its hi/lo owned tiles leave no room for this layout.
//
// Design (FlashAttention-3's operand roles).  Three launches: delta_kernel,
// then `mla_bwd_kernel` for dK/dV (kDQ false) and for dQ (kDQ true).  A
// block is two warpgroups, each owning 64 rows of one side, and both stream
// kBs-row tiles of the other side through a ring:
//   dK/dV: owns K, V of a key tile; streams Q, dO (and L, D_i) of the band
//          over the group's q heads.
//     S^T = K Q^T, dP^T = V dO^T   A = the owned K, V from shared memory,
//                                  B = the streamed tile, K-major as stored
//     dV += P^T dO (N = 128), dK += dS^T Q (N = 192)
//                                  A = P^T, dS^T in registers (the
//                                  accumulator's layout is A's), B = the
//                                  same streamed tiles read MN-major
//   dQ:    owns Q, dO of a q tile; streams K, V.  S = Q K^T, dP = dO V^T,
//          dQ += dS K (B = the K tile MN-major), the mirror image.
// So P and dS never go through shared memory, a streamed tile serves 128
// owned rows, and dK, dV and dQ sum in the tensor cores' float32
// accumulators over the whole band (and group) in one order.  Within a
// warpgroup P is formed while dP's product runs and dS while dV's does.
// The block's threads fill the ring kAhead tiles ahead with 16-byte
// `cp.async` copies straight into the 128-byte swizzled layout (zeros past
// the sequence's end), each stage completing on its full mbarrier
// (`cp.async.mbarrier.arrive.noinc`) and freed through its empty one once
// both warpgroups' products have read it.  Registers bound the tiles:
// dK/dV holds 96 + 64 accumulators, S^T and dP^T (kBs / 2 each), and P^T,
// dS^T as bf16 pairs (kBs / 4 each), so its streamed tiles are 32 rows and
// dQ's (96 accumulators) 64.  A warpgroup skips a tile its mask hides
// wholly.  Blocks are issued with
// the longest bands first (dK/dV key tile by key tile, dQ from the last q
// tile back).  No atomics: two calls give the same bits.  dQ keeps its own
// launch: folding it into the dK/dV pass in a fixed order would write and
// read a float32 dQ share of 64 x 192 per pair of tiles (~6.8 GB at
// deepseek-v3's shape), where forming S and dP again costs 640 of the
// 2,304 operations a pair.
#pragma once

#include <type_traits>

#include "fa_common.cuh"
#include "hopper_common.cuh"

namespace {

using bf16_t = __nv_bfloat16;

// A launch's tile shape.  Tunables (tools/fa_bwd_sweep.py times others):
// kBs streamed rows a tile (N of S and dP), kStages of the ring and kAhead
// tiles read ahead (kStages - 2: a tile's stage is filled once both
// warpgroups freed it a tile ago, so neither waits on the other's current
// tile).  The
// block is the two consumer warpgroups alone: ptxas gives a block of 288 or
// 384 threads 168 registers a thread, `setmaxnreg` from a producer
// warpgroup did not lift that (measured: the same spills), and 256
// threads get 255; so the consumers fill the ring themselves.
template <bool kDQ>
struct MlaCfg {
    static constexpr int DQ = 192, DV = 128;
    static constexpr int kBs = kDQ ? 64 : 32;
    static constexpr int kStages = kDQ ? 3 : 4;
    static constexpr int kAhead = kStages - 2;
    static constexpr int kOwn = 64;                  // rows a warpgroup: M
    static constexpr int kWG = 2;
    static constexpr int kCta = kOwn * kWG;
    static constexpr int kThreads = 128 * kWG;
    static constexpr int kX1 = kOwn * DQ * 2;        // a warpgroup's X1, X2
    static constexpr int kX2 = kOwn * DV * 2;
    static constexpr int kY1 = kBs * DQ * 2;         // a stage's Y1, Y2
    static constexpr int kY2 = kBs * DV * 2;
    static constexpr int kLD = kDQ ? 0 : 2 * kBs * 4;   // and L, D_i
    static constexpr int kStage = (kY1 + kY2 + kLD + 1023) / 1024 * 1024;
    static constexpr int kOffRing = kWG * (kX1 + kX2);
    static constexpr int kOffBar = kOffRing + kStages * kStage;
    static constexpr int kBytes = kOffBar + 2 * kStages * 8 + 1024;
    static_assert(kBs == 32 || kBs == 64, "N of S and dP");
    static_assert(kAhead >= 1 && kAhead < kStages, "tiles read ahead");
    static_assert(kBytes <= 232448, "shared memory of a block");
};

// rows [i0, i0 + kRows) of a [., W] bf16 head (row stride `stride`
// elements) into a swizzled tile of kRows rows, 16 bytes a copy, by the
// block's kP threads; zeros from row `valid` on
template <int W, int kRows, int kP>
__device__ __forceinline__ void mla_copy(unsigned char* dst,
                                         const bf16_t* src, int64_t stride,
                                         int valid) {
    constexpr int kChunks = W / 8;
#pragma unroll 4
    for (int c = threadIdx.x; c < kRows * kChunks; c += kP) {
        const int r = c / kChunks;
        const int x = c % kChunks;
        const bool ok = r < valid;
        cp_async16(dst + sw128_offset(kRows, r, 16 * x),
                   src + (ok ? r : 0) * stride + 8 * x, ok);
    }
}

template <bool kDQ>
__global__ void __launch_bounds__(MlaCfg<kDQ>::kThreads, 1)
mla_bwd_kernel(const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
               const bf16_t* __restrict__ v, const bf16_t* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, bf16_t* __restrict__ g1,
               bf16_t* __restrict__ g2, int64_t Sq, int64_t Sk, int Hq,
               int Hkv, int causal, int has_window, int64_t window,
               int has_softcap, float softcap, float scale,
               int64_t q_offset) {
    using C = MlaCfg<kDQ>;
    constexpr int DQ = C::DQ, DV = C::DV, kBs = C::kBs, kCta = C::kCta;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    unsigned char* ring = smem + C::kOffRing;
    const uint32_t bar0 = smem_u32(smem + C::kOffBar);   // full, then empty
    auto full = [&](int s) { return bar0 + 8 * s; };
    auto empty = [&](int s) { return bar0 + 8 * (C::kStages + s); };

    const int groups = Hq / Hkv;
    const int64_t b = blockIdx.x / (kDQ ? Hq : Hkv);
    const int hx = blockIdx.x % (kDQ ? Hq : Hkv);    // q head, or kv head
    const int tile = kDQ ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
    const int64_t o_cta = static_cast<int64_t>(tile) * kCta;
    const int64_t S_own = kDQ ? Sq : Sk;
    const int64_t S_str = kDQ ? Sk : Sq;
    const int cta_valid =
        static_cast<int>(S_own - o_cta < kCta ? S_own - o_cta : kCta);

    // the band of streamed rows [lo_row, hi_row) the block's rows can see
    int64_t lo_row = 0;
    int64_t hi_row = S_str;
    if constexpr (kDQ) {
        const int64_t pos_lo = q_offset + o_cta;
        const int64_t pos_hi = pos_lo + cta_valid - 1;
        if (causal && pos_hi + 1 < hi_row) {
            hi_row = pos_hi + 1;
        }
        if (has_window && pos_lo - window + 1 > lo_row) {
            lo_row = pos_lo - window + 1;
        }
    } else {
        const int64_t k_last = o_cta + cta_valid - 1;
        if (causal && o_cta - q_offset > lo_row) {
            lo_row = o_cta - q_offset;
        }
        if (has_window && k_last + window - q_offset < hi_row) {
            hi_row = k_last + window - q_offset;
        }
    }
    const int64_t t_begin = lo_row / kBs;
    const int64_t n_band =
        hi_row > lo_row ? (hi_row + kBs - 1) / kBs - t_begin : 0;
    // dK/dV walk the group's q heads, dQ its one kv head
    const int64_t n_tiles = n_band * (kDQ ? 1 : groups);
    const int64_t q_stride = static_cast<int64_t>(Hq) * DQ;
    const int64_t o_stride = static_cast<int64_t>(Hq) * DV;
    const int64_t k_stride = static_cast<int64_t>(Hkv) * DQ;
    const int64_t v_stride = static_cast<int64_t>(Hkv) * DV;

    if (threadIdx.x == 0) {
        for (int s = 0; s < C::kStages; ++s) {
            mbar_init(full(s), C::kThreads);
            mbar_init(empty(s), C::kThreads);
        }
        mbar_init_fence();
    }
    __syncthreads();

    // tile m of the walk into stage m % kStages once every thread has
    // freed it: each thread's share of the copies, then its arrival on the
    // stage's full barrier once they have landed
    auto fill = [&](int64_t m) {
        const int64_t i0 = (t_begin + m % n_band) * kBs;
        const int hs = kDQ ? hx / groups
                           : hx * groups + static_cast<int>(m / n_band);
        const int rows =
            static_cast<int>(S_str - i0 < kBs ? S_str - i0 : kBs);
        const int s = static_cast<int>(m % C::kStages);
        unsigned char* st = ring + s * C::kStage;
        mbar_wait(empty(s),
                  static_cast<uint32_t>(((m / C::kStages) & 1) ^ 1));
        // Y1 (q or k) is DQ wide, Y2 (dout or v) DV
        const int64_t s1 = kDQ ? k_stride : q_stride;
        const int64_t s2 = kDQ ? v_stride : o_stride;
        mla_copy<DQ, kBs, C::kThreads>(
            st, (kDQ ? k : q) + (b * S_str + i0) * s1 +
                    static_cast<int64_t>(hs) * DQ,
            s1, rows);
        mla_copy<DV, kBs, C::kThreads>(
            st + C::kY1, (kDQ ? v : dout) + (b * S_str + i0) * s2 +
                             static_cast<int64_t>(hs) * DV,
            s2, rows);
        if constexpr (!kDQ) {
            // L and D_i of the tile's q rows, 4 bytes a copy
            const int c = threadIdx.x;
            if (c < 2 * kBs) {
                const int r = c % kBs;
                const float* src =
                    (c < kBs ? lse : delta) + (b * Hq + hs) * Sq + i0;
                cp_async4(smem_u32(st + C::kY1 + C::kY2 + 4 * c),
                          src + (r < rows ? r : 0), r < rows);
            }
        }
        cp_async_mbar_arrive(full(s));
    };
    for (int64_t m = 0; m < C::kAhead && m < n_tiles; ++m) {
        fill(m);
    }

    // warpgroup wg owns rows [o0, o0 + own_valid) of the block's; both read
    // every streamed tile.  Barrier 1 + wg is this warpgroup's.
    const int wg = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int m0 = 16 * (warp % 4);   // this warp's rows of the 64
    const int64_t o0 = o_cta + static_cast<int64_t>(wg) * C::kOwn;
    const int own_valid = static_cast<int>(
        S_own - o0 < C::kOwn ? (S_own > o0 ? S_own - o0 : 0) : C::kOwn);
    unsigned char* own = smem + wg * (C::kX1 + C::kX2);   // X1, X2

    // the owned tiles (K, V or Q, dO) into the swizzled layout once
    for (int x = 0; x < 2; ++x) {
        const int width = x == 0 ? DQ : DV;
        const int64_t stride = kDQ ? (x == 0 ? q_stride : o_stride)
                                   : (x == 0 ? k_stride : v_stride);
        const bf16_t* src = kDQ ? (x == 0 ? q : dout) : (x == 0 ? k : v);
        src += (b * S_own + o0) * stride +
               static_cast<int64_t>(hx) * width;
        unsigned char* dst = own + x * C::kX1;
        const int steps = width / 8;
        for (int i = tid; i < C::kOwn * steps; i += 128) {
            const int n = i / steps;
            const int c = i % steps;
            const uint4 raw =
                n < own_valid
                    ? *reinterpret_cast<const uint4*>(src + n * stride +
                                                      8 * c)
                    : make_uint4(0u, 0u, 0u, 0u);
            *reinterpret_cast<uint4*>(
                dst + sw128_offset(C::kOwn, n, 16 * c)) = raw;
        }
    }
    fence_proxy_async();
    bar_sync(1 + wg, 128);
    const uint64_t dx1 = sw128_desc(smem_u32(own), C::kOwn, 0);
    const uint64_t dx2 = sw128_desc(smem_u32(own) + C::kX1, C::kOwn, 0);

    constexpr float kLog2e = 1.4426950408889634f;
    const float scale2 = scale * kLog2e;
    // dQ: L (base 2) and D_i of this thread's two owned q rows
    float own_l2[2] = {0.f, 0.f}, own_delta[2] = {0.f, 0.f};
    if constexpr (kDQ) {
        const float* lse_b = lse + (b * Hq + hx) * Sq;
        const float* delta_b = delta + (b * Hq + hx) * Sq;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = m0 + g + 8 * h;
            own_l2[h] = r < own_valid ? lse_b[o0 + r] * kLog2e : 0.f;
            own_delta[h] = r < own_valid ? delta_b[o0 + r] : 0.f;
        }
    }

    // the sums: dV (N = DV; dK/dV only) and dK or dQ (N = DQ)
    float acc1[kDQ ? 1 : DV / 2];
    float acc2[DQ / 2];
#pragma unroll
    for (int i = 0; i < DQ / 2; ++i) {
        acc2[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < (kDQ ? 1 : DV / 2); ++i) {
        acc1[i] = 0.f;
    }

    for (int64_t n = 0; n < n_tiles; ++n) {
        if (n + C::kAhead < n_tiles) {
            fill(n + C::kAhead);   // into a stage both warpgroups freed
        }
        const int64_t i0 = (t_begin + n % n_band) * kBs;
        const int s = static_cast<int>(n % C::kStages);
        const uint32_t par =
            static_cast<uint32_t>((n / C::kStages) & 1);
        unsigned char* st = ring + s * C::kStage;
        const uint32_t y1 = smem_u32(st);
        const uint32_t y2 = y1 + C::kY1;
        const float* lsm =
            reinterpret_cast<const float*>(st + C::kY1 + C::kY2);

        // this warpgroup's rows against the tile's: wholly hidden,
        // wholly visible, or masked element by element
        const int64_t q_lo = kDQ ? o0 : i0;
        const int64_t q_hi = q_lo + (kDQ ? C::kOwn : kBs) - 1;
        const int64_t k_lo = kDQ ? i0 : o0;
        const int64_t k_hi = k_lo + (kDQ ? kBs : C::kOwn) - 1;
        const bool hidden =
            own_valid == 0 || (causal && k_lo > q_offset + q_hi) ||
            (has_window && k_hi <= q_offset + q_lo - window);
        const bool inside =
            q_hi < Sq && k_hi < Sk &&
            (!causal || k_hi <= q_offset + q_lo) &&
            (!has_window || k_lo > q_offset + q_hi - window);
        // the mask of an element (M row r, N column c) in 32 bits: its key
        // minus its q position is d0 + (r - c), or d0 + (c - r) for dQ;
        // visible when r < own_valid, c < str_valid, d <= 0 (causal) and
        // d > d_lo (the window)
        constexpr int64_t kLim = int64_t(1) << 30;
        auto clamp = [&](int64_t x) {
            return static_cast<int>(x < -kLim ? -kLim : (x > kLim ? kLim : x));
        };
        const int d0 = clamp(kDQ ? i0 - o0 - q_offset : o0 - i0 - q_offset);
        const int str_valid = clamp(S_str - i0);
        const int d_lo = has_window ? clamp(-window) : -2 * kLim;

        mbar_wait(full(s), par);
        if (!hidden) {
            fence_proxy_async();   // the ring's cp.async writes
            // T1 = X1 Y1^T over DQ (S), T2 = X2 Y2^T over DV (dP): two
            // groups, so that P is formed while T2 runs
            float t1[kBs / 2], t2[kBs / 2];
            const uint64_t dy1 = sw128_desc(y1, kBs, 0);
            const uint64_t dy2 = sw128_desc(y2, kBs, 0);
            // the same tiles MN-major for dV and dK or dQ: k-step kk is
            // rows 16kk..16kk+15, 2048 bytes (128 descriptor units) on
            const uint64_t dm1 = sw128_desc_mn(y1, kBs * 128);
            const uint64_t dm2 = sw128_desc_mn(y2, kBs * 128);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < DQ / 16; ++kk) {
                WgmmaSS<kBs>::mma(t1, sw128_step(dx1, C::kOwn, 32 * kk),
                                  sw128_step(dy1, kBs, 32 * kk),
                                  kk > 0 ? 1 : 0);
            }
            wgmma_commit();
#pragma unroll
            for (int kk = 0; kk < DV / 16; ++kk) {
                WgmmaSS<kBs>::mma(t2, sw128_step(dx2, C::kOwn, 32 * kk),
                                  sw128_step(dy2, kBs, 32 * kk),
                                  kk > 0 ? 1 : 0);
            }
            wgmma_commit();

            // element 4j + e of T1 and T2 is M row m0 + g + 8(e/2), N
            // column 8j + 2t + e%2; as the A of k-step j/2 it is half
            // e%2 of register 2(j%2) + e/2
            auto body = [&](auto masked, auto capped) {
                constexpr bool kMasked = decltype(masked)::value;
                constexpr bool kCapped = decltype(capped)::value;
                auto L2 = [&](int j, int e) {
                    if constexpr (kDQ) {
                        return own_l2[e >> 1];
                    } else {
                        return lsm[8 * j + 2 * t + (e & 1)] * kLog2e;
                    }
                };
                auto Dl = [&](int j, int e) {
                    if constexpr (kDQ) {
                        return own_delta[e >> 1];
                    } else {
                        return lsm[kBs + 8 * j + 2 * t + (e & 1)];
                    }
                };
                // P (0 where masked), and with the softcap its factor
                // 1 - tanh^2, both rounded to bf16 pairs
                wgmma_wait<1>();
                fence_regs(t1);
                uint32_t pa[kBs / 16][4], da[kBs / 16][4];
                uint32_t ca[kCapped ? kBs / 16 : 1][4];
#pragma unroll
                for (int j = 0; j < kBs / 8; ++j) {
                    float pv[4], cv[4];
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        float x2;
                        cv[e] = 1.f;
                        if constexpr (kCapped) {
                            const float th =
                                tanhf(t1[4 * j + e] * scale / softcap);
                            x2 = th * softcap * kLog2e;
                            cv[e] = 1.f - th * th;
                        } else {
                            x2 = t1[4 * j + e] * scale2;
                        }
                        float p = ex2_approx(x2 - L2(j, e));
                        if constexpr (kMasked) {
                            const int r = m0 + g + 8 * (e >> 1);
                            const int c = 8 * j + 2 * t + (e & 1);
                            const int d = d0 + (kDQ ? c - r : r - c);
                            const bool ok = r < own_valid && c < str_valid &&
                                            (!causal || d <= 0) && d > d_lo;
                            p = ok ? p : 0.f;
                        }
                        pv[e] = p;
                    }
                    pa[j >> 1][2 * (j & 1)] = pack_bf16(pv[0], pv[1]);
                    pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(pv[2], pv[3]);
                    if constexpr (kCapped) {
                        ca[j >> 1][2 * (j & 1)] = pack_bf16(cv[0], cv[1]);
                        ca[j >> 1][2 * (j & 1) + 1] =
                            pack_bf16(cv[2], cv[3]);
                    }
                }
#pragma unroll
                for (int kk = 0; kk < kBs / 16; ++kk) {
                    fence_regs(pa[kk]);
                }
                // dV += P^T Y2 (dK/dV), B the dO tile MN-major, k-step
                // kk its rows 16kk..16kk+15; it runs while dS is formed
                if constexpr (!kDQ) {
                    fence_regs(acc1);
                    wgmma_fence();
#pragma unroll
                    for (int kk = 0; kk < kBs / 16; ++kk) {
                        WgmmaRT<DV>::mma(acc1, pa[kk], dm2 + 128 * kk, 1);
                    }
                    wgmma_commit();
                    wgmma_wait<1>();
                } else {
                    wgmma_wait<0>();
                }
                fence_regs(t2);
                // dS = P (dP - D_i) (1 - tanh^2), from P as rounded
                auto half = [](uint32_t w, int e) {
                    return __uint_as_float((e & 1) ? (w & 0xffff0000u)
                                                   : (w << 16));
                };
#pragma unroll
                for (int j = 0; j < kBs / 8; ++j) {
                    float dv[4];
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int r = 2 * (j & 1) + (e >> 1);
                        float ds = half(pa[j >> 1][r], e) *
                                   (t2[4 * j + e] - Dl(j, e));
                        if constexpr (kCapped) {
                            ds = ds * half(ca[j >> 1][r], e);
                        }
                        dv[e] = ds;
                    }
                    da[j >> 1][2 * (j & 1)] = pack_bf16(dv[0], dv[1]);
                    da[j >> 1][2 * (j & 1) + 1] = pack_bf16(dv[2], dv[3]);
                }
#pragma unroll
                for (int kk = 0; kk < kBs / 16; ++kk) {
                    fence_regs(da[kk]);
                }
                // dK or dQ += dS Y1, B the Q or K tile MN-major
                fence_regs(acc2);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < kBs / 16; ++kk) {
                    WgmmaRT<DQ>::mma(acc2, da[kk], dm1 + 128 * kk, 1);
                }
                wgmma_commit();
                wgmma_wait<0>();
                // the products read P and dS from registers until now
#pragma unroll
                for (int kk = 0; kk < kBs / 16; ++kk) {
                    fence_regs(pa[kk]);
                    fence_regs(da[kk]);
                }
                if constexpr (!kDQ) {
                    fence_regs(acc1);
                }
                fence_regs(acc2);
            };
            if (inside) {
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
        }
        mbar_arrive(empty(s));
    }

    // out: acc[4j + e] at M row m0 + g + 8(e/2), column 8j + 2t + e%2;
    // g1 (dK or dQ, times the scale) has DQ columns, g2 (dV) DV
    const int64_t stride1 = kDQ ? q_stride : k_stride;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = m0 + g + 8 * h;
        if (r >= own_valid) {
            continue;
        }
        const int64_t row = b * S_own + o0 + r;
        bf16_t* out1 = g1 + row * stride1 + static_cast<int64_t>(hx) * DQ;
#pragma unroll
        for (int j = 0; j < DQ / 8; ++j) {
            *reinterpret_cast<__nv_bfloat162*>(out1 + 8 * j + 2 * t) =
                __floats2bfloat162_rn(acc2[4 * j + 2 * h] * scale,
                                      acc2[4 * j + 2 * h + 1] * scale);
        }
        if constexpr (!kDQ) {
            bf16_t* out2 =
                g2 + row * v_stride + static_cast<int64_t>(hx) * DV;
#pragma unroll
            for (int j = 0; j < DV / 8; ++j) {
                *reinterpret_cast<__nv_bfloat162*>(out2 + 8 * j + 2 * t) =
                    __floats2bfloat162_rn(acc1[4 * j + 2 * h],
                                          acc1[4 * j + 2 * h + 1]);
            }
        }
    }
}

}  // namespace
