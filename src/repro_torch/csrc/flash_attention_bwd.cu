// Flash attention backward for Hopper (sm_90a), bound through a plain C
// interface.
//
// The TPU kernel `_fa_kernel` of the JAX package
// (src/repro/kernels/flash_attention.py:29, launched at :120) has no
// backward: the JAX package trains by differentiating its plain versions
// (`attention_ref`, src/repro/kernels/ops.py:96-118).  This file computes
// the same gradient for the forward kernel of flash_attention.cu, from its
// output O and the log-sum-exp L of each row that it writes when asked
// (FlashAttention-2's scheme):
//
//   P_ij  = exp(s_ij - L_i)                 (0 where the forward masks)
//   D_i   = sum_d dO_id O_id                 (delta_kernel)
//   dP_ij = dO_i . v_j
//   dS_ij = P_ij (dP_ij - D_i) c_ij,   c_ij = 1 - tanh^2(x_ij / cap) with
//           the softcap (x_ij = scale q_i . k_j), else 1
//   dQ_i  = scale sum_j dS_ij k_j,   dK_j = scale sum_i dS_ij q_i,
//   dV_j  = sum_i P_ij dO_i
//
// with the forward's mask (j < Sk, j <= pos_i when causal, j > pos_i -
// window when windowed, pos_i = q_offset + i), scale and softcap.  A
// masked pair has P = 0: a row that the forward masks entirely gets a zero
// gradient.  Tiles wholly outside the band are not visited.  q and k have
// head dim Dqk, v, O and dO Dv: (D, D), or MLA's (192, 128), as the
// forward.  S, dK and dQ run over Dqk; dP, D_i and dV over Dv.
//
// Bound.  Each unmasked pair costs five products (S, dK, dQ of length Dqk;
// dP, dV of length Dv): 6*Dqk + 4*Dv operations (10*D at equal head
// dims), each product three TF32 products in float32.  This design forms
// S and dP twice (point 4), 8*Dqk + 6*Dv a pair, so it can reach at most
// 10/14 of that bound at equal head dims, 1664/2304 at MLA's.
//
// Design.  bf16 at (192, 128) runs a body of its own,
// flash_attention_bwd_mla.cuh (FlashAttention-3's operand roles: the owned
// rows as M, P and dS kept in registers); every (D, D), and float32 at
// (192, 128), run the one below.  Three launches: delta_kernel, then one
// body, `bwd_kernel`, for dK/dV (kDQ false) and for dQ (kDQ true).  A
// block owns rows of one side (K and V of a key tile, or Q and dO of a q
// tile), one warpgroup per kNo
// owned rows (`BwdCfg`), and streams 64-row tiles of the other side
// (Q and dO, or K and V).  In the words of the five bottlenecks:
// 1. Every product is a `wgmma` (hopper_common.cuh), A from registers, B
//    from shared memory in the 128-byte swizzled K-major layout:
//      T1 = Y1 X1^T, T2 = Y2 X2^T    (S, dP or S^T, dP^T: M = the 64
//                                     streamed rows, N = the owned rows)
//      A1 = Y2^T P,  A2 = Y1^T dS    (dV^T: M = Dv; dK^T or dQ^T:
//                                     M = Dqk)
//    with X1, X2 the owned tiles and Y1, Y2 the streamed ones (X1, Y1 the
//    Q and K tiles, Dqk wide; X2, Y2 the dO and V tiles, Dv wide).  `.tf32`
//    takes no transpose, so no B operand is ever a transpose: the owned
//    tiles are B of T1/T2 as stored; P and dS are B of A1/A2, written by
//    the warpgroup from its T accumulators with the owned index as the
//    row (the transpose is only where each thread stores its elements);
//    the streamed tiles are only ever A, read from their raw rows into
//    registers (rows padded by 32 bytes: both fragment loads are free of
//    bank conflicts).  No transposed copy is kept: shared memory holds per
//    warpgroup the owned tiles' hi and lo (2 * kNo * (Dqk + Dv) * 4 bytes
//    in float32) and P and dS (hi, lo), and the ring, whose stages are
//    sized per operand (a Dqk-wide stage, then a Dv-wide one).  Float32
//    is split TF32, three wgmma a product (hi.hi, hi.lo, lo.hi; hi
//    rounded to nearest as in the forward, fa_common.cuh `split`, not the
//    raw operand, whose truncation would double the product's error):
//    the owned tiles are split once a block, P and dS once where they are
//    formed, and a streamed tile once a warpgroup for each of its two
//    products (as T's A and as A1/A2's transposed A), not once a warp.
//    bf16 runs natively (P and dS rounded to bf16, float32
//    accumulators).  --fmad=false stands; the epilogue needs no fused add
//    (exp2 of the logit and L taken in base 2).
// 2. A producer warp streams the tiles with per-row `cp.async.bulk` copies
//    (a [B, S, H, D] row is contiguous for D elements, so no tensor map or
//    driver entry point is needed) into a ring of kStages stages, each
//    completing on its full mbarrier; the consumers free a stage through
//    its empty mbarrier once its fragments are in registers.  A wait of
//    more than ~10 s traps.  With two consumer warpgroups ptxas holds the
//    288-thread block to 168 registers a thread; `setmaxnreg` with a
//    producer warpgroup did not lift that (measured: the same spills and
//    4 % slower), so the producer is one warp and no registers move.
//    At Dqk != Dv (float32 (192, 128), whose two stages hold one tile:
//    the owned hi/lo copies fill shared memory) the Dv-wide tile streams
//    first, T2 runs before T1, dV^T's M blocks run before dK^T's, and the
//    Dv-wide stage is freed once its last product has its fragments (dQ:
//    T2; dK/dV: dV^T's last block), so that the next tile's copies
//    overlap this tile's products: at deepseek-v3's layer on an H100
//    30.75 ms against 40.37, the same bits (a timing-only copy that
//    streams nothing at all took 25.1).
// 3. dK/dV: a block per (b, kv head, key tile) walks the q heads of the
//    kv head's group in head order, and for each the q tiles of the band;
//    dK and dV are summed in registers over the whole group in that one
//    order and written once: no atomics, no per-q-head shares, no reduce
//    launch.  Each tile's A1/A2 goes into a fresh tensor-core accumulator
//    and is added to the sums on the CUDA cores: a tensor-core sum over a
//    whole band and group rounds away the split's small products (measured
//    against float64: 2e-4 of max|g| at path B's shape, against 5e-6 this
//    way).  At (192, 128) dV^T's two M blocks and dK^T's three of 32
//    owned rows fit, and one pass forms both; at float32 (256, 256) so do
//    the four and four of 32 owned rows (point 6).
// 4. dQ: its own launch, a block per (b, q head, q tile), which forms S
//    and dP again (14*D a pair in all at equal head dims); fixed-order
//    dQ shares from the dK/dV blocks would be ~0.35 GB written and read
//    again at path A's shape (one 64 x 64 float32 share per pair of tiles
//    in the band).
// 5. Longest bands first: dK/dV blocks are issued key tile by key tile
//    (a causal band shortens as the keys move right), dQ blocks from the
//    last q tile back.
// 6. float32 at (256, 256) (`kByParts`): the owned tiles' hi and lo copies
//    of 32 rows take 128 KB, so a whole 256-wide streamed tile (67.6 KB)
//    fits once: 16 owned rows (the products' N) were the parent's rule.
//    Here each streamed tile comes as kParts (2) column parts of 64 rows,
//    a stage each (34.8 KB; two stages), each freed once its fragments are
//    in registers; T1 and T2 sum their parts in one accumulator, and the
//    M blocks of A1/A2 take the part that holds their columns.  P and dS
//    share one tile: dK/dV streams Q's parts (T1, then P), dO's (T2's
//    parts, and dV^T's blocks from P), then writes dS over P (P read back
//    from the tile, the softcap's factor from a tile of its own, so S is
//    not held in registers) and streams Q's parts again (dK^T's blocks);
//    dQ streams V's parts (T2) and K's (T1, kept for dQ^T's blocks).  One
//    kv head gives Sk / 32 dK/dV blocks (96 of 132 SMs at path B's
//    shape), so the dK/dV launch runs on a side stream of the highest
//    priority, forked after delta_kernel and joined before the call
//    returns, and the dQ launch's blocks fill the other SMs (9.3-9.7
//    against 11.3-11.4 ms one after the other, on an H100).  Quarters (a
//    4-deep ring of 17.4 KB parts) were 1.7x slower, 16 owned rows
//    (192 blocks; or two warpgroups, 168 registers at 288 threads) 6-40 %
//    slower (PERF.md).
// Every sum has one order, so two calls give the same bits.
//
// Build: see flash_attention.cu.
#include <mutex>
#include <type_traits>

#include "fa_common.cuh"
#include "hopper_common.cuh"
#include "flash_attention_bwd_mla.cuh"

namespace {

constexpr int kRows = 64;        // streamed rows of a tile: wgmma's M

// A block's tile shape.  Tunables (tools/fa_bwd_sweep.py times others):
// kNo owned rows of a consumer warpgroup (N of every product), kWG
// consumer warpgroups (each owns its rows; all read every streamed tile
// of the one ring), kStoreTiles 2 (P and dS apart) or 1 (dS written over P
// once A1 has read it, to save shared memory), kStages of the ring,
// kChunk k-steps of A fragments a fence.  One block an SM.  The tile rules
// read D, the wider head dim; the Q and K tiles are DQ wide, the V and dO
// tiles DV (stage s of the ring holds the tile that streams first when s
// is even: the DQ-wide one, or at Dqk != Dv the DV-wide one).
// At (192, 128) (float32 only: bf16 runs flash_attention_bwd_mla.cuh),
// 32 owned rows and two stages (one of each width) take 201,792 bytes; 16
// rows and four stages (230,464) were 18 % slower at deepseek-v3's layer
// on an H100 (48.1 against 40.7 ms).  float32 (256, 256) streams column
// parts (kParts, point 6 above): 32 owned rows, one P/dS tile, two
// stages, one k-step a chunk (two spill more and were 5-10 % slower).
template <typename T, int DQ, int DV>
struct BwdCfg {
    static constexpr int D = DQ > DV ? DQ : DV;
    static constexpr bool kF32 = std::is_same<T, float>::value;
    static constexpr int kEs = static_cast<int>(sizeof(T));
    // float32 at (256, 256): each streamed tile as kParts column parts, a
    // stage each (0: whole tiles)
    static constexpr int kParts = kF32 && DQ == 256 && DV == 256 ? 2 : 0;
    static constexpr bool kByParts = kParts > 0;
    static constexpr int kNo =
        kF32 ? (D <= 64 ? 48 : (D == 192 || kByParts ? 32 : 4096 / D))
             : (D <= 128 ? 64 : 32);
    static constexpr int kWG = D <= 64 ? 2 : 1;
    static constexpr int kStoreTiles = kF32 && (D <= 64 || kByParts) ? 1 : 2;
    static constexpr int kStages =
        kF32 ? (D <= 64 ? 4 : (D == 128 ? 3 : (kByParts ? kParts : 2))) : 4;
    static constexpr int kChunk =
        kByParts ? 1 : (kF32 && D <= 64 ? 2 : 4);
    static constexpr int kK = kF32 ? 8 : 16;           // wgmma's K
    static constexpr int kCopies = kF32 ? 2 : 1;       // hi (and lo)
    // a streamed row: its width and 32 bytes, so that the fragment loads
    // of both products are free of bank conflicts
    static constexpr int kLd1 = DQ + 32 / kEs;
    static constexpr int kLd2 = DV + 32 / kEs;
    static constexpr int kStage1 = kRows * kLd1 * kEs;   // bytes of a stage
    static constexpr int kStage2 = kRows * kLd2 * kEs;
    // at Dqk != Dv the Dv-wide tile (dO or V) streams first (point 2)
    static constexpr bool kY2First = DQ != DV;
    static constexpr int kStageA = kY2First ? kStage2 : kStage1;
    static constexpr int kStageB = kY2First ? kStage1 : kStage2;
    // kByParts: every stage one part, kPw columns of 64 rows (and 32
    // bytes)
    static constexpr int kPw = kParts > 0 ? DQ / kParts : DQ;
    static constexpr int kLdP = kPw + 32 / kEs;
    static constexpr int kStageP = kRows * kLdP * kEs;
    static constexpr int kDp1 = DQ * kEs < 128 ? 128 / kEs : DQ;
    static constexpr int kDp2 = DV * kEs < 128 ? 128 / kEs : DV;
    static constexpr int kOwn1 = kNo * kDp1 * kEs;     // one X1 copy
    static constexpr int kOwn2 = kNo * kDp2 * kEs;     // one X2 copy
    static constexpr int kStore = kNo * kRows * kEs;   // one P or dS copy
    // M blocks of A1 (dV^T, DV rows) and of A2 (dK^T or dQ^T, DQ rows)
    static constexpr int kMb1 = DV < 64 ? 1 : DV / 64;
    static constexpr int kMb2 = DQ < 64 ? 1 : DQ / 64;
    static constexpr int kMb = kMb1 > kMb2 ? kMb1 : kMb2;
    static constexpr int kConsumers = 128 * kWG;
    static constexpr int kThreads = kConsumers + 32;   // and the producer
    // a warpgroup's owned tiles (X1 hi, lo, X2 hi, lo) and P, dS (hi, lo),
    // then the ring and the barriers
    static constexpr int kOffStore = kCopies * (kOwn1 + kOwn2);
    static constexpr int kPerWG = kOffStore + kStoreTiles * kCopies * kStore;
    static constexpr int kOffRing = kWG * kPerWG;
    static constexpr int kRing =
        kByParts ? kStages * kStageP
                : kStages / 2 * (kStageA + kStageB) + kStages % 2 * kStageA;
    // kByParts: the softcap's factor 1 - tanh^2 of a tile's pairs, from P's
    // forming to dS's
    static constexpr int kOffFac = kOffRing + kRing;
    static constexpr int kOffBar =
        kOffFac + (kByParts ? kWG * kNo * kRows * 4 : 0);
    static constexpr int kBytes = kOffBar + 2 * kStages * 8 + 1024;
    // byte offset of stage s in the ring
    __device__ __forceinline__ static int stage(int s) {
        return kByParts ? s * kStageP
                       : s / 2 * (kStageA + kStageB) + s % 2 * kStageA;
    }
    static_assert(kOwn1 % 1024 == 0 && kOwn2 % 1024 == 0 &&
                      kStore % 1024 == 0,
                  "alignment");
    static_assert(kStage1 % 16 == 0 && kStage2 % 16 == 0,
                  "bulk copies need 16-byte rows");
    static_assert(kStages % 2 == 0 || DQ == DV,
                  "an odd ring holds both widths in one stage size");
    static_assert(kStoreTiles == 2 || kMb == 1 || kByParts,
                  "a shared P/dS tile, one M block (or dS after every "
                  "block of dV^T, kByParts)");
    static_assert(!kByParts || (kPw % 64 == 0 && kStages >= kParts),
                  "whole M blocks a part; dQ holds K's parts");
    static_assert(kBytes <= 232448, "shared memory of a block");
};

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

template <typename T>
__device__ __forceinline__ T cast_out(float v);
template <>
__device__ __forceinline__ float cast_out<float>(float v) {
    return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 cast_out<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

// ------------------------------------------------------------------ //
// D_i = sum_d dO_id O_id over dO's D (= Dv) columns, one warp a row;
// delta is [B, Hq, Sq]
// ------------------------------------------------------------------ //
template <typename T, int D>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
             float* __restrict__ delta, int64_t rows, int64_t Sq, int Hq) {
    const int64_t r = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (r >= rows) {
        return;
    }
    const T* o = out + r * D;
    const T* g = dout + r * D;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) {
        acc += to_float(o[d]) * to_float(g[d]);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
        acc += __shfl_xor_sync(kFullMask, acc, off);
    }
    if (lane == 0) {
        const int64_t h = r % Hq;
        const int64_t bi = r / Hq;          // b * Sq + i
        delta[((bi / Sq) * Hq + h) * Sq + bi % Sq] = acc;
    }
}

// ------------------------------------------------------------------ //
// A fragments from a raw streamed tile W wide (rows of LD elements; the rows
// past the sequence's end are zero, see the loop).  rows(): A[m][k] =
// Y[m0 + m][k0 + k], the T products, where float32 permutes k within each
// 8 (register slot t holds k = 2t, slot t + 4 k = 2t + 1: one 8-byte load
// for both), and the owned tiles are stored with the same permutation.
// cols(): A[m][k] = Y[k0 + k][d], the A1/A2 products, where M row slot g
// of a warp's 16 holds d = m0 + 2g and slot g + 8 d = m0 + 2g + 1 (one
// 8-byte load, or a 4-byte pair in bf16), which the output write undoes;
// d >= W is zero.  Float32 comes back split into TF32 hi and lo.
// ------------------------------------------------------------------ //
template <typename T, int W, int LD>
struct Frag;

template <int W, int LD>
struct Frag<float, W, LD> {
    static constexpr int kLd = LD;
    __device__ __forceinline__ static void rows(const float* y, int m0,
                                                int k0, int g, int t,
                                                uint32_t (&hi)[4],
                                                uint32_t (&lo)[4]) {
        const float* p = y + (m0 + g) * kLd + k0 + 2 * t;
        const float2 x0 = *reinterpret_cast<const float2*>(p);
        const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * kLd);
        split(x0.x, hi[0], lo[0]);
        split(x1.x, hi[1], lo[1]);
        split(x0.y, hi[2], lo[2]);
        split(x1.y, hi[3], lo[3]);
    }
    __device__ __forceinline__ static void cols(const float* y, int m0,
                                                int k0, int g, int t,
                                                uint32_t (&hi)[4],
                                                uint32_t (&lo)[4]) {
        const int d = m0 + 2 * g;
        float2 x0 = make_float2(0.f, 0.f);
        float2 x1 = x0;
        if (W >= 64 || d < W) {
            const float* p = y + (k0 + t) * kLd + d;
            x0 = *reinterpret_cast<const float2*>(p);
            x1 = *reinterpret_cast<const float2*>(p + 4 * kLd);
        }
        split(x0.x, hi[0], lo[0]);
        split(x0.y, hi[1], lo[1]);
        split(x1.x, hi[2], lo[2]);
        split(x1.y, hi[3], lo[3]);
    }
};

template <int W, int LD>
struct Frag<__nv_bfloat16, W, LD> {
    static constexpr int kLd = LD;
    __device__ __forceinline__ static uint32_t word(const __nv_bfloat16* y,
                                                    int off) {
        return *reinterpret_cast<const uint32_t*>(y + off);
    }
    __device__ __forceinline__ static void rows(const __nv_bfloat16* y,
                                                int m0, int k0, int g, int t,
                                                uint32_t (&a)[4],
                                                uint32_t (&)[4]) {
        const int at = (m0 + g) * kLd + k0 + 2 * t;
        a[0] = word(y, at);
        a[1] = word(y, at + 8 * kLd);
        a[2] = word(y, at + 8);
        a[3] = word(y, at + 8 * kLd + 8);
    }
    __device__ __forceinline__ static void cols(const __nv_bfloat16* y,
                                                int m0, int k0, int g, int t,
                                                uint32_t (&a)[4],
                                                uint32_t (&)[4]) {
        // rows k and k + 1 at d and d + 1: a0 = (d; k, k+1), a1 = (d + 1;
        // k, k+1), a2, a3 the same at k + 8
        const int d = m0 + 2 * g;
        a[0] = a[1] = a[2] = a[3] = 0u;
        if (W >= 64 || d < W) {
            const int at = (k0 + 2 * t) * kLd + d;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const uint32_t w0 = word(y, at + 8 * h * kLd);
                const uint32_t w1 = word(y, at + (8 * h + 1) * kLd);
                a[2 * h] = __byte_perm(w0, w1, 0x5410);
                a[2 * h + 1] = __byte_perm(w0, w1, 0x7632);
            }
        }
    }
};

// store a value of P or dS at `at` in a swizzled tile (float32: its TF32
// hi there, the rest lo C::kStore bytes on)
template <typename C>
__device__ __forceinline__ void put(unsigned char* at, float x) {
    if constexpr (C::kF32) {
        const uint32_t hi = tf32_rna(x);
        *reinterpret_cast<uint32_t*>(at) = hi;
        *reinterpret_cast<float*>(at + C::kStore) = x - __uint_as_float(hi);
    } else {
        *reinterpret_cast<__nv_bfloat16*>(at) = __float2bfloat16(x);
    }
}

// two adjacent outputs
template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ------------------------------------------------------------------ //
// The backward body: kDQ false gives dK and dV (owned K, V; streamed Q,
// dO over the group's q heads), true gives dQ (owned Q, dO; streamed K, V)
// ------------------------------------------------------------------ //
template <typename T, int DQ, int DV, bool kDQ>
__global__ void __launch_bounds__(BwdCfg<T, DQ, DV>::kThreads, 1)
bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ g1, T* __restrict__ g2, int64_t Sq, int64_t Sk,
           int Hq, int Hkv, int causal, int has_window, int64_t window,
           int has_softcap, float softcap, float scale, int64_t q_offset) {
    using C = BwdCfg<T, DQ, DV>;
    constexpr int kNo = C::kNo;
    constexpr int kCta = kNo * C::kWG;   // a block's owned rows
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
    const int64_t t_begin = lo_row / kRows;
    const int64_t n_band =
        hi_row > lo_row ? (hi_row + kRows - 1) / kRows - t_begin : 0;
    // dK/dV walk the group's q heads, dQ its one kv head
    const int64_t n_tiles = n_band * (kDQ ? 1 : groups);
    // row strides: q (and dq) and k (and dk) are DQ wide, dout, v (and dv)
    // DV wide
    const int64_t q_stride = static_cast<int64_t>(Hq) * DQ;
    const int64_t o_stride = static_cast<int64_t>(Hq) * DV;
    const int64_t k_stride = static_cast<int64_t>(Hkv) * DQ;
    const int64_t v_stride = static_cast<int64_t>(Hkv) * DV;

    if (threadIdx.x == 0) {
        for (int s = 0; s < C::kStages; ++s) {
            mbar_init(full(s), 1);
            mbar_init(empty(s), C::kConsumers);
        }
        mbar_init_fence();
    }
    __syncthreads();

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;

    if constexpr (C::kByParts) {
        if (warp == C::kConsumers / 32) {
            // ---------- producer: the streamed tiles' parts ----------- //
            // load j of a tile, part j % kParts (the consumers' order):
            // dK/dV q's parts, dout's, q's again; dQ v's, then k's
            constexpr int kP = C::kParts;
            constexpr int kLoads = (kDQ ? 2 : 3) * kP;
            for (int64_t n = 0; n < n_tiles; ++n) {
                const int64_t i0 = (t_begin + n % n_band) * kRows;
                const int hs =
                    kDQ ? hx / groups
                        : hx * groups + static_cast<int>(n / n_band);
                const int rows = static_cast<int>(
                    S_str - i0 < kRows ? S_str - i0 : kRows);
                const uint32_t bytes =
                    static_cast<uint32_t>(rows * C::kPw * C::kEs);
                for (int j = 0; j < kLoads; ++j) {
                    const int y = kDQ ? (j < kP ? 1 : 0) : (j / kP == 1);
                    const int64_t stride =
                        kDQ ? (y == 0 ? k_stride : v_stride)
                            : (y == 0 ? q_stride : o_stride);
                    const T* src =
                        kDQ ? (y == 0 ? k : v) : (y == 0 ? q : dout);
                    src += (b * S_str + i0) * stride +
                           static_cast<int64_t>(hs) * (y == 0 ? DQ : DV) +
                           (j % kP) * C::kPw;
                    const int64_t slot = kLoads * n + j;
                    const int s = static_cast<int>(slot % C::kStages);
                    mbar_wait(empty(s), static_cast<uint32_t>(
                                            ((slot / C::kStages) & 1) ^ 1));
                    if (lane == 0) {
                        mbar_expect_tx(full(s), bytes);
                    }
                    __syncwarp();
                    const uint32_t dst = smem_u32(ring + C::stage(s));
                    for (int r = lane; r < rows; r += 32) {
                        bulk_g2s(dst + r * C::kLdP * C::kEs, src + r * stride,
                                 C::kPw * C::kEs, full(s));
                    }
                }
            }
            return;
        }
    }
    if (warp == C::kConsumers / 32) {
        // ---------------- producer: the streamed tiles ---------------- //
        for (int64_t n = 0; n < n_tiles; ++n) {
            const int64_t i0 = (t_begin + n % n_band) * kRows;
            const int hs = kDQ ? hx / groups
                               : hx * groups + static_cast<int>(n / n_band);
            const int rows = static_cast<int>(
                S_str - i0 < kRows ? S_str - i0 : kRows);
            for (int yy = 0; yy < 2; ++yy) {
                // Y1 (q or k) is DQ wide, Y2 (dout or v) DV
                const int y = C::kY2First ? 1 - yy : yy;
                const int width = y == 0 ? DQ : DV;
                const int ld = y == 0 ? C::kLd1 : C::kLd2;
                const int64_t stride = kDQ ? (y == 0 ? k_stride : v_stride)
                                           : (y == 0 ? q_stride : o_stride);
                const uint32_t bytes =
                    static_cast<uint32_t>(rows * width * C::kEs);
                const int64_t slot = 2 * n + yy;
                const int s = static_cast<int>(slot % C::kStages);
                const uint32_t par =
                    static_cast<uint32_t>((slot / C::kStages) & 1);
                const T* src = kDQ ? (y == 0 ? k : v) : (y == 0 ? q : dout);
                src += (b * S_str + i0) * stride +
                       static_cast<int64_t>(hs) * width;
                mbar_wait(empty(s), par ^ 1);
                if (lane == 0) {
                    mbar_expect_tx(full(s), bytes);
                }
                __syncwarp();
                const uint32_t dst = smem_u32(ring + C::stage(s));
                for (int r = lane; r < rows; r += 32) {
                    bulk_g2s(dst + r * ld * C::kEs, src + r * stride,
                             width * C::kEs, full(s));
                }
            }
        }
        return;
    }

    // ---------------- consumers: kWG warpgroups ---------------- //
    // warpgroup wg owns rows [o0, o0 + own_valid) of the block's; all read
    // every streamed tile.  Barrier 1 + wg is this warpgroup's.
    const int wg = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;
    const int bar_id = 1 + wg;
    const int64_t o0 = o_cta + static_cast<int64_t>(wg) * kNo;
    const int own_valid = static_cast<int>(
        S_own - o0 < kNo ? (S_own > o0 ? S_own - o0 : 0) : kNo);
    unsigned char* own = smem + wg * C::kPerWG;   // X1 hi, lo, X2 hi, lo
    unsigned char* store = own + C::kOffStore;     // P (hi, lo), dS
    const int g = lane >> 2;
    const int t = lane & 3;
    const int m0 = 16 * (warp % 4);    // this warp's rows of a 64-row M

    // the owned tiles, split (float32) into the swizzled layout once;
    // float32 permutes k within each 8 as Frag::rows reads it (slots 0-3
    // hold d 0, 2, 4, 6, slots 4-7 d 1, 3, 5, 7)
    {
        for (int x = 0; x < 2; ++x) {
            // X1 (q or k) is DQ wide, X2 (dout or v) DV
            const int width = x == 0 ? DQ : DV;
            const int64_t stride = kDQ ? (x == 0 ? q_stride : o_stride)
                                       : (x == 0 ? k_stride : v_stride);
            const T* src = kDQ ? (x == 0 ? q : dout) : (x == 0 ? k : v);
            src += b * S_own * stride + static_cast<int64_t>(hx) * width;
            unsigned char* dst = own + x * C::kCopies * C::kOwn1;
            const int own_bytes = x == 0 ? C::kOwn1 : C::kOwn2;
            const int steps = width / 8;    // 8 elements a step
            for (int i = tid; i < kNo * steps; i += 128) {
                const int n = i / steps;
                const int c = (i % steps) * 8;
                uint4 raw[C::kF32 ? 2 : 1];
#pragma unroll
                for (int h = 0; h < (C::kF32 ? 2 : 1); ++h) {
                    raw[h] = n < own_valid
                                 ? *reinterpret_cast<const uint4*>(
                                       src + (o0 + n) * stride + c + 4 * h)
                                 : make_uint4(0u, 0u, 0u, 0u);
                }
                const uint32_t off = sw128_offset(kNo, n, c * C::kEs);
                if constexpr (C::kF32) {
                    const uint32_t off2 = sw128_offset(kNo, n, c * 4 + 16);
                    const float xs[8] = {
                        __uint_as_float(raw[0].x), __uint_as_float(raw[0].z),
                        __uint_as_float(raw[1].x), __uint_as_float(raw[1].z),
                        __uint_as_float(raw[0].y), __uint_as_float(raw[0].w),
                        __uint_as_float(raw[1].y), __uint_as_float(raw[1].w)};
                    uint32_t hi[8], lo[8];
#pragma unroll
                    for (int e = 0; e < 8; ++e) {
                        split(xs[e], hi[e], lo[e]);
                    }
                    *reinterpret_cast<uint4*>(dst + off) =
                        make_uint4(hi[0], hi[1], hi[2], hi[3]);
                    *reinterpret_cast<uint4*>(dst + off2) =
                        make_uint4(hi[4], hi[5], hi[6], hi[7]);
                    *reinterpret_cast<uint4*>(dst + own_bytes + off) =
                        make_uint4(lo[0], lo[1], lo[2], lo[3]);
                    *reinterpret_cast<uint4*>(dst + own_bytes + off2) =
                        make_uint4(lo[4], lo[5], lo[6], lo[7]);
                } else {
                    *reinterpret_cast<uint4*>(dst + off) = raw[0];
                }
            }
        }
        fence_proxy_async();
        bar_sync(bar_id, 128);
    }
    const uint32_t own_base = smem_u32(own);
    const uint32_t store_base = smem_u32(store);
    auto own_desc = [&](int x, int copy, int kk) {
        const int at = x == 0 ? copy * C::kOwn1
                              : C::kCopies * C::kOwn1 + copy * C::kOwn2;
        return sw128_desc(own_base + at, kNo, 32 * kk);
    };
    // P's tile (x = 0) and dS's (x = 1; the same tile when they share)
    constexpr int kDsTile = C::kStoreTiles - 1;
    auto store_desc = [&](int x, int copy, int kk) {
        return sw128_desc(
            store_base + (x * kDsTile * C::kCopies + copy) * C::kStore, kNo,
            32 * kk);
    };
    unsigned char* const ds_tile = store + kDsTile * C::kCopies * C::kStore;

    // exp(x - L) = exp2(x log2(e) - L log2(e)): the logits and L are
    // taken in base 2
    constexpr float kLog2e = 1.4426950408889634f;
    const float scale2 = scale * kLog2e;
    // dQ: L (base 2) and D of the owned q rows this thread's columns hold
    float own_l2[kNo / 8][2], own_delta[kNo / 8][2];
    if constexpr (kDQ) {
        const float* lse_b = lse + (b * Hq + hx) * Sq;
        const float* delta_b = delta + (b * Hq + hx) * Sq;
#pragma unroll
        for (int j = 0; j < kNo / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int c = 8 * j + 2 * t + e;
                own_l2[j][e] = c < own_valid ? lse_b[o0 + c] * kLog2e
                                             : inf_f();
                own_delta[j][e] = c < own_valid ? delta_b[o0 + c] : 0.f;
            }
        }
    }
    // where this thread's element e of the T accumulators (streamed row
    // m0 + g + 8(e/2), owned row 8j + 2t + e%2) goes in the swizzled P and
    // dS tiles: off[e] + 1024 j (owned rows 8 apart are 1024 bytes apart)
    uint32_t off[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        off[e] = sw128_offset(kNo, 2 * t + (e & 1),
                              (m0 + g + 8 * (e >> 1)) * C::kEs);
    }

    constexpr int kMb1 = kDQ ? 0 : C::kMb1;   // M blocks of dV^T
    constexpr int kMb2 = C::kMb2;             // of dK^T or dQ^T
    constexpr int kMb = kMb1 > kMb2 ? kMb1 : kMb2;
    float acc1[kMb1 > 0 ? kMb1 : 1][kNo / 2];   // dV^T (dK/dV only)
    float acc2[kMb2][kNo / 2];                  // dK^T, or dQ^T
#pragma unroll
    for (int i = 0; i < kNo / 2; ++i) {
#pragma unroll
        for (int mb = 0; mb < (kMb1 > 0 ? kMb1 : 1); ++mb) {
            acc1[mb][i] = 0.f;
        }
#pragma unroll
        for (int mb = 0; mb < kMb2; ++mb) {
            acc2[mb][i] = 0.f;
        }
    }

    using Frag1 = Frag<T, DQ, C::kLd1>;
    using Frag2 = Frag<T, DV, C::kLd2>;
    if constexpr (C::kByParts) {
        // Each 256-wide streamed tile as kParts column parts, a stage
        // each, every part freed once its fragments are in registers.
        // dK/dV, 3 kParts loads a tile: Q's parts (T1, then P into the
        // store tile), dO's (T2's parts, and dV^T's M blocks of each part
        // from P), then dS over P and Q's parts again (dK^T's M blocks).
        // dQ, 2 kParts: V's (T2), K's (T1, each kept for dQ^T's M blocks
        // after dS).
        using FragP = Frag<T, C::kPw, C::kLdP>;
        constexpr int kP = C::kParts;
        constexpr int kLoads = (kDQ ? 2 : 3) * kP;
        constexpr int kHs = C::kPw / C::kK;   // k-steps a part
        constexpr int kTc = C::kChunk < kHs ? C::kChunk : kHs;
        constexpr int kAs = kRows / C::kK;
        constexpr int kAc = C::kChunk < kAs ? C::kChunk : kAs;
        constexpr int kBp = C::kPw / 64;      // M blocks a part
        for (int64_t n = 0; n < n_tiles; ++n) {
            const int64_t i0 = (t_begin + n % n_band) * kRows;
            const int nv = static_cast<int>(S_str - i0 < kRows ? S_str - i0
                                                                : kRows);
            const int hq =
                kDQ ? hx : hx * groups + static_cast<int>(n / n_band);
            // load j of this tile: its stage; take waits for it and zeros
            // its rows past the end (the last tile), give frees it
            auto at = [&](int j) {
                return reinterpret_cast<T*>(
                    ring + C::stage(static_cast<int>((kLoads * n + j) %
                                                     C::kStages)));
            };
            auto take = [&](int j) {
                const int64_t slot = kLoads * n + j;
                mbar_wait(full(static_cast<int>(slot % C::kStages)),
                          static_cast<uint32_t>((slot / C::kStages) & 1));
                T* y = at(j);
                if (nv < kRows) {
                    for (int i = tid; i < (kRows - nv) * C::kPw; i += 128) {
                        y[(nv + i / C::kPw) * C::kLdP + i % C::kPw] =
                            cast_out<T>(0.f);
                    }
                    fence_proxy_async();   // before the producer's next copy
                    bar_sync(bar_id, 128);
                }
                return y;
            };
            auto give = [&](int j) {
                mbar_arrive(empty(static_cast<int>((kLoads * n + j) %
                                                   C::kStages)));
            };
            // the owned and store tiles' addresses, opaque to the
            // compiler once a tile, so that it forms each descriptor where
            // it is used and holds none of them across the loop
            uint32_t ob = own_base, sb = store_base;
            asm volatile("" : "+r"(ob), "+r"(sb));
            auto odesc = [&](int x, int copy, int kk) {
                const int off_x = x == 0 ? copy * C::kOwn1
                                         : C::kCopies * C::kOwn1 +
                                               copy * C::kOwn2;
                return sw128_desc(ob + off_x, kNo, 32 * kk);
            };
            // T += part pp of the streamed tile y against owned tile x
            auto t_part = [&](float (&d)[kNo / 2], const T* y, int x,
                              int pp) {
                product<T, kNo, kHs, kTc>(
                    d,
                    [&](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
                        FragP::rows(y, m0, kk * C::kK, g, t, hi, lo);
                    },
                    [&](int kk, int copy) {
                        return odesc(x, copy, kk + pp * kHs);
                    },
                    pp > 0);
            };
            // A1 or A2's M blocks of part pp (the columns of y) against
            // the store tile, each into a fresh accumulator added to acc
            // on the CUDA cores; load j is freed once their fragments are
            // in (two accumulators in turns, each added once the next
            // block had waited for it, measured no faster)
            float a[kNo / 2];
            auto a_part = [&](float (&acc)[C::kMb][kNo / 2], const T* y,
                              int pp, int j) {
#pragma unroll
                for (int mb2 = 0; mb2 < kBp; ++mb2) {
                    product<T, kNo, kAs, kAc>(
                        a,
                        [&](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
                            FragP::cols(y, 64 * mb2 + m0, kk * C::kK, g, t,
                                        hi, lo);
                        },
                        [&](int kk, int copy) {
                            return sw128_desc(sb + copy * C::kStore, kNo,
                                              32 * kk);
                        },
                        false);
                    if (mb2 == kBp - 1) {
                        give(j);
                    }
                    wgmma_wait<0>();
                    fence_regs(a);
#pragma unroll
                    for (int i = 0; i < kNo / 2; ++i) {
                        acc[kBp * pp + mb2][i] =
                            acc[kBp * pp + mb2][i] + a[i];
                    }
                }
            };

            float row_l2[2] = {0.f, 0.f}, row_delta[2] = {0.f, 0.f};
            if constexpr (!kDQ) {
                const float* lse_b = lse + (b * Hq + hq) * Sq;
                const float* delta_b = delta + (b * Hq + hq) * Sq;
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    const int64_t row = i0 + m0 + g + 8 * r;
                    row_l2[r] = row < Sq ? lse_b[row] * kLog2e : inf_f();
                    row_delta[r] = row < Sq ? delta_b[row] : 0.f;
                }
            }
            const int64_t q_lo = kDQ ? o0 : i0;
            const int64_t q_hi = q_lo + (kDQ ? kNo : kRows) - 1;
            const int64_t k_lo = kDQ ? i0 : o0;
            const int64_t k_hi = k_lo + (kDQ ? kRows : kNo) - 1;
            const bool inside = q_hi < Sq && k_hi < Sk &&
                                (!causal || k_hi <= q_offset + q_lo) &&
                                (!has_window ||
                                 k_lo > q_offset + q_hi - window);
            // P (part 0: from t1 (S) into the store tile, and the
            // softcap's factor into its own tile) or dS (part 1: from t2
            // (dP), with P read back from the store tile (dK/dV, after
            // dV^T has read it: t1 is dead by then) or formed from t1
            // (dQ), into the store tile)
            float t1[kNo / 2], t2[kNo / 2];
            auto body = [&](auto part, auto masked, auto capped) {
                constexpr int kPart = decltype(part)::value;
                constexpr bool kMasked = decltype(masked)::value;
                constexpr bool kCapped = decltype(capped)::value;
                unsigned char* const fac =
                    smem + C::kOffFac + wg * kNo * kRows * 4;
#pragma unroll
                for (int j = 0; j < kNo / 8; ++j) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        unsigned char* const pt = store + off[e] + 1024 * j;
                        if constexpr (kPart == 1 && !kDQ) {
                            const float Dl = row_delta[e >> 1];
                            float ds = (__uint_as_float(*reinterpret_cast<
                                            const uint32_t*>(pt)) +
                                        *reinterpret_cast<const float*>(
                                            pt + C::kStore)) *
                                       (t2[4 * j + e] - Dl);
                            if constexpr (kCapped) {
                                ds = ds * *reinterpret_cast<const float*>(
                                              fac + off[e] + 1024 * j);
                            }
                            put<C>(pt, ds);
                            continue;
                        }
                        const float L2 =
                            kDQ ? own_l2[j][e & 1] : row_l2[e >> 1];
                        float x2, dfac = 1.f;
                        if constexpr (kCapped) {
                            const float th = tanhf(t1[4 * j + e] * scale /
                                                   softcap);
                            x2 = th * softcap * kLog2e;
                            dfac = 1.f - th * th;
                        } else {
                            x2 = t1[4 * j + e] * scale2;
                        }
                        float p = exp2f(x2 - L2);
                        if constexpr (kMasked) {
                            const int r = m0 + g + 8 * (e >> 1);
                            const int c = 8 * j + 2 * t + (e & 1);
                            const int64_t qi = kDQ ? o0 + c : i0 + r;
                            const int64_t kj = kDQ ? i0 + r : o0 + c;
                            const int64_t pos = q_offset + qi;
                            const bool ok = qi < Sq && kj < Sk &&
                                            (!causal || kj <= pos) &&
                                            (!has_window ||
                                             kj > pos - window);
                            p = ok ? p : 0.f;
                        }
                        if constexpr (kPart == 0) {
                            put<C>(pt, p);
                            if constexpr (kCapped) {
                                *reinterpret_cast<float*>(
                                    fac + off[e] + 1024 * j) = dfac;
                            }
                        } else {
                            float ds =
                                p * (t2[4 * j + e] - own_delta[j][e & 1]);
                            if constexpr (kCapped) {
                                ds = ds * dfac;
                            }
                            put<C>(pt, ds);
                        }
                    }
                }
                fence_proxy_async();
                bar_sync(bar_id, 128);
            };
            auto form = [&](auto part) {
                if (inside) {
                    if (has_softcap) {
                        body(part, std::false_type{}, std::true_type{});
                    } else {
                        body(part, std::false_type{}, std::false_type{});
                    }
                } else {
                    if (has_softcap) {
                        body(part, std::true_type{}, std::true_type{});
                    } else {
                        body(part, std::true_type{}, std::false_type{});
                    }
                }
            };
            using Part0 = std::integral_constant<int, 0>;
            using Part1 = std::integral_constant<int, 1>;

            if constexpr (kDQ) {
#pragma unroll
                for (int pp = 0; pp < kP; ++pp) {   // V's parts: T2
                    t_part(t2, take(pp), 1, pp);
                    give(pp);
                }
#pragma unroll
                for (int pp = 0; pp < kP; ++pp) {   // K's parts: T1
                    t_part(t1, take(kP + pp), 0, pp);
                }
                wgmma_wait<0>();
                fence_regs(t1);
                fence_regs(t2);
                form(Part1{});
#pragma unroll
                for (int pp = 0; pp < kP; ++pp) {   // dQ^T from K's parts
                    a_part(acc2, at(kP + pp), pp, kP + pp);
                }
            } else {
#pragma unroll
                for (int pp = 0; pp < kP; ++pp) {   // Q's parts: T1, P
                    t_part(t1, take(pp), 0, pp);
                    give(pp);
                }
                wgmma_wait<0>();
                fence_regs(t1);
                form(Part0{});
#pragma unroll
                for (int pp = 0; pp < kP; ++pp) {   // dO's: T2, dV^T
                    const T* y = take(kP + pp);
                    t_part(t2, y, 1, pp);
                    a_part(acc1, y, pp, kP + pp);
                }
                fence_regs(t2);   // T2 is done, and P is read
                form(Part1{});                      // dS over P
#pragma unroll
                for (int pp = 0; pp < kP; ++pp) {   // Q's again: dK^T
                    a_part(acc2, take(2 * kP + pp), pp, 2 * kP + pp);
                }
            }
        }
    }
    // every other instantiation: whole streamed tiles
    if constexpr (!C::kByParts) for (int64_t n = 0; n < n_tiles; ++n) {
        const int64_t i0 = (t_begin + n % n_band) * kRows;
        const int nv = static_cast<int>(S_str - i0 < kRows ? S_str - i0
                                                            : kRows);
        const int hq = kDQ ? hx : hx * groups + static_cast<int>(n / n_band);
        const int64_t slot1 = 2 * n + (C::kY2First ? 1 : 0);
        const int64_t slot2 = 2 * n + (C::kY2First ? 0 : 1);
        const int s1 = static_cast<int>(slot1 % C::kStages);
        const int s2 = static_cast<int>(slot2 % C::kStages);
        const uint32_t p1 = static_cast<uint32_t>((slot1 / C::kStages) & 1);
        const uint32_t p2 = static_cast<uint32_t>((slot2 / C::kStages) & 1);
        T* y1 = reinterpret_cast<T*>(ring + C::stage(s1));
        T* y2 = reinterpret_cast<T*>(ring + C::stage(s2));

        // dK/dV: L (base 2) and D of this thread's streamed q rows
        float row_l2[2] = {0.f, 0.f}, row_delta[2] = {0.f, 0.f};
        if constexpr (!kDQ) {
            const float* lse_b = lse + (b * Hq + hq) * Sq;
            const float* delta_b = delta + (b * Hq + hq) * Sq;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int64_t row = i0 + m0 + g + 8 * r;
                row_l2[r] = row < Sq ? lse_b[row] * kLog2e : inf_f();
                row_delta[r] = row < Sq ? delta_b[row] : 0.f;
            }
        }

        // T1 = Y1 X1^T over DQ, T2 = Y2 X2^T over DV (at Dqk != Dv T2 first,
        // while Y1 lands; dQ frees V's stage as soon as T2 has it)
        constexpr int kTs1 = DQ / C::kK;
        constexpr int kTc1 = C::kChunk < kTs1 ? C::kChunk : kTs1;
        constexpr int kTs2 = DV / C::kK;
        constexpr int kTc2 = C::kChunk < kTs2 ? C::kChunk : kTs2;
        float t1[kNo / 2], t2[kNo / 2];
        if constexpr (C::kY2First) {
            mbar_wait(full(s2), p2);
            if (nv < kRows) {   // the last tile: rows past the end are zero
                for (int i = tid; i < (kRows - nv) * DV; i += 128) {
                    y2[(nv + i / DV) * C::kLd2 + i % DV] = cast_out<T>(0.f);
                }
                fence_proxy_async();   // before the producer's next copy
                bar_sync(bar_id, 128);
            }
            product<T, kNo, kTs2, kTc2>(
                t2,
                [&](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
                    Frag2::rows(y2, m0, kk * C::kK, g, t, hi, lo);
                },
                [&](int kk, int copy) { return own_desc(1, copy, kk); },
                false);
            if constexpr (kDQ) {
                mbar_arrive(empty(s2));
            }
            mbar_wait(full(s1), p1);
            if (nv < kRows) {
                for (int i = tid; i < (kRows - nv) * DQ; i += 128) {
                    y1[(nv + i / DQ) * C::kLd1 + i % DQ] = cast_out<T>(0.f);
                }
                fence_proxy_async();
                bar_sync(bar_id, 128);
            }
            product<T, kNo, kTs1, kTc1>(
                t1,
                [&](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
                    Frag1::rows(y1, m0, kk * C::kK, g, t, hi, lo);
                },
                [&](int kk, int copy) { return own_desc(0, copy, kk); },
                false);
        } else {
            mbar_wait(full(s1), p1);
            mbar_wait(full(s2), p2);
            if (nv < kRows) {   // the last tile: rows past the end are zero
                // (every warpgroup writes the same zeros, then reads)
                for (int i = tid; i < (kRows - nv) * DQ; i += 128) {
                    y1[(nv + i / DQ) * C::kLd1 + i % DQ] = cast_out<T>(0.f);
                }
                for (int i = tid; i < (kRows - nv) * DV; i += 128) {
                    y2[(nv + i / DV) * C::kLd2 + i % DV] = cast_out<T>(0.f);
                }
                fence_proxy_async();   // before the producer's next copy
                bar_sync(bar_id, 128);
            }

            product<T, kNo, kTs1, kTc1>(
                t1,
                [&](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
                    Frag1::rows(y1, m0, kk * C::kK, g, t, hi, lo);
                },
                [&](int kk, int copy) { return own_desc(0, copy, kk); },
                false);
            product<T, kNo, kTs2, kTc2>(
                t2,
                [&](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
                    Frag2::rows(y2, m0, kk * C::kK, g, t, hi, lo);
                },
                [&](int kk, int copy) { return own_desc(1, copy, kk); },
                false);
        }
        wgmma_wait<0>();
        fence_regs(t1);
        fence_regs(t2);

        // P and dS (dS kept in t2); the mask and the softcap are decided
        // once a tile
        const int64_t q_lo = kDQ ? o0 : i0;
        const int64_t q_hi = q_lo + (kDQ ? kNo : kRows) - 1;
        const int64_t k_lo = kDQ ? i0 : o0;
        const int64_t k_hi = k_lo + (kDQ ? kRows : kNo) - 1;
        const bool inside = q_hi < Sq && k_hi < Sk &&
                            (!causal || k_hi <= q_offset + q_lo) &&
                            (!has_window || k_lo > q_offset + q_hi - window);
        auto body = [&](auto masked, auto capped) {
            constexpr bool kMasked = decltype(masked)::value;
            constexpr bool kCapped = decltype(capped)::value;
#pragma unroll
            for (int j = 0; j < kNo / 8; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float L2 = kDQ ? own_l2[j][e & 1] : row_l2[e >> 1];
                    const float Dl = kDQ ? own_delta[j][e & 1]
                                         : row_delta[e >> 1];
                    float x2, dfac = 1.f;
                    if constexpr (kCapped) {
                        const float th = tanhf(t1[4 * j + e] * scale /
                                               softcap);
                        x2 = th * softcap * kLog2e;
                        dfac = 1.f - th * th;
                    } else {
                        x2 = t1[4 * j + e] * scale2;
                    }
                    float p = exp2f(x2 - L2);
                    float ds = p * (t2[4 * j + e] - Dl);
                    if constexpr (kCapped) {
                        ds = ds * dfac;
                    }
                    if constexpr (kMasked) {
                        const int r = m0 + g + 8 * (e >> 1);
                        const int c = 8 * j + 2 * t + (e & 1);
                        const int64_t qi = kDQ ? o0 + c : i0 + r;
                        const int64_t kj = kDQ ? i0 + r : o0 + c;
                        const int64_t pos = q_offset + qi;
                        const bool ok =
                            qi < Sq && kj < Sk && (!causal || kj <= pos) &&
                            (!has_window || kj > pos - window);
                        p = ok ? p : 0.f;
                        ds = ok ? ds : 0.f;
                    }
                    t2[4 * j + e] = ds;
                    if constexpr (!kDQ) {
                        put<C>(store + off[e] + 1024 * j, p);
                    }
                    if constexpr (kDQ || kDsTile == 1) {
                        put<C>(ds_tile + off[e] + 1024 * j, ds);
                    }
                }
            }
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
        fence_proxy_async();
        bar_sync(bar_id, 128);

        // A1 = Y2^T P (dV^T), A2 = Y1^T dS (dK^T or dQ^T), one M block at
        // a time into fresh accumulators (t1, t2: free now), then added to
        // the sums on the CUDA cores: no tensor-core sum runs longer than
        // one tile, whose rounding would otherwise grow with the band and
        // the group.  When P and dS share a tile, dS goes in once A1 has
        // read P.  A1 has kMb1 blocks (DV rows), A2 kMb2 (DQ rows).
        constexpr int kAs = kRows / C::kK;
        constexpr int kAc = C::kChunk < kAs ? C::kChunk : kAs;
        constexpr bool kShared = !kDQ && kDsTile == 0;
        if constexpr (C::kY2First) {
            // dV^T's blocks first, then the Dv-wide stage is free while
            // dK^T's (or dQ^T's) run
            static_assert(!kShared, "P and dS apart");
#pragma unroll
            for (int mb = 0; mb < kMb1; ++mb) {
                product<T, kNo, kAs, kAc>(
                    t1,
                    [&](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
                        Frag2::cols(y2, 64 * mb + m0, kk * C::kK, g, t, hi,
                                    lo);
                    },
                    [&](int kk, int copy) { return store_desc(0, copy, kk); },
                    false);
                if (mb == kMb1 - 1) {
                    mbar_arrive(empty(s2));   // dO's last fragments are in
                }
                wgmma_wait<0>();
                fence_regs(t1);
#pragma unroll
                for (int i = 0; i < kNo / 2; ++i) {
                    acc1[mb][i] = acc1[mb][i] + t1[i];
                }
            }
#pragma unroll
            for (int mb = 0; mb < kMb2; ++mb) {
                product<T, kNo, kAs, kAc>(
                    t2,
                    [&](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
                        Frag1::cols(y1, 64 * mb + m0, kk * C::kK, g, t, hi,
                                    lo);
                    },
                    [&](int kk, int copy) { return store_desc(1, copy, kk); },
                    false);
                if (mb == kMb2 - 1) {
                    mbar_arrive(empty(s1));
                }
                wgmma_wait<0>();
                fence_regs(t2);
#pragma unroll
                for (int i = 0; i < kNo / 2; ++i) {
                    acc2[mb][i] = acc2[mb][i] + t2[i];
                }
            }
            continue;
        }
#pragma unroll
        for (int mb = 0; mb < kMb; ++mb) {
            const bool a1 = mb < kMb1;
            const bool a2 = mb < kMb2;
            if (a1) {
                product<T, kNo, kAs, kAc>(
                    t1,
                    [&](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
                        Frag2::cols(y2, 64 * mb + m0, kk * C::kK, g, t, hi,
                                    lo);
                    },
                    [&](int kk, int copy) { return store_desc(0, copy, kk); },
                    false);
            }
            if constexpr (kShared) {
                wgmma_wait<0>();   // P is read
                fence_regs(t1);
#pragma unroll
                for (int i = 0; i < kNo / 2; ++i) {
                    acc1[mb][i] = acc1[mb][i] + t1[i];
                }
#pragma unroll
                for (int j = 0; j < kNo / 8; ++j) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        put<C>(ds_tile + off[e] + 1024 * j, t2[4 * j + e]);
                    }
                }
                fence_proxy_async();
                bar_sync(bar_id, 128);
            }
            if (a2) {
                product<T, kNo, kAs, kAc>(
                    t2,
                    [&](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
                        Frag1::cols(y1, 64 * mb + m0, kk * C::kK, g, t, hi,
                                    lo);
                    },
                    [&](int kk, int copy) { return store_desc(1, copy, kk); },
                    false);
            }
            if (mb == kMb - 1) {
                mbar_arrive(empty(s1));   // the tiles are in registers now
                mbar_arrive(empty(s2));
            }
            wgmma_wait<0>();
            fence_regs(t1);
            fence_regs(t2);
#pragma unroll
            for (int i = 0; i < kNo / 2; ++i) {
                if constexpr (!kShared) {
                    if (a1) {
                        acc1[mb][i] = acc1[mb][i] + t1[i];
                    }
                }
                if (a2) {
                    acc2[mb][i] = acc2[mb][i] + t2[i];
                }
            }
        }
    }

    // out: acc[mb][4j + e] at d = 64mb + m0 + 2g + e/2 (Frag::cols' row
    // order), owned row c = 8j + 2t + e%2; d and d + 1 are written together.
    // g1 (dK or dQ) has DQ columns, g2 (dV) DV.
    const int64_t stride1 = kDQ ? q_stride : k_stride;
#pragma unroll
    for (int mb = 0; mb < kMb; ++mb) {
        const int d = 64 * mb + m0 + 2 * g;
#pragma unroll
        for (int j = 0; j < kNo / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int c = 8 * j + 2 * t + e;
                if (c >= own_valid) {
                    continue;
                }
                const int64_t row = b * S_own + o0 + c;
                if (mb < kMb2 && (DQ >= 64 || d < DQ)) {
                    store2<T>(g1 + row * stride1 +
                                  static_cast<int64_t>(hx) * DQ + d,
                              acc2[mb][4 * j + e] * scale,
                              acc2[mb][4 * j + e + 2] * scale);
                }
                if constexpr (!kDQ) {
                    if (mb < kMb1 && (DV >= 64 || d < DV)) {
                        store2<T>(g2 + row * v_stride +
                                      static_cast<int64_t>(hx) * DV + d,
                                  acc1[mb][4 * j + e],
                                  acc1[mb][4 * j + e + 2]);
                    }
                }
            }
        }
    }
}

// A side stream of the highest priority and the events that fork it from
// the caller's stream and join it back, one set a device, made at its
// first use there (null if that failed)
struct Side {
    cudaStream_t stream;
    cudaEvent_t fork, join;
};
inline const Side* side_stream() {
    constexpr int kMaxDevices = 64;
    static Side sides[kMaxDevices];
    static bool made[kMaxDevices] = {};
    static std::mutex lock;
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 ||
        dev >= kMaxDevices) {
        cudaGetLastError();
        return nullptr;
    }
    std::lock_guard<std::mutex> hold(lock);
    if (!made[dev]) {
        Side& sd = sides[dev];
        int least = 0, greatest = 0;
        if (cudaDeviceGetStreamPriorityRange(&least, &greatest) !=
                cudaSuccess ||
            cudaStreamCreateWithPriority(&sd.stream, cudaStreamNonBlocking,
                                         greatest) != cudaSuccess ||
            cudaEventCreateWithFlags(&sd.fork, cudaEventDisableTiming) !=
                cudaSuccess ||
            cudaEventCreateWithFlags(&sd.join, cudaEventDisableTiming) !=
                cudaSuccess) {
            cudaGetLastError();
            return nullptr;
        }
        made[dev] = true;
    }
    return &sides[dev];
}

template <typename K>
int set_smem(K kernel, int bytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) {   // returned here, so cleared for later calls
        cudaGetLastError();
    }
    return static_cast<int>(err);
}

template <typename T, int DQ, int DV>
int launch(const T* q, const T* k, const T* v, const T* out, const T* dout,
           const float* lse, float* delta, T* dq, T* dk, T* dv, int64_t B,
           int64_t Sq, int64_t Sk, int64_t Hq, int64_t Hkv, int causal,
           int has_window, int64_t window, int has_softcap, float softcap,
           float scale, int64_t q_offset, cudaStream_t stream) {
    using C = BwdCfg<T, DQ, DV>;
    const int64_t rows = B * Sq * Hq;
    delta_kernel<T, DV><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                          stream>>>(out, dout, delta, rows, Sq,
                                    static_cast<int>(Hq));
    int err = static_cast<int>(cudaGetLastError());
    if (err != 0) {
        return err;
    }
    const int hq = static_cast<int>(Hq);
    const int hkv = static_cast<int>(Hkv);
    constexpr int kCta = C::kNo * C::kWG;    // owned rows of a block
    // dK, dV: blocks key tile by key tile (the longest causal bands first)
    if ((err = set_smem(bwd_kernel<T, DQ, DV, false>, C::kBytes))) {
        return err;
    }
    if ((err = set_smem(bwd_kernel<T, DQ, DV, true>, C::kBytes))) {
        return err;
    }
    // float32 (256, 256): the dK/dV launch on a side stream of the
    // highest priority, forked after delta_kernel and joined before the
    // call returns, so that the dQ launch's blocks fill the SMs the dK/dV
    // launch leaves idle (one kv head's Sk / 32 blocks: 96 of 132 SMs at
    // path B's shape) and never delay its blocks
    cudaStream_t kstream = stream;
    if constexpr (C::kByParts) {
        const Side* side = side_stream();
        if (side == nullptr) {
            return static_cast<int>(cudaErrorInitializationError);
        }
        kstream = side->stream;
        if ((err = static_cast<int>(cudaEventRecord(side->fork, stream))) ||
            (err = static_cast<int>(
                 cudaStreamWaitEvent(kstream, side->fork, 0)))) {
            return err;
        }
    }
    const dim3 kgrid(static_cast<unsigned>(B * Hkv),
                     static_cast<unsigned>((Sk + kCta - 1) / kCta));
    bwd_kernel<T, DQ, DV, false><<<kgrid, C::kThreads, C::kBytes, kstream>>>(
        q, k, v, dout, lse, delta, dk, dv, Sq, Sk, hq, hkv, causal,
        has_window, window, has_softcap, softcap, scale, q_offset);
    if ((err = static_cast<int>(cudaGetLastError()))) {
        return err;
    }
    const dim3 qgrid(static_cast<unsigned>(B * Hq),
                     static_cast<unsigned>((Sq + kCta - 1) / kCta));
    bwd_kernel<T, DQ, DV, true><<<qgrid, C::kThreads, C::kBytes, stream>>>(
        q, k, v, dout, lse, delta, dq, nullptr, Sq, Sk, hq, hkv, causal,
        has_window, window, has_softcap, softcap, scale, q_offset);
    if ((err = static_cast<int>(cudaGetLastError()))) {
        return err;
    }
    if constexpr (C::kByParts) {
        const Side* side = side_stream();
        if ((err = static_cast<int>(cudaEventRecord(side->join, kstream))) ||
            (err = static_cast<int>(
                 cudaStreamWaitEvent(stream, side->join, 0)))) {
            return err;
        }
    }
    return 0;
}

// bf16 at (192, 128): delta_kernel, then flash_attention_bwd_mla.cuh's body
// for dK/dV (a block per (b, kv head, 128 keys), key tile by key tile) and
// for dQ (a block per (b, q head, 128 q rows), from the last back)
int launch_mla(const bf16_t* q, const bf16_t* k, const bf16_t* v,
               const bf16_t* out, const bf16_t* dout, const float* lse,
               float* delta, bf16_t* dq, bf16_t* dk, bf16_t* dv, int64_t B,
               int64_t Sq, int64_t Sk, int64_t Hq, int64_t Hkv, int causal,
               int has_window, int64_t window, int has_softcap,
               float softcap, float scale, int64_t q_offset,
               cudaStream_t stream) {
    using KV = MlaCfg<false>;
    using QC = MlaCfg<true>;
    const int64_t rows = B * Sq * Hq;
    delta_kernel<bf16_t, 128><<<static_cast<unsigned>((rows + 7) / 8), 256,
                                0, stream>>>(out, dout, delta, rows, Sq,
                                             static_cast<int>(Hq));
    int err = static_cast<int>(cudaGetLastError());
    if (err != 0) {
        return err;
    }
    const int hq = static_cast<int>(Hq);
    const int hkv = static_cast<int>(Hkv);
    if ((err = set_smem(mla_bwd_kernel<false>, KV::kBytes))) {
        return err;
    }
    const dim3 kgrid(static_cast<unsigned>(B * Hkv),
                     static_cast<unsigned>((Sk + KV::kCta - 1) / KV::kCta));
    mla_bwd_kernel<false><<<kgrid, KV::kThreads, KV::kBytes, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, Sq, Sk, hq, hkv, causal,
        has_window, window, has_softcap, softcap, scale, q_offset);
    if ((err = static_cast<int>(cudaGetLastError()))) {
        return err;
    }
    if ((err = set_smem(mla_bwd_kernel<true>, QC::kBytes))) {
        return err;
    }
    const dim3 qgrid(static_cast<unsigned>(B * Hq),
                     static_cast<unsigned>((Sq + QC::kCta - 1) / QC::kCta));
    mla_bwd_kernel<true><<<qgrid, QC::kThreads, QC::kBytes, stream>>>(
        q, k, v, dout, lse, delta, dq, nullptr, Sq, Sk, hq, hkv, causal,
        has_window, window, has_softcap, softcap, scale, q_offset);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, const T* out,
             const T* dout, const float* lse, float* delta, T* dq, T* dk,
             T* dv, int64_t B, int64_t Sq, int64_t Sk, int64_t Hq,
             int64_t Hkv, int64_t Dqk, int64_t Dv, int causal,
             int has_window, int64_t window, int has_softcap, float softcap,
             float scale, int64_t q_offset, void* stream) {
    if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
        B * Hq > 0x7fffffff || Sq / 16 >= 65535 || Sk / 16 >= 65535) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (Dqk == 192 && Dv == 128) {   // MLA
        if constexpr (std::is_same<T, __nv_bfloat16>::value) {
            return launch_mla(q, k, v, out, dout, lse, delta, dq, dk, dv, B,
                              Sq, Sk, Hq, Hkv, causal, has_window, window,
                              has_softcap, softcap, scale, q_offset, s);
        } else {
            return launch<T, 192, 128>(q, k, v, out, dout, lse, delta, dq,
                                       dk, dv, B, Sq, Sk, Hq, Hkv, causal,
                                       has_window, window, has_softcap,
                                       softcap, scale, q_offset, s);
        }
    }
    if (Dqk != Dv) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
#define REPRO_FA_BWD_CASE(DIM)                                              \
    case DIM:                                                               \
        return launch<T, DIM, DIM>(q, k, v, out, dout, lse, delta, dq, dk,  \
                                   dv, B, Sq, Sk, Hq, Hkv, causal,          \
                                   has_window, window, has_softcap,         \
                                   softcap, scale, q_offset, s);
    switch (Dqk) {
        REPRO_FA_BWD_CASE(16)
        REPRO_FA_BWD_CASE(32)
        REPRO_FA_BWD_CASE(64)
        REPRO_FA_BWD_CASE(128)
        REPRO_FA_BWD_CASE(256)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef REPRO_FA_BWD_CASE
}

}  // namespace

extern "C" {

// Each entry launches its kernels on `stream` without synchronising and
// returns a CUDA error code: 0 when every launch was accepted.  out and
// lse are the forward's (flash_attention_f32/bf16 with lse), dout the
// gradient of out; delta [B, Hq, Sq] is float32 scratch; dq, dk, dv have
// the shapes of q, k, v.  q and k have head dim Dqk, v, out and dout Dv;
// (Dqk, Dv) must be (D, D) with D 16, 32, 64, 128 or 256, or (192, 128).
// Every tensor is contiguous and 16-byte aligned.
int flash_attention_bwd_f32(const float* q, const float* k, const float* v,
                            const float* out, const float* dout,
                            const float* lse, float* delta, float* dq,
                            float* dk, float* dv, int64_t B, int64_t Sq,
                            int64_t Sk, int64_t Hq, int64_t Hkv, int64_t Dqk,
                            int64_t Dv, int causal, int has_window,
                            int64_t window, int has_softcap, float softcap,
                            float scale, int64_t q_offset, void* stream) {
    return dispatch<float>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq,
                           Sk, Hq, Hkv, Dqk, Dv, causal, has_window, window,
                           has_softcap, softcap, scale, q_offset, stream);
}

int flash_attention_bwd_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* out, const __nv_bfloat16* dout, const float* lse,
    float* delta, __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
    int64_t B, int64_t Sq, int64_t Sk, int64_t Hq, int64_t Hkv, int64_t Dqk,
    int64_t Dv, int causal, int has_window, int64_t window, int has_softcap,
    float softcap, float scale, int64_t q_offset, void* stream) {
    return dispatch<__nv_bfloat16>(q, k, v, out, dout, lse, delta, dq, dk,
                                   dv, B, Sq, Sk, Hq, Hkv, Dqk, Dv, causal,
                                   has_window, window, has_softcap, softcap,
                                   scale, q_offset, stream);
}

}  // extern "C"
