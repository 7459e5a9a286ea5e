// Flash attention backward for Hopper (sm_90a), bound through a plain C
// interface.
//
// The TPU kernel `_fa_kernel` of the JAX package
// (src/repro/kernels/flash_attention.py:29, launched at :120) has no
// backward: the JAX package trains by differentiating its plain versions
// (`attention_ref`, `_attention_chunked`; src/repro/kernels/ops.py).  This
// file computes the same gradient for the forward kernel of
// flash_attention.cu, from its output O and the log-sum-exp L of each row
// that it writes when asked (FlashAttention-2's scheme):
//
//   P_ij  = exp(s_ij - L_i)                 (0 where the forward masks)
//   D_i   = sum_d dO_id O_id                 (delta_kernel)
//   dP_ij = dO_i . v_j
//   dS_ij = P_ij (dP_ij - D_i) c_ij,   c_ij = 1 - tanh^2(x_ij / cap) with
//           the softcap (x_ij = scale q_i . k_j), else 1
//   dQ_i  = scale sum_j dS_ij k_j            (dq_kernel)
//   dK_j  = scale sum_i dS_ij q_i,  dV_j = sum_i P_ij dO_i   (dkdv_kernel)
//
// with the forward's mask (j < Sk, j <= pos_i when causal, j > pos_i -
// window when windowed, pos_i = q_offset + i), scale and softcap.  A
// masked pair has P = 0 here: a row that the forward masks entirely gets
// a zero gradient (never exp(s - L) of two -1e30's, and L = +inf where
// the forward visited no key).  k or q tiles wholly outside the band are
// not visited, as in the forward; since their P is 0 that changes nothing.
//
// Design.  The products run on the tensor cores with the forward's
// fragments (fa_common.cuh: float32 as split TF32, bf16 as m16n8k16 with
// P and dS rounded to bf16 for the mma, float32 accumulators).  A warp
// owns 16 rows and streams 16-row tiles through a double-buffered
// cp.async ring:
// - dq_kernel: a block per (b, q head, q tile); each warp holds 16 q rows
//   of Q and dO in shared memory and its rows' L and D in registers, and
//   walks the k tiles of the band: S = Q K^T and dP = dO V^T
//   (`Mma::scores`), dS, then dQ += dS K (`Mma::pv`).
// - dkdv_kernel: a block per (b, q head, k tile); each warp holds 16 keys
//   of K and V, and walks the q tiles of the band (Q, dO, L and D of 16
//   rows a tile): S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and
//   dK += dS^T Q.  The gradient of one kv head sums over the Hq / Hkv q
//   heads that read it; each q head's block writes its own float32 share
//   and reduce_kernel adds the shares in head order.  No atomics: every
//   sum has one fixed order, so two calls give the same bits.
// - At head_dim 256 the dK and dV accumulators (128 registers each) do
//   not fit in one thread, so dV (which needs no dP) and dK run as two
//   passes of dkdv_kernel; blocks are 4 warps there (Q and dO of 64 rows
//   or K and V of 64 keys, 135 KB, plus the ring), 8 warps below.
//
// Bound.  Each unmasked pair costs five products of length D (S and dP,
// recomputed in both kernels, then dQ, dK and dV): 10*D operations in the
// algorithm's count, 3 TF32 products each in float32.  Bytes (q, k, v, O,
// dO read once, dq, dk, dv written once) are far below that at the
// training shapes.
//
// Build: see flash_attention.cu.
#include "fa_common.cuh"

namespace {

// warps a block at head_dim D: 8, or 4 at 256 (shared memory)
template <int D>
constexpr int bwd_warps() {
    return D == 256 ? 4 : 8;
}

// Shared-memory layout of one block (elements of T): two owned tiles of
// kRows rows (Q and dO, or K and V), then the ring of two stages, each two
// streamed 16-row tiles (K and V, or Q and dO), then (dkdv only) the
// stages' L and D values.
template <typename T, int D>
struct BwdTiles {
    static constexpr int kWarps = bwd_warps<D>();
    static constexpr int kThreads = 32 * kWarps;
    static constexpr int kRows = 16 * kWarps;
    static constexpr int kLd = D + 32 / static_cast<int>(sizeof(T));
    static constexpr int kOwn = kRows * kLd;
    static constexpr int kTile = kBlockK * kLd;
    static constexpr int kStage = 2 * kTile;
    static constexpr int kBytes =
        static_cast<int>(sizeof(T)) * (2 * kOwn + 2 * kStage) +
        static_cast<int>(sizeof(float)) * 2 * 2 * kBlockK;
};

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// x = scale * s, then the softcap; returns x and sets dfac = dx/d(scale*s)
__device__ __forceinline__ float logit(float s, float scale, int has_softcap,
                                       float softcap, float& dfac) {
    float x = s * scale;
    dfac = 1.f;
    if (has_softcap) {
        const float th = tanhf(x / softcap);
        x = th * softcap;
        dfac = 1.f - th * th;
    }
    return x;
}

// ------------------------------------------------------------------ //
// D_i = sum_d dO_id O_id, one warp a row; delta is [B, Hq, Sq]
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
// dQ: a block per (q tile, q head, batch)
// ------------------------------------------------------------------ //
template <typename T, int D>
__global__ void __launch_bounds__(BwdTiles<T, D>::kThreads, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int64_t Sq, int64_t Sk, int Hq, int Hkv,
          int causal, int has_window, int64_t window, int has_softcap,
          float softcap, float scale, int64_t q_offset) {
    using L = BwdTiles<T, D>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* qs = reinterpret_cast<T*>(smem_raw);
    T* dos = qs + L::kOwn;
    T* stages = dos + L::kOwn;

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    // the last q tile first: under a causal mask it has the most keys
    const int64_t q0 =
        static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * L::kRows;
    const int h = blockIdx.y;
    const int64_t b = blockIdx.z;
    const int hk = h / (Hq / Hkv);
    const int64_t q_stride = static_cast<int64_t>(Hq) * D;
    const int64_t kv_stride = static_cast<int64_t>(Hkv) * D;
    const T* qb = q + (b * Sq * Hq + h) * D;
    const T* dob = dout + (b * Sq * Hq + h) * D;
    const T* kb = k + (b * Sk * Hkv + hk) * D;
    const T* vb = v + (b * Sk * Hkv + hk) * D;
    T* dqb = dq + (b * Sq * Hq + h) * D;
    const float* lse_b = lse + (b * Hq + h) * Sq;
    const float* delta_b = delta + (b * Hq + h) * Sq;

    // the k tiles this q tile can see (the forward's band)
    const int64_t rows = (Sq - q0 < L::kRows) ? (Sq - q0) : L::kRows;
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
    const int64_t t_begin = k_begin / kBlockK;
    const int64_t t_end = k_end > 0 ? (k_end + kBlockK - 1) / kBlockK : 0;

    load_rows<T, D, L::kRows, L::kLd, L::kThreads>(qs, qb, q_stride, q0, Sq);
    load_rows<T, D, L::kRows, L::kLd, L::kThreads>(dos, dob, q_stride, q0,
                                                   Sq);
    if (t_begin < t_end) {
        const int64_t k0 = t_begin * kBlockK;
        load_rows<T, D, kBlockK, L::kLd, L::kThreads>(stages, kb, kv_stride,
                                                      k0, Sk);
        load_rows<T, D, kBlockK, L::kLd, L::kThreads>(stages + L::kTile, vb,
                                                      kv_stride, k0, Sk);
    }
    cp_async_commit();

    // this thread's rows: 16*warp + g and + 8
    const int64_t wpos_lo = pos_lo + 16 * warp;
    const int64_t my_pos[2] = {wpos_lo + g, wpos_lo + g + 8};
    float my_lse[2], my_delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int64_t row = q0 + 16 * warp + g + 8 * r;
        my_lse[r] = row < Sq ? lse_b[row] : inf_f();
        my_delta[r] = row < Sq ? delta_b[row] : 0.f;
    }
    float acc[D / 8][4];
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            acc[c][e] = 0.f;
        }
    }
    const T* qw = qs + 16 * warp * L::kLd;
    const T* dow = dos + 16 * warp * L::kLd;

    for (int64_t kt = t_begin; kt < t_end; ++kt) {
        const int64_t k0 = kt * kBlockK;
        const T* ks = stages + ((kt - t_begin) & 1) * L::kStage;
        const T* vs = ks + L::kTile;
        cp_async_wait_all();
        __syncthreads();   // tile kt is in; every warp is done with kt-1
        if (kt + 1 < t_end) {
            T* nxt = stages + ((kt + 1 - t_begin) & 1) * L::kStage;
            load_rows<T, D, kBlockK, L::kLd, L::kThreads>(
                nxt, kb, kv_stride, k0 + kBlockK, Sk);
            load_rows<T, D, kBlockK, L::kLd, L::kThreads>(
                nxt + L::kTile, vb, kv_stride, k0 + kBlockK, Sk);
            cp_async_commit();
        }

        float s[kBlockK / 8][4], dp[kBlockK / 8][4];
        Mma<T>::template scores<D, L::kLd>(qw, ks, g, t, s);
        Mma<T>::template scores<D, L::kLd>(dow, vs, g, t, dp);

        const bool inside =
            k0 + kBlockK <= Sk &&
            (!causal || k0 + kBlockK - 1 <= wpos_lo) &&
            (!has_window || k0 > wpos_lo + 15 - window);
#pragma unroll
        for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                float dfac;
                const float x = logit(s[j][e], scale, has_softcap, softcap,
                                      dfac);
                bool ok = true;
                if (!inside) {
                    const int64_t kp = k0 + 8 * j + 2 * t + (e & 1);
                    ok = kp < Sk;
                    if (causal) {
                        ok = ok && kp <= my_pos[r];
                    }
                    if (has_window) {
                        ok = ok && kp > my_pos[r] - window;
                    }
                }
                const float p = ok ? expf(x - my_lse[r]) : 0.f;
                s[j][e] = p * (dp[j][e] - my_delta[r]) * dfac;   // dS
            }
        }
        Mma<T>::template pv<D, L::kLd>(s, ks, g, t, acc);
    }
    cp_async_wait_all();

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int64_t row = q0 + 16 * warp + g + 8 * r;
        if (row < Sq) {
            T* dst = dqb + row * q_stride + 4 * t;
#pragma unroll
            for (int c = 0; c < D / 16; ++c) {
                store4<T>(dst + 16 * c, acc[2 * c][2 * r] * scale,
                          acc[2 * c + 1][2 * r] * scale,
                          acc[2 * c][2 * r + 1] * scale,
                          acc[2 * c + 1][2 * r + 1] * scale);
            }
        }
    }
}

// ------------------------------------------------------------------ //
// dK, dV: a block per (k tile, q head, batch); each q head's share of
// the kv head's gradient, float32, into dk_h / dv_h [B, Sk, Hq, D]
// ------------------------------------------------------------------ //
template <typename T, int D, bool kDK, bool kDV>
__global__ void __launch_bounds__(BwdTiles<T, D>::kThreads, 1)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk_h, float* __restrict__ dv_h, int64_t Sq,
            int64_t Sk, int Hq, int Hkv, int causal, int has_window,
            int64_t window, int has_softcap, float softcap, float scale,
            int64_t q_offset) {
    using L = BwdTiles<T, D>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* ks = reinterpret_cast<T*>(smem_raw);
    T* vs = ks + L::kOwn;
    T* stages = vs + L::kOwn;
    float* stats = reinterpret_cast<float*>(stages + 2 * L::kStage);

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int64_t k0 = static_cast<int64_t>(blockIdx.x) * L::kRows;
    const int h = blockIdx.y;
    const int64_t b = blockIdx.z;
    const int hk = h / (Hq / Hkv);
    const int64_t q_stride = static_cast<int64_t>(Hq) * D;
    const int64_t kv_stride = static_cast<int64_t>(Hkv) * D;
    const T* qb = q + (b * Sq * Hq + h) * D;
    const T* dob = dout + (b * Sq * Hq + h) * D;
    const T* kb = k + (b * Sk * Hkv + hk) * D;
    const T* vb = v + (b * Sk * Hkv + hk) * D;
    const float* lse_b = lse + (b * Hq + h) * Sq;
    const float* delta_b = delta + (b * Hq + h) * Sq;

    // the q tiles that can see a key of this block: pos >= k0 when causal,
    // pos <= k_last + window - 1 when windowed
    const int64_t k_last = (k0 + L::kRows < Sk ? k0 + L::kRows : Sk) - 1;
    int64_t i_begin = 0;
    int64_t i_end = Sq;
    if (causal && k0 - q_offset > i_begin) {
        i_begin = k0 - q_offset;
    }
    if (has_window && k_last + window - q_offset < i_end) {
        i_end = k_last + window - q_offset;
    }
    const int64_t t_begin = i_begin / kBlockK;
    const int64_t t_end =
        i_end > i_begin ? (i_end + kBlockK - 1) / kBlockK : t_begin;

    // stage `slot` <- the q tile starting at row i0: Q, dO, L and D
    auto load_stage = [&](int64_t i0, int slot) {
        T* qt = stages + slot * L::kStage;
        load_rows<T, D, kBlockK, L::kLd, L::kThreads>(qt, qb, q_stride, i0,
                                                      Sq);
        load_rows<T, D, kBlockK, L::kLd, L::kThreads>(qt + L::kTile, dob,
                                                      q_stride, i0, Sq);
        if (threadIdx.x < 2 * kBlockK) {
            const int c = threadIdx.x % kBlockK;
            const bool live = i0 + c < Sq;
            float* st = stats + slot * 2 * kBlockK;
            if (threadIdx.x < kBlockK) {
                st[c] = live ? lse_b[i0 + c] : inf_f();
            } else {
                st[kBlockK + c] = live ? delta_b[i0 + c] : 0.f;
            }
        }
    };

    load_rows<T, D, L::kRows, L::kLd, L::kThreads>(ks, kb, kv_stride, k0, Sk);
    if constexpr (kDK) {
        load_rows<T, D, L::kRows, L::kLd, L::kThreads>(vs, vb, kv_stride, k0,
                                                       Sk);
    }
    if (t_begin < t_end) {
        load_stage(t_begin * kBlockK, 0);
    }
    cp_async_commit();

    // this thread's keys: 16*warp + g and + 8
    const int64_t wk0 = k0 + 16 * warp;
    const int64_t my_k[2] = {wk0 + g, wk0 + g + 8};
    float acc_k[kDK ? D / 8 : 1][4];
    float acc_v[kDV ? D / 8 : 1][4];
#pragma unroll
    for (int c = 0; c < (kDK ? D / 8 : 1); ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            acc_k[c][e] = 0.f;
        }
    }
#pragma unroll
    for (int c = 0; c < (kDV ? D / 8 : 1); ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            acc_v[c][e] = 0.f;
        }
    }
    const T* kw = ks + 16 * warp * L::kLd;
    const T* vw = vs + 16 * warp * L::kLd;

    for (int64_t it = t_begin; it < t_end; ++it) {
        const int64_t i0 = it * kBlockK;
        const int slot = static_cast<int>((it - t_begin) & 1);
        const T* qt = stages + slot * L::kStage;
        const T* dot = qt + L::kTile;
        const float* lse_s = stats + slot * 2 * kBlockK;
        const float* delta_s = lse_s + kBlockK;
        cp_async_wait_all();
        __syncthreads();   // tile it is in; every warp is done with it-1
        if (it + 1 < t_end) {
            load_stage(i0 + kBlockK, slot ^ 1);
            cp_async_commit();
        }

        float s[kBlockK / 8][4];        // S^T: rows keys, columns q rows
        Mma<T>::template scores<D, L::kLd>(kw, qt, g, t, s);
        float dp[kBlockK / 8][4];
        if constexpr (kDK) {
            Mma<T>::template scores<D, L::kLd>(vw, dot, g, t, dp);
        }

        const int64_t p0 = q_offset + i0;   // the tile's first position
        const bool inside =
            wk0 + 15 < Sk && i0 + kBlockK <= Sq &&
            (!causal || wk0 + 15 <= p0) &&
            (!has_window || wk0 > p0 + kBlockK - 1 - window);
        float pt[kBlockK / 8][4];
#pragma unroll
        for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = 8 * j + 2 * t + (e & 1);
                float dfac;
                const float x = logit(s[j][e], scale, has_softcap, softcap,
                                      dfac);
                bool ok = true;
                if (!inside) {
                    const int64_t kp = my_k[e >> 1];
                    const int64_t pos = p0 + col;
                    ok = kp < Sk && i0 + col < Sq;
                    if (causal) {
                        ok = ok && kp <= pos;
                    }
                    if (has_window) {
                        ok = ok && kp > pos - window;
                    }
                }
                const float p = ok ? expf(x - lse_s[col]) : 0.f;
                pt[j][e] = p;
                if constexpr (kDK) {
                    s[j][e] = p * (dp[j][e] - delta_s[col]) * dfac;  // dS^T
                }
            }
        }
        if constexpr (kDV) {
            Mma<T>::template pv<D, L::kLd>(pt, dot, g, t, acc_v);
        }
        if constexpr (kDK) {
            Mma<T>::template pv<D, L::kLd>(s, qt, g, t, acc_k);
        }
    }
    cp_async_wait_all();

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int64_t kp = my_k[r];
        if (kp < Sk) {
            const int64_t at = ((b * Sk + kp) * Hq + h) * D + 4 * t;
#pragma unroll
            for (int c = 0; c < D / 16; ++c) {
                if constexpr (kDK) {
                    *reinterpret_cast<float4*>(dk_h + at + 16 * c) =
                        make_float4(acc_k[2 * c][2 * r] * scale,
                                    acc_k[2 * c + 1][2 * r] * scale,
                                    acc_k[2 * c][2 * r + 1] * scale,
                                    acc_k[2 * c + 1][2 * r + 1] * scale);
                }
                if constexpr (kDV) {
                    *reinterpret_cast<float4*>(dv_h + at + 16 * c) =
                        make_float4(acc_v[2 * c][2 * r],
                                    acc_v[2 * c + 1][2 * r],
                                    acc_v[2 * c][2 * r + 1],
                                    acc_v[2 * c + 1][2 * r + 1]);
                }
            }
        }
    }
}

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

// dk[b, j, hk, d] = sum over the group's q heads h (in order) of
// dk_h[b, j, h, d]; the same for dv
template <typename T>
__global__ void __launch_bounds__(256)
reduce_kernel(const float* __restrict__ dk_h, const float* __restrict__ dv_h,
              T* __restrict__ dk, T* __restrict__ dv, int64_t n, int Hkv,
              int groups, int D) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
    if (i >= n) {
        return;
    }
    const int64_t d = i % D;
    const int64_t hk = (i / D) % Hkv;
    const int64_t bj = i / (static_cast<int64_t>(D) * Hkv);   // b * Sk + j
    const int64_t src = (bj * Hkv * groups + hk * groups) * D + d;
    float sk = 0.f;
    float sv = 0.f;
    for (int gi = 0; gi < groups; ++gi) {
        sk += dk_h[src + static_cast<int64_t>(gi) * D];
        sv += dv_h[src + static_cast<int64_t>(gi) * D];
    }
    dk[i] = cast_out<T>(sk);
    dv[i] = cast_out<T>(sv);
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

template <typename T, int D>
int launch(const T* q, const T* k, const T* v, const T* out, const T* dout,
           const float* lse, float* delta, float* dk_h, float* dv_h, T* dq,
           T* dk, T* dv, int64_t B, int64_t Sq, int64_t Sk, int64_t Hq,
           int64_t Hkv, int causal, int has_window, int64_t window,
           int has_softcap, float softcap, float scale, int64_t q_offset,
           cudaStream_t stream) {
    using L = BwdTiles<T, D>;
    const int64_t rows = B * Sq * Hq;
    delta_kernel<T, D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                         stream>>>(out, dout, delta, rows, Sq,
                                   static_cast<int>(Hq));
    int err = static_cast<int>(cudaGetLastError());
    if (err != 0) {
        return err;
    }
    const int hq = static_cast<int>(Hq);
    const int hkv = static_cast<int>(Hkv);
    const dim3 kgrid(static_cast<unsigned>((Sk + L::kRows - 1) / L::kRows),
                     static_cast<unsigned>(Hq), static_cast<unsigned>(B));
    if constexpr (D == 256) {       // dV, then dK: one accumulator a pass
        if ((err = set_smem(dkdv_kernel<T, D, false, true>, L::kBytes))) {
            return err;
        }
        dkdv_kernel<T, D, false, true><<<kgrid, L::kThreads, L::kBytes,
                                         stream>>>(
            q, k, v, dout, lse, delta, dk_h, dv_h, Sq, Sk, hq, hkv, causal,
            has_window, window, has_softcap, softcap, scale, q_offset);
        if ((err = static_cast<int>(cudaGetLastError()))) {
            return err;
        }
        if ((err = set_smem(dkdv_kernel<T, D, true, false>, L::kBytes))) {
            return err;
        }
        dkdv_kernel<T, D, true, false><<<kgrid, L::kThreads, L::kBytes,
                                         stream>>>(
            q, k, v, dout, lse, delta, dk_h, dv_h, Sq, Sk, hq, hkv, causal,
            has_window, window, has_softcap, softcap, scale, q_offset);
    } else {
        if ((err = set_smem(dkdv_kernel<T, D, true, true>, L::kBytes))) {
            return err;
        }
        dkdv_kernel<T, D, true, true><<<kgrid, L::kThreads, L::kBytes,
                                        stream>>>(
            q, k, v, dout, lse, delta, dk_h, dv_h, Sq, Sk, hq, hkv, causal,
            has_window, window, has_softcap, softcap, scale, q_offset);
    }
    if ((err = static_cast<int>(cudaGetLastError()))) {
        return err;
    }
    const int64_t n = B * Sk * Hkv * D;
    reduce_kernel<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                       stream>>>(dk_h, dv_h, dk, dv, n, hkv, hq / hkv, D);
    if ((err = static_cast<int>(cudaGetLastError()))) {
        return err;
    }
    if ((err = set_smem(dq_kernel<T, D>, L::kBytes))) {
        return err;
    }
    const dim3 qgrid(static_cast<unsigned>((Sq + L::kRows - 1) / L::kRows),
                     static_cast<unsigned>(Hq), static_cast<unsigned>(B));
    dq_kernel<T, D><<<qgrid, L::kThreads, L::kBytes, stream>>>(
        q, k, v, dout, lse, delta, dq, Sq, Sk, hq, hkv, causal, has_window,
        window, has_softcap, softcap, scale, q_offset);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, const T* out,
             const T* dout, const float* lse, float* delta, float* dk_h,
             float* dv_h, T* dq, T* dk, T* dv, int64_t B, int64_t Sq,
             int64_t Sk, int64_t Hq, int64_t Hkv, int64_t D, int causal,
             int has_window, int64_t window, int has_softcap, float softcap,
             float scale, int64_t q_offset, void* stream) {
    if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
        Hq > 65535 || B > 65535) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FA_BWD_CASE(DIM)                                              \
    case DIM:                                                               \
        return launch<T, DIM>(q, k, v, out, dout, lse, delta, dk_h, dv_h,   \
                              dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal,       \
                              has_window, window, has_softcap, softcap,     \
                              scale, q_offset, s);
    switch (D) {
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
// gradient of out; delta [B, Hq, Sq] and dk_h, dv_h [B, Sk, Hq, D] are
// float32 scratch; dq, dk, dv have the shapes of q, k, v.  Every tensor
// is contiguous and 16-byte aligned.
int flash_attention_bwd_f32(const float* q, const float* k, const float* v,
                            const float* out, const float* dout,
                            const float* lse, float* delta, float* dk_h,
                            float* dv_h, float* dq, float* dk, float* dv,
                            int64_t B, int64_t Sq, int64_t Sk, int64_t Hq,
                            int64_t Hkv, int64_t D, int causal,
                            int has_window, int64_t window, int has_softcap,
                            float softcap, float scale, int64_t q_offset,
                            void* stream) {
    return dispatch<float>(q, k, v, out, dout, lse, delta, dk_h, dv_h, dq, dk,
                           dv, B, Sq, Sk, Hq, Hkv, D, causal, has_window,
                           window, has_softcap, softcap, scale, q_offset,
                           stream);
}

int flash_attention_bwd_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* out, const __nv_bfloat16* dout, const float* lse,
    float* delta, float* dk_h, float* dv_h, __nv_bfloat16* dq,
    __nv_bfloat16* dk, __nv_bfloat16* dv, int64_t B, int64_t Sq, int64_t Sk,
    int64_t Hq, int64_t Hkv, int64_t D, int causal, int has_window,
    int64_t window, int has_softcap, float softcap, float scale,
    int64_t q_offset, void* stream) {
    return dispatch<__nv_bfloat16>(q, k, v, out, dout, lse, delta, dk_h,
                                   dv_h, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D,
                                   causal, has_window, window, has_softcap,
                                   softcap, scale, q_offset, stream);
}

}  // extern "C"
