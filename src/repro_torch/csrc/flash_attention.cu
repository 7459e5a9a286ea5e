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
// k tiles wholly outside the causal / window band of a q tile are not
// visited: the TPU kernel visits them, and its rescale
// alpha = exp(m_prev - m_new) wipes what they added (or they add exactly
// 0), so the result is the same.  Rows of the k and v tiles past Sk are
// zeros (0 * garbage would be NaN).  float32 or bfloat16 in, float32
// inside, out in the input's type.
//
// Bound.  Every unmasked (query, key) pair costs 2*(Dqk + Dv) operations
// (4*D when the two are equal: a product of length Dqk and one of length
// Dv).  On the tensor cores that is, at the serving
// shape (B=2, S=3072, 16 heads, 1 kv head, head_dim 256, window 2048),
// 1.4e11 operations; float32 needs three TF32 products for each (below),
// so 4.1e11 over 495 TFLOP/s = 0.83 ms.  On the CUDA cores (the previous
// design) the same work is 2.05 ms at 67 TFLOP/s.
//
// Previous design (CUDA cores): 256 threads per (batch, head, 64-row q
// tile), float32 FMAs on the CUDA cores limited by shared-memory
// bandwidth, synchronous K/V loads and three __syncthreads per 32-key
// tile, 142 KB of shared memory at head_dim 256: 6.85 ms at the serving
// shape (H100 80GB HBM3, 700 W; PERF.md).
//
// This design:
// - Tensor cores through mma.sync.  A warp owns 16 q rows; S = Q K^T and
//   O += P V are m16n8 tiles.  bfloat16: m16n8k16 with float32
//   accumulators.  float32: split TF32 ("3xTF32"): each operand x is
//   split into hi = cvt.rna.tf32(x) (two integer operations) and lo =
//   x - hi, which the tensor core reads rounded toward zero, and a
//   product is hi*hi + hi*lo + lo*hi (m16n8k8), which keeps errors near
//   float32's (plain TF32 misses the 2e-5 tolerance at head_dim 256;
//   tests/test_torch_kernels.py emulates both) at a third of the TF32
//   rate.  The splits, not the mma, are most of the instructions: every
//   warp splits every K and V element it reads.  S's hi*hi terms and
//   its two small terms go to separate accumulators, so the three
//   products of a tile do not wait on each other.
// - Fragments without shuffles.  The order of the contraction index
//   inside one mma is free, so it is permuted to suit the loads: for
//   S = Q K^T, float32 k index t <-> d 2t and t+4 <-> 2t+1 (bf16:
//   (2t, 2t+1) <-> (4t, 4t+1) and (2t+8, 2t+9) <-> (4t+2, 4t+3)), so the
//   Q and K fragments are single 8-byte shared loads; for O += P V,
//   float32 k index t <-> key 2t and t+4 <-> key 2t+1, so S's accumulator
//   fragment is P's operand fragment as it stands (bf16: the standard
//   pairing).  The output columns of two neighbouring n tiles interleave
//   (tile 2c column g <-> d 16c+2g, tile 2c+1 <-> 16c+2g+1), so one
//   8-byte (4-byte in bf16) load of a V row serves both, and each thread
//   ends up owning 4 consecutive output columns: one 16-byte store.
// - Shared-memory rows are padded so that every fragment load of a warp
//   touches 32 distinct banks: Q and K rows by 32 bytes (a word stride
//   of 8 mod 32), V rows by 16 bytes (4 mod 32).
// - Asynchronous copies.  The block's Q tile and K/V tiles come in with
//   cp.async (16 bytes per copy, zero-filled past Sq or Sk); K/V tiles are
//   double-buffered: after the one __syncthreads of a tile, tile t+1 is
//   requested into the other buffer and tile t is computed while it
//   loads.
// - Masks only where needed: a k tile inside the band for all of a warp's
//   rows skips the per-score position tests.
// - q tiles are walked last to first, so the causal tiles with the most
//   keys start first and the short ones fill the tail.
// - Warp layout, decided at head_dim 256 in float32 (the pinch) by
//   tools/fa_sweep.py (PERF.md has its table): 8 warps of 16 rows (a
//   128-row q tile) and 16-key tiles.  The 16 x 256 accumulator is 128 of
//   a thread's 237 registers; Q (132 KB) and two K/V buffers (66 KB) take
//   198 KB of shared memory, so one block of 8 warps per SM: two warps
//   per scheduler hide more of the mma and load latency than 4 warps
//   with 32-key tiles (one per scheduler), which in turn beat 2 warps.
//   The loop over head_dim that forms S is unrolled 8 times: faster than
//   2 or 4 in the same sweep, level with 32 at fewer registers.
// - Two head dims.  Everything the block reads of q and k (their tiles,
//   row pitch and strides, the loop that forms S) is sized by Dqk, and
//   everything of v and the output (the V tile, the accumulator, the
//   store) by Dv.  The instantiations are (D, D) for D in 16, 32, 64,
//   128 and 256, and (192, 128), MLA's (DeepSeek-V3: a 128-wide latent
//   part and a 64-wide rotary part in q and k, 128 in v).  At (192, 128)
//   a block takes 144,896 bytes of shared memory in float32 (Q 102,400,
//   two K/V stages of 12,800 + 8,448) and 75,264 in bfloat16, so one
//   block of 8 warps an SM, as at 256; the accumulator is 64 registers.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -Xcompiler -fPIC -c, then linked -shared (see
//        core/cuda/_build.py).
#include "fa_common.cuh"

namespace {

constexpr int kWarps = 8;               // warps per block, 16 q rows each
constexpr int kBlockQ = 16 * kWarps;    // q rows per block
constexpr int kThreads = 32 * kWarps;

// Shared-memory layout of one block (elements of T).
template <typename T, int Dqk, int Dv>
struct Tiles {
    static constexpr int kLdQK = Dqk + 32 / static_cast<int>(sizeof(T));
    static constexpr int kLdV = Dv + 16 / static_cast<int>(sizeof(T));
    static constexpr int kQ = kBlockQ * kLdQK;
    static constexpr int kK = kBlockK * kLdQK;
    static constexpr int kStage = kK + kBlockK * kLdV;   // one K and one V
    static constexpr int kBytes =
        static_cast<int>(sizeof(T)) * (kQ + 2 * kStage);
};


template <typename T, int Dqk, int Dv>
__global__ void __launch_bounds__(kThreads, 1)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out,
          float* __restrict__ lse, int64_t Sq,
          int64_t Sk, int Hq, int Hkv, int causal, int has_window,
          int64_t window, int has_softcap, float softcap, float scale,
          int64_t q_offset) {
    using L = Tiles<T, Dqk, Dv>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* qs = reinterpret_cast<T*>(smem_raw);
    T* stages = qs + L::kQ;

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    // the last q tile first: under a causal mask it has the most keys
    const int64_t q0 =
        static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kBlockQ;
    const int h = blockIdx.y;
    const int64_t b = blockIdx.z;
    const int hk = h / (Hq / Hkv);
    // per position: q and k rows are Dqk wide, v and out rows Dv
    const int64_t q_stride = static_cast<int64_t>(Hq) * Dqk;
    const int64_t k_stride = static_cast<int64_t>(Hkv) * Dqk;
    const int64_t v_stride = static_cast<int64_t>(Hkv) * Dv;
    const int64_t o_stride = static_cast<int64_t>(Hq) * Dv;
    const T* qb = q + (b * Sq * Hq + h) * Dqk;
    const T* kb = k + (b * Sk * Hkv + hk) * Dqk;
    const T* vb = v + (b * Sk * Hkv + hk) * Dv;
    T* ob = out + (b * Sq * Hq + h) * Dv;

    // the k tiles this q tile can see
    const int64_t rows = (Sq - q0 < kBlockQ) ? (Sq - q0) : kBlockQ;
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

    load_rows<T, Dqk, kBlockQ, L::kLdQK, kThreads>(qs, qb, q_stride, q0,
                                                   Sq);
    if (t_begin < t_end) {
        const int64_t k0 = t_begin * kBlockK;
        load_rows<T, Dqk, kBlockK, L::kLdQK, kThreads>(stages, kb, k_stride,
                                                       k0, Sk);
        load_rows<T, Dv, kBlockK, L::kLdV, kThreads>(stages + L::kK, vb,
                                                     v_stride, k0, Sk);
    }
    cp_async_commit();

    // this thread's rows of the tile: r_lo = 16*warp + g and r_lo + 8
    const int64_t wpos_lo = pos_lo + 16 * warp;   // the warp's first row
    const int64_t my_pos[2] = {wpos_lo + g, wpos_lo + g + 8};
    float o[Dv / 8][4];
#pragma unroll
    for (int c = 0; c < Dv / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            o[c][e] = 0.f;
        }
    }
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};
    const T* qw = qs + 16 * warp * L::kLdQK;

    for (int64_t kt = t_begin; kt < t_end; ++kt) {
        const int64_t k0 = kt * kBlockK;
        T* ks = stages + ((kt - t_begin) & 1) * L::kStage;
        const T* vs = ks + L::kK;
        cp_async_wait_all();
        __syncthreads();   // tile kt is in; every warp is done with kt-1
        if (kt + 1 < t_end) {   // tile kt+1 loads while kt is computed
            T* nxt = stages + ((kt + 1 - t_begin) & 1) * L::kStage;
            load_rows<T, Dqk, kBlockK, L::kLdQK, kThreads>(
                nxt, kb, k_stride, k0 + kBlockK, Sk);
            load_rows<T, Dv, kBlockK, L::kLdV, kThreads>(
                nxt + L::kK, vb, v_stride, k0 + kBlockK, Sk);
            cp_async_commit();
        }

        float s[kBlockK / 8][4];
        Mma<T>::template scores<Dqk, L::kLdQK>(qw, ks, g, t, s);

        // scale, softcap and mask; a tile inside the band for every row
        // of the warp needs no position tests
        const bool inside =
            k0 + kBlockK <= Sk &&
            (!causal || k0 + kBlockK - 1 <= wpos_lo) &&
            (!has_window || k0 > wpos_lo + 15 - window);
#pragma unroll
        for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float val = s[j][e] * scale;
                if (has_softcap) {
                    val = tanhf(val / softcap) * softcap;
                }
                if (!inside) {
                    const int64_t kp = k0 + 8 * j + 2 * t + (e & 1);
                    const int64_t pos = my_pos[e >> 1];
                    bool ok = kp < Sk;
                    if (causal) {
                        ok = ok && kp <= pos;
                    }
                    if (has_window) {
                        ok = ok && kp > pos - window;
                    }
                    val = ok ? val : kNegInf;
                }
                s[j][e] = val;
            }
        }

        // the online softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3),
        // each spread over the 4 threads of a quad
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float mx = kNegInf;
#pragma unroll
            for (int j = 0; j < kBlockK / 8; ++j) {
                mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
            }
            mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
            const float m_new = fmaxf(m[r], mx);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < kBlockK / 8; ++j) {
                s[j][2 * r] = expf(s[j][2 * r] - m_new);
                s[j][2 * r + 1] = expf(s[j][2 * r + 1] - m_new);
                sum += s[j][2 * r] + s[j][2 * r + 1];
            }
            sum += __shfl_xor_sync(kFullMask, sum, 1);
            sum += __shfl_xor_sync(kFullMask, sum, 2);
            const float alpha = expf(m[r] - m_new);
            l[r] = alpha * l[r] + sum;
            m[r] = m_new;
#pragma unroll
            for (int c = 0; c < Dv / 8; ++c) {
                o[c][2 * r] *= alpha;
                o[c][2 * r + 1] *= alpha;
            }
        }

        Mma<T>::template pv<Dv, L::kLdV>(s, vs, g, t, o);
    }
    cp_async_wait_all();   // no copy outlives the block (no k tile: Q's)

    // thread (g, t) owns columns 16c + 4t .. 16c + 4t + 3 of rows g, g+8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int64_t row = q0 + 16 * warp + g + 8 * r;
        if (row < Sq && lse != nullptr && t == 0) {
            // log of the row's softmax denominator, for the backward; +inf
            // where no key was visited (the row's P is 0 there)
            lse[(b * Hq + h) * Sq + row] =
                l[r] == 0.f ? __int_as_float(0x7f800000) : m[r] + logf(l[r]);
        }
        if (row < Sq) {
            const float denom = (l[r] == 0.f) ? 1.f : l[r];
            T* dst = ob + row * o_stride + 4 * t;
#pragma unroll
            for (int c = 0; c < Dv / 16; ++c) {
                store4<T>(dst + 16 * c, o[2 * c][2 * r] / denom,
                          o[2 * c + 1][2 * r] / denom,
                          o[2 * c][2 * r + 1] / denom,
                          o[2 * c + 1][2 * r + 1] / denom);
            }
        }
    }
}

template <typename T, int Dqk, int Dv>
int launch(const T* q, const T* k, const T* v, T* out, float* lse, int64_t B,
           int64_t Sq, int64_t Sk, int64_t Hq, int64_t Hkv, int causal,
           int has_window,
           int64_t window, int has_softcap, float softcap, float scale,
           int64_t q_offset, void* stream) {
    const int smem = Tiles<T, Dqk, Dv>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(
        fa_kernel<T, Dqk, Dv>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) {   // returned here, so cleared for later calls
        cudaGetLastError();
        return static_cast<int>(err);
    }
    const dim3 grid(static_cast<unsigned>((Sq + kBlockQ - 1) / kBlockQ),
                    static_cast<unsigned>(Hq), static_cast<unsigned>(B));
    fa_kernel<T, Dqk, Dv><<<grid, kThreads, smem,
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
