// Flash attention (forward) for Hopper (sm_90a), bound through a plain C
// interface.
//
// Replaces the TPU kernel `_fa_kernel` of the JAX package
// (src/repro/kernels/flash_attention.py:29, launched at :120).
//
// What it computes: for q [B, Sq, Hq, D] and k, v [B, Sk, Hkv, D] (the JAX
// package's layout, read in place with row strides Hq*D and Hkv*D; nothing
// is repeated or transposed in device memory),
// out[b, i, h] = softmax_j(s_ij) . v[b, j, h']
// with h' = h / (Hq / Hkv) (GQA), s_ij = (q_i * scale) . k_j, then the
// optional tanh softcap s = tanh(s / cap) * cap, then the mask: j < Sk,
// j <= pos_i when causal, j > pos_i - window when windowed, where
// pos_i = q_offset + i.  A masked score is -1e30, not -inf, as in the TPU
// kernel; the softmax is the online one (running max m, running sum l and
// the accumulator, all float32), and a row whose sum is 0 divides by 1.
// float32 or bfloat16 in, float32 inside, out in the input's type.
//
// Design.  The TPU grid walks (batch, head, q block, k block) with the k
// axis sequential and the softmax state in VMEM scratch.  Here one block
// of 256 threads owns one (batch, head, 64-row q tile) and loops over the
// k tiles (32 keys each) itself.  The q tile (pre-scaled) and one k and v
// tile live in shared memory as float32, rows padded by 4 floats so that
// the float4 reads of 8 neighbouring threads fall in distinct banks.  At
// head_dim 256 that is 142 KB, above the 48 KB static limit, so it is
// dynamic shared memory, raised per instantiation with
// cudaFuncSetAttribute.  Thread (ty, tx) of the 16 x 16 layout owns rows
// 4*ty .. 4*ty+3 of the tile: their scores against keys tx and tx + 16,
// their softmax state (replicated across the 16 threads of a half warp,
// which reduce row max and row sum with shuffles), and D/16 columns of
// their output accumulator in registers.  Products use fmaf explicitly, so
// the library's --fmad=false does not split them.  k tiles wholly outside
// the causal / window band of the q tile are not visited: the TPU kernel
// visits them, and its rescale alpha = exp(m_prev - m_new) wipes what they
// added (or they add exactly 0), so the result is the same.  Rows of the
// k and v tiles past Sk are loaded as zeros (0 * garbage would be NaN).
//
// Bound.  At the serving shape (head_dim 256, window 2048, one kv head)
// the kernel is bound by operations: every unmasked (query, key) pair
// costs 4*D float32 multiply-adds on the CUDA cores (the TPU's MXU work;
// this simple kernel uses no tensor cores), about 1.4e11 operations a
// layer at B=2, S=3072, against 67 TFLOP/s; it reads q once and k, v once
// per q tile (from L2: one kv head serves all 16 heads).  The inner loops
// are shared-memory-bandwidth limited at about half the FMA rate.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -Xcompiler -fPIC -c, then linked -shared (see
//        core/cuda/_build.py).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;      // q rows per block
constexpr int kBlockK = 32;      // keys per k tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kPad = 4;          // floats of padding per tile row
constexpr int kLdP = kBlockK + 4;  // row stride of the probability tile
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

template <typename T>
struct Io;

template <>
struct Io<float> {
    __device__ __forceinline__ static float4 load4(const float* p) {
        return *reinterpret_cast<const float4*>(p);
    }
    __device__ __forceinline__ static void store(float* p, float v) { *p = v; }
};

template <>
struct Io<__nv_bfloat16> {
    __device__ __forceinline__ static float4 load4(const __nv_bfloat16* p) {
        const uint2 raw = *reinterpret_cast<const uint2*>(p);
        const float2 lo =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 hi =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        return make_float4(lo.x, lo.y, hi.x, hi.y);
    }
    __device__ __forceinline__ static void store(__nv_bfloat16* p, float v) {
        *p = __float2bfloat16(v);  // round to nearest even, as astype does
    }
};

// Column of the c-th of the D/16 output columns that thread tx owns.  With
// D a multiple of 64 they come in float4 groups: 64*g + 4*tx + e.
template <int D>
__device__ __forceinline__ int out_col(int tx, int c) {
    if constexpr (D % 64 == 0) {
        return (c / 4) * 64 + tx * 4 + (c % 4);
    } else {
        return tx + 16 * c;
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int64_t Sq,
          int64_t Sk, int Hq, int Hkv, int causal, int has_window,
          int64_t window, int has_softcap, float softcap, float scale,
          int64_t q_offset) {
    constexpr int kLd = D + kPad;
    constexpr int kCols = D / 16;
    constexpr int kVecs = D / 4;  // float4 per row
    extern __shared__ float4 smem4[];
    float* qs = reinterpret_cast<float*>(smem4);  // [kBlockQ][kLd]
    float* ks = qs + kBlockQ * kLd;               // [kBlockK][kLd]
    float* vs = ks + kBlockK * kLd;               // [kBlockK][kLd]
    float* ps = vs + kBlockK * kLd;               // [kBlockQ][kLdP]

    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;
    const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kBlockQ;
    const int h = blockIdx.y;
    const int64_t b = blockIdx.z;
    const int hk = h / (Hq / Hkv);
    const int64_t q_stride = static_cast<int64_t>(Hq) * D;   // per position
    const int64_t kv_stride = static_cast<int64_t>(Hkv) * D;
    const T* qb = q + (b * Sq * Hq + h) * D;
    const T* kb = k + (b * Sk * Hkv + hk) * D;
    const T* vb = v + (b * Sk * Hkv + hk) * D;
    T* ob = out + (b * Sq * Hq + h) * D;

    // the q tile, as q * scale in float32 (rows past Sq are zeros)
    for (int i = threadIdx.x; i < kBlockQ * kVecs; i += kThreads) {
        const int r = i / kVecs;
        const int c = (i % kVecs) * 4;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q0 + r < Sq) {
            val = Io<T>::load4(qb + (q0 + r) * q_stride + c);
            val.x *= scale;
            val.y *= scale;
            val.z *= scale;
            val.w *= scale;
        }
        *reinterpret_cast<float4*>(qs + r * kLd + c) = val;
    }

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

    float m[4], l[4], acc[4][kCols];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = kNegInf;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
            acc[i][c] = 0.f;
        }
    }

    for (int64_t t = t_begin; t < t_end; ++t) {
        const int64_t k0 = t * kBlockK;
        __syncthreads();  // the previous tile's k, v and p are consumed
        for (int i = threadIdx.x; i < kBlockK * kVecs; i += kThreads) {
            const int r = i / kVecs;
            const int c = (i % kVecs) * 4;
            float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
            float4 vv = kv;
            if (k0 + r < Sk) {
                kv = Io<T>::load4(kb + (k0 + r) * kv_stride + c);
                vv = Io<T>::load4(vb + (k0 + r) * kv_stride + c);
            }
            *reinterpret_cast<float4*>(ks + r * kLd + c) = kv;
            *reinterpret_cast<float4*>(vs + r * kLd + c) = vv;
        }
        __syncthreads();

        // scores of rows 4*ty+i against keys tx and tx+16
        float s[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            s[i][0] = 0.f;
            s[i][1] = 0.f;
        }
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
            const float4 k0v = *reinterpret_cast<const float4*>(ks + tx * kLd + d);
            const float4 k1v =
                *reinterpret_cast<const float4*>(ks + (tx + 16) * kLd + d);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float4 qv =
                    *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * kLd + d);
                s[i][0] = fmaf(qv.x, k0v.x, s[i][0]);
                s[i][0] = fmaf(qv.y, k0v.y, s[i][0]);
                s[i][0] = fmaf(qv.z, k0v.z, s[i][0]);
                s[i][0] = fmaf(qv.w, k0v.w, s[i][0]);
                s[i][1] = fmaf(qv.x, k1v.x, s[i][1]);
                s[i][1] = fmaf(qv.y, k1v.y, s[i][1]);
                s[i][1] = fmaf(qv.z, k1v.z, s[i][1]);
                s[i][1] = fmaf(qv.w, k1v.w, s[i][1]);
            }
        }

        // softcap, mask, and the online softmax update of each row
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int64_t pos = pos_lo + ty * 4 + i;
            float mx = kNegInf;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int64_t kp = k0 + tx + 16 * j;
                float val = s[i][j];
                if (has_softcap) {
                    val = tanhf(val / softcap) * softcap;
                }
                bool ok = kp < Sk;
                if (causal) {
                    ok = ok && kp <= pos;
                }
                if (has_window) {
                    ok = ok && kp > pos - window;
                }
                s[i][j] = ok ? val : kNegInf;
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1) {
                mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
            }
            const float m_new = fmaxf(m[i], mx);
            const float p0 = expf(s[i][0] - m_new);
            const float p1 = expf(s[i][1] - m_new);
            float sum = p0 + p1;
#pragma unroll
            for (int off = 8; off > 0; off >>= 1) {
                sum += __shfl_xor_sync(kFullMask, sum, off);
            }
            const float alpha = expf(m[i] - m_new);
            l[i] = alpha * l[i] + sum;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
                acc[i][c] *= alpha;
            }
            ps[(ty * 4 + i) * kLdP + tx] = p0;
            ps[(ty * 4 + i) * kLdP + tx + 16] = p1;
        }
        __syncthreads();

        // acc += p . v over the tile's keys, four keys at a time
#pragma unroll 2
        for (int kk = 0; kk < kBlockK; kk += 4) {
            float p[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float4 pv =
                    *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * kLdP + kk);
                p[i][0] = pv.x;
                p[i][1] = pv.y;
                p[i][2] = pv.z;
                p[i][3] = pv.w;
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float* vrow = vs + (kk + e) * kLd;
                if constexpr (D % 64 == 0) {
#pragma unroll
                    for (int g = 0; g < kCols / 4; ++g) {
                        const float4 vv =
                            *reinterpret_cast<const float4*>(vrow + g * 64 + tx * 4);
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            acc[i][4 * g + 0] = fmaf(p[i][e], vv.x, acc[i][4 * g + 0]);
                            acc[i][4 * g + 1] = fmaf(p[i][e], vv.y, acc[i][4 * g + 1]);
                            acc[i][4 * g + 2] = fmaf(p[i][e], vv.z, acc[i][4 * g + 2]);
                            acc[i][4 * g + 3] = fmaf(p[i][e], vv.w, acc[i][4 * g + 3]);
                        }
                    }
                } else {
#pragma unroll
                    for (int c = 0; c < kCols; ++c) {
                        const float vv = vrow[out_col<D>(tx, c)];
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            acc[i][c] = fmaf(p[i][e], vv, acc[i][c]);
                        }
                    }
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int64_t r = q0 + ty * 4 + i;
        if (r < Sq) {
            const float denom = (l[i] == 0.f) ? 1.f : l[i];
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
                Io<T>::store(ob + r * q_stride + out_col<D>(tx, c),
                             acc[i][c] / denom);
            }
        }
    }
}

template <typename T, int D>
int launch(const T* q, const T* k, const T* v, T* out, int64_t B, int64_t Sq,
           int64_t Sk, int64_t Hq, int64_t Hkv, int causal, int has_window,
           int64_t window, int has_softcap, float softcap, float scale,
           int64_t q_offset, void* stream) {
    constexpr int kLd = D + kPad;
    const int smem = static_cast<int>(
        sizeof(float) * (kBlockQ * kLd + 2 * kBlockK * kLd + kBlockQ * kLdP));
    cudaError_t err = cudaFuncSetAttribute(
        fa_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    const dim3 grid(static_cast<unsigned>((Sq + kBlockQ - 1) / kBlockQ),
                    static_cast<unsigned>(Hq), static_cast<unsigned>(B));
    fa_kernel<T, D><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        q, k, v, out, Sq, Sk, static_cast<int>(Hq), static_cast<int>(Hkv),
        causal, has_window, window, has_softcap, softcap, scale, q_offset);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* out, int64_t B,
             int64_t Sq, int64_t Sk, int64_t Hq, int64_t Hkv, int64_t D,
             int causal, int has_window, int64_t window, int has_softcap,
             float softcap, float scale, int64_t q_offset, void* stream) {
    if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
        Hq > 65535 || B > 65535) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
#define REPRO_FA_CASE(DIM)                                                    \
    case DIM:                                                                 \
        return launch<T, DIM>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal,      \
                              has_window, window, has_softcap, softcap,      \
                              scale, q_offset, stream);
    switch (D) {
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
// error code: 0 when the launch was accepted.  head_dim must be 16, 32,
// 64, 128 or 256.
int flash_attention_f32(const float* q, const float* k, const float* v,
                        float* out, int64_t B, int64_t Sq, int64_t Sk,
                        int64_t Hq, int64_t Hkv, int64_t D, int causal,
                        int has_window, int64_t window, int has_softcap,
                        float softcap, float scale, int64_t q_offset,
                        void* stream) {
    return dispatch<float>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, causal,
                           has_window, window, has_softcap, softcap, scale,
                           q_offset, stream);
}

int flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, __nv_bfloat16* out,
                         int64_t B, int64_t Sq, int64_t Sk, int64_t Hq,
                         int64_t Hkv, int64_t D, int causal, int has_window,
                         int64_t window, int has_softcap, float softcap,
                         float scale, int64_t q_offset, void* stream) {
    return dispatch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D,
                                   causal, has_window, window, has_softcap,
                                   softcap, scale, q_offset, stream);
}

}  // extern "C"
