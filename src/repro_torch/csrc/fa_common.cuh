// Shared pieces of the flash-attention kernels (flash_attention.cu, the
// forward, and flash_attention_bwd.cu, the backward): cp.async and mma.sync
// wrappers, the split-TF32 operands, 2^x on the MUFU, and for the
// forward's kept mma.sync body (float32 at head dim 256) the m16n8
// fragment products of a warp's 16 rows against a 16-row tile
// (`Mma<T>::scores`, a product over head_dim, and `Mma<T>::pv`, a product
// over the tile's 16 rows) and its tile loads.  The design notes are in
// flash_attention.cu.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockK = 16;             // rows of a streamed tile
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;
static_assert(kBlockK % 16 == 0, "bf16 P.V takes 16 keys per mma");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
}



// ------------------------------------------------------------------ //
// PTX wrappers
// ------------------------------------------------------------------ //
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(smem));
    const int n = valid ? 16 : 0;   // 0: fill the 16 bytes with zeros
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// returns once at most N of this thread's cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// cvt.rna.tf32.f32 for finite x that do not round past the float32 range:
// the magnitude rounded to 10 mantissa bits, ties away from zero.  Two
// integer operations, where the PTX instruction compiles to a sequence
// that also handles infinities and NaN (which no operand here is).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo: hi a TF32 value, x - hi exact in float32.  lo is passed
// with all its bits; the tensor core reads a TF32 operand's top 19 bits,
// so it takes lo rounded toward zero (CUTLASS's "fast" 3xTF32 does the
// same).  That drops 2 of 5 instructions a split against rounding lo to
// nearest, and moves the product's error from about 2^-22 to 2^-21 of
// |x| (tests/test_torch_kernels.py emulates both).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32_rna(x);
    lo = __float_as_uint(x - __uint_as_float(hi));
}

// 2^x to about 2 ulp (the MUFU's own), denormal results flushed to zero:
// enough for P, which is rounded to bf16
__device__ __forceinline__ float ex2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------------------------ //
// Fragment layouts of m16n8kK (lane = 4*g + t): A rows g and g+8, B
// column g, C (row g: c0, c1; row g+8: c2, c3) columns 2t and 2t+1.
// ------------------------------------------------------------------ //
template <typename T>
struct Mma;

template <>
struct Mma<float> {
    // s[j] = Q K^T for keys 8j..8j+7: qw is the warp's 16 rows, ks the k
    // tile; contraction index t <-> d 2t, t+4 <-> d 2t+1
    template <int D, int Ld>
    __device__ __forceinline__ static void scores(const float* qw,
                                                  const float* ks, int g,
                                                  int t,
                                                  float s[kBlockK / 8][4]) {
        float small[kBlockK / 8][4];
#pragma unroll
        for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s[j][e] = 0.f;
                small[j][e] = 0.f;
            }
        }
#pragma unroll 8
        for (int d0 = 0; d0 < D; d0 += 8) {
            const float2 q0 =
                *reinterpret_cast<const float2*>(qw + g * Ld + d0 + 2 * t);
            const float2 q1 = *reinterpret_cast<const float2*>(
                qw + (g + 8) * Ld + d0 + 2 * t);
            uint32_t ah[4], al[4];
            split(q0.x, ah[0], al[0]);
            split(q1.x, ah[1], al[1]);
            split(q0.y, ah[2], al[2]);
            split(q1.y, ah[3], al[3]);
#pragma unroll
            for (int j = 0; j < kBlockK / 8; ++j) {
                const float2 kv = *reinterpret_cast<const float2*>(
                    ks + (8 * j + g) * Ld + d0 + 2 * t);
                uint32_t bh[2], bl[2];
                split(kv.x, bh[0], bl[0]);
                split(kv.y, bh[1], bl[1]);
                mma_tf32(s[j], ah, bh);
                mma_tf32(small[j], ah, bl);
                mma_tf32(small[j], al, bh);
            }
        }
#pragma unroll
        for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s[j][e] += small[j][e];
            }
        }
    }

    // o += P V: p[j] holds S's fragment of keys 8j..8j+7 (k index
    // t <-> key 2t, t+4 <-> key 2t+1); o[2c], o[2c+1] are the interleaved
    // column tiles of d 16c..16c+15
    template <int D, int Ld>
    __device__ __forceinline__ static void pv(const float p[kBlockK / 8][4],
                                              const float* vs, int g, int t,
                                              float o[D / 8][4]) {
#pragma unroll
        for (int j = 0; j < kBlockK / 8; ++j) {
            uint32_t ah[4], al[4];
            split(p[j][0], ah[0], al[0]);
            split(p[j][2], ah[1], al[1]);
            split(p[j][1], ah[2], al[2]);
            split(p[j][3], ah[3], al[3]);
            const float* v0 = vs + (8 * j + 2 * t) * Ld + 2 * g;
#pragma unroll
            for (int c = 0; c < D / 16; ++c) {
                const float2 x0 =
                    *reinterpret_cast<const float2*>(v0 + 16 * c);
                const float2 x1 =
                    *reinterpret_cast<const float2*>(v0 + Ld + 16 * c);
                uint32_t bh[2], bl[2];
                split(x0.x, bh[0], bl[0]);
                split(x1.x, bh[1], bl[1]);
                mma_tf32(o[2 * c], al, bh);
                mma_tf32(o[2 * c], ah, bl);
                mma_tf32(o[2 * c], ah, bh);
                split(x0.y, bh[0], bl[0]);
                split(x1.y, bh[1], bl[1]);
                mma_tf32(o[2 * c + 1], al, bh);
                mma_tf32(o[2 * c + 1], ah, bl);
                mma_tf32(o[2 * c + 1], ah, bh);
            }
        }
    }
};

template <>
struct Mma<__nv_bfloat16> {
    // contraction index (2t, 2t+1) <-> d (4t, 4t+1), (2t+8, 2t+9) <->
    // (4t+2, 4t+3) within each 16
    template <int D, int Ld>
    __device__ __forceinline__ static void scores(const __nv_bfloat16* qw,
                                                  const __nv_bfloat16* ks,
                                                  int g, int t,
                                                  float s[kBlockK / 8][4]) {
#pragma unroll
        for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s[j][e] = 0.f;
            }
        }
#pragma unroll 4
        for (int d0 = 0; d0 < D; d0 += 16) {
            const uint2 q0 =
                *reinterpret_cast<const uint2*>(qw + g * Ld + d0 + 4 * t);
            const uint2 q1 = *reinterpret_cast<const uint2*>(
                qw + (g + 8) * Ld + d0 + 4 * t);
            const uint32_t a[4] = {q0.x, q1.x, q0.y, q1.y};
#pragma unroll
            for (int j = 0; j < kBlockK / 8; ++j) {
                const uint2 kv = *reinterpret_cast<const uint2*>(
                    ks + (8 * j + g) * Ld + d0 + 4 * t);
                const uint32_t b[2] = {kv.x, kv.y};
                mma_bf16(s[j], a, b);
            }
        }
    }

    template <int D, int Ld>
    __device__ __forceinline__ static void pv(const float p[kBlockK / 8][4],
                                              const __nv_bfloat16* vs, int g,
                                              int t, float o[D / 8][4]) {
#pragma unroll
        for (int j = 0; j < kBlockK / 16; ++j) {
            const uint32_t a[4] = {
                pack_bf16(p[2 * j][0], p[2 * j][1]),
                pack_bf16(p[2 * j][2], p[2 * j][3]),
                pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
            const __nv_bfloat16* v0 = vs + (16 * j + 2 * t) * Ld + 2 * g;
#pragma unroll
            for (int c = 0; c < D / 16; ++c) {
                // rows 2t, 2t+1, 2t+8, 2t+9; low half d 16c+2g, high half
                // d 16c+2g+1
                const uint32_t r0 =
                    *reinterpret_cast<const uint32_t*>(v0 + 16 * c);
                const uint32_t r1 =
                    *reinterpret_cast<const uint32_t*>(v0 + Ld + 16 * c);
                const uint32_t r8 =
                    *reinterpret_cast<const uint32_t*>(v0 + 8 * Ld + 16 * c);
                const uint32_t r9 =
                    *reinterpret_cast<const uint32_t*>(v0 + 9 * Ld + 16 * c);
                const uint32_t even[2] = {__byte_perm(r0, r1, 0x5410),
                                          __byte_perm(r8, r9, 0x5410)};
                const uint32_t odd[2] = {__byte_perm(r0, r1, 0x7632),
                                         __byte_perm(r8, r9, 0x7632)};
                mma_bf16(o[2 * c], a, even);
                mma_bf16(o[2 * c + 1], a, odd);
            }
        }
    }
};

template <typename T>
__device__ __forceinline__ void store4(T* p, float a, float b, float c,
                                       float d);

template <>
__device__ __forceinline__ void store4<float>(float* p, float a, float b,
                                              float c, float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float a, float b,
                                                      float c, float d) {
    // round to nearest even, as astype does
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(a, b),
                                              pack_bf16(c, d));
}

// rows [row0, row0 + Rows) of a [S, H*D] matrix into shared memory with
// row stride Ld, zero-filled from row `valid` on, by a block of Threads
template <typename T, int D, int Rows, int Ld, int Threads>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          int64_t stride, int64_t row0,
                                          int64_t valid) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));   // per copy
    constexpr int kChunks = D / kPer;                         // per row
    for (int i = threadIdx.x; i < Rows * kChunks; i += Threads) {
        const int r = i / kChunks;
        const int c = (i % kChunks) * kPer;
        const bool ok = row0 + r < valid;
        cp_async16(dst + r * Ld + c, src + (ok ? row0 + r : 0) * stride + c,
                   ok);
    }
}

}  // namespace
