// Hopper (sm_90a) building blocks of the flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu, flash_attention_bwd_mla.cuh):
// mbarriers, the bulk async copy that completes on one, the async-proxy
// fence, named barriers, and warpgroup products (`wgmma`) with A in
// registers and B in shared memory, in the 128-byte swizzled K-major layout
// that `sw128_offset` writes and `sw128_desc` describes; for bf16 also with
// A in shared memory and with B transposed (MN-major); and `product`, a
// split-TF32 or bf16 product over k-steps with A fragments a chunk ahead.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------------ //
// mbarriers and the bulk copy
// ------------------------------------------------------------------ //
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
                 "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
                 : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            bar),
        "r"(bytes)
        : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    return done != 0;
}

// returns once the barrier has completed the phase of parity `parity`; a
// wait of more than 2^34 cycles (about 10 s) can only be a lost arrival,
// and traps, so that a fault ends the kernel with an error instead of
// holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    if (mbar_try(bar, parity)) {
        return;
    }
    const long long t0 = clock64();
    while (!mbar_try(bar, parity)) {
        if (clock64() - t0 > (1ll << 34)) {
            __trap();
        }
    }
}

// `bytes` (a multiple of 16) from global to shared memory (both 16-byte
// aligned); completes `bytes` of the barrier's transaction count
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(dst),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
}

// this thread's shared-memory writes become visible to the async proxy
// (wgmma's operand reads)
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1..15) among `count` threads
__device__ __forceinline__ void bar_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ------------------------------------------------------------------ //
// The 128-byte swizzled K-major layout: a tile of R rows (R % 8 == 0) by
// K bytes (K % 128 == 0) is K/128 column blocks of R x 128 bytes, each
// 1024-byte aligned; in a block, the 16-byte chunk c of row n lies at
// chunk c ^ (n % 8) of the row's 128 bytes.
// ------------------------------------------------------------------ //
__device__ __forceinline__ uint32_t sw128_offset(int rows, int n, int byte) {
    const int chunk = ((byte >> 4) & 7) ^ (n & 7);
    return static_cast<uint32_t>((byte >> 7) * rows * 128 + n * 128 +
                                 (chunk << 4) + (byte & 15));
}

// the wgmma descriptor of rows 0..R-1 and bytes kb..kb+31 of such a tile
// at shared address `base` (kb % 32 == 0): start address, leading offset
// 1 (unused when swizzled), stride 1024 bytes between 8-row groups,
// layout 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t base, int rows,
                                               int kb) {
    const uint32_t addr =
        base + static_cast<uint32_t>((kb >> 7) * rows * 128 + (kb & 127));
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>(1) << 16) |
           (static_cast<uint64_t>(1024 >> 4) << 32) |
           (static_cast<uint64_t>(1) << 62);
}

// `sw128_desc(base, rows, kb)` from `sw128_desc(base, rows, 0)`: the
// start address moved on in its 16-byte units (no carry out of the field:
// shared memory is below 256 KB)
__device__ __forceinline__ uint64_t sw128_step(uint64_t desc0, int rows,
                                               int kb) {
    return desc0 +
           static_cast<uint64_t>(((kb >> 7) * rows * 128 + (kb & 127)) >> 4);
}

// ------------------------------------------------------------------ //
// wgmma: D[64 x N] = A[64 x K] B[N x K]^T (+ D when acc != 0), A in
// registers (K = 8 tf32 or 16 bf16), B K-major in shared memory.
// Register layouts (warp w of the warpgroup, lane = 4g + t): A tf32 a0
// (16w+g, t), a1 (16w+g+8, t), a2 (16w+g, t+4), a3 (16w+g+8, t+4); A
// bf16 a0 (16w+g, 2t..2t+1), a1 (16w+g+8, 2t..), a2 (16w+g, 2t+8..), a3
// (16w+g+8, 2t+8..), the lower k in the low half; D d[4j+e] at
// (16w+g+8(e/2), 8j+2t+(e%2)).
// ------------------------------------------------------------------ //
__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pin registers in program order around the asynchronous products: the
// compiler may not move their definitions or uses across the wgmma
// fence, commit and wait (which name no registers themselves)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
        asm volatile("" : "+f"(r[i])::"memory");
    }
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
        asm volatile("" : "+r"(r[i])::"memory");
    }
}

template <typename T, int N>
struct Wgmma;

#define REPRO_WG_TAIL_TF32 " p, 1, 1;\n}\n"
#define REPRO_WG_TAIL_BF16 " p, 1, 1, 0;\n}\n"

#define REPRO_WGMMA_16(TYPE, SHAPE, TAIL)                                    \
    __device__ __forceinline__ static void mma(float (&d)[8],                \
                                               const uint32_t (&a)[4],       \
                                               uint64_t desc, int acc) {     \
        asm volatile(                                                         \
            "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                      \
            "wgmma.mma_async.sync.aligned." SHAPE ".f32." TYPE "." TYPE      \
            " {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12,"    \
            TAIL                                                              \
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),    \
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7])                              \
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),         \
              "r"(acc));                                                      \
    }

#define REPRO_WGMMA_32(TYPE, SHAPE, TAIL)                                    \
    __device__ __forceinline__ static void mma(float (&d)[16],               \
                                               const uint32_t (&a)[4],       \
                                               uint64_t desc, int acc) {     \
        asm volatile(                                                         \
            "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                      \
            "wgmma.mma_async.sync.aligned." SHAPE ".f32." TYPE "." TYPE      \
            " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"  \
            " %14, %15}, {%16, %17, %18, %19}, %20," TAIL                     \
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),    \
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),    \
              "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),            \
              "+f"(d[14]), "+f"(d[15])                                        \
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),         \
              "r"(acc));                                                      \
    }

#define REPRO_WGMMA_48(TYPE, SHAPE, TAIL)                                    \
    __device__ __forceinline__ static void mma(float (&d)[24],               \
                                               const uint32_t (&a)[4],       \
                                               uint64_t desc, int acc) {     \
        asm volatile(                                                         \
            "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"                      \
            "wgmma.mma_async.sync.aligned." SHAPE ".f32." TYPE "." TYPE      \
            " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"  \
            " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23},"            \
            " {%24, %25, %26, %27}, %28," TAIL                                \
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),    \
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),    \
              "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),            \
              "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),            \
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),            \
              "+f"(d[22]), "+f"(d[23])                                        \
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),         \
              "r"(acc));                                                      \
    }

#define REPRO_WGMMA_64(TYPE, SHAPE, TAIL)                                    \
    __device__ __forceinline__ static void mma(float (&d)[32],               \
                                               const uint32_t (&a)[4],       \
                                               uint64_t desc, int acc) {     \
        asm volatile(                                                         \
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                      \
            "wgmma.mma_async.sync.aligned." SHAPE ".f32." TYPE "." TYPE      \
            " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"  \
            " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"   \
            " %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36,"     \
            TAIL                                                              \
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),    \
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),    \
              "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),            \
              "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),            \
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),            \
              "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),            \
              "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),            \
              "+f"(d[30]), "+f"(d[31])                                        \
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),         \
              "r"(acc));                                                      \
    }

template <>
struct Wgmma<float, 16> {
    REPRO_WGMMA_16("tf32", "m64n16k8", REPRO_WG_TAIL_TF32)
};
template <>
struct Wgmma<float, 32> {
    REPRO_WGMMA_32("tf32", "m64n32k8", REPRO_WG_TAIL_TF32)
};
template <>
struct Wgmma<float, 48> {
    REPRO_WGMMA_48("tf32", "m64n48k8", REPRO_WG_TAIL_TF32)
};
template <>
struct Wgmma<float, 64> {
    REPRO_WGMMA_64("tf32", "m64n64k8", REPRO_WG_TAIL_TF32)
};
template <>
struct Wgmma<__nv_bfloat16, 16> {
    REPRO_WGMMA_16("bf16", "m64n16k16", REPRO_WG_TAIL_BF16)
};
template <>
struct Wgmma<__nv_bfloat16, 32> {
    REPRO_WGMMA_32("bf16", "m64n32k16", REPRO_WG_TAIL_BF16)
};
template <>
struct Wgmma<__nv_bfloat16, 48> {
    REPRO_WGMMA_48("bf16", "m64n48k16", REPRO_WG_TAIL_BF16)
};
template <>
struct Wgmma<__nv_bfloat16, 64> {
    REPRO_WGMMA_64("bf16", "m64n64k16", REPRO_WG_TAIL_BF16)
};

#undef REPRO_WGMMA_16
#undef REPRO_WGMMA_32
#undef REPRO_WGMMA_48
#undef REPRO_WGMMA_64
#undef REPRO_WG_TAIL_TF32
#undef REPRO_WG_TAIL_BF16

// ------------------------------------------------------------------ //
// bf16 wgmma with both operands in shared memory, and with B transposed.
// WgmmaSS<N>: D[64 x N] = A[64 x K] B[N x K]^T (+ D), A and B K-major
// (both `sw128_desc`).  WgmmaRT<N>: A in registers as for `Wgmma`, B
// MN-major (the transpose immediate set): B[n][k] is element n of row k of
// a tile stored in the 128-byte swizzled layout with n along the row
// (`sw128_desc_mn`).  D's layout is Wgmma's.
// ------------------------------------------------------------------ //
template <int N>
struct WgmmaSS;
template <int N>
struct WgmmaRT;

template <>
struct WgmmaSS<32> {
    __device__ __forceinline__ static void mma(float (&d)[16],
                                               uint64_t desc_a,
                                               uint64_t desc_b, int acc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
            "%13, %14, %15"
            "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
              "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
              "+f"(d[14]), "+f"(d[15])
            : "l"(desc_a), "l"(desc_b), "r"(acc));
    }
};
template <>
struct WgmmaSS<64> {
    __device__ __forceinline__ static void mma(float (&d)[32],
                                               uint64_t desc_a,
                                               uint64_t desc_b, int acc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
            "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31"
            "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
              "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
              "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
              "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
              "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31])
            : "l"(desc_a), "l"(desc_b), "r"(acc));
    }
};
template <>
struct WgmmaSS<128> {
    __device__ __forceinline__ static void mma(float (&d)[64],
                                               uint64_t desc_a,
                                               uint64_t desc_b, int acc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
            "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
            "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
            "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
            "%57, %58, %59, %60, %61, %62, %63"
            "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
              "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
              "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
              "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
              "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
              "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
              "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
              "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
              "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "l"(desc_a), "l"(desc_b), "r"(acc));
    }
};
template <>
struct WgmmaRT<64> {
    __device__ __forceinline__ static void mma(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b, int acc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
            "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31"
            "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
              "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
              "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
              "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
              "r"(acc));
    }
};
template <>
struct WgmmaRT<128> {
    __device__ __forceinline__ static void mma(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b, int acc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
            "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
            "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
            "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
            "%57, %58, %59, %60, %61, %62, %63"
            "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
              "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
              "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
              "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
              "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]),
              "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
              "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
              "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
              "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
              "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
              "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]),
              "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
              "+f"(d[62]), "+f"(d[63])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
              "r"(acc));
    }
};
template <>
struct WgmmaRT<192> {
    __device__ __forceinline__ static void mma(float (&d)[96],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b, int acc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
            "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
            "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
            "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
            "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, "
            "%68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, "
            "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
            "%90, %91, %92, %93, %94, %95"
            "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
              "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
              "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
              "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
              "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]),
              "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
              "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
              "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
              "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
              "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
              "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]),
              "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
              "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
              "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
              "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
              "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
              "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]),
              "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
              "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
              "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]),
              "+f"(d[94]), "+f"(d[95])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
              "r"(acc));
    }
};


// the wgmma descriptor of an MN-major operand at shared address `base`:
// rows of the tile are k, 8 rows (1024 bytes) a swizzle atom along k, and
// each 64 bf16 columns (one 128-byte column block of the tile) `lbo`
// bytes after the one before, as `sw128_offset` lays out a tile of
// lbo / 128 rows
__device__ __forceinline__ uint64_t sw128_desc_mn(uint32_t base,
                                                  uint32_t lbo) {
    return static_cast<uint64_t>((base & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>(lbo >> 4) << 16) |
           (static_cast<uint64_t>(1024 >> 4) << 32) |
           (static_cast<uint64_t>(1) << 62);
}

// 4 bytes from global to shared memory, zeros when !valid (cp.async.ca)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

// the barrier's pending count falls by one once every cp.async this
// thread issued before has landed (the count is not raised first)
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                     "r"(bar)
                 : "memory");
}

// d (=, or += when `acc`) A B^T over the k-steps [0, KS) on the tensor
// cores, split TF32 (hi.hi, hi.lo, lo.hi) or bf16: the A fragments of
// KC k-steps go to registers first (`frag(kk, hi, lo)`), then one fence
// and their wgmma (B from `desc(kk, copy)`), then a commit; so no
// instruction defines a running wgmma's registers.  The next chunk's
// fragments load while this chunk's products run, and at most two
// chunks are in flight, so their registers stay few.
template <typename T, int N, int KS, int KC, typename F, typename B>
__device__ __forceinline__ void product(float (&d)[N / 2], F frag, B desc,
                                        bool acc) {
    static_assert(KS % KC == 0, "chunks of whole k-steps");
#pragma unroll
    for (int c0 = 0; c0 < KS; c0 += KC) {
        uint32_t hi[KC][4], lo[KC][4];
#pragma unroll
        for (int i = 0; i < KC; ++i) {
            frag(c0 + i, hi[i], lo[i]);
            fence_regs(hi[i]);
            if constexpr (std::is_same<T, float>::value) {
                fence_regs(lo[i]);
            }
        }
        fence_regs(d);
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < KC; ++i) {
            const int first = (acc || c0 + i > 0) ? 1 : 0;
            Wgmma<T, N>::mma(d, hi[i], desc(c0 + i, 0), first);
            if constexpr (std::is_same<T, float>::value) {
                Wgmma<T, N>::mma(d, hi[i], desc(c0 + i, 1), 1);
                Wgmma<T, N>::mma(d, lo[i], desc(c0 + i, 0), 1);
            }
        }
        wgmma_commit();
        fence_regs(d);
        wgmma_wait<1>();   // the chunk before is done: its registers free
    }
}

}  // namespace
