// Shared pieces of the flash-attention kernels (flash_attention.cu, the
// forward, and flash_attention_bwd.cu, the backward): cp.async wrappers,
// the split-TF32 operands, 2^x on the MUFU and bf16 packing.  The design
// notes are in flash_attention.cu.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace
