// AdamW for Hopper (sm_90a): the global-norm clip and every leaf's update of
// `repro_torch.optim.adamw_update`, bound through a plain C interface.
//
// Replaces no TPU kernel: the JAX package's `optim.adamw_update` is plain
// jnp that XLA fuses.  The port's tree path runs it as PyTorch operators,
// about 23 device launches a leaf (6,922 a step over smollm-360m's 290
// leaves), with ~10 float32 temporaries a leaf and a scaled copy of every
// gradient; the host enqueueing them is what the card waits for.
//
// What it computes, in three launches on one stream with no host sync
// (`optim/adamw_cuda.py` builds the leaf tables and launches them):
//   1. adamw_norm_kernel: each block sums the float32 squares g*g of one
//      chunk of one gradient leaf in float64 and writes one partial.
//   2. adamw_finish_kernel (one block): the partials summed in a fixed
//      order; gn = sqrt(sum) and scale = min(clip / (gn + 1e-9), 1); the
//      step counter's step + 1; the cosine schedule's learning rate and
//      the bias corrections 1 - b^step, each with the float32 operations
//      and roundings of the PyTorch operators the tree path runs (see
//      the kernel), into a 5-float scalar buffer [gn, scale, lr, bc1, bc2].
//   3. adamw_apply_kernel: per element, in float32 and the tree path's
//      order,
//          g  = to_g_dtype(g * scale)
//          m' = b1*m + (1-b1)*g
//          v' = b2*v + ((1-b2)*g)*g
//          u  = (m'/bc1) / (sqrt(v'/bc2) + eps)
//          p' = p - lr*(u + wd*p)
//      each result cast to its own dtype (float32 or bfloat16, per leaf
//      and per operand).  Built with --fmad=false and IEEE division and
//      square root, every operation rounds once as PyTorch's operators do,
//      so p', m' and v' equal the tree path's bit for bit whenever the
//      scalars are equal.  The outputs may be the inputs (in place).
// The squares are summed in another order than PyTorch's float32
// reduction, so gn differs from the tree path's by float32 rounding; the
// sum is fixed by the leaves' sizes alone (no atomics), so two calls give
// the same bits.
//
// Leaf tables.  A launch takes up to kMaxLeaves leaves as a kernel
// parameter (a `Table` of 29 KB: CUDA 12.1 allows 32,764 bytes of them),
// copied at the launch, so the host's table may be reused at once; more
// leaves take more launches.  Every leaf is cut into chunks of `chunk`
// elements, one block each; a block finds its leaf by a binary search of
// the table's first blocks.
//
// Bound.  Memory: one read of g for the norm (4 B an element in float32)
// and one pass that reads p, g, m, v and writes p, m, v (28 B): 11.58 GB
// over smollm-360m's 361,821,120 parameters, 3.46 ms at 3.35 TB/s.  Loads
// and stores are 16 bytes a thread (4 elements) wherever a leaf's
// operands share their alignment phase, after a scalar head; a leaf whose
// operands do not (views at odd offsets of one buffer beside fresh
// moments) is walked one element a thread, still coalesced.
//
// Build: see flash_attention.cu.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;          // a block of the norm and the update
constexpr int kFinishThreads = 1024;   // the one block that finishes
constexpr int kMaxLeaves = 384;        // a Table of 29,200 bytes
constexpr int kRow = 10;               // int64 fields of a host table row

struct Leaf {
    void* p;            // inputs
    const void* g;
    void* m;
    void* v;
    void* po;           // outputs (the inputs, in place)
    void* mo;
    void* vo;
    int64_t n;          // elements
    int64_t code;       // bfloat16 operands: bit 0 p, 1 g, 2 m, 3 v
};

struct Table {
    int64_t chunk;                  // elements a block
    int32_t n_leaves;
    int32_t start[kMaxLeaves + 1];  // a leaf's first block; [n] the grid
    Leaf leaf[kMaxLeaves];
};

struct Hyper {          // the constants as float32, as PyTorch takes them
    float b1, omb1, b2, omb2, eps, wd;
};

struct Step {           // the step's scalars, from the finish kernel
    float scale, lr, bc1, bc2;
};

__device__ __forceinline__ float ld(const float* p, int64_t i) {
    return p[i];
}
__device__ __forceinline__ float ld(const bf16* p, int64_t i) {
    return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, int64_t i, float x) {
    p[i] = x;
}
__device__ __forceinline__ void st(bf16* p, int64_t i, float x) {
    p[i] = __float2bfloat16(x);   // round to nearest even, as PyTorch's
}

__device__ __forceinline__ void ld4(const float* p, float (&x)[4]) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    x[0] = r.x;
    x[1] = r.y;
    x[2] = r.z;
    x[3] = r.w;
}
__device__ __forceinline__ void ld4(const bf16* p, float (&x)[4]) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(r.x << 16);
    x[1] = __uint_as_float(r.x & 0xffff0000u);
    x[2] = __uint_as_float(r.y << 16);
    x[3] = __uint_as_float(r.y & 0xffff0000u);
}
__device__ __forceinline__ void st4(float* p, const float (&x)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ uint32_t bf16_bits(float x) {
    return __bfloat16_as_ushort(__float2bfloat16(x));
}
__device__ __forceinline__ void st4(bf16* p, const float (&x)[4]) {
    uint2 r;
    r.x = bf16_bits(x[0]) | (bf16_bits(x[1]) << 16);
    r.y = bf16_bits(x[2]) | (bf16_bits(x[3]) << 16);
    *reinterpret_cast<uint2*>(p) = r;
}

// x rounded to T and back: the tree path's `.to(g.dtype)` of the scaled
// gradient, read again as float32
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
    return x;
}
template <>
__device__ __forceinline__ float round_to<bf16>(float x) {
    return __bfloat162float(__float2bfloat16(x));
}

// the element's position in its 4-element (16-byte in float32) group
template <typename T>
__device__ __forceinline__ int phase4(const void* p) {
    return static_cast<int>(reinterpret_cast<uintptr_t>(p) / sizeof(T)) & 3;
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
    return a < b ? a : b;
}

// PyTorch's clamp: NaN passes through
__device__ __forceinline__ float clamp_max(float x, float hi) {
    return x != x ? x : fminf(x, hi);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
    return x != x ? x : fminf(fmaxf(x, lo), hi);
}

template <typename G>
__device__ __forceinline__ void adamw_elem(float& p, float g, float& m,
                                           float& v, const Hyper& h,
                                           const Step& s) {
    const float gs = round_to<G>(g * s.scale);
    m = h.b1 * m + h.omb1 * gs;
    v = h.b2 * v + (h.omb2 * gs) * gs;
    const float u = (m / s.bc1) / (sqrtf(v / s.bc2) + h.eps);
    p = p - s.lr * (u + h.wd * p);
}

// The block's chunk [lo, hi) of leaf L: a scalar head up to the first
// element whose operands all sit at a 4-element boundary, 4-element
// vectors, a scalar tail; one element a thread if the operands' phases
// differ.
template <typename P, typename G, typename M, typename V>
__device__ void apply_chunk(const Leaf& L, int64_t lo, int64_t hi,
                            const Hyper& h, const Step& s) {
    const P* p = static_cast<const P*>(L.p);
    const G* g = static_cast<const G*>(L.g);
    const M* m = static_cast<const M*>(L.m);
    const V* v = static_cast<const V*>(L.v);
    P* po = static_cast<P*>(L.po);
    M* mo = static_cast<M*>(L.mo);
    V* vo = static_cast<V*>(L.vo);
    auto one = [&](int64_t i) {
        float pf = ld(p, i), mf = ld(m, i), vf = ld(v, i);
        adamw_elem<G>(pf, ld(g, i), mf, vf, h, s);
        st(po, i, pf);
        st(mo, i, mf);
        st(vo, i, vf);
    };
    const int ph = phase4<P>(p);
    const bool vec = ph == phase4<G>(g) && ph == phase4<M>(m) &&
                     ph == phase4<V>(v) && ph == phase4<P>(po) &&
                     ph == phase4<M>(mo) && ph == phase4<V>(vo);
    if (!vec) {
        for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) one(i);
        return;
    }
    const int64_t head = min64(hi, lo + ((4 - ph) & 3));
    const int64_t nvec = (hi - head) / 4;
    const int64_t tail = head + 4 * nvec;
    if (lo + threadIdx.x < head) one(lo + threadIdx.x);
    for (int64_t j = threadIdx.x; j < nvec; j += kThreads) {
        const int64_t i = head + 4 * j;
        float pf[4], gf[4], mf[4], vf[4];
        ld4(p + i, pf);
        ld4(g + i, gf);
        ld4(m + i, mf);
        ld4(v + i, vf);
#pragma unroll
        for (int k = 0; k < 4; ++k) adamw_elem<G>(pf[k], gf[k], mf[k], vf[k],
                                                  h, s);
        st4(po + i, pf);
        st4(mo + i, mf);
        st4(vo + i, vf);
    }
    if (tail + threadIdx.x < hi) one(tail + threadIdx.x);
}

// This thread's float64 sum of the squares of chunk [lo, hi) of gradient g
template <typename G>
__device__ double sumsq_chunk(const void* gp, int64_t lo, int64_t hi) {
    const G* g = static_cast<const G*>(gp);
    double acc = 0.0;
    const int64_t head = min64(hi, lo + ((4 - phase4<G>(g)) & 3));
    const int64_t nvec = (hi - head) / 4;
    const int64_t tail = head + 4 * nvec;
    if (lo + threadIdx.x < head) {
        const float x = ld(g, lo + threadIdx.x);
        acc += static_cast<double>(x * x);
    }
    for (int64_t j = threadIdx.x; j < nvec; j += kThreads) {
        float x[4];
        ld4(g + head + 4 * j, x);
#pragma unroll
        for (int k = 0; k < 4; ++k) acc += static_cast<double>(x[k] * x[k]);
    }
    if (tail + threadIdx.x < hi) {
        const float x = ld(g, tail + threadIdx.x);
        acc += static_cast<double>(x * x);
    }
    return acc;
}

// The block's sum of x, in thread 0, in a fixed order (blockDim.x a
// multiple of 32, at most 1,024).  Called once a kernel.
__device__ double block_sum(double x) {
    __shared__ double warp_sums[32];
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    if (lane == 0) warp_sums[w] = x;
    __syncthreads();
    x = 0.0;
    if (w == 0) {
        if (lane < static_cast<int>(blockDim.x >> 5)) x = warp_sums[lane];
        for (int o = 16; o > 0; o >>= 1)
            x += __shfl_down_sync(0xffffffffu, x, o);
    }
    return x;
}

// The leaf of block b: the last i in [0, n) with start[i] <= b (leaves of
// no elements have no block and are passed over).
__device__ __forceinline__ int find_leaf(const Table& t, int b) {
    int lo = 0, hi = t.n_leaves - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (t.start[mid] <= b) lo = mid; else hi = mid - 1;
    }
    return lo;
}

__global__ void __launch_bounds__(kThreads)
adamw_norm_kernel(const __grid_constant__ Table t, double* partials) {
    const int b = blockIdx.x;
    const int i = find_leaf(t, b);
    const Leaf& L = t.leaf[i];
    const int64_t lo = static_cast<int64_t>(b - t.start[i]) * t.chunk;
    const int64_t hi = min64(L.n, lo + t.chunk);
    const double s = (L.code & 2) ? sumsq_chunk<bf16>(L.g, lo, hi)
                                  : sumsq_chunk<float>(L.g, lo, hi);
    const double total = block_sum(s);
    if (threadIdx.x == 0) partials[b] = total;
}

struct Sched {          // the clip and the schedule, as PyTorch takes them
    float clip, lr, b1, b2;
    int64_t warmup, total;
};

// The tree path's scalars, operator for operator (torch's CUDA kernels;
// a Python number is a float32 operand; a division by a Python number is
// a product with its float32 reciprocal; `x / tensor` from Python is
// `tensor.reciprocal() * x`):
//   gn    = sqrt(sum)                               float32
//   scale = clamp(reciprocal(gn + 1e-9) * clip, max=1)
//   step  = step + 1                                int32
//   warm  = clamp(s * (1 / max(warmup, 1)), max=1)  s = float(step)
//   t     = clamp((s - warmup) * (1 / max(total - warmup, 1)), 0, 1)
//   lr    = ((warm * lr) * 0.5) * (1 + cos(pi * t))
//   bc    = 1 - pow(b, s)
__global__ void __launch_bounds__(kFinishThreads)
adamw_finish_kernel(const double* partials, int64_t n_partials,
                    const int32_t* step_in, int32_t* step_out, float* scal,
                    Sched sc) {
    double acc = 0.0;
    for (int64_t i = threadIdx.x; i < n_partials; i += kFinishThreads)
        acc += partials[i];
    acc = block_sum(acc);
    if (threadIdx.x != 0) return;
    const float gn = sqrtf(static_cast<float>(acc));
    const float scale = clamp_max(
        (1.0f / (gn + static_cast<float>(1e-9))) * sc.clip, 1.0f);
    // int32 addition wraps, as the tensor's does
    const int32_t step = static_cast<int32_t>(
        static_cast<uint32_t>(step_in[0]) + 1u);
    step_out[0] = step;
    const float s = static_cast<float>(step);
    const int64_t warm_div = sc.warmup > 1 ? sc.warmup : 1;
    const int64_t decay = sc.total - sc.warmup > 1 ? sc.total - sc.warmup : 1;
    const float warm = clamp_max(
        s * (1.0f / static_cast<float>(warm_div)), 1.0f);
    const float t = clamp((s - static_cast<float>(sc.warmup)) *
                              (1.0f / static_cast<float>(decay)),
                          0.0f, 1.0f);
    const float c = cosf(static_cast<float>(3.141592653589793) * t);
    scal[0] = gn;
    scal[1] = scale;
    scal[2] = ((warm * sc.lr) * 0.5f) * (c + 1.0f);
    scal[3] = 1.0f - powf(sc.b1, s);
    scal[4] = 1.0f - powf(sc.b2, s);
}

__global__ void __launch_bounds__(kThreads)
adamw_apply_kernel(const __grid_constant__ Table t, const float* scal,
                   Hyper h) {
    const int b = blockIdx.x;
    const int i = find_leaf(t, b);
    const Leaf& L = t.leaf[i];
    const int64_t lo = static_cast<int64_t>(b - t.start[i]) * t.chunk;
    const int64_t hi = min64(L.n, lo + t.chunk);
    const Step s{scal[1], scal[2], scal[3], scal[4]};
#define ADAMW_CASE(c, P, G, M, V) \
    case c: apply_chunk<P, G, M, V>(L, lo, hi, h, s); break;
    switch (L.code) {
        ADAMW_CASE(0, float, float, float, float)
        ADAMW_CASE(1, bf16, float, float, float)
        ADAMW_CASE(2, float, bf16, float, float)
        ADAMW_CASE(3, bf16, bf16, float, float)
        ADAMW_CASE(4, float, float, bf16, float)
        ADAMW_CASE(5, bf16, float, bf16, float)
        ADAMW_CASE(6, float, bf16, bf16, float)
        ADAMW_CASE(7, bf16, bf16, bf16, float)
        ADAMW_CASE(8, float, float, float, bf16)
        ADAMW_CASE(9, bf16, float, float, bf16)
        ADAMW_CASE(10, float, bf16, float, bf16)
        ADAMW_CASE(11, bf16, bf16, float, bf16)
        ADAMW_CASE(12, float, float, bf16, bf16)
        ADAMW_CASE(13, bf16, float, bf16, bf16)
        ADAMW_CASE(14, float, bf16, bf16, bf16)
        ADAMW_CASE(15, bf16, bf16, bf16, bf16)
        default: break;
    }
#undef ADAMW_CASE
}

// The host table's rows (p, g, m, v, po, mo, vo, n, code, first block)
// into a Table; false where the arguments are out of range.
bool fill(Table& t, const int64_t* rows, int32_t n, int64_t chunk,
          int64_t blocks) {
    if (n < 1 || n > kMaxLeaves || chunk <= 0 || chunk % 4 != 0 ||
        blocks < 0 || blocks > INT32_MAX)
        return false;
    t.chunk = chunk;
    t.n_leaves = n;
    for (int i = 0; i < n; ++i) {
        const int64_t* r = rows + static_cast<int64_t>(i) * kRow;
        Leaf& L = t.leaf[i];
        L.p = reinterpret_cast<void*>(r[0]);
        L.g = reinterpret_cast<const void*>(r[1]);
        L.m = reinterpret_cast<void*>(r[2]);
        L.v = reinterpret_cast<void*>(r[3]);
        L.po = reinterpret_cast<void*>(r[4]);
        L.mo = reinterpret_cast<void*>(r[5]);
        L.vo = reinterpret_cast<void*>(r[6]);
        L.n = r[7];
        L.code = r[8];
        if (r[8] < 0 || r[8] > 15) return false;
        t.start[i] = static_cast<int32_t>(r[9]);
    }
    t.start[n] = static_cast<int32_t>(blocks);
    return true;
}

}  // namespace

extern "C" {

// Leaves a launch takes: the host cuts its leaves into groups of this many.
int32_t adamw_max_leaves() { return kMaxLeaves; }

// Each entry launches on `stream` without synchronising and returns a CUDA
// error code: 0 when the launch was accepted.

// The norm's partials of one group of leaves, `blocks` of them, into
// partials[0 .. blocks).
int adamw_norm(const int64_t* rows, int32_t n, int64_t chunk, int64_t blocks,
               double* partials, void* stream) {
    Table t;
    if (!fill(t, rows, n, chunk, blocks)) return cudaErrorInvalidValue;
    if (blocks == 0) return 0;
    adamw_norm_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(t, partials);
    return static_cast<int>(cudaGetLastError());
}

// The clip's norm and scale, the step and its schedule, into scal[0..5)
// and *step_out (which may be step_in).
int adamw_finish(const double* partials, int64_t n_partials,
                 const int32_t* step_in, int32_t* step_out, float* scal,
                 float clip, float lr, float b1, float b2, int64_t warmup,
                 int64_t total, void* stream) {
    if (n_partials < 0) return cudaErrorInvalidValue;
    adamw_finish_kernel<<<1, kFinishThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        partials, n_partials, step_in, step_out, scal,
        Sched{clip, lr, b1, b2, warmup, total});
    return static_cast<int>(cudaGetLastError());
}

// The update of one group of leaves.  b1, omb1 (float32 of 1 - b1 taken
// in double), b2, omb2, eps, wd: the constants as PyTorch rounds them.
int adamw_apply(const int64_t* rows, int32_t n, int64_t chunk, int64_t blocks,
                const float* scal, float b1, float omb1, float b2, float omb2,
                float eps, float wd, void* stream) {
    Table t;
    if (!fill(t, rows, n, chunk, blocks)) return cudaErrorInvalidValue;
    if (blocks == 0) return 0;
    adamw_apply_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        t, scal, Hyper{b1, omb1, b2, omb2, eps, wd});
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
