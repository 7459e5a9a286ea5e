// Sorted-segment sum for Hopper (sm_90a), bound through a plain C interface.
//
// Replaces the TPU kernel `_segsum_kernel` of the JAX package
// (src/repro/core/pallas/segsum.py:138, launched at :172).
//
// What it computes: out[s] = sum of data[i] over the i with ids[i] == s,
// added in increasing i, starting from 0, for every s < num_segments.
// `ids` is sorted ascending.  Empty segments get 0.  The order of the adds
// within a segment is the order of np.add.at / np.bincount over the same
// stream, so the result is bit-identical to them for float64 and int64.
//
// Design.  The TPU kernel walks the whole stream in one sequential grid and
// carries the running (id, partial sum) from block to block, with the whole
// output resident on chip.  Blocks on Hopper run in no order, and
// bit-identity needs the order only *within* a segment, so this kernel is
// parallel across segments instead: one warp owns one segment.  The warp
// finds its segment's [lo, hi) by two binary searches over the sorted ids
// (lane 0 searches for s, lane 1 for s + 1), then walks data[lo:hi] 32
// values at a time: each lane loads one value (neighbouring lanes read
// neighbouring addresses, so the load is coalesced), and the 32 values are
// broadcast lane by lane with __shfl_sync and folded in index order.  Every
// lane folds the same values in the same order, so every lane holds the
// same sum and lane 0 writes it.  The output stays in device memory and is
// written once per segment, so there is no limit on num_segments.
//
// Bound.  The kernel is memory-bound: it must read 8 bytes of data and 8
// bytes of id per element and write 8 bytes per segment, about
// 16*m + 8*num_segments bytes (the ids are read only by the binary
// searches, 2*log2(m) probes per segment), over 3.35 TB/s on an H100 SXM.
// The fold within one segment is a chain of dependent adds (the price of
// bit-identity), so a single very long segment is latency-bound on one
// warp; many segments of moderate length fill the card.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (see core/cuda/_build.py).
// --fmad=false keeps any add from being contracted into an FMA.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// First position in ids[0, m) whose id is >= key.
__device__ __forceinline__ int64_t lower_bound(const int64_t* __restrict__ ids,
                                               int64_t m, int64_t key) {
    int64_t lo = 0, hi = m;
    while (lo < hi) {
        int64_t mid = lo + ((hi - lo) >> 1);
        if (ids[mid] < key) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    return lo;
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segsum_kernel(const T* __restrict__ data, const int64_t* __restrict__ ids,
              int64_t m, T* __restrict__ out, int64_t num_segments) {
    const int lane = threadIdx.x & 31;
    const int64_t seg =
        static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
    if (seg >= num_segments) {
        return;  // the whole warp leaves together: seg is uniform per warp
    }
    int64_t bound = 0;
    if (lane < 2) {
        bound = lower_bound(ids, m, seg + lane);
    }
    const int64_t lo = __shfl_sync(kFullMask, bound, 0);
    const int64_t hi = __shfl_sync(kFullMask, bound, 1);

    T acc = T(0);
    for (int64_t base = lo; base < hi; base += 32) {
        const int64_t i = base + lane;
        const T v = (i < hi) ? data[i] : T(0);
        const int64_t left = hi - base;
        const int n = left < 32 ? static_cast<int>(left) : 32;
        for (int j = 0; j < n; ++j) {
            acc = acc + __shfl_sync(kFullMask, v, j);
        }
    }
    if (lane == 0) {
        out[seg] = acc;
    }
}

template <typename T>
int launch(const T* data, const int64_t* ids, int64_t m, T* out,
           int64_t num_segments, void* stream) {
    if (num_segments <= 0) {
        return static_cast<int>(cudaGetLastError());
    }
    const int64_t blocks = (num_segments + kWarpsPerBlock - 1) / kWarpsPerBlock;
    segsum_kernel<T><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(data, ids, m, out,
                                                            num_segments);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on `stream` without synchronising and returns
// cudaGetLastError() (0 when the launch was accepted).
int segsum_f64(const double* data, const int64_t* ids, int64_t m, double* out,
               int64_t num_segments, void* stream) {
    return launch<double>(data, ids, m, out, num_segments, stream);
}

int segsum_i64(const int64_t* data, const int64_t* ids, int64_t m,
               int64_t* out, int64_t num_segments, void* stream) {
    return launch<int64_t>(data, ids, m, out, num_segments, stream);
}

}  // extern "C"
