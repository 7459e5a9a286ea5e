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
// Bound.  The function must read 8 bytes of data and 8 bytes of id per
// element and write 8 bytes per segment: 16*m + 8*num_segments bytes over
// 3.35 TB/s on an H100 SXM.  Bit-identity makes each float64 segment a
// chain of dependent adds, so a segment of L values takes at least L add
// latencies however many threads the card has.
//
// Previous design: one warp per segment, which found its
// [lo, hi) with two binary searches over all m ids (~2 x 21 dependent
// loads) and folded 32 values a round through __shfl_sync.  At the
// star-comm shape (2,023,937 values into 1,048,576 segments) that was a
// million warps, most on empty segments, with 30 of 32 lanes idle:
// 0.734 ms against index_add_'s 0.052 ms.  At the loads shape (5,528,199
// values into 1,024 segments) every round's load waited on memory before
// its 32 shuffled adds: 0.140 ms (H100 80GB HBM3, 700 W; PERF.md).
//
// This design: one pass over the stream, where every position is read
// once, and a second launch for the few long segments.
// 1. `scan_kernel`: a block owns a tile of 1,024 positions (4 a thread).
//    It copies its ids (with 33 before and 33 after) and its data (with 32
//    after) into shared memory in coalesced loads, all requested at once,
//    then the thread at position i compares ids[i-1] and ids[i] (the
//    output was zeroed by a memset first, so empty segments need nothing):
//    - if i starts a segment and ids[i+32] is the same id, the segment is
//      long: (id, i) goes on a list (an atomic counter, zeroed by a memset
//      on the stream; the list's order is free, since each segment is
//      summed whole by one owner);
//    - else the segment has at most kShortMax values, and the thread folds
//      them left to right from shared memory and writes the sum;
//    - if i ends a segment and ids[i-32] is the same id, it writes the
//      long segment's end.
// 2. `long_kernel` (only when m > kShortMax): one warp a long segment, up
//    to a full card of blocks striding over the list.  A warp loads 256
//    values a round, coalesced, the next round's loads issued before this
//    round is folded; lane 0 folds the round in index order from shared
//    memory.  int64 addition is associative (wrap-around included), so an
//    int64 segment is summed by lane partial sums and a warp tree
//    instead, bit-identical all the same.
// The long segments' ends, the counter and the list are int64 scratch that
// the wrapper allocates uninitialised (segsum_scratch_len elements).  The
// output stays in device memory, so there is no limit on num_segments.
// A design that first wrote every segment's offsets in a pass of its own
// and then folded from them moved 16 bytes a segment more; it was slower
// on the star-comm layout and faster on the loads layout, where the long
// folds start one pass earlier (PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -Xcompiler -fPIC -c, then linked -shared (see
//        core/cuda/_build.py).  --fmad=false keeps any add from being
//        contracted into an FMA; no fast-math.
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;             // positions per block
constexpr int kWarps = kThreads / 32;
constexpr int kShortMax = 32;             // a segment of more values is long
constexpr int kAhead = 8;                 // 32-value loads per lane and round
constexpr int kRound = 32 * kAhead;
constexpr int kPer = 4;                   // positions a thread
constexpr int kTile = kThreads * kPer;    // positions a block
// the block's id window: kShortMax + 1 positions before its tile (a
// segment end looks 32 back, a start one back) and kShortMax + 1 after (a
// start looks 32 ahead, an end one ahead); its data window: the tile and
// kShortMax after
constexpr int kIdsBefore = kShortMax + 1;
constexpr int kIdsLen = kIdsBefore + kTile + kShortMax + 1;
constexpr int kDataLen = kTile + kShortMax;
constexpr unsigned kFullMask = 0xffffffffu;

// One pass over the stream: a block owns kTile positions, thread t the
// positions t, t + kThreads, ... of the tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ data, const int64_t* __restrict__ ids,
            int64_t m, int64_t num_segments, T* __restrict__ out,
            unsigned long long* __restrict__ long_count,
            int64_t* __restrict__ long_list, int64_t* __restrict__ long_end) {
    __shared__ int64_t ids_s[kIdsLen];
    __shared__ T data_s[kDataLen];
    const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kTile;
    const int64_t w0 = b0 - kIdsBefore;
    // -1 before the stream, num_segments from position m on
    for (int k = threadIdx.x; k < kIdsLen; k += kThreads) {
        const int64_t p = w0 + k;
        ids_s[k] = p < 0 ? -1 : (p < m ? ids[p] : num_segments);
    }
    for (int k = threadIdx.x; k < kDataLen; k += kThreads) {
        const int64_t p = b0 + k;
        data_s[k] = p < m ? data[p] : T(0);
    }
    __syncthreads();

#pragma unroll
    for (int e = 0; e < kPer; ++e) {
        const int t = threadIdx.x + e * kThreads;   // position in the tile
        const int64_t i = b0 + t;
        const int64_t* id = ids_s + kIdsBefore + t;   // id[0] = ids[i]
        if (i >= m) {
            break;
        }
        if (id[-1] != id[0]) {   // i starts segment id[0]
            const int64_t s = id[0];
            if (id[kShortMax] == s) {   // more than kShortMax values
                const unsigned long long slot = atomicAdd(long_count, 1ull);
                long_list[2 * slot] = s;
                long_list[2 * slot + 1] = i;
            } else {
                T acc = T(0);
                for (int j = 0; j < kShortMax && id[j] == s; ++j) {
                    acc = acc + data_s[t + j];
                }
                out[s] = acc;
            }
        }
        if (id[1] != id[0] && id[-kShortMax] == id[0]) {
            long_end[id[0]] = i + 1;    // i ends a long segment
        }
    }
}

// data[lo, hi) summed by one warp; the result is in lane 0.
template <typename T>
__device__ T fold_long(const T* __restrict__ data, int64_t lo, int64_t hi,
                       T* buf, int lane) {
    if constexpr (std::is_same<T, int64_t>::value) {
        // associative: lane partial sums, then a tree across the warp
        int64_t acc = 0;
        for (int64_t base = lo; base < hi; base += kRound) {
            int64_t v[kAhead];
#pragma unroll
            for (int r = 0; r < kAhead; ++r) {
                const int64_t i = base + r * 32 + lane;
                v[r] = (i < hi) ? data[i] : 0;
            }
#pragma unroll
            for (int r = 0; r < kAhead; ++r) {
                acc += v[r];
            }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            acc += __shfl_xor_sync(kFullMask, acc, off);
        }
        return acc;
    } else {
        T cur[kAhead], nxt[kAhead];
#pragma unroll
        for (int r = 0; r < kAhead; ++r) {
            const int64_t i = lo + r * 32 + lane;
            cur[r] = (i < hi) ? data[i] : T(0);
        }
        T acc = T(0);
        for (int64_t base = lo; base < hi; base += kRound) {
            const int64_t next = base + kRound;
            if (next < hi) {   // the next round's loads, before this fold
#pragma unroll
                for (int r = 0; r < kAhead; ++r) {
                    const int64_t i = next + r * 32 + lane;
                    nxt[r] = (i < hi) ? data[i] : T(0);
                }
            }
#pragma unroll
            for (int r = 0; r < kAhead; ++r) {
                buf[r * 32 + lane] = cur[r];
            }
            __syncwarp();
            if (lane == 0) {
                const int64_t n = hi - base;
                if (n >= kRound) {
                    // two values a shared load, loads hoisted ahead of the
                    // chain of adds
                    const double2* pairs =
                        reinterpret_cast<const double2*>(buf);
#pragma unroll 16
                    for (int j = 0; j < kRound / 2; ++j) {
                        const double2 p = pairs[j];
                        acc = acc + p.x;
                        acc = acc + p.y;
                    }
                } else {
                    for (int j = 0; j < static_cast<int>(n); ++j) {
                        acc = acc + buf[j];
                    }
                }
            }
            __syncwarp();
#pragma unroll
            for (int r = 0; r < kAhead; ++r) {
                cur[r] = nxt[r];
            }
        }
        return acc;
    }
}

// The long segments, from the list: warps stride over it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
long_kernel(const T* __restrict__ data,
            const unsigned long long* __restrict__ long_count,
            const int64_t* __restrict__ long_list,
            const int64_t* __restrict__ long_end, T* __restrict__ out) {
    __shared__ __align__(16) T buf[kWarps][kRound];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int64_t count = static_cast<int64_t>(*long_count);
    for (int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
         w < count; w += static_cast<int64_t>(gridDim.x) * kWarps) {
        const int64_t s = long_list[2 * w];
        const T acc = fold_long<T>(data, long_list[2 * w + 1], long_end[s],
                                   buf[warp], lane);
        if (lane == 0) {
            out[s] = acc;
        }
    }
}

// Long segments have more than kShortMax values each.
int64_t max_long(int64_t m) { return m / (kShortMax + 1); }

template <typename T>
int launch(const T* data, const int64_t* ids, int64_t m, T* out,
           int64_t num_segments, int64_t* scratch, void* stream_ptr) {
    if (num_segments <= 0 || m <= 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    int64_t* long_end = scratch;                          // num_segments
    auto* long_count = reinterpret_cast<unsigned long long*>(
        scratch + num_segments);                          // 1
    int64_t* long_list = scratch + num_segments + 1;      // 2 * max_long(m)
    const int64_t most = max_long(m);
    // empty segments stay 0
    cudaError_t err = cudaMemsetAsync(out, 0, sizeof(T) * num_segments,
                                      stream);
    if (err == cudaSuccess && most > 0) {
        err = cudaMemsetAsync(long_count, 0, sizeof(*long_count), stream);
    }
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    const int64_t tiles = (m + kTile - 1) / kTile;
    scan_kernel<T><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
        data, ids, m, num_segments, out, long_count, long_list, long_end);
    err = cudaGetLastError();
    if (err != cudaSuccess || most == 0) {   // no segment can be long
        return static_cast<int>(err);
    }
    // one warp a long segment, up to a full card of blocks
    int device = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
    }
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    const int64_t want = (most + kWarps - 1) / kWarps;
    const int64_t full = static_cast<int64_t>(sms) * (2048 / kThreads);
    const int64_t blocks = want < full ? want : full;
    long_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        data, long_count, long_list, long_end, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// int64 elements of scratch that a call with m values and num_segments
// segments needs: each long segment's end, the long-segment counter, and
// the list of (segment, start) pairs.
int64_t segsum_scratch_len(int64_t m, int64_t num_segments) {
    return num_segments + 1 + 2 * max_long(m);
}

// Each entry launches on `stream` without synchronising and returns a
// CUDA error code (0 when the launches were accepted).  m and
// num_segments must be positive; `scratch` holds segsum_scratch_len(m,
// num_segments) int64 elements of device memory, uninitialised.
int segsum_f64(const double* data, const int64_t* ids, int64_t m, double* out,
               int64_t num_segments, int64_t* scratch, void* stream) {
    return launch<double>(data, ids, m, out, num_segments, scratch, stream);
}

int segsum_i64(const int64_t* data, const int64_t* ids, int64_t m,
               int64_t* out, int64_t num_segments, int64_t* scratch,
               void* stream) {
    return launch<int64_t>(data, ids, m, out, num_segments, scratch, stream);
}

}  // extern "C"
