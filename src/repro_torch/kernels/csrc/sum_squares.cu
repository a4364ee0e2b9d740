// ||X||² of CP-ALS's fit: the sum of squares of n float32 values, each
// squared and summed in float64, for Hopper (sm_90a), with no host
// synchronisation.
//
// No Pallas counterpart: the reference takes ||X|| on the host
// (src/repro/core/cpals.py:124, `st.norm() ** 2`, numpy's float64 norm of
// the values) every iteration.  The port reduces it once a `cp_als` call
// from the values it has already uploaded for the fit and the difference.
// torch widens a float32 tensor to a whole float64 copy before any float64
// reduction of it (615 MB at NELL-2), so the widening happens here, in
// registers.
//
// Contract: partials[b] = Σ x_i² over the indices i ≡ t (mod G·kThreads)
// of block b's threads t, G = gridDim.x, in float64; the wrapper sums the G
// partials.  A float32 squares exactly in float64 (48 significant bits of
// 53), so the result differs from any other float64 summation of the same
// squares only by the order of the additions.  The order depends on n and G
// alone: two calls give the same bits.
//
// Design.  Reading the values once bounds it: 4n bytes (307 MB at NELL-2,
// 92 µs at 3.35 TB/s).  A grid-stride loop of coalesced loads, four loads
// in flight per thread (four independent accumulators), so that about one
// wave of G ≤ 1024 blocks of 256 threads keeps some 4 MB in flight; then a
// warp shuffle tree and one shared-memory step per block.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;

__global__ void __launch_bounds__(kThreads)
sum_squares_kernel(const float* __restrict__ x, long long n, double* __restrict__ partials) {
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    double acc0 = 0.0, acc1 = 0.0, acc2 = 0.0, acc3 = 0.0;
    for (; i + 3 * stride < n; i += 4 * stride) {
        const double a = __ldg(x + i), b = __ldg(x + i + stride);
        const double c = __ldg(x + i + 2 * stride), d = __ldg(x + i + 3 * stride);
        acc0 = __dadd_rn(acc0, __dmul_rn(a, a));
        acc1 = __dadd_rn(acc1, __dmul_rn(b, b));
        acc2 = __dadd_rn(acc2, __dmul_rn(c, c));
        acc3 = __dadd_rn(acc3, __dmul_rn(d, d));
    }
    for (; i < n; i += stride) {
        const double a = __ldg(x + i);
        acc0 = __dadd_rn(acc0, __dmul_rn(a, a));
    }
    double acc = __dadd_rn(__dadd_rn(acc0, acc1), __dadd_rn(acc2, acc3));
    for (int off = 16; off > 0; off >>= 1) {
        acc = __dadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
    }
    __shared__ double warp_sums[kThreads / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) warp_sums[warp] = acc;
    __syncthreads();
    if (warp == 0) {
        acc = lane < kThreads / 32 ? warp_sums[lane] : 0.0;
        for (int off = 16; off > 0; off >>= 1) {
            acc = __dadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
        }
        if (lane == 0) partials[blockIdx.x] = acc;
    }
}

}  // namespace

extern "C" {

// Launches `blocks` blocks on `stream`: x holds n float32 values, partials
// `blocks` float64.  Returns a cudaError_t (0 = launched).  Allocates
// nothing and does not synchronise.
int prism_sum_squares_f32(const void* x, long long n, void* partials, int blocks, void* stream) {
    if (n < 1 || blocks < 1 || blocks > kMaxBlocks) {
        return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    sum_squares_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), n, static_cast<double*>(partials));
    return static_cast<int>(cudaGetLastError());
}

const char* prism_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
