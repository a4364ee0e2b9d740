// Chunked spMTTKRP, float path: the per-task partial blocks, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/mttkrp_kernel.py::mttkrp_pallas_local
// (body `_kernel`).  Same contract: for every task t and slot p with a
// nonzero value, multiply the value by the input-mode factor rows at
// task_chunk[t, m] * S_m + coords_rel[t, p, m] (clamped to the factor's last
// row), in mode order, and add the product into row coords_rel[t, p, mode]
// of the task's private (S_mode, R) block.  Output: local (T, S_mode, R) f32,
// zero-filled by the caller.  The global sum of the blocks stays outside,
// in PyTorch (kernels/ref.py::reduce_local).
//
// Design.  The TPU kernel runs one grid step per task and turns every
// gather and scatter into a one-hot matrix product, because the TPU has no
// cheap random access.  Hopper has, so this kernel reads each factor row by
// index from device memory and scatters with atomicAdd.  The TPU's one step
// per task would put a whole task on one SM, and a task can hold every
// nonzero of the tensor (T = 1 under a large memory budget), so the grid is
// (task, tile of `kTile` slots) flattened into gridDim.x.  Inside a block,
// lanes are cut into groups of `group` = min(32, next power of two >= R);
// a group takes one nonzero at a time and its lanes walk r (looping when
// R > 32).  Padding slots (value 0) are skipped after one 4-byte read.
//
// Bound.  Bytes: per live nonzero the coordinates and value are read once
// and (N-1)·R factor values are gathered, for (N-1)·R multiplies and R
// atomic adds; far below the card's arithmetic rate.  The factor matrices at R = 10 are
// a few MB and stay in the 50 MB L2, so the stream of coordinates and
// values plus the atomics into the partial blocks set the time.  Staging a
// task's factor blocks and its partial block in shared memory, and fusing
// the global sum, are left to a later change.
//
// Built by kernels/_build.py with nvcc into a shared library with a plain C
// interface; kernels/mttkrp_kernel.py calls it through ctypes.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kTile = 1024;  // slots per block

__device__ __forceinline__ long long min_ll(long long a, long long b) { return a < b ? a : b; }

// meta is (3, N) int64: factor address, factor rows, chunk size S_m per mode.
__global__ void __launch_bounds__(kThreads)
mttkrp_local_kernel(const int32_t* __restrict__ task_chunk,  // (T, N)
                    const int32_t* __restrict__ coords_rel,  // (T, P, N)
                    const float* __restrict__ values,        // (T, P)
                    const long long* __restrict__ meta,      // (3, N)
                    float* __restrict__ local,               // (T, S_mode, R)
                    long long P, int N, int R, int mode,
                    long long tiles_per_task, int group) {
    extern __shared__ long long smeta[];
    for (int i = threadIdx.x; i < 3 * N; i += blockDim.x) smeta[i] = meta[i];
    __syncthreads();

    const long long t = blockIdx.x / tiles_per_task;
    const long long p_begin = (blockIdx.x % tiles_per_task) * kTile;
    const long long p_end = min_ll(P, p_begin + kTile);
    const int lane = threadIdx.x % group;
    const int n_groups = blockDim.x / group;
    const long long s_out = smeta[2 * N + mode];
    const int32_t* tc = task_chunk + t * N;
    float* out = local + t * s_out * R;

    for (long long p = p_begin + threadIdx.x / group; p < p_end; p += n_groups) {
        const long long e = t * P + p;
        const float v = values[e];
        if (v == 0.0f) continue;  // padding slot
        const int32_t* c = coords_rel + e * N;
        const long long co = c[mode];
        if (co < 0 || co >= s_out) continue;  // dropped, as the scatter drops it
        for (int r = lane; r < R; r += group) {
            float acc = v;
            for (int m = 0; m < N; ++m) {
                if (m == mode) continue;
                const float* f = reinterpret_cast<const float*>(smeta[m]);
                const long long row = min_ll(
                    static_cast<long long>(tc[m]) * smeta[2 * N + m] + c[m], smeta[N + m] - 1);
                acc *= __ldg(f + row * R + r);
            }
            atomicAdd(out + co * R + r, acc);
        }
    }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
// Allocates nothing and does not synchronise.
int prism_mttkrp_local_f32(const void* task_chunk, const void* coords_rel, const void* values,
                           const void* meta, void* local, long long T, long long P, int N, int R,
                           int mode, void* stream) {
    int group = 1;
    while (group < R && group < 32) group *= 2;
    const long long tiles_per_task = (P + kTile - 1) / kTile;
    const long long blocks = T * tiles_per_task;
    if (blocks < 1 || blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
    const size_t smem = 3 * static_cast<size_t>(N) * sizeof(long long);
    mttkrp_local_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(task_chunk), static_cast<const int32_t*>(coords_rel),
        static_cast<const float*>(values), static_cast<const long long*>(meta),
        static_cast<float*>(local), P, N, R, mode, tiles_per_task, group);
    return static_cast<int>(cudaGetLastError());
}

const char* prism_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
