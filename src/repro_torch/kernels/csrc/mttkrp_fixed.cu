// Chunked spMTTKRP, fixed point (paper Algorithm 2): the per-task int32
// partial blocks, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/mttkrp_fixed_kernel.py::mttkrp_fixed_pallas_local (body
// `_kernel`).  Same contract: for every task t and slot p with a nonzero
// qvalue, gather each input mode's row at task_chunk[t, m] * S_m +
// coords_rel[t, p, m] (clamped to the factor's last row); the first input
// mode's row is the partial, each later one multiplies it and an arithmetic
// `>> matrix_frac` follows each multiply, in mode order; then `* qvalue` and
// `>> (value_frac + prec_shift)`; the result is added into row
// coords_rel[t, p, mode] of the task's (S_mode, R) int32 block (rows outside
// [0, S_mode) are dropped).  Output: local (T, S_mode, R) int32, zero-filled
// by the caller; the global sum stays in PyTorch (kernels/ref.py::reduce_local).
//
// Arithmetic.  XLA's int32 multiply wraps, and signed overflow is undefined
// in C++, so every product is formed in uint32_t and cast back to int32_t
// (two's complement, as nvcc defines it) before the shift, which is
// arithmetic on signed ints.  Integer atomicAdd is associative modulo 2^32,
// so the blocks equal the plain version's bit for bit in any order.  A slot
// whose qvalue is 0 (padding, or a value that quantized to 0) is skipped:
// its partial is 0 * x >> k = 0.
//
// Design.  The TPU kernel runs one grid step per task and turns every gather
// and scatter into a one-hot integer matrix product, because the TPU has no
// cheap random access.  This kernel keeps the float kernel's structure
// (csrc/mttkrp.cu): rows are read by index from device memory and the
// partials go out with atomicAdd; the grid is (task, tile of kTile slots)
// flattened, so one task holding every nonzero (T = 1) still fills the card;
// lanes are grouped over r; a pinned int64 meta table carries the factor
// addresses, row counts and chunk sizes.  It is templated on the stored
// factor type (int8 for Q5.3, int16 for Q9.7, int32 for Q17.15) and the
// qvalue type (int16 or int32), and reads them at that width.
//
// Bound.  Per live nonzero, 4·N bytes of coordinates and 2 of qvalue are
// read once, plus the input factors at their storage width and the
// (T, S_mode, R) int32 blocks written once.  At NELL-2's published size
// (76.9 M nonzeros, R = 10, the 256 KiB plan) that is about 1.3 GB per mode,
// 0.40 ms at 3.35 TB/s; coordinates are 12 of the 14 bytes per nonzero.  The
// integer work, (2·(N-1) + 1)·R multiplies, shifts and adds per nonzero
// (3.8 G per mode there), takes 0.23 ms at the 16.7 T int32 operations/s of
// 132 SMs × 64 INT32 lanes × 1.98 GHz (Hopper white paper), so bytes bound
// it.  Staging the task blocks in shared memory and stopping at the task's
// nonzero count are left to a later change.
//
// Built by kernels/_build.py with nvcc into a shared library with a plain C
// interface; kernels/mttkrp_fixed_kernel.py calls it through ctypes.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kTile = 1024;  // slots per block

__device__ __forceinline__ long long min_ll(long long a, long long b) { return a < b ? a : b; }

// The int32 product as XLA forms it: modulo 2^32.
__device__ __forceinline__ int32_t wrap_mul(int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

// meta is (3, N) int64: factor address, factor rows, chunk size S_m per mode.
template <typename F, typename V>
__global__ void __launch_bounds__(kThreads)
mttkrp_fixed_local_kernel(const int32_t* __restrict__ task_chunk,  // (T, N)
                          const int32_t* __restrict__ coords_rel,  // (T, P, N)
                          const V* __restrict__ qvalues,           // (T, P)
                          const long long* __restrict__ meta,      // (3, N)
                          int32_t* __restrict__ local,             // (T, S_mode, R)
                          long long P, int N, int R, int mode,
                          long long tiles_per_task, int group,
                          int matrix_frac, int out_shift) {
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
    int32_t* out = local + t * s_out * R;

    for (long long p = p_begin + threadIdx.x / group; p < p_end; p += n_groups) {
        const long long e = t * P + p;
        const int32_t v = static_cast<int32_t>(qvalues[e]);
        if (v == 0) continue;  // padding slot, or a value that quantized to 0
        const int32_t* c = coords_rel + e * N;
        const long long co = c[mode];
        if (co < 0 || co >= s_out) continue;  // dropped, as the scatter drops it
        for (int r = lane; r < R; r += group) {
            int32_t acc = 0;
            bool first = true;
            for (int m = 0; m < N; ++m) {
                if (m == mode) continue;
                const F* f = reinterpret_cast<const F*>(smeta[m]);
                const long long row = min_ll(
                    static_cast<long long>(tc[m]) * smeta[2 * N + m] + c[m], smeta[N + m] - 1);
                const int32_t x = static_cast<int32_t>(__ldg(f + row * R + r));
                acc = first ? x : (wrap_mul(acc, x) >> matrix_frac);  // Alg. 2 l.9-12
                first = false;
            }
            acc = wrap_mul(acc, v) >> out_shift;  // Alg. 2 l.14-15
            atomicAdd(out + co * R + r, acc);
        }
    }
}

template <typename F, typename V>
int launch(const void* task_chunk, const void* coords_rel, const void* qvalues, const void* meta,
           void* local, long long T, long long P, int N, int R, int mode, int matrix_frac,
           int out_shift, void* stream) {
    int group = 1;
    while (group < R && group < 32) group *= 2;
    const long long tiles_per_task = (P + kTile - 1) / kTile;
    const long long blocks = T * tiles_per_task;
    if (blocks < 1 || blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
    const size_t smem = 3 * static_cast<size_t>(N) * sizeof(long long);
    mttkrp_fixed_local_kernel<F, V><<<static_cast<unsigned>(blocks), kThreads, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(task_chunk), static_cast<const int32_t*>(coords_rel),
        static_cast<const V*>(qvalues), static_cast<const long long*>(meta),
        static_cast<int32_t*>(local), P, N, R, mode, tiles_per_task, group, matrix_frac,
        out_shift);
    return static_cast<int>(cudaGetLastError());
}

template <typename F>
int launch_values(int value_bytes, const void* task_chunk, const void* coords_rel,
                  const void* qvalues, const void* meta, void* local, long long T, long long P,
                  int N, int R, int mode, int matrix_frac, int out_shift, void* stream) {
    switch (value_bytes) {
        case 2:
            return launch<F, int16_t>(task_chunk, coords_rel, qvalues, meta, local, T, P, N, R,
                                      mode, matrix_frac, out_shift, stream);
        case 4:
            return launch<F, int32_t>(task_chunk, coords_rel, qvalues, meta, local, T, P, N, R,
                                      mode, matrix_frac, out_shift, stream);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` for factors stored in `factor_bytes`
// (1, 2 or 4) and qvalues in `value_bytes` (2 or 4); returns
// cudaGetLastError() (0 = launched).  Allocates nothing and does not
// synchronise.  out_shift = value_frac + prec_shift.
int prism_mttkrp_fixed_local(const void* task_chunk, const void* coords_rel, const void* qvalues,
                             const void* meta, void* local, long long T, long long P, int N,
                             int R, int mode, int matrix_frac, int out_shift, int factor_bytes,
                             int value_bytes, void* stream) {
    switch (factor_bytes) {
        case 1:
            return launch_values<int8_t>(value_bytes, task_chunk, coords_rel, qvalues, meta,
                                         local, T, P, N, R, mode, matrix_frac, out_shift, stream);
        case 2:
            return launch_values<int16_t>(value_bytes, task_chunk, coords_rel, qvalues, meta,
                                          local, T, P, N, R, mode, matrix_frac, out_shift, stream);
        case 4:
            return launch_values<int32_t>(value_bytes, task_chunk, coords_rel, qvalues, meta,
                                          local, T, P, N, R, mode, matrix_frac, out_shift, stream);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

const char* prism_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
