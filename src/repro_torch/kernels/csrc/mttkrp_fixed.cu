// Chunked spMTTKRP, fixed point (paper Algorithm 2), int32 sums, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/mttkrp_fixed_kernel.py::mttkrp_fixed_pallas_local (body
// `_kernel`).  Same contract: for every task t and live slot p with a
// nonzero qvalue, gather each input mode's row at task_chunk[t, m] * S_m +
// coords_rel[t, p, m] (clamped to the factor's last row); the first input
// mode's row is the partial, each later one multiplies it and an arithmetic
// `>> matrix_frac` follows each multiply, in mode order; then `* qvalue` and
// `>> (value_frac + prec_shift)`; the result is added into row
// coords_rel[t, p, mode] of the task's (S_mode, R) int32 block (rows outside
// [0, S_mode) are dropped).  The TPU kernel returns those blocks, local
// (T, S_mode, R) int32; this one adds each straight into the (I_pad, R)
// int32 output at rows task_chunk[t, mode] * S_mode + [0, S_mode).
//
// Arithmetic.  XLA's int32 multiply wraps, and signed overflow is undefined
// in C++, so every product is formed in uint32_t and cast back to int32_t
// (two's complement, as nvcc defines it) before the shift, which is
// arithmetic on signed ints.  Integer addition is associative modulo 2^32,
// so the output equals the plain version's bit for bit in any order, in
// shared memory, across the blocks that share a task and across the tasks
// that share an output row alike.  A slot
// whose qvalue is 0 (padding, or a value that quantized to 0) is skipped:
// its partial is 0 * x >> k = 0.
//
// Design.  The float kernel's tiling (csrc/mttkrp_tiles.cuh; design notes
// in csrc/mttkrp.cu) with this arithmetic as its policy: a block owns a
// task, accumulates its (S_mode, R) int32 block in shared memory with the
// native int32 shared atomic (so it keeps the flattened mapping in every
// mode: combining runs of equal rows first measured slower here), stages
// the input factor blocks at their storage width (int8 for Q5.3, int16 for
// Q9.7, int32 for Q17.15) as long as the budget lasts, streams coordinates
// and qvalues (int16 or int32) through a cp.async ring and stops at the
// task's live count; tier `global` adds one int32 atomicAdd in device
// memory per run of slots on one output row and per r.
//
// Bound.  Per live nonzero, 4·N bytes of coordinates and 2 of qvalue are
// read once, plus the input factors at their storage width and the
// (I_pad, R) int32 output written once.  At NELL-2's published size
// (76.9 M nonzeros, R = 10, the 256 KiB plan) that is about 1.3 GB per mode,
// 0.40 ms at 3.35 TB/s; coordinates are 12 of the 14 bytes per nonzero.  The
// integer work, (2·(N-1) + 1)·R multiplies, shifts and adds per nonzero
// (3.8 G per mode there), takes 0.23 ms at the 16.7 T int32 operations/s of
// 132 SMs × 64 INT32 lanes × 1.98 GHz (Hopper white paper), so bytes bound
// it; the task tiers stay above it for the float kernel's reason, the
// shared-memory work per (nonzero, r) pair.
//
// Built by kernels/_build.py with nvcc into a shared library with a plain C
// interface; kernels/mttkrp_fixed_kernel.py calls it through ctypes.

#include "mttkrp_tiles.cuh"

namespace {

// The int32 product as XLA forms it: modulo 2^32.
__device__ __forceinline__ int32_t wrap_mul(int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

template <typename F, typename V>
struct FixedPolicy {
    using Factor = F;
    using Value = V;
    using Acc = int32_t;
    using Elem = int32_t;
    // Shared-memory int32 atomics are native (ATOMS.ADD): the flattened
    // mapping is faster than combining runs even where rows repeat.
    static constexpr bool kRuns = false;
    int matrix_frac;
    int out_shift;  // value_frac + prec_shift
    __device__ static int32_t widen(F x) { return static_cast<int32_t>(x); }
    __device__ int32_t begin(V) const { return 0; }
    __device__ int32_t mul(int32_t p, int32_t x, bool first) const {  // Alg. 2 l.9-12
        return first ? x : (wrap_mul(p, x) >> matrix_frac);
    }
    __device__ int32_t finish(int32_t p, V v) const {  // Alg. 2 l.14-15
        return wrap_mul(p, static_cast<int32_t>(v)) >> out_shift;
    }
    __device__ int32_t add(int32_t a, int32_t b) const {  // modulo 2^32, as the atomics add
        return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
    }
};

struct Args {
    const void *task_chunk, *coords_rel, *qvalues, *meta, *nnz_per_task;
    void* out;
    long long T, P;
    int N, R, mode;
    const long long* chunk;
    int tier;
    long long bpt;
    unsigned staged_mask;
    long long smem_bytes;
    cudaStream_t stream;
};

template <typename F, typename V>
int launch_typed(const Args& a, int matrix_frac, int out_shift) {
    return prism::launch(a.task_chunk, a.coords_rel, a.qvalues, a.meta, a.nnz_per_task, a.out,
                         a.T, a.P, a.N, a.R, a.mode, a.chunk, a.tier, a.bpt, a.staged_mask,
                         a.smem_bytes, FixedPolicy<F, V>{matrix_frac, out_shift},
                         a.stream);
}

template <typename F>
int launch_values(int value_bytes, const Args& a, int matrix_frac, int out_shift) {
    switch (value_bytes) {
        case 2:
            return launch_typed<F, int16_t>(a, matrix_frac, out_shift);
        case 4:
            return launch_typed<F, int32_t>(a, matrix_frac, out_shift);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

extern "C" {

// Launches tier `tier` (0 global, 1 accumulator, 2 staged) on `stream` for
// factors stored in `factor_bytes` (1, 2 or 4) and qvalues in `value_bytes`
// (2 or 4); `chunk` is the host's (N,) int64 chunk shape, the output as in
// csrc/mttkrp.cu and out_shift = value_frac + prec_shift.  Returns a
// cudaError_t (0 = launched) or -1 when `smem_bytes` disagrees with the
// kernel's layout.  Allocates nothing and does not synchronise.
int prism_mttkrp_fixed_local(const void* task_chunk, const void* coords_rel, const void* qvalues,
                             const void* meta, const void* nnz_per_task, void* out, long long T,
                             long long P, int N, int R, int mode, const long long* chunk,
                             int tier, long long bpt, unsigned staged_mask, long long smem_bytes,
                             int matrix_frac, int out_shift, int factor_bytes, int value_bytes,
                             void* stream) {
    const Args a{task_chunk, coords_rel, qvalues, meta, nnz_per_task, out, T, P, N, R, mode,
                 chunk, tier, bpt, staged_mask, smem_bytes, static_cast<cudaStream_t>(stream)};
    switch (factor_bytes) {
        case 1:
            return launch_values<int8_t>(value_bytes, a, matrix_frac, out_shift);
        case 2:
            return launch_values<int16_t>(value_bytes, a, matrix_frac, out_shift);
        case 4:
            return launch_values<int32_t>(value_bytes, a, matrix_frac, out_shift);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

const char* prism_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
