// Chunked spMTTKRP, float path: the per-task partial blocks, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/mttkrp_kernel.py::mttkrp_pallas_local
// (body `_kernel`).  Same contract: for every task t and live slot p with a
// nonzero value, multiply the value by the input-mode factor rows at
// task_chunk[t, m] * S_m + coords_rel[t, p, m] (clamped to the factor's last
// row), in mode order, and add the product into row coords_rel[t, p, mode]
// of the task's private (S_mode, R) block.  Output: local (T, S_mode, R)
// f32.  The global sum of the blocks stays outside, in PyTorch
// (kernels/ref.py::reduce_local).
//
// Design (csrc/mttkrp_tiles.cuh).  The TPU kernel runs one grid step per
// task, fetches each input mode's (S_m, R) block once through its
// BlockSpec, keeps the output block in VMEM and turns gathers and scatters
// into one-hot matrix products.  Here a block of 512 threads owns a task,
// or an equal share of a task's live slots when few tasks must fill 132
// SMs (blocks per task, chosen on the host).  It accumulates the
// (S_mode, R) block in shared memory, stages the input modes' factor
// blocks in shared memory as long as the budget lasts (tier `staged`; tier
// `accumulator` gathers them from L2), streams the task's coordinates and
// values through a double-buffered `cp.async` ring, stops at the task's
// live count `nnz_per_task[t]`, and writes the block once.  Threads walk
// the (slot, r) pairs flattened, two at a time, so that no lane idles at
// R = 10.  A shared-memory float atomicAdd is a compare-and-swap loop on
// sm_90 (ATOMS.CAST.SPIN in the SASS), which retries whenever lanes of a
// warp hit one address; mode 0 of a lexicographically sorted tensor puts
// runs of ~12 consecutive slots on one output row, so where a block's first
// tile shows such runs its threads sum each run in a register and issue
// one atomic per run.  Tier `global` (nothing fits in shared memory) is the
// first design: lane groups over r and one device-memory atomicAdd per
// (nonzero, r), 769 M per mode at NELL-2's size.
//
// Bound.  Bytes: per live nonzero the coordinates and value are read once
// (16 B at N = 3), each input factor once, each block written once: 0.42–
// 0.46 ms per mode at NELL-2's published size (76.9 M nonzeros, R = 10,
// the 256 KiB plan) at 3.35 TB/s.  The (N-1)·R multiplies and R adds per
// nonzero are far below the card's float32 rate.  What keeps the task
// tiers above the bytes bound is the shared-memory work per (nonzero, r)
// pair: the staged-row reads, which conflict in banks when a warp's rows
// overlap, and the atomic, each on the pair's dependent chain.
//
// Built by kernels/_build.py with nvcc into a shared library with a plain C
// interface; kernels/mttkrp_kernel.py calls it through ctypes.

#include "mttkrp_tiles.cuh"

namespace {

struct FloatPolicy {
    using Factor = float;
    using Value = float;
    using Acc = float;
    using Elem = float;
    // A shared-memory float atomicAdd is a compare-and-swap loop on sm_90
    // (ATOMS.CAST.SPIN), which retries when lanes hit one address: combine
    // runs of equal output rows first.
    static constexpr bool kRuns = true;
    __device__ static float widen(float x) { return x; }
    __device__ float begin(float v) const { return v; }
    __device__ float mul(float p, float x, bool) const { return p * x; }  // mode order
    __device__ float finish(float p, float) const { return p; }
    __device__ float add(float a, float b) const { return a + b; }
};

}  // namespace

extern "C" {

// Launches tier `tier` (0 global, 1 accumulator, 2 staged) on `stream`;
// `chunk` is the host's (N,) int64 chunk shape.  Returns a cudaError_t
// (0 = launched) or -1 when `smem_bytes` disagrees with the kernel's
// layout.  Allocates nothing and does not synchronise.
int prism_mttkrp_local_f32(const void* task_chunk, const void* coords_rel, const void* values,
                           const void* meta, const void* nnz_per_task, void* local, long long T,
                           long long P, int N, int R, int mode, const long long* chunk, int tier,
                           long long bpt, unsigned staged_mask, long long smem_bytes,
                           void* stream) {
    return prism::launch(task_chunk, coords_rel, values, meta, nnz_per_task, local, T, P, N, R,
                         mode, chunk, tier, bpt, staged_mask, smem_bytes, FloatPolicy{},
                         static_cast<cudaStream_t>(stream));
}

const char* prism_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
