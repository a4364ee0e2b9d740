// The tiling shared by the float and the fixed-point chunked spMTTKRP
// kernels (csrc/mttkrp.cu, csrc/mttkrp_fixed.cu).  The arithmetic is a
// policy (a struct with `begin`, `mul`, `finish`, `add` and the flag
// `kRuns`): float multiply and add, or paper Alg. 2's wrapped int32
// products and shifts with int32 adds.
//
// Contract (both kernels): for every task t and live slot p, the partial
// of slot p is formed from its value and, in mode order, each input mode
// m's factor row task_chunk[t, m] * S_m + coords_rel[t, p, m], clamped to
// the factor's last row; it is added into row coords_rel[t, p, mode] of
// the task's (S_mode, R) block, and dropped when that row is outside
// [0, S_mode).  Slots whose value is 0 add nothing and are skipped.  A slot
// at or past nnz_per_task[t] (when given) is not read: the caller
// guarantees it holds 0.  Output: the (I_pad, R) MTTKRP itself, block t
// added into rows task_chunk[t, mode] * S_mode + [0, S_mode) of the
// zero-filled output that kernels/ops.py allocates.  The TPU kernel's
// per-task (T, S_mode, R) partials are the plain version's
// (kernels/ref.py::mttkrp_local_ref; their sum is kernels/ref.py::reduce_local).
//
// Three tiers, chosen on the host from the shapes by
// kernels/tiles.py::plan_launch, which mirrors `task_smem_bytes` below:
//
//   staged       one block of kThreads threads owns a task (or a part of
//                it, `bpt` blocks per task); the task's (S_mode, R) block
//                is accumulated in shared memory with shared-memory atomics
//                and each staged input mode's (S_m, R) factor block is
//                copied into shared memory once, in mode order as long as
//                the budget lasts.  A coordinate outside [0, S_m) reads the
//                clamped row from device memory, as the plain version does.
//   accumulator  the same without staged factor blocks: rows are gathered
//                from device memory (they sit in L2).
//   global       nothing fits: lanes grouped over r, each group walking a
//                contiguous share of the slots and adding its partials into
//                the zero-filled output with device-memory atomics, one per
//                run of slots that share an output row and per r.
//
// In the two task tiers the task's coordinates and values stream through a
// double-buffered ring in shared memory with 16-byte `cp.async` copies, so
// the next kRing slots load while the warps work on these.  coords_rel[t]
// starts at byte 12·t·P and values[t] at 4·t·P (2·t·P for int16 qvalues),
// which are not 16-byte aligned in general, so each copy is aligned down
// to 16 bytes and the consumer skips the head.  The copies read whole
// 16-byte-aligned chunks that each hold a byte of the range, so they never
// cross a page; `cp.async.bulk` (TMA's 1-D form) would also need the
// size to be a multiple of 16 and an mbarrier per stage for no gain here.
// Threads walk the (slot, r) pairs of a tile flattened, so at R = 10 no
// lane idles.  At the end a block adds the non-zero entries of its
// accumulator into the zero-filled output with device-memory atomics,
// coalesced, at its task's rows.  Device atomics keep the fixed-point kernel
// bit-exact (int32 addition is associative modulo 2^32).  The output takes
// the place of the (T, S_mode, R) partials and their sum, which at FROSTT
// Delicious's size would be 738-858 GB a mode.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace prism {

constexpr int kThreads = 512;            // task tiers: threads per block
constexpr int kRing = 512;               // task tiers: slots per ring stage
constexpr int kGlobalThreads = 256;      // global tier
constexpr long long kGlobalTile = 1024;  // global tier: slots per block
constexpr int kLayoutMismatch = -1;      // returned when the host's plan disagrees
static_assert(kRing == kThreads, "the run count gives each thread one slot of a tile");

enum Tier { kGlobal = 0, kAccumulator = 1, kStaged = 2 };

// One mode of the task a block owns, kept in shared memory.
struct ModeInfo {
    const void* factor;  // device address of the (rows, R) factor
    long long base;      // first global row of the task's chunk: task_chunk[t, m] * S_m
    long long last;      // rows - 1: every gather clamps to it
    int size;            // chunk size S_m
    int staged;          // byte offset of the staged (S_m, R) block in shared memory, or -1
};
static_assert(sizeof(ModeInfo) == 32, "ModeInfo layout");

__host__ __device__ __forceinline__ long long align16(long long x) { return (x + 15) & ~15LL; }

// Bytes of one ring stage: the coordinates and the values of kRing slots,
// each with room for the 16-byte alignment of both ends.
__host__ __device__ __forceinline__ long long ring_coord_bytes(int n_modes) {
    return align16(4LL * kRing * n_modes) + 32;
}
__host__ __device__ __forceinline__ long long ring_value_bytes(int value_bytes) {
    return align16(static_cast<long long>(kRing) * value_bytes) + 32;
}
__host__ __device__ __forceinline__ long long tab_bytes(int n_modes) {
    return align16(static_cast<long long>(sizeof(ModeInfo)) * n_modes);
}

// Dynamic shared memory of a task-tier launch: mode table, two ring
// stages, the (S_mode, R) accumulator, then each staged factor block.
inline long long task_smem_bytes(const long long* chunk, int n_modes, int rank, int mode,
                                 unsigned staged_mask, int factor_bytes, int value_bytes,
                                 int acc_bytes) {
    long long bytes = tab_bytes(n_modes)
                      + 2 * (ring_coord_bytes(n_modes) + ring_value_bytes(value_bytes))
                      + align16(chunk[mode] * rank * acc_bytes);
    for (int m = 0; m < n_modes && m < 32; ++m)
        if ((staged_mask >> m) & 1u) bytes += align16(chunk[m] * rank * factor_bytes);
    return bytes;
}

__device__ __forceinline__ long long min_ll(long long a, long long b) { return a < b ? a : b; }
__device__ __forceinline__ long long max_ll(long long a, long long b) { return a > b ? a : b; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {  // all but the newest group landed
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Starts the block's copy of `nbytes` from `src` into `dst` (16-byte
// aligned), aligned down to 16 bytes; the data begins at dst + (src & 15).
__device__ __forceinline__ void copy_async(unsigned char* dst, const void* src, long long nbytes) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(src);
    const uintptr_t a0 = a & ~static_cast<uintptr_t>(15);
    const int chunks = static_cast<int>((a - a0 + nbytes + 15) / 16);
    for (int i = threadIdx.x; i < chunks; i += blockDim.x)
        cp_async16(dst + 16 * i, reinterpret_cast<const unsigned char*>(a0) + 16 * i);
}

template <typename T>
__device__ __forceinline__ const T* skip_head(const unsigned char* stage, const void* src) {
    return reinterpret_cast<const T*>(stage + (reinterpret_cast<uintptr_t>(src) & 15));
}

// Task tiers.  Block b owns part (b % bpt) of task (b / bpt): an equal
// share of the task's live slots.  meta is (3, N) int64: factor address,
// factor rows, chunk size per mode.  kN > 0 fixes the number of modes at
// compile time (the mode loop unrolls and the mode table sits in
// registers); kN = 0 takes it from n_modes.
template <class Pol, int kN>
__global__ void __launch_bounds__(kThreads, 2)
task_kernel(const int32_t* __restrict__ task_chunk,              // (T, N)
            const int32_t* __restrict__ coords_rel,              // (T, P, N)
            const typename Pol::Value* __restrict__ values,      // (T, P)
            const long long* __restrict__ meta,                  // (3, N)
            const int32_t* __restrict__ nnz_per_task,            // (T,) or null
            typename Pol::Acc* __restrict__ out,                 // (I_pad, R)
            long long P, int n_modes, int R, int mode, int bpt, unsigned staged_mask,
            Pol pol) {
    using F = typename Pol::Factor;
    using V = typename Pol::Value;
    using A = typename Pol::Acc;
    const int N = kN > 0 ? kN : n_modes;
    extern __shared__ __align__(16) unsigned char smem[];

    const long long t = blockIdx.x / bpt;
    const long long part = blockIdx.x % bpt;
    long long live = P;
    if (nnz_per_task != nullptr) live = max_ll(0, min_ll(P, nnz_per_task[t]));
    const long long span = (live + bpt - 1) / bpt;
    const long long s_begin = part * span;
    const long long s_end = min_ll(live, s_begin + span);
    if (s_begin >= s_end) return;  // adds nothing

    ModeInfo* tab = reinterpret_cast<ModeInfo*>(smem);
    const long long stage_c = ring_coord_bytes(N);
    const long long stage_bytes = stage_c + ring_value_bytes(sizeof(V));
    unsigned char* ring = smem + tab_bytes(N);
    A* acc = reinterpret_cast<A*>(ring + 2 * stage_bytes);
    const int s_out = static_cast<int>(meta[2 * N + mode]);
    const int n_acc = s_out * R;
    const int32_t* cbase = coords_rel + t * P * N;
    const V* vbase = values + t * P;

    auto issue = [&](int stage, long long s0) {
        const long long ns = min_ll(kRing, s_end - s0);
        if (ns <= 0) return;
        unsigned char* st = ring + stage * stage_bytes;
        copy_async(st, cbase + s0 * N, ns * N * 4);
        copy_async(st + stage_c, vbase + s0, ns * static_cast<long long>(sizeof(V)));
    };
    issue(0, s_begin);  // lands while the block sets up
    cp_async_commit();

    if (threadIdx.x == 0) {
        long long off = tab_bytes(N) + 2 * stage_bytes + align16(sizeof(A) * n_acc);
        for (int m = 0; m < N; ++m) {
            ModeInfo d;
            d.factor = reinterpret_cast<const void*>(meta[m]);
            d.size = static_cast<int>(meta[2 * N + m]);
            d.base = static_cast<long long>(task_chunk[t * N + m]) * d.size;
            d.last = meta[N + m] - 1;
            d.staged = -1;
            if (m < 32 && ((staged_mask >> m) & 1u)) {
                d.staged = static_cast<int>(off);
                off += align16(static_cast<long long>(d.size) * R * sizeof(F));
            }
            tab[m] = d;
        }
    }
    for (int i = threadIdx.x; i < n_acc; i += kThreads) acc[i] = A(0);
    __syncthreads();
    for (int m = 0; m < N; ++m) {
        const ModeInfo d = tab[m];
        if (d.staged < 0) continue;
        F* dst = reinterpret_cast<F*>(smem + d.staged);
        const F* src = static_cast<const F*>(d.factor);
        const long long first = d.base * R, end = (d.last + 1) * R;
        const int n = d.size * R;
#pragma unroll 4
        for (int i = threadIdx.x; i < n; i += kThreads) {
            long long e = first + i;
            if (e >= end) e = end - R + i % R;  // rows past the last clamp to it
            dst[i] = __ldg(src + e);
        }
    }

    ModeInfo md[kN > 0 ? kN : 1];
    if constexpr (kN > 0) {
#pragma unroll
        for (int m = 0; m < kN; ++m) md[m] = tab[m];
    }
    // The partial of one (slot, r) pair, in mode order.
    auto partial = [&](const int32_t* c, int r, V v) {
        auto p = pol.begin(v);
        bool first = true;
        auto step = [&](const ModeInfo& d, int m) {
            if (m == mode) return;
            const int cm = c[m];
            typename Pol::Elem x;
            if (d.staged >= 0 && static_cast<unsigned>(cm) < static_cast<unsigned>(d.size)) {
                x = Pol::widen(reinterpret_cast<const F*>(smem + d.staged)[cm * R + r]);
            } else {
                const long long row = min_ll(d.base + cm, d.last);
                x = Pol::widen(__ldg(static_cast<const F*>(d.factor) + row * R + r));
            }
            p = pol.mul(p, x, first);
            first = false;
        };
        if constexpr (kN > 0) {
#pragma unroll
            for (int m = 0; m < kN; ++m) step(md[m], m);
        } else {
            for (int m = 0; m < N; ++m) step(tab[m], m);
        }
        return pol.finish(p, v);
    };

    // Two mappings of threads to a tile's (slot, r) pairs.  Flattened:
    // thread i takes pairs i, i + kThreads, ..., two at a time (their loads
    // overlap).  Runs (policies with kRuns): R threads per group of
    // consecutive slots, each walking its group's slots for one r and
    // adding a partial into shared memory only where the output row
    // changes.  Where consecutive slots share output rows (the chunked
    // layout keeps each task's nonzeros in the tensor's order, so mode 0 of
    // a lexicographically sorted tensor has runs of about S_1·S_2·density)
    // that saves most shared-memory atomics and their same-address retries.
    // A block counts the runs of its first tile and takes the runs mapping
    // for all its tiles when they average 4 slots or more.
    const int slot0 = threadIdx.x / R, r0 = threadIdx.x % R;
    const int dslot = kThreads / R, dr = kThreads % R;
    const int groups = kThreads / R;  // runs mapping: 0 when R > kThreads
    bool runs = false;
    const long long n_tiles = (s_end - s_begin + kRing - 1) / kRing;
    for (long long k = 0; k < n_tiles; ++k) {
        const long long s0 = s_begin + k * kRing;
        issue(static_cast<int>((k + 1) & 1), s0 + kRing);
        cp_async_commit();
        cp_async_wait_one();
        __syncthreads();
        const unsigned char* st = ring + (k & 1) * stage_bytes;
        const int32_t* rc = skip_head<int32_t>(st, cbase + s0 * N);
        const V* rv = skip_head<V>(st + stage_c, vbase + s0);
        const int ns = static_cast<int>(min_ll(kRing, s_end - s0));
        if (Pol::kRuns && k == 0 && groups > 0) {  // the first tile decides
            const int j = threadIdx.x;  // one slot per thread (kRing == kThreads)
            const int n_runs = __syncthreads_count(
                j < ns && (j == 0 || rc[j * N + mode] != rc[(j - 1) * N + mode]));
            runs = 4 * n_runs <= ns;  // runs of 4 slots or more on average
        }
        if (runs) {
            const int g = threadIdx.x / R, r = threadIdx.x % R;
            const int len = (ns + groups - 1) / groups;
            const int j1 = min(ns, (g + 1) * len);
            A run = A(0);
            int run_row = -1;
            for (int jj = g * len; g < groups && jj < j1; ++jj) {
                const V v = rv[jj];
                const int32_t* c = rc + jj * N;
                const int co = c[mode];
                if (v == V(0) || static_cast<unsigned>(co) >= static_cast<unsigned>(s_out))
                    continue;
                const A p = partial(c, r, v);
                if (co == run_row) {
                    run = pol.add(run, p);
                } else {
                    if (run_row >= 0) atomicAdd(acc + run_row * R + r, run);
                    run = p;
                    run_row = co;
                }
            }
            if (run_row >= 0) atomicAdd(acc + run_row * R + r, run);
        } else {
            const int n_pairs = ns * R;
            int slot = slot0, r = r0;
#pragma unroll 2
            for (int i = threadIdx.x; i < n_pairs; i += kThreads) {
                const V v = rv[slot];
                const int32_t* c = rc + slot * N;
                const int co = c[mode];
                if (v != V(0) && static_cast<unsigned>(co) < static_cast<unsigned>(s_out))
                    atomicAdd(acc + co * R + r, partial(c, r, v));
                slot += dslot;
                r += dr;
                if (r >= R) {
                    r -= R;
                    ++slot;
                }
            }
        }
        __syncthreads();  // the next tile's issue refills this stage
    }

    __syncthreads();
    // tab[mode].base is the task's first output row, task_chunk[t, mode] * S_mode
    A* dst = out + tab[mode].base * R;
    for (int i = threadIdx.x; i < n_acc; i += kThreads)
        if (acc[i] != A(0)) atomicAdd(dst + i, acc[i]);
}

// Global tier.  The grid is (task, tile of kGlobalTile slots) flattened;
// lanes are cut into groups of `group` = min(32, next power of two >= R),
// and each group walks a contiguous share of the tile's slots, its lanes
// over r (r = lane, lane + group, ...).  Rows are read by index from device
// memory.  A lane sums the partials of consecutive slots that share an
// output row in a register and adds the run into the zero-filled output with
// one device atomic where the row changes: under a Zipf pattern one row can
// hold a quarter of a mode's nonzeros, and each atomic on it waits for the
// last at the same address.  The slots keep the tensor's lexicographic order
// inside a task, so the hot row of mode m forms runs wherever the modes
// before m repeat.
template <class Pol>
__global__ void __launch_bounds__(kGlobalThreads)
global_kernel(const int32_t* __restrict__ task_chunk, const int32_t* __restrict__ coords_rel,
              const typename Pol::Value* __restrict__ values, const long long* __restrict__ meta,
              const int32_t* __restrict__ nnz_per_task, typename Pol::Acc* __restrict__ out,
              long long P, int N, int R, int mode, long long tiles_per_task, int group,
              Pol pol) {
    using F = typename Pol::Factor;
    using A = typename Pol::Acc;
    extern __shared__ long long smeta[];
    for (int i = threadIdx.x; i < 3 * N; i += blockDim.x) smeta[i] = meta[i];
    __syncthreads();

    const long long t = blockIdx.x / tiles_per_task;
    long long live = P;
    if (nnz_per_task != nullptr) live = max_ll(0, min_ll(P, nnz_per_task[t]));
    const long long p_begin = (blockIdx.x % tiles_per_task) * kGlobalTile;
    const long long p_end = min_ll(live, p_begin + kGlobalTile);
    const int lane = threadIdx.x % group;
    const int n_groups = blockDim.x / group;
    const long long span = (max_ll(0, p_end - p_begin) + n_groups - 1) / n_groups;
    const long long g_begin = p_begin + (threadIdx.x / group) * span;
    const long long g_end = min_ll(p_end, g_begin + span);
    const long long s_out = smeta[2 * N + mode];
    const int32_t* tc = task_chunk + t * N;
    A* dst = out + static_cast<long long>(tc[mode]) * s_out * R;

    for (int r = lane; r < R; r += group) {
        A run = A(0);
        long long run_row = -1;
        for (long long p = g_begin; p < g_end; ++p) {
            const long long e = t * P + p;
            const auto v = values[e];
            if (v == 0) continue;
            const int32_t* c = coords_rel + e * N;
            const long long co = c[mode];
            if (co < 0 || co >= s_out) continue;  // dropped, as the scatter drops it
            auto acc = pol.begin(v);
            bool first = true;
            for (int m = 0; m < N; ++m) {
                if (m == mode) continue;
                const F* f = reinterpret_cast<const F*>(smeta[m]);
                const long long row = min_ll(
                    static_cast<long long>(tc[m]) * smeta[2 * N + m] + c[m], smeta[N + m] - 1);
                acc = pol.mul(acc, Pol::widen(__ldg(f + row * R + r)), first);
                first = false;
            }
            const A partial = pol.finish(acc, v);
            if (co == run_row) {
                run = pol.add(run, partial);
            } else {
                if (run_row >= 0) atomicAdd(dst + run_row * R + r, run);
                run = partial;
                run_row = co;
            }
        }
        if (run_row >= 0) atomicAdd(dst + run_row * R + r, run);
    }
}

// Launches one tier on `stream`.  `chunk` (host, N int64) is the chunk
// shape; `smem_bytes` is the host plan's dynamic shared memory, held here
// against the kernel's own layout (kLayoutMismatch when they differ).
// Returns a cudaError_t (0 = launched); allocates nothing, does not
// synchronise.
template <class Pol>
int launch(const void* task_chunk, const void* coords_rel, const void* values, const void* meta,
           const void* nnz_per_task, void* out, long long T, long long P, int N, int R,
           int mode, const long long* chunk, int tier, long long bpt, unsigned staged_mask,
           long long smem_bytes, Pol pol, cudaStream_t stream) {
    using V = typename Pol::Value;
    using A = typename Pol::Acc;
    const auto* tc = static_cast<const int32_t*>(task_chunk);
    const auto* cr = static_cast<const int32_t*>(coords_rel);
    const auto* vals = static_cast<const V*>(values);
    const auto* mt = static_cast<const long long*>(meta);
    const auto* nnz = static_cast<const int32_t*>(nnz_per_task);
    auto* dst = static_cast<A*>(out);
    if (tier == kGlobal) {
        int group = 1;
        while (group < R && group < 32) group *= 2;
        const long long tiles = (P + kGlobalTile - 1) / kGlobalTile;
        const long long blocks = T * tiles;
        if (blocks < 1 || blocks > INT_MAX || bpt != tiles)
            return static_cast<int>(cudaErrorInvalidConfiguration);
        if (smem_bytes != 3LL * N * static_cast<long long>(sizeof(long long)))
            return kLayoutMismatch;
        global_kernel<Pol><<<static_cast<unsigned>(blocks), kGlobalThreads, smem_bytes, stream>>>(
            tc, cr, vals, mt, nnz, dst, P, N, R, mode, tiles, group, pol);
        return static_cast<int>(cudaGetLastError());
    }
    if (tier != kAccumulator && tier != kStaged) return static_cast<int>(cudaErrorInvalidValue);
    if ((tier == kStaged) != (staged_mask != 0) || (mode < 32 && ((staged_mask >> mode) & 1u)))
        return kLayoutMismatch;  // the output mode's factor is never read, so never staged
    const long long blocks = T * bpt;
    if (bpt < 1 || bpt > INT_MAX || blocks < 1 || blocks > INT_MAX)
        return static_cast<int>(cudaErrorInvalidConfiguration);
    if (smem_bytes != task_smem_bytes(chunk, N, R, mode, staged_mask,
                                      sizeof(typename Pol::Factor), sizeof(V), sizeof(A)))
        return kLayoutMismatch;
    // The repository's tensors have 3, 4 or 5 modes; others take kN = 0.
    auto kernel = N == 3 ? task_kernel<Pol, 3>
                  : N == 4 ? task_kernel<Pol, 4>
                  : N == 5 ? task_kernel<Pol, 5>
                           : task_kernel<Pol, 0>;
    if (smem_bytes > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes));
        if (e != cudaSuccess) {
            cudaGetLastError();  // a refused attribute must not fail the next launch
            return static_cast<int>(e);
        }
    }
    kernel<<<static_cast<unsigned>(blocks), kThreads, smem_bytes, stream>>>(
        tc, cr, vals, mt, nnz, dst, P, N, R, mode, static_cast<int>(bpt), staged_mask, pol);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace prism
