// Pseudo-inverse of a stack of symmetric positive semi-definite R×R float32
// matrices, for Hopper (sm_90a), with no host synchronisation.
//
// Ports `jnp.linalg.pinv` as CP-ALS calls it (src/repro/core/cpals.py,
// `jnp.linalg.pinv(v)` on V, the Hadamard product of the other modes'
// Gram matrices): it has no Pallas counterpart.  torch has no pinv, svd or
// eigh that leaves the host alone (each reads its info flag back), and CP-ALS
// runs one per mode: a wait on the host per mode, which holds the next
// mode's dispatch until the card has finished the MTTKRP before it.
//
// Contract: out[b] = Σ_k v_k v_kᵀ / λ_k over the eigenpairs of v[b] whose
// |λ_k| exceeds 10·R·eps(float32) times the largest |λ|.  V is symmetric, so
// its singular values are the |λ| and this is the function jnp's SVD-based
// pinv computes, with jnp's cutoff.  Only the upper triangle is read: the
// float32 Gram products can differ from their transposes in the last bit.
// A matrix holding a NaN, or a ±Inf off the diagonal, comes out all NaN; one
// with ±Inf only on the diagonal all zeros, as jnp's pinv answers both; such
// a matrix is flagged as it is loaded (a block vote or a warp ballot) and
// runs no rotation.
//
// Two designs, one contract.
//
// The warp tier (R ≤ 32, every rank CP-ALS and the serving path use).  One
// warp per matrix, several matrices per block, no block barrier and no
// shared memory.  One-sided (Hestenes) Jacobi in float64 on U = A·W, A the
// symmetrised V: lane i holds row i of U and of the rotation accumulator W
// in registers, W = R + R % 2 columns wide (the even width the kernel is
// instantiated at; a padded column is zero and never rotates).  Each round
// rotates the fixed column pairs (2j, 2j+1); between rounds the columns move
// one step along the round-robin cycle (`round_robin_source`), a fixed
// permutation of registers, so W-1 rounds meet every pair once and no
// register is ever indexed at run time.  A pair's ‖u_p‖², ‖u_q‖² and
// u_p·u_q are sums over the lanes, reduced and scattered by
// `__shfl_xor_sync` (the butterfly's pairing, so every lane that holds a
// sum holds the same bits); lane j gathers pair j's three and computes its
// rotation (the round's float64 chains side by side, one per lane), and
// shuffles hand every lane each pair's cosine and sine, to apply to its own
// row.  A pair rotates while |u_p·u_q| > eps(float64)·‖u_p‖·‖u_q‖ (the
// relative criterion in its one-sided form, compared squared) and neither
// column is below eps·‖A‖_F (numerically zero: it would be cut); the rounds
// stop once W-1 rounds in a row rotate nothing
// (every pair checked against the final U; a warp vote, `__ballot_sync`,
// makes it warp-uniform), or after kMaxSweeps sweeps.  Then
// λ_k = w_k·u_k (its sign kept) and out[i][j] = Σ_k (1/λ_k)·(w_ik·w_jk) over
// the kept k, summed in one order for (i, j) and (j, i): bitwise symmetric.
// Every float64 operation is an explicitly rounded intrinsic (never fused
// into a multiply-add) and square roots and divisions are correctly rounded,
// so `kernels/gram_pinv.py::jacobi_replay` repeats the arithmetic on the host
// bit for bit.
//
// The block tier (any R; the design of the first port).  One block per
// matrix.  Cyclic Jacobi in float64, in the round-robin order (R/2 disjoint
// pairs per round, R-1 rounds per sweep, each round's rotations applied
// together: columns of A and V, then rows of A), on A and the eigenvector
// matrix V held in shared memory.  A pair is rotated while |a_pq| >
// eps(float64)·sqrt(|a_pp·a_qq|); the sweeps stop when one rotates nothing,
// or after kMaxSweeps.  The result is formed from V and the kept 1/λ in
// float64 and written as float32, bitwise symmetric.  When A, V and the
// rotations do not fit the card's opt-in shared memory (R above 120 on the
// H100) the same kernel works from a global scratch buffer the wrapper
// allocates.
//
// Bound.  Bytes: one R×R float32 read and one written per matrix (2·R²·4 B),
// 0.0008 µs per matrix at R = 10 over 3.35 TB/s: nothing.  Operations, of
// the function and not of either design: a symmetric eigendecomposition with
// its vectors (about 9·R³ flops, the symmetric QR algorithm's count) and the
// product W·diag(1/λ)·Wᵀ (about R³), some 10⁴ flops per matrix at R = 10.
// A launch at CP-ALS's B = 1 is bound by the latency of its dependent rounds
// (the block tier: three block barriers each; the warp tier: one scattered
// sum over the lanes and one float64 rotation chain each, all issued by a
// single warp), not by a rate of the card.
//
// Built by kernels/_build.py with nvcc into a shared library with a plain C
// interface; kernels/gram_pinv.py calls it through ctypes.

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cmath>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxSweeps = 40;
constexpr int kLayoutMismatch = -1;

// Doubles of one matrix's work area: A, V, and one value per index
// (a pair's cosine and sine while rotating, the kept 1/λ at the end).
__host__ __device__ inline long long work_doubles(int R) {
    const long long m = R + (R & 1);
    return 2LL * R * R + m;
}

// Pair i of round k of the round-robin ordering of m (even) indices: index
// m-1 stays put and the others turn round it, so the R/2 pairs of a round
// are disjoint and the m-1 rounds meet every pair once.  p < q.
__device__ inline void pair_of(int k, int i, int m, int& p, int& q) {
    if (i == 0) {
        p = k;
        q = m - 1;
    } else {
        p = (k + i) % (m - 1);
        q = (k - i + (m - 1)) % (m - 1);
    }
    if (p > q) {
        const int t = p;
        p = q;
        q = t;
    }
}

// A non-finite entry decides the result without any rotation, as
// `jnp.linalg.pinv` does: a NaN anywhere, or a ±Inf off the diagonal, makes
// every entry NaN; ±Inf only on the diagonal makes every entry zero (the
// cutoff, rtol·Inf, keeps no direction).
constexpr int kNonFiniteNaN = 2;
constexpr int kNonFiniteZeros = 1;

// The quiet NaN numpy's float32 NaN has, so that the host replay matches bit for bit.
__device__ __forceinline__ float quiet_nan() { return __uint_as_float(0x7fc00000u); }

__device__ __forceinline__ int nonfinite_kind(double x, bool diagonal) {
    return isfinite(x) ? 0 : diagonal && !isnan(x) ? kNonFiniteZeros : kNonFiniteNaN;
}

__global__ void __launch_bounds__(kMaxThreads)
gram_pinv_kernel(const float* __restrict__ v, float* __restrict__ out, int R, double rtol,
                 double* __restrict__ scratch) {
    extern __shared__ double smem[];
    __shared__ double lam_max;
    const long long b = blockIdx.x;
    const long long rr = static_cast<long long>(R) * R;
    double* A = scratch != nullptr ? scratch + b * work_doubles(R) : smem;
    double* V = A + rr;
    double* aux = V + rr;  // cosines [0, half), sines [half, m); later the kept 1/λ
    const int m = R + (R & 1);
    const int half = m / 2;
    double* cs = aux;
    double* sn = aux + half;
    const float* vb = v + b * rr;

    int bad = 0;  // kNonFiniteNaN, kNonFiniteZeros: what this thread's entries ask for
    for (long long idx = threadIdx.x; idx < rr; idx += blockDim.x) {
        const int i = static_cast<int>(idx / R), j = static_cast<int>(idx % R);
        const double x = static_cast<double>(vb[i <= j ? idx : static_cast<long long>(j) * R + i]);
        A[idx] = x;
        V[idx] = i == j ? 1.0 : 0.0;
        bad |= nonfinite_kind(x, i == j);
    }
    // Both votes are block barriers: A and V are complete after them.
    const int any_nan = __syncthreads_or(bad & kNonFiniteNaN);
    const int any_inf = __syncthreads_or(bad & kNonFiniteZeros);
    if (any_nan || any_inf) {
        const float fill = any_nan ? quiet_nan() : 0.0f;
        for (long long idx = threadIdx.x; idx < rr; idx += blockDim.x) out[b * rr + idx] = fill;
        return;  // the whole block: no barrier follows
    }

    for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
        int rotated = 0;
        for (int k = 0; k < m - 1; ++k) {
            int mine = 0;
            for (int i = threadIdx.x; i < half; i += blockDim.x) {
                int p, q;
                pair_of(k, i, m, p, q);
                double c = 1.0, s = 0.0;
                if (q < R) {
                    const double apq = A[static_cast<long long>(p) * R + q];
                    const double app = A[static_cast<long long>(p) * R + p];
                    const double aqq = A[static_cast<long long>(q) * R + q];
                    if (apq != 0.0 && fabs(apq) > DBL_EPSILON * sqrt(fabs(app) * fabs(aqq))) {
                        const double theta = (aqq - app) / (2.0 * apq);
                        const double t = fabs(theta) > 1e150
                                             ? 0.5 / theta
                                             : (theta >= 0.0 ? 1.0 : -1.0) /
                                                   (fabs(theta) + sqrt(1.0 + theta * theta));
                        c = 1.0 / sqrt(1.0 + t * t);
                        s = t * c;
                        mine = 1;
                    }
                }
                cs[i] = c;
                sn[i] = s;
            }
            if (!__syncthreads_or(mine)) continue;  // the same answer in every thread
            rotated = 1;
            // Columns p, q of A and V, every row r: A ← A·J, V ← V·J.
            for (long long idx = threadIdx.x; idx < static_cast<long long>(half) * R;
                 idx += blockDim.x) {
                const int i = static_cast<int>(idx / R), r = static_cast<int>(idx % R);
                const double s = sn[i];
                if (s == 0.0) continue;
                int p, q;
                pair_of(k, i, m, p, q);
                const double c = cs[i];
                const long long rp = static_cast<long long>(r) * R + p;
                const long long rq = static_cast<long long>(r) * R + q;
                const double arp = A[rp], arq = A[rq];
                A[rp] = c * arp - s * arq;
                A[rq] = s * arp + c * arq;
                const double vrp = V[rp], vrq = V[rq];
                V[rp] = c * vrp - s * vrq;
                V[rq] = s * vrp + c * vrq;
            }
            __syncthreads();
            // Rows p, q of A, every column: A ← Jᵀ·A; the pair's own
            // off-diagonal entries are zero by construction.
            for (long long idx = threadIdx.x; idx < static_cast<long long>(half) * R;
                 idx += blockDim.x) {
                const int i = static_cast<int>(idx / R), col = static_cast<int>(idx % R);
                const double s = sn[i];
                if (s == 0.0) continue;
                int p, q;
                pair_of(k, i, m, p, q);
                const double c = cs[i];
                const long long pc = static_cast<long long>(p) * R + col;
                const long long qc = static_cast<long long>(q) * R + col;
                const double apc = A[pc], aqc = A[qc];
                A[pc] = col == q ? 0.0 : c * apc - s * aqc;
                A[qc] = col == p ? 0.0 : s * apc + c * aqc;
            }
            __syncthreads();
        }
        if (!rotated) break;
    }

    // Eigenvalues on A's diagonal: keep 1/λ where |λ| > rtol·max|λ|.
    if (threadIdx.x == 0) {
        double mx = 0.0;
        for (int i = 0; i < R; ++i) mx = fmax(mx, fabs(A[static_cast<long long>(i) * R + i]));
        lam_max = mx;
    }
    __syncthreads();
    const double cutoff = rtol * lam_max;
    for (int i = threadIdx.x; i < R; i += blockDim.x) {
        const double lam = A[static_cast<long long>(i) * R + i];
        aux[i] = fabs(lam) > cutoff ? 1.0 / lam : 0.0;
    }
    __syncthreads();
    float* ob = out + b * rr;
    for (long long idx = threadIdx.x; idx < rr; idx += blockDim.x) {
        const long long i = idx / R, j = idx % R;
        double acc = 0.0;
        for (int k = 0; k < R; ++k) acc += aux[k] * (V[i * R + k] * V[j * R + k]);
        ob[idx] = static_cast<float>(acc);
    }
}


// ---------------------------------------------------------------------------
// The warp tier.
// ---------------------------------------------------------------------------

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxWarpWidth = 32;
constexpr unsigned kFullMask = 0xffffffffu;

// Lanes a butterfly over W rows spans: the next power of two ≥ W.
__host__ __device__ constexpr int lanes_for(int W) {
    return W <= 2 ? 2 : W <= 4 ? 4 : W <= 8 ? 8 : W <= 16 ? 16 : 32;
}

// The slot whose column moves into slot c between two rounds: slot 0 stays,
// the others turn one step round the cycle 1 ← 2 ← 4 ← … ← W-2 ← W-1 ← W-3
// ← … ← 3 ← 1 (the round-robin ordering with slots (2j, 2j+1) paired).
// After W-1 rounds every pair has met once and every column is back home.
__host__ __device__ constexpr int round_robin_source(int c, int W) {
    return c == 0 ? 0
           : (c & 1) ? (c == 1 ? (W > 2 ? 2 : 1) : c - 2)
                     : (c + 2 <= W - 2 ? c + 2 : W - 1);
}

// The sum of x over the L lanes of this lane's group, as a butterfly: every
// lane adds its partner's value to its own, so every lane ends with the same
// bits (addition commutes).
template <int L>
__device__ __forceinline__ double group_sum(double x) {
#pragma unroll
    for (int h = L / 2; h > 0; h /= 2) x = __dadd_rn(x, __shfl_xor_sync(kFullMask, x, h));
    return x;
}

// The sums of L·K values over the L lanes of this lane's group, scattered:
// lane i ends with the complete sums of values [i·K, i·K + K) in x[0, K).
// Each level halves what a lane carries: the lane whose bit H is clear keeps
// the lower half and sends the upper, its partner the reverse (L·K - K
// shuffles in all, against log2(L) per value for `group_sum`).  The pairing,
// bit L/2 first down to bit 1, is the butterfly's, so every sum has the bits
// `group_sum` would give it.
template <int L, int K, int H = L / 2>
__device__ __forceinline__ void scatter_sum(double (&x)[L * K], int lane) {
    if constexpr (H >= 1) {
        constexpr int half = K * H;
        const bool upper = (lane & H) != 0;
#pragma unroll
        for (int t = 0; t < half; ++t) {
            const double keep = upper ? x[half + t] : x[t];
            const double send = upper ? x[t] : x[half + t];
            x[t] = __dadd_rn(keep, __shfl_xor_sync(kFullMask, send, H));
        }
        scatter_sum<L, K, H / 2>(x, lane);
    }
}

template <int W>
__device__ __forceinline__ void next_round(double (&x)[W]) {
    double y[W];
#pragma unroll
    for (int c = 0; c < W; ++c) y[c] = x[round_robin_source(c, W)];
#pragma unroll
    for (int c = 0; c < W; ++c) x[c] = y[c];
}

// Pairs whose sums, rotation and update are in flight together: all of a
// round's W/2 up to width 16, groups of at most 6 past it, so that U, W and
// the groups' sums fit the 255 registers a thread may hold.
template <int W>
__host__ __device__ constexpr int pair_group() {
    constexpr int most = W <= 16 ? 8 : 6;
    constexpr int groups = (W / 2 + most - 1) / most;
    return (W / 2 + groups - 1) / groups;
}

// Rotate pairs (2j, 2j+1) for j in [J0, J0 + G); returns whether any
// rotated (the same answer in every lane).  The group's 3·G sums (‖u_p‖²,
// ‖u_q‖², u_p·u_q per pair) are scattered over the lanes, and lane j gathers
// pair J0 + j's three and computes its rotation, so the group's float64
// chains (two square roots and a division) run side by side, one per lane;
// the cosines and sines reach every lane by shuffle and the decisions by one
// ballot.  A pair rotates while (u_p·u_q)² > eps²·‖u_p‖²·‖u_q‖² (the
// relative criterion) and neither column's squared norm is at most `tiny`
// (eps²·‖A‖_F²): such a column is numerically zero, and the relative
// criterion alone would orthogonalise its rounding noise again and again,
// shrinking it round by round into the subnormals.  A pair that does not
// rotate keeps its columns by selection.
template <int W, int L, int J0, int G>
__device__ __forceinline__ bool rotate_pairs(double (&u)[W], double (&w)[W], double tiny,
                                             int lane) {
    static_assert(G <= L, "lane j of the first L computes pair J0 + j");
    constexpr int K = (3 * G + L - 1) / L;  // sums each lane ends with
    double x[L * K];
#pragma unroll
    for (int j = 0; j < G; ++j) {
        const double up = u[2 * (J0 + j)], uq = u[2 * (J0 + j) + 1];
        x[j] = __dmul_rn(up, up);
        x[G + j] = __dmul_rn(uq, uq);
        x[2 * G + j] = __dmul_rn(up, uq);
    }
#pragma unroll
    for (int t = 3 * G; t < L * K; ++t) x[t] = 0.0;
    scatter_sum<L, K>(x, lane);
    // Sum kind·G + j lives in lane (kind·G + j) / K, register (kind·G + j) % K.
    const int jm = lane < G ? lane : 0;
    double sums[3];
#pragma unroll
    for (int kind = 0; kind < 3; ++kind) {
        const int slot = kind * G + jm;
        double got = 0.0;
#pragma unroll
        for (int r = 0; r < K; ++r) {
            const double y = __shfl_sync(kFullMask, x[r], slot / K);
            got = slot % K == r ? y : got;
        }
        sums[kind] = got;
    }
    const double am = sums[0], bm = sums[1], gm = sums[2];
    const bool rot = __dmul_rn(gm, gm) > __dmul_rn(__dmul_rn(DBL_EPSILON * DBL_EPSILON, am), bm) &&
                     fmin(am, bm) > tiny;
    // t = sign(d)·2γ / (|d| + √(d² + 4γ²)), d = ‖u_q‖² - ‖u_p‖²; c = 1/√(1 + t²),
    // s = t·c, formed as c = m·(1/n), s = ±2γ·(1/n) with m = |d| + √(d² + 4γ²)
    // and n = √(m² + 4γ²).  Squares stay in range for any float32 input.
    const double d = __dsub_rn(bm, am);
    const double g2 = __dmul_rn(2.0, gm);
    const double m =
        __dadd_rn(fabs(d), __dsqrt_rn(__dadd_rn(__dmul_rn(d, d), __dmul_rn(g2, g2))));
    const double inv = __ddiv_rn(1.0, __dsqrt_rn(__dadd_rn(__dmul_rn(m, m), __dmul_rn(g2, g2))));
    const double cm = __dmul_rn(m, inv);
    const double sm = __dmul_rn(d >= 0.0 ? g2 : -g2, inv);
    const unsigned bits = __ballot_sync(kFullMask, rot);
#pragma unroll
    for (int j = 0; j < G; ++j) {
        const double c = __shfl_sync(kFullMask, cm, j), s = __shfl_sync(kFullMask, sm, j);
        const bool rj = (bits >> j) & 1u;
        const int p = 2 * (J0 + j), q = p + 1;
        const double up = u[p], uq = u[q], wp = w[p], wq = w[q];
        u[p] = rj ? __dsub_rn(__dmul_rn(c, up), __dmul_rn(s, uq)) : up;
        u[q] = rj ? __dadd_rn(__dmul_rn(s, up), __dmul_rn(c, uq)) : uq;
        w[p] = rj ? __dsub_rn(__dmul_rn(c, wp), __dmul_rn(s, wq)) : wp;
        w[q] = rj ? __dadd_rn(__dmul_rn(s, wp), __dmul_rn(c, wq)) : wq;
    }
    return (bits & ((1u << G) - 1u)) != 0u;
}

// One round: every pair (2j, 2j+1), a group at a time; whether any rotated
// (the same answer in every lane).
template <int W, int L, int J0 = 0>
__device__ __forceinline__ bool rotate_round(double (&u)[W], double (&w)[W], double tiny,
                                             int lane) {
    constexpr int G = W / 2 - J0 < pair_group<W>() ? W / 2 - J0 : pair_group<W>();
    const bool any = rotate_pairs<W, L, J0, G>(u, w, tiny, lane);
    if constexpr (J0 + G < W / 2) {
        return rotate_round<W, L, J0 + G>(u, w, tiny, lane) || any;
    } else {
        return any;
    }
}

template <int W>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gram_pinv_warp_kernel(const float* __restrict__ v, float* __restrict__ out, long long B, int R,
                      double rtol) {
    static_assert(W % 2 == 0 && W >= 2 && W <= kMaxWarpWidth, "even widths up to 32");
    constexpr int L = lanes_for(W);
    const long long b = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
    if (b >= B) return;  // the whole warp: no barrier follows
    const int lane = static_cast<int>(threadIdx.x % 32);
    const int row = lane & (L - 1);  // lanes past L repeat the first L lanes' rows and work
    const long long rr = static_cast<long long>(R) * R;
    const float* vb = v + b * rr;

    double u[W], w[W];
    int bad = 0;  // kNonFiniteNaN, kNonFiniteZeros: what this lane's row asks for
#pragma unroll
    for (int c = 0; c < W; ++c) {
        u[c] = row < R && c < R
                   ? static_cast<double>(vb[row <= c ? static_cast<long long>(row) * R + c
                                                     : static_cast<long long>(c) * R + row])
                   : 0.0;
        w[c] = row == c ? 1.0 : 0.0;
        bad |= nonfinite_kind(u[c], row == c);
    }
    const unsigned any_nan = __ballot_sync(kFullMask, bad & kNonFiniteNaN);
    if (any_nan | __ballot_sync(kFullMask, bad & kNonFiniteZeros)) {
        const float fill = any_nan ? quiet_nan() : 0.0f;
        if (lane < R) {
            for (int j = 0; j < R; ++j) out[b * rr + static_cast<long long>(lane) * R + j] = fill;
        }
        return;  // the whole warp: no shuffle follows
    }

    double row_sq = 0.0;
#pragma unroll
    for (int c = 0; c < W; ++c) row_sq = __dadd_rn(row_sq, __dmul_rn(u[c], u[c]));
    const double tiny = __dmul_rn(DBL_EPSILON * DBL_EPSILON, group_sum<L>(row_sq));

    int quiet = 0;  // rounds in a row that rotated nothing (warp-uniform: a ballot)
    for (int round = 0; round < kMaxSweeps * (W - 1) && quiet < W - 1; ++round) {
        quiet = rotate_round<W, L>(u, w, tiny, lane) ? 0 : quiet + 1;
        next_round<W>(u);
        next_round<W>(w);
    }

    // λ_k = w_k·u_k; keep 1/λ_k where |λ_k| > rtol·max|λ|.
    double d[W];
    double lam_max = 0.0;
#pragma unroll
    for (int k = 0; k < W; ++k) {
        d[k] = group_sum<L>(__dmul_rn(w[k], u[k]));
        lam_max = fmax(lam_max, fabs(d[k]));
    }
    const double cutoff = __dmul_rn(rtol, lam_max);
#pragma unroll
    for (int k = 0; k < W; ++k) d[k] = fabs(d[k]) > cutoff ? __ddiv_rn(1.0, d[k]) : 0.0;

    // Row `lane` of the result: row j of W reaches every lane by shuffle.
    float* ob = out + b * rr;
    for (int j = 0; j < R; ++j) {
        double acc = 0.0;
#pragma unroll
        for (int k = 0; k < W; ++k) {
            const double wjk = __shfl_sync(kFullMask, w[k], j);
            acc = __dadd_rn(acc, __dmul_rn(d[k], __dmul_rn(w[k], wjk)));
        }
        if (lane < R) ob[static_cast<long long>(lane) * R + j] = __double2float_rn(acc);
    }
}

template <int W>
cudaError_t launch_warp(const float* v, float* out, long long B, int R, double rtol,
                        cudaStream_t stream) {
    const long long blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
    gram_pinv_warp_kernel<W><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, stream>>>(
        v, out, B, R, rtol);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of one matrix's work area (A, V and the per-index values).
long long prism_gram_pinv_work_bytes(int R) {
    return work_doubles(R) * static_cast<long long>(sizeof(double));
}

// Launches B blocks on `stream`: v and out are (B, R, R) float32, `scratch`
// is null (the work area lives in `smem_bytes` of dynamic shared memory, which
// must be exactly one matrix's work bytes) or B work areas of device memory
// (then `smem_bytes` is 0).  Returns a cudaError_t (0 = launched) or -1 when
// the layout arguments disagree.  Allocates nothing and does not synchronise.
int prism_gram_pinv_f32(const void* v, void* out, long long B, int R, double rtol,
                        void* scratch, long long smem_bytes, void* stream) {
    if (B < 1 || B > INT_MAX || R < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const long long need = prism_gram_pinv_work_bytes(R);
    if (scratch == nullptr ? smem_bytes != need : smem_bytes != 0) return kLayoutMismatch;
    if (smem_bytes > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            gram_pinv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem_bytes));
        if (e != cudaSuccess) {
            cudaGetLastError();  // a refused attribute must not fail the next launch
            return static_cast<int>(e);
        }
    }
    const long long rr = static_cast<long long>(R) * R;
    const int threads = rr >= kMaxThreads ? kMaxThreads : static_cast<int>((rr + 31) / 32 * 32);
    gram_pinv_kernel<<<static_cast<unsigned>(B), threads, static_cast<size_t>(smem_bytes),
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(v), static_cast<float*>(out), R, rtol,
        static_cast<double*>(scratch));
    return static_cast<int>(cudaGetLastError());
}

// Launches the warp tier on `stream`: v and out are (B, R, R) float32, one
// warp per matrix, instantiated at the even width R + R % 2.  Returns a
// cudaError_t (0 = launched) or -1 when R is past a warp (R > 32).
// Allocates nothing and does not synchronise.
int prism_gram_pinv_warp_f32(const void* v, void* out, long long B, int R, double rtol,
                             void* stream) {
    if (B < 1 || R < 1 || (B + kWarpsPerBlock - 1) / kWarpsPerBlock > INT_MAX) {
        return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    if (R > kMaxWarpWidth) return kLayoutMismatch;
    const auto* vf = static_cast<const float*>(v);
    auto* of = static_cast<float*>(out);
    const auto st = static_cast<cudaStream_t>(stream);
    cudaError_t e = cudaErrorInvalidValue;
    switch (R + (R & 1)) {
#define PRISM_WARP_WIDTH(W) \
    case W: e = launch_warp<W>(vf, of, B, R, rtol, st); break;
        PRISM_WARP_WIDTH(2) PRISM_WARP_WIDTH(4) PRISM_WARP_WIDTH(6) PRISM_WARP_WIDTH(8)
        PRISM_WARP_WIDTH(10) PRISM_WARP_WIDTH(12) PRISM_WARP_WIDTH(14) PRISM_WARP_WIDTH(16)
        PRISM_WARP_WIDTH(18) PRISM_WARP_WIDTH(20) PRISM_WARP_WIDTH(22) PRISM_WARP_WIDTH(24)
        PRISM_WARP_WIDTH(26) PRISM_WARP_WIDTH(28) PRISM_WARP_WIDTH(30) PRISM_WARP_WIDTH(32)
#undef PRISM_WARP_WIDTH
    }
    return static_cast<int>(e);
}

const char* prism_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
