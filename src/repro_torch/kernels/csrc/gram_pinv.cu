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
//
// Design.  One block per matrix.  Cyclic Jacobi in float64, in the
// round-robin order (R/2 disjoint pairs per round, R-1 rounds per sweep,
// each round's rotations applied together: columns of A and V, then rows
// of A), on A and the eigenvector matrix V held in shared memory.  A pair is
// rotated while |a_pq| > eps(float64)·sqrt(|a_pp·a_qq|) (the relative
// criterion, which a PSD matrix's small eigenvalues need); the sweeps stop
// when one rotates nothing, or after kMaxSweeps.  The result is formed from V
// and the kept 1/λ in float64 and written as float32, bitwise symmetric.
// When A, V and the rotations do not fit the card's opt-in shared memory
// (R above 119 on the H100) the same kernel works from a global scratch
// buffer the wrapper allocates.
//
// Bound.  Bytes: one R×R float32 read and one written per matrix (2·R²·4 B),
// 0.0008 µs per matrix at R = 10 over 3.35 TB/s: nothing.  Operations: a
// sweep costs about 8·R³ float64 flops in rotations; about 6 to 12 sweeps
// converge.  At CP-ALS's R (10) a launch does a few hundred thousand flops
// on one SM, so it is bound by the latency of its R-1 dependent rounds per
// sweep (three block barriers each), not by a rate of the card.
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

    for (long long idx = threadIdx.x; idx < rr; idx += blockDim.x) {
        const int i = static_cast<int>(idx / R), j = static_cast<int>(idx % R);
        A[idx] = static_cast<double>(vb[i <= j ? idx : static_cast<long long>(j) * R + i]);
        V[idx] = i == j ? 1.0 : 0.0;
    }
    __syncthreads();

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

const char* prism_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
