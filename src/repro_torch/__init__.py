"""PRISM (Processing-In-Memory Sparse MTTKRP) in PyTorch and CUDA.

The port of the JAX package `repro` to an NVIDIA H100: chunked CP-ALS
through hand-written Hopper spMTTKRP kernels, float and fixed point (paper
Alg. 2).  It imports neither JAX nor `repro`; its host-side numpy code
produces the same arrays as the reference from the same seeds.  Entry
points run on the CUDA card unless the caller passes ``device="cpu"``;
importing the package builds no kernel.

    from repro_torch import build_engine, cp_als, decide_partition, table1_tensor
    st = table1_tensor("nell2")
    plan = decide_partition(st, 10, mem_bytes=256 * 1024, rank_axis=10)
    chunking = dict(chunk_shape=plan.chunk_shape, capacity=plan.capacity)
    eng = build_engine(st, "kernel", 10, **chunking)                  # float
    res = cp_als(st, 10, n_iters=5, engine=eng)
    eng = build_engine(st, "fixed", 10, fixed_preset="int7", **chunking)  # Q9.7
    res = cp_als(st, 10, n_iters=5, engine=eng)                       # res.quant_error
"""
from .core import (
    CROSS_MODE_SLACK,
    FIXED_PRESETS,
    Q5_3,
    Q9_7,
    Q17_15,
    TABLE1,
    ChunkedTensor,
    CPResult,
    PartitionPlan,
    QFormat,
    SparseTensor,
    accumulator_safe_nnz,
    avg_abs_diff,
    chunk_tensor,
    chunked_device_arrays,
    clamp_capacity,
    cp_als,
    cross_mode_error_bound,
    decide_partition,
    dequantize_output,
    fit_value,
    gather_factor_blocks,
    init_factors,
    mttkrp_chunked,
    mttkrp_chunked_fixed,
    mttkrp_coo,
    mttkrp_coo_fixed,
    preset_error_bound,
    random_tensor,
    reconstruct_nnz,
    replication_stats,
    table1_tensor,
    value_qformat,
    wave_collision_mask,
)
from .engine import (
    BackendSpec,
    Engine,
    EngineContext,
    PlanCache,
    backend_table,
    build_candidate,
    build_engine,
    candidate_lossless,
    get_backend,
    parse_candidate,
    register_backend,
    registered_backends,
)
from .interop import (
    chunked_from_reference,
    factors_from_reference,
    qfactors_from_reference,
    tensor_from_reference,
)
from .kernels import (
    mttkrp_fixed_kernel_op,
    mttkrp_fixed_local,
    mttkrp_kernel_op,
    mttkrp_local,
    pad_factor,
)

__all__ = [
    "CROSS_MODE_SLACK",
    "FIXED_PRESETS",
    "Q5_3",
    "Q9_7",
    "Q17_15",
    "TABLE1",
    "BackendSpec",
    "CPResult",
    "ChunkedTensor",
    "Engine",
    "EngineContext",
    "PartitionPlan",
    "PlanCache",
    "QFormat",
    "SparseTensor",
    "accumulator_safe_nnz",
    "avg_abs_diff",
    "backend_table",
    "build_candidate",
    "build_engine",
    "candidate_lossless",
    "chunk_tensor",
    "chunked_device_arrays",
    "chunked_from_reference",
    "clamp_capacity",
    "cp_als",
    "cross_mode_error_bound",
    "decide_partition",
    "dequantize_output",
    "factors_from_reference",
    "fit_value",
    "gather_factor_blocks",
    "get_backend",
    "init_factors",
    "mttkrp_chunked",
    "mttkrp_chunked_fixed",
    "mttkrp_coo",
    "mttkrp_coo_fixed",
    "mttkrp_fixed_kernel_op",
    "mttkrp_fixed_local",
    "mttkrp_kernel_op",
    "mttkrp_local",
    "pad_factor",
    "parse_candidate",
    "preset_error_bound",
    "qfactors_from_reference",
    "random_tensor",
    "reconstruct_nnz",
    "register_backend",
    "registered_backends",
    "replication_stats",
    "table1_tensor",
    "tensor_from_reference",
    "value_qformat",
    "wave_collision_mask",
]
