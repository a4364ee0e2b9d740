"""PRISM (Processing-In-Memory Sparse MTTKRP) in PyTorch and CUDA.

The port of the JAX package `repro` to an NVIDIA H100: chunked CP-ALS
through a hand-written Hopper spMTTKRP kernel.  It imports neither JAX nor
`repro`; its host-side numpy code produces the same arrays as the
reference from the same seeds.  Entry points run on the CUDA card unless
the caller passes ``device="cpu"``; importing the package builds no kernel.

    from repro_torch import build_engine, cp_als, decide_partition, table1_tensor
    st = table1_tensor("nell2")
    plan = decide_partition(st, 10, mem_bytes=256 * 1024, rank_axis=10)
    eng = build_engine(st, "kernel", 10, chunk_shape=plan.chunk_shape,
                       capacity=plan.capacity)
    res = cp_als(st, 10, n_iters=5, engine=eng)
"""
from .core import (
    TABLE1,
    ChunkedTensor,
    CPResult,
    PartitionPlan,
    SparseTensor,
    avg_abs_diff,
    chunk_tensor,
    chunked_device_arrays,
    clamp_capacity,
    cp_als,
    decide_partition,
    fit_value,
    gather_factor_blocks,
    init_factors,
    mttkrp_chunked,
    mttkrp_coo,
    random_tensor,
    reconstruct_nnz,
    replication_stats,
    table1_tensor,
)
from .engine import (
    BackendSpec,
    Engine,
    EngineContext,
    PlanCache,
    backend_table,
    build_engine,
    get_backend,
    register_backend,
    registered_backends,
)
from .interop import chunked_from_reference, factors_from_reference, tensor_from_reference
from .kernels import mttkrp_kernel_op, mttkrp_local, pad_factor

__all__ = [
    "TABLE1",
    "BackendSpec",
    "CPResult",
    "ChunkedTensor",
    "Engine",
    "EngineContext",
    "PartitionPlan",
    "PlanCache",
    "SparseTensor",
    "avg_abs_diff",
    "backend_table",
    "build_engine",
    "chunk_tensor",
    "chunked_device_arrays",
    "chunked_from_reference",
    "clamp_capacity",
    "cp_als",
    "decide_partition",
    "factors_from_reference",
    "fit_value",
    "gather_factor_blocks",
    "get_backend",
    "init_factors",
    "mttkrp_chunked",
    "mttkrp_coo",
    "mttkrp_kernel_op",
    "mttkrp_local",
    "pad_factor",
    "random_tensor",
    "reconstruct_nnz",
    "register_backend",
    "registered_backends",
    "replication_stats",
    "table1_tensor",
    "tensor_from_reference",
]
