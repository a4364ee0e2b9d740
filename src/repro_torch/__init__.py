"""PRISM (Processing-In-Memory Sparse MTTKRP) in PyTorch and CUDA.

The port of the JAX package `repro` to an NVIDIA H100: chunked CP-ALS
through hand-written Hopper spMTTKRP kernels, float and fixed point (paper
Alg. 2), the CSF and ALTO layouts (`formats`) with their backends, and the
paper's heterogeneous dense/sparse split (`hetero`), the autotuner
(`engine="auto"`, `TunePolicy`, the tuning store and the calibrated cost
prior) that chooses among them, and the serving path: batched many-tensor
CP-ALS (`cp_als_batched`, `repro_torch.batch`), the coalescing
`DecomposeService` over it (`repro_torch.serve`) and its `MetricsRegistry`
(`repro_torch.obs`), the `distributed` backend over a `torch.distributed`
mesh (`repro_torch.launch`, `DistributedMTTKRP`), and the offline sweep
that fills a tuning store ahead of time (`repro_torch.sweep`, with the
card's roofline in `repro_torch.roofline`).  It imports neither JAX nor
`repro`; its host-side numpy code produces the same arrays as the
reference from the same seeds.  Entry
points run on the CUDA card unless the caller passes ``device="cpu"``;
importing the package builds no kernel.

    from repro_torch import (DecomposeService, TunePolicy, build_engine, cp_als,
                             cp_als_batched, decide_partition, random_tensor, table1_tensor)
    st = table1_tensor("nell2")
    res = cp_als(st, 10, n_iters=5, engine="auto")                   # measured winner per mode
    res = cp_als(st, 10, n_iters=5, engine="auto",                   # winners persisted
                 tune=TunePolicy(store=True))                        # (~/.cache/repro/autotune.json)
    plan = decide_partition(st, 10, mem_bytes=256 * 1024, rank_axis=10)
    chunking = dict(chunk_shape=plan.chunk_shape, capacity=plan.capacity)
    eng = build_engine(st, "kernel", 10, **chunking)                  # float
    res = cp_als(st, 10, n_iters=5, engine=eng)
    eng = build_engine(st, "fixed", 10, fixed_preset="int7", **chunking)  # Q9.7
    res = cp_als(st, 10, n_iters=5, engine=eng)                       # res.quant_error
    res = cp_als(st, 10, n_iters=5, engine="alto")                    # or "csf", "hetero"
    small = [random_tensor((12, 10, 8), 50, seed=s) for s in range(1000)]
    results = cp_als_batched(small, 5, n_iters=3)                     # one ALS loop per bucket
    with DecomposeService(5, n_iters=3, max_batch=256) as svc:        # coalesced requests
        res = svc.submit(small[0]).result()
"""
from .core import (
    CROSS_MODE_SLACK,
    FIXED_PRESETS,
    MAX_DENSE_VOLUME,
    Q5_3,
    Q9_7,
    Q17_15,
    TABLE1,
    ChunkedTensor,
    CPResult,
    DistributedMTTKRP,
    HeteroSplit,
    PartitionPlan,
    QFormat,
    SparseTensor,
    accumulator_safe_nnz,
    alto_order,
    avg_abs_diff,
    chunk_tensor,
    chunked_device_arrays,
    clamp_capacity,
    cp_als,
    cross_mode_error_bound,
    decide_partition,
    densify_tasks,
    dequantize_output,
    distributed_mttkrp_fn,
    fit_value,
    gather_factor_blocks,
    hetero_device_arrays,
    init_factors,
    mttkrp_alto,
    mttkrp_chunked,
    mttkrp_chunked_fixed,
    mttkrp_coo,
    mttkrp_coo_fixed,
    mttkrp_csf,
    mttkrp_hetero,
    preset_error_bound,
    random_tensor,
    reconstruct_nnz,
    replication_stats,
    split_tasks,
    table1_tensor,
    value_qformat,
    wave_collision_mask,
)
from .engine import (
    AutotuneReport,
    BackendSpec,
    CalibratedPrior,
    Engine,
    EngineContext,
    PlanCache,
    TunePolicy,
    TuningStore,
    autotune_engine,
    backend_table,
    build_candidate,
    build_engine,
    candidate_lossless,
    eligible_backends,
    get_backend,
    parse_candidate,
    register_backend,
    registered_backends,
)
from .formats import (
    ALTOTensor,
    CSFModeTree,
    FormatCache,
    FormatStats,
    alto_key_bits,
    build_alto,
    build_csf_tree,
    default_format_cache,
    fiber_count,
    register_format,
    registered_formats,
)
from .obs import MetricsRegistry, enable_tracing, get_tracer, span
from .batch import cp_als_batched
from .serve import DecomposeService, ServeStats
from .sweep import SweepConfig, load_config, pareto_report, run_sweep
from .interop import (
    chunked_from_reference,
    factors_from_reference,
    padded_batch_from_reference,
    qfactors_from_reference,
    tensor_from_reference,
)
from .kernels import (
    KernelError,
    mttkrp_fixed_kernel_op,
    mttkrp_fixed_local,
    mttkrp_kernel_op,
    mttkrp_local,
    pad_factor,
)

__all__ = [
    "CROSS_MODE_SLACK",
    "FIXED_PRESETS",
    "MAX_DENSE_VOLUME",
    "Q17_15",
    "Q5_3",
    "Q9_7",
    "TABLE1",
    "ALTOTensor",
    "AutotuneReport",
    "BackendSpec",
    "CPResult",
    "CalibratedPrior",
    "CSFModeTree",
    "ChunkedTensor",
    "DecomposeService",
    "DistributedMTTKRP",
    "Engine",
    "EngineContext",
    "FormatCache",
    "FormatStats",
    "HeteroSplit",
    "KernelError",
    "MetricsRegistry",
    "PartitionPlan",
    "PlanCache",
    "QFormat",
    "ServeStats",
    "SparseTensor",
    "SweepConfig",
    "TunePolicy",
    "TuningStore",
    "accumulator_safe_nnz",
    "alto_key_bits",
    "alto_order",
    "autotune_engine",
    "avg_abs_diff",
    "backend_table",
    "build_alto",
    "build_candidate",
    "build_csf_tree",
    "build_engine",
    "candidate_lossless",
    "chunk_tensor",
    "chunked_device_arrays",
    "chunked_from_reference",
    "clamp_capacity",
    "cp_als",
    "cp_als_batched",
    "cross_mode_error_bound",
    "decide_partition",
    "default_format_cache",
    "densify_tasks",
    "dequantize_output",
    "distributed_mttkrp_fn",
    "eligible_backends",
    "enable_tracing",
    "factors_from_reference",
    "fiber_count",
    "fit_value",
    "gather_factor_blocks",
    "get_backend",
    "get_tracer",
    "hetero_device_arrays",
    "init_factors",
    "load_config",
    "mttkrp_alto",
    "mttkrp_chunked",
    "mttkrp_chunked_fixed",
    "mttkrp_coo",
    "mttkrp_coo_fixed",
    "mttkrp_csf",
    "mttkrp_fixed_kernel_op",
    "mttkrp_fixed_local",
    "mttkrp_hetero",
    "mttkrp_kernel_op",
    "mttkrp_local",
    "pad_factor",
    "padded_batch_from_reference",
    "pareto_report",
    "parse_candidate",
    "preset_error_bound",
    "qfactors_from_reference",
    "random_tensor",
    "reconstruct_nnz",
    "register_backend",
    "register_format",
    "registered_backends",
    "registered_formats",
    "replication_stats",
    "run_sweep",
    "span",
    "split_tasks",
    "table1_tensor",
    "tensor_from_reference",
    "value_qformat",
    "wave_collision_mask",
]
