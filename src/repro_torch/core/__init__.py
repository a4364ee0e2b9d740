"""PRISM core in PyTorch: the chunked sparse tensor format, the partition
decider, float and fixed-point spMTTKRP, the CSF/ALTO ops and baselines,
the Qm.n formats, lock-free emulation, heterogeneous execution, the
distributed MTTKRP over a `torch.distributed` mesh and CP-ALS
(`cp_als_batched`, batched many-tensor CP-ALS, resolves lazily from
`repro_torch.batch`)."""
from .baselines import alto_order
from .chunking import ChunkedTensor, chunk_tensor, clamp_capacity, replication_stats
from .cpals import CPResult, avg_abs_diff, cp_als, fit_value, init_factors, reconstruct_nnz
from .distributed import DistributedMTTKRP, distributed_mttkrp_fn, shard_chunked
from .hetero import (
    MAX_DENSE_VOLUME,
    HeteroSplit,
    densify_tasks,
    hetero_device_arrays,
    mttkrp_hetero,
    split_tasks,
)
from .lockfree import wave_collision_mask
from .mttkrp import (
    chunked_device_arrays,
    dequantize_output,
    gather_factor_blocks,
    mttkrp_alto,
    mttkrp_chunked,
    mttkrp_chunked_fixed,
    mttkrp_coo,
    mttkrp_coo_fixed,
    mttkrp_csf,
)
from .partition import PartitionPlan, decide_partition
from .qformat import (
    CROSS_MODE_SLACK,
    FIXED_PRESETS,
    Q5_3,
    Q9_7,
    Q17_15,
    QFormat,
    accumulator_safe_nnz,
    cross_mode_error_bound,
    preset_error_bound,
    value_qformat,
)
from .sptensor import TABLE1, SparseTensor, random_tensor, table1_tensor

__all__ = [
    "CROSS_MODE_SLACK",
    "FIXED_PRESETS",
    "MAX_DENSE_VOLUME",
    "Q17_15",
    "Q5_3",
    "Q9_7",
    "TABLE1",
    "CPResult",
    "ChunkedTensor",
    "DistributedMTTKRP",
    "HeteroSplit",
    "PartitionPlan",
    "QFormat",
    "SparseTensor",
    "accumulator_safe_nnz",
    "alto_order",
    "avg_abs_diff",
    "chunk_tensor",
    "chunked_device_arrays",
    "clamp_capacity",
    "cp_als",
    "cross_mode_error_bound",
    "decide_partition",
    "densify_tasks",
    "dequantize_output",
    "distributed_mttkrp_fn",
    "fit_value",
    "gather_factor_blocks",
    "hetero_device_arrays",
    "init_factors",
    "mttkrp_alto",
    "mttkrp_chunked",
    "mttkrp_chunked_fixed",
    "mttkrp_coo",
    "mttkrp_coo_fixed",
    "mttkrp_csf",
    "mttkrp_hetero",
    "preset_error_bound",
    "random_tensor",
    "reconstruct_nnz",
    "replication_stats",
    "shard_chunked",
    "split_tasks",
    "table1_tensor",
    "value_qformat",
    "wave_collision_mask",
]


def __getattr__(name):
    # Lazy (PEP 562): `repro_torch.batch` itself imports from
    # `repro_torch.core.cpals`, so an eager import here would be circular.
    if name == "cp_als_batched":
        from ..batch import cp_als_batched
        return cp_als_batched
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
