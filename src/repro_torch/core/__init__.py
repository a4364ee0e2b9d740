"""PRISM core in PyTorch: the chunked sparse tensor format, the partition
decider, float and fixed-point spMTTKRP, the Qm.n formats, lock-free
emulation and CP-ALS."""
from .chunking import ChunkedTensor, chunk_tensor, clamp_capacity, replication_stats
from .cpals import CPResult, avg_abs_diff, cp_als, fit_value, init_factors, reconstruct_nnz
from .lockfree import wave_collision_mask
from .mttkrp import (
    chunked_device_arrays,
    dequantize_output,
    gather_factor_blocks,
    mttkrp_chunked,
    mttkrp_chunked_fixed,
    mttkrp_coo,
    mttkrp_coo_fixed,
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
    "Q5_3",
    "Q9_7",
    "Q17_15",
    "TABLE1",
    "CPResult",
    "ChunkedTensor",
    "PartitionPlan",
    "QFormat",
    "SparseTensor",
    "accumulator_safe_nnz",
    "avg_abs_diff",
    "chunk_tensor",
    "chunked_device_arrays",
    "clamp_capacity",
    "cp_als",
    "cross_mode_error_bound",
    "decide_partition",
    "dequantize_output",
    "fit_value",
    "gather_factor_blocks",
    "init_factors",
    "mttkrp_chunked",
    "mttkrp_chunked_fixed",
    "mttkrp_coo",
    "mttkrp_coo_fixed",
    "preset_error_bound",
    "random_tensor",
    "reconstruct_nnz",
    "replication_stats",
    "table1_tensor",
    "value_qformat",
    "wave_collision_mask",
]
