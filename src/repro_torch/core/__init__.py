"""PRISM core in PyTorch: the chunked sparse tensor format, the partition
decider, float spMTTKRP and CP-ALS."""
from .chunking import ChunkedTensor, chunk_tensor, clamp_capacity, replication_stats
from .cpals import CPResult, avg_abs_diff, cp_als, fit_value, init_factors, reconstruct_nnz
from .mttkrp import chunked_device_arrays, gather_factor_blocks, mttkrp_chunked, mttkrp_coo
from .partition import PartitionPlan, decide_partition
from .sptensor import TABLE1, SparseTensor, random_tensor, table1_tensor

__all__ = [
    "TABLE1",
    "CPResult",
    "ChunkedTensor",
    "PartitionPlan",
    "SparseTensor",
    "avg_abs_diff",
    "chunk_tensor",
    "chunked_device_arrays",
    "clamp_capacity",
    "cp_als",
    "decide_partition",
    "fit_value",
    "gather_factor_blocks",
    "init_factors",
    "mttkrp_chunked",
    "mttkrp_coo",
    "random_tensor",
    "reconstruct_nnz",
    "replication_stats",
    "table1_tensor",
]
