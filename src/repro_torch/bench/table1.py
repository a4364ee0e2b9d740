"""Paper Table I — the evaluation tensors (counterpart of
`benchmarks/table1.py`).

FROSTT isn't available offline; this benchmark materializes the synthetic
stand-ins (scaled dims, matched mode count and balance character), reports
their stats, and the partition plan the Fig. 5 decider picks for each.
Host numpy only: its rows equal the JAX suite's.
"""
from __future__ import annotations

from ..core import TABLE1, decide_partition, table1_tensor
from .common import save, table


def run():
    rows = []
    for name in TABLE1:
        st = table1_tensor(name)
        plan = decide_partition(st, rank=10, mem_bytes=256 * 1024,
                                n_devices=2560, rank_axis=10)
        rows.append(dict(
            tensor=name,
            dims="x".join(str(d) for d in st.shape),
            nnz=st.nnz,
            density=f"{st.density:.2e}",
            chunk_shape="x".join(str(c) for c in plan.chunk_shape),
            capacity=plan.capacity,
            rank_block=plan.rank_block,
            kernel_iters=plan.kernel_iterations,
        ))
    print("\n== Table I (synthetic stand-ins) + Fig.5 partition plans ==")
    print(table(rows, ["tensor", "dims", "nnz", "density", "chunk_shape",
                       "capacity", "rank_block", "kernel_iters"]))
    save("table1", rows)
    return rows
