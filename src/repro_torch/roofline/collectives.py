"""Collective-byte accounting from a collectives log (the port's
counterpart of `repro.roofline.hlo`).

The reference parses the compiled SPMD module's HLO text; the port has no
compiled module, so `DistributedMTTKRP` logs each collective it runs as
{op, bytes, group}: the op in HLO's spelling, the bytes of its result (for
a reduce-scatter, one block) and the size of its group.  Wire bytes per
device follow the same ring formulas as the reference.
"""
from __future__ import annotations

__all__ = ["collective_bytes", "wire_bytes"]

OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def wire_bytes(op: str, nbytes: float, group: int) -> float:
    """Bytes one device sends for a collective whose result is `nbytes`
    over a group of `group` devices."""
    if op not in OPS:
        raise ValueError(f"unknown collective {op!r}; known: {OPS}")
    if op == "collective-permute":
        return float(nbytes)  # the payload crosses a link once
    if group <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * nbytes * (group - 1) / group
    if op == "reduce-scatter":
        return float(nbytes * (group - 1))  # the result is already 1/g of the input
    return nbytes * (group - 1) / group  # all-gather, all-to-all


def collective_bytes(records) -> dict:
    """Totals over `records` ({op, bytes, group} each): wire bytes per
    device, the number of collectives, and wire bytes by op."""
    by_op: dict[str, float] = {}
    total = 0.0
    for r in records:
        w = wire_bytes(r["op"], r["bytes"], r["group"])
        by_op[r["op"]] = by_op.get(r["op"], 0.0) + w
        total += w
    return {"total_wire_bytes": total, "count": len(records), "by_op": by_op}
