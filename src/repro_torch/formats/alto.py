"""ALTO: adaptive linearized tensor order as a storage format, a numpy copy
of `repro.formats.alto` that builds byte-identical layouts.

ALTO (Helal et al., ICS'21) replaces per-mode coordinate tuples with ONE
mode-agnostic linearized index per nonzero: the bits of every mode's
coordinate are interleaved (mode-major round-robin, adaptive — a mode drops
out of the rotation once its coordinate width is exhausted), and the nonzeros
are stored sorted by that key.  One copy of the tensor then serves every
MTTKRP mode, and any mode's coordinate is recovered at kernel time by
gathering its bit positions back out of the key
(`repro_torch.core.mttkrp.mttkrp_alto`).

The key is packed into ceil(bits/32) little-endian uint32 words, as in the
reference.  Torch has no right shift for uint32, so the device copy
(`FormatCache.device_alto`) reinterprets the same words as int32.  Tensors
needing more than 64 key bits are rejected; the `alto` backend then takes
the ALTO-ordered COO baseline (`core.baselines`).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.sptensor import SparseTensor

__all__ = [
    "MAX_KEY_BITS",
    "ALTOTensor",
    "alto_decode_mode",
    "alto_index_bytes",
    "alto_key_bits",
    "alto_positions",
    "alto_to_coo",
    "build_alto",
]

MAX_KEY_BITS = 64


def alto_index_bytes(nnz: int, n_words: int) -> int:
    """Bytes of the packed linearized index — the single key stream (vs
    `nnz·ndim·4` for COO coordinate columns).  Single source for both the
    real layout (`ALTOTensor.index_bytes`) and `FormatStats`."""
    return 4 * nnz * n_words


def _mode_bits(shape: tuple[int, ...]) -> list[int]:
    """Coordinate width per mode (≥1 bit even for size-1 modes, so every
    mode owns at least one key position and decoding stays uniform)."""
    return [max(1, int(np.ceil(np.log2(max(s, 2))))) for s in shape]


def alto_positions(shape: tuple[int, ...]) -> tuple[tuple[int, ...], ...]:
    """Per-mode key bit positions: `positions[m][b]` is where bit `b` of
    mode `m`'s coordinate lives in the linearized key.  Mode-major
    round-robin over the bits each mode still needs (the ALTO paper's
    adaptive interleave)."""
    bits = _mode_bits(shape)
    positions: list[list[int]] = [[] for _ in shape]
    pos = 0
    for b in range(max(bits)):
        for m in range(len(shape)):
            if b < bits[m]:
                positions[m].append(pos)
                pos += 1
    return tuple(tuple(p) for p in positions)


def alto_key_bits(shape: tuple[int, ...]) -> int:
    return sum(_mode_bits(shape))


@dataclasses.dataclass(frozen=True)
class ALTOTensor:
    """Linearized tensor: one sorted key stream serving every mode.

    key_words — (nnz, W) uint32, W = ceil(key_bits/32) little-endian words
                of the interleaved key; rows sorted ascending by key.
    values    — (nnz,) f32 in key order.
    perm      — (nnz,) position of each row in the source COO arrays.
    positions — per-mode de-interleave bit positions.
    """

    key_words: np.ndarray
    values: np.ndarray
    perm: np.ndarray
    positions: tuple[tuple[int, ...], ...]
    shape: tuple[int, ...]

    @property
    def nnz(self) -> int:
        return self.values.shape[0]

    @property
    def key_bits(self) -> int:
        return alto_key_bits(self.shape)

    @property
    def n_words(self) -> int:
        return self.key_words.shape[1]

    @property
    def index_bytes(self) -> int:
        """What the cost model charges as `indexed` traffic."""
        return alto_index_bytes(self.nnz, self.n_words)


def build_alto(st: SparseTensor) -> ALTOTensor:
    """Encode, sort, and word-pack the linearized index."""
    bits = alto_key_bits(st.shape)
    if bits > MAX_KEY_BITS:
        raise ValueError(
            f"ALTO key needs {bits} bits for shape {st.shape}; the packed "
            f"encoding caps at {MAX_KEY_BITS} (BLCO block splitting is the "
            "planned lift — see ROADMAP)")
    positions = alto_positions(st.shape)
    key = np.zeros(st.nnz, dtype=np.uint64)
    for m, pos in enumerate(positions):
        c = st.coords[:, m].astype(np.uint64)
        for b, p in enumerate(pos):
            key |= ((c >> np.uint64(b)) & np.uint64(1)) << np.uint64(p)
    perm = np.argsort(key, kind="stable").astype(np.int64)
    key = key[perm]
    n_words = max(1, -(-bits // 32))
    words = np.empty((st.nnz, n_words), dtype=np.uint32)
    for w in range(n_words):
        words[:, w] = ((key >> np.uint64(32 * w)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return ALTOTensor(
        key_words=words,
        values=st.values[perm].astype(np.float32),
        perm=perm,
        positions=positions,
        shape=st.shape,
    )


def alto_decode_mode(at: ALTOTensor, mode: int) -> np.ndarray:
    """Host-side de-interleave of one mode's coordinates (the torch op does
    the same bit gathers on the device)."""
    pos = at.positions[mode]
    c = np.zeros(at.nnz, dtype=np.int32)
    for b, p in enumerate(pos):
        word = at.key_words[:, p // 32]
        c |= (((word >> np.uint32(p % 32)) & np.uint32(1)) << b).astype(np.int32)
    return c


def alto_to_coo(at: ALTOTensor) -> SparseTensor:
    """Invert the linearization back to COO (key order; the coordinate/value
    multiset and `to_dense()` are preserved exactly)."""
    coords = np.stack([alto_decode_mode(at, m) for m in range(len(at.shape))],
                      axis=1).astype(np.int32)
    return SparseTensor(coords, at.values.copy(), at.shape)
