"""Analytic memory-bound cost prior for cold-start backend ranking (the
port's copy of `repro.engine.costmodel`: the same formulas, with the port's
`kernel` backend in the reference's `pallas` place and no interpret mode).

spMTTKRP is memory-bound (the paper's roofline argument: a handful of FLOPs
per nonzero against coordinate reads, factor-row gathers and output
scatters), so candidate backends can be *ranked* — not timed — by the bytes
they move per MTTKRP call.  The prior exists for one job: when the
autotuner starts cold on a workload it has never measured, decide which
candidates are worth spending probe budget on (`max_probes`) and which
modes are worth probing at all (cross-mode elision).  It is a prior, not a
predictor — measured timings always override it, and the persisted store
(persist.py) means a workload pays the probe phase once.

The per-backend models mirror how each execution strategy touches memory:

  ref          COO scatter-add: every nonzero read-modify-writes its output
               row (2x traffic on the accumulator).
  alto         ALTO ordering turns the scatter into a near-sequential
               segment sum (1x accumulator traffic) and improves factor
               gather locality.
  chunked      PRISM chunked format: padded tasks (capacity padding moves
               dead bytes) but chunk-local accumulation.
  hetero       chunked plus densified blocks for the dense einsum — extra
               traffic for the dense side, in exchange for dense peak.
  kernel       chunked bytes (the hand-written CUDA kernel on the chunked
               format; the reference's `pallas`).  The byte model cannot
               tell it from the plain `chunked` op: only a calibrated
               per-backend dispatch term separates them.
  distributed  chunked bytes split across devices plus an output
               all-reduce and a per-call dispatch overhead.
  fixed        chunked with quantized values/factors.  Candidate ids carry
               the Qm.n preset ("fixed:int3" / "fixed:int7" /
               "fixed:int15-12"), and the gather/value traffic scales with
               that preset's storage width — the whole point of the paper's
               narrow-int path is fewer bytes against the memory roofline.
               Lossy — only admitted under an accuracy budget.
  csf          CSF fiber trees (repro_torch.formats.csf): interior factor gathers
               scale with the *fiber* count, not nnz — the model consumes
               `FormatStats` fiber counts (measured when the autotuner has
               the live tensor, balls-in-bins-estimated from (shape, nnz)
               otherwise) so a long-fibered tensor ranks csf ahead of COO
               on a cold start.
  alto         ALTO linearized index: the per-mode coordinate columns are
               replaced by one packed key stream (FormatStats.key_words ·
               4 bytes/nnz), de-interleaved at kernel time.

Every model is decomposed into five byte components (`byte_terms`):

    seconds = (fixed + chunk_padding·padded + chunk_padding·hetero_overhead·densified)
              / bandwidth  +  narrow / narrow_bandwidth
              + indexed / indexed_bandwidth  +  dispatch(backend)

where `narrow` counts the bytes moved through quantized (int8/int16/int32)
paths — already scaled by the preset's storage width — and
`narrow_bandwidth` is the effective throughput of that traffic (quantize /
dequantize arithmetic rides on every narrow byte, so it need not equal the
float-stream bandwidth).  `indexed` counts the bytes of *format index
structure* (CSF fiber pointers/coords, ALTO key words) whose consumption
carries extra address arithmetic — bit de-interleaves, fiber-tree walks —
priced at its own `indexed_bandwidth`.  The model stays *linear* in the
reparametrized coefficients (1/bandwidth, chunk_padding/bandwidth,
chunk_padding·hetero_overhead/bandwidth, 1/narrow_bandwidth,
1/indexed_bandwidth, and the per-backend dispatch terms) — exactly what
`calibrate.py` needs to fit them by least squares against the tuning
store's measured timings.
"""
from __future__ import annotations

import dataclasses
import math

from ..core.qformat import FIXED_PRESETS
from ..formats import MAX_KEY_BITS, FormatStats

__all__ = [
    "CostModelPrior",
    "WorkloadStats",
    "byte_terms",
    "default_prior",
    "device_byte_terms",
    "prior_order",
]

_IDX = 4   # int32 coordinate bytes
_VAL = 4   # float32 value bytes
_QVAL = 2  # runtime 16-bit quantized tensor-value bytes (value_qformat)


def _split_candidate(name: str) -> tuple[str, str | None]:
    """Candidate ids are "backend" or "backend:preset"; the byte models (and
    dispatch lookups) key on the backend, widths on the preset.  Kept local —
    unknown names must degrade to the COO-like default, not raise, so the
    registry's strict parser is not used here."""
    base, _, preset = name.partition(":")
    return base, (preset or None)


def _preset_width(preset: str | None) -> float:
    """Factor storage bytes per element for a fixed-point preset (falls back
    to int16/Q9.7 — the paper's preferred mode-3 format — when the candidate
    doesn't pin one)."""
    if preset is not None and preset in FIXED_PRESETS:
        qf, _shift = FIXED_PRESETS[preset]
        return qf.storage_bits / 8.0
    return 2.0


@dataclasses.dataclass(frozen=True)
class WorkloadStats:
    """The tensor statistics the byte models consume — duck-compatible with
    `SparseTensor` (shape/nnz/ndim), constructible from a persisted
    `WorkloadKey` so calibration can evaluate the prior on workloads whose
    tensors are long gone.

    `format_stats` (a `repro_torch.formats.FormatStats`) carries the layout
    statistics — per-mode fiber counts, interleave key width — the csf/alto
    byte models need; None falls back to the balls-in-bins estimate from
    (shape, nnz) inside `byte_terms`.  The autotuner attaches measured
    stats for live tensors and persists them with the entry (schema v4), so
    calibration trains on the same numbers prediction used."""

    shape: tuple[int, ...]
    nnz: int
    format_stats: FormatStats | None = None

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @classmethod
    def from_key(cls, key, format_stats: FormatStats | dict | None = None,
                 ) -> WorkloadStats:
        if isinstance(format_stats, dict):
            format_stats = FormatStats.from_json(format_stats)
        return cls(shape=tuple(key.shape), nnz=int(key.nnz),
                   format_stats=format_stats)


def _format_stats(st) -> FormatStats:
    """The `FormatStats` for anything byte_terms accepts: an attached
    (measured or persisted) instance when present, else the estimate —
    which is a pure function of (shape, nnz), so prediction and training
    agree whenever neither side has real counts."""
    fs = getattr(st, "format_stats", None)
    if fs is not None:
        return fs
    return FormatStats.estimate(tuple(st.shape), int(st.nnz))


def byte_terms(name: str, st, rank: int, mode: int,
               ) -> tuple[float, float, float, float, float]:
    """Decompose candidate `name`'s mode-`mode` MTTKRP traffic on `st` into
    ``(fixed, padded, densified, narrow, indexed)`` byte components:

    - *fixed* bytes move regardless of chunking (coordinates, values,
      gathers, the output);
    - *padded* bytes are scaled by the chunk-capacity padding factor
      (`CostModelPrior.chunk_padding`);
    - *densified* bytes are additionally scaled by the dense-block traffic
      multiplier (`CostModelPrior.hetero_overhead`);
    - *narrow* bytes move through quantized integer paths, already scaled by
      the candidate's preset storage width, and are charged at
      `CostModelPrior.narrow_bandwidth` — this is what lets the prior rank
      an int8 candidate above an int16 one on a cold start;
    - *indexed* bytes are format index structure (CSF fiber tree levels,
      ALTO key words) whose consumption pays address arithmetic on top of
      the load, charged at `CostModelPrior.indexed_bandwidth`.

    `name` accepts preset candidate ids ("fixed:int3"); `st` is anything
    with `.shape`, `.nnz`, `.ndim` (a `SparseTensor` or a `WorkloadStats` —
    the latter may carry measured `FormatStats`; without them the csf/alto
    models fall back to the balls-in-bins fiber estimate).
    """
    base_name, preset = _split_candidate(name)
    n, d, r = st.nnz, st.ndim, rank
    out = st.shape[mode] * r * _VAL
    coords = n * d * _IDX
    values = n * _VAL
    gathers = n * (d - 1) * r * _VAL
    base = coords + values + gathers
    if base_name == "ref":
        return base + 2 * n * r * _VAL + out, 0.0, 0.0, 0.0, 0.0
    if base_name == "alto":
        # One packed key stream replaces the coordinate columns (indexed
        # traffic: every key byte is de-interleaved); the ALTO order keeps
        # the 0.75 gather-locality credit, and the sorted segment reduction
        # writes the accumulator once (1x, vs ref's read-modify-write 2x).
        # Past the 64-bit key cap the backend falls back to ALTO-*ordered*
        # COO (see backends._build_alto): explicit coordinate columns move
        # as plain stream bytes and no key is ever decoded.
        fs = _format_stats(st)
        if fs.key_bits > MAX_KEY_BITS:
            return (coords + values + 0.75 * gathers + n * r * _VAL + out,
                    0.0, 0.0, 0.0, 0.0)
        return (values + 0.75 * gathers + n * r * _VAL + out,
                0.0, 0.0, 0.0, fs.alto_index_bytes())
    if base_name == "csf":
        # Fiber reuse: interior gathers + the first reduction level scale
        # with the fiber count, not nnz — only the innermost factor is
        # gathered per nonzero.  The tree's index arrays are indexed bytes.
        fs = _format_stats(st)
        fibers = fs.fiber_counts[mode]
        return (values + n * r * _VAL                    # leaf gathers
                + max(d - 2, 0) * fibers * r * _VAL      # interior gathers
                + 2 * fibers * r * _VAL + out,           # fiber accumulator
                0.0, 0.0, 0.0, fs.csf_index_bytes(mode))
    if base_name in ("chunked", "kernel", "distributed"):
        return out, base + n * r * _VAL, 0.0, 0.0, 0.0
    if base_name == "hetero":
        return out, 0.0, base + n * r * _VAL, 0.0, 0.0
    if base_name == "fixed":
        # Quantized traffic scales with the preset width: w-byte factor
        # gathers and accumulator, 16-bit tensor values.  Coordinates and
        # the dequantized f32 output stay full-width.
        w = _preset_width(preset)
        narrow = (w / _VAL) * gathers + n * _QVAL + (w / _VAL) * n * r * _VAL
        return coords + out, 0.0, 0.0, narrow, 0.0
    # Unknown (user-registered) backend: assume COO-like traffic so it
    # ranks mid-field and still gets probed under a generous budget.
    return base + 2 * n * r * _VAL + out, 0.0, 0.0, 0.0, 0.0


def device_byte_terms(name: str, st, rank: int, mode: int, *,
                      n_devices: int = 1,
                      ) -> tuple[float, float, float, float, float]:
    """`byte_terms` adjusted for the device count: the distributed backend
    splits its traffic across the real device count and adds an output
    all-reduce (to the fixed component — it is not sharded).  This is the
    single source of the per-observation decomposition: `CostModelPrior
    .seconds` consumes it for prediction and `calibrate._design_terms` for
    the training design matrix, so the two cannot drift apart."""
    fixed, padded, densified, narrow, indexed = byte_terms(name, st, rank, mode)
    if _split_candidate(name)[0] == "distributed":
        nd = max(1, n_devices)
        fixed = fixed / nd + 2 * st.shape[mode] * rank * _VAL
        padded /= nd
        densified /= nd
        narrow /= nd
        indexed /= nd
    return fixed, padded, densified, narrow, indexed


@dataclasses.dataclass
class CostModelPrior:
    """Ranks backend candidates by estimated seconds per MTTKRP call.

    `bandwidth` is a sustained-stream guess (B/s) used only to convert bytes
    into comparable seconds so per-call dispatch overheads can be folded in;
    absolute values are meaningless, only the ordering matters.  All
    coefficients here are the hard-coded defaults — `calibrate.CalibratedPrior`
    replaces them with values fitted to the tuning store's measurements.
    """

    bandwidth: float = 2.0e10        # sustained memory bandwidth guess, B/s
    chunk_padding: float = 1.25      # padded-task overhead guess for chunked
    hetero_overhead: float = 1.2     # densified-block traffic multiplier
    #: Effective throughput of quantized-int traffic (B/s).  Bytes are bytes
    #: on the bus, but every narrow byte also pays quantize/dequantize
    #: arithmetic, so calibration may learn a value below `bandwidth`.
    narrow_bandwidth: float = 2.0e10
    #: Effective throughput of format-index traffic (B/s): CSF fiber-tree
    #: levels and ALTO key words carry address arithmetic (tree walks, bit
    #: de-interleaves) on every byte, so calibration may learn a value
    #: below the plain stream bandwidth.
    indexed_bandwidth: float = 2.0e10
    dispatch_s: float = 1e-4         # per-call dispatch overhead
    distributed_dispatch_s: float = 2e-3  # distributed per-call overhead
    #: Per-backend dispatch overrides (seconds); missing backends fall back
    #: to `dispatch_s` / `distributed_dispatch_s`.  Populated by calibration.
    dispatch_overheads: dict[str, float] = dataclasses.field(default_factory=dict)

    def dispatch(self, name: str) -> float:
        """Per-call dispatch overhead for candidate `name`, in seconds.
        Preset variants share their backend's dispatch term ("fixed:int3"
        and "fixed:int7" run the same kernel launch path)."""
        base, _preset = _split_candidate(name)
        if base in self.dispatch_overheads:
            return self.dispatch_overheads[base]
        if base == "distributed":
            return self.distributed_dispatch_s
        return self.dispatch_s

    def bytes_moved(self, name: str, st, rank: int, mode: int) -> float:
        """Estimated bytes moved by one mode-`mode` MTTKRP for `name`
        (single-device traffic; `seconds` applies the device split)."""
        fixed, padded, densified, narrow, indexed = byte_terms(
            name, st, rank, mode)
        return (fixed + self.chunk_padding * padded
                + self.chunk_padding * self.hetero_overhead * densified
                + narrow + indexed)

    def seconds(self, name: str, st, rank: int, mode: int, *,
                n_devices: int = 1) -> float:
        # device_byte_terms splits distributed traffic across the real
        # device count (a single-device host gets no speedup — the mesh
        # degenerates to one shard) and adds the output all-reduce.
        fixed, padded, densified, narrow, indexed = device_byte_terms(
            name, st, rank, mode, n_devices=n_devices)
        t = (fixed + self.chunk_padding * padded
             + self.chunk_padding * self.hetero_overhead * densified
             ) / self.bandwidth
        t += narrow / self.narrow_bandwidth
        t += indexed / self.indexed_bandwidth
        t += self.dispatch(name)
        return t

    def order(self, st, rank: int, candidates: list[str],
              modes: list[int] | None = None, *,
              n_devices: int = 1) -> list[str]:
        """Candidates sorted cheapest-first by estimated total seconds over
        `modes` (ties broken by name, so the ordering is deterministic)."""
        if modes is None:
            modes = list(range(st.ndim))
        def total(name: str) -> float:
            return math.fsum(
                self.seconds(name, st, rank, m, n_devices=n_devices)
                for m in modes)
        return sorted(candidates, key=lambda name: (total(name), name))


#: Shared default instance (the prior is stateless apart from coefficients).
default_prior = CostModelPrior()


def prior_order(st, rank: int, candidates: list[str],
                modes: list[int] | None = None, **kw) -> list[str]:
    """Module-level convenience over `default_prior.order`."""
    return default_prior.order(st, rank, candidates, modes, **kw)
