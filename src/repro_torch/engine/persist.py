"""Persistent autotuner store: measured winners survive the process (the
port's copy of `repro.engine.persist`: the same file format, schema v5,
default path and environment variables, so a store written by either
package loads in the other; the device fingerprint comes from torch).

The paper's finding (Fig. 7) is that the best spMTTKRP strategy is
workload-dependent; the autotuner measures that — but measurement is only
worth its cost if a familiar workload doesn't re-pay it every process.  The
store persists each `AutotuneReport` keyed by a *workload fingerprint*
(tensor shape, nnz, density, mode count, rank, candidate set) plus a
*device fingerprint* of the engine's device (torch backend "cuda" or
"cpu", device count, device kind, torch and CUDA versions), so a repeat decomposition of the same — or a near-identical —
tensor skips the probe phase entirely and dispatches straight to the
persisted per-mode winners.

Matching is exact-or-near: everything in the fingerprint must match
exactly except nnz/density, which tolerate a relative drift (default 10%)
— re-decomposing this week's crawl of last week's tensor should still hit.
A device-fingerprint change (different backend, device count, or torch
version) always invalidates: timings measured on other silicon are noise.
A `device="cpu"` run on the card's machine never serves a CUDA entry, nor
the reverse, and the JAX package's entries (which carry a `jax` version
and no `torch`) never match the port's.

Default store path: `~/.cache/repro/autotune.json`, overridable with the
`REPRO_AUTOTUNE_CACHE` environment variable or the `path` argument.  Writes
are atomic (temp file + rename) and the read-merge-write cycle in `save()`
runs under an advisory file lock (`<path>.lock`, flock), so concurrent
processes filling one store never drop each other's fresh entries; last
writer wins per fingerprint.

Entries can expire: pass `ttl_s=` (or set `REPRO_AUTOTUNE_TTL` seconds) and
`lookup` ignores entries older than the TTL, so a stale workload re-probes —
the device fingerprint can't see silent environment drift (thermal state,
background load, a driver update under the same version string), but a TTL
bounds how long a drifted measurement keeps steering dispatch.  Expired
entries are also excluded from `observations()`, the training-data iterator
the cost-model calibration (calibrate.py) fits against.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import tempfile
import time
from typing import NamedTuple

import torch

from ..device import resolve_device

import fcntl

__all__ = [
    "DEFAULT_STORE_ENV",
    "DEFAULT_TTL_ENV",
    "Observation",
    "StoredEntry",
    "TuningStore",
    "WorkloadKey",
    "budget_covers",
    "device_fingerprint",
    "device_fingerprint_id",
    "resolve_store",
]

DEFAULT_STORE_ENV = "REPRO_AUTOTUNE_CACHE"
DEFAULT_TTL_ENV = "REPRO_AUTOTUNE_TTL"
# v2 adds nothing to the entry layout (per-entry `created` timestamps were
# already written by v1) but marks stores whose entries are TTL-aware and
# near-match-deduplicated; v1 files load unchanged.  v3 adds the optional
# `budget` / `errors` fields (accuracy-budgeted format autotuning); v1/v2
# files load unchanged with budget=None and no recorded errors.  v4 adds the
# optional `format_stats` field — the measured layout statistics
# (repro.formats.FormatStats: per-mode fiber counts, interleave key bits) of
# the tuned tensor, so format candidate ids ("csf"/"alto") round-trip with
# the numbers their byte models need at calibration time; v1-v3 files load
# unchanged with format_stats=None (calibration falls back to the
# balls-in-bins estimate).  v5 adds the optional `capacity` field to the
# workload KEY — the explicit chunk capacity the workload was tuned under
# (None: the partition decider's choice) — so a workload tuned under a
# pinned capacity fingerprints distinctly instead of colliding with the
# default-capacity entry; v1-v4 files load unchanged with capacity=None, which is
# exactly what every pre-v5 writer ran with.  See docs/store-schema.md.
_SCHEMA_VERSION = 5
_READABLE_VERSIONS = (1, 2, 3, 4, 5)


def default_store_path() -> str:
    env = os.environ.get(DEFAULT_STORE_ENV)
    if env:
        return env
    return os.path.join(
        os.path.expanduser("~"), ".cache", "repro", "autotune.json")


def default_ttl_s() -> float | None:
    env = os.environ.get(DEFAULT_TTL_ENV)
    if not env:
        return None
    try:
        ttl = float(env)
    except ValueError:
        return None
    return ttl if ttl > 0 else None


def device_fingerprint(device: str | torch.device | None = None) -> dict[str, str]:
    """What the timings were measured on: the engine's `device` (None: the
    CUDA card, raising where there is none).  Any change invalidates
    entries: a winner measured on other silicon (or another torch) is not a
    prior worth trusting over re-measurement."""
    device = resolve_device(device)
    if device.type == "cuda":
        count, kind = torch.cuda.device_count(), torch.cuda.get_device_name(device)
    else:
        count, kind = 1, device.type
    return {
        "backend": device.type,
        "device_count": str(count),
        "device_kind": kind,
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
    }


def device_fingerprint_id(fp: dict[str, str] | None = None) -> str:
    """Short stable hex id of a device fingerprint.  None: the CUDA
    card's fingerprint."""
    fp = device_fingerprint() if fp is None else fp
    blob = json.dumps(dict(fp), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


@dataclasses.dataclass(frozen=True)
class WorkloadKey:
    """Fingerprint of one (tensor, rank, candidate set, device) workload.

    `capacity` (schema v5) is the *explicit* chunk capacity the workload was
    tuned under, None when the partition decider chose (the default path —
    and the only value pre-v5 stores could have run with, so old entries
    load compatibly).  An explicitly-pinned capacity changes every chunked
    backend's padding, so timings measured under one must not serve
    another.
    """

    shape: tuple[int, ...]
    nnz: int
    density: float
    ndim: int
    rank: int
    candidates: tuple[str, ...]
    device: tuple[tuple[str, str], ...]
    capacity: int | None = None

    @classmethod
    def from_tensor(cls, st, rank: int, candidates, *,
                    capacity: int | None = None,
                    device: str | torch.device | None = None) -> WorkloadKey:
        """The key of `st` tuned at `rank` over `candidates` on `device`
        (None: the CUDA card)."""
        return cls(
            shape=tuple(int(d) for d in st.shape),
            nnz=int(st.nnz),
            density=float(st.density),
            ndim=int(st.ndim),
            rank=int(rank),
            candidates=tuple(sorted(candidates)),
            device=tuple(sorted(device_fingerprint(device).items())),
            capacity=int(capacity) if capacity is not None else None,
        )

    def to_json(self) -> dict:
        return {
            "shape": list(self.shape),
            "nnz": self.nnz,
            "density": self.density,
            "ndim": self.ndim,
            "rank": self.rank,
            "candidates": list(self.candidates),
            "device": {k: v for k, v in self.device},
            "capacity": self.capacity,
        }

    @classmethod
    def from_json(cls, d: dict) -> WorkloadKey:
        cap = d.get("capacity")
        return cls(
            shape=tuple(int(x) for x in d["shape"]),
            nnz=int(d["nnz"]),
            density=float(d["density"]),
            ndim=int(d["ndim"]),
            rank=int(d["rank"]),
            # Sort exactly as `from_tensor` does: a hand-edited or foreign-
            # order entry must still exact-match (and dedup) against the key
            # built from the live candidate list.
            candidates=tuple(sorted(str(c) for c in d["candidates"])),
            device=tuple(sorted((str(k), str(v))
                                for k, v in d["device"].items())),
            capacity=int(cap) if cap is not None else None,
        )

    def fingerprint(self) -> str:
        """Short stable hex id of the whole key (the workload analogue of
        `device_fingerprint_id`), so a trace row can be joined back to the
        store entry it produced."""
        blob = json.dumps(self.to_json(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:12]

    def matches(self, other: WorkloadKey, *, nnz_tol: float = 0.1) -> bool:
        """Exact-or-near: everything exact except nnz/density within a
        relative tolerance (the same tensor re-ingested rarely has the
        byte-identical nonzero count).  `nnz_tol=0` degrades to exact-stat
        matching, so workloads a few percent apart in nnz stay distinct."""
        if (self.shape, self.ndim, self.rank, self.candidates, self.device,
                self.capacity) != (
                other.shape, other.ndim, other.rank, other.candidates,
                other.device, other.capacity):
            return False
        if other.nnz == 0 or self.nnz == 0:
            return self.nnz == other.nnz
        if abs(self.nnz - other.nnz) / other.nnz > nnz_tol:
            return False
        return abs(self.density - other.density) / max(other.density, 1e-30) <= nnz_tol


@dataclasses.dataclass
class StoredEntry:
    """One persisted autotune outcome.

    `budget` is the accuracy budget the entry was tuned under (None: the
    lossless-only default), and `errors` the measured per-mode MTTKRP
    relative errors of the lossy candidates that were probed — together they
    let a later lookup decide whether the persisted winners are *valid* for
    its own budget (see `budget_covers`) instead of trusting blindly.

    `format_stats` (schema v4) is the tuned tensor's measured layout
    statistics as a `repro_torch.formats.FormatStats` JSON dict — fiber counts per
    mode, interleave key width — recorded whenever the candidate space held
    a format backend, so the calibration's csf/alto design columns train on
    the same numbers the live prediction used.
    """

    key: WorkloadKey
    winners: dict[int, str]                # mode -> candidate id
    timings: dict[str, dict[int, float]]   # candidate -> mode -> best seconds
    overall: str | None = None             # fallback for untimed modes
    warmup: int = 1
    reps: int = 2
    created: float = 0.0
    budget: float | None = None            # accuracy budget tuned under
    errors: dict[str, dict[int, float]] = dataclasses.field(
        default_factory=dict)              # candidate -> mode -> rel error
    format_stats: dict | None = None       # FormatStats.to_json() payload

    def to_json(self) -> dict:
        return {
            "key": self.key.to_json(),
            "winners": {str(m): n for m, n in self.winners.items()},
            "timings": {n: {str(m): t for m, t in per.items()}
                        for n, per in self.timings.items()},
            "overall": self.overall,
            "warmup": self.warmup,
            "reps": self.reps,
            "created": self.created,
            "budget": self.budget,
            "errors": {n: {str(m): e for m, e in per.items()}
                       for n, per in self.errors.items()},
            "format_stats": self.format_stats,
        }

    @classmethod
    def from_json(cls, d: dict) -> StoredEntry:
        budget = d.get("budget")
        fstats = d.get("format_stats")
        return cls(
            key=WorkloadKey.from_json(d["key"]),
            winners={int(m): str(n) for m, n in d["winners"].items()},
            timings={n: {int(m): float(t) for m, t in per.items()}
                     for n, per in d.get("timings", {}).items()},
            overall=d.get("overall"),
            warmup=int(d.get("warmup", 1)),
            reps=int(d.get("reps", 2)),
            created=float(d.get("created", 0.0)),
            budget=float(budget) if budget is not None else None,
            errors={n: {int(m): float(e) for m, e in per.items()}
                    for n, per in d.get("errors", {}).items()},
            format_stats=dict(fstats) if isinstance(fstats, dict) else None,
        )


#: Sentinel: "don't filter on budget" (distinct from None, which is the
#: real lossless-only budget value).
_ANY_BUDGET = object()


def budget_covers(stored: float | None, requested: float | None) -> bool:
    """Whether winners tuned under `stored` remain valid for `requested`.

    Matching or looser requests reuse the entry: every admitted candidate's
    measured error was <= the stored budget, so it is also <= any looser
    one.  Everything else re-probes — a *stricter* request could be handed
    an over-budget winner, a `None` (lossless-only) request must never
    dispatch to a lossy winner tuned under some budget, and a budgeted
    request can't trust an entry that never measured errors at all.
    """
    if stored is None:
        return requested is None
    if requested is None:
        return False
    return requested >= stored


def _drop_shadowed(entries: list[StoredEntry], *,
                   nnz_tol: float = 0.1) -> list[StoredEntry]:
    """Keep only the newest of any near-matching cluster: an entry recorded
    later supersedes older entries its key near-matches (they would only
    shadow each other in `lookup`).  Exact-duplicate keys are expected to be
    merged by the caller already.  `nnz_tol=0` keeps every distinct
    fingerprint: workloads a few percent apart in nnz are then deliberate
    points, not drift."""
    kept: list[StoredEntry] = []
    for e in sorted(entries, key=lambda e: e.created):
        kept = [k for k in kept if not e.key.matches(k.key, nnz_tol=nnz_tol)]
        kept.append(e)
    return kept


class Observation(NamedTuple):
    """One measured (workload, backend, mode) → seconds data point — the
    training rows the cost-model calibration fits against.  `format_stats`
    carries the entry's persisted layout statistics (schema v4) when
    present, so the csf/alto design columns train on measured fiber
    counts."""

    key: WorkloadKey
    backend: str
    mode: int
    seconds: float
    created: float
    format_stats: dict | None = None


class TuningStore:
    """JSON-file store of autotune outcomes.

    Lookup is linear over entries (stores hold tens of workloads, not
    millions); exact fingerprint matches win over near matches, and among
    near matches the closest nnz wins.

    `ttl_s` (default: the `REPRO_AUTOTUNE_TTL` env var, else no expiry)
    bounds how long an entry steers dispatch: entries older than the TTL are
    invisible to `lookup` and `observations`, so the workload re-probes and
    the fresh measurement replaces the stale one.  A TTL of 0 or less means
    "no expiry" here exactly as it does in the env var, so `ttl_s=0` is the
    explicit opt-out when the environment sets a TTL.  Entries with no
    recorded timestamp (`created == 0`, from pre-v2 stores) count as stale
    whenever a TTL is in force — unknown age is not trusted age.

    `nnz_tol` is the store's near-match policy (default 0.1): the relative
    nnz/density drift `lookup` tolerates AND the radius within which
    `record`/`save` treat entries as superseding each other.  With
    `nnz_tol=0`, workloads a few percent apart in nnz neither serve each
    other warm nor dedup each other away.
    """

    def __init__(self, path: str | os.PathLike | None = None, *,
                 ttl_s: float | None = None, nnz_tol: float = 0.1):
        self.path = os.fspath(path) if path is not None else default_store_path()
        self.ttl_s = ((ttl_s if ttl_s > 0 else None)
                      if ttl_s is not None else default_ttl_s())
        if nnz_tol < 0:
            raise ValueError(f"nnz_tol is a relative drift tolerance and "
                             f"must be >= 0 (got {nnz_tol})")
        self.nnz_tol = float(nnz_tol)
        self._entries: list[StoredEntry] | None = None  # lazy-loaded
        #: Keys `forget()` removed but save() hasn't published yet: the
        #: read-merge-write in save() would otherwise resurrect them from
        #: the on-disk copy (merging can only add/update, never delete).
        self._forgotten: set[WorkloadKey] = set()

    def expired(self, entry: StoredEntry, *, now: float | None = None) -> bool:
        if self.ttl_s is None:
            return False
        now = time.time() if now is None else now
        return (now - entry.created) > self.ttl_s

    # -- I/O ---------------------------------------------------------------
    def _read_disk(self) -> list[StoredEntry]:
        try:
            with open(self.path) as f:
                raw = json.load(f)
            if isinstance(raw, dict) and raw.get("version") in _READABLE_VERSIONS:
                return [StoredEntry.from_json(e) for e in raw.get("entries", [])]
        except FileNotFoundError:
            pass
        except (json.JSONDecodeError, KeyError, TypeError, ValueError, OSError):
            # A corrupt or foreign-schema store must never take the
            # decomposition down — fall back to cold-start behaviour.
            pass
        return []

    def _load(self) -> list[StoredEntry]:
        if self._entries is None:
            self._entries = self._read_disk()
        return self._entries

    @contextlib.contextmanager
    def _save_lock(self):
        """Advisory inter-process lock (`<path>.lock`, flock) serializing
        the read-merge-write cycle in `save`."""
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        with open(self.path + ".lock", "a") as lf:
            fcntl.flock(lf.fileno(), fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lf.fileno(), fcntl.LOCK_UN)

    def _merge_and_write(self) -> None:
        # Merge with what's on disk right now, not with our lazily-cached
        # snapshot: concurrent processes sharing a store must lose at most
        # a racing write to the *same* fingerprint, never other workloads'
        # entries.  (The rename below is atomic; this read-merge-write makes
        # "last writer wins" hold per fingerprint rather than per file.)
        by_key = {e.key: e for e in self._read_disk()
                  if e.key not in self._forgotten}
        by_key.update({e.key: e for e in self._load()})
        self._entries = _drop_shadowed(list(by_key.values()),
                                       nnz_tol=self.nnz_tol)
        payload = {
            "version": _SCHEMA_VERSION,
            "entries": [e.to_json() for e in self._entries],
        }
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".autotune-", suffix=".json", dir=d)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1)
            os.replace(tmp, self.path)  # atomic: concurrent readers see old/new
            self._forgotten.clear()     # the deletions are published now
        except BaseException:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            raise

    def save(self) -> None:
        """Write the store to disk, merged with concurrent writers' entries.

        The read-merge-write cycle runs under an advisory flock on
        `<path>.lock`: without it, two writers that both read before either
        renamed would each publish a payload missing the other's fresh
        fingerprints — the second rename wins and silently drops the
        first's work.
        """
        with self._save_lock():
            self._merge_and_write()

    # -- queries -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._load())

    def entries(self) -> list[StoredEntry]:
        return list(self._load())

    def lookup(self, key: WorkloadKey, *, nnz_tol: float | None = None,
               budget: float | None | object = _ANY_BUDGET,
               ) -> StoredEntry | None:
        """Exact-or-near fingerprint match (see `WorkloadKey.matches`),
        ignoring entries past the store's TTL — stale winners re-probe.
        `nnz_tol` defaults to the store's policy (`self.nnz_tol`).

        `budget` (when given) additionally requires the entry's tuning
        budget to cover the requested one (`budget_covers`): an entry tuned
        under a stricter-or-equal budget serves a looser request, anything
        else is invisible and the workload re-probes."""
        nnz_tol = self.nnz_tol if nnz_tol is None else nnz_tol
        now = time.time()
        best: StoredEntry | None = None
        best_dist = float("inf")
        for e in self._load():
            if self.expired(e, now=now):
                continue
            if budget is not _ANY_BUDGET and not budget_covers(e.budget, budget):
                continue
            if e.key == key:
                return e
            if key.matches(e.key, nnz_tol=nnz_tol):
                dist = abs(e.key.nnz - key.nnz) / max(key.nnz, 1)
                if dist < best_dist:
                    best, best_dist = e, dist
        return best

    def observations(self, *, device: dict[str, str] | None = None,
                     include_expired: bool = False) -> list[Observation]:
        """Flatten every persisted timing into (key, backend, mode, seconds)
        training rows.  `device` filters to entries measured on one device
        fingerprint (pass `device_fingerprint(dev)` for a device); expired
        entries are excluded unless `include_expired` — stale timings are no
        better as training data than as dispatch decisions."""
        want = tuple(sorted(device.items())) if device is not None else None
        now = time.time()
        rows: list[Observation] = []
        for e in self._load():
            if not include_expired and self.expired(e, now=now):
                continue
            if want is not None and e.key.device != want:
                continue
            for backend, per_mode in e.timings.items():
                for mode, t in per_mode.items():
                    rows.append(Observation(e.key, backend, int(mode),
                                            float(t), e.created,
                                            e.format_stats))
        return rows

    def record(self, key: WorkloadKey, winners: dict[int, str],
               timings: dict[str, dict[int, float]], *,
               overall: str | None = None, warmup: int = 1, reps: int = 2,
               budget: float | None = None,
               errors: dict[str, dict[int, float]] | None = None,
               format_stats: dict | None = None,
               save: bool = True) -> StoredEntry:
        """Insert the entry for `key`, replacing the exact fingerprint AND
        any near-match it supersedes (within the store's `nnz_tol` policy):
        without the latter, repeated decompositions of a slowly drifting
        tensor (nnz creeping within the ±10% near-match window) accumulate
        entries that shadow each other in `lookup`, growing the store
        without bound.  A `nnz_tol=0` store keeps every distinct
        fingerprint, and no entry supersedes its neighbours."""
        entry = StoredEntry(key=key, winners=dict(winners),
                            timings={n: dict(p) for n, p in timings.items()},
                            overall=overall, warmup=warmup, reps=reps,
                            created=time.time(), budget=budget,
                            errors={n: dict(p)
                                    for n, p in (errors or {}).items()},
                            format_stats=format_stats)
        entries = self._load()
        self._entries = [*(e for e in entries
                           if e.key != key
                           and not key.matches(e.key, nnz_tol=self.nnz_tol)),
                         entry]
        if save:
            self.save()
        return entry

    def forget(self, key: WorkloadKey, *, save: bool = True) -> bool:
        """Drop the exact-fingerprint entry for `key`, if present, so the
        next tune of that workload re-measures instead of being served warm
        from the stale entry.

        The removal is remembered until the next successful `save()`:
        save's read-merge-write would otherwise resurrect the entry from
        the on-disk copy (merging can only add/update)."""
        entries = self._load()
        kept = [e for e in entries if e.key != key]
        if len(kept) == len(entries):
            return False
        self._entries = kept
        self._forgotten.add(key)
        if save:
            self.save()
        return True

    def clear(self) -> None:
        """Drop all entries and delete the backing file (and its lock)."""
        self._entries = []
        with contextlib.suppress(FileNotFoundError):
            os.unlink(self.path)
        with contextlib.suppress(FileNotFoundError):
            os.unlink(self.path + ".lock")

    def __repr__(self) -> str:
        return f"TuningStore({self.path!r}, entries={len(self)})"


def resolve_store(store) -> TuningStore | None:
    """Normalize the `store=` argument accepted by the autotuner:
    None/False → no persistence; True → default path (env-overridable);
    str/PathLike → that path; TuningStore → itself."""
    if store is None or store is False:
        return None
    if store is True:
        return TuningStore()
    if isinstance(store, TuningStore):
        return store
    return TuningStore(store)
