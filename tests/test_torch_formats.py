"""The port's format subsystem (`repro_torch.formats`, the CSF/ALTO ops, the
baselines and the `alto`/`csf` backends) against the JAX package on the CPU.

Host layouts are held byte for byte, field by field.  MTTKRP is held per
mode within 1e-5 relative (Frobenius norm), the reference's own gate
(tests/test_formats.py): the port sums with `index_add_` where the reference
runs a sorted `segment_sum`, so only the order of the float32 sums may
differ.  Fit histories are held per iteration at 1e-6, as in
tests/test_torch_cpals.py.
"""
import gc
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro import formats as rf
from repro.core import baselines as rbase
from repro.core import cp_als, random_tensor, table1_tensor
from repro.core import mttkrp as rmttkrp
from repro.core.sptensor import TABLE1
from repro_torch import formats as pf
from repro_torch.core import baselines as pbase
from repro_torch.engine import PlanCache

REL_TOL = 1e-5
FIT_ATOL = 1e-6
LBNL_SHAPE = (1605, 4198, 1631, 4209, 868131)  # 68 ALTO key bits (published dims)

# (label, shape, nnz, distribution, seed): the edge shapes of
# tests/test_formats.py::test_roundtrip_edge_cases and a seed sweep.
EDGE = [
    ("empty", (4, 5, 6), 0, "uniform", 9),
    ("one_nonzero", (4, 5, 6), 1, "uniform", 9),
    ("size1_mode", (5, 1, 7), 20, "uniform", 9),
    ("all_size1", (1, 1, 1), 1, "uniform", 9),
    ("two_modes", (9, 3), 12, "uniform", 9),
]
SWEEP = [(f"seed{s}_{d}", (30, 24, 36, 5)[: 3 + s % 2], 300 + 50 * s, d, s)
         for s in range(4) for d in ("uniform", "powerlaw")]
CASES = EDGE + SWEEP


def _tensors(shape, nnz, distribution, seed):
    """The same tensor from both packages (their generators are held
    byte-identical by tests/test_torch_host.py)."""
    return (random_tensor(shape, nnz, distribution=distribution, seed=seed),
            rt.random_tensor(shape, nnz, distribution=distribution, seed=seed))


def _table1(name, nnz=None):
    return table1_tensor(name, nnz=nnz), rt.table1_tensor(name, nnz=nnz)


def _assert_bytes(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


def _assert_alto_equal(got, want):
    for f in ("key_words", "values", "perm"):
        _assert_bytes(getattr(got, f), getattr(want, f), f)
    assert got.positions == want.positions
    assert got.shape == want.shape
    assert (got.key_bits, got.n_words, got.index_bytes) == (want.key_bits, want.n_words,
                                                            want.index_bytes)


def _assert_csf_equal(got, want):
    for f in ("perm", "inner_coord", "values", "fiber_ids", "fiber_coords"):
        _assert_bytes(getattr(got, f), getattr(want, f), f)
    assert (got.mode, got.inner_mode, got.mid_modes, got.shape) == (
        want.mode, want.inner_mode, want.mid_modes, want.shape)
    assert (got.n_fibers, got.index_bytes) == (want.n_fibers, want.index_bytes)


def _assert_coo_equal(got, want):
    _assert_bytes(got.coords, want.coords, "coords")
    _assert_bytes(got.values, want.values, "values")
    assert tuple(got.shape) == tuple(want.shape)


def _layout_cases():
    cases = [pytest.param(("table1", name), id=f"table1-{name}") for name in sorted(TABLE1)]
    cases += [pytest.param(("random", *c[1:]), id=c[0]) for c in CASES]
    return cases


def _pair(case):
    if case[0] == "table1":
        return _table1(case[1])
    return _tensors(*case[1:])


# ---------------------------------------------------------------------------
# Host layouts: byte-identical to the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", _layout_cases())
def test_layouts_byte_identical(case):
    st, pst = _pair(case)
    _assert_alto_equal(rt.build_alto(pst), rf.build_alto(st))
    for mode in range(st.ndim):
        _assert_csf_equal(rt.build_csf_tree(pst, mode), rf.build_csf_tree(st, mode))
        assert rt.fiber_count(pst, mode) == rf.fiber_count(st, mode)
        assert pf.csf_mode_order(pst.shape, mode) == rf.csf_mode_order(st.shape, mode)
    for mode in range(st.ndim):
        _assert_bytes(pf.alto.alto_decode_mode(rt.build_alto(pst), mode),
                      rf.alto.alto_decode_mode(rf.build_alto(st), mode), "decode")


@pytest.mark.parametrize("case", [pytest.param(c[1:], id=c[0]) for c in CASES])
def test_conversions_round_trip_like_the_reference(case):
    """Every conversion gives the reference's arrays, and the round trips
    give back the tensor's (coords, values) multiset and its dense form."""
    st, pst = _tensors(*case)
    ref_alto = rf.coo_to_alto(st)
    _assert_alto_equal(pf.coo_to_alto(pst), ref_alto)
    back = pf.alto_to_coo(pf.coo_to_alto(pst))
    _assert_coo_equal(back, rf.alto_to_coo(ref_alto))
    np.testing.assert_array_equal(back.to_dense(), pst.to_dense())
    for mode in range(st.ndim):
        ref_tree = rf.coo_to_csf(st, mode)
        tree = pf.coo_to_csf(pst, mode)
        _assert_csf_equal(tree, ref_tree)
        back = pf.csf_to_coo(tree)
        _assert_coo_equal(back, rf.csf_to_coo(ref_tree))
        np.testing.assert_array_equal(back.to_dense(), pst.to_dense())
        _assert_alto_equal(pf.csf_to_alto(tree), rf.csf_to_alto(ref_tree))
        _assert_csf_equal(pf.alto_to_csf(pf.coo_to_alto(pst), mode),
                          rf.alto_to_csf(ref_alto, mode))


@pytest.mark.parametrize("shape", [
    (533, 17300, 2500, 140), (12092, 9184, 28818), LBNL_SHAPE, (1, 1, 1), (2, 3), (9, 3),
    *(spec["shape"] for _, spec in sorted(TABLE1.items())),
])
def test_alto_positions_and_key_bits(shape):
    assert pf.alto_positions(shape) == rf.alto_positions(shape)
    assert pf.alto_key_bits(shape) == rf.alto_key_bits(shape)
    flat = [p for per in pf.alto_positions(shape) for p in per]
    assert sorted(flat) == list(range(pf.alto_key_bits(shape)))


def test_alto_key_width_guard():
    """Past 64 key bits `build_alto` refuses, as the reference does; LBNL's
    published dims need 68 bits, NELL-2's 43."""
    assert pf.alto_key_bits(LBNL_SHAPE) == 68
    assert pf.alto_key_bits((12092, 9184, 28818)) == 43
    huge = rt.SparseTensor(np.zeros((1, 3), np.int32), np.ones(1, np.float32),
                           (1 << 30, 1 << 30, 1 << 30))
    with pytest.raises(ValueError, match="key needs 90 bits"):
        rt.build_alto(huge)
    small_lbnl = rt.random_tensor(LBNL_SHAPE, 50, distribution="powerlaw", seed=0)
    with pytest.raises(ValueError, match="key needs 68 bits"):
        rt.build_alto(small_lbnl)


@pytest.mark.parametrize(("shape", "nnz", "distribution"), [
    (LBNL_SHAPE, 3000, "powerlaw"),     # 68 bits: the int64 key's top bits wrap
    ((1 << 20, 1 << 22, 1 << 21), 2000, "uniform"),  # 63 bits: the sign bit is set
    ((605, 460, 1440), 2000, "uniform"),
])
def test_alto_order_identical(shape, nnz, distribution):
    st, pst = _tensors(shape, nnz, distribution, 0)
    _assert_bytes(pbase.alto_order(pst.coords, pst.shape), rbase.alto_order(st.coords, st.shape),
                  "alto_order")


# ---------------------------------------------------------------------------
# FormatStats, the format registry and FormatCache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", _layout_cases())
def test_format_stats_equal_reference(case):
    st, pst = _pair(case)
    got, want = pf.FormatStats.from_tensor(pst), rf.FormatStats.from_tensor(st)
    assert got.to_json() == want.to_json()
    est, ref_est = pf.FormatStats.estimate(pst.shape, pst.nnz), rf.FormatStats.estimate(
        st.shape, st.nnz)
    assert est.to_json() == ref_est.to_json()
    for stats, ref in ((got, want), (est, ref_est)):
        assert stats.coo_index_bytes() == ref.coo_index_bytes()
        assert stats.alto_index_bytes() == ref.alto_index_bytes()
        assert [stats.csf_index_bytes(m) for m in range(st.ndim)] == [
            ref.csf_index_bytes(m) for m in range(st.ndim)]
        blob = json.loads(json.dumps(stats.to_json()))
        assert pf.FormatStats.from_json(blob) == stats
        assert rf.FormatStats.from_json(blob).to_json() == stats.to_json()


def test_format_stats_match_built_layouts():
    """The measured index bytes are the built layouts' own."""
    pst = rt.table1_tensor("delicious", nnz=3000)
    stats = pf.FormatStats.from_tensor(pst)
    assert stats.alto_index_bytes() == rt.build_alto(pst).index_bytes
    for mode in range(pst.ndim):
        tree = rt.build_csf_tree(pst, mode)
        assert stats.fiber_counts[mode] == tree.n_fibers
        assert stats.csf_index_bytes(mode) == tree.index_bytes


def test_format_registry_matches_reference():
    got, want = rt.registered_formats(), rf.registered_formats()
    assert sorted(got) == sorted(want) == ["alto", "coo", "csf"]
    for name in got:
        g, w = got[name], want[name]
        assert (g.mode_agnostic, g.sorted_reduce) == (w.mode_agnostic, w.sorted_reduce)
    assert pf.format_table(None).splitlines()[:2] == rf.format_table(None).splitlines()[:2]
    pst = rt.table1_tensor("nell2", nnz=500)
    assert pf.get_format("coo").build(pst) is pst
    _assert_csf_equal(pf.get_format("csf").build(pst, 1), rt.build_csf_tree(pst, 1))
    _assert_alto_equal(pf.get_format("alto").build(pst), rt.build_alto(pst))
    with pytest.raises(ValueError, match="unknown format"):
        pf.get_format("blco")


def test_format_cache_hits_misses_and_eviction():
    """The reference's counters (tests/test_formats.py), with device tensors
    keyed by device and entries evicted with the tensor."""
    st = rt.random_tensor((20, 16, 24), 300, seed=5)
    fc = pf.FormatCache()
    t0 = fc.csf(st, 0)
    assert fc.csf(st, 0) is t0
    assert fc.csf(st, 1) is not t0
    a0 = fc.alto(st)
    assert fc.alto(st) is a0
    d0 = fc.device_csf(st, 0, "cpu")
    assert fc.device_csf(st, 0, torch.device("cpu")) is d0
    assert fc.device_alto(st, "cpu") is fc.device_alto(st, "cpu")
    assert fc.stats.csf_misses == 2
    assert fc.stats.csf_hits == 2  # one direct hit, one from device_csf's miss
    assert fc.stats.alto_misses == 1
    assert fc.stats.alto_hits == 2  # likewise
    assert (fc.stats.device_misses, fc.stats.device_hits) == (2, 2)
    assert fc.device_csf(st, 0, "meta") is not d0  # another device, another entry
    assert fc.stats.device_misses == 3
    s = fc.format_stats(st)
    assert fc.format_stats(st) is s
    # ALTO's device words are the layout's uint32 words, reinterpreted
    dev = fc.device_alto(st, "cpu")
    assert dev["key_words"].dtype == torch.int32
    assert dev["key_words"].numpy().tobytes() == a0.key_words.tobytes()
    del st, t0, a0, d0, dev
    gc.collect()
    assert not (fc._csf or fc._alto or fc._device or fc._stats)
    st = rt.random_tensor((20, 16, 24), 300, seed=5)
    fc.csf(st, 0)
    fc.clear()
    assert fc.stats == pf.FormatCacheStats()
    fc.csf(st, 0)
    assert fc.stats.csf_misses == 1


# ---------------------------------------------------------------------------
# MTTKRP over the layouts, against the reference's ops
# ---------------------------------------------------------------------------

def _factors(shape, rank, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (d, rank)).astype(np.float32) for d in shape]


def _assert_rel_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert rel <= REL_TOL, (what, rel)


OP_CASES = [
    pytest.param(("random", (30, 24, 36), 800, "uniform", 2), id="3d"),
    pytest.param(("random", (12, 30, 8, 9), 600, "powerlaw", 4), id="4d-powerlaw"),
    pytest.param(("table1", "lbnl"), id="table1-lbnl"),
    pytest.param(("table1", "delicious"), id="table1-delicious"),
    *(pytest.param(("random", *c[1:]), id=c[0]) for c in EDGE),
]


@pytest.mark.parametrize("case", OP_CASES)
def test_mttkrp_csf_and_alto_match_reference(case):
    st, pst = _pair(case)
    fs = _factors(st.shape, 6)
    jf, tf = tuple(jnp.asarray(f) for f in fs), [torch.from_numpy(f) for f in fs]
    at, pat = rf.build_alto(st), rt.build_alto(pst)
    words = torch.from_numpy(pat.key_words.view(np.int32))
    for mode in range(st.ndim):
        out_dim = st.shape[mode]
        want = rmttkrp.mttkrp_alto(jf, jnp.asarray(at.key_words), jnp.asarray(at.values),
                                   mode=mode, positions=at.positions, out_dim=out_dim)
        got = rt.mttkrp_alto(tf, words, torch.from_numpy(pat.values), mode=mode,
                             positions=pat.positions, out_dim=out_dim)
        _assert_rel_close(got, want, ("alto", mode))
        tree, ptree = rf.build_csf_tree(st, mode), rt.build_csf_tree(pst, mode)
        want = rmttkrp.mttkrp_csf(
            jf, jnp.asarray(tree.inner_coord), jnp.asarray(tree.values),
            jnp.asarray(tree.fiber_ids), jnp.asarray(tree.fiber_coords), mode=mode,
            inner_mode=tree.inner_mode, mid_modes=tree.mid_modes, out_dim=out_dim,
            n_fibers=tree.n_fibers)
        got = rt.mttkrp_csf(
            tf, *(torch.from_numpy(getattr(ptree, f))
                  for f in ("inner_coord", "values", "fiber_ids", "fiber_coords")),
            mode=mode, inner_mode=ptree.inner_mode, mid_modes=ptree.mid_modes,
            out_dim=out_dim, n_fibers=ptree.n_fibers)
        _assert_rel_close(got, want, ("csf", mode))


@pytest.mark.parametrize(("shape", "nnz", "distribution"), [
    (LBNL_SHAPE, 3000, "powerlaw"),
    ((30, 24, 36), 800, "uniform"),
])
def test_baselines_match_reference(shape, nnz, distribution):
    """Both baselines over ALTO-ordered coordinates, including a shape past
    64 key bits (the `alto` backend's fallback)."""
    st, pst = _tensors(shape, nnz, distribution, 3)
    order = pbase.alto_order(pst.coords, pst.shape)
    fs = _factors(shape, 5)
    jf, tf = tuple(jnp.asarray(f) for f in fs), [torch.from_numpy(f) for f in fs]
    jc, jv = jnp.asarray(st.coords[order]), jnp.asarray(st.values[order])
    tc, tv = torch.from_numpy(pst.coords[order]), torch.from_numpy(pst.values[order])
    for mode in range(len(shape)):
        for ref_op, op in ((rbase.mttkrp_alto, pbase.mttkrp_alto),
                           (rbase.mttkrp_plain_coo, pbase.mttkrp_plain_coo)):
            want = ref_op(jf, jc, jv, mode=mode, out_dim=shape[mode])
            _assert_rel_close(op(tf, tc, tv, mode=mode, out_dim=shape[mode]), want,
                              (op.__name__, mode))


# ---------------------------------------------------------------------------
# The `alto` and `csf` backends and CP-ALS through them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["csf", "alto"])
@pytest.mark.parametrize("tname", sorted(TABLE1))
def test_backend_matches_reference_on_every_table1_tensor(tname, backend):
    """`build_engine(st, "csf"/"alto", device="cpu")` within 1e-5 relative of
    the reference's COO MTTKRP, every mode of every TABLE1 tensor at the
    reference test's nnz=4000."""
    st, pst = _table1(tname, nnz=4000)
    fs = _factors(st.shape, 6)
    eng = rt.build_engine(pst, backend, 6, device="cpu", plans=PlanCache(),
                          formats=pf.FormatCache())
    assert eng.name == backend and eng.context.device == torch.device("cpu")
    for mode in range(st.ndim):
        want = rmttkrp.mttkrp_coo(tuple(jnp.asarray(f) for f in fs), jnp.asarray(st.coords),
                                  jnp.asarray(st.values), mode=mode, out_dim=st.shape[mode])
        out = eng([torch.from_numpy(f) for f in fs], mode)
        assert tuple(out.shape) == (st.shape[mode], 6)
        _assert_rel_close(out, want, (tname, backend, mode))


def test_alto_backend_takes_the_ordered_coo_baseline_past_64_bits():
    """LBNL's published dims need 68 key bits: the backend decides from
    `alto_key_bits` (no layout is built) and matches the reference's
    fallback engine per mode."""
    from repro.engine import PlanCache as RefPlanCache
    from repro.engine import build_engine as ref_build_engine
    st, pst = _tensors(LBNL_SHAPE, 3000, "powerlaw", 1)
    fc = pf.FormatCache()
    eng = rt.build_engine(pst, "alto", 4, device="cpu", formats=fc)
    assert fc.stats == pf.FormatCacheStats()  # no ALTO layout was attempted
    ref = ref_build_engine(st, "alto", 4, plans=RefPlanCache(), formats=rf.FormatCache())
    fs = _factors(LBNL_SHAPE, 4)
    for mode in range(5):
        want = ref(tuple(jnp.asarray(f) for f in fs), mode)
        _assert_rel_close(eng([torch.from_numpy(f) for f in fs], mode), want, mode)


def test_backends_share_the_format_cache():
    """CP-ALS builds each layout once and moves it once: the `csf` backend
    builds one tree per mode, lazily; `alto` one linearization."""
    pst = rt.table1_tensor("nell2", nnz=2000)
    fc = pf.FormatCache()
    rt.cp_als(pst, 4, n_iters=3, engine="csf", device="cpu", formats=fc)
    assert (fc.stats.csf_misses, fc.stats.device_misses) == (3, 3)
    assert fc.stats.device_hits == 3 * 3 - 3
    rt.cp_als(pst, 4, n_iters=2, engine="alto", device="cpu", formats=fc)
    assert (fc.stats.alto_misses, fc.stats.device_misses) == (1, 4)


@pytest.fixture(scope="module")
def reference_fits():
    """JAX cp_als through `alto` and `csf`, once per tensor."""
    out = {}
    for name in ("nell2", "lbnl"):
        st = table1_tensor(name)
        for eng in ("alto", "csf"):
            out[(name, eng)] = cp_als(st, 10, 3, engine=eng)
    return out


@pytest.mark.parametrize("name", ["nell2", "lbnl"])
@pytest.mark.parametrize("engine", ["alto", "csf"])
def test_cpals_fit_matches_reference(reference_fits, name, engine):
    want = reference_fits[(name, engine)]
    got = rt.cp_als(rt.table1_tensor(name), 10, 3, engine=engine, device="cpu")
    assert got.engine == engine and got.quant_error is None
    np.testing.assert_allclose(got.fit_history, want.fit_history, rtol=0, atol=FIT_ATOL)
    np.testing.assert_allclose(got.diff_history, want.diff_history, rtol=0, atol=FIT_ATOL)


def test_cpals_fit_matches_reference_past_64_bits():
    """CP-ALS through the `alto` fallback on an LBNL-shaped tensor."""
    st, pst = _tensors(LBNL_SHAPE, 3000, "powerlaw", 2)
    want = cp_als(st, 4, 3, engine="alto")
    got = rt.cp_als(pst, 4, 3, engine="alto", device="cpu")
    np.testing.assert_allclose(got.fit_history, want.fit_history, rtol=0, atol=FIT_ATOL)
    np.testing.assert_allclose(got.diff_history, want.diff_history, rtol=0, atol=FIT_ATOL)


@pytest.mark.parametrize("engine", ["alto", "csf", "hetero"])
def test_new_backends_need_a_card_unless_asked_for_the_cpu(monkeypatch, engine):
    """Without `device=` the backends run on the CUDA card, and raise where
    there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pst = rt.table1_tensor("nell2", nnz=500)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.build_engine(pst, engine, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.cp_als(pst, 4, 1, engine=engine)


def test_engine_keywords_name_the_new_fields():
    pst = rt.table1_tensor("nell2", nnz=500)
    with pytest.raises(TypeError, match="did you mean 'dense_fraction'"):
        rt.build_engine(pst, "hetero", 4, device="cpu", dense_fractoin=0.5)
    with pytest.raises(TypeError, match="did you mean 'formats'"):
        rt.cp_als(pst, 4, 1, engine="csf", device="cpu", format=pf.FormatCache())
    ctx = rt.build_engine(pst, "csf", 4, device="cpu").context
    assert ctx.formats is rt.default_format_cache and ctx.dense_fraction is None
