"""The port's fixed-point slice (paper Alg. 2) against the JAX package on the
CPU.  Same inputs on both sides, made with numpy from a seed.

Tolerances:
  * quantization (`QFormat.quantize`, `quantize_np`), the fixed MTTKRP ops,
    the kernel wrapper's plain path, the full op and the `fixed` engine's
    output on given factors: bit-exact (integers; the dequantization divides
    by a power of two);
  * `wave_collision_mask`: equal;
  * `cp_als(engine="fixed")` per iteration: fit and diff within 1e-5
    absolute plus 1e-3 relative, `quant_error` within 1% relative.  The
    float steps between MTTKRPs (Gram products, `pinv`) round differently in
    the two packages, and a factor entry within float32 rounding of a
    quantization half-step can round to the neighbouring step; that moves
    the next MTTKRP by one step in one entry, which a converging fit sees at
    the 1e-7 level and `quant_error` (a ratio of two norms, one of them of
    the quantization noise) at 1e-3.  Int7 on LBNL's five modes diverges, in
    both packages (fit about -2.5 by the third iteration), and there one
    step moves fit and diff by about 1e-4 of their size: hence the relative
    term.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import chunk_tensor, cp_als, random_tensor, table1_tensor
from repro.core import lockfree as ref_lockfree
from repro.core import mttkrp as ref_mttkrp
from repro.core import qformat as ref_qformat
from repro.engine import build_engine as ref_build_engine
from repro.engine import candidate_lossless as ref_candidate_lossless
from repro.engine import parse_candidate as ref_parse_candidate
from repro.kernels import mttkrp_fixed_pallas
from repro.kernels import ref as kref
from repro.kernels.mttkrp_fixed_kernel import mttkrp_fixed_pallas_local
from repro.kernels.ops import pad_factor
from repro_torch.core import qformat as pt_qformat
from repro_torch.core.cpals import _exact_mttkrp
from repro_torch.kernels import mttkrp_fixed_kernel
from repro_torch.kernels import ref as pref

SWEEP = [
    # shape, nnz, chunk_shape, capacity, rank (tests/test_kernels.py SWEEP[:3])
    ((32, 32, 32), 400, (8, 8, 8), 16, 4),
    ((40, 30, 50), 600, (16, 8, 16), 32, 8),
    ((17, 23, 9), 200, (8, 8, 4), 16, 3),
]
FORMATS = [("Q9_7", 0), ("Q17_15", 3)]
CASES = [(*case, qf, shift) for case in SWEEP for qf, shift in FORMATS] + [
    (*SWEEP[0], "Q5_3", 0),
    ((20, 12, 20, 12), 300, (8, 4, 8, 4), 32, 5, "Q17_15", 3),
]
FIT_ATOL = 1e-5
FIT_RTOL = 1e-3
QUANT_RTOL = 1e-2
N_ITERS = 3


def _setup(shape, nnz, cs, cap, rank, qf_name, seed=2, scale=1.0):
    """Reference tensor and chunking, float factors, the value format and
    both packages' quantized inputs."""
    st = random_tensor(shape, nnz, seed=seed)
    rng = np.random.default_rng(seed + 1)
    factors = [(scale * rng.uniform(-1, 1, (d, rank))).astype(np.float32) for d in shape]
    ct = chunk_tensor(st, cs, capacity=cap)
    qf = getattr(ref_qformat, qf_name)
    vq = ref_qformat.value_qformat(st.values)
    jq = tuple(qf.quantize(jnp.asarray(f)) for f in factors)
    tq = rt.qfactors_from_reference(jq, "cpu")
    return st, ct, qf, vq, jq, tq


def _q(qf, vq, shift):
    return dict(matrix_frac=qf.frac_bits, value_frac=vq.frac_bits, prec_shift=shift)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_equal(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# qformat
# --------------------------------------------------------------------------

FORMAT_OBJECTS = ["Q5_3", "Q9_7", "Q17_15"]


@pytest.mark.parametrize("name", FORMAT_OBJECTS)
def test_qformat_properties_match_reference(name):
    got, want = getattr(pt_qformat, name), getattr(ref_qformat, name)
    for attr in ("int_bits", "frac_bits", "storage_bits", "scale", "np_dtype",
                 "max_abs_error", "max_int", "min_int"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert str(got) == str(want)
    assert str(got.storage_dtype).split(".")[-1] == jnp.dtype(want.storage_dtype).name
    assert got.dequantize(torch.tensor([-3, 0, 5], dtype=got.storage_dtype)).tolist() == \
        np.asarray(want.dequantize(jnp.asarray([-3, 0, 5], want.storage_dtype))).tolist()


def _quantize_inputs(qf, seed=0):
    """Random values, exact half-steps of both parities, and out-of-range
    values of both signs."""
    rng = np.random.default_rng(seed)
    half = (np.arange(-40, 40) + 0.5) / qf.scale
    limit = (qf.max_int + 1) / qf.scale
    big = np.array([limit, -limit, 1.5 * limit, -3 * limit, 1e30, -1e30])
    return np.concatenate([rng.uniform(-2, 2, 300), half, big]).astype(np.float32)


@pytest.mark.parametrize("name", FORMAT_OBJECTS + ["value"])
def test_quantize_byte_identical(name):
    if name == "value":
        pair = (pt_qformat.QFormat(3, 13), ref_qformat.QFormat(3, 13))
    else:
        pair = (getattr(pt_qformat, name), getattr(ref_qformat, name))
    got_qf, want_qf = pair
    x = _quantize_inputs(want_qf)
    got = got_qf.quantize(torch.from_numpy(x)).numpy()
    want = np.asarray(want_qf.quantize(jnp.asarray(x)))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    got_np, want_np = got_qf.quantize_np(x), want_qf.quantize_np(x)
    assert got_np.dtype == want_np.dtype and got_np.tobytes() == want_np.tobytes()


def test_presets_and_bounds_match_reference():
    assert list(pt_qformat.FIXED_PRESETS) == list(ref_qformat.FIXED_PRESETS)
    assert pt_qformat.CROSS_MODE_SLACK == ref_qformat.CROSS_MODE_SLACK
    for preset, (qf, shift) in pt_qformat.FIXED_PRESETS.items():
        rqf, rshift = ref_qformat.FIXED_PRESETS[preset]
        assert (qf.int_bits, qf.frac_bits, shift) == (rqf.int_bits, rqf.frac_bits, rshift)
        for value_frac in range(0, 16):
            assert pt_qformat.accumulator_safe_nnz(preset, value_frac=value_frac) == \
                ref_qformat.accumulator_safe_nnz(preset, value_frac=value_frac)
            for ndim in (3, 4, 5):
                assert pt_qformat.preset_error_bound(preset, ndim, value_frac=value_frac) == \
                    ref_qformat.preset_error_bound(preset, ndim, value_frac=value_frac)
        for measured in ({}, {0: 0.01, 2: 0.03}):
            assert pt_qformat.cross_mode_error_bound(measured, preset, 3) == \
                ref_qformat.cross_mode_error_bound(measured, preset, 3)


@pytest.mark.parametrize("vmax", [0.0, 1e-3, 0.9, 1.0, 3.0, 1000.0, 1e6])
def test_value_qformat_matches_reference(vmax):
    values = np.random.default_rng(1).uniform(-1, 1, 50) * vmax
    for bits in (16, 8):
        got = pt_qformat.value_qformat(values, storage_bits=bits)
        want = ref_qformat.value_qformat(values, storage_bits=bits)
        assert (got.int_bits, got.frac_bits) == (want.int_bits, want.frac_bits)


# --------------------------------------------------------------------------
# fixed MTTKRP ops, wrapper, full op
# --------------------------------------------------------------------------

@pytest.mark.parametrize(("shape", "nnz", "cs", "cap", "rank", "qf_name", "shift"), CASES)
def test_fixed_ops_bit_exact(shape, nnz, cs, cap, rank, qf_name, shift):
    st, ct, qf, vq, jq, tq = _setup(shape, nnz, cs, cap, rank, qf_name)
    q = _q(qf, vq, shift)
    jvals = jnp.asarray(vq.quantize_np(st.values))
    jcvals = jnp.asarray(vq.quantize_np(ct.values))
    pdev = rt.chunked_device_arrays(rt.chunked_from_reference(ct), "cpu")
    for mode in range(len(shape)):
        want = ref_mttkrp.mttkrp_coo_fixed(jq, jnp.asarray(st.coords), jvals, mode=mode,
                                           out_dim=shape[mode], **q)
        got = rt.mttkrp_coo_fixed(tq, _t(st.coords), _t(jvals), mode=mode,
                                  out_dim=shape[mode], **q)
        _assert_equal(got, want)
        want = ref_mttkrp.mttkrp_chunked_fixed(
            jq, jnp.asarray(ct.task_chunk), jnp.asarray(ct.coords_rel), jcvals, mode=mode,
            chunk_shape=ct.chunk_shape, out_dim=shape[mode], **q)
        got = rt.mttkrp_chunked_fixed(tq, pdev["task_chunk"], pdev["coords_rel"], _t(jcvals),
                                      mode=mode, chunk_shape=ct.chunk_shape,
                                      out_dim=shape[mode], **q)
        _assert_equal(got, want)
        deq = rt.dequantize_output(got, qf.frac_bits, shift)
        np.testing.assert_array_equal(
            deq.numpy(), np.asarray(ref_mttkrp.dequantize_output(want, qf.frac_bits, shift)))


def test_fixed_ops_wrap_like_xla():
    """Factors in [-4, 4] under Q17.15 make int32 products overflow; the
    port wraps them as XLA does."""
    shape, nnz, cs, cap, rank = SWEEP[1]
    st, ct, qf, vq, jq, tq = _setup(shape, nnz, cs, cap, rank, "Q17_15", scale=4.0)
    rows = [tq[m][torch.from_numpy(st.coords[:, m])].to(torch.int64) for m in (1, 2)]
    assert bool(((rows[0] * rows[1]).abs() > 2**31 - 1).any())  # the wrap is exercised
    q = _q(qf, vq, 3)
    jcvals = jnp.asarray(vq.quantize_np(ct.values))
    pdev = rt.chunked_device_arrays(rt.chunked_from_reference(ct), "cpu")
    for mode in range(len(shape)):
        want = ref_mttkrp.mttkrp_chunked_fixed(
            jq, jnp.asarray(ct.task_chunk), jnp.asarray(ct.coords_rel), jcvals, mode=mode,
            chunk_shape=ct.chunk_shape, out_dim=shape[mode], **q)
        got = rt.mttkrp_chunked_fixed(tq, pdev["task_chunk"], pdev["coords_rel"], _t(jcvals),
                                      mode=mode, chunk_shape=ct.chunk_shape,
                                      out_dim=shape[mode], **q)
        _assert_equal(got, want)
        got = rt.mttkrp_fixed_kernel_op(tq, pdev["task_chunk"], pdev["coords_rel"],
                                        _t(jcvals), mode=mode, chunk_shape=ct.chunk_shape,
                                        out_dim=shape[mode], **q)
        _assert_equal(got, want)


@pytest.mark.parametrize(("shape", "nnz", "cs", "cap", "rank", "qf_name", "shift"),
                         [CASES[0], CASES[1], CASES[6]])
def test_local_cpu_path_matches_oracle_and_pallas(shape, nnz, cs, cap, rank, qf_name, shift):
    """The plain partials against the jnp oracle and the interpret-mode
    Pallas kernel; the wrapper's CPU path (their sum added into its output)
    against the summed Pallas partials; the full op against the full Pallas
    op.  Small shapes: interpret mode is slow."""
    _st, ct, qf, vq, jq, tq = _setup(shape, nnz, cs, cap, rank, qf_name)
    q = _q(qf, vq, shift)
    jpadded = tuple(pad_factor(f, cs[m]) for m, f in enumerate(jq))
    tpadded = [rt.pad_factor(f, cs[m]) for m, f in enumerate(tq)]
    jargs = (jnp.asarray(ct.task_chunk), jnp.asarray(ct.coords_rel),
             jnp.asarray(vq.quantize_np(ct.values)))
    targs = (_t(ct.task_chunk), _t(ct.coords_rel), _t(vq.quantize_np(ct.values)))
    rng = np.random.default_rng(7)
    before = mttkrp_fixed_kernel.launches
    for mode in range(len(shape)):
        plain = pref.mttkrp_fixed_local_ref(tpadded, *targs, mode=mode,
                                            chunk_shape=ct.chunk_shape, **q)
        oracle = kref.mttkrp_fixed_local_ref(jpadded, *jargs, mode=mode,
                                             chunk_shape=ct.chunk_shape, **q)
        pallas = mttkrp_fixed_pallas_local(jpadded, *jargs, mode=mode,
                                           chunk_shape=ct.chunk_shape, interpret=True, **q)
        _assert_equal(plain, oracle)
        _assert_equal(plain, pallas)
        rows = -(-shape[mode] // cs[mode]) * cs[mode]
        base = rng.integers(-1000, 1000, (rows, rank), dtype=np.int32)
        out = torch.from_numpy(base.copy())
        assert rt.mttkrp_fixed_local(tpadded, *targs, mode=mode, chunk_shape=ct.chunk_shape,
                                     out=out, **q) is out
        _assert_equal(out, base + np.asarray(kref.reduce_local(
            pallas, jargs[0], mode=mode, chunk_shape=ct.chunk_shape, out_dim=rows)))
        want = mttkrp_fixed_pallas(jq, *jargs, mode=mode, chunk_shape=ct.chunk_shape,
                                   out_dim=shape[mode], interpret=True, **q)
        got = rt.mttkrp_fixed_kernel_op(tq, *targs, mode=mode, chunk_shape=ct.chunk_shape,
                                        out_dim=shape[mode], **q)
        assert got.shape == (shape[mode], rank)
        _assert_equal(got, want)
    assert mttkrp_fixed_kernel.launches == before  # the CPU path launches nothing


def test_fixed_wrapper_refuses_other_devices():
    meta = torch.zeros((1, 2, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        rt.mttkrp_fixed_local([torch.zeros(2, 2, dtype=torch.int16)] * 2,
                              torch.zeros(1, 2, dtype=torch.int32), meta,
                              torch.zeros(1, 2, dtype=torch.int16), mode=0,
                              chunk_shape=(2, 2), matrix_frac=7, value_frac=7,
                              out=torch.zeros(2, 2, dtype=torch.int32, device="meta"))


def test_qfactors_from_reference_keeps_integer_types():
    """The reference's quantized factors go through interop into the port's
    fixed op and give the reference's integers."""
    shape, nnz, cs, cap, rank = SWEEP[0]
    for qf_name in FORMAT_OBJECTS:
        st, ct, qf, vq, jq, tq = _setup(shape, nnz, cs, cap, rank, qf_name)
        for got, want in zip(tq, jq, strict=True):
            assert got.device.type == "cpu"
            assert got.numpy().dtype == np.asarray(want).dtype
            assert got.numpy().tobytes() == np.asarray(want).tobytes()
        q = _q(qf, vq, 0)
        jcvals = vq.quantize_np(ct.values)
        want = ref_mttkrp.mttkrp_chunked_fixed(
            jq, jnp.asarray(ct.task_chunk), jnp.asarray(ct.coords_rel), jnp.asarray(jcvals),
            mode=1, chunk_shape=ct.chunk_shape, out_dim=shape[1], **q)
        got = rt.mttkrp_fixed_kernel_op(tq, _t(ct.task_chunk), _t(ct.coords_rel), _t(jcvals),
                                        mode=1, chunk_shape=ct.chunk_shape,
                                        out_dim=shape[1], **q)
        _assert_equal(got, want)
    with pytest.raises(TypeError, match="signed integers"):
        rt.qfactors_from_reference([np.zeros((2, 2), np.float32)], "cpu")


# --------------------------------------------------------------------------
# lock-free emulation
# --------------------------------------------------------------------------

@pytest.mark.parametrize(("t", "p", "rows", "full"), [
    (3, 32, 4, True),     # P a multiple of 16, every slot live, many collisions
    (4, 37, 6, False),    # P not a multiple of 16, nnz_per_task < P
    (2, 10, 50, False),   # P < 16, few collisions
    (5, 64, 1, False),    # one output row: every wave collides
])
def test_wave_collision_mask_matches_reference(t, p, rows, full):
    rng = np.random.default_rng(t * 100 + p)
    out_rows = rng.integers(0, rows, (t, p)).astype(np.int32)
    nnz_pt = (np.full(t, p) if full else rng.integers(0, p + 1, t)).astype(np.int32)
    want = np.asarray(ref_lockfree.wave_collision_mask(jnp.asarray(out_rows),
                                                       jnp.asarray(nnz_pt)))
    got = rt.wave_collision_mask(_t(out_rows), _t(nnz_pt))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() <= want.size  # some survive


LOCKFREE_KW = dict(chunk_shape=(8, 8, 8), capacity=64)


@pytest.mark.parametrize("engine", ["chunked", "fixed:int7", "fixed:int15-12"])
def test_lockfree_engines_match_reference(engine):
    """The engines' lock-free outputs on the same factors: float within
    1e-5, fixed point bit-exact."""
    st = random_tensor((30, 24, 36), 900, seed=6)
    want_eng = ref_build_engine(st, engine, 5, lockfree_mode=True, **LOCKFREE_KW)
    got_eng = rt.build_engine(rt.tensor_from_reference(st), engine, 5, lockfree_mode=True,
                              device="cpu", plans=rt.PlanCache(), **LOCKFREE_KW)
    assert got_eng.context.lockfree_mode and not _exact_mttkrp(got_eng)
    rng = np.random.default_rng(7)
    factors = [rng.uniform(-1, 1, (d, 5)).astype(np.float32) for d in st.shape]
    for mode in range(st.ndim):
        want = np.asarray(want_eng(tuple(jnp.asarray(f) for f in factors), mode))
        got = got_eng([torch.from_numpy(f) for f in factors], mode).numpy()
        if engine == "chunked":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(got, want)
    locked = rt.build_engine(rt.tensor_from_reference(st), engine, 5, device="cpu",
                             **LOCKFREE_KW)
    assert not np.array_equal(locked([torch.from_numpy(f) for f in factors], 0).numpy(),
                              got_eng([torch.from_numpy(f) for f in factors], 0).numpy())


def test_lockfree_cp_als_matches_reference():
    st = random_tensor((30, 24, 36), 900, seed=6)
    want = cp_als(st, 5, n_iters=N_ITERS, engine="chunked", seed=7, lockfree_mode=True,
                  **LOCKFREE_KW)
    got = rt.cp_als(rt.tensor_from_reference(st), 5, n_iters=N_ITERS, engine="chunked",
                    seed=7, lockfree_mode=True, device="cpu", **LOCKFREE_KW)
    np.testing.assert_allclose(got.fit_history, want.fit_history, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.diff_history, want.diff_history, rtol=0, atol=1e-6)
    assert got.quant_error is None and want.quant_error is None


# --------------------------------------------------------------------------
# cp_als through the fixed engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["nell2", "lbnl"])
@pytest.mark.parametrize("preset", ["int7", "int15-12"])
def test_fixed_cp_als_follows_reference(name, preset):
    want = cp_als(table1_tensor(name), 10, N_ITERS, engine="fixed", fixed_preset=preset)
    got = rt.cp_als(rt.table1_tensor(name), 10, N_ITERS, engine="fixed", fixed_preset=preset,
                    device="cpu")
    assert got.engine == want.engine == "fixed"
    assert len(got.fit_history) == len(got.iter_times) == N_ITERS
    np.testing.assert_allclose(got.fit_history, want.fit_history, rtol=FIT_RTOL, atol=FIT_ATOL)
    np.testing.assert_allclose(got.diff_history, want.diff_history, rtol=FIT_RTOL,
                               atol=FIT_ATOL)
    assert got.quant_error == pytest.approx(want.quant_error, rel=QUANT_RTOL)
    # the reported fit is the factors-only one, never the lossy fast path
    assert abs(got.fit_history[-1] - rt.fit_value(rt.table1_tensor(name), got.factors,
                                                  got.lam)) < 1e-6


def test_fixed_engine_output_bit_exact_on_given_factors():
    """The whole `fixed` engine (factor quantization on the device, the value
    format chosen at build time, the kernel op, dequantization) gives the
    reference engine's floats on the same factors, every preset."""
    st = random_tensor((20, 16, 24), 400, seed=1)
    rng = np.random.default_rng(2)
    factors = [rng.uniform(-1, 1, (d, 4)).astype(np.float32) for d in st.shape]
    kw = dict(chunk_shape=(8, 8, 8), capacity=32)
    for preset in rt.FIXED_PRESETS:
        want_eng = ref_build_engine(st, f"fixed:{preset}", 4, **kw)
        got_eng = rt.build_engine(rt.tensor_from_reference(st), f"fixed:{preset}", 4,
                                  device="cpu", **kw)
        for mode in range(st.ndim):
            np.testing.assert_array_equal(
                got_eng([torch.from_numpy(f) for f in factors], mode).numpy(),
                np.asarray(want_eng(tuple(jnp.asarray(f) for f in factors), mode)))


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

def test_fixed_backend_spec_and_candidate_ids():
    spec = rt.get_backend("fixed")
    assert spec.needs_chunking and spec.supports_fixed_point and not spec.lossless
    assert spec.presets == tuple(rt.FIXED_PRESETS) == ("int3", "int7", "int15-12")
    for name in ("ref", "chunked", "kernel"):
        other = rt.get_backend(name)
        assert other.lossless and not other.supports_fixed_point and other.presets == ()
    for cand in ("chunked", "fixed", "fixed:int7", "fixed:int15-12", "never_registered",
                 "fixed:int9", "chunked:int7"):
        assert rt.candidate_lossless(cand) == ref_candidate_lossless(cand), cand
    for cand in ("chunked", "fixed", "fixed:int3", "fixed:int15-12"):
        assert rt.parse_candidate(cand) == ref_parse_candidate(cand)
    for bad, match in (("fixed:int9", "no preset 'int9'"), ("chunked:int7", "no preset"),
                       ("bogus:int7", "unknown engine")):
        with pytest.raises(ValueError, match=match):
            ref_parse_candidate(bad)
        with pytest.raises(ValueError, match=match):
            rt.parse_candidate(bad)
    with pytest.raises(ValueError, match="may not contain ':'"):
        rt.register_backend("a:b")
    table = rt.backend_table()
    assert "fixed-point" in table.splitlines()[0] and "presets" in table.splitlines()[0]
    assert "`int7`" in table and "`int15-12`" in table


def test_fixed_preset_pin_conflict_and_unknown():
    st = rt.table1_tensor("nell2")
    rst = table1_tensor("nell2")
    kw = dict(chunk_shape=(302, 230, 720), capacity=4096)
    pinned = rt.build_engine(st, "fixed:int15-12", 4, device="cpu", **kw)
    assert pinned.name == "fixed:int15-12" and pinned.context.fixed_preset == "int15-12"
    assert rt.build_engine(st, "fixed", 4, device="cpu", **kw).context.fixed_preset == "int7"
    agree = rt.build_engine(st, "fixed:int7", 4, device="cpu", fixed_preset="int7", **kw)
    assert agree.context.fixed_preset == "int7"
    with pytest.raises(ValueError, match="conflicting presets"):
        rt.build_engine(st, "fixed:int7", 4, device="cpu", fixed_preset="int15-12", **kw)
    # an unknown preset raises the reference's exception type
    with pytest.raises(KeyError):
        ref_build_engine(rst, "fixed", 4, fixed_preset="int9", **kw)
    with pytest.raises(KeyError):
        rt.build_engine(st, "fixed", 4, device="cpu", fixed_preset="int9", **kw)
    ctx = rt.EngineContext(st=st, rank=4, device="cpu", **kw)
    assert rt.build_candidate("fixed:int3", ctx) is not None and ctx.fixed_preset == "int7"


def test_fit_fast_path_off_for_fixed_and_lockfree():
    st = rt.table1_tensor("lbnl")
    kw = dict(device="cpu", chunk_shape=(40, 105, 40, 105, 217), capacity=64)
    assert _exact_mttkrp(rt.build_engine(st, "kernel", 4, **kw))
    assert not _exact_mttkrp(rt.build_engine(st, "fixed", 4, **kw))
    assert not _exact_mttkrp(rt.build_engine(st, "fixed:int15-12", 4, **kw))
    assert not _exact_mttkrp(rt.build_engine(st, "kernel", 4, lockfree_mode=True, **kw))
    assert not _exact_mttkrp(lambda f, m: None)
    res = rt.cp_als(st, 4, 1, engine="kernel", track_diff=False, **kw)
    assert res.quant_error is None
    res = rt.cp_als(st, 4, 1, engine="fixed:int15-12", track_diff=False, **kw)
    assert res.engine == "fixed:int15-12" and res.quant_error > 0
