"""The CUDA spMTTKRP kernels, float and fixed point, against their plain
PyTorch versions on the card: each launch adds into an (I_pad, R) output
that already holds numbers, held to those numbers plus the summed plain
per-task partials (`ref.reduce_local(ref.mttkrp_*_local_ref(...))`).

Run on a machine with an NVIDIA GPU and nvcc:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernel_gpu.py

Elsewhere every test skips (the card is looked for inside a fixture, so
every pytest worker collects the same tests).  The kernel's per-nonzero
products are formed in the plain version's order; only the order of the
atomic sums differs, so each entry is held to 1e-4 of the sum of the
absolute values of its terms, which bounds the reordering error of a float32
sum of up to ~800 terms (2·(k-1)·2^-24 ≤ 1e-4) and is several times the
typical error well beyond that.  The fixed-point kernel (paper Alg. 2) sums
integers, so it is held to its plain version with `torch.equal`, every
preset, every mode.  The Gram pseudo-inverse kernel (float64 Jacobi) is
held to its plain version (torch's float32 SVD on the card) at
max(1e-5, κ·2^-17) of each matrix's largest entry, κ its condition number
over the kept directions: the flat value where V is well conditioned, about
64 float32 roundings magnified by κ where it is not.  A member holding a
NaN or an off-diagonal ±Inf must come out all NaN, one with ±Inf only on
the diagonal all zeros, as the plain version (and `jnp.linalg.pinv`) answer.
"""
import dataclasses
import gc

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.core import cpals as port_cpals
from repro_torch.kernels import (
    KernelError,
    _build,
    gram_pinv,
    mttkrp_fixed_kernel,
    mttkrp_kernel,
    sum_squares,
    tiles,
)
from repro_torch.kernels import ref as pref
from repro_torch.obs import capture
from repro_torch.obs.metrics import default_registry

pytestmark = pytest.mark.gpu

SWEEP = [
    # shape, nnz, chunk_shape, capacity, rank
    ((32, 32, 32), 400, (8, 8, 8), 16, 4),
    ((40, 30, 50), 600, (16, 8, 16), 32, 8),
    ((17, 23, 9), 200, (8, 8, 4), 16, 3),
    ((20, 12, 20, 12), 300, (8, 4, 8, 4), 32, 5),
    ((8, 8, 8, 8, 8), 200, (4, 4, 4, 4, 4), 16, 2),
    ((40, 30, 50), 600, (16, 8, 16), 32, 40),  # R > 32: lanes loop over r
    ((30, 40), 300, (8, 16), 32, 6),  # 2 and 6 modes: the kernels' generic mode loop
    ((6, 6, 6, 6, 6, 6), 300, (3, 3, 3, 3, 3, 3), 32, 4),
]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernel)")
    return torch.device("cuda")


def _inputs(shape, nnz, cs, cap, rank, device, seed=0, distribution="uniform"):
    st = rt.random_tensor(shape, nnz, seed=seed, distribution=distribution)
    rng = np.random.default_rng(seed + 1)
    factors = [torch.from_numpy(rng.uniform(-1, 1, (d, rank)).astype(np.float32)).to(device)
               for d in shape]
    ct = rt.chunk_tensor(st, cs, cap)
    return factors, ct, rt.chunked_device_arrays(ct, device)


def _assert_sum_order_close(got, want, abs_terms):
    torch.cuda.synchronize()
    err = (got - want).abs()
    tol = 1e-4 * abs_terms + 1e-6
    assert bool((err <= tol).all()), f"max err {err.max().item()} (max tol {tol.max().item()})"


def _base(kind, ct, mode, rank, device, seed=7):
    """An (I_pad, R) output that already holds numbers: float in [-0.5,
    0.5), fixed over all of int32 (the kernels' sums wrap into it)."""
    rows = -(-ct.tensor_shape[mode] // ct.chunk_shape[mode]) * ct.chunk_shape[mode]
    gen = torch.Generator(device=device).manual_seed(seed)
    if kind == "float":
        return torch.rand((rows, rank), generator=gen, device=device) - 0.5
    return torch.randint(-2**31, 2**31 - 1, (rows, rank), generator=gen, device=device,
                         dtype=torch.int32)


def _summed(local, dev, mode, cs, base):
    """`base` plus the sum of per-task partials, as the kernels add it."""
    return base + pref.reduce_local(local, dev["task_chunk"], mode=mode, chunk_shape=cs,
                                    out_dim=base.shape[0])


def _check_every_mode(factors, ct, dev):
    padded = [rt.pad_factor(f, ct.chunk_shape[m]) for m, f in enumerate(factors)]
    abs_padded = [f.abs() for f in padded]
    args = (dev["task_chunk"], dev["coords_rel"])
    cs = ct.chunk_shape
    for mode in range(ct.ndim):
        base = _base("float", ct, mode, factors[0].shape[1], dev["values"].device)
        out = base.clone()
        before = mttkrp_kernel.launches
        got = rt.mttkrp_local(padded, *args, dev["values"], mode=mode, chunk_shape=cs, out=out)
        assert mttkrp_kernel.launches == before + 1 and got is out
        want = _summed(pref.mttkrp_local_ref(padded, *args, dev["values"], mode=mode,
                                             chunk_shape=cs), dev, mode, cs, base)
        abs_terms = _summed(pref.mttkrp_local_ref(abs_padded, *args, dev["values"].abs(),
                                                  mode=mode, chunk_shape=cs),
                            dev, mode, cs, base.abs())
        _assert_sum_order_close(got, want, abs_terms)

        out_dim = ct.tensor_shape[mode]
        got = rt.mttkrp_kernel_op(factors, *args, dev["values"], mode=mode,
                                  chunk_shape=ct.chunk_shape, out_dim=out_dim)
        want = rt.mttkrp_chunked(factors, *args, dev["values"], mode=mode,
                                 chunk_shape=ct.chunk_shape, out_dim=out_dim)
        abs_terms = rt.mttkrp_chunked([f.abs() for f in factors], *args, dev["values"].abs(),
                                      mode=mode, chunk_shape=ct.chunk_shape, out_dim=out_dim)
        _assert_sum_order_close(got, want, abs_terms)


@pytest.mark.parametrize(("shape", "nnz", "cs", "cap", "rank"), SWEEP)
def test_kernel_matches_plain_every_mode(cuda, shape, nnz, cs, cap, rank):
    _check_every_mode(*_inputs(shape, nnz, cs, cap, rank, cuda))


def test_kernel_one_task_many_nonzeros(cuda):
    """T = 1 with a large P: the grid tiles one task over many blocks."""
    factors, ct, dev = _inputs((300, 200, 400), 400_000, (300, 200, 400), None, 10, cuda)
    assert ct.num_tasks == 1 and ct.capacity == 400_000
    _check_every_mode(factors, ct, dev)


def test_kernel_split_powerlaw_chunks_five_modes(cuda):
    factors, ct, dev = _inputs((16, 42, 16, 42, 868), 30_000, (16, 42, 16, 42, 109), 512, 10,
                               cuda, distribution="powerlaw")
    assert ct.num_tasks > ct.grid[-1]  # hot chunks were split
    _check_every_mode(factors, ct, dev)


def test_kernel_wrapper_rejects_what_it_cannot_take(cuda):
    factors, ct, dev = _inputs((32, 32, 32), 400, (8, 8, 8), 16, 4, cuda)
    kw = dict(mode=0, chunk_shape=ct.chunk_shape, out=torch.zeros((32, 4), device=cuda))
    with pytest.raises(TypeError, match="float32"):
        rt.mttkrp_local([f.double() for f in factors], dev["task_chunk"], dev["coords_rel"],
                        dev["values"], **kw)
    with pytest.raises(TypeError, match="int32"):
        rt.mttkrp_local(factors, dev["task_chunk"].long(), dev["coords_rel"],
                        dev["values"], **kw)
    with pytest.raises(ValueError, match="is on"):
        rt.mttkrp_local(factors, dev["task_chunk"].cpu(), dev["coords_rel"],
                        dev["values"], **kw)


# ---------------------------------------------------------------------------
# Fixed point (paper Alg. 2): bit for bit
# ---------------------------------------------------------------------------

def _fixed_inputs(factors, ct, dev, preset, scale=1.0):
    """Quantized factors (L∞-normalized, then scaled) and qvalues, as the
    `fixed` backend makes them, plus the shift parameters."""
    qf, prec_shift = rt.FIXED_PRESETS[preset]
    qfactors = [qf.quantize(scale * f / f.abs().amax(dim=0)) for f in factors]
    vq = rt.value_qformat(ct.values)
    qvalues = torch.from_numpy(vq.quantize_np(ct.values)).to(dev["values"].device)
    return qfactors, qvalues, dict(matrix_frac=qf.frac_bits, value_frac=vq.frac_bits,
                                   prec_shift=prec_shift)


def _check_fixed_every_mode(factors, ct, dev, preset, scale=1.0):
    qfactors, qvalues, q = _fixed_inputs(factors, ct, dev, preset, scale)
    padded = [rt.pad_factor(f, ct.chunk_shape[m]) for m, f in enumerate(qfactors)]
    args = (dev["task_chunk"], dev["coords_rel"], qvalues)
    cs = ct.chunk_shape
    for mode in range(ct.ndim):
        base = _base("fixed", ct, mode, qfactors[0].shape[1], qvalues.device)
        out = base.clone()
        before = mttkrp_fixed_kernel.launches
        got = rt.mttkrp_fixed_local(padded, *args, mode=mode, chunk_shape=cs, out=out, **q)
        assert mttkrp_fixed_kernel.launches == before + 1 and got is out
        want = _summed(pref.mttkrp_fixed_local_ref(padded, *args, mode=mode, chunk_shape=cs, **q),
                       dev, mode, cs, base)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"local, mode {mode}"
        out_dim = ct.tensor_shape[mode]
        got = rt.mttkrp_fixed_kernel_op(qfactors, *args, mode=mode, chunk_shape=ct.chunk_shape,
                                        out_dim=out_dim, **q)
        want = rt.mttkrp_chunked_fixed(qfactors, *args, mode=mode, chunk_shape=ct.chunk_shape,
                                       out_dim=out_dim, **q)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"full op, mode {mode}"


@pytest.mark.parametrize("preset", ["int3", "int7", "int15-12"])
@pytest.mark.parametrize(("shape", "nnz", "cs", "cap", "rank"), SWEEP)
def test_fixed_kernel_equals_plain_every_mode(cuda, shape, nnz, cs, cap, rank, preset):
    _check_fixed_every_mode(*_inputs(shape, nnz, cs, cap, rank, cuda), preset)


def test_fixed_kernel_one_task_many_nonzeros(cuda):
    factors, ct, dev = _inputs((300, 200, 400), 400_000, (300, 200, 400), None, 10, cuda)
    assert ct.num_tasks == 1
    _check_fixed_every_mode(factors, ct, dev, "int7")


def test_fixed_kernel_split_powerlaw_chunks_five_modes(cuda):
    factors, ct, dev = _inputs((16, 42, 16, 42, 868), 30_000, (16, 42, 16, 42, 109), 512, 10,
                               cuda, distribution="powerlaw")
    assert ct.num_tasks > ct.grid[-1]
    _check_fixed_every_mode(factors, ct, dev, "int15-12")


def test_fixed_kernel_wraps_like_the_plain_version(cuda):
    """Factors in [-4, 4] under Q17.15: int32 products overflow and wrap."""
    factors, ct, dev = _inputs((40, 30, 50), 600, (16, 8, 16), 32, 8, cuda)
    qfactors, _, _ = _fixed_inputs(factors, ct, dev, "int15-12", scale=4.0)
    assert int(qfactors[1].abs().max()) * int(qfactors[2].abs().max()) > 2**31
    _check_fixed_every_mode(factors, ct, dev, "int15-12", scale=4.0)


def test_fixed_kernel_wrapper_rejects_what_it_cannot_take(cuda):
    factors, ct, dev = _inputs((32, 32, 32), 400, (8, 8, 8), 16, 4, cuda)
    qfactors, qvalues, q = _fixed_inputs(factors, ct, dev, "int3")
    args = (dev["task_chunk"], dev["coords_rel"], qvalues)
    kw = dict(mode=0, chunk_shape=ct.chunk_shape,
              out=torch.zeros((32, 4), dtype=torch.int32, device=cuda))
    # int3's int8 factors declared as int15-12's Q.15
    with pytest.raises(TypeError, match="cannot hold 15 fractional bits"):
        rt.mttkrp_fixed_local(qfactors, *args, **kw, matrix_frac=15, value_frac=q["value_frac"],
                              prec_shift=3)
    with pytest.raises(TypeError, match="qfactors must be"):
        rt.mttkrp_fixed_local(factors, *args, **kw, **q)
    with pytest.raises(TypeError, match="must be torch.int8"):
        rt.mttkrp_fixed_local([qfactors[0], qfactors[1].to(torch.int16), qfactors[2]], *args,
                              **kw, **q)
    with pytest.raises(TypeError, match="qvalues must be"):
        rt.mttkrp_fixed_local(qfactors, dev["task_chunk"], dev["coords_rel"], dev["values"],
                              **kw, **q)
    with pytest.raises(TypeError, match="int32"):
        rt.mttkrp_fixed_local(qfactors, dev["task_chunk"].long(), dev["coords_rel"], qvalues,
                              **kw, **q)
    with pytest.raises(ValueError, match="is on"):
        rt.mttkrp_fixed_local([qfactors[0], qfactors[1].cpu(), qfactors[2]], *args, **kw, **q)
    with pytest.raises(ValueError, match="is on"):
        rt.mttkrp_fixed_local(qfactors, dev["task_chunk"].cpu(), dev["coords_rel"], qvalues,
                              **kw, **q)


# ---------------------------------------------------------------------------
# Launch tiers (kernels/tiles.py): staged, accumulator-only, global
# ---------------------------------------------------------------------------

TIER_CASES = [
    # shape, nnz, chunk_shape, capacity, rank, the tier its shapes give
    ((40, 30, 50), 600, (16, 8, 16), 32, 10, "staged"),
    ((1400, 1400, 1400), 20_000, (700, 700, 700), 4096, 64, "accumulator"),
    ((2000, 1000, 1500), 20_000, (1000, 1000, 1000), 4096, 64, "global"),
]


def _local_pair(kind, factors, ct, dev, mode, preset="int7", **kw):
    """(kernel, plain, Σ|terms|) of one mode: the kernel launched (with `kw`)
    into an output that already holds `_base`, the plain version as that
    base plus the summed per-task partials; float factors are padded, fixed
    ones quantized (`preset`) and padded, unless kw says `padded=False`."""
    pad = kw.pop("padded", True)
    args = (dev["task_chunk"], dev["coords_rel"])
    cs = ct.chunk_shape
    base = _base(kind, ct, mode, factors[0].shape[1], dev["values"].device)
    if kind == "float":
        fs = [rt.pad_factor(f, cs[m]) if pad else f for m, f in enumerate(factors)]
        got = rt.mttkrp_local(fs, *args, dev["values"], mode=mode, chunk_shape=cs,
                              out=base.clone(), **kw)
        want = _summed(pref.mttkrp_local_ref(fs, *args, dev["values"], mode=mode,
                                             chunk_shape=cs), dev, mode, cs, base)
        terms = _summed(pref.mttkrp_local_ref([f.abs() for f in fs], *args, dev["values"].abs(),
                                              mode=mode, chunk_shape=cs), dev, mode, cs,
                        base.abs())
        return got, want, terms
    qfactors, qvalues, q = _fixed_inputs(factors, ct, dev, preset)
    fs = [rt.pad_factor(f, cs[m]) if pad else f for m, f in enumerate(qfactors)]
    got = rt.mttkrp_fixed_local(fs, *args, qvalues, mode=mode, chunk_shape=cs, out=base.clone(),
                                **q, **kw)
    want = _summed(pref.mttkrp_fixed_local_ref(fs, *args, qvalues, mode=mode, chunk_shape=cs,
                                               **q), dev, mode, cs, base)
    return got, want, None


def _assert_pair(kind, got, want, terms):
    if kind == "float":
        _assert_sum_order_close(got, want, terms)
    else:
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def _plan(kind, ct, mode, rank, preset="int7", **kw):
    # int7: int16 factors and qvalues; int15-12: int32 factors, int16 qvalues
    fb, vb = (4, 4) if kind == "float" else (2 if preset == "int7" else 4, 2)
    return tiles.plan_launch(ct.num_tasks, ct.capacity, ct.chunk_shape, mode, rank,
                             factor_bytes=fb, value_bytes=vb, **kw)


@pytest.mark.parametrize("kind", ["float", "fixed"])
@pytest.mark.parametrize(("shape", "nnz", "cs", "cap", "rank", "tier"), TIER_CASES)
def test_kernels_in_the_tier_their_shapes_give(cuda, kind, shape, nnz, cs, cap, rank, tier):
    factors, ct, dev = _inputs(shape, nnz, cs, cap, rank, cuda)
    for mode in range(ct.ndim):
        assert _plan(kind, ct, mode, rank).tier == tier
        got, want, terms = _local_pair(kind, factors, ct, dev, mode,
                                       nnz_per_task=dev["nnz_per_task"])
        _assert_pair(kind, got, want, terms)


@pytest.mark.parametrize("kind", ["float", "fixed"])
@pytest.mark.parametrize("rank", [1, 3, 10, 33, 64])
def test_kernels_every_rank(cuda, kind, rank):
    factors, ct, dev = _inputs((40, 30, 50), 1500, (16, 8, 16), 64, rank, cuda)
    for mode in range(ct.ndim):
        for nnz in (None, dev["nnz_per_task"]):
            got, want, terms = _local_pair(kind, factors, ct, dev, mode, nnz_per_task=nnz)
            _assert_pair(kind, got, want, terms)


@pytest.mark.parametrize("kind", ["float", "fixed"])
@pytest.mark.parametrize("tier", ["global", "accumulator", "staged"])
def test_kernels_unpadded_factors_and_out_of_chunk_coordinates(cuda, kind, tier):
    """Factors not padded to whole chunks (the last chunk's rows clamp), and
    input-mode coordinates past the chunk, which read the clamped global row
    from device memory even where the block is staged."""
    factors, ct, dev = _inputs((17, 23, 9), 200, (8, 8, 4), 16, 3, cuda)
    coords = dev["coords_rel"].clone()
    live = torch.arange(ct.capacity, device=cuda)[None, :] < dev["nnz_per_task"][:, None]
    coords[..., 1] = torch.where(live & (coords[..., 1] % 3 == 0), coords[..., 1] + 9,
                                 coords[..., 1])
    dev = {**dev, "coords_rel": coords}
    for mode in (0, 2):
        plan = _plan(kind, ct, mode, 3, tier=tier)
        got, want, terms = _local_pair(kind, factors, ct, dev, mode, padded=False, plan=plan)
        _assert_pair(kind, got, want, terms)


@pytest.mark.parametrize("kind", ["float", "fixed"])
def test_padding_tasks_add_nothing_to_out(cuda, kind):
    """Padding tasks (nnz 0) add nothing: with the real tasks, the output
    holds the real tasks' sums; alone, it keeps what it held, bit for bit."""
    st = rt.random_tensor((40, 30, 50), 600, seed=3)
    ct = rt.chunk_tensor(st, (16, 8, 16), 32)
    n_real = ct.num_tasks
    ct = ct.pad_tasks(n_real + 7)
    dev = rt.chunked_device_arrays(ct, cuda)
    rng = np.random.default_rng(4)
    factors = [torch.from_numpy(rng.uniform(-1, 1, (d, 10)).astype(np.float32)).to(cuda)
               for d in st.shape]
    qfactors, qvalues, q = _fixed_inputs(factors, ct, dev, "int7")
    cs = ct.chunk_shape
    args = (dev["task_chunk"][n_real:], dev["coords_rel"][n_real:])
    for mode in range(ct.ndim):
        got, want, terms = _local_pair(kind, factors, ct, dev, mode,
                                       nnz_per_task=dev["nnz_per_task"])
        _assert_pair(kind, got, want, terms)
        base = _base(kind, ct, mode, 10, cuda)
        for nnz in (None, dev["nnz_per_task"][n_real:]):
            out = base.clone()
            if kind == "float":
                rt.mttkrp_local([rt.pad_factor(f, cs[m]) for m, f in enumerate(factors)], *args,
                                dev["values"][n_real:], mode=mode, chunk_shape=cs,
                                nnz_per_task=nnz, out=out)
            else:
                rt.mttkrp_fixed_local([rt.pad_factor(f, cs[m]) for m, f in enumerate(qfactors)],
                                      *args, qvalues[n_real:], mode=mode, chunk_shape=cs,
                                      nnz_per_task=nnz, out=out, **q)
            torch.cuda.synchronize()
            assert torch.equal(out, base), mode


def test_kernel_launch_the_card_refuses_raises(cuda):
    """A plan past the card's shared memory is refused and raises; a plan
    that disagrees with the kernel's layout raises; the next launch works."""
    factors, ct, dev = _inputs((2000, 1000, 1500), 20_000, (1000, 1000, 1000), 4096, 64, cuda)
    big = _plan("float", ct, 0, 64, smem_budget=10**6)
    assert big.tier != "global" and big.smem_bytes > tiles.device_budget(cuda)
    before = mttkrp_kernel.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        _local_pair("float", factors, ct, dev, 0, plan=big)
    wrong = dataclasses.replace(_plan("float", ct, 0, 64, tier="global"), smem_bytes=8)
    with pytest.raises(RuntimeError, match="disagree"):
        _local_pair("float", factors, ct, dev, 0, plan=wrong)
    with pytest.raises(RuntimeError, match="disagree"):  # stages the output mode's factor
        _local_pair("float", factors, ct, dev, 0, plan=tiles.LaunchPlan("staged", 1, 0, (0,)))
    with pytest.raises(RuntimeError, match="launch failed"):
        _local_pair("fixed", factors, ct, dev, 0, plan=_plan("fixed", ct, 0, 64,
                                                            smem_budget=10**6))
    assert mttkrp_kernel.launches == before
    got, want, terms = _local_pair("float", factors, ct, dev, 0)
    _assert_pair("float", got, want, terms)


@pytest.mark.parametrize("kind", ["float", "fixed"])
def test_engines_pass_nnz_per_task(cuda, kind):
    """The `kernel` and `fixed` engines run with the resident nnz_per_task
    and follow the plain chunked ops on the card."""
    st = rt.random_tensor((40, 30, 50), 1500, seed=6)
    chunking = dict(chunk_shape=(16, 8, 16), capacity=64)
    if kind == "float":
        got = rt.cp_als(st, 6, n_iters=3, engine="kernel", seed=1, **chunking)
        want = rt.cp_als(st, 6, n_iters=3, engine="chunked", seed=1, **chunking)
        np.testing.assert_allclose(got.fit_history, want.fit_history, atol=1e-5)
    else:
        got = rt.cp_als(st, 6, n_iters=3, engine="fixed", fixed_preset="int15-12", seed=1,
                        **chunking)
        want = rt.cp_als(st, 6, n_iters=3, engine="fixed", fixed_preset="int15-12", seed=1,
                         device="cpu", **chunking)
        np.testing.assert_allclose(got.fit_history, want.fit_history, atol=1e-5, rtol=1e-3)


@pytest.mark.parametrize("kind", ["float", "fixed"])
@pytest.mark.parametrize("rank", [10, 64])
def test_kernels_on_runs_of_equal_output_rows(cuda, kind, rank):
    """A dense tensor: in each task's (lexicographic) slot order mode 0 and
    mode 1 have long runs of equal output rows, which the float kernel
    combines before its shared-memory atomics, and mode 2 has none."""
    factors, ct, dev = _inputs((64, 64, 64), 100_000, (16, 16, 16), None, rank, cuda)
    for mode in range(ct.ndim):
        got, want, terms = _local_pair(kind, factors, ct, dev, mode,
                                       nnz_per_task=dev["nnz_per_task"])
        _assert_pair(kind, got, want, terms)


# ---------------------------------------------------------------------------
# The direct output: every tier adds into the (I_pad, R) MTTKRP itself
# ---------------------------------------------------------------------------

DIRECT_CASES = {
    # a 4-mode Zipf(1.3) tensor: row 0 of each mode holds up to a quarter of it
    "four-mode-hot-row": ((60, 400, 200, 30), 6000, (16, 64, 32, 30), 64, 10, "powerlaw"),
    # 3,375 chunks of 16 slots: more tasks than MIN_BLOCKS, many on each output row
    "more-tasks-than-min-blocks": ((120, 120, 120), 20_000, (8, 8, 8), 16, 10, "uniform"),
    # one task: the task tiers split it over blocks, the global tier over tiles
    "split-tasks": ((300, 200, 400), 100_000, (300, 200, 400), None, 10, "uniform"),
    # 48 small tasks whose shapes give the staged tier
    "small-tasks": ((40, 30, 50), 600, (16, 8, 16), 32, 10, "uniform"),
}


@pytest.mark.parametrize("kind", ["float", "fixed"])
@pytest.mark.parametrize("tier", ["global", "accumulator", "staged"])
@pytest.mark.parametrize("case", sorted(DIRECT_CASES))
def test_direct_output_every_tier_equals_summed_partials(cuda, kind, tier, case):
    """Every tier, forced through `plan=`, adds each task's sums into the
    output rows task_chunk[t, mode]·S_mode + [0, S_mode) on top of what the
    output holds, with and without `nnz_per_task`: float within 1e-5 of
    Σ|terms| per entry (only the order of the sums differs: the block's, the
    runs', the device atomics'), fixed (int15-12, the fixed cells' format)
    bit for bit (int32 sums wrap alike in any order)."""
    shape, nnz, cs, cap, rank, dist = DIRECT_CASES[case]
    factors, ct, dev = _inputs(shape, nnz, cs, cap, rank, cuda, distribution=dist)
    if case == "four-mode-hot-row":  # Zipf(1.3), clipped: about a quarter on row 0
        st = rt.random_tensor(shape, nnz, seed=0, distribution=dist)
        assert all(int(np.bincount(st.coords[:, m]).max()) >= nnz // 10 for m in range(4))
    if case == "more-tasks-than-min-blocks":
        assert ct.num_tasks > tiles.MIN_BLOCKS
    for mode in range(ct.ndim):
        plan = _plan(kind, ct, mode, rank, preset="int15-12", tier=tier)
        assert plan.tier == tier
        if case == "split-tasks":
            assert ct.num_tasks == 1 and plan.blocks_per_task > 1
        for nnz in (None, dev["nnz_per_task"]):
            before = (mttkrp_kernel.launches, mttkrp_fixed_kernel.launches)
            got, want, terms = _local_pair(kind, factors, ct, dev, mode, preset="int15-12",
                                           nnz_per_task=nnz, plan=plan)
            torch.cuda.synchronize()
            assert (mttkrp_kernel.launches - before[0],
                    mttkrp_fixed_kernel.launches - before[1]) \
                == ((1, 0) if kind == "float" else (0, 1))
            if kind == "float":
                err, tol = (got - want).abs(), 1e-5 * terms + 1e-6
                assert bool((err <= tol).all()), f"mode {mode}: max err {err.max().item()}"
            else:
                assert torch.equal(got, want), f"mode {mode}"


@pytest.mark.parametrize("kind", ["float", "fixed"])
def test_direct_output_rejects_what_it_cannot_take(cuda, kind):
    factors, ct, dev = _inputs((32, 32, 32), 400, (8, 8, 8), 16, 4, cuda)
    dtype = torch.float32 if kind == "float" else torch.int32

    def launch(out):
        if kind == "float":
            return rt.mttkrp_local(factors, dev["task_chunk"], dev["coords_rel"], dev["values"],
                                   mode=0, chunk_shape=ct.chunk_shape, out=out)
        qfactors, qvalues, q = _fixed_inputs(factors, ct, dev, "int7")
        return rt.mttkrp_fixed_local(qfactors, dev["task_chunk"], dev["coords_rel"], qvalues,
                                     mode=0, chunk_shape=ct.chunk_shape, out=out, **q)

    with pytest.raises(TypeError, match="out must be"):
        launch(torch.zeros((32, 4), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="multiple of 8 rows"):
        launch(torch.zeros((30, 4), dtype=dtype, device=cuda))
    with pytest.raises(ValueError, match="multiple of 8 rows"):
        launch(torch.zeros((32, 5), dtype=dtype, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        launch(torch.zeros((4, 32), dtype=dtype, device=cuda).T)
    with pytest.raises(ValueError, match="is on"):
        launch(torch.zeros((32, 4), dtype=dtype))
    out = torch.zeros((32, 4), dtype=dtype, device=cuda)
    assert launch(out) is out


# ---------------------------------------------------------------------------
# the Gram pseudo-inverse kernel (csrc/gram_pinv.cu)
# ---------------------------------------------------------------------------

NELL2_SHAPE = (12092, 9184, 28818)


def _gram_stack(rank, n, seed, edit=None, rows=200):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        v = np.ones((rank, rank), np.float32)
        for _m in range(2):
            f = rng.uniform(0, 1, (rows, rank)).astype(np.float32)
            if edit is not None:
                edit(f)
            v = v * (f.T @ f)
        out.append(v)
    return torch.from_numpy(np.stack(out))


def _case_a_grams(device):
    """V of every mode at case (a)'s first iteration: NELL-2's dims, R = 10,
    the factors `init_factors` draws."""
    fs = rt.init_factors(NELL2_SHAPE, 10, seed=0, device=device)
    grams = [f.T @ f for f in fs]
    return torch.stack([grams[(m + 1) % 3] * grams[(m + 2) % 3] for m in range(3)])


def _zero_column(f):
    f[:, 3] = 0.0


def _equal_columns(f):
    f[:, 6] = f[:, 5]


PINV_STACKS = {
    "case-a": lambda dev: _case_a_grams(dev),
    "zero-column": lambda dev: _gram_stack(10, 4, 1, _zero_column).to(dev),
    "equal-columns": lambda dev: _gram_stack(10, 4, 2, _equal_columns).to(dev),
    "rank-33-shared": lambda dev: _gram_stack(33, 3, 8, rows=100).to(dev),
    "rank-160-global-scratch": lambda dev: _gram_stack(160, 2, 3, rows=400).to(dev),
    "batched-4096-rank-5": lambda dev: _gram_stack(5, 4096, 4, rows=50).to(dev),
}
#: The tier `plan_pinv` picks for each stack on the H100.
PINV_TIERS = {"rank-33-shared": "shared", "rank-160-global-scratch": "global"}


def _assert_pinv_close(got, want, v):
    torch.cuda.synchronize()
    v64 = v.double().cpu().numpy()
    lam = np.abs(np.linalg.eigvalsh(v64))
    top = lam.max(axis=-1, keepdims=True)
    kept = np.where(lam > pref.gram_pinv_rtol(v.shape[-1]) * top, lam, np.inf)
    kappa = top[..., 0] / kept.min(axis=-1)
    tol = np.maximum(1e-5, kappa * 2.0 ** -17)
    g, w = got.double().cpu().numpy(), want.double().cpu().numpy()
    err = np.abs(g - w).max(axis=(-2, -1)) / np.abs(w).max(axis=(-2, -1))
    assert bool((err <= tol).all()), f"max err/tol {(err / tol).max()}"


def _pinv_plan(dev, rank, tier=None):
    return gram_pinv.plan_pinv(rank, tiles.device_budget(dev), tier)


@pytest.mark.parametrize("stack", sorted(PINV_STACKS))
def test_gram_pinv_matches_plain(cuda, stack):
    v = PINV_STACKS[stack](cuda).contiguous()
    assert _pinv_plan(cuda, v.shape[-1]).tier == PINV_TIERS.get(stack, "warp")
    before = gram_pinv.launches
    got = gram_pinv.gram_pinv(v)
    assert gram_pinv.launches == before + 1
    assert got.shape == v.shape and got.dtype == torch.float32 and got.is_cuda
    assert torch.equal(got, got.mT)  # formed symmetric, bit for bit
    _assert_pinv_close(got, pref.gram_pinv_ref(v), v)


@pytest.mark.parametrize("n", [1, 3, 4096])
@pytest.mark.parametrize("rank", [1, 2, 5, 10, 16, 31, 32])
def test_gram_pinv_warp_tier(cuda, rank, n):
    """The warp tier at every width class, B not a multiple of the warps
    per block: within the tolerance of the plain version, symmetric, and bit
    for bit its host replay (on the first 8 matrices)."""
    v = _gram_stack(rank, n, 100 * rank + n, rows=max(50, 3 * rank)).to(cuda)
    plan = _pinv_plan(cuda, rank)
    assert plan == gram_pinv.PinvLaunch("warp")
    before = gram_pinv.launches
    got = gram_pinv.gram_pinv(v)
    assert gram_pinv.launches == before + 1
    assert torch.equal(got, got.mT)
    _assert_pinv_close(got, pref.gram_pinv_ref(v), v)
    replay = gram_pinv.jacobi_replay(v[:8].cpu().numpy())
    assert np.array_equal(replay.out.view(np.int32), got[:8].cpu().numpy().view(np.int32))


@pytest.mark.parametrize("tier", ["warp", "shared"])
def test_gram_pinv_all_zero_matrix(cuda, tier):
    v = torch.zeros(5, 10, 10, device=cuda)
    got = gram_pinv.gram_pinv(v, launch=_pinv_plan(cuda, 10, tier))
    assert torch.equal(got, torch.zeros_like(v))


@pytest.mark.parametrize("stack", ["case-a", "zero-column", "equal-columns", "batched-4096-rank-5"])
def test_gram_pinv_warp_and_block_tiers_agree(cuda, stack):
    """The same V through the warp tier and the first design (the shared
    tier, forced): each within the tolerance of the other."""
    v = PINV_STACKS[stack](cuda).contiguous()
    rank = v.shape[-1]
    before = gram_pinv.launches
    warp = gram_pinv.gram_pinv(v, launch=_pinv_plan(cuda, rank, "warp"))
    block = gram_pinv.gram_pinv(v, launch=_pinv_plan(cuda, rank, "shared"))
    assert gram_pinv.launches == before + 2
    _assert_pinv_close(warp, block, v)


#: Symmetric non-finite placements in member 1 of a (3, 10, 10) stack, and
#: what `jnp.linalg.pinv` answers for that member (tests/test_torch_pinv.py
#: holds the plain version and the host replay to it on the CPU).
NONFINITE = {
    "nan-off-diagonal": ([(3, 4, np.nan)], "nan"),
    "nan-diagonal": ([(2, 2, np.nan)], "nan"),
    "inf-off-diagonal": ([(3, 4, np.inf)], "nan"),
    "neg-inf-off-diagonal": ([(3, 4, -np.inf)], "nan"),
    "inf-diagonal": ([(2, 2, np.inf)], "zeros"),
    "inf-two-diagonal": ([(2, 2, np.inf), (5, 5, np.inf)], "zeros"),
    "neg-inf-diagonal": ([(2, 2, -np.inf)], "zeros"),
    "inf-diagonal-and-off": ([(2, 2, np.inf), (2, 5, np.inf)], "nan"),
}


@pytest.mark.parametrize("tier", ["warp", "shared", "global"])
@pytest.mark.parametrize("placement", list(NONFINITE))
def test_gram_pinv_nonfinite_member(cuda, placement, tier):
    """One bad member: all NaN or all zeros as the plain version (and jnp)
    answer, the others within the tolerance of the plain version; the warp
    tier bit for bit its host replay, NaN bits included."""
    v = _gram_stack(10, 3, 9).numpy()
    for i, j, x in NONFINITE[placement][0]:
        v[1, i, j] = v[1, j, i] = x
    vt = torch.from_numpy(v).to(cuda)
    before = gram_pinv.launches
    got = gram_pinv.gram_pinv(vt, launch=_pinv_plan(cuda, 10, tier))
    assert gram_pinv.launches == before + 1
    want = pref.gram_pinv_ref(vt)
    assert torch.equal(got.isnan(), want.isnan())
    assert bool(got[1].isnan().all()) if NONFINITE[placement][1] == "nan" else not got[1].any()
    _assert_pinv_close(got[[0, 2]], want[[0, 2]], vt[[0, 2]])
    if tier == "warp":
        replay = gram_pinv.jacobi_replay(v)
        assert np.array_equal(replay.out.view(np.int32), got.cpu().numpy().view(np.int32))


def test_gram_pinv_reads_one_triangle(cuda):
    """An asymmetric last bit below the diagonal changes nothing."""
    v = _gram_stack(10, 3, 5).to(cuda)
    noisy = v.clone()
    lower = torch.ones(10, 10, dtype=torch.bool, device=cuda).tril(-1)
    noisy[:, lower] = torch.nextafter(noisy[:, lower], torch.full_like(noisy[:, lower], 1e30))
    for tier in ("warp", "shared"):
        plan = _pinv_plan(cuda, 10, tier)
        assert torch.equal(gram_pinv.gram_pinv(noisy, launch=plan),
                           gram_pinv.gram_pinv(v, launch=plan))


def test_gram_pinv_global_scratch_equals_shared(cuda):
    """The same arithmetic from a global scratch buffer: the same bits."""
    v = _gram_stack(10, 64, 6).to(cuda)
    assert torch.equal(gram_pinv.gram_pinv(v, launch=_pinv_plan(cuda, 10, "global")),
                       gram_pinv.gram_pinv(v, launch=_pinv_plan(cuda, 10, "shared")))


def test_gram_pinv_failures_raise(cuda, monkeypatch):
    """A wrong layout in either design, a rejected input and a failed build
    raise; cp_als on the card never falls back to the plain version."""
    v = _gram_stack(5, 2, 7).to(cuda)
    before = gram_pinv.launches
    with pytest.raises(KernelError, match="disagree"):
        gram_pinv.gram_pinv(v, launch=gram_pinv.PinvLaunch("shared", smem_bytes=8))
    with pytest.raises(KernelError, match="disagree"):  # R = 33 is past a warp
        gram_pinv.gram_pinv(_gram_stack(33, 1, 7, rows=100).to(cuda),
                            launch=gram_pinv.PinvLaunch("warp"))
    with pytest.raises(ValueError, match="tier"):
        gram_pinv.gram_pinv(v, launch=gram_pinv.PinvLaunch("registers"))
    with pytest.raises(TypeError, match="float32"):
        gram_pinv.gram_pinv(v.double())
    with pytest.raises(ValueError, match="must be"):
        gram_pinv.gram_pinv(v[:, :, :4])
    with pytest.raises(ValueError, match="contiguous"):
        gram_pinv.gram_pinv(v.mT)
    assert gram_pinv.launches == before

    def broken(name):
        raise KernelError(f"nvcc failed on csrc/{name}.cu")

    monkeypatch.setattr(_build, "load", broken)
    st = rt.table1_tensor("nell2")
    # ||X||² is reduced on the card before the first mode update where the call reads the COO
    with pytest.raises(KernelError, match="sum_squares"):
        rt.cp_als(st, 10, n_iters=1, engine="ref")
    with pytest.raises(KernelError, match="gram_pinv"):
        rt.cp_als(st, 10, n_iters=1, engine="ref", track_diff=False)


def test_cp_als_kernel_engine_through_gram_pinv(cuda, monkeypatch):
    """Three warp-tier launches per iteration; fits within 1e-6 of the same
    run through the plain pseudo-inverse on the card, and factors within
    max(1e-5, κ·2^-17) of their largest entry (κ: the worst V's condition
    number; fits here are about 1e-4, so the factors are the sharper test)."""
    st = rt.table1_tensor("nell2")
    plans = []
    plan_pinv = gram_pinv.plan_pinv
    monkeypatch.setattr(gram_pinv, "plan_pinv", lambda *a, **k: plans.append(plan_pinv(*a, **k))
                        or plans[-1])
    before = gram_pinv.launches
    res = rt.cp_als(st, 10, n_iters=3, engine="kernel")
    assert gram_pinv.launches - before == 9
    assert [p.tier for p in plans] == ["warp"] * 9
    monkeypatch.setattr(port_cpals, "_pinv", pref.gram_pinv_ref)
    plain = rt.cp_als(st, 10, n_iters=3, engine="kernel")
    assert gram_pinv.launches - before == 9
    np.testing.assert_allclose(res.fit_history, plain.fit_history, rtol=0, atol=1e-6)
    fs = [f.double().cpu().numpy() for f in plain.factors]
    grams = [f.T @ f for f in fs]
    kappa = max(np.linalg.cond(np.prod([g for k, g in enumerate(grams) if k != mode], axis=0))
                for mode in range(len(fs)))
    for got, want in zip(res.factors, fs, strict=True):
        gap = np.abs(got.double().cpu().numpy() - want).max() / np.abs(want).max()
        assert gap <= max(1e-5, kappa * 2.0 ** -17), (gap, kappa)


# ---------------------------------------------------------------------------
# the fit's sum of squares (csrc/sum_squares.cu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 255, 256 * 1024 + 7, (1 << 22) + 3, 9_000_001])
def test_sum_squares_matches_plain(cuda, n):
    """Float64 sums of exact float64 squares: the kernel, the plain version
    and numpy differ only in the order of the additions, within 2·n·2^-53 of
    the sum; the kernel's order depends on n alone, so it repeats its bits."""
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    values = torch.from_numpy(x).to(cuda)
    before = sum_squares.launches
    got, again = sum_squares.sum_squares(values), sum_squares.sum_squares(values)
    assert sum_squares.launches == before + 2
    assert got.dtype == torch.float64 and got.dim() == 0 and got.device == values.device
    assert torch.equal(got, again)
    x64 = x.astype(np.float64)
    want = float(np.dot(x64, x64))
    for other in (float(got), float(pref.sum_squares_ref(values))):
        assert abs(other - want) <= 2 * n * 2.0 ** -53 * want


def test_sum_squares_refuses_what_it_does_not_take(cuda):
    before = sum_squares.launches
    empty = sum_squares.sum_squares(torch.empty(0, device=cuda))
    assert float(empty) == 0.0 and empty.dtype == torch.float64
    for bad, err in [(torch.ones(4, 4, device=cuda), ValueError),
                     (torch.ones(8, device=cuda)[::2], ValueError),
                     (torch.ones(8, dtype=torch.float64, device=cuda), TypeError)]:
        with pytest.raises(err):
            sum_squares.sum_squares(bad)
    assert sum_squares.launches == before


def test_cp_als_reduces_the_norm_once_on_the_card(cuda):
    """One launch a `cp_als` call that uploads the COO, none where it uploads
    none; the fit from the kernel's ||X||² equals the host norm's within 1e-9."""
    st = rt.random_tensor((42, 30, 36), 900, seed=5)
    kw = dict(chunk_shape=(6, 6, 6), capacity=16)
    before = sum_squares.launches
    res = rt.cp_als(st, 8, n_iters=3, engine="kernel", seed=4, **kw)
    assert sum_squares.launches == before + 1
    rt.cp_als(st, 8, n_iters=3, engine="kernel", seed=4, track_diff=False, **kw)
    assert sum_squares.launches == before + 1
    norm_x2 = sum_squares.sum_squares(torch.from_numpy(st.values).to(cuda))
    assert abs(port_cpals.fit_value(st, res.factors, res.lam, norm_x2=norm_x2)
               - port_cpals.fit_value(st, res.factors, res.lam)) <= 1e-9


@pytest.mark.parametrize("engine", ["kernel", "fixed:int15-12"])
def test_cp_als_keeps_the_coo_on_the_card(cuda, engine):
    """Two calls on one engine copy the COO (3.2 MB here) once: the second
    copies only the factors.  Against two calls that each copy the COO into
    an engine of their own, built after the previous one is dropped, the
    histories agree within 1e-5 (the float kernel's atomics reorder its sums)
    and the peak device memory over the two calls within 1 MiB."""
    st = rt.random_tensor((300, 200, 400), 200_000, seed=6)
    rank, kw = 8, dict(chunk_shape=(32, 32, 32), capacity=256)
    counter = default_registry.counter("cp_als.upload_bytes")

    def build():
        return rt.build_engine(st, engine, rank, device=cuda, plans=rt.PlanCache(), **kw)

    def two_calls(resident: bool):
        gc.collect()
        torch.cuda.synchronize(cuda)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(cuda)
        eng, out = build(), []
        for seed in (0, 1):
            if not resident and seed:
                del eng
                gc.collect()
                eng = build()
            before = counter.value
            with capture() as spans:
                res = rt.cp_als(st, rank, 3, engine=eng, seed=seed)
            (upload,) = [s for s in spans if s.name == "cp_als.upload"]
            out.append((res, upload.attrs["coo"], counter.value - before))
        torch.cuda.synchronize(cuda)
        return out, torch.cuda.max_memory_allocated(cuda)

    factor_bytes, coo_bytes = sum(st.shape) * rank * 4, st.nnz * 16
    per_call, per_call_peak = two_calls(resident=False)
    got, peak = two_calls(resident=True)
    assert [(how, n) for _, how, n in per_call] == [("copied", factor_bytes + coo_bytes)] * 2
    assert [(how, n) for _, how, n in got] == [("copied", factor_bytes + coo_bytes),
                                               ("resident", factor_bytes)]
    for (res, _, _), (want, _, _) in zip(got, per_call, strict=True):
        np.testing.assert_allclose(res.fit_history, want.fit_history, rtol=0, atol=1e-5)
        np.testing.assert_allclose(res.diff_history, want.diff_history, rtol=0, atol=1e-5)
    assert abs(peak - per_call_peak) <= 1 << 20, (peak, per_call_peak)


@pytest.fixture
def nccl_mesh(cuda):
    """A (1, 1) mesh on a one-rank NCCL group, destroyed after the test."""
    import torch.distributed as dist

    from repro_torch.launch import make_local_mesh
    mesh = make_local_mesh()
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("reduce", ["psum", "psum_scatter"])
def test_distributed_engine_on_one_nccl_rank_matches_kernel(nccl_mesh, reduce):
    """The `distributed` engine on a one-rank NCCL mesh launches the float
    kernel once per mode on the plan cache's resident arrays, and agrees
    with the `kernel` engine within 1e-5 of the sum of |terms| per entry
    (both sum with float atomics, in orders that change from run to run)."""
    import torch.distributed as dist
    assert dist.get_backend() == "nccl"
    st = rt.random_tensor((42, 30, 36), 900, seed=5)
    kw = dict(chunk_shape=(6, 6, 6), capacity=16, plans=rt.PlanCache())
    eng = rt.build_engine(st, "distributed", 8, mesh=nccl_mesh, reduce=reduce, **kw)
    kern = rt.build_engine(st, "kernel", 8, **kw)
    assert (eng.fn.arrays["values"].data_ptr()
            == kern.context.device_arrays()["values"].data_ptr())
    factors = rt.init_factors(st.shape, 8, seed=0, device="cuda")
    coords = torch.from_numpy(st.coords).cuda()
    abs_values = torch.from_numpy(np.abs(st.values)).cuda()
    for mode in range(3):
        before = mttkrp_kernel.launches
        got = eng(factors, mode)
        assert mttkrp_kernel.launches == before + 1
        want = kern(factors, mode)
        terms = rt.mttkrp_coo([f.abs() for f in factors], coords, abs_values, mode=mode,
                              out_dim=st.shape[mode])
        torch.cuda.synchronize()
        assert got.shape == (st.shape[mode], 8) and got.is_cuda
        assert bool(((got - want).abs() <= 1e-5 * terms).all())
    assert [r["group"] for r in eng.fn.log] == [1] * len(eng.fn.log)


_RANKS_WORKER = """
import json, sys
import torch, torch.distributed as dist
rank, world, init, out, backend = sys.argv[1:6]
rank, world = int(rank), int(world)
device = "cuda" if backend == "nccl" else "cpu"
if device == "cuda":
    torch.cuda.set_device(rank)
dist.init_process_group(backend, init_method="file://" + init, rank=rank, world_size=world)
import repro_torch as rt
from repro_torch.kernels import mttkrp_kernel
from repro_torch.launch import make_local_mesh
st = rt.random_tensor((42, 30, 36), 900, seed=5)
factors = rt.init_factors(st.shape, 8, seed=0, device=device)
res = {}
for n_model in (1, 2):
    mesh = make_local_mesh(n_model=n_model, device=device)
    for reduce in ("psum", "psum_scatter"):
        eng = rt.build_engine(st, "distributed", 8, mesh=mesh, reduce=reduce,
                              chunk_shape=(6, 6, 6), capacity=16, device=device)
        before = mttkrp_kernel.launches
        key = f"{n_model}/{reduce}"
        res[key] = [eng(factors, m).cpu().tolist() for m in range(3)]
        res[key + "/launches"] = mttkrp_kernel.launches - before
        res[key + "/fit"] = rt.cp_als(st, 8, n_iters=3, engine=eng, seed=4).fit_history
with open(f"{out}/{rank}.json", "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
"""


def run_ranks(world: int, tmp_path, backend: str, timeout: float = 300) -> list:
    """Run `_RANKS_WORKER` on `world` ranks (one card each under NCCL) and
    return each rank's results; every rank is killed at the timeout."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANKS_WORKER, str(r), str(world),
                               str(tmp_path / "init"), str(tmp_path), backend],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"a rank did not finish within {timeout} s")
    for p, (_out, err) in zip(procs, outs, strict=True):
        assert p.returncode == 0, err[-4000:]
    return [json.loads((tmp_path / f"{r}.json").read_text()) for r in range(world)]


def test_distributed_engine_on_four_nccl_ranks_matches_kernel(cuda, tmp_path):
    """Four NCCL ranks, one card each, on (4, 1) and (2, 2) meshes: every
    rank's result within 1e-5 of Σ|terms| of the one-card `kernel` engine
    per mode (mode 0: 44 data-padded rows over 42 chunk rows at 4 data
    ranks), one float-kernel launch per mode, and cp_als fits within 1e-5."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards")
    st = rt.random_tensor((42, 30, 36), 900, seed=5)
    kern = rt.build_engine(st, "kernel", 8, chunk_shape=(6, 6, 6), capacity=16,
                           plans=rt.PlanCache())
    factors = rt.init_factors(st.shape, 8, seed=0, device=cuda)
    coords = torch.from_numpy(st.coords).cuda()
    abs_values = torch.from_numpy(np.abs(st.values)).cuda()
    want = [kern(factors, m).cpu() for m in range(3)]
    terms = [rt.mttkrp_coo([f.abs() for f in factors], coords, abs_values, mode=m,
                           out_dim=st.shape[m]).cpu() for m in range(3)]
    fit = rt.cp_als(st, 8, n_iters=3, engine=kern, seed=4).fit_history
    results = run_ranks(4, tmp_path, "nccl")
    for res in results:
        for key in ("1/psum", "1/psum_scatter", "2/psum", "2/psum_scatter"):
            assert res[key + "/launches"] == 3
            for m in range(3):
                got = torch.tensor(res[key][m])
                assert got.shape == want[m].shape
                assert bool(((got - want[m]).abs() <= 1e-5 * terms[m]).all()), (key, m)
            np.testing.assert_allclose(res[key + "/fit"], fit, rtol=0, atol=1e-5)
