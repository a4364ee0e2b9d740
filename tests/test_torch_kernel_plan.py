"""Launch plans of the spMTTKRP kernels (`repro_torch.kernels.tiles`), on the
CPU: the tier, blocks per task and shared memory each shape gets, the
resident `nnz_per_task` the kernels stop at, and the build hash that must
cover the shared header.

The cases are `chip_smoke.py`'s at R = 10: (a) NELL-2 under the 256 KiB
plan, (b) NELL-2 under the default 64 MiB plan, (c) LBNL under the 256 KiB
plan; f32 factors and values (the float kernel) and int16 factors and
qvalues (the fixed kernel with int7).
"""
import math
import shutil
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.kernels import _build, tiles
from repro_torch.kernels import ref as kref

A = dict(num_tasks=8192, capacity=18_405, chunk_shape=(756, 574, 901))
B = dict(num_tasks=32, capacity=4_791_455, chunk_shape=(6046, 4592, 3603))
C = dict(num_tasks=357, capacity=10_548, chunk_shape=(1605, 4198, 1631, 4209, 3392))
F32 = dict(factor_bytes=4, value_bytes=4)
I16 = dict(factor_bytes=2, value_bytes=2)

# (case, widths) -> per mode (tier, staged input modes, blocks per task)
EXPECTED = [
    (A, F32, [("staged", (1, 2), 1), ("staged", (0, 2), 1), ("staged", (0, 1), 1)]),
    (A, I16, [("staged", (1, 2), 1), ("staged", (0, 2), 1), ("staged", (0, 1), 1)]),
    # (b): mode 0's 6,046-row accumulator (242 KB) does not fit; modes 1-2
    # keep only theirs, and the 32 tasks are split over 17 blocks each.
    (B, F32, [("global", (), 4680), ("accumulator", (), 17), ("accumulator", (), 17)]),
    (B, I16, [("global", (), 4680), ("accumulator", (), 17), ("accumulator", (), 17)]),
    # (c): every accumulator fits; mode 0's 64 KB factor block is staged
    # where it fits beside it (modes 2 and 4), and staging stops at the
    # first input block that does not fit (mode order).
    (C, F32, [("accumulator", (), 1), ("accumulator", (), 1), ("staged", (0,), 1),
              ("accumulator", (), 1), ("staged", (0,), 1)]),
    (C, I16, [("staged", (1, 2), 1), ("staged", (0,), 1), ("staged", (0, 1), 1),
              ("staged", (0,), 1), ("staged", (0,), 1)]),
]


@pytest.mark.parametrize(("case", "widths", "want"), EXPECTED,
                         ids=["a-f32", "a-i16", "b-f32", "b-i16", "c-f32", "c-i16"])
def test_plan_launch_tiers_of_the_smoke_cases(case, widths, want):
    for mode, (tier, staged, bpt) in enumerate(want):
        plan = tiles.plan_launch(**case, mode=mode, rank=10, **widths)
        assert (plan.tier, plan.staged, plan.blocks_per_task) == (tier, staged, bpt), mode
        assert plan.smem_bytes <= tiles.SMEM_BUDGET
        if tier == "global":
            assert plan.smem_bytes == 3 * len(case["chunk_shape"]) * 8
        else:
            assert plan.smem_bytes == tiles.task_smem_bytes(case["chunk_shape"], mode, 10, staged,
                                                            **widths)


def test_task_smem_bytes_layout():
    """Mode table 3·32 B, two ring stages of 512 slots (12 B coordinates and
    a 4 B value each, 32 B of alignment room per array), the 756 × 10 f32
    accumulator and the staged 574- and 901-row blocks, each 16 B aligned."""
    ring_stage = (6144 + 32) + (2048 + 32)
    want = 96 + 2 * ring_stage + 30240 + 22960 + 36048
    assert tiles.task_smem_bytes((756, 574, 901), 0, 10, (1, 2), factor_bytes=4,
                                 value_bytes=4) == want == 105_856


@pytest.mark.parametrize("widths", [F32, I16])
def test_budget_below_one_accumulator_row_lands_in_global(widths):
    base = tiles.task_smem_bytes(A["chunk_shape"], 0, 10, factor_bytes=widths["factor_bytes"],
                                 value_bytes=widths["value_bytes"])
    row = 10 * 4
    for budget in (0, row - 1, base - 1):
        plan = tiles.plan_launch(**A, mode=0, rank=10, smem_budget=budget, **widths)
        assert plan.tier == "global"
        assert plan.blocks_per_task == -(-A["capacity"] // tiles.GLOBAL_TILE)
    assert tiles.plan_launch(**A, mode=0, rank=10, smem_budget=base,
                             **widths).tier == "accumulator"


def test_forced_tiers():
    for tier in tiles.TIERS:
        assert tiles.plan_launch(**A, mode=1, rank=10, tier=tier).tier == tier
    assert tiles.plan_launch(**A, mode=1, rank=10, tier="accumulator").staged == ()
    with pytest.raises(ValueError, match="needs"):
        tiles.plan_launch(**B, mode=0, rank=10, tier="accumulator")
    with pytest.raises(ValueError, match="no factor block fits"):
        tiles.plan_launch(**B, mode=1, rank=10, tier="staged")
    with pytest.raises(ValueError, match="tier must be one of"):
        tiles.plan_launch(**A, mode=0, rank=10, tier="shared")


def test_blocks_per_task_split_few_large_tasks_only():
    one = tiles.plan_launch(1, 400_000, (300, 200, 400), 0, 10)
    assert one.blocks_per_task == 400_000 // 4096
    small = tiles.plan_launch(1, 600, (16, 8, 16), 0, 10)
    assert small.blocks_per_task == 1
    many = tiles.plan_launch(10_000, 400_000, (300, 200, 400), 0, 10)
    assert many.blocks_per_task == 1
    assert tiles.plan_launch(0, 0, (8, 8, 8), 0, 4).blocks_per_task == 1


@pytest.mark.parametrize("rank", [1, 3, 10, 33, 64])
def test_plans_fit_every_rank(rank):
    for case in (A, B, C):
        for mode in range(len(case["chunk_shape"])):
            for widths in (F32, I16):
                plan = tiles.plan_launch(**case, mode=mode, rank=rank, **widths)
                assert plan.smem_bytes <= tiles.SMEM_BUDGET
                assert plan.blocks_per_task >= 1


def test_chunked_device_arrays_carry_nnz_per_task():
    st = rt.random_tensor((40, 30, 50), 1500, seed=2, distribution="powerlaw")
    ct = rt.chunk_tensor(st, (16, 8, 16), 64)
    dev = rt.chunked_device_arrays(ct, "cpu")
    got = dev["nnz_per_task"]
    assert got.dtype == torch.int32 and tuple(got.shape) == (ct.num_tasks,)
    assert got.numpy().tobytes() == ct.nnz_per_task.tobytes()
    assert int(got.sum()) == st.nnz


def test_nnz_per_task_checks():
    cr = torch.zeros((4, 8, 3), dtype=torch.int32)
    tiles.check_nnz_per_task(None, cr)
    tiles.check_nnz_per_task(torch.zeros(4, dtype=torch.int32), cr)
    with pytest.raises(TypeError, match="int32"):
        tiles.check_nnz_per_task(torch.zeros(4, dtype=torch.int64), cr)
    with pytest.raises(ValueError, match="contiguous"):
        tiles.check_nnz_per_task(torch.zeros(5, dtype=torch.int32), cr)


@pytest.mark.parametrize("fixed", [False, True])
def test_plain_versions_ignore_nnz_per_task(fixed):
    """On the CPU the wrappers run the plain versions, which accept
    nnz_per_task and give what they give without it."""
    st = rt.random_tensor((17, 23, 9), 200, seed=1)
    ct = rt.chunk_tensor(st, (8, 8, 4), 16)
    dev = rt.chunked_device_arrays(ct, "cpu")
    rng = np.random.default_rng(0)
    factors = [torch.from_numpy(rng.uniform(-1, 1, (d, 3)).astype(np.float32))
               for d in st.shape]
    args = (dev["task_chunk"], dev["coords_rel"])
    for mode in range(3):
        if fixed:
            qf, shift = rt.FIXED_PRESETS["int7"]
            vq = rt.value_qformat(ct.values)
            qvalues = torch.from_numpy(vq.quantize_np(ct.values))
            kw = dict(mode=mode, chunk_shape=ct.chunk_shape, out_dim=st.shape[mode],
                      matrix_frac=qf.frac_bits, value_frac=vq.frac_bits, prec_shift=shift)
            qfactors = [qf.quantize(f) for f in factors]
            got = rt.mttkrp_fixed_kernel_op(qfactors, *args, qvalues, **kw,
                                            nnz_per_task=dev["nnz_per_task"])
            want = rt.mttkrp_fixed_kernel_op(qfactors, *args, qvalues, **kw)
            assert torch.equal(got, want)
        else:
            kw = dict(mode=mode, chunk_shape=ct.chunk_shape, out_dim=st.shape[mode])
            got = rt.mttkrp_kernel_op(factors, *args, dev["values"], **kw,
                                      nnz_per_task=dev["nnz_per_task"])
            want = rt.mttkrp_kernel_op(factors, *args, dev["values"], **kw)
            assert torch.equal(got, want)


def test_library_hash_covers_the_shared_header(tmp_path, monkeypatch):
    for src in _build.CSRC.iterdir():
        shutil.copy(src, tmp_path / src.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {name: _build._library_path(name) for name in ("mttkrp", "mttkrp_fixed")}
    header = tmp_path / "mttkrp_tiles.cuh"
    header.write_text(header.read_text() + "\n// changed\n")
    after = {name: _build._library_path(name) for name in ("mttkrp", "mttkrp_fixed")}
    assert all(before[name] != after[name] for name in before)


# ---------------------------------------------------------------------------
# FROSTT delicious-4d at its published size, and the kernels' direct output
# ---------------------------------------------------------------------------

D_SHAPE = (532_924, 17_262_471, 2_480_308, 1_443)
D_NNZ = 140_126_181


def _delicious_plan():
    """decide_partition's plan for Delicious under the benchmark's 256 KiB
    budget: the decider reads only the shape, nonzero count and density."""
    st = types.SimpleNamespace(shape=D_SHAPE, nnz=D_NNZ, ndim=len(D_SHAPE),
                               density=D_NNZ / math.prod(D_SHAPE))
    return rt.decide_partition(st, 10, mem_bytes=256 * 1024, rank_axis=10)


def test_decide_partition_at_delicious_size():
    plan = _delicious_plan()
    assert plan.chunk_shape == (33_308, 33_716, 38_755, 1_443)
    assert plan.capacity == 2_650
    assert plan.est_chunks == 16 * 512 * 64 * 1


@pytest.mark.parametrize("widths", [F32, I16], ids=["f32", "i16"])
def test_plan_launch_at_delicious_size(widths):
    """Modes 0-2's (S_mode, R) accumulators (1.3-1.6 MB) fit no block: the
    global tier, 3 tiles of a 2,650-slot task; mode 3's 1,443 rows do, and no
    input block fits beside them.  T is a Zipf(1.3) model's 554 K tasks."""
    plan = _delicious_plan()
    got = [tiles.plan_launch(554_000, plan.capacity, plan.chunk_shape, mode, 10, **widths)
           for mode in range(4)]
    assert [(p.tier, p.blocks_per_task) for p in got] == [("global", 3)] * 3 + [
        ("accumulator", 1)]
    # the direct outputs: whole chunks of each mode, 811 MB at R = 10 in float32
    rows = [-(-d // s) * s for d, s in zip(D_SHAPE, plan.chunk_shape, strict=True)]
    assert sum(rows) * 10 * 4 == 811_091_320


@pytest.mark.parametrize("fixed", [False, True])
def test_direct_output_on_the_cpu_adds_the_summed_partials(fixed):
    """The wrappers' plain path adds `reduce_local` of the plain version's
    partials into `out`, as the kernels add into the (I_pad, R) output."""
    st = rt.random_tensor((30, 40, 20, 12), 900, seed=5, distribution="powerlaw")
    ct = rt.chunk_tensor(st, (8, 16, 8, 12), 24)
    dev = rt.chunked_device_arrays(ct, "cpu")
    rng = np.random.default_rng(1)
    factors = [torch.from_numpy(rng.uniform(-1, 1, (d, 4)).astype(np.float32))
               for d in st.shape]
    args = (dev["task_chunk"], dev["coords_rel"])
    for mode in range(4):
        cs = ct.chunk_shape
        padded = [rt.pad_factor(f, cs[m]) for m, f in enumerate(factors)]
        rows = -(-st.shape[mode] // cs[mode]) * cs[mode]
        if fixed:
            qf, shift = rt.FIXED_PRESETS["int15-12"]
            vq = rt.value_qformat(ct.values)
            q = dict(matrix_frac=qf.frac_bits, value_frac=vq.frac_bits, prec_shift=shift)
            qvals = torch.from_numpy(vq.quantize_np(ct.values))
            fs = [qf.quantize(f) for f in padded]
            base = torch.from_numpy(rng.integers(-1000, 1000, (rows, 4), dtype=np.int32))
            local = kref.mttkrp_fixed_local_ref(fs, *args, qvals, mode=mode, chunk_shape=cs, **q)
            got = rt.mttkrp_fixed_local(fs, *args, qvals, mode=mode, chunk_shape=cs, **q,
                                        out=base.clone())
        else:
            base = torch.from_numpy(rng.uniform(-1, 1, (rows, 4)).astype(np.float32))
            local = kref.mttkrp_local_ref(padded, *args, dev["values"], mode=mode, chunk_shape=cs)
            got = rt.mttkrp_local(padded, *args, dev["values"], mode=mode, chunk_shape=cs,
                                  out=base.clone())
        want = base + kref.reduce_local(local, dev["task_chunk"], mode=mode, chunk_shape=cs,
                                        out_dim=rows)
        assert got.shape == (rows, 4) and torch.equal(got, want), mode


@pytest.mark.parametrize("fixed", [False, True])
def test_kernel_ops_count_their_outputs_while_tracing(fixed):
    """`mttkrp.out_bytes` adds each op call's (I_pad, R) output and
    `mttkrp.calls` the call, only while tracing is on."""
    from repro_torch.obs import metrics, tracing

    st = rt.random_tensor((17, 23, 9), 200, seed=1)
    ct = rt.chunk_tensor(st, (8, 8, 4), 16)
    dev = rt.chunked_device_arrays(ct, "cpu")
    factors = [torch.ones((d, 3)) for d in st.shape]
    args = (dev["task_chunk"], dev["coords_rel"])

    def op(mode):
        kw = dict(mode=mode, chunk_shape=ct.chunk_shape, out_dim=st.shape[mode])
        if not fixed:
            return rt.mttkrp_kernel_op(factors, *args, dev["values"], **kw)
        qf, shift = rt.FIXED_PRESETS["int7"]
        vq = rt.value_qformat(ct.values)
        return rt.mttkrp_fixed_kernel_op(
            [qf.quantize(f) for f in factors], *args,
            torch.from_numpy(vq.quantize_np(ct.values)), **kw, matrix_frac=qf.frac_bits,
            value_frac=vq.frac_bits, prec_shift=shift)

    def counts():
        snap = metrics.default_registry.snapshot()
        return tuple(snap[k]["value"] if k in snap else 0
                     for k in ("mttkrp.out_bytes", "mttkrp.calls"))

    before = counts()
    op(0)
    assert counts() == before
    tracing.enable_tracing()
    try:
        outs = [op(mode) for mode in range(3)]
    finally:
        tracing.disable_tracing()
    # rows rounded up to whole chunks: 17 -> 24, 23 -> 24, 9 -> 12; 4 B entries
    assert [o.shape[0] for o in outs] == list(st.shape)
    assert counts() == (before[0] + (24 + 24 + 12) * 3 * 4, before[1] + 3)


@pytest.mark.parametrize("seed", [1, 2**35 + 9])
def test_kernel_engine_on_table1_delicious_agrees_with_the_benchmark_reference(seed):
    """cp_als through the `kernel` engine (its plain path on the CPU, the
    direct output's `reduce_local`) on PRISM Table I's scaled Delicious,
    under the benchmark's 256 KiB plan, held to `perfbench/reference.py`'s
    float64 CP-ALS: float32 rounding through five iterations."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from perfbench import check, reference

    st = rt.table1_tensor("delicious")
    plan = rt.decide_partition(st, 10, mem_bytes=256 * 1024, rank_axis=10)
    res = rt.cp_als(st, 10, n_iters=5, engine="kernel", seed=seed, device="cpu",
                    chunk_shape=plan.chunk_shape, capacity=plan.capacity)
    ref = reference.cp_als_ref(torch.from_numpy(st.coords), torch.from_numpy(st.values),
                               st.shape, 10, 5, seed)
    r = check.readings(res, ref)
    assert r["factor_gap"] < 1e-4 and r["lam_gap"] < 1e-4 and r["fit_gap"] < 1e-6, r
