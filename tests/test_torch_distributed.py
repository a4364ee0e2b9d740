"""The port's `distributed` backend over `torch.distributed`, against the
JAX package's `DistributedMTTKRP` on the CPU.

Multi-rank runs are spawned: one gloo run of 8 ranks on a (4, 2) mesh
(both reductions, every mode, a shape whose data-padded rows exceed its
chunk-padded ones, 3 CP-ALS iterations through the engine) beside one JAX
run on 8 host devices, and one 2-rank run of the SPMD autotuner.  Every
subprocess has a timeout, so a rank stuck in a collective fails the test
instead of hanging the suite.  The one-rank tests destroy their process
group again, so no other test of the worker sees one.

Tolerances: MTTKRP per entry within 1e-5 of the sum of the absolute values
of its terms (float32 sums of the same products in another order: the
task blocks are split over ranks and reduced by the collectives); fits
within 1e-5; the one-rank mesh runs the `chunked` op and an identity
reduction, so it equals the `chunked` engine bit for bit.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch as rt
from repro.roofline.hlo import collective_bytes as hlo_collective_bytes
from repro.roofline.hlo import parse_collectives
from repro_torch.core.distributed import _pad_dim
from repro_torch.launch import make_local_mesh, mesh_axes
from repro_torch.roofline import collective_bytes, wire_bytes
from test_roofline import HLO

REPO = Path(__file__).resolve().parents[1]
RANK = 8
REL_TOL = 1e-5
FIT_ATOL = 1e-5
TIMEOUT = 300
#: name -> (shape, nnz, seed, chunk_shape, capacity).  "pad": mode 0 has 42
#: rows in chunks of 6 (42 rows chunk-padded), and 4 data ranks want 44.
CASES = {
    "base": ((40, 32, 48), 2000, 1, (8, 8, 8), 32),
    "pad": ((42, 30, 36), 900, 5, (6, 6, 6), 16),
}
REDUCTIONS = ("psum", "psum_scatter")
CP_SEED = 4

_PORT_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    job, rank, world, init, out, spec = sys.argv[1:7]
    rank, world, spec = int(rank), int(world), json.loads(spec)
    dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                            world_size=world)
    import repro_torch as rt
    from repro_torch.launch import make_local_mesh, mesh_axes, world_rank
    R = spec["rank"]
    res = {}
    if job == "mesh8":
        mesh = make_local_mesh(n_data=4, n_model=2, device="cpu")
        res["eligible"] = rt.eligible_backends()
        for name, (shape, nnz, seed, cs, cap) in spec["cases"].items():
            st = rt.random_tensor(tuple(shape), nnz, seed=seed)
            ct = rt.chunk_tensor(st, tuple(cs), cap)
            rng = np.random.default_rng(2)
            factors = [torch.from_numpy(rng.uniform(-1, 1, (d, R)).astype(np.float32))
                       for d in shape]
            for reduce in ("psum", "psum_scatter"):
                d = rt.DistributedMTTKRP(mesh, ct, R, reduce=reduce)
                res[f"{name}/{reduce}"] = [d(factors, m).tolist() for m in range(3)]
                res[f"{name}/{reduce}/log"] = d.log
        # The shard body through the kernel op (its plain version here):
        # the "pad" case's mode 0 needs 44 rows over 4 data ranks, past the
        # 42 rows of its chunks.
        import repro_torch.core.distributed as cd
        from repro_torch.kernels import ops as kops
        chunked = cd.mttkrp_chunked
        cd.mttkrp_chunked = kops.mttkrp_kernel_op
        shape, nnz, seed, cs, cap = spec["cases"]["pad"]
        st = rt.random_tensor(tuple(shape), nnz, seed=seed)
        for reduce in ("psum", "psum_scatter"):
            d = rt.DistributedMTTKRP(mesh, rt.chunk_tensor(st, tuple(cs), cap), R,
                                     reduce=reduce)
            res[f"pad/{reduce}/kernel_op"] = d(factors, 0).tolist()
        cd.mttkrp_chunked = chunked
        try:
            rt.DistributedMTTKRP(mesh, ct, R - 1)
            res["odd_rank"] = None
        except ValueError as e:
            res["odd_rank"] = str(e)
        shape, nnz, seed, cs, cap = spec["cases"]["base"]
        st = rt.random_tensor(tuple(shape), nnz, seed=seed)
        for reduce in ("psum", "psum_scatter"):
            eng = rt.build_engine(st, "distributed", R, reduce=reduce, device="cpu",
                                  chunk_shape=tuple(cs), capacity=cap)
            res["default_mesh"] = mesh_axes(eng.fn.mesh)
            res[f"fit/{reduce}"] = rt.cp_als(st, R, n_iters=3, engine=eng,
                                             seed=spec["cp_seed"]).fit_history
    elif job == "tune2":
        from repro_torch.engine import TuningStore, registry
        saves = []
        real_save = TuningStore.save
        def counted_save(self):
            saves.append(1)
            real_save(self)
        TuningStore.save = counted_save

        @registry.register_backend("flaky", needs_chunking=True)
        def _flaky(ctx):
            # A candidate that fails on one rank only: every rank must skip it.
            if world_rank() == 1:
                raise RuntimeError("flaky on rank 1")
            return registry.get_backend("chunked").build(ctx)

        st = rt.random_tensor((30, 24, 36), 800, seed=2)
        tune = rt.TunePolicy(candidates=("chunked", "distributed", "flaky"),
                             store=spec["store"])
        eng = rt.build_engine(st, "auto", R, device="cpu", chunk_shape=(8, 8, 8),
                              capacity=32, tune=tune)
        cp = rt.cp_als(st, R, n_iters=2, engine=eng, seed=0)
        warm = rt.build_engine(st, "auto", R, device="cpu", chunk_shape=(8, 8, 8),
                               capacity=32, tune=tune)
        res.update(winners=eng.report.winners, skipped=sorted(eng.report.skipped),
                   probes=eng.report.n_probes, fit=cp.fit_history, saves=len(saves),
                   warm_source=warm.report.source, warm_winners=warm.report.winners)
    with open(f"{out}/{job}.{rank}.json", "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
""")

_REFERENCE_RUN = textwrap.dedent("""
    import json, sys
    import jax.numpy as jnp, numpy as np
    from repro.core import DistributedMTTKRP, cp_als, random_tensor
    from repro.core.chunking import chunk_tensor
    from repro.engine import build_engine
    from repro.launch.mesh import make_mesh_compat
    out, spec = sys.argv[1], json.loads(sys.argv[2])
    R = spec["rank"]
    mesh = make_mesh_compat((4, 2), ("data", "model"))
    res = {}
    for name, (shape, nnz, seed, cs, cap) in spec["cases"].items():
        st = random_tensor(tuple(shape), nnz, seed=seed)
        ct = chunk_tensor(st, tuple(cs), cap)
        rng = np.random.default_rng(2)
        factors = [jnp.asarray(rng.uniform(-1, 1, (d, R)).astype(np.float32)) for d in shape]
        for reduce in ("psum", "psum_scatter"):
            d = DistributedMTTKRP(mesh, ct, R, reduce=reduce)
            res[f"{name}/{reduce}"] = [np.asarray(d(factors, m))[:shape[m]].tolist()
                                       for m in range(3)]
    shape, nnz, seed, cs, cap = spec["cases"]["base"]
    st = random_tensor(tuple(shape), nnz, seed=seed)
    for reduce in ("psum", "psum_scatter"):
        eng = build_engine(st, "distributed", R, mesh=mesh, reduce=reduce,
                           chunk_shape=tuple(cs), capacity=cap)
        res[f"fit/{reduce}"] = cp_als(st, R, n_iters=3, engine=eng,
                                      seed=spec["cp_seed"]).fit_history
    with open(out, "w") as f:
        json.dump(res, f)
""")


def _env(**extra):
    return dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1", **extra)


def _wait(procs):
    """Wait for every process (TIMEOUT in all); kill them all on a timeout."""
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"a spawned process did not finish within {TIMEOUT} s")
    for p, (_out, err) in zip(procs, outs, strict=True):
        assert p.returncode == 0, err[-4000:]


def _spawn_ranks(job: str, world: int, tmp: Path, spec: dict) -> list:
    return [subprocess.Popen(
        [sys.executable, "-c", _PORT_WORKER, job, str(r), str(world), str(tmp / f"{job}.init"),
         str(tmp), json.dumps(spec)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def _results(job: str, world: int, tmp: Path) -> list:
    return [json.loads((tmp / f"{job}.{r}.json").read_text()) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 8-rank gloo run of the port and the JAX package's run on 8 host
    devices, started together."""
    tmp = tmp_path_factory.mktemp("dist8")
    spec = {"rank": RANK, "cases": CASES, "cp_seed": CP_SEED}
    ref_out = tmp / "reference.json"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_RUN, str(ref_out), json.dumps(spec)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    procs += _spawn_ranks("mesh8", 8, tmp, spec)
    _wait(procs)
    return _results("mesh8", 8, tmp), json.loads(ref_out.read_text())


def _inputs(name):
    shape, nnz, seed, _cs, _cap = CASES[name]
    st = rt.random_tensor(shape, nnz, seed=seed)
    rng = np.random.default_rng(2)
    factors = [torch.from_numpy(rng.uniform(-1, 1, (d, RANK)).astype(np.float32))
               for d in shape]
    return st, factors


def test_padding_case_wants_more_rows_than_its_chunks_hold():
    """The kernel op (its plain version here) pads the requested rows to
    whole chunks, so it returns all 44 rows the reduction needs."""
    shape, nnz, seed, cs, cap = CASES["pad"]
    assert _pad_dim(shape[0], 4) == 44 > -(-shape[0] // cs[0]) * cs[0] == 42
    st, factors = _inputs("pad")
    dev = rt.chunked_device_arrays(rt.chunk_tensor(st, cs, cap), "cpu")
    args = (factors, dev["task_chunk"], dev["coords_rel"], dev["values"])
    got = rt.mttkrp_kernel_op(*args, mode=0, chunk_shape=cs, out_dim=44)
    want = rt.mttkrp_chunked(*args, mode=0, chunk_shape=cs, out_dim=44)
    assert got.shape == (44, RANK) and not got[42:].any()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("reduce", REDUCTIONS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_distributed_mttkrp_matches_reference(runs, case, reduce, mode):
    port, ref = runs
    st, factors = _inputs(case)
    terms = rt.mttkrp_coo([f.abs() for f in factors], torch.from_numpy(st.coords),
                          torch.from_numpy(np.abs(st.values)), mode=mode,
                          out_dim=st.shape[mode]).numpy()
    got = np.asarray(port[0][f"{case}/{reduce}"][mode], np.float32)
    want = np.asarray(ref[f"{case}/{reduce}"][mode], np.float32)
    assert got.shape == want.shape == (st.shape[mode], RANK)
    assert np.all(np.abs(got - want) <= REL_TOL * terms)
    # The engine contract: the full result on every rank.
    for other in port[1:]:
        assert other[f"{case}/{reduce}"][mode] == port[0][f"{case}/{reduce}"][mode]


@pytest.mark.parametrize("reduce", REDUCTIONS)
def test_padding_rows_past_the_chunks_through_the_kernel_op(runs, reduce):
    """The shard body through the kernel op reduces the data-padded rows
    (44), past the chunk-padded ones (42), and agrees with the reference."""
    port, ref = runs
    st, factors = _inputs("pad")
    terms = rt.mttkrp_coo([f.abs() for f in factors], torch.from_numpy(st.coords),
                          torch.from_numpy(np.abs(st.values)), mode=0, out_dim=42).numpy()
    got = np.asarray(port[0][f"pad/{reduce}/kernel_op"], np.float32)
    want = np.asarray(ref[f"pad/{reduce}"][0], np.float32)
    assert got.shape == want.shape == (42, RANK)
    assert np.all(np.abs(got - want) <= REL_TOL * terms)


@pytest.mark.parametrize("reduce", REDUCTIONS)
def test_distributed_cpals_fits_match_reference_and_ref(runs, reduce):
    port, ref = runs
    shape, nnz, seed, _cs, _cap = CASES["base"]
    fits = port[0][f"fit/{reduce}"]
    assert len(fits) == 3 and all(r[f"fit/{reduce}"] == fits for r in port)
    np.testing.assert_allclose(fits, ref[f"fit/{reduce}"], rtol=0, atol=FIT_ATOL)
    plain = rt.cp_als(rt.random_tensor(shape, nnz, seed=seed), RANK, n_iters=3, engine="ref",
                      seed=CP_SEED, device="cpu")
    np.testing.assert_allclose(fits, plain.fit_history, rtol=0, atol=FIT_ATOL)


def test_eight_ranks_make_distributed_eligible_on_a_default_4x2_mesh(runs):
    port, _ref = runs
    assert "distributed" in port[0]["eligible"]
    assert port[0]["default_mesh"] == {"data": 4, "model": 2}


def test_rank_not_divisible_by_model_ranks_raises(runs):
    port, _ref = runs
    assert all("does not split over 2" in r["odd_rank"] for r in port)


@pytest.mark.parametrize("reduce", REDUCTIONS)
def test_collective_log_equals_hlo_accounting(runs, reduce):
    """The engine's log, written out as HLO collectives of the same op,
    result bytes and group, costs what `repro.roofline.hlo` says."""
    port, _ref = runs
    log = port[0][f"base/{reduce}/log"]
    assert len(log) == 3 * (2 if reduce == "psum" else 3)
    assert {r["group"] for r in log} == {4, 2}
    groups = {2: "{{0,1}}", 4: "{{0,1,2,3}}"}
    hlo = "\n".join(f"  %c{i} = f32[{r['bytes'] // 4}]{{0}} {r['op']}(%p), "
                    f"replica_groups={groups[r['group']]}" for i, r in enumerate(log))
    assert collective_bytes(log) == hlo_collective_bytes(hlo)


def test_collective_bytes_of_the_hlo_sample_equal_the_reference():
    records = parse_collectives(HLO)
    for r in records:
        assert wire_bytes(r["op"], r["bytes"], r["group"]) == r["wire_bytes"]
    assert collective_bytes(records) == hlo_collective_bytes(HLO)
    with pytest.raises(ValueError, match="unknown collective"):
        wire_bytes("broadcast", 4, 2)


@pytest.fixture
def one_rank_mesh():
    assert not dist.is_initialized()
    mesh = make_local_mesh(device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("reduce", REDUCTIONS)
def test_one_rank_mesh_equals_chunked_bit_for_bit(one_rank_mesh, reduce):
    assert dist.get_backend() == "gloo" and mesh_axes(one_rank_mesh) == {"data": 1, "model": 1}
    st, factors = _inputs("pad")
    kw = dict(chunk_shape=CASES["pad"][3], capacity=CASES["pad"][4], device="cpu")
    got = rt.build_engine(st, "distributed", RANK, mesh=one_rank_mesh, reduce=reduce, **kw)
    want = rt.build_engine(st, "chunked", RANK, **kw)
    for mode in range(3):
        assert torch.equal(got(factors, mode), want(factors, mode))
    a = rt.cp_als(st, RANK, n_iters=3, engine=got, seed=CP_SEED)
    b = rt.cp_als(st, RANK, n_iters=3, engine=want, seed=CP_SEED)
    assert a.fit_history == b.fit_history
    assert collective_bytes(got.fn.log)["total_wire_bytes"] == 0.0


def test_one_rank_group_keeps_distributed_ineligible(one_rank_mesh):
    assert "distributed" not in rt.eligible_backends()
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_local_mesh(n_data=2, device="cpu")
    with pytest.raises(ValueError, match="mesh is over cpu"):
        rt.build_engine(rt.random_tensor((8, 8, 8), 40, seed=0), "distributed", 2,
                        mesh=one_rank_mesh, device="meta")


def test_spmd_autotune_ranks_agree(tmp_path):
    """Two gloo ranks tune `chunked` against `distributed` (and a candidate
    that fails on rank 1 only): both take the same winners, skip the same
    candidate, run CP-ALS to the same fits and go warm together; only
    rank 0 writes the store."""
    store = tmp_path / "store.json"
    _wait(_spawn_ranks("tune2", 2, tmp_path, {"rank": 4, "store": str(store)}))
    r0, r1 = _results("tune2", 2, tmp_path)
    assert r0["winners"] == r1["winners"] and set(r0["winners"]) == {"0", "1", "2"}
    assert r0["skipped"] == r1["skipped"] == ["flaky"]
    assert r0["probes"] == r1["probes"] > 0
    assert r0["fit"] == r1["fit"] and len(r0["fit"]) == 2
    assert r0["warm_source"] == r1["warm_source"] == "persisted"
    assert r0["warm_winners"] == r0["winners"]
    assert r0["saves"] >= 1 and r1["saves"] == 0
    assert store.exists()
