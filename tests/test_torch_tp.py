"""Tensor, expert and FSDP parallelism of the port's LM stack over
`torch.distributed`, against the JAX package on the CPU.

One spawned gloo run of 8 ranks serves and trains the smoke configs of
qwen3-14b (with and without `manual_sp`), jamba-1.5-large, xlstm-350m,
whisper-medium and internvl2-1b on a (4, 2) mesh, and qwen3-moe-30b-a3b
on a (2, 4) one; a second run of 4 ranks resumes the (4, 2) run's
checkpoint onto a (2, 2) mesh with `elastic_restore`.  Every rank holds
only its blocks (the params carried across from the reference by
`interop.lm_params_from_reference(..., mesh=)`); the gradients and params
compared are gathered whole (`gather_tree`).

Held against the JAX package: the dense, SSM, xLSTM, enc-dec and VLM cases
against its one-device run (in this process), whose results the mesh
must give up to summation order; the MoE case against the reference's own
run on a (2, 4) mesh of 8 forced host devices (a subprocess), because
capacity drops exist only on a model axis of more ranks: a rank computes
only cap = max(round_up(2·T·k·e_loc/E, 128), 128) of its assignments, so
on a model axis of two (e_loc = E/2) cap ≥ T·k and nothing can drop, and
the test runs the MoE case on four.  Its batch repeats one token in every
other row, so that routing is skewed and some assignments drop (asserted).

Tolerances, float32: the loss within 1e-5 relative, prefill logits within
1e-5 of Σ|terms| of the final product (LOGIT_REL), `generate`'s tokens
equal, gradients within 1e-4 of each leaf's largest (test_torch_train's),
and after two train steps (grad_accum 2; 8-bit moments for qwen3-14b) at
most 0.1% of param entries more than 1e-5 from the reference's and none
more than 4·lr.  The manual-SP MLP is also held to the port's implicit
path in bfloat16 at tests/test_manual_sp.py's bounds: the loss within
2e-4 relative, gradients within 0.02 of the global norm.  Every
subprocess runs under a timeout.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _lm_families import _batch, _hidden_seen, _jb, _np, _rctx, _tb
from repro import configs as rconfigs
from repro.launch import steps as rsteps
from repro.models import LM as RLM
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw_init as radamw_init
from repro_torch import configs
from repro_torch.interop import lm_params_from_reference
from repro_torch.launch import shardings
from repro_torch.models import LM, MeshCtx, nn

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 300
CPU = torch.device("cpu")
LOGIT_REL = 1e-5
LOSS_REL = 1e-5
GRAD_REL = 1e-4
PARAM_ATOL, PARAM_SHARE = 1e-5, 1e-3
LR = 1e-3
SP_LOSS_REL, SP_GRAD_NORM = 2e-4, 0.02
ROWS, SEQ, GEN, PROMPT = 8, 32, 4, 5
#: case → (arch, mesh, overrides of the smoke config, 8-bit moments)
CASES = {
    "qwen3_14b": ("qwen3_14b", (4, 2), {}, True),
    "qwen3_14b_sp": ("qwen3_14b", (4, 2), {"manual_sp": True}, False),
    "qwen3_moe": ("qwen3_moe_30b_a3b", (2, 4), {}, False),
    "jamba": ("jamba_1_5_large_398b", (4, 2), {}, False),
    "xlstm": ("xlstm_350m", (4, 2), {}, False),
    "whisper": ("whisper_medium", (4, 2), {}, False),
    "internvl": ("internvl2_1b", (4, 2), {}, False),
}
MOE = "qwen3_moe"
RESUMED = "qwen3_14b"


def _cfgs(case, dtype="float32"):
    arch, _, over, _ = CASES[case]
    over = dict(over, compute_dtype=dtype)
    return (dataclasses.replace(rconfigs.get_smoke_config(arch), **over),
            dataclasses.replace(configs.get_smoke_config(arch), **over))


def _case_batch(case) -> dict:
    cfg = _cfgs(case)[1]
    b = _batch(cfg, ROWS, SEQ)
    if case == MOE:  # every other row one repeated token: skewed routing, drops
        b["tokens"] = b["tokens"].copy()
        b["tokens"][::2] = 7
    return b


_WORKER = textwrap.dedent("""
    import json, pickle, sys
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    job, rank, world, init, tmp = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
    dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=world)
    import dataclasses
    from repro_torch import configs
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.interop import lm_params_from_reference
    from repro_torch.launch import elastic, make_local_mesh
    from repro_torch.launch.shardings import gather_tree, leaves_with_paths, replication
    from repro_torch.launch.steps import (generate, make_ctx, make_grad_step, make_prefill_step,
                                          make_train_step, param_specs, state_shardings)
    from repro_torch.models import LM, moe, nn
    from repro_torch.optim import AdamWConfig, adamw_init
    spec = json.load(open(tmp + "/spec.json"))
    host = lambda tree: nn.tree_map(lambda a: a.detach().float().numpy().copy(), tree)
    res = {}

    def model(case, dtype="float32"):
        c = spec["cases"][case]
        cfg = dataclasses.replace(configs.get_smoke_config(c["arch"]), compute_dtype=dtype,
                                  **c["over"])
        return LM(cfg), c

    def batch(case):
        b = pickle.load(open(tmp + "/batch_" + case + ".pkl", "rb"))
        return {k: torch.from_numpy(v) for k, v in b.items()}

    if job == "mesh":
        meshes = {}
        for case in spec["cases"]:
            lm, c = model(case)
            shape = tuple(c["mesh"])
            if shape not in meshes:
                meshes[shape] = make_local_mesh(*shape, device="cpu")
            mesh = meshes[shape]
            rparams = pickle.load(open(tmp + "/params_" + case + ".pkl", "rb"))
            params = lm_params_from_reference(rparams, lm.cfg, "cpu", mesh=mesh)
            specs = param_specs(lm, make_ctx(mesh))
            # each rank holds its blocks: their sizes over the ranks count each element
            # times the ranks that hold it
            counts = torch.tensor([float(a.numel()) for a in nn.tree_leaves(params)])
            dist.all_reduce(counts)
            whole = lm_params_from_reference(rparams, lm.cfg, "cpu")
            want = [a.numel() * replication(mesh, s)
                    for a, (_, s) in zip(nn.tree_leaves(whole), leaves_with_paths(specs))]
            out = {"blocks_ok": bool(np.allclose(counts.numpy(), want))}
            b = batch(case)
            ctx = make_ctx(mesh)
            loss, grads = make_grad_step(lm, ctx)(params, b)
            out["loss"] = float(loss)
            out["grads"] = host(gather_tree(grads, specs, mesh))
            moe.drops = 0
            with torch.no_grad():
                out["prefill"] = make_prefill_step(lm, ctx)(params, b).numpy()
            drops = torch.tensor([moe.drops])
            dist.all_reduce(drops)
            out["drops"] = int(drops)
            out["tokens"] = generate(lm, params, make_ctx(mesh, seq_sharded=False),
                                     b["tokens"][:, :spec["prompt"]], spec["gen"]).numpy()
            opt_cfg = AdamWConfig(lr=spec["lr"], use_8bit=c["use_8bit"])
            opt = adamw_init(params, opt_cfg, specs=specs, mesh=mesh)
            step = make_train_step(lm, ctx, opt_cfg, grad_accum=2)
            out["losses"] = []
            for _ in range(2):
                params, opt, loss = step(params, opt, b)
                out["losses"].append(float(loss))
            out["params"] = host(gather_tree(params, specs, mesh))
            if case == spec["resumed"]:
                sh = state_shardings(lm, mesh, opt_cfg)
                save_checkpoint(tmp + "/ckpt", 2, {"params": params, "opt": opt},
                                shardings=sh, mesh=mesh)
                out["opt"] = host(gather_tree(opt, sh["opt"], mesh))
                params, opt, loss = step(params, opt, b)
                out["third_loss"] = float(loss)
            if c["over"].get("manual_sp"):  # bfloat16: manual SP against the implicit path
                for name, sp in (("sp_bf16", True), ("implicit_bf16", False)):
                    lm_b = LM(dataclasses.replace(model(case, "bfloat16")[0].cfg, manual_sp=sp))
                    p_b = lm_params_from_reference(rparams, lm_b.cfg, "cpu", mesh=mesh)
                    l_b, g_b = make_grad_step(lm_b, ctx)(p_b, b)
                    out[name] = {"loss": float(l_b), "grads": host(gather_tree(g_b, specs, mesh))}
            res[case] = out
    else:  # resume the (4, 2) run's checkpoint on the ranks of this run
        lm, c = model(spec["resumed"])
        opt_cfg = AdamWConfig(lr=spec["lr"], use_8bit=c["use_8bit"])
        mesh, params, opt, start = elastic.elastic_restore(lm, tmp + "/ckpt", opt_cfg, n_model=2,
                                                           device="cpu")
        sh = state_shardings(lm, mesh, opt_cfg)
        res = {"mesh": list(mesh.shape), "step": start,
               "params": host(gather_tree(params, sh["params"], mesh)),
               "opt": host(gather_tree(opt, sh["opt"], mesh))}
        step = make_train_step(lm, make_ctx(mesh), opt_cfg, grad_accum=2)
        _, _, loss = step(params, opt, batch(spec["resumed"]))
        res["loss"] = float(loss)
    if rank == 0:
        pickle.dump(res, open(tmp + "/out_" + job + ".pkl", "wb"))
    dist.barrier()
    dist.destroy_process_group()
""")

_REF_MESH = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from repro import configs
    from repro.launch import steps
    from repro.launch.mesh import make_mesh_compat
    from repro.models import LM
    from repro.optim import AdamWConfig, adamw_init
    tmp, case, arch, shape, lr, prompt, gen = sys.argv[1:8]
    shape, lr, prompt, gen = tuple(int(n) for n in shape.split("x")), float(lr), int(prompt), int(gen)
    lm = LM(dataclasses.replace(configs.get_smoke_config(arch), compute_dtype="float32"))
    params = pickle.load(open(tmp + "/params_" + case + ".pkl", "rb"))
    b = {k: jnp.asarray(v) for k, v in pickle.load(open(tmp + "/batch_" + case + ".pkl", "rb")).items()}
    mesh = make_mesh_compat(shape, ("data", "model"))
    ctx = steps.make_ctx(mesh)
    out = {}
    loss, grads = jax.jit(jax.value_and_grad(lambda p, x: lm.loss(p, ctx, x)))(params, b)
    out["loss"] = float(loss)
    out["grads"] = jax.tree.map(np.asarray, grads)
    out["prefill"] = np.asarray(jax.jit(lambda p, x: lm.prefill(p, ctx, x))(params, b))
    out["tokens"] = np.asarray(steps.generate(lm, params, steps.make_ctx(mesh, seq_sharded=False),
                                              b["tokens"][:, :prompt], gen))
    opt_cfg = AdamWConfig(lr=lr)
    opt = adamw_init(params, opt_cfg)
    step = jax.jit(steps.make_train_step(lm, ctx, opt_cfg, grad_accum=2))
    out["losses"] = []
    for _ in range(2):
        params, opt, loss = step(params, opt, b)
        out["losses"].append(float(loss))
    out["params"] = jax.tree.map(np.asarray, params)
    pickle.dump(out, open(tmp + "/ref_mesh.pkl", "wb"))
""")


def _spawn(job, world, tmp, env):
    init = tmp / f"init_{job}"
    return [subprocess.Popen([sys.executable, "-c", _WORKER, job, str(r), str(world), str(init),
                              str(tmp)], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True) for r in range(world)]


def _wait(procs, what):
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"{what} did not finish within {TIMEOUT} s")
    for p, (_, err) in zip(procs, outs, strict=True):
        assert p.returncode == 0, f"{what}: {err[-4000:]}"


def _one_device(case, rparams, batch):
    """The reference on one device (the trivial mesh its MoE needs)."""
    rcfg, cfg = _cfgs(case)
    rlm, ctx = RLM(rcfg), _rctx()
    jb = _jb(batch)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, x: rlm.loss(p, ctx, x)))(rparams, jb)
    out = {"loss": float(loss), "grads": grads,
           "prefill": np.asarray(jax.jit(lambda p, x: rlm.prefill(p, ctx, x))(rparams, jb)),
           "tokens": np.asarray(rsteps.generate(rlm, rparams, ctx, jb["tokens"][:, :PROMPT],
                                                GEN))}
    opt_cfg = RAdamWConfig(lr=LR, use_8bit=CASES[case][3])
    opt = radamw_init(rparams, opt_cfg)
    step = jax.jit(rsteps.make_train_step(rlm, ctx, opt_cfg, grad_accum=2))
    out["losses"], p = [], rparams
    for _ in range(2):
        p, opt, loss = step(p, opt, jb)
        out["losses"].append(float(loss))
    out["params"] = p
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the mesh run's results, the resumed run's, the references', the
    reference params and batches) per case."""
    tmp = tmp_path_factory.mktemp("tp")
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}:{REPO / 'tests'}", OMP_NUM_THREADS="1")
    spec = {"cases": {c: {"arch": a, "mesh": list(m), "over": o, "use_8bit": e}
                      for c, (a, m, o, e) in CASES.items()},
            "resumed": RESUMED, "lr": LR, "gen": GEN, "prompt": PROMPT}
    (tmp / "spec.json").write_text(json.dumps(spec))
    rparams, batches = {}, {}
    for case in CASES:
        rparams[case] = RLM(_cfgs(case)[0]).init(jax.random.key(0))[0]
        batches[case] = _case_batch(case)
        with open(tmp / f"params_{case}.pkl", "wb") as f:
            pickle.dump(jax.tree.map(np.asarray, rparams[case]), f)
        with open(tmp / f"batch_{case}.pkl", "wb") as f:
            pickle.dump(batches[case], f)
    workers = _spawn("mesh", 8, tmp, env)
    arch, mesh = CASES[MOE][:2]
    ref_env = {k: v for k, v in env.items() if k != "XLA_FLAGS"}
    ref_mesh = subprocess.Popen(
        [sys.executable, "-c", _REF_MESH, str(tmp), MOE, arch, "x".join(map(str, mesh)),
         str(LR), str(PROMPT), str(GEN)], env=ref_env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    refs = {case: _one_device(case, rparams[case], batches[case])
            for case in CASES if case != MOE}
    _wait(workers, "the 8-rank run")
    _wait([ref_mesh], "the reference's (2, 4) mesh run")
    resumers = _spawn("resume", 4, tmp, env)
    _wait(resumers, "the 4-rank resume")
    with open(tmp / "ref_mesh.pkl", "rb") as f:
        refs[MOE] = pickle.load(f)
    with open(tmp / "out_mesh.pkl", "rb") as f:
        got = pickle.load(f)
    with open(tmp / "out_resume.pkl", "rb") as f:
        resumed = pickle.load(f)
    return got, resumed, refs, rparams, batches


def _carried(tree, case):
    return lm_params_from_reference(jax.tree.map(np.asarray, tree), _cfgs(case)[1], CPU)


def _pairs(got, want):
    """(path, got, want) over the port's tree and the reference's carried one."""
    flat = dict(shardings.leaves_with_paths(want))
    return [(path, a, _np(flat[path])) for path, a in shardings.leaves_with_paths(got)]


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_only_its_blocks(runs, case):
    got, *_ = runs
    assert got[case]["blocks_ok"]


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_gradients_match_the_reference(runs, case):
    got, _, refs, _, _ = runs
    g, r = got[case], refs[case]
    assert abs(g["loss"] - r["loss"]) <= LOSS_REL * abs(r["loss"]), (g["loss"], r["loss"])
    for path, a, w in _pairs(g["grads"], _carried(r["grads"], case)):
        tol = GRAD_REL * max(np.abs(w).max(), 1e-30)
        assert np.abs(a - w).max() <= tol, (path, float(np.abs(a - w).max()), tol)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_generate_match_the_reference(runs, case):
    got, _, refs, rparams, batches = runs
    rcfg, cfg = _cfgs(case)
    lm = LM(cfg)
    seen = _hidden_seen(lm)  # the final hidden state, for Σ|terms|
    with torch.no_grad():
        lm.prefill(lm_params_from_reference(rparams[case], cfg, CPU), MeshCtx(mesh=None),
                   _tb(batches[case]))
    h = seen[-1].astype(np.float64)
    w = (np.asarray(rparams[case]["embed"]["w"]).T if cfg.tie_embeddings
         else np.asarray(rparams[case]["unembed"]["w"])).astype(np.float64)
    tol = LOGIT_REL * (np.abs(h) @ np.abs(w))
    err = np.abs(got[case]["prefill"] - refs[case]["prefill"])
    assert np.all(err <= tol), float(err.max())
    np.testing.assert_array_equal(got[case]["tokens"], refs[case]["tokens"])


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_match_the_reference(runs, case):
    got, _, refs, _, _ = runs
    g, r = got[case], refs[case]
    np.testing.assert_allclose(g["losses"], r["losses"], rtol=LOSS_REL)
    d = np.concatenate([np.abs(a - w).ravel()
                        for _, a, w in _pairs(g["params"], _carried(r["params"], case))])
    assert (d > PARAM_ATOL).mean() <= PARAM_SHARE and d.max() <= 4 * LR, (
        float((d > PARAM_ATOL).mean()), float(d.max()))


def test_moe_drops_assignments_on_four_model_ranks(runs):
    """Capacity drops happened, and the results above equal the
    reference's mesh run, which drops by the same rule."""
    got, *_ = runs
    assert got[MOE]["drops"] > 0
    assert all(got[c]["drops"] == 0 for c in CASES if c != MOE and CASES[c][1][1] == 2)


def test_manual_sp_matches_the_implicit_path_in_bfloat16(runs):
    got, *_ = runs
    sp, imp = got["qwen3_14b_sp"]["sp_bf16"], got["qwen3_14b_sp"]["implicit_bf16"]
    assert abs(sp["loss"] - imp["loss"]) <= SP_LOSS_REL * abs(imp["loss"])
    a = np.concatenate([x.ravel() for x in nn.tree_leaves(sp["grads"])])
    b = np.concatenate([x.ravel() for x in nn.tree_leaves(imp["grads"])])
    assert np.linalg.norm(a - b) <= SP_GRAD_NORM * np.linalg.norm(b)


def test_elastic_restore_onto_a_smaller_mesh(runs):
    """The (4, 2) run's checkpoint, resumed on 4 ranks as a (2, 2) mesh,
    holds the state bit for bit, and the next step's loss is the one the
    (4, 2) run took."""
    got, resumed, *_ = runs
    assert resumed["mesh"] == [2, 2] and resumed["step"] == 2
    for tree in ("params", "opt"):
        for (path, a), (_, b) in zip(shardings.leaves_with_paths(resumed[tree]),
                                     shardings.leaves_with_paths(got[RESUMED][tree]),
                                     strict=True):
            np.testing.assert_array_equal(a, b, err_msg=str(path))
    assert abs(resumed["loss"] - got[RESUMED]["third_loss"]) <= LOSS_REL * abs(
        got[RESUMED]["third_loss"])


def _torchrun(n: int, *args, env) -> None:
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(n), "-m", "repro_torch.bench.tp", "--device", "cpu", "--smoke", *args]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]


def test_the_multi_card_bench_on_gloo_ranks(tmp_path):
    """`python -m repro_torch.bench.tp` (the four-card record) at the smoke
    configs under `torch.distributed.run` on the CPU: the (1, 4) and (2, 2)
    meshes' prefill logits within 1e-5 of Σ|terms| of one rank's and their
    tokens equal; a train step on (2, 2) and its checkpoint resumed on two
    ranks as (1, 2), bit for bit, whose next loss is the (2, 2) run's
    within 1e-2 (bfloat16 compute, the bound of tests/_lm_families.py)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    out, ckpt = tmp_path / "tp.jsonl", tmp_path / "ckpt"
    for part in ("agree", "serve", "train"):
        _torchrun(4, "--part", part, "--out", str(out), "--ckpt", str(ckpt), env=env)
    _torchrun(2, "--part", "restore", "--out", str(out), "--ckpt", str(ckpt), env=env)
    agree, serve, train, restore = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert agree["ok"] and agree["1x4"]["tokens_equal"] and agree["2x2"]["tokens_equal"]
    assert serve["mesh"] == [1, 4] and serve["decode_collectives"]["count"] > 0
    assert len(serve["tokens"]) == 4 and len(serve["tokens"][0]) == 12
    assert train["mesh"] == [2, 2] and restore["mesh"] == [1, 2] and restore["restored_equal"]
    assert abs(restore["loss"] - train["next_loss"]) <= 1e-2 * abs(train["next_loss"])
