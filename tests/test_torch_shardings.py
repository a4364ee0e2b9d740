"""The port's placement (`repro_torch.launch.shardings`) and dry-run
registry (`repro_torch.launch.dryrun`) against the JAX package's.

Specs: every one of the ten configs at its published size, on (4, 2),
(8, 1) and (1, 8) meshes and on the production (16, 16) and (2, 16, 16)
shapes.  The reference resolves against a mesh only through its axis
sizes (`mesh.shape`, `mesh.axis_names`) and wraps each spec in a
`NamedSharding`; the tests hand it an object with those sizes and read
the spec back out of a stand-in for `NamedSharding` (patched into the
reference module for the test only), so no mesh of 256 devices is made.
The reference stacks each pattern slot's layers (a leading repeat axis,
never sharded); the port's per-layer specs must equal its specs with that
axis dropped, layer r·len(pattern) + j against repeat r of slot j.

The dry run: `SHAPES`, the archs `should_skip` skips, `input_structs`'
shapes and dtypes and `count_active_params` equal; the port's collective
schedule, extrapolated from short lengths and two depths, equal to the
same step run at its full length.
"""
import importlib
import math
import os

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.launch import shardings as rsh
from repro.launch import steps as rsteps
from repro.models import LM as RLM
from repro.optim import AdamWConfig as RAdamW
from repro_torch import configs
from repro_torch.launch import dryrun, shardings
from repro_torch.launch.steps import init_opt_shapes
from repro_torch.models import LM
from repro_torch.models.transformer import segment_layout
from repro_torch.optim import AdamWConfig

ARCHS = configs.ARCHS
MESHES = {
    "4x2": {"data": 4, "model": 2},
    "8x1": {"data": 8, "model": 1},
    "1x8": {"data": 1, "model": 8},
    "16x16": {"data": 16, "model": 16},
    "pod2x16x16": {"pod": 2, "data": 16, "model": 16},
}


class SizedMesh:
    """What the reference's resolution reads of a mesh: its axis sizes."""

    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


class Spec:
    """Stands in for `NamedSharding`: keeps the spec."""

    def __init__(self, mesh, spec):
        self.spec = spec


@pytest.fixture
def ref_sh(monkeypatch):
    monkeypatch.setattr(rsh, "NamedSharding", Spec)
    return rsh


@pytest.fixture(scope="module")
def models():
    """arch → (reference LM, its param structs and logical specs, port LM,
    its meta params and logical specs)."""
    out = {}
    for arch in ARCHS:
        rlm, lm = RLM(rconfigs.get_config(arch)), LM(configs.get_config(arch))
        rstructs, rspecs = rsh.init_shapes(rlm, jax.random.key(0))
        structs, specs = shardings.init_shapes(lm)
        out[arch] = (rlm, rstructs, rspecs, lm, structs, specs)
    return out


def _tuple(spec) -> tuple:
    return tuple(spec.spec)


def _unstack(tree, cfg, leaf=_tuple):
    """The reference's stacked tree of Spec leaves in the port's
    per-layer structure, each leaf's spec without the repeat axis."""
    layouts = {"layers": segment_layout(cfg.n_layers, cfg.pattern)}
    if cfg.encoder_decoder:
        from repro_torch.models.model import ENC_SPEC
        layouts["enc_layers"] = segment_layout(cfg.n_enc_layers, (ENC_SPEC,))

    def strip(x):
        return leaf(x)[1:]

    def is_leaf(x):
        return isinstance(x, Spec)
    out = {}
    for k, v in tree.items():
        if k in layouts:
            out[k] = [[jax.tree.map(strip, seg[f"b{j}"], is_leaf=is_leaf)
                       for _ in range(reps) for j in range(len(pat))]
                      for seg, (pat, reps) in zip(v, layouts[k], strict=True)]
        else:
            out[k] = jax.tree.map(leaf, v, is_leaf=is_leaf)
    return out


def _flat(tree) -> dict:
    """path → leaf (a spec tuple is a leaf)."""
    return dict(shardings.leaves_with_paths(tree))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_equal_the_reference(models, ref_sh, arch, mesh):
    rlm, rstructs, rspecs, lm, structs, specs = models[arch]
    sizes = MESHES[mesh]
    want = _unstack(ref_sh.param_shardings(SizedMesh(sizes), rstructs, rspecs), lm.cfg)
    got = shardings.param_shardings(sizes, structs, specs)
    assert _flat(got) == _flat(want)


@pytest.mark.parametrize("use_8bit", [False, True], ids=["f32", "8bit"])
@pytest.mark.parametrize("mesh", ["4x2", "1x8", "16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_shardings_equal_the_reference(models, ref_sh, arch, mesh, use_8bit):
    rlm, rstructs, rspecs, lm, structs, specs = models[arch]
    sizes = MESHES[mesh]
    rmesh = SizedMesh(sizes)
    r_psh = ref_sh.param_shardings(rmesh, rstructs, rspecs)
    r_ostructs = rsteps.init_opt_shapes(rstructs, RAdamW(use_8bit=use_8bit))
    r_osh = ref_sh.opt_shardings(rmesh, r_ostructs, r_psh)
    want = {"m": _unstack(r_osh["m"], lm.cfg), "v": _unstack(r_osh["v"], lm.cfg),
            "step": _tuple(r_osh["step"])}
    p_sh = shardings.param_shardings(sizes, structs, specs)
    o_structs = init_opt_shapes(structs, AdamWConfig(use_8bit=use_8bit))
    got = shardings.opt_shardings(sizes, o_structs, p_sh)
    assert _flat(got) == _flat(want)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_shardings_equal_the_reference(ref_sh, rdryrun, arch, shape, mesh):
    sizes = MESHES[mesh]
    sh = dryrun.SHAPES[shape]
    r_structs = rdryrun.input_structs(rconfigs.get_config(arch), sh["kind"], sh["seq"],
                                      sh["batch"])
    want = jax.tree.map(_tuple, ref_sh.batch_shardings(SizedMesh(sizes), r_structs),
                        is_leaf=lambda x: isinstance(x, Spec))
    structs = dryrun.input_structs(configs.get_config(arch), sh["kind"], sh["seq"], sh["batch"])
    assert _flat(shardings.batch_shardings(sizes, structs)) == _flat(want)


@pytest.mark.parametrize("long_context", [False, True], ids=["32k", "500k"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_equal_the_reference(models, ref_sh, arch, mesh, long_context):
    rlm, _, _, lm, _, _ = models[arch]
    cfg = lm.cfg
    sizes = MESHES[mesh]
    seq, batch = (524288, 1) if long_context else (32768, 128)
    enc_len = seq if cfg.encoder_decoder else 0
    max_len = max(seq // cfg.dec_ratio, 448) if cfg.encoder_decoder else seq
    r_structs = jax.eval_shape(lambda: rlm.init_cache(batch, max_len, enc_len))
    want = _unstack({"layers": ref_sh.cache_shardings(SizedMesh(sizes), r_structs,
                                                      long_context=long_context)}, cfg)
    structs = lm.init_cache(batch, max_len, enc_len=enc_len, device="meta")
    got = shardings.cache_shardings(sizes, structs, long_context=long_context)
    assert _flat({"layers": got}) == _flat(want)


def test_resolve_falls_back_to_replication():
    """A dim that does not divide is replicated; an axis goes to the first
    dim that takes it (the mLSTM's ("inner", "inner") shards only its first)."""
    sizes = {"data": 16, "model": 16}
    assert shardings._resolve(sizes, (1024, 51865), ("embed", "vocab")) == ("data", None)
    assert shardings._resolve(sizes, (2048, 2048), ("inner", "inner")) == ("model", None)
    assert shardings._resolve(sizes, (1024, 1024), ("embed", "embed")) == ("data", None)
    for shape, axes in [((1024, 51865), ("embed", "vocab")), ((2048, 2048), ("inner", "inner")),
                        ((8, 1024, 768), ("expert", None, "expert_ffn"))]:
        assert shardings._resolve(sizes, shape, axes) == tuple(
            rsh._resolve(SizedMesh(sizes), shape, axes))


@pytest.mark.parametrize("mesh", ["4x2", "1x8", "16x16"])
def test_block_shapes_count_every_element_once(models, mesh):
    """The sum over ranks of a leaf's blocks is the leaf times its
    replication (every config's params at full size)."""
    sizes = MESHES[mesh]
    n = math.prod(sizes.values())
    for arch in ARCHS:
        *_, structs, specs = models[arch]
        p_sh = shardings.param_shardings(sizes, structs, specs)
        for path, spec in shardings.leaves_with_paths(p_sh):
            a = _flat(structs)[path]
            block = math.prod(shardings.block_shape(tuple(a.shape), spec, sizes))
            assert block * n == a.numel() * shardings.replication(sizes, spec), (arch, path)


# ---------------------------------------------------------------------------
# The dry run's registry
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rdryrun():
    """The reference's dryrun module, imported with the environment put back
    as it was (it sets XLA_FLAGS when it is imported)."""
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


def test_dryrun_shapes_and_skips_equal_the_reference(rdryrun):
    assert dryrun.SHAPES == rdryrun.SHAPES
    skipped = set()
    for arch in ARCHS:
        for shape in dryrun.SHAPES:
            want = rdryrun.should_skip(rconfigs.get_config(arch), shape)
            assert dryrun.should_skip(configs.get_config(arch), shape) == want
            if want:
                skipped.add(arch)
    assert len(skipped) == 6


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_input_structs_equal_the_reference(rdryrun, arch, shape):
    sh = dryrun.SHAPES[shape]
    want = rdryrun.input_structs(rconfigs.get_config(arch), sh["kind"], sh["seq"], sh["batch"])
    got = dryrun.input_structs(configs.get_config(arch), sh["kind"], sh["seq"], sh["batch"])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape) and got[k].is_meta
        assert str(got[k].dtype).removeprefix("torch.") == str(np.dtype(v.dtype))


@pytest.mark.parametrize("arch", ARCHS)
def test_count_active_params_equals_the_reference(models, rdryrun, arch):
    rlm, rstructs, _, lm, structs, _ = models[arch]
    assert dryrun.count_active_params(lm.cfg, structs) == pytest.approx(
        rdryrun.count_active_params(rlm.cfg, rstructs), rel=1e-12)


@pytest.mark.parametrize("arch, shape", [("command_r_35b", "train_4k"),
                                         ("qwen3_moe_30b_a3b", "prefill_32k"),
                                         ("internvl2_1b", "train_4k"),
                                         ("whisper_medium", "prefill_32k")])
def test_collective_schedule_extrapolates_exactly(arch, shape):
    """Two short lengths and two depths give the full-length step's
    collectives: each collective is affine in the rows and per repeat."""
    cfg = configs.get_config(arch)
    sh = dryrun.SHAPES[shape]
    sizes = dryrun.production_sizes(False)
    fast = dryrun.collective_schedule(cfg, sh["kind"], sh["seq"], sh["batch"], sizes)
    exact = dryrun.collective_schedule(cfg, sh["kind"], sh["seq"], sh["batch"], sizes,
                                       exact=True)
    assert fast["count"] == exact["count"]
    assert fast["total_wire_bytes"] == pytest.approx(exact["total_wire_bytes"], rel=1e-12)
    assert fast["total_wire_bytes"] > 0


def test_run_cell_writes_a_record(tmp_path):
    rec = dryrun.run_cell("command_r_35b", "decode_32k", multi_pod=False, out_dir=str(tmp_path))
    assert (tmp_path / "command_r_35b__decode_32k__pod16x16.json").exists()
    assert rec["n_chips"] == 256 and rec["memory"]["cache_bytes"] > 0
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s", "collective_s")
    skip = dryrun.run_cell("command_r_35b", "long_500k", multi_pod=True, out_dir=str(tmp_path))
    assert "skipped" in skip
    assert dryrun.main(["--arch", "gemma3_4b", "--shape", "decode_32k", "--out",
                        str(tmp_path)]) == 0


@pytest.mark.parametrize("use_8bit", [False, True], ids=["f32", "8bit"])
def test_interop_carries_state_onto_a_mesh(use_8bit):
    """`opt_state_from_reference(..., mesh=)` keeps rank 0's block of every
    leaf of the reference's AdamW state (a (4, 2) mesh of sizes only), as
    `opt_shardings` places it."""
    from repro.optim import adamw_init as radamw_init
    from repro_torch.interop import lm_params_from_reference, opt_state_from_reference
    arch = "qwen3_14b"
    rlm, lm = RLM(rconfigs.get_smoke_config(arch)), LM(configs.get_smoke_config(arch))
    rparams = rlm.init(jax.random.key(0))[0]
    mesh = dryrun.DryMesh(MESHES["4x2"])
    opt_cfg = AdamWConfig(use_8bit=use_8bit)
    ropt = radamw_init(rparams, RAdamW(use_8bit=use_8bit))
    got = opt_state_from_reference(ropt, lm.cfg, "cpu", mesh=mesh, opt_cfg=opt_cfg)
    whole = opt_state_from_reference(ropt, lm.cfg, "cpu")
    structs, specs = shardings.init_shapes(lm)
    o_sh = shardings.opt_shardings(mesh, init_opt_shapes(structs, opt_cfg),
                                   shardings.param_shardings(mesh, structs, specs))
    flat_sh, flat_whole = _flat(o_sh), _flat(whole)
    for path, a in shardings.leaves_with_paths(got):
        w = flat_whole[path]
        assert tuple(a.shape) == shardings.block_shape(tuple(w.shape), flat_sh[path], mesh)
        assert torch.equal(a, w[shardings.block_slices(mesh, tuple(w.shape), flat_sh[path])])
    p = lm_params_from_reference(rparams, lm.cfg, "cpu", mesh=mesh)
    assert tuple(p["embed"]["w"].shape) == (lm.cfg.vocab // 2, lm.cfg.d_model // 4)
