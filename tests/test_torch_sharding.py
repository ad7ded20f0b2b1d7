"""The port's sharding rules (``dist.sharding``), meshes (``launch.mesh``)
and shape cells (``launch.shapes``) against the reference's.

Every spec is compared by ``path_str`` as ``tuple(spec)``, for every arch of
the catalog on the production meshes and three small ones, ZeRO on and off,
over the parameters and both optimizer states; the reference's trees are
``jax.eval_shape`` trees and its meshes ``AbstractMesh``es, as
``tests/test_dist.py`` builds them.  The production mesh is held against
the dry-run artifacts under ``experiments/dryrun`` (the reference's own
needs 256 devices).
"""

import dataclasses
import functools
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.dist import sharding as jsh
from repro.dist.treepath import path_str as jpath_str
from repro.launch import shapes as jshapes
from repro.models import api as japi
from repro.train import optimizer as jopt
from repro_torch import configs, interop
from repro_torch.dist import sharding as sh
from repro_torch.dist import treepath as tp
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shapes
from repro_torch.models import api

REPO = Path(__file__).resolve().parents[1]

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "4x4": ((4, 4), ("data", "model")),
    "2x8": ((2, 8), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
}


@functools.cache
def _ref_trees(arch: str) -> dict:
    """The reference's parameter and optimizer-state trees (shapes only)."""
    cfg = jconfigs.get(arch)
    params = jax.eval_shape(lambda: japi.init_params(cfg, jax.random.PRNGKey(0)))
    return {"params": params, **{
        sd: jax.eval_shape(lambda s=sd: jopt.init_state(params, jopt.OptConfig(state_dtype=s)))
        for sd in ("float32", "int8")}}


@functools.cache
def _port_trees(arch: str) -> dict:
    cfg = configs.get(arch)
    return {"params": shapes.params_specs(cfg),
            **{sd: shapes.opt_state_specs(cfg, sd) for sd in ("float32", "int8")}}


def _ref_flat(specs) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda s: isinstance(s, P))[0]
    return {jpath_str(p): tuple(s) for p, s in leaves}


def _port_flat(specs, tree) -> dict:
    flat = tp.flatten_with_path(specs)
    assert all(isinstance(s, sh.PartitionSpec) for _, s in flat)
    assert len(flat) == len(tp.leaves(tree))  # a spec is a leaf, one per leaf of the tree
    return {tp.path_str(p): tuple(s) for p, s in flat}


def _meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), sh.AbstractMesh(sizes, names)


def _cfgs(arch, zero):
    return (dataclasses.replace(jconfigs.get(arch), zero_partition=zero),
            dataclasses.replace(configs.get(arch), zero_partition=zero))


# -- the rules ------------------------------------------------------------------------

@pytest.mark.parametrize("zero", [True, False], ids=["zero", "nozero"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_match_reference(arch, mesh, zero):
    """Parameters, float32 and int8 optimizer states: every leaf's spec."""
    jcfg, tcfg = _cfgs(arch, zero)
    jm, tm = _meshes(mesh)
    ref, port = _ref_trees(arch), _port_trees(arch)
    for kind in ("params", "float32", "int8"):
        exp = _ref_flat(jsh.param_specs(jcfg, ref[kind], jm))
        got = _port_flat(sh.param_specs(tcfg, port[kind], tm), port[kind])
        assert got == exp, kind


@pytest.mark.parametrize("mesh", ["16x16", "4x4"])
@pytest.mark.parametrize("cell", list(jshapes.SHAPES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_batch_and_cache_specs_match_reference(arch, cell, mesh):
    jcfg, tcfg = jconfigs.get(arch), configs.get(arch)
    jm, tm = _meshes(mesh)
    jcell, tcell = jshapes.SHAPES[cell], shapes.SHAPES[cell]
    inputs = shapes.input_specs(tcfg, tcell)
    assert (_port_flat(sh.batch_specs(tcfg, inputs, tm), inputs)
            == _ref_flat(jsh.batch_specs(jcfg, jshapes.input_specs(jcfg, jcell), jm)))
    state = shapes.decode_state_specs(tcfg, tcell)
    exp = jsh.cache_specs(jcfg, jshapes.decode_state_specs(jcfg, jcell), jm, jcell.global_batch)
    assert (_port_flat(sh.cache_specs(tcfg, state, tm, tcell.global_batch), state)
            == _ref_flat(exp))


def test_mesh_axes_read_every_kind_of_mesh():
    sizes = {"pod": 2, "data": 16, "model": 16}
    prod = tmesh.make_production_mesh(multi_pod=True)
    for m in (prod, sizes):
        assert sh.mesh_axes(m) == (("pod", "data"), "model")
        assert sh.ep_axes(configs.get("kimi-k2-1t-a32b"), m) == ("data", "model")
    assert sh.mesh_axes({"x": 2, "y": 4}) == (("x",), "y")  # last axis is tp without a 'model'
    specs = sh.param_specs(configs.get("minicpm-2b"), _port_trees("minicpm-2b")["params"], sizes)
    assert specs == sh.param_specs(configs.get("minicpm-2b"),
                                   _port_trees("minicpm-2b")["params"], prod)


def test_partition_spec_is_a_leaf_and_a_sequence():
    s = sh.PartitionSpec(None, ("data", "model"), "model")
    assert tuple(s) == tuple(P(None, ("data", "model"), "model"))
    assert len(s) == 3 and s[1] == ("data", "model") and not isinstance(s, tuple)
    assert s == sh.PartitionSpec(None, ("data", "model"), "model") != sh.PartitionSpec()
    tree = {"a": [s, sh.PartitionSpec()], "b": (sh.PartitionSpec("model"),)}
    assert tp.leaves(tree) == [s, sh.PartitionSpec(), sh.PartitionSpec("model")]


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    m = {"data": 2, "model": 4}
    specs = {"w": sh.PartitionSpec(None, "model"), "e": sh.PartitionSpec(None, ("data", "model")),
             "z": sh.PartitionSpec("data", "model"), "n": sh.PartitionSpec()}
    got = sh.shardings_for(m, specs)
    assert got == {"w": (Replicate(), Shard(1)), "e": (Shard(1), Shard(1)),
                   "z": (Shard(0), Shard(1)), "n": (Replicate(), Replicate())}
    with pytest.raises(ValueError, match="order"):
        sh.placements(m, sh.PartitionSpec(("model", "data")))


# -- meshes and shape cells -----------------------------------------------------------

def test_production_mesh_matches_the_dryrun_artifacts():
    arts = sorted((REPO / "experiments" / "dryrun").glob("*.json"))
    assert len(arts) == 40
    single = tmesh.make_production_mesh()
    for path in arts:
        art = json.loads(path.read_text())
        assert list(single.axis_sizes) == art["mesh"] and list(single.axis_names) == art["axes"]
        assert single.size == art["chips"]
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert (multi.axis_names, multi.axis_sizes, multi.size) == (("pod", "data", "model"),
                                                                (2, 16, 16), 512)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}


def test_host_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_host_mesh(model=2)


def test_shape_tables_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    assert shapes.TRAIN_MICROBATCH == jshapes.TRAIN_MICROBATCH


def _ref_shapes(tree) -> list:
    return [(jpath_str(p), tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_shapes(tree) -> list:
    out = []
    for p, x in tp.flatten_with_path(tree):
        if isinstance(x, int):  # a cache's len: the port's host int, the reference's int32
            out.append((tp.path_str(p), (), "int32"))
        else:
            assert x.device.type == "meta"
            out.append((tp.path_str(p), tuple(x.shape), str(x.dtype).removeprefix("torch.")))
    return out


@pytest.mark.parametrize("cell", list(jshapes.SHAPES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cell_inputs_and_state_match_reference(arch, cell):
    """The 40 cells: applicability (same reasons) and the meta trees."""
    jcfg, tcfg = jconfigs.get(arch), configs.get(arch)
    jcell, tcell = jshapes.SHAPES[cell], shapes.SHAPES[cell]
    assert shapes.cell_supported(tcfg, tcell) == jshapes.cell_supported(jcfg, jcell)
    assert (_port_shapes(shapes.input_specs(tcfg, tcell))
            == _ref_shapes(jshapes.input_specs(jcfg, jcell)))
    assert (_port_shapes(shapes.decode_state_specs(tcfg, tcell))
            == _ref_shapes(jshapes.decode_state_specs(jcfg, jcell)))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_params_and_opt_state_specs_match_reference(arch):
    ref, port = _ref_trees(arch), _port_trees(arch)
    assert (_port_shapes(port["params"])
            == _ref_shapes(jshapes.params_specs(jconfigs.get(arch)))
            == _ref_shapes(ref["params"]))
    for sd in ("float32", "int8"):
        assert _port_shapes(port[sd]) == _ref_shapes(ref[sd]), sd


# -- local_shard ----------------------------------------------------------------------

@pytest.mark.parametrize("coords", [(d, m) for d in range(2) for m in range(2)])
def test_local_shard_is_the_expert_slice(coords):
    """At (2, 2) the experts lie on the joint ('data', 'model') axis: the
    block ``local_shard`` cuts at (d, m) is ``interop.expert_slice``'s slice
    for joint rank 2 d + m."""
    cfg = configs.get("qwen3-moe-235b-a22b").reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    sizes = {"data": 2, "model": 2}
    specs = sh.param_specs(cfg, params, sizes)
    assert tuple(specs["blocks"]["moe"]["wi"])[1] == ("data", "model")
    d, m = coords
    got = sh.local_shard(params, specs, sizes, {"data": d, "model": m})
    exp = interop.expert_slice(cfg, interop.params_to_numpy(params), 2 * d + m, 4)
    for name in ("wi", "wo"):
        g = got["blocks"]["moe"][name]
        assert g.shape[1] == cfg.num_experts_padded // 4
        np.testing.assert_array_equal(g.float().numpy(), exp["blocks"]["moe"][name])
