"""The port's resharded ranged restore (``dist.checkpoint.restore_sharded``)
against the reference's: the same shards bit for bit and the same priced
``S3Store`` op log (every GET's key, bytes and modeled seconds; the totals
and the request cost) for the same restore, on the reference's own test
trees (``tests/test_object_store.py``), a reduced minicpm-2b training state
(float32 masters, bfloat16 weights, int8 moments) at every coord of (1, 4)
and (4, 4), checkpoints crossing packages both ways, and
``benchmarks/ckpt_store.py``'s scenario.  ``shardings_for``'s placements
are held against ``local_shard`` in a gloo world-4 job
(``tests/_torch_spmd_ranks.py``).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

import _torch_spmd_ranks as ranks_
from repro import configs as jconfigs
from repro.dist import checkpoint as jckpt
from repro.dist import object_store as jobs
from repro.dist import sharding as jsh
from repro.models import api as japi
from repro_torch import configs
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist import object_store as obs
from repro_torch.dist import sharding as sh
from repro_torch.dist import treepath as tp
from repro_torch.models import api
from repro_torch.train import optimizer as opt

PS = sh.PartitionSpec


def _to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def _raw(x) -> tuple:
    """(shape, dtype name, bytes) of a tensor or an array: equal means bit-equal."""
    if isinstance(x, torch.Tensor):
        return ranks_.raw(x)
    a = np.asarray(x)
    return tuple(a.shape), str(a.dtype), np.ascontiguousarray(a).tobytes()


def _assert_bit_equal(got, exp):
    """Two trees (tensors or the reference's arrays, leaves in the same order)."""
    g, e = tp.leaves(got), tp.leaves(exp)
    assert len(g) == len(e)
    for a, b in zip(g, e):
        assert _raw(a) == _raw(b)


def _ops(store) -> dict:
    return {"ops": [(o.kind, o.key, o.nbytes, o.time_s) for o in store.ops], "gets": store.gets,
            "bytes_got": store.bytes_got, "op_time_s": store.op_time_s,
            "usd": store.request_cost_usd()}


def _jspecs(specs):
    """The port's spec tree as the reference's (P leaves)."""
    return tp.tree_map(lambda s: P(*s), specs)


class _Pair:
    """The same tree saved by each package into its own S3Store."""

    def __init__(self, tree, step=1):
        self.tree, self.jtree = tree, tp.tree_map(_to_jax, tree)
        self.store, self.jstore = obs.S3Store(), jobs.S3Store()
        self.ref = ckpt.save(self.store, step, tree)
        self.jref = jckpt.save(self.jstore, step, self.jtree)

    def restore(self, specs, sizes, coords, **kw):
        """Both packages' shard at ``coords``; the op logs must be equal."""
        self.store.reset_ops()
        self.jstore.reset_ops()
        got = ckpt.restore_sharded(self.ref, self.tree, specs, sizes, coords, **kw)
        exp = jckpt.restore_sharded(self.jref, self.jtree, _jspecs(specs), sizes, coords, **kw)
        assert _ops(self.store) == _ops(self.jstore)
        _assert_bit_equal(got, exp)
        return got


# -- the reference's cases --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["local", "s3"])
def test_sharded_restore_matches_full(kind, tmp_path):
    """Reassembling every shard reproduces the unsharded checkpoint."""
    t = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
         "v": torch.arange(16, dtype=torch.float32), "norm": torch.ones(8)}
    specs = {"w": PS(None, "model"), "v": PS("model"), "norm": PS()}
    store = obs.LocalStore(tmp_path / "port") if kind == "local" else obs.S3Store()
    jstore = jobs.LocalStore(tmp_path / "ref") if kind == "local" else jobs.S3Store()
    ref, jref = ckpt.save(store, 1, t), jckpt.save(jstore, 1, tp.tree_map(_to_jax, t))
    shards = []
    for i in range(4):
        store.reset_ops()
        jstore.reset_ops()
        shards.append(ckpt.restore_sharded(ref, t, specs, {"model": 4}, {"model": i}))
        exp = jckpt.restore_sharded(jref, tp.tree_map(_to_jax, t), _jspecs(specs),
                                    {"model": 4}, {"model": i})
        _assert_bit_equal(shards[-1], exp)
        got_ops, exp_ops = _ops(store), _ops(jstore)
        if kind == "local":  # the keys name each package's own directory
            for o in (got_ops, exp_ops):
                o["ops"] = [(k, n, s) for k, _, n, s in o["ops"]]
        assert got_ops == exp_ops
    assert torch.equal(torch.cat([s["w"] for s in shards], 1), t["w"])
    assert torch.equal(torch.cat([s["v"] for s in shards]), t["v"])
    for s in shards:  # replicated leaf: every shard gets the whole thing
        assert torch.equal(s["norm"], t["norm"])


def test_ranged_reads_strictly_fewer_bytes():
    pair = _Pair({"w": torch.zeros(64, 64), "b": torch.zeros(64)})
    pair.store.reset_ops()
    ckpt.restore(pair.ref, pair.tree)
    full_bytes, full_time = pair.store.bytes_got, pair.store.op_time_s
    pair.restore({"w": PS("model"), "b": PS("model")}, {"model": 4}, {"model": 2})
    assert pair.store.bytes_got < full_bytes
    assert pair.store.op_time_s < full_time  # dim0 shards: fewer bytes AND trips


def test_inner_dim_sharding_coalesces_to_budget():
    """More runs than the GET budget: ranges merge across the narrowest gaps,
    the result is exact, and the request count stays bounded."""
    pair = _Pair({"w": torch.arange(16 * 12, dtype=torch.float32).reshape(16, 12)})
    shard = pair.restore({"w": PS(None, "model")}, {"model": 3}, {"model": 1}, max_gets=4)
    assert torch.equal(shard["w"], pair.tree["w"][:, 4:8])
    assert pair.store.gets <= 1 + 4  # manifest + at most the budget


def test_joint_axis_sharding():
    pair = _Pair({"e": torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)})
    sizes = {"data": 2, "model": 2}
    got = [pair.restore({"e": PS(("data", "model"))}, sizes, {"data": d, "model": m})["e"]
           for d in range(2) for m in range(2)]
    assert torch.equal(torch.cat(got, 0), pair.tree["e"])


def test_global_shape_still_validated():
    store = obs.S3Store()
    ref = ckpt.save(store, 0, {"w": torch.zeros(8, 8)})
    with pytest.raises(ValueError):
        ckpt.restore_sharded(ref, {"w": torch.zeros(4, 8)}, {"w": PS("model")},
                             {"model": 4}, {"model": 0})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore_sharded(ref, {"w": torch.zeros(8, 8)}, {"w": PS(), "b": PS()},
                             {"model": 4}, {"model": 0})


# -- a reduced minicpm-2b training state --------------------------------------------------

def _minicpm_state() -> dict:
    """Float32 masters, their bfloat16 rounding, and int8 AdamW moments made
    non-zero by one update from a seeded gradient."""
    cfg = configs.get("minicpm-2b").reduced()
    gen = torch.Generator().manual_seed(11)
    params = api.init_params(cfg, gen, device="cpu", master=True)
    ocfg = opt.OptConfig(state_dtype="int8")
    state = opt.init_state(params, ocfg)
    grads = tp.tree_map(lambda p: torch.randn(p.shape, generator=gen), params)
    work = tp.tree_map(torch.clone, params)
    opt.apply_updates(work, grads, state, ocfg)
    assert all(bool(state[k]["blocks"]["wi"]["q"].any()) for k in ("m", "v"))
    bf16 = tp.tree_map(lambda p: p.to(torch.bfloat16), params)
    return {"master": params, "serve": bf16, "opt": state}


@pytest.fixture(scope="module")
def minicpm():
    return _Pair(_minicpm_state(), step=3)


def _coords(shape):
    return [(d, m) for d in range(shape[0]) for m in range(shape[1])]


@pytest.mark.parametrize("mesh,coords", [(m, c) for m in ((1, 4), (4, 4)) for c in _coords(m)],
                         ids=lambda v: "x".join(map(str, v)))
def test_minicpm_state_restores_shard_by_shard(minicpm, mesh, coords):
    cfg = configs.get("minicpm-2b").reduced()
    sizes = dict(zip(("data", "model"), mesh))
    specs = sh.param_specs(cfg, minicpm.tree, sizes)
    jspecs = jsh.param_specs(jconfigs.get("minicpm-2b").reduced(), minicpm.jtree,
                             AbstractMesh(mesh, ("data", "model")))
    assert _jspecs(specs) == jspecs
    kinds = {str(t.dtype) for t in tp.leaves(minicpm.tree)}
    assert {"torch.float32", "torch.bfloat16", "torch.int8", "torch.int32"} <= kinds
    at = dict(zip(("data", "model"), coords))
    shard = minicpm.restore(specs, sizes, at)
    _assert_bit_equal(shard, sh.local_shard(minicpm.tree, specs, sizes, at))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_packages_shard_by_shard(minicpm, writer):
    """A checkpoint the reference wrote restores shard by shard in the port,
    and the other way round: the shards ``local_shard``'s, the op log the
    writer's own reader's."""
    cfg = configs.get("minicpm-2b").reduced()
    sizes = {"data": 1, "model": 4}
    specs = sh.param_specs(cfg, minicpm.tree, sizes)
    for m in range(4):
        at = {"data": 0, "model": m}
        exp = sh.local_shard(minicpm.tree, specs, sizes, at)
        if writer == "reference":
            store = minicpm.jstore
            own = lambda: jckpt.restore_sharded(minicpm.jref, minicpm.jtree, _jspecs(specs),
                                                sizes, at)
            got = lambda: ckpt.restore_sharded(ckpt.CheckpointRef(store, minicpm.jref.name),
                                               minicpm.tree, specs, sizes, at)
        else:
            store = minicpm.store
            own = lambda: ckpt.restore_sharded(minicpm.ref, minicpm.tree, specs, sizes, at)
            got = lambda: jckpt.restore_sharded(jckpt.CheckpointRef(store, minicpm.ref.name),
                                                minicpm.jtree, _jspecs(specs), sizes, at)
        ops = []
        for fn in (own, got):
            store.reset_ops()
            _assert_bit_equal(fn(), exp)
            ops.append(_ops(store))
        assert ops[0] == ops[1]


def test_ckpt_store_scenario_on_the_port():
    """``benchmarks/ckpt_store.py`` on the port at the benchmark's own tree
    (reduced minicpm-2b from PRNGKey(0)) and (1, 4) mesh: its two gates hold
    and every S3 figure equals the reference's run."""
    from benchmarks import ckpt_store

    jparams = japi.init_params(jconfigs.get(ckpt_store.ARCH).reduced(), jax.random.PRNGKey(0))
    params = tp.tree_map(lambda a: torch.from_numpy(np.array(a)), jparams)
    cfg = configs.get(ckpt_store.ARCH).reduced()
    s3 = obs.S3Store()
    ref = ckpt.save(s3, ckpt_store.STEP, params)
    save_ops = {"model_s": s3.op_time_s, "puts": s3.puts, "bytes": s3.bytes_put,
                "cost_usd": s3.request_cost_usd()}

    def priced():
        return {"model_s": s3.op_time_s, "gets": s3.gets, "bytes": s3.bytes_got,
                "cost_usd": s3.request_cost_usd()}

    s3.reset_ops()
    ckpt.restore(ref, params)
    full = priced()
    sizes = dict(zip(ckpt_store.MESH_AXES, ckpt_store.MESH_SHAPE))
    s3.reset_ops()
    shard = ckpt.restore_sharded(ref, params, sh.param_specs(cfg, params, sizes), sizes,
                                 {"data": 0, "model": 0})
    ranged = priced()
    assert ranged["bytes"] / full["bytes"] < 0.6
    assert ranged["model_s"] < full["model_s"]
    exp = ckpt_store.run()
    assert exp["s3"] == {"save": save_ops, "restore_full": full, "restore_ranged": ranged}
    assert exp["ranged_fraction"] == ranged["bytes"] / full["bytes"]
    assert exp["shard_bytes"] == sum(t.numel() * t.element_size() for t in tp.leaves(shard))


# -- shardings_for on a gloo world-4 DeviceMesh ------------------------------------------

def test_distribute_tensor_local_shards_equal_local_shard(tmp_path):
    """Each rank of a (2, 2) ``make_host_mesh`` distributes the reduced
    minicpm-2b and qwen3-moe trees with ``shardings_for``'s placements; its
    local tensors equal ``local_shard`` at its coords, bit for bit."""
    inputs = tmp_path / "inputs.pkl"
    inputs.write_bytes(pickle.dumps({}))
    ranks_.wait(ranks_.launch("shard", 4, tmp_path, inputs), "the shard job")
    outs = ranks_.load(tmp_path, "shard", 4)
    trees = ranks_.shard_trees()
    for rank, out in enumerate(outs):
        assert out["backend"] == "gloo" and out["mesh"] == {"data": 2, "model": 2}
        at = dict(zip(("data", "model"), out["coords"]))
        assert at == {"data": rank // 2, "model": rank % 2}
        for name, (cfg, tree) in trees.items():
            specs = sh.param_specs(cfg, tree, out["mesh"])
            exp = sh.local_shard(tree, specs, out["mesh"], at)
            assert out["local"][name] == {tp.path_str(p): _raw(e)
                                          for p, e in tp.flatten_with_path(exp)}


def test_the_plan_script_prices_what_restore_sharded_reads(minicpm):
    """``scripts/torch_reshard_plan.py`` prices a restore from shapes alone:
    its bytes, GETs and modeled seconds are the real restore's op log less
    the manifest's GET, for the full restore and every shard of (1, 4) and
    (4, 4)."""
    import importlib.util

    path = ranks_.REPO / "scripts" / "torch_reshard_plan.py"
    spec = importlib.util.spec_from_file_location("torch_reshard_plan", path)
    plan_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(plan_mod)
    cfg = configs.get("minicpm-2b").reduced()
    like = tp.leaves(minicpm.tree)

    def logged(fn):
        minicpm.store.reset_ops()
        fn()
        gets = [o for o in minicpm.store.ops if o.kind == "get"][1:]  # after the manifest
        return {"bytes": sum(o.nbytes for o in gets), "gets": len(gets),
                "modeled_s": pytest.approx(sum(o.time_s for o in gets), rel=1e-12)}

    assert plan_mod.plan(like, None, {}, {}) == logged(lambda: ckpt.restore(minicpm.ref,
                                                                             minicpm.tree))
    for mesh in ((1, 4), (4, 4)):
        sizes = dict(zip(("data", "model"), mesh))
        specs = sh.param_specs(cfg, minicpm.tree, sizes)
        for d, m in _coords(mesh):
            at = {"data": d, "model": m}
            assert plan_mod.plan(like, tp.leaves(specs), sizes, at) == logged(
                lambda: ckpt.restore_sharded(minicpm.ref, minicpm.tree, specs, sizes, at))
