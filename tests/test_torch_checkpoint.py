"""The port's durable state against the reference: ``dist.treepath``,
``dist.object_store`` (the same op logs and priced numbers for the same
operations) and ``dist.checkpoint`` (round trip, ``latest``, atomicity under
injected writer death, strict shapes and leaves, mirroring
``tests/test_dist.py::TestCheckpoint`` and ``tests/test_object_store.py``),
and checkpoints crossing packages both ways.  Everything is exact: bytes,
keys, op kinds, sizes and modeled seconds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import checkpoint as jckpt
from repro.dist import object_store as jobs
from repro.dist import treepath as jtp
from repro.train import optimizer as jopt
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist import object_store as obs
from repro_torch.dist import treepath as tp
from repro_torch.train import optimizer as topt


def _tree(scale=1.0):
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4) * scale,
        "nested": {"b": torch.ones(6, dtype=torch.bfloat16),
                   "step": torch.tensor(7, dtype=torch.int32)},
    }


def _assert_trees_equal(t1, t2):
    for a, b in zip(tp.leaves(t1), tp.leaves(t2)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.fixture(params=["local", "s3"])
def store(request, tmp_path):
    return obs.LocalStore(tmp_path) if request.param == "local" else obs.S3Store()


# -- treepath ---------------------------------------------------------------------

def test_flatten_order_and_paths_match_jax():
    tree = {"z": {"b": 1, "a": [2, 3]}, "a": 4, "m": {"q": 5, "scale": 6}, "n": None}
    exp = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = tp.flatten_with_path(tree)
    assert [leaf for _, leaf in got] == [leaf for _, leaf in exp]
    assert [tp.path_str(p) for p, _ in got] == [jtp.path_str(p) for p, _ in exp]
    assert [tp.path_parts(p) for p, _ in exp] == [jtp.path_parts(p) for p, _ in exp]
    assert tp.path_str(()) == jtp.path_str(()) == "."
    rebuilt = tp.unflatten_like(tree, [x * 10 for x in tp.leaves(tree)])
    assert rebuilt == {"z": {"b": 10, "a": [20, 30]}, "a": 40, "m": {"q": 50, "scale": 60},
                       "n": None}


# -- object stores: same ops, same prices -------------------------------------------

def _drive(store, fail_at=None, killed=obs.WriterKilled):
    """One sequence of operations, returned as the op log with each S3
    generation id (a random uuid) masked."""
    store.put_objects_atomic("g1", {"a": b"x" * 1000, "b": bytes(range(256)) * 4})
    store.put_objects_atomic("g2", {"a": b"y" * 10})
    store.get_object("g1", "a")
    store.get_object("g1", "b", start=16, stop=48)
    store.get_ranges("g1", "b", [(0, 100), (200, 700), (900, 1024)])
    store.object_size("g1", "a")
    store.list_objects("g1")
    store.committed("g2")
    store.committed("nope")
    store.list_groups()
    store.put_objects_atomic("g1", {"a": b"z" * 5})  # re-publish
    store.delete_group("g2")
    if fail_at is not None:
        store.fail_after_puts = fail_at
        with pytest.raises(killed):
            store.put_objects_atomic("g3", {"a": b"1", "b": b"2", "c": b"3"})
        store.fail_after_puts = None
    ops = []
    for o in store.ops:
        parts = o.key.split("/")
        if len(parts) == 3 and len(parts[1]) == 8:
            parts[1] = "<gen>"
        ops.append((o.kind, "/".join(parts), o.nbytes, o.time_s))
    return ops, store.list_groups()


@pytest.mark.parametrize("fail_at", [None, 0, 2])
def test_s3_op_log_and_prices_match(fail_at):
    got, groups = _drive(obs.S3Store(), fail_at)
    exp, jgroups = _drive(jobs.S3Store(), fail_at, jobs.WriterKilled)
    assert got == exp and groups == jgroups
    a, b = obs.S3Store(), jobs.S3Store()
    for s in (a, b):
        _drive(s)
    assert (a.op_time_s, a.puts, a.gets, a.bytes_put, a.bytes_got) == \
        (b.op_time_s, b.puts, b.gets, b.bytes_put, b.bytes_got)
    assert a.request_cost_usd() == b.request_cost_usd() > 0
    assert (obs.S3_USD_PER_PUT, obs.S3_USD_PER_GET) == (jobs.S3_USD_PER_PUT, jobs.S3_USD_PER_GET)


def test_local_op_log_matches(tmp_path):
    a, b = obs.LocalStore(tmp_path / "t"), jobs.LocalStore(tmp_path / "j")
    got, groups = _drive(a)
    exp, jgroups = _drive(b)
    strip = lambda ops, root: [(k, key.replace(str(root), "<root>"), n, t) for k, key, n, t in ops]  # noqa: E731
    assert strip(got, a.root) == strip(exp, b.root) and groups == jgroups
    assert a.op_time_s == 0.0 and a.request_cost_usd() == 0.0
    assert a.bytes_put == b.bytes_put and a.bytes_got == b.bytes_got


def _mask_gen(key):
    parts = key.split("/")
    if len(parts) == 3 and len(parts[1]) == 8:
        parts[1] = "<gen>"
    return "/".join(parts)


@pytest.mark.parametrize("outage", [False, True])
def test_store_tracer_is_not_ported(outage):
    """Once refused; now ``attach_tracer`` mirrors every op onto the store
    lane and ``arm_faults`` prices store outages as ``outage`` ops, both
    equal to the reference's (spans by lane, kind, bytes, usd, interval)."""
    from repro.core import faults as jfaults, trace as jtrace
    from repro_torch.core import faults as tfaults, trace as ttrace

    logs = []
    for store, faults, trace in ((obs.S3Store(), tfaults, ttrace),
                                 (jobs.S3Store(), jfaults, jtrace)):
        tracer = trace.Tracer()
        assert store.attach_tracer(tracer, rank=2) is tracer
        if outage:
            store.arm_faults(faults.FaultPlan(store_outages=((1, 3),)).armed(), step=0)
            store.put_objects_atomic("g0", {"a": b"q" * 64})
            store.set_fault_step(1)
        ops, _ = _drive(store)
        spans = [(sp.rank, sp.lane, sp.kind, sp.nbytes, sp.usd, sp.t0, sp.t1,
                  _mask_gen(sp.meta_dict["key"])) for sp in tracer.spans]
        assert len(spans) == len(store.ops)
        logs.append((ops, spans, [o.kind for o in store.ops].count("outage")))
    assert logs[0] == logs[1]
    assert (logs[0][2] > 0) == outage
    assert isinstance(obs.as_store("somewhere"), obs.LocalStore)


# -- checkpoint contract (both backends) -----------------------------------------

class TestContract:
    def test_roundtrip(self, store):
        t = _tree()
        ref = ckpt.save(store, 3, t, extra={"note": "x"})
        _assert_trees_equal(t, ckpt.restore(ref, t))
        m = ckpt.read_manifest(ref)
        assert m["step"] == 3 and m["extra"]["note"] == "x"

    def test_latest_orders_steps(self, store):
        assert ckpt.latest(store) is None
        ckpt.save(store, 1, _tree())
        ckpt.save(store, 2, _tree())
        assert ckpt.latest(store).name == "step_00000002"
        ckpt.save(store, 10, _tree())
        assert ckpt.latest(store).step == 10

    def test_resave_same_step_last_writer_wins(self, store):
        ckpt.save(store, 5, _tree(1.0))
        ckpt.save(store, 5, _tree(2.0))
        assert ckpt.latest(store).step == 5
        _assert_trees_equal(_tree(2.0), ckpt.restore(ckpt.latest(store), _tree()))

    def test_shape_mismatch_detected(self, store):
        ref = ckpt.save(store, 0, {"a": torch.zeros(2, 2)})
        with pytest.raises(ValueError):
            ckpt.restore(ref, {"a": torch.zeros(3, 2)})

    def test_missing_leaf_detected(self, store):
        ref = ckpt.save(store, 0, {"a": torch.zeros(2)})
        with pytest.raises(KeyError):
            ckpt.restore(ref, {"a": torch.zeros(2), "b": torch.zeros(2)})

    def test_int8_moments_round_trip(self, store):
        params = {"w": torch.randn(2, 8, 512), "n": torch.randn(16)}
        state = topt.init_state(params, topt.OptConfig(state_dtype="int8"))
        state["m"]["w"] = topt._quantize(torch.randn(2, 8, 512))
        ref = ckpt.save(store, 1, {"opt": state})
        back = ckpt.restore(ref, {"opt": topt.init_state(params, topt.OptConfig(state_dtype="int8"))})
        _assert_trees_equal({"opt": state}, back)


def test_local_layout_and_atomicity(tmp_path):
    ckpt.save(tmp_path, 1, _tree())
    path = ckpt.save(tmp_path, 2, _tree())
    assert path == tmp_path / "step_00000002" and (path / "manifest.json").is_file()
    assert ckpt.latest(tmp_path).name == "step_00000002"
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".tmp")]
    # a writer killed mid-publish leaves only a .tmp-* staging dir
    stale = tmp_path / ".tmp-deadbeef"
    stale.mkdir()
    (stale / "a0.bin").write_bytes(b"partial")
    assert ckpt.latest(tmp_path).name == "step_00000002"  # unpublished work is invisible
    ckpt.save(tmp_path, 3, _tree())  # the next save sweeps the garbage
    assert not list(tmp_path.glob(".tmp-*"))


@pytest.mark.parametrize("surviving_puts", [0, 1, 3])
def test_s3_kill_between_puts_leaves_step_unmarked(surviving_puts):
    store = obs.S3Store()
    ckpt.save(store, 4, _tree(1.0))
    store.fail_after_puts = surviving_puts
    with pytest.raises(obs.WriterKilled):
        ckpt.save(store, 5, _tree(2.0))
    store.fail_after_puts = None
    assert ckpt.latest(store).step == 4  # no commit marker => no step 5
    _assert_trees_equal(_tree(1.0), ckpt.restore(ckpt.latest(store), _tree()))
    with pytest.raises(NotImplementedError, match="A 8"):
        ckpt.restore_sharded(ckpt.latest(store), _tree(), None, {}, {})


def test_restore_places_leaves_on_the_like_device(tmp_path):
    ref = ckpt.save(tmp_path, 0, {"a": torch.ones(3), "b": np.arange(4, dtype=np.int32)})
    got = ckpt.restore(ref, {"a": torch.zeros(3, device="meta"), "b": np.zeros(4, np.int32)})
    assert got["a"].device.type == "meta" and got["b"].device.type == "cpu"
    assert got["b"].dtype == torch.int32


# -- across packages -----------------------------------------------------------------

def _jax_state_tree():
    rng = np.random.default_rng(0)
    params = {"blocks": {"wi": jnp.asarray(rng.normal(size=(2, 8, 512)), jnp.float32),
                         "ln1": jnp.asarray(rng.normal(size=(2, 8)), jnp.float32)},
              "embed": jnp.asarray(rng.normal(size=(32, 8)), jnp.float32)}
    state = jopt.init_state(params, jopt.OptConfig(state_dtype="int8"))
    state["m"]["blocks"]["wi"] = jopt._quantize(jnp.asarray(rng.normal(size=(2, 8, 512)),
                                                            jnp.float32))
    state["step"] = jnp.asarray(17, jnp.int32)
    return {"params": params, "opt": state, "extra": {"b": jnp.ones((6,), jnp.bfloat16) * 3}}


def _to_torch(tree):
    def conv(x):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree.map(conv, tree)


def _assert_same(jtree, ttree):
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = tp.flatten_with_path(ttree)
    assert [jtp.path_str(p) for p, _ in jl] == [tp.path_str(p) for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        a = np.asarray(a)
        b = b.view(torch.uint16).numpy().view(a.dtype) if b.dtype == torch.bfloat16 else b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend", ["local", "s3"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, backend):
    jt = _jax_state_tree()
    jstore = jobs.LocalStore(tmp_path) if backend == "local" else jobs.S3Store()
    jckpt.save(jstore, 17, jt, extra={"from": "repro"})
    if backend == "local":
        tstore = obs.LocalStore(tmp_path)
    else:  # the same objects, as a port store holds them
        tstore = obs.S3Store()
        tstore._objects = dict(jstore._objects)
    like = jax.tree.map(lambda x: x * 0, _to_torch(jt))
    got = ckpt.restore(ckpt.latest(tstore), like)
    _assert_same(jt, got)
    assert ckpt.read_manifest(ckpt.latest(tstore))["extra"] == {"from": "repro"}


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jt = _jax_state_tree()
    tt = _to_torch(jt)
    ckpt.save(tmp_path, 17, tt, extra={"from": "repro_torch"})
    like = jax.tree.map(jnp.zeros_like, jt)
    got = jckpt.restore(jckpt.latest(tmp_path), like)
    _assert_same(got, tt)
    # and the two packages write the same manifest for the same tree
    jckpt.save(tmp_path / "j", 17, jt, extra={"from": "repro_torch"})
    assert (ckpt.read_manifest(tmp_path / "step_00000017")
            == jckpt.read_manifest(tmp_path / "j" / "step_00000017"))
