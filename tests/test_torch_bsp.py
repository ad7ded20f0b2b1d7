"""The port's BSP superstep runtime (``repro_torch.core.bsp``) and
``dist/sharding.repartition_states`` against the reference, mirroring
``tests/test_bsp.py`` and the runtime half of ``tests/test_recovery.py``.

Both packages run the same supersteps over the same states: the reference on
numpy arrays (or Python floats), the port on CPU tensors made from them
(``device="cpu"``).  Runs price their measured compute at ``cpu_scale=0``,
so every modeled second is deterministic: the ``RunReport`` (every
``SuperstepReport`` field, ``init_s``, ``joined_at``, ``evicted``), the store
op log, ``Tracer.to_json()`` and the heterogeneous bill are ``==`` the
reference's, and the final states are bit-equal.  Checkpoints of tensor
states pickle host numpy copies, so the store prices them as the
reference's of the equal arrays.  Every port Tracer a test builds is audited
by the port's own tracecheck.
"""

import dataclasses
import json
import re

import numpy as np
import pytest
import torch

from repro.core import bsp as j_bsp
from repro.core import cost_model as j_cost
from repro.core import faults as j_faults
from repro.core import netsim as j_net
from repro.dist import object_store as j_store
from repro.dist import sharding as j_shard
from repro_torch import analysis as t_analysis
from repro_torch.core import bsp as t_bsp
from repro_torch.core import cost_model as t_cost
from repro_torch.core import faults as t_faults
from repro_torch.core import netsim as t_net
from repro_torch.core import trace as t_trace
from repro_torch.dataframe import Table as TTable
from repro_torch.dist import object_store as t_store
from repro_torch.dist import sharding as t_shard

J = dict(bsp=j_bsp, faults=j_faults, net=j_net, store=j_store, cost=j_cost, np=True)
T = dict(bsp=t_bsp, faults=t_faults, net=t_net, store=t_store, cost=t_cost, np=False)


@pytest.fixture(autouse=True)
def port_trace_sanitizer():
    """Audit every port Tracer the test builds with the port's tracecheck."""
    created: list = []
    t_trace.register_audit_sink(created.append)
    yield
    t_trace.unregister_audit_sink(created.append)
    violations = [v for tr in created for v in t_analysis.check_trace(tr)]
    assert violations == [], "\n".join(str(v) for v in violations[:20])


def runtime(m, world, **kw):
    kw.setdefault("cpu_scale", 0.0)
    if not m["np"]:
        kw["device"] = "cpu"
    return m["bsp"].BSPRuntime(world, **kw)


def arr(m, a):
    return np.array(a) if m["np"] else torch.from_numpy(np.array(a))


def as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def chunk_states(m, world, n=8):
    flat = np.arange(world * n, dtype=np.float64)
    return [arr(m, flat[r * n:(r + 1) * n]) for r in range(world)]


def sum_step(rank, state, comm, world):
    return float(state) + 1.0


def barrier_step(rank, state, comm, world):
    comm.barrier()
    return state * 2


def make_step(m):
    ones = arr(m, np.ones(256))

    def step(rank, state, comm, world):
        if rank == 0:
            comm.allreduce([ones] * world)
        return state * 2.0 + 1.0
    return step


def report_rows(rep):
    return dataclasses.asdict(rep)


def masked(obj):
    """``obj`` with each S3 generation id (a random uuid) in its keys masked."""
    return json.loads(re.sub(r"/[0-9a-f]{8}/", "/<gen>/", json.dumps(obj)))


def op_rows(store):
    return masked([dataclasses.astuple(op) for op in store.ops])


def trace_json(rt):
    return masked(rt.tracer.to_json())


def same_states(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, float | int) or x is None:
            assert x == y
        else:
            np.testing.assert_array_equal(as_np(x), as_np(y))
            assert as_np(x).dtype == as_np(y).dtype


# -- supersteps, failures, stragglers (test_bsp.py) ---------------------------

def _once(coords):
    left = dict.fromkeys(coords, 1)

    def injector(step, rank):
        if left.get((step, rank), 0) > 0:
            left[(step, rank)] -= 1
            return True
        return False
    return injector


SCENARIOS = {
    "basic": (4, dict(platform="LAMBDA_10GB"), [("inc", sum_step), ("dbl", barrier_step)],
              [0.0, 1.0, 2.0, 3.0], {}),
    "failure_retry": (4, {}, [("s", sum_step)], [0.0] * 4,
                      dict(fail_injector=lambda: _once([(0, 2)]))),
    "straggler": (4, dict(deadline_s=0.5), [("s", sum_step)], [0.0] * 4,
                  dict(straggle_injector=lambda: lambda s, r: 10.0 if r == 1 else 0.0)),
    "straggle_armed": (4, dict(deadline_s=0.5), [("a", sum_step), ("b", sum_step)], [0.0] * 4,
                       dict(straggle_injector=lambda: lambda s, r: {
                           (0, 1): 10.0, (0, 3): 10.0, (1, 2): 10.0}.get((s, r), 0.0))),
    "init_lambda_32": (32, dict(platform="LAMBDA_10GB"), [("s", barrier_step)], [1.0] * 32, {}),
    "init_rivanna_32": (32, dict(platform="RIVANNA_10GB"), [("s", barrier_step)], [1.0] * 32, {}),
    "hpc_provider": (4, dict(provider="hpc-slurm"), [("s", sum_step)], [0.0] * 4, {}),
    "fault_plan": (4, {}, [("a", sum_step)], [0.0] * 4,
                   dict(faults=lambda m: m["faults"].FaultPlan(
                       straggles=((0, 2, 10.0),), kills=((0, 1),), deadline_s=0.5))),
    "overlap": (4, dict(provider="aws-lambda"), [("s", barrier_step)] * 3, [1.0] * 4,
                dict(overlap=True)),
}


def run_scenario(m, name):
    world, rt_kw, steps, init, run_kw = SCENARIOS[name]
    rt_kw = dict(rt_kw)
    if "platform" in rt_kw:
        rt_kw["platform"] = getattr(m["net"], rt_kw["platform"])
    kw = {}
    for k, v in run_kw.items():
        if k == "faults":
            kw[k] = v(m)
        elif callable(v):
            kw[k] = v()
        else:
            kw[k] = v
    rt = runtime(m, world, **rt_kw)
    states, rep = rt.run(steps, list(init), **kw)
    return rt, states, rep


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_superstep_runs_equal(name):
    (jrt, js, jrep), (trt, ts, trep) = (run_scenario(m, name) for m in (J, T))
    assert ts == js
    assert report_rows(trep) == report_rows(jrep)
    assert trt.tracer.to_json() == jrt.tracer.to_json()
    assert [dataclasses.astuple(e)[1:] for e in trt.session.events] == \
        [dataclasses.astuple(e)[1:] for e in jrt.session.events]
    if name == "straggler":
        assert trep.supersteps[0].retries == 1 and trep.supersteps[0].compute_s < 5.0
    if name == "init_lambda_32":
        assert trep.init_s == pytest.approx(31.5)


def test_failure_exhausts_retries_in_both():
    for m in (J, T):
        with pytest.raises(m["bsp"].WorkerFailure):
            runtime(m, 2).run([("s", sum_step)], [0.0, 0.0],
                              fail_injector=lambda s, r: r == 0, max_retries=2)


def test_measured_compute_is_scaled_by_cpu_speed():
    """cpu_scale=1: the rank's measured work enters compute_s (CPU here; the
    card's synchronize-before-stamp test is in test_torch_cuda.py)."""
    def work(rank, state, comm, world):
        x = torch.ones(256, 256)
        for _ in range(20):
            x = x @ x / 256.0
        return state
    rt = t_bsp.BSPRuntime(2, device="cpu", cpu_scale=1.0)
    _, rep = rt.run([("w", work)], [0, 0])
    assert rep.supersteps[0].compute_s > 0.0


def test_runtime_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_bsp.BSPRuntime(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_bsp.BSPRuntime.latest_checkpoint(t_store.S3Store())


# -- checkpoints and resume ----------------------------------------------------

@pytest.mark.parametrize("backend", ["local", "s3"])
@pytest.mark.parametrize("tensors", [False, True])
def test_checkpoint_resume_equal(backend, tensors, tmp_path):
    """Resume from a superstep checkpoint (the test_bsp.py drill) in both
    packages: the same states, reports and store op logs; the port's
    checkpoints of tensors restore as tensors on the runtime's device."""
    out = []
    for m in (J, T):
        # both packages publish under the same root (the reference's moved
        # aside first): a store's list op logs its root
        root = tmp_path / "ck"
        if root.exists():
            root.rename(tmp_path / "ck_reference")
        store = m["store"].LocalStore(root) if backend == "local" else m["store"].S3Store()
        step = make_step(m) if tensors else sum_step
        init = chunk_states(m, 4) if tensors else [0.0] * 4
        steps = [("a", step), ("b", step), ("c", step)]
        full, rep = runtime(m, 4, checkpoint_dir=store, deadline_s=0.5).run(steps, init)
        kw = {} if m["np"] else {"device": "cpu"}
        latest = m["bsp"].BSPRuntime.latest_checkpoint(store, **kw)
        ckpt = m["bsp"].BSPRuntime.checkpoint_at(store, 1, **kw)
        assert latest["step"] == 2 and ckpt["step"] == 1 and ckpt["world"] == 4
        assert m["bsp"].BSPRuntime.checkpoint_at(store, 7, **kw) is None
        if tensors and not m["np"]:
            assert all(isinstance(s, torch.Tensor) and s.device.type == "cpu"
                       for s in ckpt["states"])
        delays = {(2, 0): 10.0, (2, 3): 10.0}
        resumed, rrep = runtime(m, 4, deadline_s=0.5).run(
            steps, [None] * 4, resume_from=ckpt,
            straggle_injector=lambda s, r: delays.get((s, r), 0.0))
        same_states(resumed, full)
        assert [s.retries for s in rrep.supersteps] == [2]
        out.append((full, report_rows(rep), report_rows(rrep), op_rows(store)))
    same_states(out[0][0], out[1][0])
    assert out[0][1:] == out[1][1:]


def test_elastic_resize_equal():
    def repartition(states, new_world):
        return [x for s in states for x in (s / 2, s / 2)]

    res = []
    for m in (J, T):
        store = m["store"].S3Store()
        runtime(m, 4, checkpoint_dir=store).run([("a", sum_step)], [10.0, 20.0, 30.0, 40.0])
        kw = {} if m["np"] else {"device": "cpu"}
        ckpt = m["bsp"].BSPRuntime.checkpoint_at(store, 0, **kw)
        resized = m["bsp"].resize_checkpoint(ckpt, 8, repartition)
        final, rep = runtime(m, 8).run([("a", sum_step), ("b", sum_step)], [None] * 8,
                                      resume_from=resized)
        res.append((final, report_rows(rep), op_rows(store)))
        with pytest.raises(ValueError, match="wrong number"):
            m["bsp"].resize_checkpoint(ckpt, 3, repartition)
    assert res[0] == res[1]
    assert res[1][0] == [s + 1 for s in [5.5, 5.5, 10.5, 10.5, 15.5, 15.5, 20.5, 20.5]]


def test_atomic_publish_and_stale_tmp_swept(tmp_path):
    rt = runtime(T, 2, checkpoint_dir=tmp_path)
    rt.run([("a", sum_step)], [0.0, 0.0])
    assert not list(tmp_path.glob(".tmp-*"))
    groups = list(tmp_path.glob("superstep_*"))
    assert groups and all((g / "manifest.json").exists() for g in groups)
    stale = tmp_path / ".tmp-deadbeef"
    stale.mkdir()
    (stale / "states.pkl").write_bytes(b"partial garbage")
    assert t_bsp.BSPRuntime.latest_checkpoint(tmp_path, device="cpu")["step"] == 0
    rt.run([("a", sum_step), ("b", sum_step)], [1.0, 1.0])
    assert not list(tmp_path.glob(".tmp-*"))


def test_table_states_checkpoint_by_op_kinds():
    """A state holding a port Table pickles another class path than the
    reference's Table, so the two op logs are compared by op kinds and
    counts, not bytes; the port's Table restores with tensor columns."""
    from repro.dataframe import Table as JTable

    kinds = []
    for m, make in ((J, JTable.from_dict), (T, lambda d: TTable.from_dict(d, device="cpu"))):
        store = m["store"].S3Store()
        init = [make({"k": np.arange(r, r + 4, dtype=np.int32)}) for r in range(2)]
        runtime(m, 2, checkpoint_dir=store).run([("a", lambda r, s, c, w: s)], init)
        kinds.append(sorted((op.kind, op.key.rsplit("/", 1)[-1]) for op in store.ops))
        if not m["np"]:
            ckpt = t_bsp.BSPRuntime.latest_checkpoint(store, device="cpu")
            t = ckpt["states"][1]
            assert isinstance(t, TTable) and isinstance(t.columns["k"], torch.Tensor)
            np.testing.assert_array_equal(t.to_numpy()["k"], np.arange(1, 5))
    assert kinds[0] == kinds[1]


# -- repartition_states (test_recovery.py) --------------------------------------

@pytest.mark.parametrize("world,rows,new", [(6, 4, 5), (3, 7, 2), (4, 1, 8), (5, 3, 1)])
def test_repartition_states_equal(world, rows, new):
    states = [np.arange(i * rows, i * rows + rows, dtype=np.float64) for i in range(world)]
    j = j_shard.repartition_states(states, new)
    t = t_shard.repartition_states([torch.from_numpy(s) for s in states], new)
    assert [x.shape[0] for x in t] == [x.shape[0] for x in j]
    for a, b in zip(j, t):
        np.testing.assert_array_equal(a, b.numpy())
    scalars = [np.float64(i) for i in range(world)]
    j0 = j_shard.repartition_states([np.asarray(s) for s in scalars], new)
    t0 = t_shard.repartition_states([torch.tensor(float(s), dtype=torch.float64)
                                     for s in scalars], new)
    assert [a.tolist() for a in j0] == [b.tolist() for b in t0]


def test_repartition_states_lists_and_errors():
    for m in (j_shard, t_shard):
        lists = m.repartition_states([[1, 2], [3], [4, 5]], 2)
        assert lists == j_shard.repartition_states([[1, 2], [3], [4, 5]], 2)
        assert [x for part in lists for x in part] == [1, 2, 3, 4, 5]
        with pytest.raises(TypeError, match="repartition"):
            m.repartition_states([{"a": 1}, {"b": 2}], 1)
        with pytest.raises(ValueError, match="new_world"):
            m.repartition_states([[1]], 0)


# -- the runtime escalation path (test_recovery.py) ------------------------------

@pytest.mark.parametrize("policy", ["shrink", "rebootstrap", "retry"])
@pytest.mark.parametrize("world", [4, 6, 8])
def test_rank_loss_recovery_equal(policy, world):
    """Kill -> detect -> rollback -> shrink -> repartition, priced alike; the
    final states reproduce an uninterrupted run bit for bit."""
    steps_n = 3
    res = []
    for m in (J, T):
        step = make_step(m)
        steps = [(f"s{i}", step) for i in range(steps_n)]
        clean, _ = runtime(m, world, provider="aws-lambda").run(steps, chunk_states(m, world))
        store = m["store"].S3Store()
        rt = runtime(m, world, provider="aws-lambda", checkpoint_dir=store)
        plan = m["faults"].FaultPlan(rank_losses=((1, world - 1),))
        states, rep = rt.run(steps, chunk_states(m, world), faults=plan,
                             recovery_policy=policy)
        np.testing.assert_array_equal(np.concatenate([as_np(s) for s in states]),
                                      np.concatenate([as_np(s) for s in clean]))
        cost = m["cost"].heterogeneous_run_cost(rep, rt.session)
        res.append((report_rows(rep), op_rows(store), trace_json(rt), cost,
                    [as_np(s).tolist() for s in states]))
        if policy != "retry":
            assert rep.world == world - 1 and rep.evicted == [
                {"rank": world - 1, "step": 1, "provider": "aws-lambda"}]
            assert rep.supersteps[1].rollback_s > 0.0
    assert res[0] == res[1]


def test_store_outage_and_burst_equal():
    res = []
    for m in (J, T):
        step = make_step(m)
        store = m["store"].S3Store()
        rt = runtime(m, 4, provider="aws-lambda", checkpoint_dir=store)
        shard = j_shard if m["np"] else t_shard
        burst = m["bsp"].Burst(at_step=1, new_ranks=2, provider="gcp-cloudrun",
                               repartition=shard.repartition_states)
        states, rep = rt.run([(f"s{i}", step) for i in range(3)], chunk_states(m, 4),
                             faults=m["faults"].FaultPlan(store_outages=((1, 2),)),
                             burst=burst)
        assert [op for op in store.ops if op.kind == "outage"]
        assert rep.joined_at == {4: 1, 5: 1}
        res.append((report_rows(rep), op_rows(store), trace_json(rt),
                    m["cost"].heterogeneous_run_cost(rep, rt.session)))
    assert res[0] == res[1]


@pytest.mark.parametrize("world", [2, 3, 5])
@pytest.mark.parametrize("rate", [0.0, 0.5, 1.0])
def test_detector_never_fires_on_healthy_world_equal(world, rate):
    res = []
    for m in (J, T):
        plan = m["faults"].FaultPlan(straggle_rate=rate, straggle_s=0.5, seed=3)
        rt = runtime(m, world, provider="aws-lambda")
        _, rep = rt.run([("s0", lambda r, st_, c, w: (st_ or 0) + 1)] * 2, [0] * world,
                        faults=plan, recovery_policy="shrink")
        assert rt.session.detect_time_s == 0.0 and rt.session.recovery_time_s == 0.0
        assert rep.world == world and not rep.evicted
        res.append((report_rows(rep), rt.tracer.to_json()))
    assert res[0] == res[1]


def test_rejects_unknown_recovery_policy_and_mixed_faults():
    for m in (J, T):
        rt = runtime(m, 2, provider="aws-lambda")
        with pytest.raises(ValueError, match="recovery_policy"):
            rt.run([("s0", sum_step)], [0.0, 0.0], recovery_policy="pray")
        with pytest.raises(ValueError, match="not both"):
            rt.run([("a", sum_step)], [0.0] * 2,
                   faults=m["faults"].FaultPlan.none(), fail_injector=lambda s, r: False)
        with pytest.raises(ValueError, match="one init state"):
            rt.run([("a", sum_step)], [0.0])


# -- run construction and the shared FaultPlan (test_jobs.py) -------------------

def test_runtime_construction_equal():
    """Where a run executes comes from a provider, a session or the
    deprecated ``channel_env=``, priced alike; conflicting ones raise."""
    from repro.core import session as j_sess
    from repro_torch.core import session as t_sess

    for m, sess in ((J, j_sess), (T, t_sess)):
        rt = runtime(m, 4, provider="hpc-slurm")
        assert rt.platform == m["net"].get_provider("hpc-slurm").platform
        with pytest.warns(DeprecationWarning):
            rt = runtime(m, 2, channel_env="redis")
        assert rt.comm.channel is m["net"].CHANNELS["redis"]
        s = sess.CommSession.bootstrap(4, sess.Fabric(platform=m["net"].LAMBDA_10GB))
        with pytest.raises(ValueError, match="session"):
            runtime(m, 4, session=s, channel_env="redis")
        with pytest.raises(ValueError, match="session"):
            runtime(m, 4, session=s, provider="aws-ec2")
        with pytest.raises(ValueError, match="session world"):
            runtime(m, 2, session=s)
        rt = runtime(m, 4, session=s)
        _, rep = rt.run([("s", barrier_step)], [1.0] * 4)
        m["rows"] = (report_rows(rep), rt.tracer.to_json())
    assert J.pop("rows") == T.pop("rows")


def test_fault_plan_equals_legacy_injectors_in_both():
    retries = []
    for m in (J, T):
        left = {1: 1}

        def legacy_fail(s, r, left=left):
            if left.get(r, 0) > 0 and s == 0:
                left[r] -= 1
                return True
            return False
        _, rep_a = runtime(m, 4).run([("a", sum_step)], [0.0] * 4, fail_injector=legacy_fail)
        _, rep_b = runtime(m, 4).run([("a", sum_step)], [0.0] * 4,
                                     faults=m["faults"].FaultPlan(kills=((0, 1),)))
        plan = m["faults"].FaultPlan(straggles=((0, 2, 10.0),), deadline_s=0.5)
        _, rep_c = runtime(m, 4).run([("a", lambda r, s, c, w: 1)], [0] * 4, faults=plan)
        retries.append((report_rows(rep_a), report_rows(rep_b), report_rows(rep_c)))
        assert rep_a.supersteps[0].retries == rep_b.supersteps[0].retries == 1
        assert rep_c.supersteps[0].rebootstrap_s > 0
    assert retries[0] == retries[1]
