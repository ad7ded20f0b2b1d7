"""The port's communication sessions, NAT control plane, fault plans and the
full communicator (``repro_torch.core.session`` / ``nat`` / ``faults`` /
``communicator`` / ``backends.mediated``) against the reference, mirroring
``tests/test_session.py`` and ``tests/test_communicator.py``.

Both packages build the same sessions by name and run the same calls: the
reference on numpy arrays, the port on CPU tensors made from them.  Every
modeled second, byte and event (kind, algo, relay, relayed pairs, exact
wire total), every link map, every fault draw and every lifecycle price is
``==`` the reference's; every collective's result is bit-equal (float32
folded in rank order, integers exact).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import communicator as j_comm
from repro.core import faults as j_faults
from repro.core import nat as j_nat
from repro.core import netsim as j_net
from repro.core import session as j_sess
from repro.core.backends import mediated as j_med
from repro_torch.core import communicator as t_comm
from repro_torch.core import faults as t_faults
from repro_torch.core import nat as t_nat
from repro_torch.core import netsim as t_net
from repro_torch.core import session as t_sess
from repro_torch.core.backends import mediated as t_med

J = dict(comm=j_comm, faults=j_faults, nat=j_nat, net=j_net, sess=j_sess, med=j_med)
T = dict(comm=t_comm, faults=t_faults, nat=t_nat, net=t_net, sess=t_sess, med=t_med)


def ev_rows(events):
    return [(e.kind.value, e.world, e.bytes_per_rank, e.raw_bytes, e.algo, e.wire_total,
             e.relay, e.relayed_pairs, e.time_s, e.total_bytes, e.total_raw_bytes)
            for e in events]


def link_rows(lm):
    """A LinkMap as plain values: every pair's channel and relayed flag."""
    pairs = [(a, b) for a in range(lm.world) for b in range(a + 1, lm.world)]
    return (lm.world, dataclasses.astuple(lm.direct), dataclasses.astuple(lm.fallback),
            lm.all_direct, lm.relayed_pairs(), lm.override_pairs(),
            [(p, dataclasses.astuple(lm.link(*p).channel), lm.link(*p).relayed) for p in pairs])


def session_rows(s):
    server = None
    if s.server is not None:
        server = (s.server.expected_world, s.server._counter, s.server.cleared,
                  sorted((r, m.internal, m.external) for r, m in s.server._nat_table.items()))
    return (s.world, ev_rows(s.events), link_rows(s.link_map), s.rank_providers, s.evicted,
            server, s.bootstrap_time_s, s.rebootstrap_time_s, s.expand_time_s,
            s.shrink_time_s, s.detect_time_s, s.recovery_time_s)


# -- the NAT control plane ------------------------------------------------------

@pytest.mark.parametrize("world", [1, 2, 3, 5, 8, 16, 33, 64])
def test_nat_schedule_and_punch_equal(world):
    assert t_nat.connection_schedule(world) == j_nat.connection_schedule(world)
    for fail_prob in (0.0, 0.2):
        ts, js = t_nat.RendezvousServer(world), j_nat.RendezvousServer(world)
        assert t_nat.punch_all(ts, world, fail_prob=fail_prob, max_retries=8, seed=world) == \
            j_nat.punch_all(js, world, fail_prob=fail_prob, max_retries=8, seed=world)
        assert [ts.peer_address(r) for r in range(world)] == \
            [js.peer_address(r) for r in range(world)]


def test_nat_server_lifecycle_equal():
    for m in (t_nat, j_nat):
        s = m.RendezvousServer(4)
        assert [s.assign_rank(f"10.0.0.{i}") for i in range(4)] == [0, 1, 2, 3]
        with pytest.raises(m.StaleMetadataError):
            s.assign_rank("10.0.0.9")
        with pytest.raises(m.StaleMetadataError):
            s.assign_rank("10.0.0.9")
        s.clear()
        for i in range(4):
            s.assign_rank(f"10.0.0.{i}")
        s.grow(2)
        s.assign_rank("10.0.0.4")
        assert s.shrink([1, 3]) == {0: 0, 2: 1, 4: 2}
        assert s.reassign_rank(1, "10.9.9.9") == "54.0.0.1:50001"
        assert [s.acquire_ordered(r) for r in (1, 0, 1, 2)] == [False, True, True, True]
        with pytest.raises(ValueError):
            s.shrink([0, 1, 2])


# -- fault plans: the same seeded draws ------------------------------------------

FAULT_PLANS = [
    dict(kill_rate=0.2, straggle_rate=0.3, straggle_s=1.5, seed=7),
    dict(kills=((0, 3), (2, 1, 2)), straggles=((1, 2, 0.5),), deadline_s=9.0, seed=1),
    dict(flap_rate=0.05, store_outage_rate=0.2, rendezvous_outage_rate=0.1, seed=11,
         link_flaps=((3, 0, 1), (4, 2, 5, "permanent")), store_outages=((5, 8),),
         rendezvous_outages=((1, 2),), rank_losses=((6, 4),), outage_retries=4,
         outage_backoff_s=0.25),
]


@pytest.mark.parametrize("plan", range(len(FAULT_PLANS)))
def test_fault_draws_equal(plan):
    tp, jp = t_faults.FaultPlan(**FAULT_PLANS[plan]), j_faults.FaultPlan(**FAULT_PLANS[plan])
    assert (tp.any_faults, tp.any_infra_faults, tp.outage_penalty_s) == \
        (jp.any_faults, jp.any_infra_faults, jp.outage_penalty_s)
    ta, ja = tp.armed(), jp.armed()
    draws = {"t": [], "j": []}
    for key, a in (("t", ta), ("j", ja)):
        for step in range(12):
            row = [a.link_flaps_at(step, 8), a.store_outage(step), a.rendezvous_outage(step),
                   a.outage_penalty_s("store", step), a.outage_penalty_s("rendezvous", step)]
            for rank in range(8):
                row += [a.fail(step, rank), a.extra_delay(step, rank), a.rank_loss(step, rank)]
            draws[key].append(row)
        draws[key].append((a.kills_fired, a.straggles_fired, a.outages_fired, a.fired()))
    assert draws["t"] == draws["j"]
    assert any(any(x is True for x in row) for row in draws["t"][:-1])
    legacy = [t_faults.FaultPlan.from_injectors(lambda s, r: r == s, lambda s, r: 0.25 * r),
              j_faults.FaultPlan.from_injectors(lambda s, r: r == s, lambda s, r: 0.25 * r)]
    got = [[(a.fail(s, r), a.extra_delay(s, r)) for s in range(3) for r in range(3)]
           for a in (p.armed() for p in legacy)]
    assert got[0] == got[1]
    for m in (t_faults, j_faults):
        with pytest.raises(ValueError, match="half-open"):
            m.FaultPlan(store_outages=((3, 3),))


# -- bootstrap -----------------------------------------------------------------

FABRIC_NAMES = ["lambda", "lambda-6gb", "ec2", "hpc", "redis", "s3", "gcp-cloudrun",
                "hpc-slurm", "aws-ec2"]


@pytest.mark.parametrize("world", [1, 2, 3, 8, 16, 32, 64])
def test_bootstrap_by_fabric_name_equal(world):
    for name in FABRIC_NAMES:
        assert session_rows(t_sess.CommSession.bootstrap(world, name)) == \
            session_rows(j_sess.CommSession.bootstrap(world, name)), name
    assert sorted(t_sess.FABRICS) == sorted(j_sess.FABRICS)
    for name in j_sess.FABRICS:
        assert dataclasses.astuple(t_sess.FABRICS[name]) == dataclasses.astuple(j_sess.FABRICS[name])


def _fabric(m, **kw):
    net = m["net"]
    if "platform" in kw:
        kw["platform"] = net.resolve_platform(kw["platform"])
    if "relay" in kw:
        kw["relay"] = net.resolve_channel(kw["relay"])
    return m["sess"].Fabric(**kw)


FABRICS = [
    dict(blocked_pairs=frozenset({(0, 5), (2, 3), (6, 1)})),
    dict(blocked_ranks=frozenset({4}), relay="s3"),
    dict(punch_fail_prob=0.3, max_retries=5, seed=3),
    dict(blocked_rate=0.25, seed=9, platform="ec2-15gb-4vcpu"),
    dict(blocked_pairs=frozenset({(1, 2)}), blocked_rate=0.1, punch_fail_prob=0.1, seed=4,
         platform="rivanna-10gb"),
]


@pytest.mark.parametrize("world", [8, 16, 64])
@pytest.mark.parametrize("fabric", range(len(FABRICS)))
def test_bootstrap_scenarios_equal(fabric, world):
    ts = t_sess.CommSession.bootstrap(world, _fabric(T, **FABRICS[fabric]))
    js = j_sess.CommSession.bootstrap(world, _fabric(J, **FABRICS[fabric]))
    assert session_rows(ts) == session_rows(js)
    assert ts.full_rebootstrap_time_s() == js.full_rebootstrap_time_s()
    assert ts.rebootstrap_rank(world - 1) == js.rebootstrap_rank(world - 1)
    assert ts.rebootstrap_rank(0) == js.rebootstrap_rank(0)
    assert session_rows(ts) == session_rows(js)


def test_bootstrap_errors_and_implicit_sessions():
    for m in (T, J):
        with pytest.raises(ValueError, match="invalid for world"):
            m["sess"].CommSession.bootstrap(4, _fabric(m, blocked_pairs=frozenset({(0, 9)})))
        with pytest.raises(m["nat"].StaleMetadataError):
            srv = m["nat"].RendezvousServer(4)
            m["sess"].CommSession.bootstrap(4, "lambda", server=srv)
            m["sess"].CommSession.bootstrap(4, "lambda", server=srv)
        implicit = m["sess"].CommSession.all_direct(8)
        assert implicit.rebootstrap_rank(3) == 0.0 and implicit.events == []
        with pytest.raises(ValueError, match="relay channel must be staged"):
            m["sess"].hybrid_session(4, [(0, 1)], relay="direct")


# -- the session lifecycle ---------------------------------------------------------

def _lifecycle(m, world, policy, faults):
    """Bootstrap, expand (same- and cross-provider), detect + shrink, link
    recovery and re-bootstrap, each step's return value and state."""
    sess = m["sess"]
    s = sess.CommSession.bootstrap(world, "lambda")
    out = []
    if faults:
        s.arm_faults(m["faults"].FaultPlan(store_outages=((2, 4),),
                                           rendezvous_outages=((1, 3),)).armed(), step=0)
    out.append(s.expand(4))
    s.set_fault_step(1)
    out.append(s.expand(world // 2, provider="gcp-cloudrun"))
    out.append(s.full_rebootstrap_time_s())
    s.set_fault_step(2)
    out.append(s.store_outage_penalty_s())
    dead = list(range(s.world - 3, s.world))
    out.append(s.detect_failure("_".join(f"r{r}" for r in dead)))
    out.append(s.shrink(dead, policy=policy))
    out.append(s.recover_link(0, 1))
    out.append(s.recover_link(2, s.world - 1, permanent=True))
    out.append(s.recover_link(2, s.world - 1))
    s.set_fault_step(3)
    out.append(s.rebootstrap_rank(1))
    out.append(s.shrink([0], policy=policy))
    out.append(s.full_rebootstrap_time_s())
    out.append(session_rows(s))
    s.reset_events(keep_bootstrap=True)
    out.append(ev_rows(s.events))
    return out


@pytest.mark.parametrize("faults", [False, True])
@pytest.mark.parametrize("policy", ["incremental", "cold"])
@pytest.mark.parametrize("world", [2, 8, 64])
def test_lifecycle_equal(world, policy, faults):
    assert _lifecycle(T, world, policy, faults) == _lifecycle(J, world, policy, faults)


def _chip_lifecycle(m, policy):
    """The world-64 lifecycle ``chip_smoke.py`` prints (phase 3b)."""
    s = m["sess"].CommSession.bootstrap(64, "lambda")
    row = [s.bootstrap_time_s, s.expand(16, provider="gcp-cloudrun"), s.world,
           s.full_rebootstrap_time_s()]
    dead = list(range(s.world - 8, s.world))
    row += [s.detect_failure("_".join(f"r{r}" for r in dead)), s.shrink(dead, policy=policy),
            s.world, s.recover_link(0, 1), s.recover_link(2, 3, permanent=True),
            s.rebootstrap_rank(0), s.full_rebootstrap_time_s(), ev_rows(s.events)]
    return row


@pytest.mark.parametrize("policy", ["incremental", "cold"])
def test_chip_smoke_lifecycle_equal(policy):
    assert _chip_lifecycle(T, policy) == _chip_lifecycle(J, policy)


# -- collectives over every topology --------------------------------------------------

def _topology(m, name, world):
    """(communicator, label) for one link topology, built alike in both packages."""
    sess, net, comm = m["sess"], m["net"], m["comm"]
    pairs = [(a, b) for a in range(world) for b in range(a + 1, world)]
    if name == "implicit":
        return comm.Communicator(world)
    if name == "fixed_ec2":
        return comm.Communicator(world, net.EC2_DIRECT, algorithm="fixed")
    if name == "provider_ec2":
        return comm.make_communicator(world, provider="aws-ec2")
    if name in ("redis", "s3"):
        return getattr(m["med"], f"{name}_communicator")(world)
    if name == "hybrid":
        return m["med"].hybrid_communicator(world, pairs[1::3])
    if name == "hybrid_fixed":
        s = sess.hybrid_session(world, pairs[::4], relay="s3")
        return s.communicator(algorithm="fixed")
    if name == "blocked_rank":
        return sess.hybrid_session(world, (), relay="s3", blocked_ranks=(world - 1,)).communicator()
    if name == "fully_relayed":
        return sess.hybrid_session(world, pairs, relay="redis").communicator()
    if name == "cross_provider":
        s = sess.CommSession.bootstrap(world, "lambda")
        s.expand(3, provider="gcp-cloudrun")
        return s.communicator()
    if name == "degraded":
        s = sess.CommSession.bootstrap(world, "lambda")
        c = s.communicator()
        s.recover_link(0, world - 1, permanent=True)
        c.refresh_links()
        return c
    if name == "outage":
        s = sess.hybrid_session(world, pairs[:2], relay="redis")
        s.arm_faults(m["faults"].FaultPlan(store_outages=((0, 2),)).armed(), step=1)
        return s.communicator()
    raise ValueError(name)


TOPOLOGIES = ["implicit", "fixed_ec2", "provider_ec2", "redis", "s3", "hybrid", "hybrid_fixed",
              "blocked_rank", "fully_relayed", "cross_provider", "degraded", "outage"]


def _data(world, seed):
    rng = np.random.default_rng(seed)
    return {
        "f32": [rng.normal(size=(world * 3, 5)).astype(np.float32) for _ in range(world)],
        "i32": [rng.integers(-9, 9, size=(world * 2,)).astype(np.int32) for _ in range(world)],
        "i64": [rng.integers(-2**40, 2**40, size=(world,)).astype(np.int64) for _ in range(world)],
        "ragged": [rng.normal(size=(int(rng.integers(0, 6)), 2)).astype(np.float32)
                   for _ in range(world)],
        "empty": [np.zeros((0, 3), np.float64) for _ in range(world)],
        "sends": [[rng.normal(size=(int(rng.integers(0, 5)), 3)) for _ in range(world)]
                  for _ in range(world)],
        "eq": [[rng.integers(0, 9, 4).astype(np.int32) for _ in range(world)]
               for _ in range(world)],
    }


def _drive(comm, data, torch_side):
    """Every collective of the communicator, in one order; returns results."""
    w = comm.world_size
    if torch_side:
        conv = lambda v: [conv(x) for x in v] if isinstance(v, list) else torch.from_numpy(v)  # noqa: E731
        data = {k: conv(v) for k, v in data.items()}
        add, mx = torch.add, torch.maximum
    else:
        add, mx = np.add, np.maximum
    f, i32, i64 = data["f32"], data["i32"], data["i64"]
    out = [
        comm.allreduce(f), comm.allreduce(f, op=mx, algorithm="fixed"), comm.allreduce(i32),
        comm.allreduce(i64, op=add), comm.reduce_scatter(f), comm.reduce_scatter(i32, op=mx),
        comm.allgather(f), comm.allgatherv(data["ragged"]), comm.allgatherv(data["empty"]),
        comm.alltoall(data["eq"]), comm.alltoallv(data["sends"]),
        comm.bcast(f[w - 1], root=w - 1), comm.gather(i32, root=w // 2),
        comm.scatter(f, root=0), comm.send(i64[0], dst=w - 1), comm.send(f[1], dst=0),
        comm.ping(w - 1), comm.barrier(), comm.barrier(algorithm="fixed"),
    ]
    handles = [comm.iallreduce(f, mx), comm.iallgather(i32), comm.iallgatherv(data["ragged"]),
               comm.ialltoallv(data["sends"])]
    out.append(comm.outstanding_handles)
    out += [comm.wait(h) for h in reversed(handles)]
    out.append(comm.outstanding_handles)
    return out


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return ("array", str(x.numpy().dtype), x.shape and tuple(x.shape), x.numpy().tobytes())
    if isinstance(x, np.ndarray):
        return ("array", str(x.dtype), x.shape and tuple(x.shape), x.tobytes())
    if isinstance(x, (list, tuple)):
        return [_as_np(v) for v in x]
    return x


def _accounting(comm):
    evs = [e for e in comm.events if e.kind.value not in ("bootstrap", "detect")]
    return (ev_rows(comm.events), comm.comm_time_s, comm.bytes_on_wire, comm.raw_bytes_on_wire,
            [comm.event_lat_bw(e) for e in comm.events],
            [comm.collective_time_s(k, n) for k in ("allreduce", "alltoallv", "barrier", "bcast")
             for n in (0, 4096, 1 << 20)],
            comm.session.bootstrap_time_s, len(evs))


@pytest.mark.parametrize("world", [2, 3, 8])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_collectives_equal_on_every_topology(topology, world):
    tc, jc = _topology(T, topology, world), _topology(J, topology, world)
    data = _data(tc.world_size, seed=world)
    got, exp = _drive(tc, data, True), _drive(jc, data, False)
    assert _as_np(got) == _as_np(exp)
    assert _accounting(tc) == _accounting(jc)
    # each rank gets its own copy
    res = tc.allreduce([torch.ones(3) for _ in range(tc.world_size)])
    assert len({r.data_ptr() for r in res}) == tc.world_size
    tc.reset_events()
    jc.reset_events()
    assert ev_rows(tc.events) == ev_rows(jc.events)


def test_communicator_errors_equal():
    for m, arr in ((T, torch.ones), (J, np.ones)):
        c = m["comm"].Communicator(4)
        with pytest.raises(ValueError, match="need world_size or session"):
            m["comm"].Communicator()
        with pytest.raises(ValueError, match="divisible by world"):
            c.reduce_scatter([arr(6) for _ in range(4)])
        with pytest.raises(ValueError, match="equal shapes"):
            c.allgather([arr(i + 1) for i in range(4)])
        with pytest.raises(ValueError, match="out of range"):
            c.bcast(arr(2), root=4)
        with pytest.raises(ValueError, match="already-waited"):
            h = c.iallgather([arr(1) for _ in range(4)])
            c.wait(h)
            c.wait(h)
        with pytest.raises(ValueError, match="group size"):
            m["comm"].Communicator(3, session=m["sess"].CommSession.all_direct(4))
        with pytest.raises(ValueError, match="duplicate"):
            m["comm"].Communicator(session=m["sess"].CommSession.all_direct(4), group=(0, 0))
        with pytest.raises(ValueError, match="not in group"):
            c.split([0, 0, 1, 1])[2].local_rank(0)
    for m in (T, J):
        with pytest.raises(ValueError, match="full P x P"):
            m["comm"].Communicator(2).compressed_alltoallv([[None] * 2, [None]])
        with pytest.raises(ValueError, match="one entry per rank"):
            m["comm"].Communicator(2).compressed_alltoallv([[None] * 2])


@pytest.mark.parametrize("world", [4, 8, 9])
@pytest.mark.parametrize("topology", ["implicit", "hybrid", "cross_provider"])
def test_split_equal(topology, world):
    """MPI comm_split: the same groups, shared log and link views, the same
    results and prices in nested splits (the dp x mp mesh)."""
    rng = np.random.default_rng(world)
    colors = [None if r == 1 else int(c) for r, c in enumerate(rng.integers(0, 3, world))]
    keys = [int(k) for k in rng.integers(0, 4, world)]
    logs = []
    for m, torch_side in ((T, True), (J, False)):
        c = _topology(m, topology, world)
        size = c.world_size  # an expanded session holds more ranks
        colors = colors + [0] * (size - len(colors))
        keys = keys + [0] * (size - len(keys))
        data = [np.random.default_rng(r).normal(size=(6,)).astype(np.float32)
                for r in range(size)]
        subs = c.split(colors, keys)
        rows = []
        for r, sub in enumerate(subs):
            if sub is None:
                rows.append(None)
                continue
            xs = [torch.from_numpy(data[g]) if torch_side else data[g] for g in sub.group]
            res = sub.allreduce(xs)
            rows.append((sub.group, sub.local_rank(sub.group[-1]), _as_np(res[0]),
                         (sub._links.relayed and len(sub._links.relayed)), sub.world_size))
        mesh = c.split([r % 2 for r in range(size)])[0]
        inner = mesh.split([r // 2 for r in range(mesh.world_size)])
        rows.append([sub.group for sub in inner])
        inner[0].barrier()
        logs.append((rows, ev_rows(c.events)))
    assert logs[0] == logs[1]
