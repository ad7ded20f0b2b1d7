"""The port's own copies of the pricing code (``repro_torch.core``) against
the reference (``repro.core``): constants, modeled seconds and schedule
choices must be exactly equal (``==``, no tolerance), and the communicator
must log the same events for the same blocks."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.core import algorithms as j_alg
from repro.core import communicator as j_comm
from repro.core import netsim as j_net
from repro_torch.core import algorithms as t_alg
from repro_torch.core import communicator as t_comm
from repro_torch.core import netsim as t_net

CHANNEL_NAMES = ["direct", "ec2-direct", "hpc-direct", "redis", "s3"]
WORLDS = [2, 4, 8, 16, 32, 64]
NBYTES = [0, 1024, 1 << 20, 64 << 20]
KINDS = sorted(j_alg._KIND_CLASS)


def channels(name):
    return j_net.resolve_channel(name), t_net.resolve_channel(name)


def test_channel_constants_equal():
    for const in ("LAMBDA_DIRECT", "EC2_DIRECT", "HPC_DIRECT", "REDIS_STAGED", "S3_STAGED"):
        assert dataclasses.astuple(getattr(t_net, const)) == dataclasses.astuple(getattr(j_net, const))
    assert sorted(t_net.CHANNELS) == sorted(j_net.CHANNELS) == sorted(CHANNEL_NAMES)
    for name in CHANNEL_NAMES:
        j, t = channels(name)
        assert dataclasses.astuple(t) == dataclasses.astuple(j)
        for nbytes in NBYTES:
            assert t.point_to_point_time(nbytes) == j.point_to_point_time(nbytes)
    assert t_alg._KIND_CLASS == j_alg._KIND_CLASS
    assert t_alg.CHUNK_CANDIDATES == j_alg.CHUNK_CANDIDATES
    assert {k: sorted(v) for k, v in t_alg._DIRECT_COSTS.items()} == \
        {k: sorted(v) for k, v in j_alg._DIRECT_COSTS.items()}
    with pytest.raises(ValueError, match="unknown channel"):
        t_net.resolve_channel("carrier-pigeon")


@pytest.mark.parametrize("world", [1] + WORLDS)
@pytest.mark.parametrize("name", CHANNEL_NAMES)
def test_pricing_equal(name, world):
    j, t = channels(name)
    for kind in KINDS:
        assert t_alg.algorithms_for(t, kind) == j_alg.algorithms_for(j, kind)
        for nbytes in NBYTES:
            for algo in (None, "fixed", "auto", *j_alg.algorithms_for(j, kind)):
                assert t_net.collective_time(t, kind, world, nbytes, algo) == \
                    j_net.collective_time(j, kind, world, nbytes, algo), (kind, nbytes, algo)
            for algo in j_alg.algorithms_for(j, kind):
                assert t_alg.algorithm_time(t, kind, world, nbytes, algo) == \
                    j_alg.algorithm_time(j, kind, world, nbytes, algo)
            tc = t_alg.select_algorithm(kind, world, nbytes, t, cache=None)
            jc = j_alg.select_algorithm(kind, world, nbytes, j, cache=None)
            assert (tc.algorithm, tc.time_s, tc.chunks) == (jc.algorithm, jc.time_s, jc.chunks)
            assert t_alg.tuned_time(t, kind, world, nbytes) == j_alg.tuned_time(j, kind, world, nbytes)


def test_unknown_schedules_raise():
    j, t = channels("direct")
    with pytest.raises(ValueError, match="unknown algorithm"):
        t_alg.algorithm_time(t, "alltoall", 4, 10, "ring")
    js, ts = channels("s3")
    with pytest.raises(ValueError, match="unknown staged algorithm"):
        t_alg.algorithm_time(ts, "barrier", 4, 0, "staged_chunked")
    with pytest.raises(ValueError, match="unknown collective kind"):
        t_net.collective_time(t, "gossip", 4, 10)


def test_decision_cache_memoizes_exact_sizes():
    cache = t_alg.DecisionCache(max_entries=2)
    ch = t_net.LAMBDA_DIRECT
    first = t_alg.select_algorithm("alltoallv", 8, 4096, ch, cache=cache)
    again = t_alg.select_algorithm("alltoallv", 8, 4096, ch, cache=cache)
    assert first == again and (cache.hits, cache.misses, len(cache)) == (1, 1, 1)
    t_alg.select_algorithm("alltoallv", 8, 4097, ch, cache=cache)
    t_alg.select_algorithm("alltoallv", 8, 4098, ch, cache=cache)  # past max: self-clears
    assert len(cache) == 1
    cache.clear()
    assert (cache.hits, cache.misses, len(cache)) == (0, 0, 0)
    assert t_alg.select_algorithm("barrier", 1, 0, ch) == t_alg.Choice("none", 0.0)


def _event_log(events):
    return [(e.kind.value, e.world, e.bytes_per_rank, e.raw_bytes, e.algo, e.time_s) for e in events]


@pytest.mark.parametrize("algorithm", ["auto", "fixed", None])
@pytest.mark.parametrize("name", ["direct", "redis", "s3"])
@pytest.mark.parametrize("world", [1, 3, 8])
def test_communicator_logs_the_same_events(world, name, algorithm):
    rng = np.random.default_rng(world)
    sends = [[rng.normal(size=(int(rng.integers(0, 40)), 3)) for _ in range(world)]
             for _ in range(world)]
    jc = j_comm.make_communicator(world, name)
    tc = t_comm.make_communicator(world, name)
    j_recv, j_counts = jc.alltoallv(sends, algorithm=algorithm)
    t_recv, t_counts = tc.alltoallv([[torch.from_numpy(b) for b in row] for row in sends],
                                    algorithm=algorithm)
    np.testing.assert_array_equal(t_counts.numpy(), j_counts)
    for dst in range(world):
        for src in range(world):
            np.testing.assert_array_equal(t_recv[dst][src].numpy(), j_recv[dst][src])
    eq = [[rng.integers(0, 9, 5).astype(np.int32) for _ in range(world)] for _ in range(world)]
    j_eq = jc.alltoall(eq, algorithm=algorithm)
    t_eq = tc.alltoall([[torch.from_numpy(b) for b in row] for row in eq], algorithm=algorithm)
    assert all(np.array_equal(t_eq[d][s].numpy(), j_eq[d][s]) for d in range(world) for s in range(world))
    jc.barrier(algorithm=algorithm)
    tc.barrier(algorithm=algorithm)
    assert _event_log(tc.events) == _event_log(jc.events)
    assert tc.comm_time_s == jc.comm_time_s
    assert tc.bytes_on_wire == jc.bytes_on_wire
    assert tc.raw_bytes_on_wire == jc.raw_bytes_on_wire
    tc.reset_events()
    assert tc.events == [] and tc.comm_time_s == 0.0


def test_communicator_named_schedule_and_errors():
    jc = j_comm.Communicator(4, j_net.HPC_DIRECT, algorithm="bruck")
    tc = t_comm.Communicator(4, t_net.HPC_DIRECT, algorithm="bruck")
    blocks = [[np.ones((2, 2)) for _ in range(4)] for _ in range(4)]
    jc.alltoallv(blocks)
    tc.alltoallv([[torch.from_numpy(b) for b in row] for row in blocks])
    assert _event_log(tc.events) == _event_log(jc.events)
    assert t_comm.Communicator(2).channel == t_net.LAMBDA_DIRECT
    with pytest.raises(ValueError):
        t_comm.Communicator(0)
    with pytest.raises(ValueError, match="one entry per rank"):
        tc.alltoallv([[torch.ones(1)] * 4] * 3)
    with pytest.raises(ValueError, match="full P x P"):
        tc.alltoall([[torch.ones(1)] * 3] * 4)
    with pytest.raises(ValueError, match="unknown channel"):
        t_comm.make_communicator(4, "pigeon")


# ---------------------------------------------------------------------------
# hybrid (per-pair) link pricing, and the full communicator on tensors
# ---------------------------------------------------------------------------

def _links(net, alg, world, fraction, relay, rank_blocked=False, override=False):
    """The same GroupLinks in either package: ``fraction`` of the pairs relay
    through ``relay`` (drawn as benchmarks/hybrid_links.py draws them)."""
    pairs = [(a, b) for a in range(world) for b in range(a + 1, world)]
    k = max(1, int(round(fraction * len(pairs)))) if fraction else 0
    order = np.random.default_rng(world).permutation(len(pairs))
    relayed = sorted(pairs[i] for i in order[:k])
    if rank_blocked:
        relayed = sorted(set(relayed) | {p for p in pairs if world - 1 in p})
    ch = net.resolve_channel(relay)
    pair_direct = ()
    if override:
        pair_direct = tuple((a, b, net.EC2_DIRECT) for a, b in pairs
                            if (a, b) not in relayed and a >= world // 2)
    return alg.GroupLinks(world=world, direct=net.LAMBDA_DIRECT,
                          relayed=tuple((a, b, ch) for a, b in relayed),
                          fallback=net.REDIS_STAGED, pair_direct=pair_direct)


HYBRID_CASES = [(0.0, "redis", False, False), (1 / 16, "redis", False, False),
                (0.25, "s3", False, False), (0.25, "redis", False, True),
                (1.0, "s3", False, False), (0.0, "redis", True, False)]


@pytest.mark.parametrize("case", range(len(HYBRID_CASES)))
@pytest.mark.parametrize("world", [2, 3, 8, 16, 64])
def test_hybrid_pricing_equal(world, case):
    fraction, relay, rank_blocked, override = HYBRID_CASES[case]
    jl = _links(j_net, j_alg, world, fraction, relay, rank_blocked, override)
    tl = _links(t_net, t_alg, world, fraction, relay, rank_blocked, override)
    assert dataclasses.astuple(tl) == dataclasses.astuple(jl)
    assert (tl.all_direct, tl.fully_relayed, tl.relay_names) == \
        (jl.all_direct, jl.fully_relayed, jl.relay_names)
    for kind in KINDS:
        for nbytes in (0, 4096, 1 << 20):
            tc = t_alg.select_hybrid(kind, world, nbytes, tl, use_cache=False)
            jc = j_alg.select_hybrid(kind, world, nbytes, jl, use_cache=False)
            assert (tc.algorithm, tc.time_s, tc.chunks) == (jc.algorithm, jc.time_s, jc.chunks)
            klass = j_alg._KIND_CLASS[kind]
            for name in j_alg._HYBRID_STRUCTURE[klass]:
                assert t_alg.hybrid_algorithm_time(tl, kind, nbytes, name) == \
                    j_alg.hybrid_algorithm_time(jl, kind, nbytes, name), (kind, name)
    with pytest.raises(ValueError, match="links built for world"):
        t_alg.select_hybrid("allreduce", world + 1, 8, tl)


def test_hybrid_structure_and_cache_equal():
    assert t_alg.FIXED_SHAPES == j_alg.FIXED_SHAPES
    assert t_alg._HYBRID_CACHE_MAX == j_alg._HYBRID_CACHE_MAX
    assert {k: sorted(v) for k, v in t_alg._HYBRID_STRUCTURE.items()} == \
        {k: sorted(v) for k, v in j_alg._HYBRID_STRUCTURE.items()}
    for kind in KINDS:
        assert t_alg.fixed_shape(kind) == j_alg.fixed_shape(kind)
    shapes = {s for v in j_alg._HYBRID_STRUCTURE.values() for s, _, _ in v.values()}
    for shape in sorted(shapes):
        for world in (2, 5, 8, 13):
            r = max(1, math.ceil(math.log2(world)))
            for idx in range(2 * world):
                assert t_alg._round_pairs(shape, idx, world, r) == \
                    j_alg._round_pairs(shape, idx, world, r)
    # the bounded cache: a full cache clears itself; a cached answer is the
    # uncached one (fresh inputs, whatever other tests left in the cache)
    tl = _links(t_net, t_alg, 8, 0.25, "redis")
    first = t_alg.select_hybrid("allreduce", 8, 12345, tl)
    assert t_alg.select_hybrid("allreduce", 8, 12345, tl) is first
    assert first == t_alg.select_hybrid("allreduce", 8, 12345, tl, use_cache=False)
    assert len(t_alg._HYBRID_CACHE) <= t_alg._HYBRID_CACHE_MAX
    with pytest.raises(ValueError, match="unknown hybrid algorithm"):
        t_alg.hybrid_algorithm_time(tl, "allreduce", 8, "bruck")


def _all_collectives(comm, xs, ops):
    w = comm.world_size
    add, mx = ops
    return [comm.allreduce(xs), comm.allreduce(xs, op=mx), comm.reduce_scatter(xs),
            comm.allgather(xs), comm.allgatherv([x[: i % 3] for i, x in enumerate(xs)]),
            comm.bcast(xs[0]), comm.gather(xs, root=w - 1), comm.scatter(xs, root=w // 2),
            comm.send(xs[0], dst=w - 1), comm.ping(0),
            comm.wait(comm.iallreduce(xs, add)), comm.wait(comm.iallgather(xs)),
            comm.wait(comm.iallgatherv(xs)),
            comm.wait(comm.ialltoallv([[x[:d] for d in range(w)] for x in xs]))[0]]


def _np_view(x):
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return [_np_view(v) for v in x]
    return x


@pytest.mark.parametrize("dtype", ["float32", "int32", "int64", "float64"])
@pytest.mark.parametrize("name", CHANNEL_NAMES)
@pytest.mark.parametrize("world", [2, 16, 64])
def test_collectives_on_tensors_equal(world, name, dtype):
    """Every collective on CPU tensors against the reference on numpy:
    floats bit-equal (rank-order fold), integers exact, events ``==``."""
    rng = np.random.default_rng(world)
    xs = [(rng.normal(size=(world, 3)) * 100).astype(dtype) for _ in range(world)]
    jc, tc = j_comm.make_communicator(world, name), t_comm.make_communicator(world, name)
    got = _all_collectives(tc, [torch.from_numpy(x) for x in xs], (torch.add, torch.maximum))
    exp = _all_collectives(jc, xs, (np.add, np.maximum))
    assert _np_view(got) == _np_view(exp)
    assert _event_log(tc.events) == _event_log(jc.events)
    assert [(e.wire_total, e.relay, e.relayed_pairs, e.total_bytes) for e in tc.events] == \
        [(e.wire_total, e.relay, e.relayed_pairs, e.total_bytes) for e in jc.events]
    assert (tc.comm_time_s, tc.bytes_on_wire, tc.raw_bytes_on_wire) == \
        (jc.comm_time_s, jc.bytes_on_wire, jc.raw_bytes_on_wire)


def test_allgatherv_all_empty_and_provider_factory():
    tc = t_comm.Communicator(3)
    out = tc.allgatherv([torch.zeros((0, 2), dtype=torch.int16) for _ in range(3)])
    assert all(o.shape == (0, 2) and o.dtype == torch.int16 for o in out)
    for prov in ("aws-lambda", "aws-ec2", "gcp-cloudrun", "hpc-slurm"):
        t = t_comm.make_communicator(8, provider=prov)
        j = j_comm.make_communicator(8, provider=prov)
        assert dataclasses.astuple(t.channel) == dataclasses.astuple(j.channel)
        t.barrier()
        j.barrier()
        assert _event_log(t.events) == _event_log(j.events)
