"""Collective algorithm engine: per-algorithm cost schedules + tuned selection
— the port's own copy of ``repro.core.algorithms`` (every formula verbatim,
in the same order of operations, so the modeled seconds are equal).

``netsim.collective_time`` keeps the *calibrated* one-schedule-per-kind model
(what the paper's FMI actually ran: binomial trees, pairwise exchange,
monolithic PUT/GET staging — Figs 12/13 are measured on those).  This module
models what a *tuned* MPI-style implementation chooses per message size, the
same decision procedure mainstream MPI implementations (and FMI's MPI
lineage) apply: evaluate every candidate schedule under the channel's
alpha-beta model and take the argmin.

Direct channels (``alpha_eff = alpha * (1 + P/64)`` fan-in congestion, as
calibrated in netsim; ``r = ceil(log2 P)``; ``n`` = bytes per rank):

    kind            algorithm           modeled time
    --------------  ------------------  -----------------------------------
    allreduce       flat                2(P-1)(a + nB)      (serial at root)
                    binomial_tree       2r(a + nB)          (full payload/hop)
                    ring                2(P-1)a + 2((P-1)/P) nB
                    recursive_doubling  r(a + nB)
                    rabenseifner        2ra + 2((P-1)/P) nB (RS + AG)
    reduce_scatter  flat                (P-1)(a + nB)
                    binomial_tree       r(a + nB)
                    ring                (P-1)a + ((P-1)/P) nB
                    recursive_halving   ra + ((P-1)/P) nB
    allgather(v)    flat                (P-1)a + (P-1) nB   (serial at root)
                    ring                (P-1)a + ((P-1)/P) P nB
                    recursive_doubling  ra + (P-1) nB
    bcast           flat                (P-1)(a + nB)
                    binomial_tree       r(a + nB)
                    scatter_allgather   ra + 2((P-1)/P) nB  (van de Geijn)
    alltoall(v)     pairwise            (P-1)a + 2((P-1)/P) nB
                    bruck               ra + r nB   (log rounds; n/2 sent plus
                                        n/2 received per round = nB under the
                                        out+in convention both entries use)
    barrier         binomial_tree       ra
                    flat                2(P-1)a

Staged channels (redis/s3; ``per_obj`` = store round-trip latency, ``T`` =
total bytes crossing the shared store NIC one way):

    staged          monolithic PUT then GET, blocking per object:
                    nobj*per_obj + 2 T B (round trips AND traversals serialize)
    staged_chunked  non-blocking k-chunk two-stage pipeline:
                    min_k nobj*alpha + (k+1)*per_obj + (1 + 1/k) T B
                    — per-object request processing stays, but round trips
                    overlap (one per chunk per stage survives on the critical
                    path) and the GET stream of chunk i overlaps the PUT
                    stream of chunk i+1 at the full-duplex store NIC.

Note two deliberate repricings vs the seed's calibrated schedule: allgather(v)
under "auto" costs MORE than the old 2ra + 2nB class — every rank receives
(P-1)n bytes, so (P-1) nB is the single-link floor the seed undercharged —
and direct alltoall(v) keeps the honest (P-1) a pairwise latency instead of
the seed's pipelining hand-wave (bruck covers the latency-bound regime).

``select_algorithm`` returns the min-modeled-time schedule; decisions are
memoized per exact (kind, world, nbytes, channel) in a :class:`DecisionCache`
— real event streams (BSP supersteps, shuffle rounds) re-price the same few
sizes millions of times — so the cached answer is always the true argmin and
"auto" can never price above a fixed schedule at the same point.

Heterogeneous per-pair links (``GroupLinks``)
---------------------------------------------
When a session's bootstrap could not hole-punch every pair (symmetric NAT /
partition — paper Fig 5) the surviving topology is *hybrid*: most pairs
direct, some relayed through a store.  ``hybrid_algorithm_time`` prices a
schedule round by round against that topology: each algorithm has a known
round structure (which pairs talk in round l), a round's time is the
**slowest participating link** — direct pairs pay the usual
``alpha_eff + bytes*beta``, relayed pairs pay PUT+GET through their store
with all of a round's relayed bytes *serialized at that store's NIC* (the
same no-1/P bottleneck the staged channels model).  ``select_hybrid`` is
the autotuner over that model: schedules whose rounds avoid the relayed
pairs price at their all-direct cost, so the engine literally routes around
damage (a binomial tree never touches an off-tree relayed pair; a ring hits
an adjacent one every round).  A full-relay fallback — run the whole
collective through the fabric's store — is always a candidate, and when NO
direct pair exists it is the only one: a topology with zero punched links
is store-mediated, period, and prices exactly as the staged engine.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable

from repro_torch.core import netsim

# chunk counts the staged pipeliner may choose from (fixed, so the tuned
# time is a min over finitely many monotone-in-n schedules)
CHUNK_CANDIDATES = (1, 2, 4, 8, 16, 32, 64, 128, 256)

# kind -> cost-class; every kind in netsim's vocabulary must appear here
_KIND_CLASS = {
    "barrier": "barrier",
    "allreduce": "allreduce",
    "reduce_scatter": "reduce_scatter",
    "allgather": "allgather",
    "allgatherv": "allgather",
    "bcast": "bcast",
    "alltoall": "alltoall",
    "alltoallv": "alltoall",
    "gather": "rooted",
    "scatter": "rooted",
    "p2p": "p2p",
    "send": "p2p",
    "recv": "p2p",
}


def _as_channel(
    channel: netsim.ChannelModel | netsim.ProviderProfile,
) -> netsim.ChannelModel:
    """Accept a ProviderProfile anywhere a channel is priced: the autotuner
    runs on the provider's direct channel (its punched-pair substrate)."""
    if isinstance(channel, netsim.ProviderProfile):
        return channel.direct
    return channel


def _rounds(world: int) -> int:
    return max(1, math.ceil(math.log2(world)))


def _alpha_eff(channel: netsim.ChannelModel, world: int) -> float:
    # same fan-in congestion factor the calibrated schedules use (Fig 13)
    return channel.alpha_s * (1.0 + world / 64.0)


# -- direct-channel cost schedules ------------------------------------------
# Each entry: algorithm -> f(alpha_eff, beta, world, rounds, nbytes) -> seconds.

_Cost = Callable[[float, float, int, int, int], float]

_DIRECT_COSTS: dict[str, dict[str, _Cost]] = {
    "barrier": {
        "binomial_tree": lambda a, b, p, r, n: r * a,
        "flat": lambda a, b, p, r, n: 2.0 * (p - 1) * a,
    },
    "allreduce": {
        "flat": lambda a, b, p, r, n: 2.0 * (p - 1) * (a + n * b),
        "binomial_tree": lambda a, b, p, r, n: 2.0 * r * (a + n * b),
        "ring": lambda a, b, p, r, n: 2.0 * (p - 1) * a + 2.0 * ((p - 1) / p) * n * b,
        "recursive_doubling": lambda a, b, p, r, n: r * (a + n * b),
        "rabenseifner": lambda a, b, p, r, n: 2.0 * r * a + 2.0 * ((p - 1) / p) * n * b,
    },
    "reduce_scatter": {
        "flat": lambda a, b, p, r, n: (p - 1) * (a + n * b),
        "binomial_tree": lambda a, b, p, r, n: r * (a + n * b),
        "ring": lambda a, b, p, r, n: (p - 1) * a + ((p - 1) / p) * n * b,
        "recursive_halving": lambda a, b, p, r, n: r * a + ((p - 1) / p) * n * b,
    },
    "allgather": {
        "flat": lambda a, b, p, r, n: (p - 1) * a + (p - 1) * n * b,
        "ring": lambda a, b, p, r, n: (p - 1) * (a + n * b),
        "recursive_doubling": lambda a, b, p, r, n: r * a + (p - 1) * n * b,
    },
    "bcast": {
        "flat": lambda a, b, p, r, n: (p - 1) * (a + n * b),
        "binomial_tree": lambda a, b, p, r, n: r * (a + n * b),
        "scatter_allgather": lambda a, b, p, r, n: r * a + 2.0 * ((p - 1) / p) * n * b,
    },
    "alltoall": {
        "pairwise": lambda a, b, p, r, n: (p - 1) * a + 2.0 * ((p - 1) / p) * n * b,
        "bruck": lambda a, b, p, r, n: r * a + r * n * b,
    },
    # rooted gather/scatter: n is the calibrated per-rank share (netsim prices
    # the (P-1)/P wire at one link's share); linear == the calibrated schedule
    "rooted": {
        "linear": lambda a, b, p, r, n: a + n * b,
        "binomial_tree": lambda a, b, p, r, n: r * a + n * b,
    },
    "p2p": {
        "direct": lambda a, b, p, r, n: a + n * b,
    },
}


def _staged_nobj(kind: str, world: int) -> float:
    """Objects PUT+GET per rank under monolithic staging (netsim's model)."""
    if kind in ("alltoall", "alltoallv"):
        return 2.0 * world  # one object per destination, PUT + GET
    return 4.0  # PUT shard / GET staged result (+ control)


def _staged_monolithic(channel: netsim.ChannelModel, kind: str, world: int, nbytes: int) -> float:
    per_obj = channel.alpha_s + channel.store_alpha_s
    if kind == "barrier":
        return 2.0 * per_obj * _rounds(world)
    total = nbytes * world
    return _staged_nobj(kind, world) * per_obj + 2.0 * total * channel.beta_s_per_byte


def _staged_chunked(
    channel: netsim.ChannelModel, kind: str, world: int, nbytes: int,
) -> tuple[float, int]:
    """Best k-chunk pipelined PUT/GET time and the chosen chunk count.

    The monolithic schedule issues its per-destination objects *blocking*, so
    every one of the ``nobj`` store round-trips serializes, and the GET phase
    only starts after the last PUT completes.  The pipelined schedule issues
    non-blocking (FMI §VI) and splits the payload into k chunks, so round
    trips overlap — but they are not free: the store front-end still
    processes one request per object (``nobj * alpha``) and each of the two
    pipeline stages (PUT in, GET out) keeps one round-trip latency per chunk
    on the critical path.  The store's full-duplex NIC streams chunk i out
    while chunk i+1 streams in, pipelining the monolithic ``2 T B`` down to
    ``(1 + 1/k) T B``:

        T(k) = nobj*alpha + (k+1)*per_obj + (1 + 1/k) T B
    """
    per_obj = channel.alpha_s + channel.store_alpha_s
    issue = _staged_nobj(kind, world) * channel.alpha_s  # request processing
    total = nbytes * world
    best, best_k = math.inf, 1
    for k in CHUNK_CANDIDATES:
        t = issue + (k + 1) * per_obj + (1 + 1 / k) * total * channel.beta_s_per_byte
        if t < best:
            best, best_k = t, k
    return best, best_k


def overlap_pipeline_time(
    compute_s: float,
    lat_s: float,
    bw_s: float,
    chunks: int | None = None,
) -> tuple[float, int]:
    """Modeled superstep time with comm double-buffered behind compute.

    Extends the k-chunk staged pipeline above from "chunks of one
    collective" to "chunks of one superstep": compute is split into k
    chunks and chunk i's collective (issued non-blocking, FMI §VI) ships
    while chunk i+1 computes.  The superstep's priced comm decomposes as
    ``lat_s`` (latency rounds, ships concurrently with compute on the
    network plane) + ``bw_s`` (bytes serialized at the NIC).  Chunk i's
    bandwidth share ``bw_s/k`` starts after its compute chunk and after the
    previous chunk drains, so the pipeline's closed form is

        T(k) = max(C + B/k, C/k + B) + L

    — compute-bound (everything but the last chunk's drain hides) or
    bandwidth-bound (everything but the first compute chunk hides), plus
    the latency of the final chunk's rounds, which nothing can hide.
    ``T(1) == C + B + L`` is exactly the non-overlapped sum, so the min
    over :data:`CHUNK_CANDIDATES` is never worse than today's pricing.
    Returns ``(seconds, chunks)``; pass ``chunks=`` to pin k.
    """
    c = max(float(compute_s), 0.0)
    lat = max(float(lat_s), 0.0)
    bw = max(float(bw_s), 0.0)
    if chunks is not None and int(chunks) < 1:
        raise ValueError(f"chunks must be >= 1, got {chunks}")
    candidates = (int(chunks),) if chunks is not None else CHUNK_CANDIDATES
    best, best_k = math.inf, 1
    for k in candidates:
        if k < 1:
            raise ValueError(f"chunk count must be >= 1, got {k}")
        t = max(c + bw / k, c / k + bw) + lat
        if t < best:
            best, best_k = t, k
    return best, best_k


def algorithms_for(channel, kind: str) -> tuple[str, ...]:
    """Candidate schedule names for one (channel-or-provider, kind)."""
    channel = _as_channel(channel)
    klass = _KIND_CLASS[kind]
    if channel.staged:
        if klass == "barrier":
            return ("staged",)
        return ("staged", "staged_chunked")
    return tuple(_DIRECT_COSTS[klass])


def algorithm_time(
    channel,
    kind: str,
    world: int,
    nbytes: int,
    algorithm: str,
) -> float:
    """Modeled seconds for one collective under one named schedule
    (``channel`` may be a :class:`netsim.ProviderProfile`)."""
    if world <= 1:
        return 0.0
    channel = _as_channel(channel)
    klass = _KIND_CLASS[kind]
    if channel.staged:
        if algorithm == "staged":
            return _staged_monolithic(channel, kind, world, nbytes)
        if algorithm == "staged_chunked" and klass != "barrier":
            return _staged_chunked(channel, kind, world, nbytes)[0]
        raise ValueError(f"unknown staged algorithm {algorithm!r} for kind {kind!r}")
    try:
        fn = _DIRECT_COSTS[klass][algorithm]
    except KeyError:
        raise ValueError(
            f"unknown algorithm {algorithm!r} for kind {kind!r} "
            f"(options: {algorithms_for(channel, kind)})"
        ) from None
    return fn(_alpha_eff(channel, world), channel.beta_s_per_byte, world, _rounds(world), nbytes)


@dataclasses.dataclass(frozen=True)
class Choice:
    """One autotuner decision: the schedule to run and its modeled time."""

    algorithm: str
    time_s: float
    chunks: int = 1  # >1 only for staged_chunked


class DecisionCache:
    """Memoized (kind, world, nbytes, channel) -> algorithm decisions.

    Keys are the *exact* size, not a size bucket: a bucket-granular argmin
    would be order-dependent near crossover points (whichever size hit the
    bucket first would pin the schedule for its neighbors, occasionally above
    the true min).  Exact keys keep the autotuner guarantee — auto is never
    worse than any fixed schedule at the same point — while still absorbing
    the common case of millions of same-shaped events.  Bounded: the cache
    self-clears past ``max_entries`` (a degenerate all-unique-size stream
    would otherwise grow without limit).
    """

    def __init__(self, max_entries: int = 1 << 16):
        self._decisions: dict[tuple, str] = {}
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _key(kind: str, world: int, nbytes: int, channel: netsim.ChannelModel) -> tuple:
        return (kind, world, int(nbytes), channel)

    def lookup(self, kind, world, nbytes, channel) -> str | None:
        algo = self._decisions.get(self._key(kind, world, nbytes, channel))
        if algo is not None:
            self.hits += 1
        return algo

    def store(self, kind, world, nbytes, channel, algorithm: str) -> None:
        self.misses += 1
        if len(self._decisions) >= self.max_entries:
            self._decisions.clear()
        self._decisions[self._key(kind, world, nbytes, channel)] = algorithm

    def clear(self) -> None:
        self._decisions.clear()
        self.hits = self.misses = 0

    def __len__(self) -> int:
        return len(self._decisions)


_GLOBAL_CACHE = DecisionCache()


def select_algorithm(
    kind: str,
    world: int,
    nbytes: int,
    channel,
    cache: DecisionCache | None = _GLOBAL_CACHE,
) -> Choice:
    """Cost-driven autotuner: min modeled time over every candidate schedule.

    ``channel`` is a :class:`netsim.ChannelModel` or a
    :class:`netsim.ProviderProfile` (resolved to its direct channel, so a
    decision cached for one provider is shared by every provider on the
    same substrate).  With a cache, the argmin is memoized per exact
    (kind, world, nbytes, channel); pass ``cache=None`` to force a fresh
    evaluation.
    """
    if world <= 1:
        return Choice("none", 0.0)
    channel = _as_channel(channel)
    nbytes = int(nbytes)
    if cache is not None:
        cached = cache.lookup(kind, world, nbytes, channel)
        if cached is not None:
            return _choice_for(cached, channel, kind, world, nbytes)
    best: Choice | None = None
    for name in algorithms_for(channel, kind):
        c = _choice_for(name, channel, kind, world, nbytes)
        if best is None or c.time_s < best.time_s:
            best = c
    if cache is not None:
        cache.store(kind, world, nbytes, channel, best.algorithm)
    return best


def _choice_for(name, channel, kind, world, nbytes) -> Choice:
    if channel.staged and name == "staged_chunked":
        t, k = _staged_chunked(channel, kind, world, nbytes)
        return Choice(name, t, chunks=k)
    return Choice(name, algorithm_time(channel, kind, world, nbytes, name))


def tuned_time(channel, kind: str, world: int, nbytes: int) -> float:
    """Min modeled time across schedules (the autotuned pricing path);
    ``channel`` may be a provider profile."""
    return select_algorithm(kind, world, nbytes, channel).time_s


# ---------------------------------------------------------------------------
# Heterogeneous per-pair links: hybrid (direct + relayed) pricing
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GroupLinks:
    """A communicator group's link topology, relabeled to local ranks.

    ``relayed`` holds (i, j, store_channel) triples with i < j local ranks —
    pairs whose hole punch failed and whose traffic relays through a store
    (possibly a different store per pair).  ``fallback`` is the fabric's
    relay channel, used when routing the *whole* collective through one
    store.  ``pair_direct`` holds (i, j, channel) triples for pairs that
    punched on a *different* direct substrate than ``direct`` — same-provider
    pairs of a burst group in a heterogeneous world — priced per-round like
    direct pairs at their own alpha/beta (never staged channels; a staged
    substrate belongs in ``relayed``).  Hashable, so hybrid decisions
    memoize like direct ones.
    """

    world: int
    direct: netsim.ChannelModel
    relayed: tuple = ()
    fallback: netsim.ChannelModel = netsim.REDIS_STAGED
    pair_direct: tuple = ()

    @property
    def all_direct(self) -> bool:
        return not self.relayed and not self.pair_direct

    @property
    def fully_relayed(self) -> bool:
        return self.world > 1 and len(self.relayed) == self.world * (self.world - 1) // 2

    @property
    def relay_names(self) -> str:
        return ",".join(sorted({ch.name for (_, _, ch) in self.relayed}))

    def relays_touching(self, rank: int) -> list:
        return [ch for (i, j, ch) in self.relayed if rank in (i, j)]

    def directs_touching(self, rank: int) -> list:
        """Direct-channel overrides on pairs touching ``rank``."""
        return [ch for (i, j, ch) in self.pair_direct if rank in (i, j)]


# Round structure per (kind-class, algorithm): (pair shape, number of rounds,
# total bandwidth factor).  Per-round bytes = factor * n / rounds, so the
# homogeneous sum over rounds reproduces the closed forms in _DIRECT_COSTS
# (latency coefficient == round count for every entry, checked in tests).
_HYBRID_STRUCTURE: dict[str, dict[str, tuple]] = {
    "barrier": {
        "binomial_tree": ("binomial", lambda p, r: r, lambda p, r: 0.0),
        "flat": ("flat_fan", lambda p, r: 2 * (p - 1), lambda p, r: 0.0),
    },
    "allreduce": {
        "flat": ("flat_fan", lambda p, r: 2 * (p - 1), lambda p, r: 2.0 * (p - 1)),
        "binomial_tree": ("binomial", lambda p, r: 2 * r, lambda p, r: 2.0 * r),
        "ring": ("ring", lambda p, r: 2 * (p - 1), lambda p, r: 2.0 * (p - 1) / p),
        "recursive_doubling": ("xor", lambda p, r: r, lambda p, r: float(r)),
        "rabenseifner": ("xor", lambda p, r: 2 * r, lambda p, r: 2.0 * (p - 1) / p),
    },
    "reduce_scatter": {
        "flat": ("flat_fan", lambda p, r: p - 1, lambda p, r: float(p - 1)),
        "binomial_tree": ("binomial", lambda p, r: r, lambda p, r: float(r)),
        "ring": ("ring", lambda p, r: p - 1, lambda p, r: (p - 1) / p),
        "recursive_halving": ("xor", lambda p, r: r, lambda p, r: (p - 1) / p),
    },
    "allgather": {
        "flat": ("flat_fan", lambda p, r: p - 1, lambda p, r: float(p - 1)),
        "ring": ("ring", lambda p, r: p - 1, lambda p, r: float(p - 1)),
        "recursive_doubling": ("xor", lambda p, r: r, lambda p, r: float(p - 1)),
    },
    "bcast": {
        "flat": ("flat_fan", lambda p, r: p - 1, lambda p, r: float(p - 1)),
        "binomial_tree": ("binomial", lambda p, r: r, lambda p, r: float(r)),
        "scatter_allgather": ("binomial", lambda p, r: r, lambda p, r: 2.0 * (p - 1) / p),
    },
    "alltoall": {
        "pairwise": ("pairwise", lambda p, r: p - 1, lambda p, r: 2.0 * (p - 1) / p),
        "bruck": ("bruck", lambda p, r: r, lambda p, r: float(r)),
    },
    "rooted": {
        "linear": ("rooted_fan", lambda p, r: 1, lambda p, r: 1.0),
        "binomial_tree": ("binomial", lambda p, r: r, lambda p, r: 1.0),
    },
    "p2p": {
        "direct": ("p2p", lambda p, r: 1, lambda p, r: 1.0),
    },
}

# the calibrated paper schedule's shape per kind-class — what algorithm="fixed"
# prices when the group has relayed links (all-direct "fixed" keeps the exact
# netsim.collective_time closed form for calibration compatibility)
FIXED_SHAPES = {
    "barrier": "binomial_tree",
    "allreduce": "binomial_tree",
    "reduce_scatter": "binomial_tree",
    "allgather": "ring",
    "bcast": "binomial_tree",
    "alltoall": "pairwise",
    "rooted": "linear",
    "p2p": "direct",
}


def fixed_shape(kind: str) -> str:
    """Calibrated schedule shape for one collective kind."""
    return FIXED_SHAPES[_KIND_CLASS[kind]]


def _round_pairs(shape: str, idx: int, world: int, r: int) -> tuple:
    """Local-rank pairs communicating in round ``idx`` of a schedule shape."""
    if shape == "flat_fan":
        return ((0, 1 + idx % (world - 1)),)
    if shape == "rooted_fan":
        return tuple((0, j) for j in range(1, world))
    if shape == "binomial":
        stride = 1 << (idx % r)
        return tuple(
            (a, a + stride)
            for a in range(world)
            if (a // stride) % 2 == 0 and a + stride < world
        )
    if shape == "xor":
        stride = 1 << (idx % r)
        return tuple(
            (i, i ^ stride) for i in range(world) if i < (i ^ stride) < world
        )
    if shape == "ring":
        return tuple(sorted({
            tuple(sorted((i, (i + 1) % world))) for i in range(world)
        }))
    if shape == "pairwise":
        k = 1 + idx % (world - 1)
        return tuple(sorted({
            tuple(sorted((i, (i + k) % world))) for i in range(world)
            if i != (i + k) % world
        }))
    if shape == "bruck":
        stride = (1 << (idx % r)) % world
        if stride == 0:
            return ()
        return tuple(sorted({
            tuple(sorted((i, (i + stride) % world))) for i in range(world)
        }))
    if shape == "p2p":
        return ((0, 1),) if world > 1 else ()
    raise ValueError(f"unknown round shape {shape!r}")


def hybrid_algorithm_time(
    links: GroupLinks, kind: str, nbytes: int, algorithm: str
) -> float:
    """Seconds for one schedule over a heterogeneous link topology.

    Round time = max over participating links: direct pairs share the round
    concurrently at ``alpha_eff + b*beta``; each store serializes its relayed
    pairs' bytes (PUT+GET, no 1/P) — so one relayed pair in a round gates it
    at the relay's price, and schedules that avoid relayed pairs price
    all-direct.  With zero relayed pairs this defers to ``algorithm_time``
    (bit-identical to the homogeneous engine).
    """
    world = links.world
    if world <= 1:
        return 0.0
    if links.all_direct:
        return algorithm_time(links.direct, kind, world, nbytes, algorithm)
    klass = _KIND_CLASS[kind]
    try:
        shape, nrounds_fn, coeff_fn = _HYBRID_STRUCTURE[klass][algorithm]
    except KeyError:
        raise ValueError(
            f"unknown hybrid algorithm {algorithm!r} for kind {kind!r} "
            f"(options: {tuple(_HYBRID_STRUCTURE[klass])})"
        ) from None
    r = _rounds(world)
    nrounds = int(nrounds_fn(world, r))
    b_round = coeff_fn(world, r) * nbytes / max(nrounds, 1)
    a_eff = _alpha_eff(links.direct, world)
    beta = links.direct.beta_s_per_byte
    relay_of = {(i, j): ch for (i, j, ch) in links.relayed}
    override_of = {(i, j): ch for (i, j, ch) in links.pair_direct}
    total = 0.0
    for idx in range(nrounds):
        pairs = _round_pairs(shape, idx, world, r)
        relay_bytes: dict[netsim.ChannelModel, float] = {}
        override_chans: set[netsim.ChannelModel] = set()
        direct_active = not pairs  # a pure-latency round still pays alpha
        for pair in pairs:
            ch = relay_of.get(pair)
            if ch is not None:
                relay_bytes[ch] = relay_bytes.get(ch, 0.0) + b_round
                continue
            och = override_of.get(pair)
            if och is not None:
                override_chans.add(och)
            else:
                direct_active = True
        t = a_eff + b_round * beta if direct_active else 0.0
        for och in override_chans:
            # override pairs run concurrently on their own substrate; the
            # round is gated by the slowest participating link class
            t = max(t, _alpha_eff(och, world) + b_round * och.beta_s_per_byte)
        for ch, tot in relay_bytes.items():
            t_relay = (2.0 * (ch.alpha_s + ch.store_alpha_s)
                       + 2.0 * tot * ch.beta_s_per_byte)
            t = max(t, t_relay)
        total += t
    return total


_HYBRID_CACHE: dict[tuple, Choice] = {}
_HYBRID_CACHE_MAX = 1 << 14


def select_hybrid(
    kind: str, world: int, nbytes: int, links: GroupLinks, use_cache: bool = True
) -> Choice:
    """Autotuner over a heterogeneous link topology.

    Candidates: every direct schedule priced round-by-round against the
    link map (schedules that dodge the relayed pairs win), plus routing the
    whole collective through the fallback store ("<staged>@relay").  With no
    direct pair left the store route is the only physical one, so the
    result equals the pure-mediated staged price — never below it.
    """
    if world <= 1:
        return Choice("none", 0.0)
    if links.world != world:
        raise ValueError(f"links built for world {links.world}, got {world}")
    if links.all_direct:
        return select_algorithm(kind, world, nbytes, links.direct)
    nbytes = int(nbytes)
    klass = _KIND_CLASS[kind]
    if links.fully_relayed:
        c = select_algorithm(kind, world, nbytes, links.fallback, cache=None)
        return Choice(f"{c.algorithm}@relay", c.time_s, c.chunks)
    key = (kind, world, nbytes, links)
    if use_cache and key in _HYBRID_CACHE:
        return _HYBRID_CACHE[key]
    best: Choice | None = None
    for name in _HYBRID_STRUCTURE[klass]:
        t = hybrid_algorithm_time(links, kind, nbytes, name)
        if best is None or t < best.time_s:
            best = Choice(f"{name}+relay", t)
    fb = select_algorithm(kind, world, nbytes, links.fallback, cache=None)
    if fb.time_s < best.time_s:
        best = Choice(f"{fb.algorithm}@relay", fb.time_s, fb.chunks)
    if use_cache:
        if len(_HYBRID_CACHE) >= _HYBRID_CACHE_MAX:
            _HYBRID_CACHE.clear()
        _HYBRID_CACHE[key] = best
    return best


# ---------------------------------------------------------------------------
# Multi-provider topologies and cost-aware placement
# ---------------------------------------------------------------------------


def provider_links(rank_providers, relay=None) -> GroupLinks:
    """Link topology for a world whose ranks live on different providers.

    ``rank_providers`` maps local rank -> provider name/profile (a list or
    tuple, one entry per rank).  Cross-provider pairs cannot hole-punch —
    there is no shared rendezvous path through two NAT regimes — so they are
    forced onto relay links (``relay`` if given, else the *base* provider's
    relay channel; the base provider is rank 0's).  Same-provider pairs of a
    non-base provider punch on their own direct substrate and appear as
    ``pair_direct`` overrides — unless that provider's "direct" channel is
    itself staged, in which case those pairs are relayed through it.
    """
    profiles = [netsim.get_provider(p) for p in rank_providers]
    if not profiles:
        raise ValueError("rank_providers must name at least one rank")
    base = profiles[0]
    relay_ch = _as_channel(relay) if relay is not None else base.relay_channel
    if not relay_ch.staged:
        raise ValueError(f"relay channel {relay_ch.name!r} is not a staged store")
    world = len(profiles)
    relayed, pair_direct = [], []
    for i in range(world):
        for j in range(i + 1, world):
            pi, pj = profiles[i], profiles[j]
            if pi.name != pj.name:
                relayed.append((i, j, relay_ch))
            elif pi.name != base.name:
                if pi.direct.staged:
                    relayed.append((i, j, pi.direct))
                else:
                    pair_direct.append((i, j, pi.direct))
    return GroupLinks(
        world,
        base.direct,
        tuple(relayed),
        relay_ch,
        tuple(pair_direct),
    )


@dataclasses.dataclass(frozen=True)
class Workload:
    """A BSP job's resource shape, provider-agnostic.

    ``compute_s`` is single-superstep-summed compute time at cpu_speed 1.0
    (scaled by each candidate's relative core speed).  ``collectives`` is a
    tuple of (kind, bytes_per_rank, count) triples covering the whole run.
    """

    world: int
    compute_s: float
    collectives: tuple = ()
    mem_gb: float = 10.0


@dataclasses.dataclass(frozen=True)
class Placement:
    """One provider's priced bid for a workload."""

    provider: str
    time_s: float
    cost_usd: float
    feasible: bool
    init_s: float
    compute_s: float
    comm_s: float


def placement_candidates(workload: Workload, providers) -> list[Placement]:
    """Price ``workload`` on every candidate provider (no deadline filter).

    time = bootstrap (incl. expected NAT-blocked-pair mailbox setup)
         + compute / cpu_speed + tuned collective time on the direct channel;
    cost = world * per-rank invocation cost for that wall time.
    """
    out = []
    for prov in providers:
        p = netsim.get_provider(prov)
        world = workload.world
        init = p.bootstrap_time(world)
        if p.nat_blocked_rate > 0.0 and world > 1:
            npairs = world * (world - 1) // 2
            relay = p.relay_channel
            per_obj = relay.alpha_s + relay.store_alpha_s
            init += p.nat_blocked_rate * npairs * 2.0 * per_obj
        compute = workload.compute_s / p.platform.cpu_speed
        comm = sum(
            count * tuned_time(p.direct, kind, world, nbytes)
            for (kind, nbytes, count) in workload.collectives
        )
        total = init + compute + comm
        cost = world * p.invocation_cost(workload.mem_gb, total)
        out.append(Placement(p.name, total, cost, True, init, compute, comm))
    return out


def select_placement(workload: Workload, providers, deadline_s: float) -> Placement:
    """Cheapest provider whose modeled makespan meets the deadline.

    Among providers with ``time_s <= deadline_s`` the minimum-cost one wins
    (ties broken by time).  Feasible-set growth makes the result monotone in
    the deadline: loosening it can only add candidates, never raise the
    winning cost.  If NO provider meets the deadline the fastest one is
    returned with ``feasible=False`` — callers gate on that flag.
    """
    bids = placement_candidates(workload, providers)
    if not bids:
        raise ValueError("providers must name at least one candidate")
    feasible = [b for b in bids if b.time_s <= deadline_s]
    if feasible:
        return min(feasible, key=lambda b: (b.cost_usd, b.time_s))
    fastest = min(bids, key=lambda b: b.time_s)
    return dataclasses.replace(fastest, feasible=False)
