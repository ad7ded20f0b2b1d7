"""Collective algorithm engine: per-algorithm cost schedules + tuned selection
— the port's own copy of the all-direct and staged subset of
``repro.core.algorithms`` (hybrid links, providers and placement are not
ported yet).  Formulas are the reference's, verbatim.

Direct channels (``alpha_eff = alpha * (1 + P/64)``, ``r = ceil(log2 P)``,
``n`` = bytes per rank):

    kind            algorithm           modeled time
    --------------  ------------------  -----------------------------------
    allreduce       flat                2(P-1)(a + nB)
                    binomial_tree       2r(a + nB)
                    ring                2(P-1)a + 2((P-1)/P) nB
                    recursive_doubling  r(a + nB)
                    rabenseifner        2ra + 2((P-1)/P) nB
    reduce_scatter  flat                (P-1)(a + nB)
                    binomial_tree       r(a + nB)
                    ring                (P-1)a + ((P-1)/P) nB
                    recursive_halving   ra + ((P-1)/P) nB
    allgather(v)    flat                (P-1)a + (P-1) nB
                    ring                (P-1)a + ((P-1)/P) P nB
                    recursive_doubling  ra + (P-1) nB
    bcast           flat                (P-1)(a + nB)
                    binomial_tree       r(a + nB)
                    scatter_allgather   ra + 2((P-1)/P) nB
    alltoall(v)     pairwise            (P-1)a + 2((P-1)/P) nB
                    bruck               ra + r nB
    barrier         binomial_tree       ra
                    flat                2(P-1)a

Staged channels (redis/s3; ``per_obj`` = store round-trip latency, ``T`` =
total bytes crossing the shared store NIC one way):

    staged          nobj*per_obj + 2 T B
    staged_chunked  min_k nobj*alpha + (k+1)*per_obj + (1 + 1/k) T B

``select_algorithm`` returns the min-modeled-time schedule, memoized per
exact (kind, world, nbytes, channel) in a :class:`DecisionCache`.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable

from repro_torch.core import netsim

# chunk counts the staged pipeliner may choose from
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
    # rooted gather/scatter: n is the calibrated per-rank share
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
    """Best k-chunk pipelined PUT/GET time and the chosen chunk count:

        T(k) = nobj*alpha + (k+1)*per_obj + (1 + 1/k) T B
    """
    per_obj = channel.alpha_s + channel.store_alpha_s
    requests = _staged_nobj(kind, world) * channel.alpha_s  # request processing
    total = nbytes * world
    best, best_k = math.inf, 1
    for k in CHUNK_CANDIDATES:
        t = requests + (k + 1) * per_obj + (1 + 1 / k) * total * channel.beta_s_per_byte
        if t < best:
            best, best_k = t, k
    return best, best_k


def algorithms_for(channel: netsim.ChannelModel, kind: str) -> tuple[str, ...]:
    """Candidate schedule names for one (channel, kind)."""
    klass = _KIND_CLASS[kind]
    if channel.staged:
        if klass == "barrier":
            return ("staged",)
        return ("staged", "staged_chunked")
    return tuple(_DIRECT_COSTS[klass])


def algorithm_time(
    channel: netsim.ChannelModel,
    kind: str,
    world: int,
    nbytes: int,
    algorithm: str,
) -> float:
    """Modeled seconds for one collective under one named schedule."""
    if world <= 1:
        return 0.0
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
    """Memoized (kind, world, nbytes, channel) -> algorithm decisions, keyed
    by the exact size (so the cached answer is always the true argmin) and
    self-clearing past ``max_entries``."""

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
    channel: netsim.ChannelModel,
    cache: DecisionCache | None = _GLOBAL_CACHE,
) -> Choice:
    """Cost-driven autotuner: min modeled time over every candidate schedule
    (``cache=None`` forces a fresh evaluation)."""
    if world <= 1:
        return Choice("none", 0.0)
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


def tuned_time(channel: netsim.ChannelModel, kind: str, world: int, nbytes: int) -> float:
    """Min modeled time across schedules (the autotuned pricing path)."""
    return select_algorithm(kind, world, nbytes, channel).time_s
