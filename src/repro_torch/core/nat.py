"""NAT-traversal / rendezvous control plane (paper Fig 5 + §III-E, §VI) — the
port's own copy of ``repro.core.nat``.

Pure-Python simulation of the connection bootstrap the paper builds for AWS
Lambda: a publicly reachable rendezvous server assigns ranks via an atomic
counter (the Redis pattern of §III-D), records each function's NAT mapping,
relays peer addresses, and the functions then hole-punch direct TCP
connections following a binomial-tree schedule.  The paper measures this
init phase at ~31.5 s for 32 workers and notes it "scales linearly with the
number of tree levels" — `connection_schedule` reproduces exactly that
structure, and `repro_torch.core.session.CommSession.bootstrap` drives this server
through the full lifecycle, pricing each phase as a BOOTSTRAP event in the
session log (the closed form remains `netsim.PlatformModel.init_time`).

Also reproduced here, because the paper calls them out as contributions in
§VI: connection retries on socket failure, rank-ordered locking to kill the
race condition they observed, and the stale-metadata hazard ("stored metadata
on Redis must be cleared between subsequent experiments ... otherwise the
experiment executes non-deterministically and ultimately fails"), which we
model and test.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class NatMapping:
    internal: str
    external: str


class StaleMetadataError(RuntimeError):
    """Raised when a rendezvous namespace is reused without clearing (§III-D)."""


class RendezvousServer:
    """Atomic-counter rank assignment + NAT table + address relay."""

    def __init__(self, expected_world: int):
        self.expected_world = int(expected_world)
        self._counter = 0                      # Redis INCR analogue
        self._nat_table: dict[int, NatMapping] = {}
        self._locks_held: list[int] = []       # rank-ordered locking (§VI)
        self.cleared = True

    # -- bootstrap ------------------------------------------------------------

    def assign_rank(self, internal_addr: str) -> int:
        """Atomically assign the next rank (paper: 'increments an atomic value
        to represent the rank. Before incrementing the value, the rank is
        set.')."""
        if not self.cleared:
            raise StaleMetadataError(
                "rendezvous namespace reused without clear(); paper §III-D: "
                "experiments execute non-deterministically and ultimately fail"
            )
        rank = self._counter
        self._counter += 1
        if self._counter > self.expected_world:
            self.cleared = False  # over-subscription == stale namespace
            raise StaleMetadataError("more registrations than expected world size")
        ext = f"54.0.{rank // 256}.{rank % 256}:{40000 + rank}"
        self._nat_table[rank] = NatMapping(internal_addr, ext)
        return rank

    def clear(self) -> None:
        """Paper's required between-experiment cleanup."""
        self._counter = 0
        self._nat_table.clear()
        self._locks_held.clear()
        self.cleared = True

    def grow(self, extra: int) -> None:
        """Raise the expected world so new workers can register mid-run.

        Burst expansion is NOT the §III-D stale-metadata hazard: the live
        namespace stays valid, the admission bound just moves.  Without this,
        the (expected+1)-th ``assign_rank`` poisons the namespace.
        """
        if extra < 1:
            raise ValueError("extra must be >= 1")
        self.expected_world += int(extra)

    def shrink(self, dead_ranks) -> dict:
        """Compact the membership table after evicting ``dead_ranks``.

        Survivors are relabeled to 0..S-1 in rank order (their NAT mappings
        move to the new slots), the atomic counter and expected world drop
        to the survivor count, and held locks are released (the rank-ordered
        locking protocol restarts over the new labels).  This is NOT the
        §III-D stale-metadata hazard: the coordinator rewrites the live
        namespace in one atomic batch, it does not reuse a dead one.
        Returns the old->new rank map.
        """
        dead = {int(r) for r in dead_ranks}
        for r in dead:
            if r not in self._nat_table:
                raise KeyError(f"rank {r} was never assigned; cannot evict")
        survivors = [r for r in sorted(self._nat_table) if r not in dead]
        if not survivors:
            raise ValueError("cannot shrink away the whole membership")
        remap = {old: new for new, old in enumerate(survivors)}
        self._nat_table = {remap[r]: self._nat_table[r] for r in survivors}
        self._counter = len(survivors)
        self.expected_world = len(survivors)
        self._locks_held.clear()
        return remap

    def reassign_rank(self, rank: int, internal_addr: str) -> str:
        """Re-register a re-invoked worker in its existing slot.

        A deadline-killed rank comes back as a fresh function behind a NEW
        NAT binding; its stale mapping must be overwritten — the same
        §III-D stale-metadata hazard ``clear()`` guards between experiments,
        applied to a single slot mid-run.  Returns the new external address
        (port bumped past the original range so peers re-punch).
        """
        if rank not in self._nat_table:
            raise KeyError(f"rank {rank} was never assigned; use assign_rank")
        ext = f"54.0.{rank // 256}.{rank % 256}:{50000 + rank}"
        self._nat_table[rank] = NatMapping(internal_addr, ext)
        return ext

    def peer_address(self, rank: int) -> str:
        """Relay the hole-punched external address of a peer (Fig 5 step 2)."""
        return self._nat_table[rank].external

    # -- rank-ordered locking (the paper's race-condition fix, §VI) ------------

    def acquire_ordered(self, rank: int) -> bool:
        """Blocking-op lock granted strictly in rank order."""
        expected = len(self._locks_held)
        if rank != expected:
            return False
        self._locks_held.append(rank)
        return True


def connection_schedule(world: int) -> list[list[tuple[int, int]]]:
    """Binomial-tree hole-punching schedule: level l connects pairs at
    distance 2**l; all pairs within a level punch concurrently.

    Returns a list of levels, each a list of (a, b) rank pairs.  The number of
    levels is ceil(log2(world)) — the linear-in-levels quantity the paper's
    31.5 s init phase scales with.
    """
    if world <= 1:
        return []
    levels: list[list[tuple[int, int]]] = []
    for l in range(math.ceil(math.log2(world))):
        stride = 1 << l
        level = [
            (a, a + stride)
            for a in range(world)
            if (a // stride) % 2 == 0 and a + stride < world
        ]
        levels.append(level)
    return levels


def punch_all(
    server: RendezvousServer,
    world: int,
    fail_prob: float = 0.0,
    max_retries: int = 3,
    seed: int = 0,
) -> dict[str, int]:
    """Drive the full bootstrap: register ranks, then punch the schedule with
    retry-on-socket-failure (paper §VI: 'retries for socket connection
    failures').  Deterministic given `seed`.

    Returns counters: {'connections', 'retries', 'levels'}.
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    for w in range(world):
        server.assign_rank(f"10.0.0.{w}")
    levels = connection_schedule(world)
    retries = 0
    connections = 0
    for level in levels:
        for a, b in level:
            # both ends learn each other's external mapping, then connect
            _ = server.peer_address(a), server.peer_address(b)
            attempt = 0
            while True:
                if fail_prob == 0.0 or rng.random() >= fail_prob:
                    connections += 1
                    break
                attempt += 1
                retries += 1
                if attempt > max_retries:
                    raise ConnectionError(f"hole punch {a}<->{b} failed after {max_retries} retries")
    return {"connections": connections, "retries": retries, "levels": len(levels)}
