"""Communication sessions: the connection lifecycle around the collectives —
the port's own copy of ``repro.core.session`` (every price verbatim).

The paper's primary contribution is not the collectives themselves but the
*bootstrap* that makes them possible on serverless (§III-D/E, Fig 5):
rendezvous through a publicly reachable server (atomic-counter rank
assignment, the Redis INCR pattern), NAT-mapping exchange, binomial-tree
hole punching — and, when a pair cannot be punched (symmetric NAT, network
partition), **fallback to mediated storage** so the job still completes.
:class:`CommSession` owns exactly that lifecycle:

    session = CommSession.bootstrap(world=8, fabric="lambda")
    comm = session.communicator()          # root communicator over all ranks
    row, col = comm.split(colors), ...     # MPI_Comm_split sub-groups

``bootstrap`` drives :class:`repro_torch.core.nat.RendezvousServer` through the
full sequence and prices every phase as :class:`CommEvent`s (kind
``BOOTSTRAP``) in the session's event log — the same log the collectives
land in — replacing the old side-channel ``PlatformModel.init_time`` call.
The sum of the bootstrap events reproduces ``init_time`` exactly for the
default all-direct scenario (paper Fig 14: ~31.5 s at 32 Lambda workers).

The product of bootstrap is a :class:`LinkMap`: a **per-pair channel
assignment**.  Pairs that hole-punched get the fabric's direct channel;
pairs configured as blocked (``Fabric.blocked_pairs`` / ``blocked_ranks``)
fall back to the fabric's relay channel (redis/s3).  Every collective on a
communicator whose group contains a relayed pair is priced link-aware by
``repro_torch.core.algorithms`` (each round at the slowest participating link) and
its :class:`CommEvent` records the relay.

Re-bootstrap: a deadline-killed / preempted rank re-joins through
:meth:`CommSession.rebootstrap_rank` — re-registration in its rendezvous
slot (``RendezvousServer.reassign_rank``; the re-invoked function gets a new
NAT binding) plus one re-punch per tree level, priced into the same log.
``BSPRuntime`` calls this on every deadline kill and ``launch/train.py`` on
``--resume`` after a preemption drill.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Iterable
from typing import TYPE_CHECKING

from repro_torch.core import algorithms, nat, netsim

if TYPE_CHECKING:  # circular at runtime: communicator imports session
    from repro_torch.core.communicator import CommEvent, Communicator


# ---------------------------------------------------------------------------
# Fabric: the bootstrap environment
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Fabric:
    """Everything ``bootstrap`` needs to know about the world it connects.

    ``platform`` prices the rendezvous lifecycle (per-level punch cost, base
    startup); ``direct`` is the channel punched pairs use (defaults to the
    platform's); ``relay`` is the mediated fallback for pairs that cannot be
    punched.  The NAT scenario is configuration, not chance: ``blocked_pairs``
    are pair-wise symmetric-NAT / partition cases, ``blocked_ranks`` are
    workers behind a fully symmetric NAT (every link to them relays).
    ``punch_fail_prob`` adds *transient* socket failures that succeed on
    retry (paper §VI), priced into the punch-level events.  ``blocked_rate``
    is a provider-level expectation — that fraction of all pairs is sampled
    (deterministically, from ``seed``) as permanently blocked, on top of any
    explicitly configured pairs/ranks.  ``provider`` records which registry
    entry this fabric was derived from, if any (per-rank pricing reads it).
    """

    platform: netsim.PlatformModel = netsim.LAMBDA_10GB
    direct: netsim.ChannelModel | None = None
    relay: netsim.ChannelModel = netsim.REDIS_STAGED
    blocked_pairs: frozenset = frozenset()
    blocked_ranks: frozenset = frozenset()
    punch_fail_prob: float = 0.0
    max_retries: int = 3
    seed: int = 0
    blocked_rate: float = 0.0
    provider: str | None = None

    @property
    def direct_channel(self) -> netsim.ChannelModel:
        return self.direct or self.platform.channel

    def blocked_set(self, world: int) -> frozenset:
        """Normalized (a < b) blocked pairs, expanding blocked ranks and
        sampling ``blocked_rate`` of all pairs deterministically."""
        pairs = set()
        for p in self.blocked_pairs:
            a, b = sorted(int(x) for x in p)
            if a == b or not (0 <= a and b < world):
                raise ValueError(f"blocked pair {p!r} invalid for world {world}")
            pairs.add((a, b))
        for r in self.blocked_ranks:
            if not (0 <= int(r) < world):
                raise ValueError(f"blocked rank {r!r} out of range for world {world}")
            for o in range(world):
                if o != r:
                    pairs.add(tuple(sorted((int(r), o))))
        if self.blocked_rate > 0.0 and world > 1:
            import numpy as np

            all_pairs = [(a, b) for a in range(world) for b in range(a + 1, world)]
            k = round(self.blocked_rate * len(all_pairs))
            if k:
                rng = np.random.default_rng(self.seed)
                idx = rng.choice(len(all_pairs), size=int(k), replace=False)
                pairs.update(all_pairs[int(i)] for i in idx)
        return frozenset(pairs)


FABRICS = {
    "lambda": Fabric(platform=netsim.LAMBDA_10GB),
    "lambda-6gb": Fabric(platform=netsim.LAMBDA_6GB),
    "ec2": Fabric(platform=netsim.EC2_XL),
    "hpc": Fabric(platform=netsim.RIVANNA_10GB),
    # store-rendezvous fabrics: no NAT traversal, everything mediated
    "redis": Fabric(platform=netsim.LAMBDA_10GB, direct=netsim.REDIS_STAGED),
    "s3": Fabric(platform=netsim.LAMBDA_10GB, direct=netsim.S3_STAGED),
}


# canonical definition moved down to netsim (the provider registry prices
# bootstrap with it); re-exported here because the session owns the lifecycle
mediated_bootstrap_time = netsim.mediated_bootstrap_time


def provider_fabric(name: str | netsim.ProviderProfile) -> Fabric:
    """Fabric for a registered provider: its platform, direct channel, relay,
    and expected NAT-blocked-pair rate."""
    p = netsim.get_provider(name)
    return Fabric(
        platform=p.platform,
        direct=p.direct,
        relay=p.relay_channel,
        blocked_rate=p.nat_blocked_rate,
        provider=p.name,
    )


# ---------------------------------------------------------------------------
# LinkMap: per-pair channel assignment
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Link:
    """One pair's transport: the channel it uses and whether it relays."""

    a: int
    b: int
    channel: netsim.ChannelModel
    relayed: bool = False


class LinkMap:
    """World-wide per-pair channel table produced by bootstrap.

    Direct pairs share ``direct``; relayed pairs carry their own (possibly
    heterogeneous) store channel.  ``fallback`` is the fabric's relay — the
    store the engine routes *everything* through when no direct link exists.
    ``overrides`` carries per-pair *direct* channels that differ from the
    base (same-provider pairs of a burst group in a heterogeneous world).
    """

    def __init__(
        self,
        world: int,
        direct: netsim.ChannelModel,
        relays: dict | None = None,
        fallback: netsim.ChannelModel = netsim.REDIS_STAGED,
        overrides: dict | None = None,
    ):
        self.world = int(world)
        self.direct = direct
        self._relays = {
            tuple(sorted(p)): ch for p, ch in (relays or {}).items()
        }
        self.fallback = fallback
        self._overrides = {
            tuple(sorted(p)): ch for p, ch in (overrides or {}).items()
        }

    def link(self, a: int, b: int) -> Link:
        a, b = sorted((int(a), int(b)))
        ch = self._relays.get((a, b))
        if ch is None:
            return Link(a, b, self._overrides.get((a, b), self.direct), relayed=False)
        return Link(a, b, ch, relayed=True)

    def is_relayed(self, a: int, b: int) -> bool:
        return tuple(sorted((int(a), int(b)))) in self._relays

    @property
    def all_direct(self) -> bool:
        return not self._relays and not self._overrides

    def relayed_pairs(self) -> tuple:
        return tuple(sorted(self._relays))

    def override_pairs(self) -> tuple:
        return tuple(sorted(self._overrides))

    def degrade(self, a: int, b: int,
                channel: netsim.ChannelModel | None = None) -> Link:
        """Demote a direct pair to its relay fallback (the recovery ladder's
        last rung before shrink: the punched channel is gone for good, the
        pair's traffic routes through the store from now on).  Idempotent on
        an already-relayed pair.  Returns the pair's new :class:`Link`."""
        a, b = sorted((int(a), int(b)))
        if a == b or not (0 <= a and b < self.world):
            raise ValueError(f"pair ({a}, {b}) invalid for world {self.world}")
        self._overrides.pop((a, b), None)
        self._relays[(a, b)] = channel or self.fallback
        return self.link(a, b)

    def restore_direct(self, a: int, b: int,
                       channel: netsim.ChannelModel | None = None) -> Link:
        """Promote a relayed pair back to a direct channel (a successful
        re-punch after a transient flap).  ``channel`` other than the base
        direct lands as a per-pair override."""
        a, b = sorted((int(a), int(b)))
        self._relays.pop((a, b), None)
        if channel is not None and channel != self.direct:
            self._overrides[(a, b)] = channel
        return self.link(a, b)

    def compact(self, dead_ranks: Iterable[int]) -> dict:
        """Drop ``dead_ranks`` and relabel the survivors 0..S-1 in place
        (the link-table half of :meth:`CommSession.shrink`).  Pairs touching
        a dead rank disappear; surviving relays/overrides keep their
        channels under the new labels.  Returns the old->new rank map."""
        dead = {int(r) for r in dead_ranks}
        survivors = [r for r in range(self.world) if r not in dead]
        remap = {old: new for new, old in enumerate(survivors)}

        def _compact(table: dict) -> dict:
            out = {}
            for (a, b), ch in table.items():
                if a in remap and b in remap:
                    out[tuple(sorted((remap[a], remap[b])))] = ch
            return out

        self._relays = _compact(self._relays)
        self._overrides = _compact(self._overrides)
        self.world = len(survivors)
        return remap

    def group_links(self, group: tuple) -> algorithms.GroupLinks:
        """Link view for a sub-group, relabeled to local ranks.

        ``group[i]`` is the global rank of local rank ``i`` (split order);
        round schedules in the engine run over local labels, so relayed
        pairs are translated before pricing.
        """
        idx = {int(g): i for i, g in enumerate(group)}
        relayed = []
        for (a, b), ch in sorted(self._relays.items()):
            if a in idx and b in idx:
                i, j = sorted((idx[a], idx[b]))
                relayed.append((i, j, ch))
        pair_direct = []
        for (a, b), ch in sorted(self._overrides.items()):
            if a in idx and b in idx:
                i, j = sorted((idx[a], idx[b]))
                pair_direct.append((i, j, ch))
        return algorithms.GroupLinks(
            world=len(group),
            direct=self.direct,
            relayed=tuple(relayed),
            fallback=self.fallback,
            pair_direct=tuple(pair_direct),
        )


# ---------------------------------------------------------------------------
# CommSession
# ---------------------------------------------------------------------------


class CommSession:
    """Owns membership (rendezvous server), transport (LinkMap), and the
    priced event log that bootstrap and every collective share."""

    def __init__(
        self,
        world: int,
        link_map: LinkMap,
        fabric: Fabric | None = None,
        server: nat.RendezvousServer | None = None,
        events: list | None = None,
    ):
        if world < 1:
            raise ValueError("world must be >= 1")
        self.world = int(world)
        self.link_map = link_map
        self.fabric = fabric
        self.server = server
        self.events: list[CommEvent] = events if events is not None else []
        # optional span timeline (repro_torch.core.trace.Tracer): when attached,
        # every logged event is mirrored as a comm/bootstrap span; the
        # events list itself stays the thin per-event view it always was
        self.tracer = None
        self.trace_ranks: tuple[int, ...] | None = None
        self._mirror = True
        # per-rank provider names (None for pre-registry fabrics); expand()
        # appends to this as it grows the world, shrink() compacts it
        base = fabric.provider if fabric is not None else None
        self.rank_providers: list[str | None] = [base] * self.world
        # failure detector pricing (suspect/confirm DETECT events)
        self.detector = netsim.DEFAULT_DETECTOR
        # ranks evicted by shrink(): {"rank", "provider"} in eviction order
        self.evicted: list[dict] = []
        # armed fault-domain context (ArmedFaults + current step); the
        # runtime arms it per superstep so outage windows hit rendezvous
        # registrations and relayed collectives on the modeled clock
        self._armed = None
        self._fault_step = 0

    # -- construction ---------------------------------------------------------

    @classmethod
    def all_direct(
        cls, world: int, channel: netsim.ChannelModel | None = None
    ) -> CommSession:
        """Implicit compatibility session: every pair direct on ``channel``,
        no bootstrap events — ``Communicator(world_size=P)`` builds one of
        these, so pre-session code prices bit-identically."""
        channel = channel or netsim.LAMBDA_DIRECT
        return cls(world, LinkMap(world, channel))

    @classmethod
    def bootstrap(
        cls,
        world: int,
        fabric: Fabric | str = "lambda",
        server: nat.RendezvousServer | None = None,
    ) -> CommSession:
        """Run the full rendezvous lifecycle (paper Fig 5) and price it.

        1. every worker registers: atomic rank assignment + NAT table entry;
        2. binomial-tree hole-punch schedule, level by level, with transient
           failures retried (``punch_fail_prob``);
        3. pairs configured as blocked fail permanently after ``max_retries``
           and fall back to the fabric's relay channel (mediated storage).

        Every phase lands in the session log as a ``BOOTSTRAP``
        :class:`CommEvent`; with no blocked pairs and no transient failures
        their sum equals ``fabric.platform.init_time(world)`` exactly.
        A staged ``direct`` channel means there is nothing to punch: the
        whole bootstrap is one store-rendezvous event
        (:func:`mediated_bootstrap_time`).
        """
        import numpy as np

        from repro_torch.core.communicator import CollectiveKind, CommEvent

        if isinstance(fabric, str):
            if fabric in FABRICS:
                fabric = FABRICS[fabric]
            else:
                try:
                    fabric = provider_fabric(fabric)
                except ValueError:
                    raise ValueError(
                        f"unknown fabric {fabric!r}; options: {sorted(FABRICS)} "
                        f"or a registered provider {sorted(netsim.providers())}"
                    ) from None
        direct = fabric.direct_channel
        server = server or nat.RendezvousServer(world)
        events: list[CommEvent] = []

        # phase 1: atomic rank assignment + NAT table (Fig 5 steps 1-2).
        # Raises StaleMetadataError on a reused namespace (§III-D).
        for w in range(world):
            server.assign_rank(f"10.0.0.{w}")

        if direct.staged:
            # store rendezvous: membership converges through the store, no
            # NAT traversal, every link IS the store
            events.append(CommEvent(
                CollectiveKind.BOOTSTRAP, world, 0,
                mediated_bootstrap_time(direct, world), algo="store_rendezvous",
            ))
            link_map = LinkMap(world, direct, {}, fabric.relay)
            return cls(world, link_map, fabric, server, events)

        events.append(CommEvent(
            CollectiveKind.BOOTSTRAP, world, 0,
            fabric.platform.init_base_s, algo="rendezvous",
        ))

        # phase 2: hole punching down the binomial tree, one priced event
        # per level (the linear-in-levels scaling of the paper's 31.5 s)
        blocked = fabric.blocked_set(world)
        rng = np.random.default_rng(fabric.seed)
        for lvl, level in enumerate(nat.connection_schedule(world)):
            level_retries = 0
            for a, b in level:
                _ = server.peer_address(a), server.peer_address(b)
                if (a, b) in blocked:
                    # permanent failure (symmetric NAT): burn every retry
                    # (priced into this level's event), then fall back below
                    level_retries += fabric.max_retries
                    continue
                while fabric.punch_fail_prob and rng.random() < fabric.punch_fail_prob:
                    level_retries += 1
                    if level_retries > 64 * max(1, len(level)):
                        raise ConnectionError("transient punch failures did not converge")
            events.append(CommEvent(
                CollectiveKind.BOOTSTRAP, world, 0,
                fabric.platform.init_per_level_s + level_retries * direct.alpha_s,
                algo=f"hole_punch_l{lvl}",
            ))

        # phase 3: relay fallback for every blocked pair.  Schedule pairs
        # already burned their retries in their level's event above; what
        # remains is each blocked pair (on-tree or discovered on first use)
        # registering a mailbox with the relay store: one PUT/GET round trip
        # per endpoint.
        relays = {pair: fabric.relay for pair in blocked}
        if blocked:
            per_obj = fabric.relay.alpha_s + fabric.relay.store_alpha_s
            t = len(blocked) * 2.0 * per_obj
            events.append(CommEvent(
                CollectiveKind.BOOTSTRAP, world, 0, t,
                algo="relay_fallback", relay=fabric.relay.name,
                relayed_pairs=len(blocked),
            ))

        link_map = LinkMap(world, direct, relays, fabric.relay)
        return cls(world, link_map, fabric, server, events)

    # -- accounting -----------------------------------------------------------

    @property
    def direct_channel(self) -> netsim.ChannelModel:
        return self.link_map.direct

    # lifecycle-event algo prefixes that are NOT part of the initial
    # bootstrap: re-joins, elastic resizes, and the recovery ladder
    _LATER_LIFECYCLE = (
        "rebootstrap", "expand", "shrink", "repunch", "degrade", "outage_wait",
    )

    @property
    def bootstrap_time_s(self) -> float:
        """Priced initial bootstrap (excludes re-bootstraps, expands,
        shrinks, and recovery-ladder events)."""
        from repro_torch.core.communicator import CollectiveKind

        return float(sum(
            e.time_s for e in self.events
            if e.kind == CollectiveKind.BOOTSTRAP
            and not e.algo.startswith(self._LATER_LIFECYCLE)
        ))

    @property
    def rebootstrap_time_s(self) -> float:
        from repro_torch.core.communicator import CollectiveKind

        return float(sum(
            e.time_s for e in self.events
            if e.kind == CollectiveKind.BOOTSTRAP
            and e.algo.startswith("rebootstrap")
        ))

    @property
    def expand_time_s(self) -> float:
        """Sum of every priced ``expand_*`` event (all expansions so far)."""
        from repro_torch.core.communicator import CollectiveKind

        return float(sum(
            e.time_s for e in self.events
            if e.kind == CollectiveKind.BOOTSTRAP
            and e.algo.startswith("expand")
        ))

    @property
    def shrink_time_s(self) -> float:
        """Sum of every priced ``shrink_*`` event (all shrinks so far)."""
        from repro_torch.core.communicator import CollectiveKind

        return float(sum(
            e.time_s for e in self.events
            if e.kind == CollectiveKind.BOOTSTRAP
            and e.algo.startswith("shrink")
        ))

    @property
    def detect_time_s(self) -> float:
        """Sum of every failure-detector (``DETECT``) event."""
        from repro_torch.core.communicator import CollectiveKind

        return float(sum(
            e.time_s for e in self.events if e.kind == CollectiveKind.DETECT
        ))

    @property
    def recovery_time_s(self) -> float:
        """Everything the degradation ladder spent: detector probes plus
        re-punches, relay degradations, and outage retry waits (shrink and
        rebootstrap are accounted by their own properties)."""
        from repro_torch.core.communicator import CollectiveKind

        t = self.detect_time_s
        t += float(sum(
            e.time_s for e in self.events
            if e.kind == CollectiveKind.BOOTSTRAP
            and e.algo.startswith(("repunch", "degrade", "outage_wait"))
        ))
        return t

    def reset_events(self, keep_bootstrap: bool = True) -> None:
        """Clear collective events; bootstrap/lifecycle history (including
        failure-detector events) survives by default.  In-place so every
        communicator aliasing this log stays wired."""
        from repro_torch.core.communicator import CollectiveKind

        kept = [
            e for e in self.events
            if keep_bootstrap
            and e.kind in (CollectiveKind.BOOTSTRAP, CollectiveKind.DETECT)
        ]
        self.events[:] = kept

    # -- span timeline --------------------------------------------------------

    def attach_tracer(
        self,
        tracer,
        ranks: tuple[int, ...] | None = None,
        mirror: bool = True,
        backfill: bool = True,
    ):
        """Emit this session's priced events onto a span timeline.

        ``tracer`` is a :class:`repro_torch.core.trace.Tracer`.  Events already in
        the log (the bootstrap history) are backfilled as spans; every event
        logged afterwards is mirrored live while ``mirror`` is True.  A
        scheduler that owns span placement itself (``BSPRuntime`` lays comm
        spans *after* the superstep's compute) passes ``mirror=False`` and
        keeps the backfill.  ``ranks`` restricts mirroring to those ranks
        (``launch/train.py`` traces the one worker it models, rank 0);
        default: every rank participating in each event.
        """
        self.tracer = tracer
        self.trace_ranks = None if ranks is None else tuple(int(r) for r in ranks)
        self._mirror = bool(mirror)
        if backfill:
            for ev in self.events:
                self._mirror_event(ev, group=None)
        return tracer

    def _mirror_event(self, ev, group=None) -> None:
        if self.tracer is None:
            return
        ranks = tuple(group) if group is not None else tuple(range(ev.world))
        if self.trace_ranks is not None:
            ranks = tuple(r for r in ranks if r in self.trace_ranks)
        if ranks:
            self.tracer.ingest_comm_event(ev, ranks)

    def log_event(self, ev, group=None):
        """Append one priced event to the shared log, mirroring it onto the
        attached tracer (if any).  ``group`` is the global-rank tuple the
        event spans — sub-communicators pass theirs so the span lands on
        the right lanes."""
        self.events.append(ev)
        if self._mirror:
            self._mirror_event(ev, group=group)
        return ev

    # -- handles --------------------------------------------------------------

    def communicator(self, algorithm: str = "auto") -> Communicator:
        """Root communicator over the whole session (use ``.split`` for
        sub-groups per mesh axis)."""
        from repro_torch.core.communicator import Communicator

        return Communicator(session=self, algorithm=algorithm)

    # -- fault domains & recovery ladder --------------------------------------

    def arm_faults(self, armed, step: int = 0) -> None:
        """Attach one run's :class:`~repro_torch.core.faults.ArmedFaults` so
        infrastructure domains (store/rendezvous outages) price into this
        session's lifecycle ops.  ``step`` seeds the fault clock; the
        runtime advances it via :meth:`set_fault_step` each superstep."""
        self._armed = armed
        self._fault_step = int(step)

    def set_fault_step(self, step: int) -> None:
        self._fault_step = int(step)

    def store_outage_penalty_s(self) -> float:
        """Retry-ladder seconds store-mediated traffic pays right now
        (0.0 when no faults are armed or the store is healthy).  Consulted
        by the communicator for relayed/staged collectives."""
        if self._armed is None:
            return 0.0
        return self._armed.outage_penalty_s("store", self._fault_step)

    def _rendezvous_outage_wait(self) -> float:
        """If the rendezvous server is down right now, pay (and log) the
        retry ladder before the registration lands.  Returns the wait."""
        if self._armed is None:
            return 0.0
        wait = self._armed.outage_penalty_s("rendezvous", self._fault_step)
        if wait > 0.0:
            from repro_torch.core.communicator import CollectiveKind, CommEvent

            self.log_event(CommEvent(
                CollectiveKind.BOOTSTRAP, self.world, 0, wait,
                algo="outage_wait_rendezvous",
            ))
        return wait

    def detect_failure(self, label: str) -> float:
        """Run the priced failure detector against one target (a rank or a
        link): the missed-heartbeat suspicion window, then the confirm
        probes — two ``DETECT`` events (``detect_suspect_<label>``,
        ``detect_confirm_<label>``) on the overhead lane.  Returns the
        summed modeled seconds (failure to confirmed-dead)."""
        from repro_torch.core.communicator import CollectiveKind, CommEvent

        suspect = self.detector.suspect_s()
        confirm = self.detector.confirm_s()
        self.log_event(CommEvent(
            CollectiveKind.DETECT, self.world, 0, suspect,
            algo=f"detect_suspect_{label}",
        ))
        self.log_event(CommEvent(
            CollectiveKind.DETECT, self.world, 0, confirm,
            algo=f"detect_confirm_{label}",
        ))
        return suspect + confirm

    def recover_link(self, a: int, b: int,
                     permanent: bool = False) -> tuple:
        """The per-link degradation ladder for a flapped direct pair.

        detect (suspect -> confirm) -> re-punch with exponential backoff ->
        if the link is gone for good, degrade to the relay fallback
        (``LinkMap.degrade``).  A transient flap costs one failed punch, a
        backoff, and one successful re-punch; a permanent one burns the
        fabric's ``max_retries`` punch attempts before falling back to the
        store.  Every rung is a priced event; the caller refreshes its
        communicators afterwards (:meth:`Communicator.refresh_links`).

        Returns ``(modeled_seconds, action)`` with action ``"repunched"``,
        ``"degraded"``, or ``"already_relayed"``.
        """
        from repro_torch.core.communicator import CollectiveKind, CommEvent

        a, b = sorted((int(a), int(b)))
        if a == b or not (0 <= a and b < self.world):
            raise ValueError(f"pair ({a}, {b}) invalid for world {self.world}")
        if self.link_map.is_relayed(a, b):
            return 0.0, "already_relayed"  # already on the store: flap is moot

        total = self.detect_failure(f"l{a}_{b}")
        # re-punching goes through the rendezvous server (fresh NAT
        # mappings) — a rendezvous outage stalls the ladder here
        total += self._rendezvous_outage_wait()

        direct = self.link_map.link(a, b).channel
        if self.fabric is not None:
            punch_s = self.fabric.platform.init_per_level_s
            retries = self.fabric.max_retries
        else:
            punch_s = 0.0
            retries = 3
        backoff0 = 0.5

        if not permanent:
            # attempt 1 lands on the still-flapping link (one wasted RTT),
            # the backoff outlasts the flap, attempt 2 punches clean
            t = direct.alpha_s + backoff0 + punch_s
            self.log_event(CommEvent(
                CollectiveKind.BOOTSTRAP, self.world, 0, t,
                algo=f"repunch_l{a}_{b}",
            ))
            return total + t, "repunched"

        # permanent: burn every retry (attempt + growing backoff), then
        # register relay mailboxes for the pair — one PUT/GET round trip
        # per endpoint, same price as a bootstrap-time relay fallback
        t = sum(direct.alpha_s + backoff0 * (2.0 ** i) for i in range(retries))
        self.log_event(CommEvent(
            CollectiveKind.BOOTSTRAP, self.world, 0, t,
            algo=f"repunch_l{a}_{b}",
        ))
        total += t
        relay = self.link_map.fallback
        per_obj = relay.alpha_s + relay.store_alpha_s
        t_deg = 2.0 * per_obj
        self.link_map.degrade(a, b)
        self.log_event(CommEvent(
            CollectiveKind.BOOTSTRAP, self.world, 0, t_deg,
            algo=f"degrade_l{a}_{b}", relay=relay.name, relayed_pairs=1,
        ))
        return total + t_deg, "degraded"

    def shrink(self, dead_ranks: Iterable[int],
               policy: str = "incremental") -> float:
        """Evict confirmed-dead ranks and compact the world — the scale-down
        inverse of :meth:`expand`.

        ``policy="incremental"`` keeps the live fabric: survivors already
        hold punched links to each other, so the resize collapses to

        1. ``shrink_membership`` — the coordinator publishes the survivor
           list + new rank labels through the relay store (one PUT + one GET
           per survivor wave: ``2 * per_obj``);
        2. ``shrink_relay_gc`` — relay mailboxes of pairs touching a dead
           rank are torn down (one store round trip each);
        3. ``shrink_sync`` — survivors agree on the compacted world: a
           zero-byte barrier down the punched tree (``ceil(log2 S)`` alpha
           rounds), or one store round trip when the fabric is staged.

        ``policy="cold"`` prices the alternative this machinery avoids: tear
        everything down and re-bootstrap the survivor world from scratch
        (``shrink_cold_rebootstrap`` — the full punch cascade again).

        Either way the ``LinkMap`` compacts (survivors relabel to 0..S-1,
        surviving relays keep their channels), the rendezvous table shrinks,
        ``rank_providers`` compacts, and the evicted ranks land in
        ``self.evicted``.  Implicit all-direct sessions compact for free.
        Returns the summed modeled seconds of the ``shrink_*`` events.
        """
        from repro_torch.core.communicator import CollectiveKind, CommEvent

        dead = sorted({int(r) for r in dead_ranks})
        if not dead:
            return 0.0
        for r in dead:
            if not (0 <= r < self.world):
                raise ValueError(f"rank {r} out of range for world {self.world}")
        survivors = [r for r in range(self.world) if r not in set(dead)]
        if not survivors:
            raise ValueError("cannot shrink away the whole world")
        if policy not in ("incremental", "cold"):
            raise ValueError(f"unknown shrink policy {policy!r}")

        # record evictions (provider read before compaction)
        for r in dead:
            self.evicted.append(
                {"rank": r, "provider": self.rank_providers[r]})

        new_world = len(survivors)
        dead_pairs = [
            p for p in self.link_map.relayed_pairs()
            if p[0] in set(dead) or p[1] in set(dead)
        ]

        total = 0.0
        if self.fabric is not None:
            # membership updates route through the rendezvous/relay store —
            # an outage window stalls the shrink like any registration
            total += self._rendezvous_outage_wait()
            relay = self.link_map.fallback
            per_obj = relay.alpha_s + relay.store_alpha_s
            direct = self.fabric.direct_channel

            def emit(t, algo, **kw):
                nonlocal total
                total += t
                self.log_event(CommEvent(
                    CollectiveKind.BOOTSTRAP, new_world, 0, t, algo=algo, **kw,
                ))

            if policy == "incremental":
                emit(2.0 * per_obj, "shrink_membership")
                if dead_pairs:
                    emit(len(dead_pairs) * per_obj, "shrink_relay_gc",
                         relay=relay.name, relayed_pairs=len(dead_pairs))
                if direct.staged:
                    emit(2.0 * (direct.alpha_s + direct.store_alpha_s),
                         "shrink_sync")
                else:
                    levels = (max(1, math.ceil(math.log2(new_world)))
                              if new_world > 1 else 0)
                    emit(levels * direct.alpha_s, "shrink_sync")
            else:
                # cold: what the incremental path avoids — survivors tear
                # down and rebuild the whole session at the survivor world
                self_world = self.world
                self.world = new_world  # price at the survivor world
                try:
                    t_cold = self.full_rebootstrap_time_s()
                finally:
                    self.world = self_world
                # full_rebootstrap prices the *current* relay set; drop the
                # dead pairs' mailboxes from the bill (they are not rebuilt)
                t_cold -= sum(
                    2.0 * (self.link_map.link(a, b).channel.alpha_s
                           + self.link_map.link(a, b).channel.store_alpha_s)
                    for a, b in dead_pairs
                )
                emit(t_cold, "shrink_cold_rebootstrap")

        # compact membership: link table, rendezvous slots, providers
        self.link_map.compact(dead)
        if self.server is not None:
            self.server.shrink(dead)
        self.rank_providers = [
            p for r, p in enumerate(self.rank_providers) if r not in set(dead)
        ]
        self.world = new_world
        return total

    def rebootstrap_rank(self, rank: int) -> float:
        """Re-join a deadline-killed / preempted rank through the session.

        The re-invoked function re-registers in its rendezvous slot (a new
        NAT binding — ``RendezvousServer.reassign_rank`` overwrites the
        stale mapping, the §III-D hazard) and re-punches its ≤ ceil(log2 P)
        tree connections, one per level.  Priced as a ``BOOTSTRAP`` event in
        the shared log; returns the modeled seconds.  Implicit all-direct
        sessions have no bootstrap lifecycle to replay: no-op, 0.0.
        """
        from repro_torch.core.communicator import CollectiveKind, CommEvent

        if not (0 <= int(rank) < self.world):
            raise ValueError(f"rank {rank} out of range for world {self.world}")
        if self.fabric is None:
            return 0.0
        # re-registration needs the rendezvous server: an outage window
        # stalls the re-join for the retry ladder (priced as its own event)
        wait = self._rendezvous_outage_wait()
        if self.server is not None:
            self.server.reassign_rank(int(rank), f"10.0.0.{int(rank)}")
        direct = self.fabric.direct_channel
        if direct.staged:
            t = mediated_bootstrap_time(direct, self.world)
        else:
            # the replayed lifecycle costs what the original did: base
            # rendezvous + one re-punch per tree level (the calibrated
            # closed form, so rebootstrap can never drift from bootstrap)
            t = self.fabric.platform.init_time(self.world)
        self.log_event(CommEvent(
            CollectiveKind.BOOTSTRAP, self.world, 0, t, algo=f"rebootstrap_r{int(rank)}",
        ))
        return t + wait

    def expand(
        self,
        new_ranks: int,
        provider: str | netsim.ProviderProfile | None = None,
    ) -> float:
        """Grow the world by ``new_ranks`` workers without a full re-bootstrap.

        Cold bootstrap pays one punch event per binomial-tree *level* because
        each level gates on peers that registered one level earlier.  An
        expansion joins a **live** world: the rendezvous server is warm and
        the core's NAT table is complete, so the join collapses to

        1. ``expand_rendezvous`` — the joining ranks register (atomic rank
           assignment against the grown bound; the joining platform's
           ``init_base_s``);
        2. ``expand_punch_core`` — every new<->core pair punches
           *concurrently* (all peer mappings are already published): one
           ``init_per_level_s`` of the joining platform;
        3. ``expand_punch_new`` — new<->new pairs punch among themselves
           (their mappings appeared in step 1): one more level, only when
           more than one rank joins;
        4. ``expand_relay_fallback`` — pairs that cannot punch register relay
           mailboxes: every cross-provider pair (no shared rendezvous path
           through two NAT regimes) plus the joining provider's expected
           NAT-blocked fraction of the punchable pairs.

        A staged joining substrate skips the punch waves entirely — the new
        ranks converge through their store (``expand_store_rendezvous``) and
        every pair touching them relays.  Cross-provider pairs land in the
        ``LinkMap`` as relays; same-provider pairs of a *different* provider
        than the base keep their own direct channel as per-pair overrides.
        Returns the summed modeled seconds (compare
        :meth:`full_rebootstrap_time_s`).
        """
        import numpy as np

        from repro_torch.core.communicator import CollectiveKind, CommEvent

        k = int(new_ranks)
        if k < 1:
            raise ValueError("new_ranks must be >= 1")
        if self.fabric is None or self.server is None:
            raise ValueError(
                "implicit all-direct sessions have no bootstrap lifecycle to "
                "extend; use CommSession.bootstrap(...) first"
            )
        if provider is None:
            join_fabric = self.fabric
        else:
            join_fabric = provider_fabric(provider)
        join_name = join_fabric.provider
        base_name = self.fabric.provider
        cross = (
            provider is not None
            and (join_name != base_name or base_name is None)
        )
        join_direct = join_fabric.direct_channel
        old_world = self.world
        new_world = old_world + k

        # registration goes through the rendezvous server: pay any outage
        total = self._rendezvous_outage_wait()

        # 1. registration against the grown admission bound (warm server)
        self.server.grow(k)
        for w in range(old_world, new_world):
            self.server.assign_rank(f"10.0.0.{w}")

        def emit(t, algo, **kw):
            nonlocal total
            total += t
            self.log_event(CommEvent(
                CollectiveKind.BOOTSTRAP, new_world, 0, t, algo=algo, **kw,
            ))

        core_pairs = [
            tuple(sorted((c, n)))
            for c in range(old_world) for n in range(old_world, new_world)
        ]
        new_pairs = [
            (a, b)
            for a in range(old_world, new_world)
            for b in range(a + 1, new_world)
        ]

        relays = dict.fromkeys(self.link_map.relayed_pairs())
        for p in self.link_map.relayed_pairs():
            relays[p] = self.link_map.link(*p).channel
        overrides = {
            p: self.link_map.link(*p).channel
            for p in self.link_map.override_pairs()
        }

        if join_direct.staged:
            # store-rendezvous join: nothing to punch, every new link relays
            emit(
                mediated_bootstrap_time(join_direct, max(2, k)),
                "expand_store_rendezvous",
            )
            for p in core_pairs + new_pairs:
                relays[p] = join_direct
        else:
            emit(join_fabric.platform.init_base_s, "expand_rendezvous")
            punchable = []
            if cross:
                # cross-provider core<->new pairs cannot punch at all
                pass
            else:
                punchable += core_pairs
            punchable += new_pairs
            blocked: set = set()
            if join_fabric.blocked_rate > 0.0 and punchable:
                rng = np.random.default_rng(join_fabric.seed + old_world)
                nb = round(join_fabric.blocked_rate * len(punchable))
                if nb:
                    idx = rng.choice(len(punchable), size=int(nb), replace=False)
                    blocked = {punchable[int(i)] for i in idx}
            if not cross:
                emit(join_fabric.platform.init_per_level_s, "expand_punch_core")
            if k > 1:
                emit(join_fabric.platform.init_per_level_s, "expand_punch_new")
            relay_pairs = set(blocked)
            if cross:
                relay_pairs.update(core_pairs)
            if relay_pairs:
                relay_ch = join_fabric.relay
                per_obj = relay_ch.alpha_s + relay_ch.store_alpha_s
                emit(
                    len(relay_pairs) * 2.0 * per_obj,
                    "expand_relay_fallback",
                    relay=relay_ch.name,
                    relayed_pairs=len(relay_pairs),
                )
                for p in relay_pairs:
                    relays[p] = relay_ch
            if join_direct != self.link_map.direct:
                for p in new_pairs:
                    if p not in relays:
                        overrides[p] = join_direct

        self.link_map = LinkMap(
            new_world,
            self.link_map.direct,
            relays,
            self.link_map.fallback,
            overrides,
        )
        self.world = new_world
        self.rank_providers.extend([join_name] * k)
        return total

    def full_rebootstrap_time_s(self) -> float:
        """Modeled cost of a cold bootstrap of the *current* world — what an
        expansion avoids.  For a heterogeneous world every registration wave
        gates on the slowest member platform: base = max ``init_base_s``,
        each of the ceil(log2 P) punch levels = max ``init_per_level_s``,
        plus the mailbox registration of every currently-relayed pair.
        """
        if self.fabric is None:
            return 0.0
        platforms = []
        for name in self.rank_providers:
            if name is None:
                platforms.append(self.fabric.platform)
            else:
                platforms.append(netsim.get_provider(name).platform)
        direct = self.fabric.direct_channel
        if direct.staged:
            t = mediated_bootstrap_time(direct, self.world)
        else:
            base = max(p.init_base_s for p in platforms)
            per_level = max(p.init_per_level_s for p in platforms)
            levels = max(0, math.ceil(math.log2(self.world))) if self.world > 1 else 0
            t = base + levels * per_level
        for a, b in self.link_map.relayed_pairs():
            ch = self.link_map.link(a, b).channel
            t += 2.0 * (ch.alpha_s + ch.store_alpha_s)
        return t


def hybrid_session(
    world: int,
    blocked_pairs: Iterable = (),
    *,
    relay: str | netsim.ChannelModel = "redis",
    platform: netsim.PlatformModel = netsim.LAMBDA_10GB,
    blocked_ranks: Iterable = (),
) -> CommSession:
    """One-call hybrid topology: bootstrap a session in which
    ``blocked_pairs`` failed hole punching and relay through ``relay``."""
    relay_ch = netsim.resolve_channel(relay)
    if not relay_ch.staged:
        raise ValueError(f"relay channel must be staged, got {relay_ch.name!r}")
    fabric = Fabric(
        platform=platform,
        relay=relay_ch,
        blocked_pairs=frozenset(tuple(sorted(p)) for p in blocked_pairs),
        blocked_ranks=frozenset(int(r) for r in blocked_ranks),
    )
    return CommSession.bootstrap(world, fabric)
