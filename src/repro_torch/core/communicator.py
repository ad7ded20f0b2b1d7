"""The serverless communicator (paper §III-E) — the port's own copy of
``repro.core.communicator``, on tensors.

A :class:`Communicator` provides MPI-style collectives for a world of P
simulated ranks over per-rank lists of **tensors**: the data semantics are
the reference's (what lands where, ``op`` folded in rank order, every rank
its own copy), and every block stays on the device it came from — a
collective over CUDA tensors never stages a block through the host.  Each
collective is logged as a priced :class:`CommEvent`; the pricing below is the
reference's, verbatim, so every modeled second, byte and event is equal to
what the reference logs for the same shapes.

The paper's FMI extensions are reproduced as API surface: variable-length
collectives (allgatherv / alltoallv), non-blocking ops with handles, retries
with a ping capability, and atomic-counter rank assignment (``core/nat.py``).
The compressed wire (``compressed_alltoallv``) needs the columnar codec,
which is not ported yet (ROADMAP A 3).

Algorithm selection (``repro_torch.core.algorithms``)
-----------------------------------------------------
Every collective takes ``algorithm=`` — ``"auto"`` (default) asks the tuned
engine for the min-modeled-time schedule, ``"fixed"`` prices the calibrated
paper schedule (binomial tree / pairwise / monolithic staging), any other
name prices that schedule explicitly.  The chosen schedule lands in
``CommEvent.algo``.

Link-aware pricing (``repro_torch.core.session``)
-------------------------------------------------
A communicator belongs to a :class:`~repro_torch.core.session.CommSession`
whose bootstrap produced a per-pair ``LinkMap``.  When every pair
hole-punched, the tuned engine prices the collective as above.  Otherwise:

    topology        pricing
    --------------  -------------------------------------------------------
    hybrid          every schedule is priced round by round at the slowest
    (some pairs     participating link — relayed pairs PUT+GET through
    relayed)        their store with the round's relayed bytes serialized
                    at its NIC; the autotuner prefers schedules whose
                    rounds avoid the relayed pairs, falling back to routing
                    the whole collective through the store
                    ("<staged>@relay") when that wins.
    fully relayed   no direct links exist: the staged engine on the relay
                    channel IS the price (never below pure-mediated).
    cross-provider  a burst group admitted from another provider
    (expanded       (``CommSession.expand``) relays every cross-provider
    world)          pair; same-provider pairs of the joining group keep
                    their own direct substrate (``GroupLinks.pair_direct``).
    degraded        a direct pair moved to its relay by the recovery ladder
    (mid-run flap)  (``CommSession.recover_link`` -> ``LinkMap.degrade``)
                    prices like a bootstrap-time relay after
                    ``refresh_links()``; the same data lands.
    store outage    while a ``FaultPlan.store_outages`` window is active,
    (fault domain)  every relay/staged collective pays the outage retry
                    ladder on top of its price (algo suffix ``+outage``).

``CommEvent.relay`` records the relay channel(s) and
``CommEvent.relayed_pairs`` the failed-pair count.  Bootstrap lands in the
same log as ``BOOTSTRAP`` events.  Sub-communicators from
:meth:`Communicator.split` (MPI ``comm_split`` color/key semantics) share the
parent's link table and event log.
"""

from __future__ import annotations

import dataclasses
import enum
from collections.abc import Callable, Sequence
from typing import Any

import torch

from repro_torch.core import algorithms as _algorithms
from repro_torch.core import netsim
from repro_torch.core import session as _session


class CollectiveKind(str, enum.Enum):
    BARRIER = "barrier"
    ALLREDUCE = "allreduce"
    REDUCE_SCATTER = "reduce_scatter"
    ALLGATHER = "allgather"
    ALLGATHERV = "allgatherv"
    ALLTOALL = "alltoall"
    ALLTOALLV = "alltoallv"
    BCAST = "bcast"
    GATHER = "gather"
    SCATTER = "scatter"
    P2P = "p2p"
    BOOTSTRAP = "bootstrap"  # session lifecycle: rendezvous / punch / relay
    DETECT = "detect"        # failure detector: suspect / confirm probes


@dataclasses.dataclass
class CommEvent:
    """One priced communication event (the unit of the §IV time/cost model).

    ``bytes_per_rank`` is what actually crossed the wire (post-codec for a
    compressed collective); ``raw_bytes`` is the logical payload before
    compression, defaulting to the wire bytes for uncompressed events, so
    ``raw_bytes / bytes_per_rank`` is the per-event compression ratio.
    ``algo`` is the schedule the engine chose to price this event ("fixed"
    for the calibrated paper schedule).  Rooted collectives whose wire total
    is not a multiple of the world size carry it exactly in ``wire_total``
    (``bytes_per_rank`` is a ceil-divided share, so ``bytes_per_rank * world``
    would over-report by up to P-1 bytes).  Events priced over a hybrid link
    topology record the relay channel name(s) in ``relay`` and the number of
    hole-punch-failed pairs in the group in ``relayed_pairs``; session
    bootstrap phases land here too (kind ``BOOTSTRAP``).
    """

    kind: CollectiveKind
    world: int
    bytes_per_rank: int     # payload owned by one rank entering the collective
    time_s: float           # modeled wall time under this backend's channel
    raw_bytes: int | None = None  # pre-codec payload per rank; None => wire
    algo: str = "fixed"     # schedule chosen by the engine for this event
    wire_total: int | None = None  # exact wire bytes; None => bytes_per_rank*world
    relay: str | None = None       # relay channel(s) when pairs were relayed
    relayed_pairs: int = 0         # hole-punch-failed pairs in the group

    def __post_init__(self):
        if self.raw_bytes is None:
            self.raw_bytes = self.bytes_per_rank

    @property
    def total_bytes(self) -> int:
        if self.wire_total is not None:
            return self.wire_total
        return self.bytes_per_rank * self.world

    @property
    def total_raw_bytes(self) -> int:
        # rooted events with a defaulted raw_bytes (uncompressed): the exact
        # wire total IS the logical total — multiplying the ceil-divided
        # share back up would re-introduce the inflation wire_total removes
        if self.wire_total is not None and self.raw_bytes == self.bytes_per_rank:
            return self.wire_total
        return self.raw_bytes * self.world

    @property
    def compression_ratio(self) -> float:
        return self.raw_bytes / max(self.bytes_per_rank, 1)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class Communicator:
    """MPI-style collectives over P simulated ranks with priced events.

    Arguments
    ---------
    world_size: number of ranks (omit when ``session`` is given).
    channel:    a :class:`netsim.ChannelModel` (direct / redis / s3) that
                prices each collective. Defaults to the session's direct
                channel (Lambda direct TCP for implicit sessions).
    algorithm:  default schedule for every collective — "auto" (tuned
                engine), "fixed" (calibrated paper schedule), or a named
                schedule; overridable per call.
    session:    the :class:`~repro_torch.core.session.CommSession` that owns
                membership, the per-pair :class:`LinkMap`, and the shared
                event log.  ``Communicator(world_size=P)`` builds an
                implicit all-direct session (no bootstrap events), so
                pre-session code prices bit-identically.
    group:      global session ranks this communicator spans, in rank order
                (``split`` builds these); defaults to the whole session.
    """

    def __init__(
        self,
        world_size: int | None = None,
        channel: netsim.ChannelModel | None = None,
        algorithm: str = "auto",
        *,
        session: _session.CommSession | None = None,
        group: Sequence[int] | None = None,
    ):
        if session is None:
            if world_size is None:
                raise ValueError("need world_size or session")
            if world_size < 1:
                raise ValueError("world_size must be >= 1")
            session = _session.CommSession.all_direct(int(world_size), channel)
        self.session = session
        self.group: tuple[int, ...] = (
            tuple(int(g) for g in group) if group is not None
            else tuple(range(session.world))
        )
        for g in self.group:
            if not (0 <= g < session.world):
                raise ValueError(f"group rank {g} outside session world {session.world}")
        if len(set(self.group)) != len(self.group):
            raise ValueError("group contains duplicate ranks")
        if world_size is not None and int(world_size) != len(self.group):
            raise ValueError(
                f"world_size {world_size} != group size {len(self.group)}"
            )
        self.world_size = len(self.group)
        self.channel = channel or session.direct_channel
        self.algorithm = algorithm
        # shared, session-owned log: bootstrap events + every collective from
        # this communicator AND its split() sub-communicators
        self.events: list[CommEvent] = session.events
        self._links = session.link_map.group_links(self.group)
        # non-blocking handles: id -> (kind, result); popped on wait() so a
        # long BSP run can issue millions of iops without growing this map
        self._pending: dict[int, tuple[str, Any]] = {}
        self._next_handle = 0

    # -- accounting ---------------------------------------------------------

    def _price(
        self,
        kind: CollectiveKind,
        bytes_per_rank: int,
        algorithm: str | None = None,
        peer: int | None = None,
    ) -> tuple[str, float, str | None]:
        """(schedule name, modeled seconds, relay channel name or None) for
        one collective on this group's link topology — the single pricing
        path `_record` and external composers (the BSP barrier) share."""
        algorithm = self.algorithm if algorithm is None else algorithm
        links = self._links
        relay_name = None
        if links.all_direct:
            if algorithm == "fixed":
                algo_name = "fixed"
                t = netsim.collective_time(
                    self.channel, kind.value, self.world_size, bytes_per_rank
                )
            elif algorithm == "auto":
                choice = _algorithms.select_algorithm(
                    kind.value, self.world_size, bytes_per_rank, self.channel
                )
                algo_name, t = choice.algorithm, choice.time_s
            else:
                algo_name = algorithm
                t = _algorithms.algorithm_time(
                    self.channel, kind.value, self.world_size, bytes_per_rank, algorithm
                )
        elif kind is CollectiveKind.P2P and peer is not None:
            # endpoint-priced: relayed only if the peer sits behind a failed
            # punch (we don't model which src is talking, so take the worst
            # relay touching the peer)
            chans = links.relays_touching(self._local(peer))
            if chans:
                worst = max(
                    chans, key=lambda c: c.point_to_point_time(int(bytes_per_rank))
                )
                t = worst.point_to_point_time(int(bytes_per_rank))
                algo_name, relay_name = "p2p@relay", worst.name
            else:
                # a peer in a cross-provider burst group may sit on its own
                # direct substrate — price at the slowest direct touching it
                ch = self.channel
                dchans = links.directs_touching(self._local(peer))
                if dchans:
                    ch = max(
                        dchans + [ch],
                        key=lambda c: c.point_to_point_time(int(bytes_per_rank)),
                    )
                t = _algorithms.algorithm_time(
                    ch, "p2p", self.world_size, bytes_per_rank, "direct"
                )
                algo_name = "direct"
        else:
            # hybrid topology: price round-by-round at the slowest
            # participating link (see repro_torch.core.algorithms)
            if algorithm == "auto":
                choice = _algorithms.select_hybrid(
                    kind.value, self.world_size, bytes_per_rank, links
                )
                algo_name, t = choice.algorithm, choice.time_s
            else:
                name = (
                    _algorithms.fixed_shape(kind.value)
                    if algorithm == "fixed" else algorithm
                )
                t = _algorithms.hybrid_algorithm_time(
                    links, kind.value, bytes_per_rank, name
                )
                algo_name = f"{name}+relay"
            relay_name = links.relay_names
        return algo_name, t, relay_name

    def collective_time_s(
        self,
        kind: CollectiveKind | str,
        bytes_per_rank: int = 0,
        algorithm: str | None = None,
    ) -> float:
        """Link-aware modeled seconds for one collective WITHOUT recording an
        event — for composers that price implicit synchronization (the BSP
        superstep barrier) outside the log."""
        kind = CollectiveKind(kind)
        return self._price(kind, int(bytes_per_rank), algorithm)[1]

    def _record(
        self,
        kind: CollectiveKind,
        bytes_per_rank: int,
        raw_bytes: int | None = None,
        *,
        algorithm: str | None = None,
        wire_total: int | None = None,
        peer: int | None = None,
    ) -> CommEvent:
        algo_name, t, relay_name = self._price(
            kind, bytes_per_rank, algorithm, peer=peer
        )
        # store-outage fault domain: store-mediated traffic (relayed pairs,
        # or a fully staged channel) pays the retry ladder while the window
        # is active; all-direct collectives never touch the store
        if relay_name is not None or self.channel.staged:
            outage_s = self.session.store_outage_penalty_s()
            if outage_s > 0.0:
                t += outage_s
                algo_name += "+outage"
        ev = CommEvent(
            kind, self.world_size, int(bytes_per_rank), t,
            raw_bytes=None if raw_bytes is None else int(raw_bytes),
            algo=algo_name,
            wire_total=None if wire_total is None else int(wire_total),
            relay=relay_name,
            relayed_pairs=len(self._links.relayed) if relay_name else 0,
        )
        # the session owns the log (and mirrors onto an attached tracer);
        # self.events stays the same aliased list, so existing consumers of
        # the per-event view are untouched
        self.session.log_event(ev, group=self.group)
        return ev

    def event_lat_bw(self, ev: CommEvent) -> tuple[float, float]:
        """Decompose one logged event's price into (latency, bandwidth)
        seconds — the split the overlap scheduler pipelines on.

        Latency is the same schedule re-priced at zero bytes (the rounds /
        store round-trips that don't shrink with the payload); bandwidth is
        the remainder.  The split is exact by construction:
        ``lat + bw == ev.time_s`` always, with ``bw`` clamped at 0 so a
        zero-byte event is pure latency.  Events whose schedule can't be
        re-priced (unknown or composite names) degrade to pure latency —
        the conservative choice, since latency is what overlap can't hide.
        """
        if ev.kind is CollectiveKind.BOOTSTRAP \
                or ev.kind is CollectiveKind.DETECT or ev.time_s <= 0.0:
            return ev.time_s, 0.0
        # an outage-penalized event re-prices at its base schedule; the
        # penalty lands in the bandwidth remainder (it can't be pipelined
        # away any less than payload bytes can)
        algo = ev.algo
        if algo.endswith("+outage"):
            algo = algo[: -len("+outage")]
        try:
            if algo == "fixed":
                lat = netsim.collective_time(self.channel, ev.kind.value, ev.world, 0)
            elif algo.endswith("+relay"):
                lat = _algorithms.hybrid_algorithm_time(
                    self._links, ev.kind.value, 0, algo[: -len("+relay")]
                )
            elif algo.endswith("@relay"):
                base = algo[: -len("@relay")]
                if base == "p2p":
                    lat = ev.time_s  # endpoint-priced ping/send: no pipeline
                else:
                    lat = _algorithms.algorithm_time(
                        self._links.fallback, ev.kind.value, ev.world, 0, base
                    )
            else:
                lat = _algorithms.algorithm_time(
                    self.channel, ev.kind.value, ev.world, 0, algo
                )
        except (ValueError, KeyError):
            lat = ev.time_s
        bw = max(ev.time_s - lat, 0.0)
        return ev.time_s - bw, bw

    def _local(self, rank: int) -> int:
        """Local index of a local rank (identity; validates range)."""
        self._check_rank(rank)
        return int(rank)

    @property
    def comm_time_s(self) -> float:
        """Priced collective time (bootstrap and failure-detector events are
        accounted separately via ``session.bootstrap_time_s`` /
        ``session.recovery_time_s``)."""
        return float(sum(
            e.time_s for e in self.events
            if e.kind not in (CollectiveKind.BOOTSTRAP, CollectiveKind.DETECT)
        ))

    def refresh_links(self) -> None:
        """Re-derive this group's link view from the session's live
        ``LinkMap`` — call after the recovery ladder degraded a pair
        (``LinkMap.degrade``) so subsequent collectives price the relayed
        topology.  Sub-communicators from :meth:`split` refresh
        independently."""
        self._links = self.session.link_map.group_links(self.group)

    @property
    def bytes_on_wire(self) -> int:
        mult = 2 if self.channel.staged else 1
        return mult * int(sum(e.total_bytes for e in self.events))

    @property
    def raw_bytes_on_wire(self) -> int:
        """Logical (pre-codec) bytes for the same event log — what an
        uncompressed run would have shipped."""
        mult = 2 if self.channel.staged else 1
        return mult * int(sum(e.total_raw_bytes for e in self.events))

    def reset_events(self) -> None:
        """Clear the session log's collective events (bootstrap history —
        there is none on implicit sessions — is preserved)."""
        self.session.reset_events(keep_bootstrap=True)

    # -- sub-groups (MPI_Comm_split) ----------------------------------------

    def split(
        self,
        color: Sequence[int | None],
        key: Sequence[int] | None = None,
    ) -> list[Communicator | None]:
        """MPI ``comm_split``: partition this communicator's ranks by color.

        ``color[r]`` / ``key[r]`` are rank r's values (one entry per local
        rank — this simulation surface sees the whole world at once, where
        real MPI ranks each pass one scalar).  Ranks sharing a color form a
        sub-communicator, ordered by ``(key[r], r)`` exactly as MPI mandates;
        ``None`` color (MPI_UNDEFINED) yields ``None``.  Returns one entry
        per local rank; ranks in the same color share the SAME Communicator
        object, whose ``group`` holds the parent ranks mapped to *global
        session ranks* — so nested splits compose and the per-pair link
        table (and the shared event log) follow the sub-group.  This is the
        ``comm_split`` the dp x mp mesh axes need: split by row color for
        the dp reduction group, by column color for the mp gather group.
        """
        if len(color) != self.world_size:
            raise ValueError(
                f"need one color per rank ({self.world_size}), got {len(color)}"
            )
        if key is None:
            key = [0] * self.world_size
        if len(key) != self.world_size:
            raise ValueError(
                f"need one key per rank ({self.world_size}), got {len(key)}"
            )
        members: dict[int, list[tuple[int, int]]] = {}
        for r in range(self.world_size):
            if color[r] is None:
                continue
            members.setdefault(int(color[r]), []).append((int(key[r]), r))
        subs: dict[int, Communicator] = {}
        for c, ranked in members.items():
            ranked.sort()  # MPI: order by key, ties by parent rank
            subs[c] = Communicator(
                channel=self.channel,
                algorithm=self.algorithm,
                session=self.session,
                group=tuple(self.group[r] for _, r in ranked),
            )
        return [
            subs[int(color[r])] if color[r] is not None else None
            for r in range(self.world_size)
        ]

    def local_rank(self, global_rank: int) -> int:
        """This communicator's rank for a global session rank."""
        try:
            return self.group.index(int(global_rank))
        except ValueError:
            raise ValueError(
                f"session rank {global_rank} not in group {self.group}"
            ) from None

    # -- collectives (semantics identical across backends) -------------------
    #
    # Blocks are tensors and stay on their device; reductions fold in rank
    # order (``acc = op(acc, x)``), so float32 sums are bit-equal to the
    # reference's numpy fold, and every rank receives its own clone.

    def barrier(self, algorithm: str | None = None) -> None:
        self._record(CollectiveKind.BARRIER, 0, algorithm=algorithm)

    def _fold(self, xs: Sequence[torch.Tensor], op: Callable) -> torch.Tensor:
        acc = xs[0].clone()
        for x in xs[1:]:
            acc = op(acc, x)
        return acc

    def allreduce(
        self, xs: Sequence[torch.Tensor], op: Callable = torch.add,
        algorithm: str | None = None,
    ) -> list[torch.Tensor]:
        self._check_world(xs)
        acc = self._fold(xs, op)
        self._record(CollectiveKind.ALLREDUCE, _nbytes(xs[0]), algorithm=algorithm)
        return [acc.clone() for _ in range(self.world_size)]

    def reduce_scatter(
        self, xs: Sequence[torch.Tensor], op: Callable = torch.add,
        algorithm: str | None = None,
    ) -> list[torch.Tensor]:
        """Reduce then scatter equal chunks along axis 0 (priced as ONE
        phase moving (P-1)/P of the data, not a full allreduce)."""
        self._check_world(xs)
        acc = self._fold(xs, op)
        if acc.shape[0] % self.world_size:
            raise ValueError("reduce_scatter requires axis0 divisible by world")
        self._record(CollectiveKind.REDUCE_SCATTER, _nbytes(xs[0]), algorithm=algorithm)
        return list(torch.chunk(acc, self.world_size, dim=0))

    def allgather(
        self, xs: Sequence[torch.Tensor], algorithm: str | None = None
    ) -> list[torch.Tensor]:
        """Fixed-size allgather: every rank gets concat(xs) along axis 0."""
        self._check_world(xs)
        if len({tuple(x.shape) for x in xs}) != 1:
            raise ValueError("allgather requires equal shapes; use allgatherv")
        out = torch.cat(list(xs), dim=0)
        self._record(CollectiveKind.ALLGATHER, _nbytes(xs[0]), algorithm=algorithm)
        return [out.clone() for _ in range(self.world_size)]

    def allgatherv(
        self, xs: Sequence[torch.Tensor], algorithm: str | None = None
    ) -> list[torch.Tensor]:
        """Variable-length allgather (the paper's FMI extension, §VI):
        count-allgather (one int64 per rank) followed by the payload."""
        self._check_world(xs)
        counts = [int(x.shape[0]) for x in xs]
        self._record(CollectiveKind.ALLGATHER, 8, algorithm=algorithm)
        out = torch.cat(list(xs), dim=0) if sum(counts) else xs[0][:0]
        self._record(
            CollectiveKind.ALLGATHERV, max(_nbytes(x) for x in xs),
            algorithm=algorithm,
        )
        return [out.clone() for _ in range(self.world_size)]

    def alltoall(
        self, sends: Sequence[Sequence[torch.Tensor]],
        algorithm: str | None = None,
    ) -> list[list[torch.Tensor]]:
        """sends[src][dst] -> recvs[dst][src]; equal-shape chunks."""
        self._check_world(sends)
        for row in sends:
            if len(row) != self.world_size:
                raise ValueError("alltoall needs a full P x P send matrix")
        bytes_per_rank = sum(_nbytes(b) for b in sends[0])
        self._record(CollectiveKind.ALLTOALL, bytes_per_rank, algorithm=algorithm)
        return self._route(sends)

    def alltoallv(
        self, sends: Sequence[Sequence[torch.Tensor]],
        algorithm: str | None = None,
    ) -> tuple[list[list[torch.Tensor]], torch.Tensor]:
        """Variable-length all-to-all — the shuffle primitive (paper §III-A).

        Returns (recvs[dst][src], counts matrix[src, dst] as a host int64
        tensor of row counts, read from the blocks' shapes).
        """
        self._check_world(sends)
        counts = torch.tensor(
            [[int(b.shape[0]) for b in row] for row in sends], dtype=torch.int64
        )
        # phase 1: exchange counts (an alltoall of one int per pair)
        self._record(CollectiveKind.ALLTOALL, self.world_size * 8, algorithm=algorithm)
        # phase 2: payload
        max_payload = max(sum(_nbytes(b) for b in row) for row in sends)
        self._record(CollectiveKind.ALLTOALLV, max_payload, algorithm=algorithm)
        return self._route(sends), counts

    def compressed_alltoallv(self, sends, algorithm: str | None = None):
        raise NotImplementedError(
            "compressed_alltoallv needs the compressed columnar codec, which is "
            "not ported yet (ROADMAP.md, queue A: A 3, the compressed codec)"
        )

    def bcast(
        self, x: torch.Tensor, root: int = 0, algorithm: str | None = None
    ) -> list[torch.Tensor]:
        self._check_rank(root)
        self._record(CollectiveKind.BCAST, _nbytes(x), algorithm=algorithm)
        return [x.clone() for _ in range(self.world_size)]

    def gather(
        self, xs: Sequence[torch.Tensor], root: int = 0,
        algorithm: str | None = None,
    ) -> list[list[torch.Tensor] | None]:
        """Rooted gather: ``out[root]`` is the list of every rank's
        contribution; non-root ranks receive ``None`` (MPI_Gather semantics).

        Wire pricing: the root's own contribution never leaves the node, so
        only ``(P-1)/P`` of the payload is charged; the event stores the
        exact wire total (``bytes_per_rank`` is a ceil-divided share).
        """
        self._check_world(xs)
        self._check_rank(root)
        wire = sum(_nbytes(x) for r, x in enumerate(xs) if r != root)
        self._record(
            CollectiveKind.GATHER, -(-wire // self.world_size),
            algorithm=algorithm, wire_total=wire,
        )
        gathered = [x.clone() for x in xs]
        return [gathered if r == root else None for r in range(self.world_size)]

    def scatter(
        self, chunks: Sequence[torch.Tensor], root: int = 0,
        algorithm: str | None = None,
    ) -> list[torch.Tensor]:
        """Rooted scatter: rank ``r`` receives only ``chunks[r]``; the root's
        chunk stays local, so ``(P-1)/P`` of the payload is charged (exact
        wire total stored on the event)."""
        self._check_world(chunks)
        self._check_rank(root)
        wire = sum(_nbytes(x) for r, x in enumerate(chunks) if r != root)
        self._record(
            CollectiveKind.SCATTER, -(-wire // self.world_size),
            algorithm=algorithm, wire_total=wire,
        )
        return [x.clone() for x in chunks]

    def send(self, x: torch.Tensor, dst: int, algorithm: str | None = None) -> None:
        self._check_rank(dst)
        self._record(CollectiveKind.P2P, _nbytes(x), algorithm=algorithm, peer=dst)

    # -- non-blocking surface (paper §VI: "our design called for non-blocking
    #    I/O"); simulation completes eagerly but preserves the handle protocol.

    def _issue(self, kind: str, res: Any) -> int:
        handle = self._next_handle
        self._next_handle += 1
        self._pending[handle] = (kind, res)
        return handle

    def iallreduce(self, xs: Sequence[torch.Tensor], op: Callable = torch.add) -> int:
        return self._issue("allreduce", self.allreduce(xs, op))

    def iallgather(self, xs: Sequence[torch.Tensor]) -> int:
        return self._issue("allgather", self.allgather(xs))

    def iallgatherv(self, xs: Sequence[torch.Tensor]) -> int:
        return self._issue("allgatherv", self.allgatherv(xs))

    def ialltoallv(self, sends: Sequence[Sequence[torch.Tensor]]) -> int:
        return self._issue("alltoallv", self.alltoallv(sends))

    def wait(self, handle: int) -> Any:
        """Complete a non-blocking op.  Handles are single-use: the result is
        released on wait and a second wait on the same handle raises."""
        try:
            kind, res = self._pending.pop(handle)
        except KeyError:
            raise ValueError(
                f"unknown or already-waited handle {handle!r} "
                f"(outstanding: {sorted(self._pending)})"
            ) from None
        return res

    @property
    def outstanding_handles(self) -> int:
        return len(self._pending)

    def ping(self, peer: int) -> bool:
        """Keepalive to prevent eager socket termination (paper §VI)."""
        self._check_rank(peer)
        self._record(CollectiveKind.P2P, 1, peer=peer)
        return True

    # -- helpers -------------------------------------------------------------

    def _route(self, sends: Sequence[Sequence[torch.Tensor]]) -> list[list[torch.Tensor]]:
        return [
            [sends[src][dst].clone() for src in range(self.world_size)]
            for dst in range(self.world_size)
        ]

    def _check_world(self, xs: Sequence[Any]) -> None:
        if len(xs) != self.world_size:
            raise ValueError(
                f"expected one entry per rank ({self.world_size}), got {len(xs)}"
            )

    def _check_rank(self, r: int) -> None:
        if not (0 <= r < self.world_size):
            raise ValueError(f"rank {r} out of range for world {self.world_size}")


def make_communicator(
    world_size: int,
    env: str = "direct",
    provider: str | netsim.ProviderProfile | None = None,
) -> Communicator:
    """Factory mirroring the paper's ``env`` switch (Listing 1: 'fmi' /
    'fmi-cylon' / storage channels).  ``provider`` names a
    :class:`~repro_torch.core.netsim.ProviderProfile` instead — the communicator
    then rides that provider's direct channel."""
    if provider is not None:
        channel = netsim.resolve_provider(provider).direct
    else:
        channel = netsim.resolve_channel(env)
    return Communicator(world_size, channel)
