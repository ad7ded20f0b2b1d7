"""The serverless communicator (paper §III-E) — the port's own copy of the
subset of ``repro.core.communicator`` the distributed join and groupby need.

A :class:`Communicator` provides MPI-style collectives for a world of P
simulated ranks over per-rank lists of **device tensors**: data moves between
ranks without leaving the device, and every collective is logged as a priced
:class:`CommEvent` under the channel's alpha-beta model, exactly as the
reference prices it.  This copy covers an implicit all-direct world (every
pair on ``channel``); sessions, ``split``, hybrid/relayed pricing, the other
collectives and the tracer are not ported yet.

Every collective takes ``algorithm=`` — ``"auto"`` (default) asks the tuned
engine for the min-modeled-time schedule, ``"fixed"`` prices the calibrated
paper schedule, any other name prices that schedule; the choice lands in
``CommEvent.algo``.
"""

from __future__ import annotations

import dataclasses
import enum
from collections.abc import Sequence

import torch

from repro_torch.core import algorithms as _algorithms
from repro_torch.core import netsim


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


@dataclasses.dataclass
class CommEvent:
    """One priced communication event (the unit of the §IV time/cost model).

    ``bytes_per_rank`` is what crossed the wire; ``raw_bytes`` is the logical
    payload before compression (the wire bytes, until a codec is ported).
    ``algo`` is the schedule the engine chose to price this event.
    """

    kind: CollectiveKind
    world: int
    bytes_per_rank: int     # payload owned by one rank entering the collective
    time_s: float           # modeled wall time under this backend's channel
    raw_bytes: int | None = None  # pre-codec payload per rank; None => wire
    algo: str = "fixed"     # schedule chosen by the engine for this event

    def __post_init__(self):
        if self.raw_bytes is None:
            self.raw_bytes = self.bytes_per_rank

    @property
    def total_bytes(self) -> int:
        return self.bytes_per_rank * self.world

    @property
    def total_raw_bytes(self) -> int:
        return self.raw_bytes * self.world


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class Communicator:
    """MPI-style collectives over P simulated ranks with priced events.

    Arguments
    ---------
    world_size: number of ranks.
    channel:    a :class:`netsim.ChannelModel` (direct / redis / s3) that
                prices each collective; defaults to Lambda direct TCP.
    algorithm:  default schedule for every collective — "auto" (tuned
                engine), "fixed" (calibrated paper schedule), or a named
                schedule; overridable per call.
    """

    def __init__(
        self,
        world_size: int,
        channel: netsim.ChannelModel | None = None,
        algorithm: str = "auto",
    ):
        if world_size < 1:
            raise ValueError("world_size must be >= 1")
        self.world_size = int(world_size)
        self.channel = channel or netsim.LAMBDA_DIRECT
        self.algorithm = algorithm
        self.events: list[CommEvent] = []

    # -- accounting ---------------------------------------------------------

    def _price(
        self, kind: CollectiveKind, bytes_per_rank: int, algorithm: str | None = None,
    ) -> tuple[str, float]:
        """(schedule name, modeled seconds) for one all-direct collective."""
        algorithm = self.algorithm if algorithm is None else algorithm
        if algorithm == "fixed":
            return "fixed", netsim.collective_time(
                self.channel, kind.value, self.world_size, bytes_per_rank
            )
        if algorithm == "auto":
            choice = _algorithms.select_algorithm(
                kind.value, self.world_size, bytes_per_rank, self.channel
            )
            return choice.algorithm, choice.time_s
        return algorithm, _algorithms.algorithm_time(
            self.channel, kind.value, self.world_size, bytes_per_rank, algorithm
        )

    def _record(
        self, kind: CollectiveKind, bytes_per_rank: int, algorithm: str | None = None,
    ) -> CommEvent:
        algo_name, t = self._price(kind, bytes_per_rank, algorithm)
        ev = CommEvent(kind, self.world_size, int(bytes_per_rank), t, algo=algo_name)
        self.events.append(ev)
        return ev

    @property
    def comm_time_s(self) -> float:
        """Priced collective time of the event log."""
        return float(sum(e.time_s for e in self.events))

    @property
    def bytes_on_wire(self) -> int:
        mult = 2 if self.channel.staged else 1
        return mult * int(sum(e.total_bytes for e in self.events))

    @property
    def raw_bytes_on_wire(self) -> int:
        """Logical (pre-codec) bytes for the same event log."""
        mult = 2 if self.channel.staged else 1
        return mult * int(sum(e.total_raw_bytes for e in self.events))

    def reset_events(self) -> None:
        self.events.clear()

    # -- collectives ----------------------------------------------------------

    def barrier(self, algorithm: str | None = None) -> None:
        self._record(CollectiveKind.BARRIER, 0, algorithm=algorithm)

    def alltoall(
        self, sends: Sequence[Sequence[torch.Tensor]], algorithm: str | None = None,
    ) -> list[list[torch.Tensor]]:
        """sends[src][dst] -> recvs[dst][src]; equal-shape chunks.  Receivers
        get the senders' tensors (no copy; nothing here writes to them)."""
        self._check_world(sends)
        for row in sends:
            if len(row) != self.world_size:
                raise ValueError("alltoall needs a full P x P send matrix")
        bytes_per_rank = sum(_nbytes(b) for b in sends[0])
        self._record(CollectiveKind.ALLTOALL, bytes_per_rank, algorithm=algorithm)
        return self._route(sends)

    def alltoallv(
        self, sends: Sequence[Sequence[torch.Tensor]], algorithm: str | None = None,
    ) -> tuple[list[list[torch.Tensor]], torch.Tensor]:
        """Variable-length all-to-all — the shuffle primitive.

        Returns (recvs[dst][src], counts matrix[src, dst] as a CPU int64
        tensor of row counts).  Blocks stay on their device.
        """
        self._check_world(sends)
        counts = torch.tensor([[b.shape[0] for b in row] for row in sends], dtype=torch.int64)
        # phase 1: exchange counts (an alltoall of one int per pair)
        self._record(CollectiveKind.ALLTOALL, self.world_size * 8, algorithm=algorithm)
        # phase 2: payload
        max_payload = max(sum(_nbytes(b) for b in row) for row in sends)
        self._record(CollectiveKind.ALLTOALLV, max_payload, algorithm=algorithm)
        return self._route(sends), counts

    # -- helpers -------------------------------------------------------------

    def _route(self, sends: Sequence[Sequence[torch.Tensor]]) -> list[list[torch.Tensor]]:
        return [
            [sends[src][dst] for src in range(self.world_size)]
            for dst in range(self.world_size)
        ]

    def _check_world(self, xs: Sequence) -> None:
        if len(xs) != self.world_size:
            raise ValueError(
                f"expected one entry per rank ({self.world_size}), got {len(xs)}"
            )


def make_communicator(world_size: int, env: str = "direct") -> Communicator:
    """Factory mirroring the paper's ``env`` switch (direct / redis / s3)."""
    return Communicator(world_size, netsim.resolve_channel(env))
