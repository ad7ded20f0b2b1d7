"""Unified modeled-clock timeline: spans on per-rank lanes — the port's own
copy of ``repro.core.trace`` (the same spans, JSON and Chrome export).

The paper's performance story (Figs 10-16) is ultimately a claim about
where modeled time goes — bootstrap, punch waves, collective rounds, store
round trips, local compute.  Before this module the repo accounted for
those in disconnected silos (``CommEvent`` logs, ``StoreOp`` logs,
``SuperstepReport`` float sums, ``JobReport`` task timelines).  A
:class:`Tracer` is the one timeline they all emit onto:

- a :class:`Span` is ``(rank, lane, t0, t1, kind, nbytes, usd, meta)`` on
  the **modeled** clock (simulated seconds, not host wall time);
- lanes are a fixed vocabulary per rank: ``compute`` / ``comm`` / ``store``
  / ``bootstrap`` / ``overhead``;
- scheduling is **lane-exclusive and monotone**: two spans on the same
  ``(rank, lane)`` may never overlap, and each lane's spans are appended in
  non-decreasing start order.  Violations raise :class:`TraceError` at
  emission time — a mispriced schedule fails loudly instead of silently
  double-counting.

Emitters
--------
``CommSession.attach_tracer`` mirrors every priced :class:`CommEvent`
(collectives -> ``comm`` lane, session lifecycle -> ``bootstrap`` lane);
``Store.attach_tracer`` mirrors :class:`StoreOp`s onto the ``store`` lane;
``launch.train`` lays rank 0's per-step compute, data-fetch and modeled
gradient all-reduce spans (the reference's ``BSPRuntime`` and
``JobExecutor`` emitters come with their ports).  The existing event/op
lists stay exactly as they were — thin views the tests and cost model
already consume — the tracer is the cross-layer composition of them.

Exports
-------
``to_chrome()`` emits ``chrome://tracing``-loadable JSON ("X" complete
events, pid = rank, tid = lane); ``to_json()``/``from_json`` round-trip
the raw timeline; ``critical_path()`` reports the longest rank-serialized
chain (per superstep when spans carry ``step`` metadata).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable
from typing import Any

LANES = ("compute", "comm", "store", "bootstrap", "overhead")

# absolute slack for float accumulation when validating lane monotonicity;
# modeled times are sums of O(1e3) doubles, so 1 ns of slack is generous
_EPS = 1e-9


class TraceError(ValueError):
    """A span violated lane-exclusive / monotone scheduling."""


# ---------------------------------------------------------------------------
# audit sinks — how the sanitizers see every tracer that gets built
# ---------------------------------------------------------------------------
#
# A sanitizer or a test harness that needs "every Tracer this process
# constructs" registers a sink here instead of threading a handle through
# every layer.  A sink is any callable taking the new Tracer; registration
# is process-global and cheap (one list append per Tracer.__init__).  This
# registry is the port's own: sinks registered with the reference's
# ``repro.core.trace`` never see a port Tracer, and vice versa.

_audit_sinks: list = []


def register_audit_sink(sink) -> None:
    """Call ``sink(tracer)`` for every :class:`Tracer` constructed from now
    on (sanitizer hook; pair with :func:`unregister_audit_sink`)."""
    _audit_sinks.append(sink)


def unregister_audit_sink(sink) -> None:
    """Remove a sink registered via :func:`register_audit_sink` (no-op when
    it was already removed)."""
    try:
        _audit_sinks.remove(sink)
    except ValueError:
        pass


@dataclasses.dataclass(frozen=True)
class Span:
    """One scheduled interval on a rank's lane (modeled seconds)."""

    rank: int
    lane: str
    t0: float
    t1: float
    kind: str
    nbytes: int = 0
    usd: float = 0.0
    meta: tuple = ()  # sorted (key, value) pairs; dict view via .meta_dict

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    @property
    def meta_dict(self) -> dict:
        return dict(self.meta)


class Tracer:
    """Append-only span timeline enforcing per-(rank, lane) exclusivity.

    The tracer is a *scheduler's ledger*, not a scheduler: callers decide
    where spans go (``t0=None`` means "at this lane's cursor") and the
    tracer enforces that the resulting per-lane schedule is physical —
    exclusive and monotone on the modeled clock.
    """

    def __init__(self):
        self.spans: list[Span] = []
        self._cursor: dict[tuple[int, str], float] = {}
        # event-sequence counter: every group-synchronized event (one
        # CommEvent mirrored to all its ranks, one BSP barrier, ...) stamps
        # the same ``eseq`` into each of its per-rank spans, so an exported
        # timeline keeps the event<->span linkage the tracecheck race
        # detector groups on (heuristic grouping is the fallback for
        # pre-linkage artifacts)
        self._next_eseq = 0
        for _sink in list(_audit_sinks):
            _sink(self)

    # -- scheduling ----------------------------------------------------------

    def lane_end(self, rank: int, lane: str) -> float:
        """Modeled time at which ``(rank, lane)`` becomes free."""
        return self._cursor.get((int(rank), lane), 0.0)

    @property
    def end_s(self) -> float:
        """Latest scheduled instant across every lane (0.0 when empty)."""
        return max(self._cursor.values(), default=0.0)

    def group_free_at(self, ranks: Iterable[int], lane: str) -> float:
        """Earliest instant every listed rank's ``lane`` is free — where a
        synchronizing event (a collective) can start."""
        return max((self.lane_end(r, lane) for r in ranks), default=0.0)

    def next_event_seq(self) -> int:
        """Allot one event-sequence id (the span-group linkage key): every
        per-rank span mirrored from the same synchronizing event carries the
        same ``eseq`` meta value."""
        seq = self._next_eseq
        self._next_eseq += 1
        return seq

    def span(
        self,
        rank: int,
        lane: str,
        kind: str,
        *,
        t0: float | None = None,
        duration_s: float | None = None,
        t1: float | None = None,
        nbytes: int = 0,
        usd: float = 0.0,
        **meta: Any,
    ) -> Span:
        """Schedule one span; ``t0=None`` places it at the lane cursor.

        Give exactly one of ``duration_s`` / ``t1``.  Raises
        :class:`TraceError` when the span would start before the lane's
        cursor (overlap with an already-scheduled span) or end before it
        starts.
        """
        if lane not in LANES:
            raise TraceError(f"unknown lane {lane!r}; lanes: {LANES}")
        if (duration_s is None) == (t1 is None):
            raise TraceError("give exactly one of duration_s= / t1=")
        rank = int(rank)
        cur = self.lane_end(rank, lane)
        if t0 is None:
            t0 = cur
        t0 = float(t0)
        if t0 < cur - _EPS:
            raise TraceError(
                f"span {kind!r} starts at {t0:.9f}s but ({rank}, {lane}) is "
                f"busy until {cur:.9f}s — lanes are exclusive"
            )
        t1 = t0 + float(duration_s) if t1 is None else float(t1)
        if t1 < t0 - _EPS:
            raise TraceError(f"span {kind!r} ends ({t1}) before it starts ({t0})")
        sp = Span(
            rank, lane, t0, max(t1, t0), kind,
            nbytes=int(nbytes), usd=float(usd),
            meta=tuple(sorted(meta.items())),
        )
        self.spans.append(sp)
        self._cursor[(rank, lane)] = sp.t1
        return sp

    # -- event/op mirroring (the thin-view bridge) ---------------------------

    def ingest_comm_event(self, ev, ranks: Iterable[int], t0: float | None = None):
        """Mirror one :class:`~repro_torch.core.communicator.CommEvent` onto every
        participating rank — ``bootstrap`` lane for session lifecycle
        events, ``overhead`` for failure-detector probes, ``comm`` for
        collectives.  A collective synchronizes its group, so all ranks get
        the same interval, starting no earlier than any member's lane
        cursor."""
        kindv = ev.kind.value
        lane = ("bootstrap" if kindv == "bootstrap"
                else "overhead" if kindv == "detect" else "comm")
        ranks = [int(r) for r in ranks]
        if t0 is None:
            t0 = self.group_free_at(ranks, lane)
        seq = self.next_event_seq()
        out = []
        for r in ranks:
            out.append(self.span(
                r, lane, kindv if lane == "comm" else ev.algo,
                t0=max(t0, self.lane_end(r, lane)),
                duration_s=ev.time_s, nbytes=ev.total_bytes,
                algo=ev.algo, relay=ev.relay, relayed_pairs=ev.relayed_pairs,
                world=ev.world, eseq=seq,
            ))
        return out

    def ingest_store_op(self, op, rank: int = 0, usd: float = 0.0):
        """Mirror one :class:`~repro_torch.dist.object_store.StoreOp` onto the
        rank's ``store`` lane at its cursor."""
        return self.span(
            rank, "store", op.kind, duration_s=op.time_s,
            nbytes=op.nbytes, usd=usd, key=op.key,
        )

    # -- accounting ----------------------------------------------------------

    def lane_time_s(self, lane: str, rank: int | None = None) -> float:
        """Summed span durations on ``lane`` (one rank, or all ranks)."""
        return float(sum(
            s.duration_s for s in self.spans
            if s.lane == lane and (rank is None or s.rank == int(rank))
        ))

    def lane_usd(self, lane: str | None = None) -> float:
        return float(sum(
            s.usd for s in self.spans if lane is None or s.lane == lane
        ))

    def ranks(self) -> tuple[int, ...]:
        return tuple(sorted({s.rank for s in self.spans}))

    # -- analysis ------------------------------------------------------------

    def critical_path(self) -> dict:
        """Longest rank-serialized chain on the timeline.

        Each rank's chain is the serialized sum of its span durations (its
        lanes run on one modeled worker); the critical rank is the argmax.
        When spans carry ``step`` metadata (the BSP runtime stamps its
        superstep index) the result also breaks the chain down per
        superstep, so "which rank gated superstep k, and in which lane"
        reads straight off the report.
        """
        per_rank: dict[int, float] = {}
        per_rank_lane: dict[int, dict[str, float]] = {}
        steps: dict[int, dict[int, float]] = {}
        for s in self.spans:
            per_rank[s.rank] = per_rank.get(s.rank, 0.0) + s.duration_s
            per_rank_lane.setdefault(s.rank, {})
            per_rank_lane[s.rank][s.lane] = (
                per_rank_lane[s.rank].get(s.lane, 0.0) + s.duration_s
            )
            step = s.meta_dict.get("step")
            if step is not None:
                steps.setdefault(int(step), {})
                steps[int(step)][s.rank] = (
                    steps[int(step)].get(s.rank, 0.0) + s.duration_s
                )
        if not per_rank:
            return {"total_s": 0.0, "rank": None, "lanes": {}, "steps": []}
        crit = max(per_rank, key=lambda r: per_rank[r])
        step_rows = []
        for idx in sorted(steps):
            chains = steps[idx]
            r = max(chains, key=lambda k: chains[k])
            step_rows.append({"step": idx, "rank": r, "chain_s": chains[r]})
        return {
            "total_s": per_rank[crit],
            "rank": crit,
            "lanes": dict(sorted(per_rank_lane[crit].items())),
            "steps": step_rows,
        }

    # -- export --------------------------------------------------------------

    def to_json(self) -> dict:
        """Raw round-trippable timeline (see :meth:`from_json`)."""
        return {
            "version": 1,
            "spans": [
                {
                    "rank": s.rank, "lane": s.lane, "t0": s.t0, "t1": s.t1,
                    "kind": s.kind, "nbytes": s.nbytes, "usd": s.usd,
                    "meta": dict(s.meta),
                }
                for s in self.spans
            ],
        }

    @classmethod
    def from_json(cls, payload: dict) -> Tracer:
        """Rebuild a tracer from :meth:`to_json` output, re-validating the
        lane invariants (a hand-edited timeline that overlaps fails here)."""
        tr = cls()
        spans = sorted(payload["spans"], key=lambda d: (d["t0"], d["t1"]))
        for d in spans:
            tr.span(
                d["rank"], d["lane"], d["kind"], t0=d["t0"], t1=d["t1"],
                nbytes=d.get("nbytes", 0), usd=d.get("usd", 0.0),
                **d.get("meta", {}),
            )
        # resume the event-sequence linkage past the imported groups, so
        # events ingested after a round-trip cannot collide with them
        seqs = [
            d["meta"]["eseq"] for d in spans
            if "eseq" in d.get("meta", {})
        ]
        tr._next_eseq = max(seqs, default=-1) + 1
        return tr

    def to_chrome(self) -> dict:
        """``chrome://tracing`` / Perfetto-loadable Trace Event JSON.

        One complete ("X") event per span: ``pid`` = rank, ``tid`` = lane,
        timestamps in microseconds of modeled time.  Lane/process names are
        emitted as metadata events so the viewer labels rows readably.
        """
        events: list[dict] = []
        for rank in self.ranks():
            events.append({
                "ph": "M", "name": "process_name", "pid": rank, "tid": 0,
                "args": {"name": f"rank {rank}"},
            })
        seen_tids = set()
        for s in self.spans:
            tid = LANES.index(s.lane)
            if (s.rank, tid) not in seen_tids:
                seen_tids.add((s.rank, tid))
                events.append({
                    "ph": "M", "name": "thread_name", "pid": s.rank,
                    "tid": tid, "args": {"name": s.lane},
                })
            events.append({
                "ph": "X", "name": s.kind, "cat": s.lane,
                "pid": s.rank, "tid": tid,
                "ts": s.t0 * 1e6, "dur": s.duration_s * 1e6,
                "args": {"nbytes": s.nbytes, "usd": s.usd, **dict(s.meta)},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}
