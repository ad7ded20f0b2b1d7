"""Happens-before race detector + accounting auditor over exported timelines.

The tracer enforces lane exclusivity *at emission time*; this module is the
independent re-derivation for *exported* artifacts — a trace that was
serialized, hand-edited, replayed from another process, or produced by a
buggy emitter.  It never trusts ``Tracer``'s own guards: everything is
recomputed from the raw span records.

Causality model
---------------
Every group-synchronized event (a collective, a barrier, a bootstrap wave)
stamps the same ``eseq`` meta value into each participating rank's span
(see :meth:`repro_torch.core.trace.Tracer.next_event_seq`).  The checker
reconstructs per-rank vector clocks by processing each rank's spans in
start order and merging clocks at every shared ``eseq`` group: rank r's
component of the clock is the end time of its latest local span, and a
synchronizing event carries every participant's component to every other
participant.  The observable consequence — and what the checker asserts —
is the interval law ``min(t1) + eps >= max(t0)`` over each group: no rank
may *finish* (consume the collective's result / exit the barrier) before
every peer has at least *started* (contributed its input / entered the
barrier).  Legacy traces without ``eseq`` linkage are grouped heuristically
by per-rank occurrence order of ``(lane, kind, algo, step, nbytes)``.

See :mod:`repro_torch.analysis` for the rule-code table.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

# keep in sync with repro_torch.core.trace.LANES — redeclared here so the checker
# stays importable without pulling the (torch-importing) core package in
LANES = ("compute", "comm", "store", "bootstrap", "overhead")

# float slack: modeled times are sums of O(1e3) doubles (see trace._EPS)
_EPS = 1e-9
# relative tolerance for dollar conservation (sums may fold in any order)
_USD_RTOL = 1e-9


@dataclasses.dataclass(frozen=True)
class Violation:
    """One broken invariant, locatable on the timeline.

    ``rule`` is an ``RPT###`` code from the :mod:`repro_torch.analysis` table;
    ``rank``/``lane``/``t0``/``kind`` locate the offending span when the
    violation is span-shaped (accounting violations may be trace-global).
    """

    rule: str
    message: str
    rank: int | None = None
    lane: str | None = None
    t0: float | None = None
    kind: str | None = None

    def __str__(self) -> str:
        where = ""
        if self.rank is not None:
            where = f" [rank {self.rank}"
            if self.lane is not None:
                where += f"/{self.lane}"
            if self.t0 is not None:
                where += f" @ {self.t0:.6f}s"
            where += "]"
        return f"{self.rule}{where}: {self.message}"


def format_violations(violations: list[Violation], source: str = "") -> str:
    """Ruff-style one-line-per-violation report (``source`` prefixes each)."""
    prefix = f"{source}: " if source else ""
    return "\n".join(f"{prefix}{v}" for v in violations)


# ---------------------------------------------------------------------------
# input coercion
# ---------------------------------------------------------------------------


def _coerce_spans(trace: Any) -> list[dict]:
    """Normalize any accepted trace form to a list of raw span dicts.

    Accepts a :class:`repro_torch.core.trace.Tracer`, its ``to_json()`` payload,
    a bare span-dict list, or a path to a JSON artifact.  No validation
    happens here beyond shape — the checks do the judging.
    """
    if isinstance(trace, str | os.PathLike):
        with open(trace, encoding="utf-8") as fh:
            trace = json.load(fh)
    if hasattr(trace, "spans"):  # a live Tracer (duck-typed: no core import)
        return [
            {
                "rank": s.rank, "lane": s.lane, "t0": s.t0, "t1": s.t1,
                "kind": s.kind, "nbytes": s.nbytes, "usd": s.usd,
                "meta": dict(s.meta),
            }
            for s in trace.spans
        ]
    if isinstance(trace, dict):
        trace = trace.get("spans", [])
    return list(trace)


# ---------------------------------------------------------------------------
# span-local structure: schema, lane exclusivity, monotone clocks
# ---------------------------------------------------------------------------


def _check_schema(spans: list[dict]) -> list[Violation]:
    out = []
    for i, s in enumerate(spans):
        if not isinstance(s, dict):
            out.append(Violation("RPT003", f"span #{i} is not a record: {s!r}"))
            continue
        missing = [k for k in ("rank", "lane", "t0", "t1", "kind") if k not in s]
        if missing:
            out.append(Violation(
                "RPT003", f"span #{i} missing field(s) {missing}: {s!r}"))
            continue
        if s["lane"] not in LANES:
            out.append(Violation(
                "RPT003",
                f"unknown lane {s['lane']!r} (lanes: {LANES})",
                rank=s.get("rank"), lane=None, t0=s.get("t0"),
                kind=s.get("kind"),
            ))
    return out


def _well_formed(spans: list[dict]) -> list[dict]:
    return [
        s for s in spans
        if isinstance(s, dict)
        and all(k in s for k in ("rank", "lane", "t0", "t1", "kind"))
        and s["lane"] in LANES
    ]


def _check_lanes(spans: list[dict]) -> list[Violation]:
    """RPT001 (lane exclusivity) + RPT002 (monotone modeled clock)."""
    out = []
    lanes: dict[tuple[int, str], list[dict]] = {}
    for s in spans:
        lanes.setdefault((s["rank"], s["lane"]), []).append(s)
    for (rank, lane), ss in sorted(lanes.items(), key=lambda kv: kv[0]):
        ss = sorted(ss, key=lambda s: (s["t0"], s["t1"]))
        prev = None
        for s in ss:
            if s["t0"] < -_EPS:
                out.append(Violation(
                    "RPT002",
                    f"span {s['kind']!r} starts before the epoch "
                    f"(t0={s['t0']:.9f}s < 0)",
                    rank=rank, lane=lane, t0=s["t0"], kind=s["kind"],
                ))
            if s["t1"] < s["t0"] - _EPS:
                out.append(Violation(
                    "RPT002",
                    f"span {s['kind']!r} ends ({s['t1']:.9f}s) before it "
                    f"starts ({s['t0']:.9f}s)",
                    rank=rank, lane=lane, t0=s["t0"], kind=s["kind"],
                ))
            if prev is not None and s["t0"] < prev["t1"] - _EPS:
                out.append(Violation(
                    "RPT001",
                    f"span {s['kind']!r} starts at {s['t0']:.9f}s while "
                    f"{prev['kind']!r} holds the lane until "
                    f"{prev['t1']:.9f}s — lanes are exclusive",
                    rank=rank, lane=lane, t0=s["t0"], kind=s["kind"],
                ))
            prev = s
    return out


def _check_span_accounting(spans: list[dict]) -> list[Violation]:
    """RPT007: negative dollars / bytes on a span."""
    out = []
    for s in spans:
        if float(s.get("usd", 0.0)) < -_USD_RTOL:
            out.append(Violation(
                "RPT007", f"span {s['kind']!r} bills negative ${s['usd']}",
                rank=s["rank"], lane=s["lane"], t0=s["t0"], kind=s["kind"],
            ))
        if int(s.get("nbytes", 0) or 0) < 0:
            out.append(Violation(
                "RPT007", f"span {s['kind']!r} moves negative bytes "
                f"({s['nbytes']})",
                rank=s["rank"], lane=s["lane"], t0=s["t0"], kind=s["kind"],
            ))
    return out


# ---------------------------------------------------------------------------
# happens-before: collective / barrier causality via span groups
# ---------------------------------------------------------------------------


def _event_groups(spans: list[dict]) -> list[list[dict]]:
    """Group per-rank spans that mirror the same synchronizing event.

    Spans carrying ``eseq`` linkage (exported by this repo since the
    analysis subsystem landed) group exactly.  Legacy spans group
    heuristically: the i-th occurrence, in per-rank start order, of the
    same ``(lane, kind, algo, step, nbytes)`` signature is taken to be the
    same event on every rank — which matches how every emitter in-tree
    lays synchronized spans (identical emission order on all ranks).
    Only spans carrying an ``algo`` meta join a legacy group: every
    event-mirrored span records its schedule, while hand-placed spans
    (arbitrary per-rank work that merely shares a kind string) do not
    synchronize anything and must not be cross-rank constrained.
    """
    linked: dict[Any, list[dict]] = {}
    legacy: dict[tuple, list[dict]] = {}
    occurrence: dict[tuple, int] = {}
    for s in spans:
        meta = s.get("meta", {}) or {}
        if "eseq" in meta:
            linked.setdefault(meta["eseq"], []).append(s)
            continue
        if s["lane"] not in ("comm", "bootstrap", "overhead"):
            continue
        if meta.get("algo") is None:
            continue
        sig = (
            s["lane"], s["kind"], meta.get("algo"), meta.get("step"),
            s.get("nbytes", 0),
        )
        occ = occurrence.get((s["rank"], *sig), 0)
        occurrence[(s["rank"], *sig)] = occ + 1
        legacy.setdefault((*sig, occ), []).append(s)
    groups = [g for g in linked.values() if len(g) > 1]
    groups += [g for g in legacy.values() if len(g) > 1]
    return groups


def _check_causality(spans: list[dict]) -> list[Violation]:
    """RPT004/RPT005: a rank exits a synchronized event before a peer enters.

    The vector-clock merge at a collective makes every participant's exit
    depend on every participant's entry, so the group intervals must
    satisfy ``min(t1) + eps >= max(t0)``.  ``RPT005`` is the barrier
    specialization (exit before the slowest entrant); everything else is
    ``RPT004``.
    """
    out = []
    for group in _event_groups(spans):
        # per-rank spans in the group must agree on what the event was
        kinds = {s["kind"] for s in group}
        if len(kinds) > 1:
            s = group[0]
            out.append(Violation(
                "RPT003",
                f"event group mixes span kinds {sorted(kinds)} — the "
                f"event<->span linkage is corrupt",
                rank=s["rank"], lane=s["lane"], t0=s["t0"], kind=s["kind"],
            ))
            continue
        first_out = min(group, key=lambda s: s["t1"])
        last_in = max(group, key=lambda s: s["t0"])
        if first_out["t1"] + _EPS < last_in["t0"]:
            kind = first_out["kind"]
            if kind == "barrier":
                out.append(Violation(
                    "RPT005",
                    f"rank {first_out['rank']} exits barrier at "
                    f"{first_out['t1']:.9f}s before the slowest entrant "
                    f"(rank {last_in['rank']}) arrives at "
                    f"{last_in['t0']:.9f}s",
                    rank=first_out["rank"], lane=first_out["lane"],
                    t0=first_out["t0"], kind=kind,
                ))
            else:
                out.append(Violation(
                    "RPT004",
                    f"rank {first_out['rank']} consumes {kind!r} at "
                    f"{first_out['t1']:.9f}s before rank "
                    f"{last_in['rank']}'s matching span could have started "
                    f"({last_in['t0']:.9f}s) — result before every input",
                    rank=first_out["rank"], lane=first_out["lane"],
                    t0=first_out["t0"], kind=kind,
                ))
    return out


def _check_store_causality(spans: list[dict]) -> list[Violation]:
    """RPT006: a restore (store GET) precedes the publish (PUT) of its key.

    Keys with no in-trace PUT are skipped — data that predates the trace
    is legitimately readable.  Multiple PUTs of one key (re-save windows)
    anchor on the earliest publish.
    """
    puts: dict[str, float] = {}
    for s in spans:
        if s["lane"] != "store" or s["kind"] != "put":
            continue
        key = (s.get("meta", {}) or {}).get("key")
        if key is not None:
            puts[key] = min(puts.get(key, float("inf")), s["t1"])
    out = []
    for s in spans:
        if s["lane"] != "store" or s["kind"] != "get":
            continue
        key = (s.get("meta", {}) or {}).get("key")
        if key is None or key not in puts:
            continue
        if s["t0"] + _EPS < puts[key]:
            out.append(Violation(
                "RPT006",
                f"restore of {key!r} starts at {s['t0']:.9f}s but its "
                f"earliest publish commits at {puts[key]:.9f}s",
                rank=s["rank"], lane=s["lane"], t0=s["t0"], kind=s["kind"],
            ))
    return out


# ---------------------------------------------------------------------------
# event-log audit (CommEvent conservation laws)
# ---------------------------------------------------------------------------


def check_events(events) -> list[Violation]:
    """Audit a priced :class:`~repro_torch.core.communicator.CommEvent` log.

    RPT009: wire bytes may never exceed logical bytes (compression can only
    shrink the wire; a codec that inflates is a pricing bug).  RPT011:
    negative modeled time / empty world / negative byte counts.
    """
    out = []
    for i, ev in enumerate(events):
        tag = f"event #{i} {getattr(ev.kind, 'value', ev.kind)}/{ev.algo}"
        if ev.total_bytes > ev.total_raw_bytes:
            out.append(Violation(
                "RPT009",
                f"{tag}: wire bytes {ev.total_bytes} exceed logical bytes "
                f"{ev.total_raw_bytes}",
            ))
        if ev.time_s < 0.0:
            out.append(Violation(
                "RPT011", f"{tag}: negative modeled time {ev.time_s}"))
        if ev.world < 1:
            out.append(Violation(
                "RPT011", f"{tag}: world {ev.world} < 1"))
        if ev.bytes_per_rank < 0 or ev.raw_bytes < 0:
            out.append(Violation(
                "RPT011",
                f"{tag}: negative byte count "
                f"({ev.bytes_per_rank}/{ev.raw_bytes})",
            ))
    return out


# ---------------------------------------------------------------------------
# dollar conservation: JobReport / heterogeneous_run_cost cross-checks
# ---------------------------------------------------------------------------


def _usd_close(a: float, b: float) -> bool:
    return abs(a - b) <= _USD_RTOL * max(abs(a), abs(b), 1.0)


def check_job(report, trace) -> list[Violation]:
    """RPT008: the job's lane dollars must equal its billed dollars.

    Sums ``Span.usd`` over every span stamped with the job's id (task
    attempts, retries, speculative backups, the reducer) and compares with
    ``JobReport.cost_usd`` — the double-entry check between the timeline
    ledger and the billing ledger.
    """
    spans = _well_formed(_coerce_spans(trace))
    lane_usd = sum(
        float(s.get("usd", 0.0)) for s in spans
        if (s.get("meta", {}) or {}).get("job") == report.job_id
    )
    if not _usd_close(lane_usd, report.cost_usd):
        return [Violation(
            "RPT008",
            f"job {report.job_id}: lane dollars ${lane_usd:.9f} != billed "
            f"${report.cost_usd:.9f} (a $-entry was dropped or double-"
            f"billed)",
        )]
    return []


def check_run_cost(report, session, cost=None, *, mem_gb: float = 10.0,
                   default_provider: str = "aws-lambda") -> list[Violation]:
    """Audit a :func:`~repro_torch.core.cost_model.heterogeneous_run_cost` bill.

    RPT008: the conservation identity ``total_usd == sum(per_rank_usd) +
    evicted_usd`` and the egress line item (relay bytes billed per endpoint
    rank — recomputed independently here).  RPT010: evicted spend must
    match a fresh recomputation from the run report — an evicted rank that
    bills past its eviction step, or eviction dollars that shrank, mean
    spend was resurrected or vanished after ``shrink``.
    """
    from repro_torch.core.cost_model import heterogeneous_run_cost, relay_egress_cost

    out = []
    fresh = heterogeneous_run_cost(
        report, session, mem_gb=mem_gb, default_provider=default_provider)
    cost = cost if cost is not None else fresh
    claimed = cost["total_usd"]
    parts = sum(cost["per_rank_usd"]) + cost.get("evicted_usd", 0.0)
    if not _usd_close(claimed, parts):
        out.append(Violation(
            "RPT008",
            f"total_usd ${claimed:.9f} != sum(per_rank_usd) + evicted_usd "
            f"${parts:.9f}",
        ))
    egress = sum(relay_egress_cost(
        session, default_provider=default_provider))
    if not _usd_close(cost.get("egress_usd", 0.0), egress):
        out.append(Violation(
            "RPT008",
            f"egress_usd ${cost.get('egress_usd', 0.0):.9f} != per-endpoint "
            f"relay egress recomputation ${egress:.9f}",
        ))
    if not _usd_close(cost.get("evicted_usd", 0.0), fresh["evicted_usd"]):
        out.append(Violation(
            "RPT010",
            f"evicted_usd ${cost.get('evicted_usd', 0.0):.9f} != "
            f"recomputed eviction bill ${fresh['evicted_usd']:.9f} — "
            f"evicted spend was resurrected or dropped after shrink",
        ))
    return out


# ---------------------------------------------------------------------------
# the composed entry point
# ---------------------------------------------------------------------------


def check_trace(
    trace,
    *,
    events=None,
    session=None,
    job=None,
    report=None,
    cost=None,
    mem_gb: float = 10.0,
    default_provider: str = "aws-lambda",
) -> list[Violation]:
    """Run every applicable audit; return all violations (empty == clean).

    ``trace`` is a live :class:`~repro_torch.core.trace.Tracer`, a ``to_json()``
    payload, a bare span list, or a path to an exported JSON artifact.
    The structural and causal checks always run; pass ``events=`` (or
    ``session=``, whose log is used) for the CommEvent conservation audit,
    ``job=`` (a :class:`~repro_torch.jobs.executor.JobReport`) for the lane-vs-
    billed dollar check, and ``report=``+``session=`` (optionally the
    ``cost=`` dict under audit) for the heterogeneous-run conservation
    laws.
    """
    spans = _coerce_spans(trace)
    out = _check_schema(spans)
    spans = _well_formed(spans)
    out += _check_lanes(spans)
    out += _check_span_accounting(spans)
    out += _check_causality(spans)
    out += _check_store_causality(spans)
    if events is None and session is not None:
        events = session.events
    if events is not None:
        out += check_events(events)
    if job is not None:
        out += check_job(job, spans)
    if report is not None and session is not None:
        out += check_run_cost(
            report, session, cost,
            mem_gb=mem_gb, default_provider=default_provider)
    return out
