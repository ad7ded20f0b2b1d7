"""Unified fault injection: one plan type for every execution surface — the
port's own copy of ``repro.core.faults`` (the same seeded draws, so a plan
kills, straggles and flaps the same ranks in both packages).

The paper's §V gap analysis (no fault tolerance on Lambda) gave this repo
two ad-hoc injection hooks on :meth:`core.bsp.BSPRuntime.run` —
``fail_injector(step, rank)`` and ``straggle_injector(step, rank)`` — and
the jobs layer needs the same adversary for its retry/speculation machinery.
A :class:`FaultPlan` folds both (plus a deadline) into one declarative,
*seedable* object accepted by ``BSPRuntime.run(faults=...)`` and
``JobExecutor.map(faults=...)``:

- ``kills``: scheduled worker deaths — ``(step, rank)`` or
  ``(step, rank, count)`` entries; the rank dies ``count`` times (default 1)
  at that step before succeeding (serverless re-invocation semantics).
- ``straggles``: scheduled delays — ``(step, rank, extra_s)`` entries add
  ``extra_s`` simulated seconds to that rank's step.
- ``kill_rate`` / ``straggle_rate`` + ``straggle_s``: random faults, drawn
  *per (step, rank) coordinate* from ``seed`` — deterministic and
  order-independent, so two runs of the same plan (or the same plan armed
  twice, e.g. a speculation-on vs speculation-off A/B) see identical
  adversaries.
- ``deadline_s``: per-attempt execution bound; a rank/task whose simulated
  time exceeds it is killed and re-invoked by the runtime.

Beyond worker-level faults, a plan can schedule *infrastructure* fault
domains — the failures the paper's §III-D flags (NAT/rendezvous churn) and
§V concedes (no tolerance for a dropped hole-punched link):

- ``link_flaps``: ``(step, a, b)`` or ``(step, a, b, "permanent")`` entries —
  the direct channel between ranks ``a`` and ``b`` dies at that step.  A
  transient flap recovers after a re-punch; a permanent one degrades the
  pair to its relay fallback (``LinkMap.degrade``).  ``flap_rate`` draws
  additional transient flaps per (step, pair) from the same seed.
- ``store_outages`` / ``rendezvous_outages``: half-open ``(start, end)``
  step windows during which relay/staged store traffic (resp. rendezvous
  registrations — re-punch, rebootstrap, expand, shrink) pay the retry
  penalty ``outage_penalty_s`` (``outage_retries`` exponential backoffs of
  ``outage_backoff_s``).  ``store_outage_rate`` / ``rendezvous_outage_rate``
  draw additional single-step outages.
- ``rank_losses``: ``(step, rank)`` entries — *permanent* worker loss (the
  host is gone, re-invocation cannot help).  ``BSPRuntime.run``'s
  ``recovery_policy`` decides the escalation: treat as a kill (``"retry"``),
  or detect → roll back → ``CommSession.shrink`` (``"shrink"`` /
  ``"rebootstrap"``).

Coordinate convention: the first axis is the *execution epoch* — the
superstep index under the BSP runtime, the attempt index (0 = first
invocation) under the jobs layer; the second axis is the worker identity —
the BSP rank, or the task index for a job.  So ``kills=((0, 3),)`` means
"rank/task 3 dies on its first try" on either surface.

``FaultPlan.from_injectors`` wraps the legacy callables so the old
``BSPRuntime.run(fail_injector=..., straggle_injector=...)`` kwargs remain
thin adapters over the same machinery.

Plans are immutable; :meth:`FaultPlan.armed` returns the stateful per-run
view (scheduled kill counts are consumed as they fire).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np

Injector = Callable[[int, int], bool]
Straggler = Callable[[int, int], float]

_KILL_TAG = 0x4B494C4C      # "KILL": namespaces the kill draws under seed
_STRAGGLE_TAG = 0x534C4F57  # "SLOW": namespaces the straggle draws
_FLAP_TAG = 0x464C4150      # "FLAP": namespaces link-flap draws
_STORE_OUT_TAG = 0x53544F52    # "STOR": store-outage draws
_RENDEZ_OUT_TAG = 0x52454E44   # "REND": rendezvous-outage draws


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative kill/straggle/deadline schedule (see module docstring)."""

    kills: tuple = ()                   # (step, rank[, count]) entries
    straggles: tuple = ()               # (step, rank, extra_s) entries
    kill_rate: float = 0.0              # P(first attempt dies) per coordinate
    straggle_rate: float = 0.0          # P(straggle) per coordinate
    straggle_s: float = 0.0             # delay added when a straggle fires
    deadline_s: float | None = None     # per-attempt execution bound
    seed: int = 0
    # infrastructure fault domains (see module docstring)
    link_flaps: tuple = ()              # (step, a, b[, "transient"|"permanent"])
    store_outages: tuple = ()           # half-open (start_step, end_step) windows
    rendezvous_outages: tuple = ()      # half-open (start_step, end_step) windows
    rank_losses: tuple = ()             # (step, rank): permanent worker loss
    flap_rate: float = 0.0              # P(transient flap) per (step, pair)
    store_outage_rate: float = 0.0      # P(single-step store outage) per step
    rendezvous_outage_rate: float = 0.0  # P(single-step rendezvous outage)
    outage_retries: int = 3             # backoff attempts an outage burns
    outage_backoff_s: float = 0.5       # first backoff; doubles per attempt
    # legacy adapters (FaultPlan.from_injectors); consulted before schedules
    fail_injector: Injector | None = None
    straggle_injector: Straggler | None = None

    def __post_init__(self):
        for k in self.kills:
            if len(k) not in (2, 3):
                raise ValueError(f"kill entry {k!r}: need (step, rank[, count])")
        for s in self.straggles:
            if len(s) != 3:
                raise ValueError(f"straggle entry {s!r}: need (step, rank, extra_s)")
        for f in self.link_flaps:
            if len(f) not in (3, 4):
                raise ValueError(
                    f"link_flap entry {f!r}: need (step, a, b[, mode])")
            if len(f) == 4 and f[3] not in ("transient", "permanent"):
                raise ValueError(
                    f"link_flap entry {f!r}: mode must be "
                    f"'transient' or 'permanent'")
            if int(f[1]) == int(f[2]):
                raise ValueError(f"link_flap entry {f!r}: a == b")
        for name in ("store_outages", "rendezvous_outages"):
            for w in getattr(self, name):
                if len(w) != 2 or not (int(w[0]) < int(w[1])):
                    raise ValueError(
                        f"{name} entry {w!r}: need (start, end) with "
                        f"start < end (half-open step window)")
        for e in self.rank_losses:
            if len(e) != 2:
                raise ValueError(f"rank_loss entry {e!r}: need (step, rank)")
        for name in ("kill_rate", "straggle_rate", "flap_rate",
                     "store_outage_rate", "rendezvous_outage_rate"):
            v = getattr(self, name)
            if not (0.0 <= v <= 1.0):
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.outage_retries < 1:
            raise ValueError("outage_retries must be >= 1")

    @classmethod
    def from_injectors(
        cls,
        fail_injector: Injector | None = None,
        straggle_injector: Straggler | None = None,
        deadline_s: float | None = None,
    ) -> FaultPlan:
        """Adapter for the legacy ``BSPRuntime.run`` injector callables."""
        return cls(
            fail_injector=fail_injector,
            straggle_injector=straggle_injector,
            deadline_s=deadline_s,
        )

    @classmethod
    def none(cls) -> FaultPlan:
        return cls()

    @property
    def any_faults(self) -> bool:
        return bool(
            self.kills or self.straggles or self.kill_rate or self.straggle_rate
            or self.fail_injector or self.straggle_injector
            or self.any_infra_faults
        )

    @property
    def any_infra_faults(self) -> bool:
        """True when any infrastructure domain (links/stores/rendezvous/
        permanent losses) can fire — the recovery machinery arms only then."""
        return bool(
            self.link_flaps or self.store_outages or self.rendezvous_outages
            or self.rank_losses or self.flap_rate or self.store_outage_rate
            or self.rendezvous_outage_rate
        )

    @property
    def outage_penalty_s(self) -> float:
        """Modeled seconds one outage hit costs: the full exponential-backoff
        retry ladder (every attempt inside the window fails, the op lands
        once the window lifts)."""
        return sum(self.outage_backoff_s * (2.0 ** i)
                   for i in range(self.outage_retries))

    def _draw(self, tag: int, *coords: int) -> float:
        # per-coordinate seeded draw: deterministic AND independent of the
        # order the runtime visits coordinates in — a retried or speculated
        # schedule sees the same adversary as a straight run
        rng = np.random.default_rng([self.seed, tag, *map(int, coords)])
        return float(rng.random())

    def armed(self) -> ArmedFaults:
        """Stateful per-run view (scheduled kills are consumed as they fire)."""
        return ArmedFaults(self)


class ArmedFaults:
    """One run's live fault state over an immutable :class:`FaultPlan`.

    Counters are kept *per source* (``injector`` / ``scheduled`` / ``rate``)
    so a coordinate where several sources contribute counts each of them —
    ``kills_fired`` / ``straggles_fired`` are the sums; :meth:`fired` exposes
    the full per-domain breakdown for benchmark assertions.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._kills: dict[tuple[int, int], int] = {}
        for entry in plan.kills:
            step, rank = int(entry[0]), int(entry[1])
            count = int(entry[2]) if len(entry) == 3 else 1
            self._kills[(step, rank)] = self._kills.get((step, rank), 0) + count
        self._rate_fired: set[tuple[int, int]] = set()
        self.kills_by_source = {"injector": 0, "scheduled": 0, "rate": 0}
        self.straggles_by_source = {"injector": 0, "scheduled": 0, "rate": 0}
        # infrastructure domains: scheduled entries + rate draws, each
        # (step, pair)/(step, rank) coordinate fires at most once
        self._flaps: dict[tuple[int, int, int], bool] = {}
        for entry in plan.link_flaps:
            step = int(entry[0])
            a, b = sorted((int(entry[1]), int(entry[2])))
            permanent = len(entry) == 4 and entry[3] == "permanent"
            self._flaps[(step, a, b)] = (
                self._flaps.get((step, a, b), False) or permanent)
        self._flap_fired: set[tuple[int, int, int]] = set()
        self._losses = {(int(s), int(r)) for s, r in plan.rank_losses}
        self._outage_hits: dict[str, set[int]] = {
            "store": set(), "rendezvous": set()}
        self.flaps_fired = 0
        self.losses_fired = 0

    @property
    def kills_fired(self) -> int:
        return sum(self.kills_by_source.values())

    @property
    def straggles_fired(self) -> int:
        return sum(self.straggles_by_source.values())

    def fail(self, step: int, rank: int) -> bool:
        """Does this (step/attempt, rank/task) attempt die?  Scheduled kills
        burn down their count; rate-based kills fire at most once per
        coordinate (the re-invocation then succeeds, serverless-style)."""
        plan = self.plan
        if plan.fail_injector is not None and plan.fail_injector(step, rank):
            self.kills_by_source["injector"] += 1
            return True
        key = (int(step), int(rank))
        remaining = self._kills.get(key, 0)
        if remaining > 0:
            self._kills[key] = remaining - 1
            self.kills_by_source["scheduled"] += 1
            return True
        if plan.kill_rate > 0.0 and key not in self._rate_fired:
            if plan._draw(_KILL_TAG, step, rank) < plan.kill_rate:
                self._rate_fired.add(key)
                self.kills_by_source["rate"] += 1
                return True
        return False

    def requeue_kill(self, step: int, rank: int) -> None:
        """Schedule one more kill at this coordinate (the ``retry`` recovery
        policy folds a permanent rank loss back into the attempt loop)."""
        key = (int(step), int(rank))
        self._kills[key] = self._kills.get(key, 0) + 1

    def extra_delay(self, step: int, rank: int) -> float:
        """Injected straggler seconds for this coordinate (0.0 when none).
        Each contributing source counts once — injector, scheduled entries,
        and the rate draw are independent stragglers hitting the same rank."""
        plan = self.plan
        extra = 0.0
        if plan.straggle_injector is not None:
            inj = float(plan.straggle_injector(step, rank))
            if inj:
                extra += inj
                self.straggles_by_source["injector"] += 1
        scheduled = 0.0
        for s_step, s_rank, s_extra in plan.straggles:
            if int(s_step) == int(step) and int(s_rank) == int(rank):
                scheduled += float(s_extra)
        if scheduled:
            extra += scheduled
            self.straggles_by_source["scheduled"] += 1
        if plan.straggle_rate > 0.0 and plan.straggle_s > 0.0:
            if plan._draw(_STRAGGLE_TAG, step, rank) < plan.straggle_rate:
                extra += plan.straggle_s
                self.straggles_by_source["rate"] += 1
        return extra

    # -- infrastructure domains ------------------------------------------

    def link_flaps_at(self, step: int, world: int) -> list:
        """Link flaps firing at this step: scheduled entries plus
        ``flap_rate`` draws over every pair — each (step, pair) coordinate
        fires once.  Returns sorted ``(a, b, permanent)`` triples."""
        plan = self.plan
        step = int(step)
        out = []
        for (s, a, b), permanent in sorted(self._flaps.items()):
            if s == step and (s, a, b) not in self._flap_fired:
                self._flap_fired.add((s, a, b))
                self.flaps_fired += 1
                out.append((a, b, permanent))
        if plan.flap_rate > 0.0:
            for a in range(world):
                for b in range(a + 1, world):
                    key = (step, a, b)
                    if key in self._flap_fired:
                        continue
                    if plan._draw(_FLAP_TAG, step, a, b) < plan.flap_rate:
                        self._flap_fired.add(key)
                        self.flaps_fired += 1
                        out.append((a, b, False))
        return sorted(out)

    def rank_loss(self, step: int, rank: int) -> bool:
        """Permanent worker loss at this coordinate (fires once; consumed
        by the shrink/rebootstrap recovery policies)."""
        key = (int(step), int(rank))
        if key in self._losses:
            self._losses.discard(key)
            self.losses_fired += 1
            return True
        return False

    def _outage(self, domain: str, windows: tuple, rate: float,
                tag: int, step: int) -> bool:
        step = int(step)
        hit = any(int(lo) <= step < int(hi) for lo, hi in windows)
        if not hit and rate > 0.0:
            hit = self.plan._draw(tag, step) < rate
        if hit:
            self._outage_hits[domain].add(step)
        return hit

    def store_outage(self, step: int) -> bool:
        """Is the relay/staged store down at this step?"""
        return self._outage("store", self.plan.store_outages,
                            self.plan.store_outage_rate, _STORE_OUT_TAG, step)

    def rendezvous_outage(self, step: int) -> bool:
        """Is the rendezvous server down at this step?"""
        return self._outage("rendezvous", self.plan.rendezvous_outages,
                            self.plan.rendezvous_outage_rate,
                            _RENDEZ_OUT_TAG, step)

    def outage_penalty_s(self, domain: str, step: int) -> float:
        """Retry-ladder seconds one op pays at this step (0.0 when the
        domain is healthy).  ``domain`` is ``"store"`` or ``"rendezvous"``."""
        check = (self.store_outage if domain == "store"
                 else self.rendezvous_outage)
        return self.plan.outage_penalty_s if check(step) else 0.0

    @property
    def outages_fired(self) -> int:
        """Distinct (domain, step) outage hits observed so far."""
        return sum(len(v) for v in self._outage_hits.values())

    def fired(self) -> dict:
        """Per-domain fired breakdown (for benchmark/CI assertions)."""
        return {
            "kills": dict(self.kills_by_source, total=self.kills_fired),
            "straggles": dict(self.straggles_by_source,
                              total=self.straggles_fired),
            "flaps": self.flaps_fired,
            "rank_losses": self.losses_fired,
            "outages": {
                "store": len(self._outage_hits["store"]),
                "rendezvous": len(self._outage_hits["rendezvous"]),
                "total": self.outages_fired,
            },
        }
