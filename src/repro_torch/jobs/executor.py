"""JobExecutor: a Lithops-idiom serverless job layer over the priced substrate
— the port's own copy of ``repro.jobs.executor``.

The paper's pitch (serverless functions hosting data-intensive ML at HPC
efficiency) needs a general "invoke N priced workers over a dataset and
collect futures" surface — the FunctionExecutor shape that turns
distributed analysis into ~10-line programs.  This module provides it on
top of the repo's existing machinery instead of real cloud APIs:

- **Where it runs** comes only from the PR 6 provider registry: the
  constructor resolves ``provider=`` through :func:`netsim.resolve_provider`
  (never raw ``CHANNELS[...]`` strings), each task attempt is billed
  ``ProviderProfile.invocation_cost(mem_gb, billed_s)`` (GB-seconds + per
  request), and shuffles/reductions ride a session-backed
  :class:`~repro_torch.core.communicator.Communicator` whose bootstrap is priced
  as BOOTSTRAP events — the same composition ``BSPRuntime`` uses.
- **Execution model** follows the repo's simulation convention: task
  functions run for real on this host; modeled duration = measured compute
  x ``cpu_scale`` / platform ``cpu_speed``, plus any injected straggle from
  a :class:`~repro_torch.core.faults.FaultPlan` (the shared adversary with
  ``BSPRuntime.run``; coordinates are ``(attempt_index, task_index)``).
  Tasks are packed onto ``workers`` concurrent invocation slots
  (greedy earliest-free; default one slot per task, the serverless limit).
- **Fault tolerance** is the HPC-grade part the SLR names as the recurring
  serverless gap: per-task retries with exponential backoff (a killed or
  failed attempt is re-invoked after ``backoff_s * multiplier**k``; the
  re-invocation is a fresh worker, so attempt-0 scheduled faults don't
  re-fire), a per-attempt deadline (``FaultPlan.deadline_s``) billing the
  killed attempt at the deadline, and **speculative re-execution**: once
  the primaries are in, any task whose winning attempt ran longer than
  ``latency_factor x median`` gets a backup invocation launched at the
  detection point; the earlier modeled finish wins, the duplicate result
  is discarded deterministically (ties go to the primary), and both
  invocations are billed — speculation trades $ for tail latency.

Every job emits a :class:`JobReport` (task timeline, retries, speculative
wins, $-cost) — the jobs-layer analogue of ``bsp.RunReport``.

On the port: the pricing is the reference's text, so a job whose measured
compute is zero (``cpu_scale=0``) reports ``==`` the reference's.  Tasks
run on the executor's ``device`` (the card unless the caller names the
CPU), which is synchronized before each stamp around a task or a reducer
call, so a measured duration holds the work its kernels did, not their
launches.  ``map_reduce`` prices its gather by the pickled size of host
numpy copies of the results' tensor leaves (``dist/payload.py``), as the
reference prices the equal arrays.
"""

from __future__ import annotations

import dataclasses
import time
from collections.abc import Callable, Iterable
from typing import Any

import numpy as np
import torch

from repro_torch.core import algorithms as _algorithms
from repro_torch.core import faults as _faults
from repro_torch.core import netsim
from repro_torch.core import session as _session
from repro_torch.core import trace as _trace
from repro_torch.core.communicator import CollectiveKind, Communicator
from repro_torch.device import resolve_device, synchronize
from repro_torch.dist import payload as _payload
from repro_torch.jobs.futures import ANY_COMPLETED, Future, wait


def _gather_payloads(per_slot: list[list[Any]]) -> list[torch.Tensor]:
    """Each slot's results, pickled back to back, as one host uint8 tensor —
    what a slot contributes to the reducer's rooted gather."""
    return [
        torch.frombuffer(
            bytearray(b"".join(_payload.dumps(r) for r in chunk) or b"\0"),
            dtype=torch.uint8)
        for chunk in per_slot
    ]


class TaskError(RuntimeError):
    """A task exhausted its retry budget; the last failure is chained."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Per-task re-invocation policy (Lithops ``retries`` analogue)."""

    max_retries: int = 2        # re-invocations after the first attempt
    backoff_s: float = 0.5      # modeled delay before the first retry
    multiplier: float = 2.0     # exponential backoff growth

    def backoff(self, failures: int) -> float:
        """Modeled seconds between the ``failures``-th failure (1-based)
        and the next invocation."""
        return self.backoff_s * self.multiplier ** max(int(failures) - 1, 0)


@dataclasses.dataclass(frozen=True)
class SpeculationPolicy:
    """Straggler mitigation by backup invocation (MapReduce-style).

    A task whose winning primary attempt runs longer than
    ``max(latency_factor x median primary duration, median + min_lead_s)``
    is declared a straggler at exactly that threshold past its start; a
    backup copy is invoked there (serverless: a fresh function, no slot
    wait) and runs *without* the injected delay — the fresh-worker
    semantics ``BSPRuntime`` uses for deadline re-invocations.  The earlier
    modeled finish supplies the result; the loser's duplicate is discarded
    (ties resolve to the primary, so the choice is deterministic)."""

    enabled: bool = True
    latency_factor: float = 2.0
    min_lead_s: float = 1.0     # absolute floor, so ~0-cost tasks don't trigger

    def threshold_s(self, median_s: float) -> float:
        return max(self.latency_factor * median_s, median_s + self.min_lead_s)


@dataclasses.dataclass
class TaskAttempt:
    """One billed invocation of one task (primary, retry, or backup)."""

    start_s: float
    end_s: float
    billed_s: float             # duration the provider bills (GB-seconds basis)
    cost_usd: float
    status: str                 # "ok" | "killed" | "deadline" | "error"
    speculative: bool = False

    @property
    def duration_s(self) -> float:
        return self.end_s - self.start_s


@dataclasses.dataclass
class TaskRecord:
    """Timeline of one logical task across all its attempts."""

    index: int
    attempts: list[TaskAttempt] = dataclasses.field(default_factory=list)
    done_s: float = float("inf")   # modeled completion of the winning attempt
    winner: str = "primary"        # "primary" | "speculative"
    error: str | None = None       # set when the retry budget was exhausted
    slot: int = 0                  # invocation slot the primary attempts ran on

    @property
    def retries(self) -> int:
        """Re-invocations after the first attempt (backups not counted)."""
        return max(sum(1 for a in self.attempts if not a.speculative) - 1, 0)

    @property
    def cost_usd(self) -> float:
        return float(sum(a.cost_usd for a in self.attempts))

    @property
    def speculated(self) -> bool:
        return any(a.speculative for a in self.attempts)


@dataclasses.dataclass
class JobReport:
    """Per-job accounting — the jobs-layer analogue of ``bsp.RunReport``."""

    job_id: str
    kind: str                   # "map" | "map_reduce" | "call_async"
    provider: str
    mem_gb: float
    ntasks: int
    workers: int                # concurrent invocation slots
    init_s: float               # session bootstrap (priced BOOTSTRAP events)
    tasks: list[TaskRecord] = dataclasses.field(default_factory=list)
    comm_s: float = 0.0         # gather/shuffle time (priced CommEvents)
    reduce_s: float = 0.0       # reducer invocation compute
    reduce_cost_usd: float = 0.0
    trace_base_s: float = 0.0   # tracer offset of this job's task t=0
    # the placer's winning bid when the executor resolved its provider via
    # workload= (algorithms.select_placement); None for explicit providers
    placement: dict | None = None
    # incremental map_reduce: partial folds streamed as futures completed;
    # pipeline_end_s is the modeled end of the last fold (task clock), so
    # total_s reflects reduce-overlapped-with-map instead of the strict sum
    partial_reduces: int = 0
    pipeline_end_s: float | None = None

    @property
    def tasks_s(self) -> float:
        """Modeled parallel map phase: last winning completion."""
        done = [t.done_s for t in self.tasks if t.done_s != float("inf")]
        return max(done, default=0.0)

    @property
    def total_s(self) -> float:
        if self.pipeline_end_s is not None:
            return self.init_s + self.pipeline_end_s
        return self.init_s + self.tasks_s + self.comm_s + self.reduce_s

    @property
    def cost_usd(self) -> float:
        """Sum of every billed invocation: all attempts of all tasks plus
        the reducer.  Duplicates (lost speculation races, killed attempts)
        are billed too — the provider doesn't refund a discarded result."""
        return float(sum(t.cost_usd for t in self.tasks)) + self.reduce_cost_usd

    @property
    def retries(self) -> int:
        return sum(t.retries for t in self.tasks)

    @property
    def speculative_launched(self) -> int:
        return sum(1 for t in self.tasks if t.speculated)

    @property
    def speculative_wins(self) -> int:
        return sum(1 for t in self.tasks if t.winner == "speculative")

    @property
    def speculative_discarded(self) -> int:
        """Duplicate results thrown away — one per backup that raced a
        completing primary (whichever copy lost)."""
        return sum(
            1 for t in self.tasks
            if t.speculated and t.error is None
        )

    def timeline(self) -> list[tuple[int, float, float, str, bool]]:
        """Flat ``(task, start_s, end_s, status, speculative)`` rows, by
        start time — the Gantt view of the job."""
        rows = [
            (t.index, a.start_s, a.end_s, a.status, a.speculative)
            for t in self.tasks for a in t.attempts
        ]
        return sorted(rows, key=lambda r: (r[1], r[0], r[4]))


class JobExecutor:
    """Invoke priced serverless tasks and collect futures (see module doc).

    ``provider`` is anything :func:`netsim.resolve_provider` accepts — a
    registered name (``"aws-lambda"``), a :class:`~repro_torch.core.netsim
    .ProviderProfile`, or None for the default.  ``fabric`` optionally
    overrides the communication fabric the job's session bootstraps on (a
    :class:`~repro_torch.core.session.Fabric` or ``session.FABRICS`` name);
    default: the provider's own fabric.  ``device`` is where the tasks'
    work runs (the card unless the caller names the CPU); it is drained
    before each stamp of a measured duration.

    Alternatively pass ``workload=`` (an :class:`~repro_torch.core.algorithms
    .Workload`) instead of a provider: the executor asks the cost-aware
    placer (:func:`algorithms.select_placement`) for the cheapest registered
    provider meeting ``placement_deadline_s`` (no deadline: cheapest
    overall) and runs there; the winning bid is recorded on the executor
    (``self.placement``) and in every :class:`JobReport`.
    """

    def __init__(
        self,
        provider: str | netsim.ProviderProfile | None = None,
        *,
        fabric: str | _session.Fabric | None = None,
        workers: int | None = None,
        mem_gb: float | None = None,
        retry: RetryPolicy | None = None,
        speculation: SpeculationPolicy | None = None,
        cpu_scale: float = 1.0,
        algorithm: str = "auto",
        tracer: _trace.Tracer | None = None,
        workload: _algorithms.Workload | None = None,
        placement_deadline_s: float | None = None,
        placement_providers: Iterable[str] | None = None,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.placement: _algorithms.Placement | None = None
        if workload is not None:
            if provider is not None:
                raise ValueError(
                    "pass provider= or workload= (placer-resolved), not both")
            candidates = (
                tuple(placement_providers) if placement_providers is not None
                else netsim.providers()
            )
            deadline = (float(placement_deadline_s)
                        if placement_deadline_s is not None else float("inf"))
            self.placement = _algorithms.select_placement(
                workload, candidates, deadline)
            provider = self.placement.provider
        # the ONLY run-location path: the PR 6 registry via resolve_provider
        self.provider = netsim.resolve_provider(provider)
        if fabric is None:
            self.fabric: _session.Fabric = _session.provider_fabric(self.provider)
        elif isinstance(fabric, _session.Fabric):
            self.fabric = fabric
        else:
            self.fabric = _session.FABRICS[fabric]
        self.workers = None if workers is None else int(workers)
        self.mem_gb = float(
            mem_gb if mem_gb is not None else self.provider.platform.mem_gb
        )
        self.retry = retry if retry is not None else RetryPolicy()
        self.speculation = (
            speculation if speculation is not None else SpeculationPolicy()
        )
        self.cpu_scale = float(cpu_scale)
        self.algorithm = algorithm
        # every job lays its timeline onto this tracer: bootstrap spans from
        # the job session, task attempts on per-slot compute lanes (backups
        # on fresh lanes past the slots), gather + reduce for map_reduce.
        # Jobs append end-to-end, so one executor = one modeled timeline.
        self.tracer = tracer if tracer is not None else _trace.Tracer()
        self.reports: list[JobReport] = []
        self._job_seq = 0

    # -- internals -----------------------------------------------------------

    def _next_job_id(self, kind: str) -> str:
        self._job_seq += 1
        return f"{kind}-{self._job_seq:03d}"

    def _measure(self, fn: Callable, arg: Any) -> tuple[float, Any, BaseException | None]:
        """Run ``fn(arg)`` for real; (modeled seconds, result, exception).

        Sanctioned wall-clock: real compute measured and rescaled by the
        platform's cpu_speed — how measured time enters the modeled clock.
        The device is drained before each stamp (see the class doc).
        """
        synchronize(self.device)
        t0 = time.perf_counter()  # noqa: RPA001
        try:
            out = fn(arg)
            synchronize(self.device)
            exc = None
        except Exception as e:  # user exceptions are task failures, retried
            out = None
            exc = e
        dur = (time.perf_counter() - t0) / self.provider.platform.cpu_speed  # noqa: RPA001
        return dur * self.cpu_scale, out, exc

    def _bill(self, billed_s: float) -> float:
        return self.provider.invocation_cost(self.mem_gb, billed_s)

    def _run_task(
        self,
        fn: Callable,
        arg: Any,
        index: int,
        slot_start: float,
        armed: _faults.ArmedFaults,
        deadline_s: float | None,
    ) -> tuple[TaskRecord, Any, float]:
        """Drive one task's attempt loop; returns (record, result, base_s of
        the winning attempt — the fresh-run duration speculation uses)."""
        rec = TaskRecord(index=index)
        t = slot_start
        attempt = 0
        last_exc: BaseException | None = None
        result = None
        base_ok = 0.0
        while True:
            base_s, out, exc = self._measure(fn, arg)
            extra = armed.extra_delay(attempt, index)
            dur = base_s + extra
            if armed.fail(attempt, index):
                # the invocation crashed and its result was lost; the full
                # run is still billed (the provider metered it to the end)
                rec.attempts.append(TaskAttempt(
                    t, t + dur, dur, self._bill(dur), "killed"))
                last_exc = TaskError(
                    f"task {index} killed on attempt {attempt}")
            elif deadline_s is not None and dur > deadline_s:
                # killed AT the deadline: billed exactly deadline seconds
                rec.attempts.append(TaskAttempt(
                    t, t + deadline_s, deadline_s, self._bill(deadline_s),
                    "deadline"))
                last_exc = TaskError(
                    f"task {index} exceeded {deadline_s}s deadline "
                    f"on attempt {attempt}")
            elif exc is not None:
                rec.attempts.append(TaskAttempt(
                    t, t + dur, dur, self._bill(dur), "error"))
                last_exc = exc
            else:
                rec.attempts.append(TaskAttempt(
                    t, t + dur, dur, self._bill(dur), "ok"))
                rec.done_s = t + dur
                result = out
                base_ok = base_s
                last_exc = None
                break
            # failed attempt: exponential backoff, then a fresh invocation.
            # The attempt axis advances, so attempt-0 scheduled faults
            # don't re-fire (fresh-worker semantics).
            attempt += 1
            if attempt > self.retry.max_retries:
                break
            t = rec.attempts[-1].end_s + self.retry.backoff(attempt)
        if last_exc is not None:
            rec.error = repr(last_exc)
            rec.done_s = rec.attempts[-1].end_s
            return rec, last_exc, base_ok
        return rec, result, base_ok

    def _speculate(
        self, records: list[TaskRecord], bases: list[float]
    ) -> None:
        """Backup-invoke stragglers; winner's timing stands, loser billed."""
        policy = self.speculation
        if not policy.enabled:
            return
        ok = [r for r in records if r.error is None]
        if len(ok) < 2:
            return  # no population to call a median on
        durations = [r.attempts[-1].duration_s for r in ok]
        threshold = policy.threshold_s(float(np.median(durations)))
        for rec in ok:
            primary = rec.attempts[-1]
            if primary.duration_s <= threshold:
                continue
            detect = primary.start_s + threshold
            # fresh worker: the backup reruns without the injected delay
            backup_dur = bases[rec.index]
            backup_end = detect + backup_dur
            rec.attempts.append(TaskAttempt(
                detect, backup_end, backup_dur, self._bill(backup_dur),
                "ok", speculative=True))
            if backup_end < primary.end_s:  # ties go to the primary
                rec.winner = "speculative"
                rec.done_s = backup_end

    def _trace_job(self, report: JobReport) -> None:
        """Lay the job's task attempts onto the tracer's compute lanes.

        Primary attempts (and retries) go on the slot's lane — slot packing
        is earliest-free, so per-lane spans are already monotone.
        Speculative backups ran on fresh workers, so each gets a fresh lane
        past the slot lanes (lane exclusivity would otherwise reject a
        backup racing its own slot).
        """
        tr = self.tracer
        base = report.trace_base_s
        backup_rank = report.workers
        for rec in report.tasks:
            for a_i, a in enumerate(rec.attempts):
                if a.speculative:
                    rank = backup_rank
                    backup_rank += 1
                else:
                    rank = rec.slot
                tr.span(
                    rank, "compute", f"task{rec.index}",
                    t0=base + a.start_s, duration_s=a.duration_s,
                    usd=a.cost_usd, job=report.job_id, task=rec.index,
                    attempt=a_i, status=a.status, speculative=a.speculative,
                )

    # -- API -----------------------------------------------------------------

    def map(
        self,
        fn: Callable[[Any], Any],
        iterdata: Iterable[Any],
        *,
        faults: _faults.FaultPlan | None = None,
        _kind: str = "map",
        _session_holder: list | None = None,
    ) -> list[Future]:
        """Invoke ``fn`` once per item; one priced future per task."""
        args = list(iterdata)
        if not args:
            raise ValueError("map over an empty iterable")
        plan = faults if faults is not None else _faults.FaultPlan.none()
        armed = plan.armed()
        job_id = self._next_job_id(_kind)
        slots = max(min(self.workers or len(args), len(args)), 1)
        # one comm session per job: bootstrap (rendezvous + punch or store
        # rendezvous) is the job's priced init, exactly BSPRuntime's shape
        sess = _session.CommSession.bootstrap(slots, self.fabric)
        if plan.any_infra_faults:
            # the shared adversary hits this surface too: store outages
            # price into the job's relayed/staged collectives (the jobs
            # attempt axis stands in for the fault clock's step axis)
            sess.arm_faults(armed, step=0)
        if _session_holder is not None:
            _session_holder.append(sess)
        # backfill lays the bootstrap spans; live mirroring stays off because
        # map_reduce schedules its gather explicitly after the map phase
        sess.attach_tracer(self.tracer, mirror=False, backfill=True)
        report = JobReport(
            job_id=job_id, kind=_kind, provider=self.provider.name,
            mem_gb=self.mem_gb, ntasks=len(args), workers=slots,
            init_s=sess.bootstrap_time_s,
            trace_base_s=self.tracer.end_s,
            placement=(dataclasses.asdict(self.placement)
                       if self.placement is not None else None),
        )
        slot_free = [0.0] * slots
        records: list[TaskRecord] = []
        results: list[Any] = []
        bases: list[float] = []
        for i, arg in enumerate(args):
            slot = int(np.argmin(slot_free))
            rec, res, base = self._run_task(
                fn, arg, i, slot_free[slot], armed, plan.deadline_s)
            rec.slot = slot
            slot_free[slot] = rec.done_s if rec.done_s != float("inf") \
                else rec.attempts[-1].end_s
            records.append(rec)
            results.append(res)
            bases.append(base)
        self._speculate(records, bases)
        report.tasks = records
        self._trace_job(report)
        self.reports.append(report)
        futures = []
        for rec, res in zip(records, results):
            exc = res if rec.error is not None else None
            futures.append(Future(
                job_id, rec.index, rec.done_s,
                result=None if exc is not None else res,
                exception=exc, record=rec, job=report,
            ))
        return futures

    def call_async(
        self,
        fn: Callable[[Any], Any],
        data: Any,
        *,
        faults: _faults.FaultPlan | None = None,
    ) -> Future:
        """Single async invocation — a one-task map."""
        return self.map(fn, [data], faults=faults, _kind="call_async")[0]

    def map_reduce(
        self,
        map_fn: Callable[[Any], Any],
        iterdata: Iterable[Any],
        reduce_fn: Callable[[list[Any]], Any],
        *,
        faults: _faults.FaultPlan | None = None,
        incremental: bool = False,
    ) -> Future:
        """Map, then gather the results over the session-backed communicator
        (priced CommEvents) and run ``reduce_fn(results)`` as one more
        billed invocation.  Returns the reducer's future; its ``job`` is the
        whole job's :class:`JobReport`.

        ``incremental=True`` streams instead of batching: as ``wait(fs,
        ANY_COMPLETED)`` surfaces each completed batch, its results are
        gathered and folded into the running accumulator
        (``reduce_fn([acc] + batch)``) while later map tasks are still
        running.  One warm reducer drains the batches, so the reduce is
        billed once and — for an associative ``reduce_fn`` — the final
        result and total $ match the batch path; the job's modeled end
        (``pipeline_end_s``) is the pipelined fold recursion, which beats
        ``tasks + gather + reduce`` whenever task completions are spread."""
        holder: list = []
        futures = self.map(
            map_fn, iterdata, faults=faults, _kind="map_reduce",
            _session_holder=holder,
        )
        report: JobReport = futures[0].job
        sess = holder[0]
        failed = [f for f in futures if f.error]
        if failed:
            f = failed[0]
            red = Future(
                report.job_id, -1, report.init_s + report.tasks_s,
                exception=f.exception(), record=None, job=report,
            )
            return red
        comm = Communicator(session=sess, algorithm=self.algorithm)
        comm.reset_events()
        if incremental:
            return self._reduce_incremental(report, comm, futures, reduce_fn)
        results = [f.result() for f in futures]
        # shuffle the map outputs to the reducer slot: each slot contributes
        # its tasks' pickled payloads to a rooted gather (priced round)
        per_slot: list[list[Any]] = [[] for _ in range(report.workers)]
        for f in futures:
            per_slot[f.task_id % report.workers].append(results[f.task_id])
        comm.gather(_gather_payloads(per_slot), root=0)
        report.comm_s = comm.comm_time_s
        # sanctioned wall-clock: the reducer's real compute, rescaled
        synchronize(self.device)
        t0 = time.perf_counter()  # noqa: RPA001
        reduced = reduce_fn(results)
        synchronize(self.device)
        red_s = (
            (time.perf_counter() - t0)  # noqa: RPA001
            / self.provider.platform.cpu_speed * self.cpu_scale
        )
        report.reduce_s = red_s
        report.reduce_cost_usd = self._bill(red_s)
        # timeline: the gather starts once the last winning map task is in,
        # the reducer once the gather drains (rank 0 = the reducer slot)
        tr = self.tracer
        t_comm = report.trace_base_s + report.tasks_s
        for ev in comm.events:
            if ev.kind is CollectiveKind.BOOTSTRAP:
                continue
            spans = tr.ingest_comm_event(ev, range(report.workers), t0=t_comm)
            t_comm = max(s.t1 for s in spans)
        tr.span(
            0, "compute", "reduce",
            t0=max(t_comm, tr.lane_end(0, "compute")), duration_s=red_s,
            usd=report.reduce_cost_usd, job=report.job_id,
        )
        return Future(
            report.job_id, -1, report.total_s,
            result=reduced, record=None, job=report,
        )

    def _reduce_incremental(
        self,
        report: JobReport,
        comm: Communicator,
        futures: list[Future],
        reduce_fn: Callable[[list[Any]], Any],
    ) -> Future:
        """Streaming reduce: fold each batch as ``wait(ANY)`` surfaces it.

        The modeled clock pipelines: fold *k* starts at ``max(batch k ready
        + its gather, fold k-1 done)`` — one warm reducer drains batches
        sequentially while later map tasks are still running.  The reducer
        is billed once (one request + the summed fold GB-seconds), so total
        $ matches the batch path up to fold-measurement noise."""
        tr = self.tracer
        acc: Any = None
        nparts = 0
        red_total = 0.0     # summed fold compute (the reducer's billed time)
        red_done = 0.0      # modeled end of the last fold (task clock)
        t_comm = report.trace_base_s
        # the reducer is its own warm invocation: give it a fresh trace lane
        # past the slot and backup lanes (its folds overlap later map tasks
        # by design, so it can't share slot 0's compute lane)
        reducer_rank = report.workers + sum(
            1 for t in report.tasks for a in t.attempts if a.speculative)
        pending = list(futures)
        while pending:
            done, pending = wait(pending, ANY_COMPLETED)
            t_batch = max(f.done_s for f in done)
            batch = sorted(done, key=lambda f: f.task_id)
            per_slot: list[list[Any]] = [[] for _ in range(report.workers)]
            for f in batch:
                per_slot[f.task_id % report.workers].append(f.result())
            n0 = len(comm.events)
            before = comm.comm_time_s
            comm.gather(_gather_payloads(per_slot), root=0)
            gather_s = comm.comm_time_s - before
            # sanctioned wall-clock: each fold's real compute, rescaled
            synchronize(self.device)
            t0 = time.perf_counter()  # noqa: RPA001
            acc = reduce_fn(
                ([acc] if nparts else []) + [f.result() for f in batch])
            synchronize(self.device)
            fold_s = (
                (time.perf_counter() - t0)  # noqa: RPA001
                / self.provider.platform.cpu_speed * self.cpu_scale
            )
            red_total += fold_s
            # the fold waits for this batch's gather AND the previous fold
            fold_t0 = max(t_batch + gather_s, red_done)
            red_done = fold_t0 + fold_s
            nparts += 1
            # timeline: gather spans as the batch lands; the fold rides the
            # reducer's lane at $0 — its compute is billed once at the end
            t_comm = max(t_comm, report.trace_base_s + t_batch)
            for ev in comm.events[n0:]:
                if ev.kind is CollectiveKind.BOOTSTRAP:
                    continue
                spans = tr.ingest_comm_event(
                    ev, range(report.workers), t0=t_comm)
                t_comm = max(s.t1 for s in spans)
            tr.span(
                reducer_rank, "compute", f"reduce_part{nparts - 1}",
                t0=report.trace_base_s + fold_t0, duration_s=fold_s,
                usd=0.0, job=report.job_id, partial=True,
            )
        report.comm_s = comm.comm_time_s
        report.reduce_s = red_total
        report.reduce_cost_usd = self._bill(red_total)
        report.partial_reduces = nparts
        report.pipeline_end_s = red_done
        # settle the reducer's once-billed invocation on the timeline: the
        # folds rode at $0, so without this marker the lane ledger would
        # undercount the billed ledger by reduce_cost_usd (tracecheck RPT008)
        tr.span(
            reducer_rank, "compute", "reduce_settle",
            t0=report.trace_base_s + red_done, duration_s=0.0,
            usd=report.reduce_cost_usd, job=report.job_id,
        )
        return Future(
            report.job_id, -1, report.total_s,
            result=acc, record=None, job=report,
        )
