"""BSP superstep runtime (paper contribution C1 + the §V fault-tolerance gap)
— the port's own copy of ``repro.core.bsp``.

The paper's execution model: N single-program workers advance through
supersteps; each superstep is (local compute, communication, barrier).  On
AWS Lambda the paper's architecture has no fault tolerance and a hard 15-min
deadline (§V "the lack of checkpointing and fault tolerance mechanisms limits
the ability to recover from failures or time-constrained execution
boundaries").  This runtime implements the model *and* the missing pieces:

- superstep checkpointing (state snapshot after each barrier) through the
  same durable-store path the trainer uses (``repro_torch.dist.object_store``):
  a local directory for single-host runs or a simulated S3 store whose
  per-op pricing lands checkpoint cost in the §IV time/cost model,
- restart/recovery from the last completed superstep,
- worker-failure + straggler handling: a rank that exceeds its deadline is
  re-executed (serverless semantics: functions are idempotent re-invocable),
- elastic membership: resume a checkpoint on a different world size by
  repartitioning rank state through a user-provided repartition function.

Simulation model: ranks execute sequentially on this host; *modeled* parallel
wall time per superstep = max over ranks of (measured local compute x platform
CPU factor) + modeled communication time from the communicator event log.
This is the same composition the paper uses for Fig 14 (init / datagen /
compute phases).

On the port: the pricing is the reference's text, so every modeled second
but the measured compute is ``==`` the reference's for the same run.  Ranks
run on the runtime's ``device`` (the card unless the caller names the CPU):
the device is synchronized before each stamp around a rank's call, so
``compute_s`` is the time of the work its kernels did, not of their
launches — on the card, device seconds divided by the platform's CPU factor
(neither a Lambda nor an EC2 measurement).  Checkpoints pickle host numpy
copies of tensor leaves (``dist/payload.py``), so a checkpoint of tensors
prices as the reference's of the equal arrays, and restore as tensors on the
runtime's device.
"""

from __future__ import annotations

import dataclasses
import json
import pickle
import time
from pathlib import Path
from collections.abc import Callable, Sequence
from typing import Any

import torch

from repro_torch.core import algorithms as _algorithms
from repro_torch.core import faults as _faults
from repro_torch.core import netsim
from repro_torch.core import session as _session
from repro_torch.core import trace as _trace
from repro_torch.core.communicator import CollectiveKind, Communicator
from repro_torch.device import resolve_device, synchronize

# module reference only (attributes resolved at call time): repro_torch.dist pulls
# netsim back out of repro_torch.core, so binding names here would be circular
from repro_torch.dist import object_store as _object_store
from repro_torch.dist import payload as _payload

# A superstep: (rank, state, comm, world) -> new state.  Communication MUST go
# through `comm` so it is priced; local work is timed around the call.
SuperstepFn = Callable[[int, Any, Communicator, int], Any]


class WorkerFailure(RuntimeError):
    """Injected or detected loss of a worker mid-superstep."""


@dataclasses.dataclass
class SuperstepReport:
    index: int
    name: str
    compute_s: float          # modeled parallel compute (max over ranks, scaled)
    comm_s: float             # modeled communication time
    retries: int              # rank re-executions (stragglers / failures)
    barrier_s: float
    rebootstrap_s: float = 0.0  # deadline-killed ranks re-joining the session
    expand_s: float = 0.0       # burst admission before this superstep ran
    # self-healing fabric (run(recovery_policy=...)): what the degradation
    # ladder spent before this superstep's compute ran
    recovery_s: float = 0.0     # detect + re-punch/degrade + outage waits
    shrink_s: float = 0.0       # membership compaction (shrink_* events)
    rollback_s: float = 0.0     # re-reading the last checkpoint after a loss
    # overlap scheduling (run(overlap=True)): the double-buffered pipeline's
    # modeled compute+comm time, replacing the compute_s + comm_s sum in
    # total_s; ``chunks`` is the chunk count the pipeline chose.  None means
    # the superstep ran strictly compute-then-communicate (today's pricing).
    overlapped_s: float | None = None
    chunks: int = 1

    @property
    def total_s(self) -> float:
        phase = (
            self.compute_s + self.comm_s
            if self.overlapped_s is None else self.overlapped_s
        )
        return (phase + self.barrier_s
                + self.rebootstrap_s + self.expand_s
                + self.recovery_s + self.shrink_s + self.rollback_s)

    @property
    def overlap_speedup(self) -> float:
        """(compute + comm) / overlapped — 1.0 when not overlapped."""
        if self.overlapped_s is None or self.overlapped_s <= 0.0:
            return 1.0
        return (self.compute_s + self.comm_s) / self.overlapped_s


@dataclasses.dataclass
class RunReport:
    init_s: float
    supersteps: list[SuperstepReport]
    world: int
    # rank -> superstep index at which it joined (absent == rank 0's cohort);
    # the heterogeneous cost model bills each rank from its join point
    joined_at: dict = dataclasses.field(default_factory=dict)
    # ranks evicted by a mid-run shrink: {"rank", "step", "provider"} under
    # their PRE-shrink labels — the cost model bills each only up to its
    # eviction step (report.world is the surviving world)
    evicted: list = dataclasses.field(default_factory=list)

    @property
    def total_s(self) -> float:
        return self.init_s + sum(s.total_s for s in self.supersteps)


@dataclasses.dataclass(frozen=True)
class Burst:
    """A mid-run traffic burst absorbed by admitting workers between
    supersteps: before superstep ``at_step`` runs, ``new_ranks`` workers
    (optionally from another ``provider``) join through
    :meth:`~repro_torch.core.session.CommSession.expand`.  ``repartition(states,
    new_world)`` rebuilds per-rank state for the grown world; without one the
    new ranks start from ``None`` state."""

    at_step: int
    new_ranks: int
    provider: str | None = None
    repartition: Callable[[list[Any], int], list[Any]] | None = None


class BSPRuntime:
    """Drive P simulated ranks through supersteps with checkpoint/restart."""

    def __init__(
        self,
        world_size: int,
        platform: netsim.PlatformModel | None = None,
        channel_env: str | None = None,
        checkpoint_dir: str | Path | Any | None = None,
        deadline_s: float | None = None,
        cpu_scale: float = 1.0,
        algorithm: str = "auto",
        session: _session.CommSession | None = None,
        provider: str | netsim.ProviderProfile | None = None,
        tracer: _trace.Tracer | None = None,
        device: str | torch.device | None = None,
    ):
        self.world = int(world_size)
        # where the ranks' work runs and checkpoints restore: the card
        # unless the caller names the CPU
        self.device = resolve_device(device)
        # "Where this runs" comes from exactly one of: a pre-bootstrapped
        # session, a provider (name or profile), or the deprecated
        # channel_env string.  A session already fixes the fabric, so
        # combining it with the others is a contradiction, not a tiebreak.
        if session is not None and (provider is not None or channel_env is not None):
            raise ValueError(
                "session= already fixes the fabric; don't also pass "
                "provider=/channel_env="
            )
        self.provider: netsim.ProviderProfile | None = None
        if provider is not None:
            # raises if platform= conflicts with the named provider
            profile = netsim.resolve_provider(provider, platform=platform)
            self.provider = profile
            platform = profile.platform
            channel = profile.direct
            fabric = _session.provider_fabric(profile)
        else:
            if channel_env is not None:
                # sanctioned forwarding: this is the documented compat
                # adapter for the deprecated kwarg — the warning + mapping
                # live in resolve_provider
                channel = netsim.resolve_provider(channel_env=channel_env).direct  # noqa: RPA003
            else:
                channel = None
            platform = platform if platform is not None else netsim.LAMBDA_10GB
            if channel is None:
                channel = platform.channel
            fabric = _session.Fabric(platform=platform, direct=channel)
        self.platform = platform
        # The runtime owns a CommSession: bootstrap (rendezvous + hole punch,
        # or store rendezvous for mediated channels) is priced as BOOTSTRAP
        # events in the session log instead of the old side-channel
        # PlatformModel.init_time call; RunReport.init_s is their sum.  Pass
        # `session` to run over a pre-bootstrapped (possibly hybrid-link)
        # topology — collectives then price link-aware automatically.
        if session is None:
            session = _session.CommSession.bootstrap(self.world, fabric)
        else:
            if session.world != self.world:
                raise ValueError(
                    f"session world {session.world} != runtime world {self.world}"
                )
            channel = session.direct_channel
        self.session = session
        # algorithm: collective schedule policy for every priced exchange —
        # "auto" (tuned engine) or "fixed" (calibrated paper schedule)
        self.algorithm = algorithm
        self.comm = Communicator(
            channel=channel, algorithm=algorithm, session=session
        )
        # checkpoint_dir: a directory (wrapped in a LocalStore) or any
        # dist.object_store.Store — the same durable-state plane train.py uses
        self.checkpoint_store = (
            _object_store.as_store(checkpoint_dir) if checkpoint_dir is not None else None
        )
        self.deadline_s = deadline_s
        self.cpu_scale = cpu_scale
        self._completed_steps = 0
        # Every runtime owns a span timeline.  Live mirroring is off
        # (mirror=False): run() schedules each superstep's compute, comm and
        # bootstrap spans itself after pricing, so comm spans land after the
        # compute they follow on the modeled clock.  Bootstrap events already
        # in the session log are backfilled as bootstrap-lane spans.
        if tracer is None:
            tracer = session.tracer
        if tracer is None:
            tracer = _trace.Tracer()
        if session.tracer is not tracer:
            session.attach_tracer(tracer, mirror=False, backfill=True)
        else:
            session._mirror = False
        self.tracer = tracer
        if self.checkpoint_store is not None:
            self.checkpoint_store.attach_tracer(tracer)

    # -- checkpointing --------------------------------------------------------
    #
    # One store group per superstep: ``superstep_<n>/states.pkl`` plus a
    # ``manifest.json`` written last (the commit marker on put-then-marker
    # stores).  A killed writer leaves only store garbage that the next
    # publish/list sweeps — never a readable half-checkpoint.

    @staticmethod
    def _group_name(step: int) -> str:
        return f"superstep_{step:05d}"

    def _save(self, step: int, states: list[Any]) -> None:
        if self.checkpoint_store is None:
            return
        payload = _payload.dumps(
            {"step": step, "world": self.world, "states": states}
        )
        self.checkpoint_store.put_objects_atomic(
            self._group_name(step),
            {
                "states.pkl": payload,
                "manifest.json": json.dumps(
                    {"step": int(step), "world": self.world}
                ).encode(),
            },
        )

    @staticmethod
    def _load(store, group: str, device: torch.device) -> dict:
        return _payload.to_device(
            pickle.loads(store.get_object(group, "states.pkl")), device)

    @staticmethod
    def checkpoint_at(
        checkpoint_dir: str | Path | Any, step: int,
        device: str | torch.device | None = None,
    ) -> dict | None:
        """The committed checkpoint for one superstep (None if absent), its
        array leaves as tensors on ``device`` (the card unless named)."""
        device = resolve_device(device)
        store = _object_store.as_store(checkpoint_dir)
        group = BSPRuntime._group_name(step)
        if not store.committed(group):
            return None
        return BSPRuntime._load(store, group, device)

    @staticmethod
    def latest_checkpoint(
        checkpoint_dir: str | Path | Any,
        device: str | torch.device | None = None,
    ) -> dict | None:
        device = resolve_device(device)
        store = _object_store.as_store(checkpoint_dir)
        groups = [g for g in store.list_groups() if g.startswith("superstep_")]
        if not groups:
            return None
        return BSPRuntime._load(store, max(groups), device)

    # -- elastic membership ---------------------------------------------------

    def expand(
        self,
        new_ranks: int,
        provider: str | None = None,
        states: list[Any] | None = None,
        repartition: Callable[[list[Any], int], list[Any]] | None = None,
    ) -> tuple[list[Any] | None, float]:
        """Admit ``new_ranks`` workers into the live run (burst absorption).

        Grows the session world through the incremental expand path (priced
        ``expand_*`` BOOTSTRAP events — compare
        ``session.full_rebootstrap_time_s()``), rebuilds the root
        communicator over the new world, and repartitions ``states`` if
        given.  Returns ``(new_states, expand_seconds)``.
        """
        expand_s = self.session.expand(new_ranks, provider=provider)
        self.world = self.session.world
        self.comm = Communicator(
            channel=self.comm.channel, algorithm=self.algorithm,
            session=self.session,
        )
        if states is not None:
            if repartition is not None:
                states = repartition(list(states), self.world)
                if len(states) != self.world:
                    raise ValueError("repartition returned wrong number of states")
            else:
                states = list(states) + [None] * int(new_ranks)
        return states, expand_s

    def _rollback(self, idx: int, states: list[Any]) -> tuple[list[Any], float]:
        """Restore the newest committed checkpoint before superstep ``idx``
        (priced store GETs).  With no checkpoint store the in-memory states
        stand in for free — the simulation driver holds survivor state."""
        if self.checkpoint_store is None:
            return list(states), 0.0
        for step in range(idx - 1, -1, -1):
            group = self._group_name(step)
            if self.checkpoint_store.committed(group):
                n0 = len(self.checkpoint_store.ops)
                ckpt = self._load(self.checkpoint_store, group, self.device)
                t = float(sum(
                    op.time_s for op in self.checkpoint_store.ops[n0:]))
                return list(ckpt["states"]), t
        return list(states), 0.0

    # -- self-healing ---------------------------------------------------------

    def _recover(
        self,
        idx: int,
        states: list[Any],
        armed: _faults.ArmedFaults,
        recovery_policy: str,
        repartition: Callable[[list[Any], int], list[Any]] | None,
        joined_at: dict,
        evicted: list,
    ) -> tuple[list[Any], float, float, float, list]:
        """Run this superstep's infrastructure-fault recovery at entry.

        Arms the session/store fault clocks, walks the per-link degradation
        ladder for every flap, and escalates permanent rank losses per the
        policy.  Returns ``(states, recovery_s, shrink_s, rollback_s,
        recovery_events)`` — the events slice is what fired here, for the
        tracer to lay ahead of compute.
        """
        session = self.session
        session.arm_faults(armed, idx)
        if self.checkpoint_store is not None:
            self.checkpoint_store.arm_faults(armed, idx)
        n0 = len(session.events)
        recovery_s = shrink_s = rollback_s = 0.0

        degraded = False
        for a, b, permanent in armed.link_flaps_at(idx, self.world):
            t, action = session.recover_link(a, b, permanent=permanent)
            recovery_s += t
            degraded = degraded or action == "degraded"
        if degraded:
            self.comm.refresh_links()

        losses = [r for r in range(self.world) if armed.rank_loss(idx, r)]
        if losses:
            if recovery_policy == "retry":
                # fold each loss back into the attempt loop as one more kill
                for r in losses:
                    armed.requeue_kill(idx, r)
            else:
                label = "_".join(f"r{r}" for r in losses)
                recovery_s += session.detect_failure(label)
                states, rollback_s = self._rollback(idx, states)
                for r in losses:
                    evicted.append({
                        "rank": r, "step": idx,
                        "provider": session.rank_providers[r],
                    })
                policy = ("cold" if recovery_policy == "rebootstrap"
                          else "incremental")
                shrink_s = session.shrink(losses, policy=policy)
                self.world = session.world
                self.comm = Communicator(
                    channel=self.comm.channel, algorithm=self.algorithm,
                    session=session,
                )
                # survivors relabel to 0..S-1: keep join records addressable
                dead = set(losses)
                survivors = [r for r in range(self.world + len(losses))
                             if r not in dead]
                remap = {old: new for new, old in enumerate(survivors)}
                for old in list(joined_at):
                    step = joined_at.pop(old)
                    if old in remap:
                        joined_at[remap[old]] = step
                repart = repartition
                if repart is None:
                    from repro_torch.dist.sharding import repartition_states
                    repart = repartition_states
                states = repart(list(states), self.world)
                if len(states) != self.world:
                    raise ValueError(
                        "repartition returned wrong number of states")
        return (states, recovery_s, shrink_s, rollback_s,
                list(session.events[n0:]))

    # -- span timeline --------------------------------------------------------

    def _trace_superstep(
        self,
        idx: int,
        name: str,
        rank_elapsed: list[float],
        step_events: list,
        expand_s: float,
        reboot_s: float,
        barrier_s: float,
        overlapped_s: float | None,
        chunks: int,
        lat_s: float,
        bw_s: float,
        recovery_events: list | None = None,
    ) -> None:
        """Schedule one superstep's spans on the modeled timeline.

        overlap=False order: recovery ladder (detect spans on the overhead
        lane, repunch/degrade/shrink on bootstrap) -> expand -> per-rank
        compute -> rebootstrap -> each comm event sequentially -> barrier,
        so the superstep window equals ``SuperstepReport.total_s``.
        overlap=True emits the chunked double-buffer pipeline: rank r's
        compute is split into ``chunks`` equal spans; comm chunk i
        (bandwidth share bw/k) starts once chunk i has been computed
        everywhere and the previous comm chunk drained; the latency rounds
        of the final chunk are the unhideable tail.
        """
        tr = self.tracer
        ranks = range(self.world)
        compute_s = max(rank_elapsed, default=0.0)
        t0 = tr.end_s
        for ev in recovery_events or ():
            lane = ("overhead" if ev.kind is CollectiveKind.DETECT
                    else "bootstrap")
            seq = tr.next_event_seq()
            for r in ranks:
                tr.span(r, lane, ev.algo, t0=t0,
                        duration_s=ev.time_s, step=idx, eseq=seq)
            t0 += ev.time_s
        if expand_s > 0.0:
            seq = tr.next_event_seq()
            for r in ranks:
                tr.span(r, "bootstrap", "expand", t0=t0,
                        duration_s=expand_s, step=idx, eseq=seq)
        t1 = t0 + expand_s
        if overlapped_s is None:
            for r in ranks:
                if rank_elapsed[r] > 0.0:
                    tr.span(r, "compute", name, t0=t1,
                            duration_s=rank_elapsed[r], step=idx)
            t = t1 + compute_s
            if reboot_s > 0.0:
                seq = tr.next_event_seq()
                for r in ranks:
                    tr.span(r, "bootstrap", "rebootstrap", t0=t,
                            duration_s=reboot_s, step=idx, eseq=seq)
            t += reboot_s
            for ev in step_events:
                seq = tr.next_event_seq()
                for r in ranks:
                    tr.span(r, "comm", ev.kind.value, t0=t,
                            duration_s=ev.time_s, nbytes=ev.total_bytes,
                            step=idx, algo=ev.algo, eseq=seq)
                t += ev.time_s
        else:
            k = max(int(chunks), 1)
            c_max = compute_s / k
            for r in ranks:
                c_r = rank_elapsed[r] / k
                if c_r > 0.0:
                    for i in range(k):
                        tr.span(r, "compute", f"{name}#c{i}",
                                t0=t1 + i * c_r, duration_s=c_r, step=idx)
            # pipeline recursion: f_i = max((i+1)*c_max, f_{i-1}) + bw/k;
            # f_{k-1} + lat == t1 + overlapped_s (the closed form's schedule)
            f_prev = t1
            if bw_s > 0.0:
                b = bw_s / k
                for i in range(k):
                    s_i = max(t1 + (i + 1) * c_max, f_prev)
                    seq = tr.next_event_seq()
                    for r in ranks:
                        tr.span(r, "comm", f"overlap#c{i}", t0=s_i,
                                duration_s=b, step=idx, chunks=k, eseq=seq)
                    f_prev = s_i + b
            else:
                f_prev = t1 + compute_s
            if lat_s > 0.0 and step_events:
                seq = tr.next_event_seq()
                for r in ranks:
                    tr.span(r, "comm", "latency", t0=f_prev,
                            duration_s=lat_s, step=idx, eseq=seq)
                f_prev += lat_s
            t = max(f_prev, t1 + compute_s)
            if reboot_s > 0.0:
                seq = tr.next_event_seq()
                for r in ranks:
                    tr.span(r, "bootstrap", "rebootstrap", t0=t,
                            duration_s=reboot_s, step=idx, eseq=seq)
            t += reboot_s
        if barrier_s > 0.0:
            seq = tr.next_event_seq()
            for r in ranks:
                tr.span(r, "comm", "barrier", t0=t,
                        duration_s=barrier_s, step=idx, eseq=seq)

    # -- execution ------------------------------------------------------------

    def run(
        self,
        supersteps: Sequence[tuple[str, SuperstepFn]],
        init_states: list[Any],
        fail_injector: Callable[[int, int], bool] | None = None,
        straggle_injector: Callable[[int, int], float] | None = None,
        resume_from: dict | None = None,
        max_retries: int = 2,
        burst: Burst | None = None,
        faults: _faults.FaultPlan | None = None,
        overlap: bool = False,
        overlap_chunks: int | None = None,
        recovery_policy: str = "retry",
        repartition: Callable[[list[Any], int], list[Any]] | None = None,
    ) -> tuple[list[Any], RunReport]:
        """Execute `supersteps` over per-rank `init_states`.

        ``faults`` is a :class:`repro_torch.core.faults.FaultPlan` — the declarative
        kill/straggle/deadline schedule shared with ``JobExecutor.map``.  The
        legacy kwargs remain as thin adapters over the same machinery:
        fail_injector(step, rank) -> True means that rank dies on its first
        attempt of that step (it is retried, serverless-style re-invocation);
        straggle_injector(step, rank) -> extra seconds of simulated delay; a
        rank whose simulated time exceeds `deadline_s` (the plan's, falling
        back to the runtime's) is killed and retried.
        ``burst`` admits extra workers before superstep ``burst.at_step``
        runs; a run resumed *past* that step must already be at the expanded
        world (the checkpoint recorded it), so the burst is skipped.

        ``overlap=True`` double-buffers each superstep: compute is split into
        k chunks and chunk i's collective traffic (its bandwidth share)
        drains while chunk i+1 computes, so the superstep prices
        ``max(compute, comm)`` per chunk plus the unhideable latency rounds
        (:func:`repro_torch.core.algorithms.overlap_pipeline_time`; pin k with
        ``overlap_chunks``).  ``overlap=False`` (default) reproduces the
        strict compute-then-communicate totals bit-exactly.  Either way every
        superstep is scheduled on ``self.tracer``'s modeled timeline.

        Self-healing (the plan's infrastructure domains): at each superstep
        entry, scheduled/rate link flaps run the per-link recovery ladder
        (detect -> re-punch -> degrade to relay) and ``rank_losses`` escalate
        per ``recovery_policy``:

        - ``"retry"`` (default) — treat the loss as one more kill: the rank
          is re-invoked by the attempt loop (pre-existing behavior);
        - ``"shrink"`` — detect the dead ranks, roll back to the last store
          checkpoint, compact the world through the priced incremental
          :meth:`CommSession.shrink`, repartition the checkpointed states
          over the survivors (``repartition=``, default
          :func:`repro_torch.dist.sharding.repartition_states`), and continue;
        - ``"rebootstrap"`` — same escalation, but the membership change is
          priced as a cold re-bootstrap of the survivor world (the baseline
          shrink beats).

        Store/rendezvous outage windows price into relayed collectives,
        checkpoint ops, and any re-join that lands inside them.
        """
        if faults is not None and (
            fail_injector is not None or straggle_injector is not None
        ):
            raise ValueError("pass faults= or the legacy injectors, not both")
        plan = (
            faults
            if faults is not None
            else _faults.FaultPlan.from_injectors(fail_injector, straggle_injector)
        )
        armed = plan.armed()
        deadline_s = plan.deadline_s if plan.deadline_s is not None else self.deadline_s
        if recovery_policy not in ("retry", "shrink", "rebootstrap"):
            raise ValueError(
                f"unknown recovery_policy {recovery_policy!r}; "
                f"options: retry, shrink, rebootstrap"
            )
        if len(init_states) != self.world:
            raise ValueError("need one init state per rank")

        states = list(init_states)
        start_step = 0
        if resume_from is not None:
            if resume_from["world"] != self.world:
                raise ValueError("world mismatch: use resize_checkpoint() first")
            states = list(resume_from["states"])
            start_step = resume_from["step"] + 1

        # priced bootstrap from the session log (sums to the old
        # PlatformModel.init_time closed form on an all-direct fabric)
        init_s = self.session.bootstrap_time_s
        reports: list[SuperstepReport] = []
        joined_at: dict = {}
        evicted: list = []

        for idx in range(start_step, len(supersteps)):
            name, fn = supersteps[idx]
            expand_s = 0.0
            if burst is not None and idx == burst.at_step:
                old_world = self.world
                states, expand_s = self.expand(
                    burst.new_ranks, provider=burst.provider,
                    states=states, repartition=burst.repartition,
                )
                for r in range(old_world, self.world):
                    joined_at[r] = idx
            self.comm.reset_events()
            recovery_s = shrink_s = rollback_s = 0.0
            recovery_events: list = []
            if plan.any_infra_faults:
                states, recovery_s, shrink_s, rollback_s, recovery_events = (
                    self._recover(idx, states, armed, recovery_policy,
                                  repartition, joined_at, evicted)
                )
            max_rank_s = 0.0
            rank_elapsed: list[float] = [0.0] * self.world
            retries = 0
            reboot_s = 0.0
            new_states: list[Any] = [None] * self.world
            for rank in range(self.world):
                attempt = 0
                deadline_killed = False  # only this rank's re-invocation skips delay
                while True:
                    # sanctioned wall-clock: real compute is measured here
                    # and rescaled by platform.cpu_speed below — the one
                    # place measured time enters the modeled clock.  The
                    # device is drained before each stamp, so the span holds
                    # the work this rank's kernels did, not their launches.
                    synchronize(self.device)
                    t0 = time.perf_counter()  # noqa: RPA001
                    simulated_extra = (
                        armed.extra_delay(idx, rank) if not deadline_killed else 0.0
                    )
                    try:
                        if armed.fail(idx, rank):
                            raise WorkerFailure(f"rank {rank} died in superstep {idx}")
                        out = fn(rank, states[rank], self.comm, self.world)
                        synchronize(self.device)
                    except WorkerFailure:
                        attempt += 1
                        retries += 1
                        if attempt > max_retries:
                            raise
                        continue
                    elapsed = (time.perf_counter() - t0) / self.platform.cpu_speed  # noqa: RPA001
                    elapsed = elapsed * self.cpu_scale + simulated_extra
                    if (
                        deadline_s is not None
                        and elapsed > deadline_s
                        and attempt <= max_retries
                    ):
                        # straggler mitigation: kill + re-invoke.  The fresh
                        # worker has no injected delay, but the injector stays
                        # armed for every other rank and superstep.  The
                        # replacement function must re-join the fabric —
                        # re-rendezvous + re-punch its tree links, priced
                        # through the session into the shared log.
                        attempt += 1
                        retries += 1
                        deadline_killed = True
                        reboot_s += self.session.rebootstrap_rank(rank)
                        continue
                    new_states[rank] = out
                    rank_elapsed[rank] = elapsed
                    max_rank_s = max(max_rank_s, elapsed)
                    break
            states = new_states
            comm_s = self.comm.comm_time_s
            # this superstep's collectives: reset_events() cleared the last
            # step's and kept only BOOTSTRAP entries (init/reboot/expand)
            step_events = [
                ev for ev in self.session.events
                if ev.kind not in
                (CollectiveKind.BOOTSTRAP, CollectiveKind.DETECT)
            ]
            overlapped_s = None
            chunks = 1
            lat_s = bw_s = 0.0
            if overlap:
                for ev in step_events:
                    ev_lat, ev_bw = self.comm.event_lat_bw(ev)
                    lat_s += ev_lat
                    bw_s += ev_bw
                overlapped_s, chunks = _algorithms.overlap_pipeline_time(
                    max_rank_s, lat_s, bw_s, chunks=overlap_chunks
                )
            # priced through the communicator so a hybrid session's relayed
            # pairs gate the superstep barrier too (link-aware)
            barrier_s = self.comm.collective_time_s("barrier", 0)
            reports.append(
                SuperstepReport(
                    idx, name, max_rank_s, comm_s, retries, barrier_s,
                    rebootstrap_s=reboot_s, expand_s=expand_s,
                    recovery_s=recovery_s, shrink_s=shrink_s,
                    rollback_s=rollback_s,
                    overlapped_s=overlapped_s, chunks=chunks,
                )
            )
            self._trace_superstep(
                idx, name, rank_elapsed, step_events, expand_s, reboot_s,
                barrier_s, overlapped_s, chunks, lat_s, bw_s,
                recovery_events=recovery_events,
            )
            self._save(idx, states)
            self._completed_steps = idx + 1

        return states, RunReport(
            init_s, reports, self.world, joined_at=joined_at, evicted=evicted)


def resize_checkpoint(
    ckpt: dict,
    new_world: int,
    repartition: Callable[[list[Any], int], list[Any]],
) -> dict:
    """Elastic membership change: rebuild per-rank states for a new world size.

    `repartition(states, new_world)` owns the data semantics (e.g. table
    repartitioning by hash); this wrapper preserves the superstep cursor so a
    resumed run continues where the old world stopped — the serverless
    'state lives outside the worker' model.
    """
    new_states = repartition(list(ckpt["states"]), new_world)
    if len(new_states) != new_world:
        raise ValueError("repartition returned wrong number of states")
    return {"step": ckpt["step"], "world": new_world, "states": new_states}
