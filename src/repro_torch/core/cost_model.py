"""Empirical serverless cost model (paper contribution C3, §IV-F, Figs 15-16)
— the port's own copy of ``repro.core.cost_model``.

Reproduces every cost figure in the paper analytically:

- NAT-traversal connection phase at 32 workers x 10 GB x ~31.5 s  => ~$0.17
- distributed computation phase                                   => $0.004-0.016
- Join/Redis at 32 nodes  => ~$0.032 per execution
- Join/S3 at 32 nodes     => ~$0.150 per execution (4.7x Redis)
- Step Functions orchestration negligible vs Lambda compute
- EC2 idle-time dominance for intermittent workloads
- 120-execution revision campaign                                  => ~$3.25

Pricing constants are public AWS list prices (us-east-1, 2024/25).
"""

from __future__ import annotations

import dataclasses

# --- AWS list prices -------------------------------------------------------
LAMBDA_USD_PER_GB_S = 0.0000166667
LAMBDA_USD_PER_REQUEST = 0.20 / 1e6
STEP_FN_USD_PER_TRANSITION = 0.025 / 1000
S3_USD_PER_PUT = 0.005 / 1000
S3_USD_PER_GET = 0.0004 / 1000
ELASTICACHE_USD_PER_NODE_HR = 0.068      # cache.m5.large on-demand
EC2_M3_XLARGE_USD_PER_HR = 0.266
EC2_M3_LARGE_USD_PER_HR = 0.133


@dataclasses.dataclass(frozen=True)
class LambdaInvocation:
    """One Lambda function execution."""

    mem_gb: float
    duration_s: float

    @property
    def gb_seconds(self) -> float:
        return self.mem_gb * self.duration_s

    @property
    def cost(self) -> float:
        return self.gb_seconds * LAMBDA_USD_PER_GB_S + LAMBDA_USD_PER_REQUEST


@dataclasses.dataclass(frozen=True)
class ServerlessJobCost:
    """Cost breakdown of one BSP job on Lambda (Fig 15/16 decomposition)."""

    workers: int
    mem_gb: float
    init_s: float             # NAT traversal / bootstrap phase
    compute_s: float          # data generation + computation phase
    step_fn_transitions: int  # Step Function states executed
    s3_puts: int = 0
    s3_gets: int = 0

    @property
    def init_cost(self) -> float:
        return self.workers * self.mem_gb * self.init_s * LAMBDA_USD_PER_GB_S

    @property
    def compute_cost(self) -> float:
        return self.workers * self.mem_gb * self.compute_s * LAMBDA_USD_PER_GB_S

    @property
    def lambda_request_cost(self) -> float:
        return self.workers * LAMBDA_USD_PER_REQUEST

    @property
    def orchestration_cost(self) -> float:
        return self.step_fn_transitions * STEP_FN_USD_PER_TRANSITION

    @property
    def storage_cost(self) -> float:
        return self.s3_puts * S3_USD_PER_PUT + self.s3_gets * S3_USD_PER_GET

    @property
    def total(self) -> float:
        return (
            self.init_cost
            + self.compute_cost
            + self.lambda_request_cost
            + self.orchestration_cost
            + self.storage_cost
        )


def step_function_transitions(workers: int) -> int:
    """States in the paper's Fig 7 machine: init -> validate -> Map fan-out
    (one ExtractAndInvokeLambda + Invoke per worker) -> collect."""
    return 4 + 2 * workers


def join_cost(
    workers: int,
    *,
    channel: str = "direct",
    mem_gb: float = 10.0,
    init_s: float | None = None,
    compute_s: float | None = None,
    shuffle_rounds: int = 10,
) -> ServerlessJobCost:
    """Cost of one distributed-join experiment (paper Fig 16 inputs).

    Defaults reproduce the paper's measured 32-node numbers; callers override
    the phase durations with measured/simulated values for other points.
    """
    from repro_torch.core import netsim
    from repro_torch.core import session as _session

    platform = netsim.LAMBDA_10GB if mem_gb >= 8 else netsim.LAMBDA_6GB
    if init_s is None:
        # Bootstrap is priced through the rendezvous model for EVERY channel
        # (it used to be a hard-coded 1.0 s for non-direct ones): the direct
        # channel pays the full NAT-traversal lifecycle (CommSession's priced
        # BOOTSTRAP events, = the paper's ~31.5 s at 32), storage channels
        # pay the store-rendezvous (atomic-counter registration + log2-depth
        # membership polling — milliseconds on redis, ~0.4 s on s3 at 32).
        if channel == "direct":
            init_s = _session.CommSession.bootstrap(
                workers, _session.Fabric(platform=platform)
            ).bootstrap_time_s
        else:
            init_s = _session.mediated_bootstrap_time(
                netsim.resolve_channel(channel), workers
            )
    if compute_s is None:
        ch = netsim.resolve_channel(channel)
        # strong-scaling join basis (paper Fig 15/16 cost basis): 4.5M rows,
        # `shuffle_rounds` iterations of (hash partition + alltoallv + local
        # join); local phase ~0.1 s/iteration at 32 workers (Table III).
        local_s = 0.1 * (32.0 / max(workers, 1)) * shuffle_rounds
        per_rank_bytes = int(4.5e6 / max(workers, 1) * 2 * 16)
        comm = sum(
            netsim.collective_time(ch, "alltoallv", workers, per_rank_bytes)
            + netsim.collective_time(ch, "barrier", workers, 0)
            for _ in range(shuffle_rounds)
        )
        compute_s = local_s + comm

    s3_puts = s3_gets = 0
    if channel == "s3":
        s3_puts = s3_gets = workers * shuffle_rounds

    return ServerlessJobCost(
        workers=workers,
        mem_gb=mem_gb,
        init_s=init_s,
        compute_s=compute_s,
        step_fn_transitions=step_function_transitions(workers),
        s3_puts=s3_puts,
        s3_gets=s3_gets,
    )


def relay_egress_cost(
    session,
    events=None,
    *,
    default_provider: str = "aws-lambda",
) -> list[float]:
    """Per-rank egress dollars for relay traffic crossing a provider boundary.

    Hole-punch-failed pairs relay every collective's payload through a
    mediator; when the two endpoints sit on *different* providers that
    traffic leaves each provider's network and is metered at its
    ``ProviderProfile.egress_usd_per_gb`` rate.  For each non-bootstrap
    event in ``events`` (default: the session log) and each currently
    relayed cross-provider pair inside that event's world, both endpoint
    ranks pay ``bytes_per_rank`` at their own provider's rate.  Same-provider
    worlds — even fully relayed ones — bill $0: intra-provider relay traffic
    never crosses the boundary.
    """
    from repro_torch.core import netsim
    from repro_torch.core.communicator import CollectiveKind

    if events is None:
        events = session.events

    def _provider(rank: int) -> str:
        name = None
        if rank < len(session.rank_providers):
            name = session.rank_providers[rank]
        return name or default_provider

    per_rank = [0.0] * session.world
    pairs = [
        (a, b)
        for a, b in session.link_map.relayed_pairs()
        if _provider(a) != _provider(b)
    ]
    if not pairs:
        return per_rank
    rate = {
        r: netsim.get_provider(_provider(r)).egress_usd_per_gb
        for pair in pairs for r in pair
    }
    for ev in events:
        if ev.kind is CollectiveKind.BOOTSTRAP:
            continue
        gb = ev.bytes_per_rank / 1e9
        for a, b in pairs:
            if a < ev.world and b < ev.world:
                per_rank[a] += gb * rate[a]
                per_rank[b] += gb * rate[b]
    return per_rank


def heterogeneous_run_cost(
    report,
    session,
    *,
    mem_gb: float = 10.0,
    default_provider: str = "aws-lambda",
) -> dict:
    """Price a BSP run whose ranks live on different providers (burst runs).

    Each rank is billed at ITS provider's per-GB-s and per-request rates
    (``netsim.ProviderProfile.invocation_cost``) for the wall time from its
    join point — a rank admitted by a burst before superstep k pays nothing
    for supersteps 0..k-1 or the initial bootstrap.  ``report`` is a
    :class:`core.bsp.RunReport` (``joined_at`` maps burst ranks to
    their join step); ``session`` supplies per-rank providers
    (``CommSession.rank_providers``, ``default_provider`` standing in for
    pre-registry fabrics).  Relay traffic between ranks on *different*
    providers additionally bills each endpoint's
    ``egress_usd_per_gb`` (:func:`relay_egress_cost`) into its per-rank
    total.  Ranks evicted by a mid-run shrink (``report.evicted``) are
    billed only up to their eviction step — from that superstep on, the
    survivors alone pay.  Returns ``{"total_usd", "per_rank_usd",
    "per_provider_usd", "egress_usd", "evicted_usd"}`` with
    ``total_usd == sum(per_rank_usd) + evicted_usd``.
    """
    from repro_torch.core import netsim

    step_total = {s.index: s.total_s for s in report.supersteps}
    egress = relay_egress_cost(session, default_provider=default_provider)
    per_rank: list[float] = []
    per_provider: dict[str, float] = {}
    for rank in range(report.world):
        name = None
        if rank < len(session.rank_providers):
            name = session.rank_providers[rank]
        prov = netsim.get_provider(name or default_provider)
        joined = report.joined_at.get(rank)
        if joined is None:
            wall = report.init_s + sum(step_total.values())
        else:
            wall = sum(t for i, t in step_total.items() if i >= joined)
        cost = prov.invocation_cost(mem_gb, wall)
        if rank < len(egress):
            cost += egress[rank]
        per_rank.append(cost)
        per_provider[prov.name] = per_provider.get(prov.name, 0.0) + cost
    # evicted ranks (pre-shrink labels): billed init + every superstep
    # strictly before their eviction step, at their own provider's rates
    evicted_usd = 0.0
    for e in getattr(report, "evicted", ()) or ():
        prov = netsim.get_provider(e.get("provider") or default_provider)
        wall = report.init_s + sum(
            t for i, t in step_total.items() if i < int(e["step"]))
        cost = prov.invocation_cost(mem_gb, wall)
        evicted_usd += cost
        per_provider[prov.name] = per_provider.get(prov.name, 0.0) + cost
    return {
        "total_usd": sum(per_rank) + evicted_usd,
        "per_rank_usd": per_rank,
        "per_provider_usd": per_provider,
        "egress_usd": sum(egress),
        "evicted_usd": evicted_usd,
    }


def ec2_cost(workers: int, wall_s: float, *, xlarge: bool = True, idle_fraction: float = 0.0) -> float:
    """Provisioned-VM cost for the same job; `idle_fraction` models the
    intermittent-workload idle time the paper argues dominates (§I C-iii)."""
    rate = EC2_M3_XLARGE_USD_PER_HR if xlarge else EC2_M3_LARGE_USD_PER_HR
    busy_hr = wall_s / 3600.0
    total_hr = busy_hr / max(1e-9, (1.0 - idle_fraction))
    return workers * rate * total_hr


def break_even_utilization(workers: int, mem_gb: float, job_s: float) -> float:
    """Fraction of the hour a provisioned cluster must be busy for EC2 to be
    cheaper than Lambda for repeated runs of this job."""
    lam = ServerlessJobCost(
        workers, mem_gb, init_s=0.0, compute_s=job_s,
        step_fn_transitions=step_function_transitions(workers),
    ).total
    jobs_per_hr_budget = workers * EC2_M3_XLARGE_USD_PER_HR / max(lam, 1e-12)
    busy_s_per_hr = jobs_per_hr_budget * job_s
    return min(1.0, busy_s_per_hr / 3600.0)


def revision_campaign_cost(
    executions: int = 120, mem_gb: float = 10.0, mean_duration_s: float = 160.0
) -> float:
    """Paper: 'The total cost for all revision experiments (120 Lambda
    executions across 5 experiment types) was only $3.25.'"""
    per = LambdaInvocation(mem_gb, mean_duration_s).cost
    return executions * per
