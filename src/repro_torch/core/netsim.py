"""Calibrated platform + network models for the paper's infrastructures —
the port's own copy of ``repro.core.netsim`` (formulas and constants
verbatim, so every modeled second is equal to the reference's).

Every constant here is calibrated against a *measured* number published in the
paper (tables II/III/IV, figures 10-16).  The simulator composes execution time
as::

    T(world) = T_init(world) + T_datagen + T_compute(rows, platform)
               + T_comm(event log, channel model)

`T_compute` is measured on this host by actually running the operator on the
real data, then rescaled by the platform's relative CPU speed; `T_comm` is the
alpha-beta model below applied to the communicator's event log; `T_init` is the
NAT/bootstrap model (binomial-tree connection schedule, paper Fig 14).

Channel models
--------------
direct  : alpha-beta over peer-to-peer links (NAT hole-punched TCP on Lambda,
          plain TCP on EC2, IB verbs on HPC).
redis   : every exchange staged through one in-memory store: bytes cross the
          wire twice and the store NIC is a shared bottleneck (no 1/P scaling).
s3      : as redis, but with per-object request latency ~50 ms and lower
          effective bandwidth (paper: per-object PUT/GET round-trip overhead).
"""

from __future__ import annotations

import dataclasses
import math
import warnings

# ---------------------------------------------------------------------------
# Channel (communication substrate) models — paper §IV-B, Fig 10/12/13
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChannelModel:
    """alpha-beta cost model for one communication substrate."""

    name: str
    alpha_s: float            # per-message latency (seconds)
    beta_s_per_byte: float    # per-byte wire time on the bottleneck path
    staged: bool = False      # True => store-mediated (bytes cross twice, no 1/P)
    store_alpha_s: float = 0.0  # extra per-object latency at the store

    def point_to_point_time(self, nbytes: int) -> float:
        if self.staged:
            # PUT + GET through the store.
            return 2.0 * (self.alpha_s + self.store_alpha_s) + 2.0 * nbytes * self.beta_s_per_byte
        return self.alpha_s + nbytes * self.beta_s_per_byte


# Direct TCP between Lambda functions (NAT hole-punched).  Calibrated against
# Fig 13 (barrier, binomial tree): 0.9 ms @2 nodes (1 level), 2.7 ms @8 (3
# levels), 7 ms @32 (5 levels) — per-level latency grows mildly with fan-in
# congestion, modeled as alpha*(1 + world/64); and Fig 12 (AllReduce ~13 ms
# @32 nodes = 2 phases x 5 levels x 1.35 ms, flat in message size => latency
# bound).
LAMBDA_DIRECT = ChannelModel("direct", alpha_s=0.9e-3, beta_s_per_byte=1.0 / 600e6)

# EC2 / placement-group TCP: slightly lower latency, same-order bandwidth.
EC2_DIRECT = ChannelModel("direct", alpha_s=0.9e-3, beta_s_per_byte=1.0 / 1.0e9)

# HPC (Rivanna, IB verbs via UCX): microsecond-class latency.
HPC_DIRECT = ChannelModel("direct", alpha_s=5e-6, beta_s_per_byte=1.0 / 10e9)

# Redis (ElastiCache) staging: in-memory but serialized through one NIC
# (~10 Gb/s cache.m5) and a serialization hop.  Calibrated jointly on Fig 10
# (weak-scaling join @32: ~255 s vs ~60 s direct) and Fig 15 (join/redis
# ~$0.032 at 32 nodes => ~5-6 s strong-scaling execution).
REDIS_STAGED = ChannelModel(
    "redis", alpha_s=0.7e-3, beta_s_per_byte=1.0 / 0.8e9, staged=True, store_alpha_s=0.6e-3
)

# S3 staging: per-object PUT/GET round trips dominate (Fig 10: ~455 s @32;
# Fig 16: join/s3 ~$0.150 = 4.7x redis).
S3_STAGED = ChannelModel(
    "s3", alpha_s=10e-3, beta_s_per_byte=1.0 / 450e6, staged=True, store_alpha_s=20e-3
)

# ---------------------------------------------------------------------------
# Platform models — paper Table I infrastructure
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlatformModel:
    """One row of paper Table I: an execution platform for the scaling study."""

    name: str
    cpu_speed: float          # relative single-core throughput (EC2 Ivy Bridge = 1.0)
    cores: int                # usable cores per worker
    mem_gb: float
    channel: ChannelModel
    init_per_level_s: float   # connection/bootstrap setup per binomial-tree level
    init_base_s: float        # world-size independent startup (runtime import, etc.)
    sched_jitter_s: float     # per-doubling scheduling overhead (weak-scaling drift)

    def init_time(self, world: int) -> float:
        """Connection-establishment phase (closed form).

        The paper observes the NAT-traversal init phase "scales linearly with
        the number of tree levels in the binomial connection algorithm"
        (§IV-E) and measures ~31.5 s at 32 nodes for Lambda.  The BSP runtime
        and cost model no longer call this directly: ``CommSession.bootstrap``
        emits the same total as itemized, priced BOOTSTRAP events (rendezvous
        + one event per punch level) in the session's event log.
        """
        levels = max(0, math.ceil(math.log2(world))) if world > 1 else 0
        return self.init_base_s + levels * self.init_per_level_s


# Rivanna Cascade Lake is ~40% better IPC than EC2 Ivy Bridge (paper §IV-A).
EC2_XL = PlatformModel(
    "ec2-15gb-4vcpu", cpu_speed=1.00, cores=4, mem_gb=15.0, channel=EC2_DIRECT,
    init_per_level_s=0.35, init_base_s=0.8, sched_jitter_s=0.55,
)
EC2_L = PlatformModel(
    "ec2-7.5gb-2vcpu", cpu_speed=1.00, cores=2, mem_gb=7.5, channel=EC2_DIRECT,
    init_per_level_s=0.35, init_base_s=0.8, sched_jitter_s=0.65,
)
LAMBDA_10GB = PlatformModel(
    "lambda-10gb", cpu_speed=1.04, cores=6, mem_gb=10.0, channel=LAMBDA_DIRECT,
    init_per_level_s=6.3, init_base_s=0.0, sched_jitter_s=1.05,
)
LAMBDA_6GB = PlatformModel(
    "lambda-6gb", cpu_speed=0.98, cores=4, mem_gb=6.0, channel=LAMBDA_DIRECT,
    init_per_level_s=6.3, init_base_s=0.0, sched_jitter_s=1.05,
)
RIVANNA_10GB = PlatformModel(
    "rivanna-10gb", cpu_speed=1.40, cores=4, mem_gb=10.0, channel=HPC_DIRECT,
    init_per_level_s=0.05, init_base_s=0.3, sched_jitter_s=0.28,
)
RIVANNA_6GB = PlatformModel(
    "rivanna-6gb", cpu_speed=1.40, cores=4, mem_gb=6.0, channel=HPC_DIRECT,
    init_per_level_s=0.05, init_base_s=0.3, sched_jitter_s=0.28,
)


@dataclasses.dataclass(frozen=True)
class DetectorModel:
    """Heartbeat/timeout failure detector on the modeled clock.

    A peer is *suspected* after ``suspect_missed`` heartbeat periods pass
    without an ack, then *confirmed* dead by ``confirm_probes`` direct probes
    that each time out after ``probe_timeout_s``.  Both phases are priced as
    ``DETECT`` events on the session's ``overhead`` lane so
    ``Tracer.critical_path()`` shows detection latency inside recovery time.
    """

    heartbeat_period_s: float = 0.5
    suspect_missed: int = 3        # missed heartbeats before suspicion
    confirm_probes: int = 2        # direct probes confirming the suspicion
    probe_timeout_s: float = 1.0   # each confirm probe's timeout

    def suspect_s(self) -> float:
        """Seconds from failure to suspicion (missed-heartbeat window)."""
        return self.heartbeat_period_s * self.suspect_missed

    def confirm_s(self) -> float:
        """Seconds from suspicion to confirmation (probe timeouts)."""
        return self.probe_timeout_s * self.confirm_probes


DEFAULT_DETECTOR = DetectorModel()

# ---------------------------------------------------------------------------
# Provider fabric registry
# ---------------------------------------------------------------------------
#
# The calibrated constants above answer "Lambda vs EC2 on AWS".  A
# ProviderProfile packages one provider's whole offer — direct channel,
# staged channels, compute/request prices, bootstrap parameters, NAT
# behavior — as *data*, so the placement engine
# (``algorithms.select_placement``) and the session layer
# (``CommSession.expand(provider=...)``) can reason across clouds.  The
# registry is seeded from the calibrated AWS presets; CHANNELS/PLATFORMS
# below stay thin views over those entries so every paper-figure test keeps
# pricing against the identical objects.


def mediated_bootstrap_time(channel: ChannelModel, world: int) -> float:
    """Bootstrap through a store rendezvous (no hole punching).

    Each worker INCRs the atomic rank counter, writes its metadata record,
    reads the peer table, and confirms membership (~4 store round trips,
    concurrent across workers), then polls a tree-depth's worth of rounds
    until the full world has registered — the same log2-depth convergence
    the staged barrier pays.  Lives here (the lowest layer) so both the
    session lifecycle and the placement engine price it without an import
    cycle; re-exported by ``repro_torch.core.session`` for compatibility.
    """
    if world < 1:
        raise ValueError("world must be >= 1")
    per_obj = channel.alpha_s + channel.store_alpha_s
    levels = max(0, math.ceil(math.log2(world))) if world > 1 else 0
    return 4.0 * per_obj + 2.0 * per_obj * levels


@dataclasses.dataclass(frozen=True)
class ProviderProfile:
    """One compute provider: channels, prices, and bootstrap behavior.

    ``platform`` carries the rendezvous/bootstrap parameters (per-level
    punch cost, base startup — for ``hpc`` kinds the base models batch-queue
    wait) and the relative CPU speed; ``direct`` is the peer-to-peer channel
    hole-punched pairs use; ``staged`` lists the provider's store channels;
    ``relay`` is the default mediated fallback for pairs that cannot be
    punched (cross-provider pairs, symmetric NAT).  ``nat_blocked_rate`` is
    the fraction of pairs whose hole punch fails *permanently* on this
    provider's network (0 on AWS per the paper; stricter NATs relay more).
    Prices follow the serverless GB-second + per-request shape; serverful
    providers express their hourly rate as an equivalent GB-second rate with
    ``usd_per_request = 0``.
    """

    name: str
    kind: str                                  # "serverless" | "serverful" | "hpc"
    platform: PlatformModel
    direct: ChannelModel
    staged: tuple[ChannelModel, ...] = ()
    relay: ChannelModel | None = None
    usd_per_gb_s: float = 0.0
    usd_per_request: float = 0.0
    nat_blocked_rate: float = 0.0
    # billed per GB a worker on this provider sends to *another* provider
    # (relay traffic crossing the provider boundary); intra-provider traffic
    # is free on every preset, so a homogeneous world pays $0 egress
    egress_usd_per_gb: float = 0.0

    @property
    def relay_channel(self) -> ChannelModel:
        ch = self.relay or (self.staged[0] if self.staged else None)
        if ch is None:
            raise ValueError(f"provider {self.name!r} has no relay/staged channel")
        return ch

    def bootstrap_time(self, world: int) -> float:
        """Cold-bootstrap seconds for a world on this provider: the NAT
        lifecycle closed form for punched fabrics, the store rendezvous for
        staged direct channels."""
        if self.direct.staged:
            return mediated_bootstrap_time(self.direct, world)
        return self.platform.init_time(world)

    def invocation_cost(self, mem_gb: float, duration_s: float) -> float:
        """One worker's cost for ``duration_s`` seconds at ``mem_gb``."""
        return mem_gb * duration_s * self.usd_per_gb_s + self.usd_per_request


_PROVIDERS: dict[str, ProviderProfile] = {}


def register_provider(profile: ProviderProfile, overwrite: bool = False) -> ProviderProfile:
    """Add a provider to the registry (``overwrite=False`` protects the
    calibrated presets from accidental shadowing)."""
    if not overwrite and profile.name in _PROVIDERS:
        raise ValueError(f"provider {profile.name!r} already registered")
    _PROVIDERS[profile.name] = profile
    return profile


def get_provider(name: str | ProviderProfile) -> ProviderProfile:
    """Look up a registered provider (profiles pass through unchanged)."""
    if isinstance(name, ProviderProfile):
        return name
    try:
        return _PROVIDERS[name]
    except KeyError:
        raise ValueError(
            f"unknown provider {name!r}; registered: {sorted(_PROVIDERS)}"
        ) from None


def providers() -> tuple[str, ...]:
    return tuple(sorted(_PROVIDERS))


# -- calibrated AWS seeds (prices: public us-east-1 list, matching
#    cost_model.py constants) ------------------------------------------------

AWS_LAMBDA = register_provider(ProviderProfile(
    name="aws-lambda", kind="serverless", platform=LAMBDA_10GB,
    direct=LAMBDA_DIRECT, staged=(REDIS_STAGED, S3_STAGED), relay=REDIS_STAGED,
    usd_per_gb_s=0.0000166667, usd_per_request=0.20 / 1e6,
    nat_blocked_rate=0.0,  # the paper achieved full traversal on Lambda
    egress_usd_per_gb=0.09,  # AWS internet-egress tier ($0.09/GB)
))
AWS_EC2 = register_provider(ProviderProfile(
    name="aws-ec2", kind="serverful", platform=EC2_XL,
    direct=EC2_DIRECT, staged=(REDIS_STAGED, S3_STAGED), relay=REDIS_STAGED,
    # m3.xlarge $0.266/hr over 15 GB => equivalent GB-second rate
    usd_per_gb_s=0.266 / 3600.0 / 15.0, usd_per_request=0.0,
    nat_blocked_rate=0.0,  # placement group: no NAT between instances
    egress_usd_per_gb=0.09,  # AWS internet-egress tier ($0.09/GB)
))

# -- non-AWS presets ----------------------------------------------------------

# Cloud Run-style container serverless: gen2 cold starts are faster than the
# paper's Lambda runtime (per-level ~3.2 s vs 6.3 s) but its NAT is stricter
# (direct-VPC egress is optional), so a fraction of pairs never punch and
# relay through the memorystore channel.  Pricing: vCPU-s + GiB-s folded
# into one GB-second rate (~4 vCPU / 10 GiB shape), per-request $0.40/M.
CLOUDRUN_DIRECT = ChannelModel("direct", alpha_s=1.2e-3, beta_s_per_byte=1.0 / 500e6)
CLOUDRUN_10GB = PlatformModel(
    "cloudrun-10gb", cpu_speed=1.00, cores=4, mem_gb=10.0, channel=CLOUDRUN_DIRECT,
    init_per_level_s=3.2, init_base_s=0.5, sched_jitter_s=0.9,
)
GCP_CLOUDRUN = register_provider(ProviderProfile(
    name="gcp-cloudrun", kind="serverless", platform=CLOUDRUN_10GB,
    direct=CLOUDRUN_DIRECT, staged=(REDIS_STAGED,), relay=REDIS_STAGED,
    usd_per_gb_s=0.0000121, usd_per_request=0.40 / 1e6,
    nat_blocked_rate=0.05,
    egress_usd_per_gb=0.12,  # GCP premium-tier internet egress ($0.12/GB)
))

# Slurm-style HPC allocation: Rivanna-class interconnect and CPUs, near-zero
# per-level punch cost, but the *base* startup is the batch-queue wait — the
# cost-aware placer should only send work there when the deadline absorbs
# it.  Pricing: ~$0.10 per node-hour allocation over a 10 GB job slot.
SLURM_CPU = PlatformModel(
    "hpc-slurm-10gb", cpu_speed=1.40, cores=4, mem_gb=10.0, channel=HPC_DIRECT,
    init_per_level_s=0.05, init_base_s=45.0, sched_jitter_s=0.28,
)
HPC_SLURM = register_provider(ProviderProfile(
    name="hpc-slurm", kind="hpc", platform=SLURM_CPU,
    direct=HPC_DIRECT, staged=(REDIS_STAGED,), relay=REDIS_STAGED,
    usd_per_gb_s=0.10 / 3600.0 / 10.0, usd_per_request=0.0,
    nat_blocked_rate=0.0,
    egress_usd_per_gb=0.0,  # campus HPC: no metered egress
))


# ---------------------------------------------------------------------------
# Thin compat views over the registry
# ---------------------------------------------------------------------------
#
# The historical dicts every calibrated test and benchmark keys on.  They
# alias the registry's seeded entries (plus the Table I size variants that
# have no separate provider), so the calibration cannot fork from the
# registry: the paper-figure tests and ``select_placement`` price the
# identical ChannelModel / PlatformModel objects.

CHANNELS = {
    "direct": AWS_LAMBDA.direct,
    "ec2-direct": AWS_EC2.direct,
    "hpc-direct": HPC_SLURM.direct,
    "redis": AWS_LAMBDA.staged[0],
    "s3": AWS_LAMBDA.staged[1],
}

PLATFORMS = {
    p.name: p
    for p in (AWS_EC2.platform, EC2_L, AWS_LAMBDA.platform, LAMBDA_6GB,
              RIVANNA_10GB, RIVANNA_6GB)
}


# ---------------------------------------------------------------------------
# "Where this runs" resolution — the ONE entry point
# ---------------------------------------------------------------------------
#
# Everything above CHANNELS is calibration data; everything below is how the
# rest of the repo is allowed to name it.  ``resolve_provider`` turns any of
# the historical ways of saying "where this runs" — a provider name, a
# ProviderProfile, a platform + channel pair, or the deprecated
# ``channel_env`` string — into one canonical ProviderProfile.  Raw
# ``CHANNELS[...]`` string lookups outside this shim are a lint-the-review
# offense: they bypass the registry and fork "where" from "how much".


def resolve_channel(channel: str | ChannelModel) -> ChannelModel:
    """Channel-name compat shim: the only sanctioned string->channel map."""
    if isinstance(channel, ChannelModel):
        return channel
    try:
        return CHANNELS[channel]
    except KeyError:
        raise ValueError(
            f"unknown channel {channel!r}; options: {sorted(CHANNELS)}"
        ) from None


def resolve_platform(platform: str | PlatformModel) -> PlatformModel:
    """Platform-name compat shim: the only sanctioned string->platform map
    (the Table I size variants have no registered provider of their own, so
    callers sweeping them resolve here instead of subscripting the table)."""
    if isinstance(platform, PlatformModel):
        return platform
    try:
        return PLATFORMS[platform]
    except KeyError:
        raise ValueError(
            f"unknown platform {platform!r}; options: {sorted(PLATFORMS)}"
        ) from None


# derived profiles (e.g. aws-lambda forced onto its redis staging channel)
# are interned here so repeated resolution returns the identical object
_DERIVED: dict[tuple, ProviderProfile] = {}


def resolve_provider(
    provider: str | ProviderProfile | None = None,
    *,
    platform: PlatformModel | None = None,
    channel: str | ChannelModel | None = None,
    channel_env: str | None = None,
) -> ProviderProfile:
    """Resolve "where this runs" to a canonical :class:`ProviderProfile`.

    Exactly one way in:

    - ``provider``: a registered name (``"aws-lambda"``) or a profile —
      returned as-is from the registry; may not be combined with
      ``platform``/``channel`` (a profile already names both).
    - ``platform`` and/or ``channel``: a derived profile — the registered
      provider owning that platform/channel (falling back to ``aws-lambda``)
      with the overrides applied.  ``resolve_provider(channel="redis")``
      yields Lambda workers whose *direct* substrate is the redis staging
      channel, exactly what the old ``channel_env="redis"`` meant.
    - ``channel_env``: the deprecated spelling of ``channel`` — emits a
      ``DeprecationWarning`` and resolves the same way.
    - nothing: the calibrated default, ``aws-lambda``.

    Derived profiles are interned, so resolution is referentially stable.
    """
    if channel_env is not None:
        warnings.warn(
            "channel_env= is deprecated; say where this runs with "
            "provider=... (e.g. provider='aws-lambda') or channel=...",
            DeprecationWarning,
            stacklevel=2,
        )
        if channel is not None:
            raise ValueError("pass channel= or the deprecated channel_env=, not both")
        channel = channel_env
    if provider is not None:
        if platform is not None or channel is not None:
            raise ValueError(
                "provider= already names the platform and channel; "
                "don't combine it with platform=/channel="
            )
        return get_provider(provider)
    if platform is None and channel is None:
        return AWS_LAMBDA

    ch = resolve_channel(channel) if channel is not None else None
    base = None
    if platform is not None:
        base = next(
            (p for p in _PROVIDERS.values() if p.platform is platform), None
        )
    if base is None and ch is not None:
        base = next((p for p in _PROVIDERS.values() if p.direct is ch), None)
    base = base or AWS_LAMBDA

    overrides: dict = {}
    suffix = []
    if platform is not None and platform is not base.platform:
        overrides["platform"] = platform
        suffix.append(platform.name)
    if ch is not None and ch is not base.direct:
        overrides["direct"] = ch
        suffix.append(ch.name)
    if not overrides:
        return base
    key = (base.name, *suffix)
    if key not in _DERIVED:
        _DERIVED[key] = dataclasses.replace(
            base, name=f"{base.name}@{'+'.join(suffix)}", **overrides
        )
    return _DERIVED[key]


# ---------------------------------------------------------------------------
# Collective time composition
# ---------------------------------------------------------------------------


def collective_time(
    channel: ChannelModel,
    kind: str,
    world: int,
    bytes_per_rank: int,
    algorithm: str | None = None,
) -> float:
    """Time for one collective under the channel model.

    ``algorithm=None`` (default) prices the *calibrated fixed schedule* — the
    one the paper's FMI actually ran and that Figs 12/13 were measured on:
    binomial tree for reductions, pairwise exchange for alltoall, monolithic
    PUT/GET for staged channels.  ``algorithm="auto"`` asks the tuned engine
    (``repro_torch.core.algorithms``) for the min-modeled-time schedule; any other
    string prices that named schedule explicitly.

    direct:  tree/ring algorithms — latency term scales with log2(P) rounds
             (binomial tree, paper Fig 13), bandwidth term with the per-link
             share of the data.
    staged:  every rank PUTs its payload then GETs its inbox; the store NIC is
             a single shared bottleneck so the bandwidth term carries the FULL
             world's bytes twice, serialized (this is exactly why the paper
             measures 10-100x: the 1/P term is gone and alpha is per-object).
    """
    if world <= 1:
        return 0.0
    if algorithm is not None and algorithm != "fixed":
        from repro_torch.core import algorithms  # deferred: algorithms imports netsim

        if algorithm == "auto":
            return algorithms.tuned_time(channel, kind, world, bytes_per_rank)
        return algorithms.algorithm_time(channel, kind, world, bytes_per_rank, algorithm)
    rounds = max(1, math.ceil(math.log2(world)))
    total_bytes = bytes_per_rank * world

    if channel.staged:
        # Every exchange is a PUT then a GET through the store: per-object
        # round-trip latency (experienced per rank, concurrent across ranks)
        # plus the full world's bytes crossing the store NIC twice,
        # serialized — the 1/P link-share term of direct exchange is gone.
        per_obj = channel.alpha_s + channel.store_alpha_s
        if kind == "barrier":
            # one sentinel object per rank + polling round trips up the tree
            return 2.0 * per_obj * rounds
        if kind in ("alltoall", "alltoallv"):
            # per-destination objects: world PUTs + world GETs per rank
            # (paper: "per-object PUT/GET round-trip overhead for each
            # shuffle exchange")
            nobj_per_rank = 2.0 * world
        else:
            nobj_per_rank = 4.0  # PUT shard / GET staged result (+ control)
        return nobj_per_rank * per_obj + 2.0 * total_bytes * channel.beta_s_per_byte

    # direct peer-to-peer; mild fan-in congestion on per-hop latency
    # (calibrated on Fig 13: 0.9/2.7/7 ms barrier at 2/8/32 nodes)
    alpha_eff = channel.alpha_s * (1.0 + world / 64.0)
    if kind == "barrier":
        return rounds * alpha_eff
    if kind == "reduce_scatter":
        # ONE phase (the reduce half of an allreduce) moving (P-1)/P of the
        # payload — pricing it as a full ALLREDUCE-class event double-charged
        # every reduce-scatter + allgather decomposition
        return rounds * alpha_eff + (
            (world - 1) / world
        ) * bytes_per_rank * channel.beta_s_per_byte
    if kind in ("allreduce", "allgather", "allgatherv", "bcast"):
        # tree: reduce + broadcast phases of log2(P) hops each, plus ~2x data
        # over the slowest link share (Fig 12: 13 ms @32, flat in size)
        return 2.0 * rounds * alpha_eff + 2.0 * bytes_per_rank * channel.beta_s_per_byte
    if kind in ("alltoall", "alltoallv"):
        # P-1 pairwise exchanges, overlapped across links: alpha*(P-1) hidden by
        # pipelining down to ~rounds, bandwidth = full per-rank payload out+in.
        return rounds * alpha_eff + 2.0 * bytes_per_rank * channel.beta_s_per_byte
    if kind in ("gather", "scatter", "p2p", "send", "recv"):
        return alpha_eff + bytes_per_rank * channel.beta_s_per_byte
    raise ValueError(f"unknown collective kind {kind!r}")
