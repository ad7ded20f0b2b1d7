"""Calibrated channel models for the paper's communication substrates — the
port's own copy of the subset of ``repro.core.netsim`` that prices a shuffle.

The formulas and constants are the reference's, verbatim, so the modeled
seconds come out bit-identical; each constant is calibrated in the reference
against a number the paper publishes (Figs 10-16).

direct  : alpha-beta over peer-to-peer links (NAT hole-punched TCP on Lambda,
          plain TCP on EC2, IB verbs on HPC).
redis   : every exchange staged through one in-memory store: bytes cross the
          wire twice and the store NIC is a shared bottleneck (no 1/P scaling).
s3      : as redis, but with per-object request latency ~50 ms and lower
          effective bandwidth (per-object PUT/GET round-trip overhead).
"""

from __future__ import annotations

import dataclasses
import math


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


# Direct TCP between Lambda functions (NAT hole-punched); Fig 13 barrier and
# Fig 12 allreduce calibration.
LAMBDA_DIRECT = ChannelModel("direct", alpha_s=0.9e-3, beta_s_per_byte=1.0 / 600e6)

# EC2 / placement-group TCP: slightly lower latency, same-order bandwidth.
EC2_DIRECT = ChannelModel("direct", alpha_s=0.9e-3, beta_s_per_byte=1.0 / 1.0e9)

# HPC (Rivanna, IB verbs via UCX): microsecond-class latency.
HPC_DIRECT = ChannelModel("direct", alpha_s=5e-6, beta_s_per_byte=1.0 / 10e9)

# Redis (ElastiCache) staging: in-memory but serialized through one NIC;
# Fig 10 weak-scaling join and Fig 15 cost calibration.
REDIS_STAGED = ChannelModel(
    "redis", alpha_s=0.7e-3, beta_s_per_byte=1.0 / 0.8e9, staged=True, store_alpha_s=0.6e-3
)

# S3 staging: per-object PUT/GET round trips dominate (Fig 10, Fig 16).
S3_STAGED = ChannelModel(
    "s3", alpha_s=10e-3, beta_s_per_byte=1.0 / 450e6, staged=True, store_alpha_s=20e-3
)

# the reference's compat view, under the same five names
CHANNELS = {
    "direct": LAMBDA_DIRECT,
    "ec2-direct": EC2_DIRECT,
    "hpc-direct": HPC_DIRECT,
    "redis": REDIS_STAGED,
    "s3": S3_STAGED,
}


def resolve_channel(channel: str | ChannelModel) -> ChannelModel:
    """The only sanctioned string->channel map."""
    if isinstance(channel, ChannelModel):
        return channel
    try:
        return CHANNELS[channel]
    except KeyError:
        raise ValueError(
            f"unknown channel {channel!r}; options: {sorted(CHANNELS)}"
        ) from None


def collective_time(
    channel: ChannelModel,
    kind: str,
    world: int,
    bytes_per_rank: int,
    algorithm: str | None = None,
) -> float:
    """Time for one collective under the channel model.

    ``algorithm=None`` (or ``"fixed"``) prices the calibrated fixed schedule
    the paper's FMI ran: binomial tree for reductions, pairwise exchange for
    alltoall, monolithic PUT/GET for staged channels.  ``"auto"`` asks the
    tuned engine (:mod:`repro_torch.core.algorithms`) for the
    min-modeled-time schedule; any other string prices that named schedule.
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
        # PUT then GET through the store: per-object round trips plus the
        # full world's bytes crossing the store NIC twice, serialized.
        per_obj = channel.alpha_s + channel.store_alpha_s
        if kind == "barrier":
            # one sentinel object per rank + polling round trips up the tree
            return 2.0 * per_obj * rounds
        if kind in ("alltoall", "alltoallv"):
            # per-destination objects: world PUTs + world GETs per rank
            nobj_per_rank = 2.0 * world
        else:
            nobj_per_rank = 4.0  # PUT shard / GET staged result (+ control)
        return nobj_per_rank * per_obj + 2.0 * total_bytes * channel.beta_s_per_byte

    # direct peer-to-peer; mild fan-in congestion on per-hop latency
    alpha_eff = channel.alpha_s * (1.0 + world / 64.0)
    if kind == "barrier":
        return rounds * alpha_eff
    if kind == "reduce_scatter":
        return rounds * alpha_eff + (
            (world - 1) / world
        ) * bytes_per_rank * channel.beta_s_per_byte
    if kind in ("allreduce", "allgather", "allgatherv", "bcast"):
        return 2.0 * rounds * alpha_eff + 2.0 * bytes_per_rank * channel.beta_s_per_byte
    if kind in ("alltoall", "alltoallv"):
        return rounds * alpha_eff + 2.0 * bytes_per_rank * channel.beta_s_per_byte
    if kind in ("gather", "scatter", "p2p", "send", "recv"):
        return alpha_eff + bytes_per_rank * channel.beta_s_per_byte
    raise ValueError(f"unknown collective kind {kind!r}")
