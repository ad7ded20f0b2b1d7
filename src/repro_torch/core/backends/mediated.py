"""Store-mediated backends (Redis / S3) — the paper's comparison substrates;
the port's own copy of the three communicator factories of
``repro.core.backends.mediated``.

1. **Simulation pricing**: `redis_communicator` / `s3_communicator` are
   :class:`Communicator` instances whose channel models carry the measured
   constants from paper Fig 10/15/16 (PUT+GET per exchange, shared store NIC,
   per-object latency).

2. **Relay fallback** (`hybrid_communicator`): the store is also the paper's
   Fig 5 escape hatch for pairs that cannot hole-punch — one call builds a
   session-bootstrapped communicator whose blocked pairs relay through
   redis/s3 while every other pair stays direct, priced link-aware.

The reference's SPMD emulation of store staging (``staged_all_to_all``,
``staged_allreduce``, ``staged_all_to_all_chunked``) belongs to the SPMD
surface (ROADMAP A 5).
"""

from __future__ import annotations

from repro_torch.core import netsim
from repro_torch.core import session as _session
from repro_torch.core.communicator import Communicator


def redis_communicator(world_size: int) -> Communicator:
    return Communicator(world_size, netsim.REDIS_STAGED)


def s3_communicator(world_size: int) -> Communicator:
    return Communicator(world_size, netsim.S3_STAGED)


def hybrid_communicator(
    world_size: int,
    blocked_pairs=(),
    *,
    relay: str = "redis",
    platform: netsim.PlatformModel = netsim.LAMBDA_10GB,
) -> Communicator:
    """Bootstrapped communicator in which ``blocked_pairs`` failed hole
    punching and fall back to the mediated ``relay`` channel (paper Fig 5's
    rendezvous -> punch -> storage-fallback lifecycle in one call)."""
    return _session.hybrid_session(
        world_size, blocked_pairs, relay=relay, platform=platform
    ).communicator()
