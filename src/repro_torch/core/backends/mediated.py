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

3. **SPMD emulation** (``staged_all_to_all`` / ``staged_allreduce`` /
   ``staged_all_to_all_chunked``): the same exchange through a staging hop
   on the mesh axes of :mod:`repro_torch.core.backends.direct` — every
   rank's payload gathered to every rank ("the store"), then sliced.  The
   bytes scale with P x payload through one point instead of payload/P per
   link, which is why mediated exchange loses; never a production path.
"""

from __future__ import annotations

import torch

from repro_torch.core import netsim
from repro_torch.core import session as _session
from repro_torch.core.backends import direct
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


# ---------------------------------------------------------------------------
# SPMD emulation of store staging (on the mesh axes of ``direct``)
# ---------------------------------------------------------------------------


def staged_all_to_all(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """All-to-all routed through a staging point.

    ``x`` is ``[P, chunk, ...]`` per rank (slot d destined to rank d).  The
    direct version is one all-to-all moving ``P*chunk`` per rank; the staged
    one materializes the full ``[P, P, chunk]`` matrix on every rank (PUT =
    all_gather) and each rank slices its inbox (GET): ``P**2 * chunk``
    through the gather.
    """
    me = direct.axis_index(axis, mesh)
    store = direct.allgather(x[None], axis, dim=0, mesh=mesh)  # [P, P, chunk, ...] everywhere
    return store[:, me].clone()                                 # [P, chunk, ...] from each src


def staged_allreduce(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """Allreduce through a store: PUT all shards (all_gather), reduce locally.

    Moves P*|x| bytes per rank instead of ~2|x| for a ring/tree reduction.
    """
    return direct.allgather(x[None], axis, dim=0, mesh=mesh).sum(0)


def staged_all_to_all_chunked(x: torch.Tensor, axis: str, *, chunks: int = 4,
                              mesh=None) -> torch.Tensor:
    """Chunked-pipelined rendition of :func:`staged_all_to_all`: the
    capacity dimension cut into ``chunks`` pieces, each taking the staging
    hop on its own (peak staged memory ``P^2 * cap / chunks``).  Results are
    identical to the monolithic hop."""
    if chunks <= 1:
        return staged_all_to_all(x, axis, mesh)
    cap = x.shape[1]
    if cap % chunks:
        raise ValueError(f"capacity {cap} not divisible by chunks {chunks}")
    step = cap // chunks
    return torch.cat([staged_all_to_all(x[:, i * step:(i + 1) * step], axis, mesh)
                      for i in range(chunks)], dim=1)
