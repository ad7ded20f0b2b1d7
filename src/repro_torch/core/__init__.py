"""Core: the paper's contribution — the port's own copy of ``repro.core``:
serverless communicator, comm sessions (bootstrap lifecycle + per-pair
links), NAT-traversal control plane, network/cost models, provider fabric
registry + cost-aware placement, and the modeled-clock span timeline every
priced layer emits onto.  The BSP runtime (``bsp``) is not ported yet
(ROADMAP A 10)."""

from repro_torch.core.netsim import (  # noqa: F401
    ProviderProfile,
    get_provider,
    providers,
    register_provider,
    resolve_channel,
    resolve_provider,
)
from repro_torch.core.faults import FaultPlan  # noqa: F401
from repro_torch.core.algorithms import (  # noqa: F401
    Choice,
    DecisionCache,
    GroupLinks,
    Placement,
    Workload,
    algorithm_time,
    algorithms_for,
    hybrid_algorithm_time,
    placement_candidates,
    provider_links,
    select_algorithm,
    select_hybrid,
    select_placement,
    overlap_pipeline_time,
    tuned_time,
)
from repro_torch.core.trace import (  # noqa: F401
    LANES,
    Span,
    TraceError,
    Tracer,
)
from repro_torch.core.session import (  # noqa: F401
    FABRICS,
    CommSession,
    Fabric,
    Link,
    LinkMap,
    hybrid_session,
    mediated_bootstrap_time,
    provider_fabric,
)
from repro_torch.core.communicator import (  # noqa: F401
    CollectiveKind,
    CommEvent,
    Communicator,
    make_communicator,
)
