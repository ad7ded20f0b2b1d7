"""The priced communicator substrate (own copies of the ``repro.core``
subset the distributed join and groupby need)."""

from repro_torch.core.communicator import (  # noqa: F401
    CollectiveKind,
    CommEvent,
    Communicator,
    make_communicator,
)
