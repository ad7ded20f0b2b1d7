"""Distributed Memory Dataframe (DDMF) — the Cylon analogue (paper §III-A),
on PyTorch tensors: a fixed-capacity columnar table per rank, P of them for
the distributed form."""

from repro_torch.dataframe.table import Table, Schema  # noqa: F401
from repro_torch.dataframe.partition import (  # noqa: F401
    build_partition_payload,
    hash32,
    hash_columns,
)
from repro_torch.dataframe import io, ops_dist, ops_local  # noqa: F401
