"""Object-store dataset partitioner: byte-range splits with data discovery.

The Lithops pattern for feeding serverless maps: the *client* never
downloads the dataset — it lists the objects in a store group
(``Store.list_objects``), sizes them (``object_size``: HEAD requests, both
priced ops), and cuts each object into ``chunk_bytes``-sized byte ranges.
Each :class:`DataPartition` is a self-describing unit of work a task can
fetch with one ranged GET, so a ``JobExecutor.map`` over the partitions
streams the dataset through N priced workers without any worker (or the
client) ever holding it whole — the out-of-core entry the dataframe layer
builds its CSV ETL on (``repro_torch.dataframe.io``).

Invariant (property-tested): the partitions of a group tile its bytes
exactly — every byte of every object is in exactly one partition.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence


@dataclasses.dataclass(frozen=True)
class DataPartition:
    """One byte range ``[start, stop)`` of one object — a unit of map work."""

    group: str
    key: str
    start: int
    stop: int
    index: int          # position in the job's partition list
    object_size: int    # total bytes of the source object

    @property
    def size_bytes(self) -> int:
        return self.stop - self.start

    @property
    def is_first(self) -> bool:
        return self.start == 0

    @property
    def is_last(self) -> bool:
        return self.stop >= self.object_size

    def read(self, store) -> bytes:
        """Fetch exactly this range (one priced ranged GET)."""
        return store.get_object(self.group, self.key, self.start, self.stop)


def partition_dataset(
    store,
    group: str,
    *,
    chunk_bytes: int,
    keys: Sequence[str] | None = None,
) -> list[DataPartition]:
    """Discover ``group``'s objects and split them into byte-range partitions.

    ``keys`` narrows discovery to specific objects (default: everything
    ``store.list_objects`` reports).  Each object becomes
    ``ceil(size / chunk_bytes)`` partitions; a zero-byte object yields
    none.  The returned list is ordered by (key, offset) and indexed
    contiguously — ready to hand to ``JobExecutor.map``.
    """
    if chunk_bytes < 1:
        raise ValueError(f"chunk_bytes must be >= 1, got {chunk_bytes}")
    names = list(keys) if keys is not None else store.list_objects(group)
    parts: list[DataPartition] = []
    for key in names:
        size = store.object_size(group, key)
        for lo in range(0, size, chunk_bytes):
            parts.append(DataPartition(
                group=group, key=key,
                start=lo, stop=min(lo + chunk_bytes, size),
                index=len(parts), object_size=size,
            ))
    return parts
