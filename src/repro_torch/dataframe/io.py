"""Out-of-core CSV ETL: object-store byte ranges -> fixed-capacity Tables —
the port of ``repro.dataframe.io``.

The dataframe-layer consumer of the jobs partitioner
(:mod:`repro_torch.jobs.partitioner`): a CSV object living in a
``dist.object_store.Store`` is cut into byte-range partitions, and each
partition parses *only its own lines* into a :class:`~repro_torch.dataframe
.table.Table` — so N serverless tasks can ETL a dataset none of them could
hold, each paying for exactly the ranged GETs it issues.

Line-ownership convention (the standard one for byte-range CSV splits): a
data row belongs to the partition containing its **first byte**.  A
partition therefore (a) skips forward past the first newline in its range
unless it starts the object (those bytes are the tail of a row the
previous partition owns), and (b) reads past its ``stop`` boundary to
finish its final row (a small ranged-GET extension).  Applied across a
partitioning that tiles the bytes exactly — which ``partition_dataset``
guarantees — every row is parsed exactly once.

Parsing stays a host row loop (each cell through ``float()``), copied from
the reference so that values and error messages are identical; only the
finished columns go to the Table's ``device`` (the card unless the caller
names the CPU).  ``Table.from_dict`` turns the float64 columns into
float32, as the reference's Tables hold them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.dataframe.table import Table
from repro_torch.jobs.partitioner import DataPartition

# how far past the partition boundary one extension GET reaches while
# looking for the end of the final row; doubles until a newline or EOF
_TAIL_PROBE_BYTES = 4096


def read_header(store, group: str, key: str) -> list[str]:
    """Column names from the object's first line (one small ranged GET,
    extended geometrically if the header outruns the probe)."""
    probe = _TAIL_PROBE_BYTES
    size = store.object_size(group, key)
    while True:
        chunk = store.get_object(group, key, 0, min(probe, size))
        nl = chunk.find(b"\n")
        if nl >= 0 or probe >= size:
            line = chunk if nl < 0 else chunk[:nl]
            return [c.strip() for c in line.decode().split(",")]
        probe *= 2


def _extend_to_newline(store, part: DataPartition, data: bytes) -> bytes:
    """Append bytes past ``part.stop`` until the final row terminates."""
    pos = part.stop
    probe = _TAIL_PROBE_BYTES
    while not part.is_last and not data.endswith(b"\n"):
        hi = min(pos + probe, part.object_size)
        tail = store.get_object(part.group, part.key, pos, hi)
        nl = tail.find(b"\n")
        if nl >= 0:
            return data + tail[:nl + 1]
        data += tail
        if hi >= part.object_size:
            return data
        pos = hi
        probe *= 2
    return data


def read_csv_partition(
    store,
    part: DataPartition,
    columns: list[str] | None = None,
    capacity: int | None = None,
    device: str | torch.device | None = None,
) -> Table:
    """Parse one byte-range partition of a CSV object into a Table on
    ``device`` (the card unless the caller names the CPU).

    ``columns`` must be given for partitions that don't start the object
    (use :func:`read_header` once per object); the first partition infers
    them from the header line it owns.  Numeric cells parse as float64.
    """
    data = part.read(store)
    data = _extend_to_newline(store, part, data)
    if part.is_first:
        nl = data.find(b"\n")
        if nl < 0:
            raise ValueError(f"{part.key}: no header line in first partition")
        columns = [c.strip() for c in data[:nl].decode().split(",")]
        body = data[nl + 1:]
    else:
        if columns is None:
            raise ValueError("columns required for a non-first partition")
        # Row-boundary probe (the Hadoop/Lithops split rule): if the byte
        # just before our range is a newline, our first byte STARTS a row
        # and we own it; otherwise the leading partial row belongs to the
        # partition that contains its first byte — skip past it.  Without
        # the probe, a split landing exactly on a boundary drops that row.
        prev = store.get_object(part.group, part.key, part.start - 1, part.start)
        if prev == b"\n":
            body = data
        else:
            nl = data.find(b"\n")
            body = b"" if nl < 0 else data[nl + 1:]
    rows = [ln for ln in body.decode().split("\n") if ln.strip()]
    cols: dict[str, np.ndarray] = {
        c: np.empty(len(rows), dtype=np.float64) for c in columns
    }
    for i, ln in enumerate(rows):
        cells = ln.split(",")
        if len(cells) != len(columns):
            raise ValueError(
                f"{part.key}@{part.start}: row {i} has {len(cells)} cells, "
                f"expected {len(columns)}"
            )
        for c, cell in zip(columns, cells):
            cols[c][i] = float(cell)
    if not rows:  # keep the schema even for an empty slice
        return Table.from_dict(
            {c: np.empty(0, dtype=np.float64) for c in columns},
            capacity=capacity or 1, device=device,
        )
    return Table.from_dict(cols, capacity=capacity, device=device)


def etl_csv(
    store,
    group: str,
    key: str,
    *,
    chunk_bytes: int,
    executor=None,
    faults=None,
    device: str | torch.device | None = None,
) -> list[Table]:
    """Partition one CSV object and parse every partition into a Table on
    ``device`` (the card unless the caller names the CPU).

    With ``executor`` (a :class:`repro_torch.jobs.JobExecutor`) the partitions go
    through ``map`` — each parse is a billed, fault-tolerant serverless
    task and the executor's last :class:`~repro_torch.jobs.executor.JobReport`
    prices the whole ETL; without one, the partitions parse locally (same
    results, no pricing).
    """
    from repro_torch.jobs.partitioner import partition_dataset

    parts = partition_dataset(
        store, group, chunk_bytes=chunk_bytes, keys=[key])
    columns = read_header(store, group, key)

    def parse(part: DataPartition) -> Table:
        return read_csv_partition(store, part, columns=columns, device=device)

    if executor is None:
        return [parse(p) for p in parts]
    from repro_torch.jobs import get_result

    return get_result(executor.map(parse, parts, faults=faults))
