"""Distributed operators: hash partition -> AllToAll shuffle -> local op —
port of the simulation surface of ``repro.dataframe.ops_dist``.

Paper §III-D: "1) Hash applicable columns into partitioned tables, 2) Use
AllToAll to send tables to the intended destination, and 3) Execute a local
join on the received tables."  Per-rank ``list[Table]`` go through a
:class:`~repro_torch.core.communicator.Communicator` whose event log prices
the communication; the blocks stay on the tables' device.  The GroupBy
combiner (paper §IV-C: local pre-aggregation shrinks 50M rows to ~1e3 before
the wire) is ``combine=True``.
"""

from __future__ import annotations

import torch

from repro_torch.core.communicator import Communicator
from repro_torch.dataframe import ops_local
from repro_torch.dataframe.partition import build_partition_payload
from repro_torch.dataframe.table import Table

_NO_CODEC = (
    "compress=True needs the compressed columnar codec, which is not ported yet "
    "(ROADMAP A 3, the compressed codec)"
)


def _shuffle_sim(
    tables: list[Table], key: str, comm: Communicator, compress: bool = False,
    algorithm: str | None = None,
) -> list[Table]:
    """Hash-shuffle each rank's table so rows land at hash(key) % P.

    Every block ships as one float64 row-matrix (the reference's raw wire
    format, 8 B/value), so rows and event bytes match the reference; like
    it, this loses integer precision above 2**53.
    """
    if compress:
        raise NotImplementedError(_NO_CODEC)
    p = comm.world_size
    names = sorted(tables[0].columns)
    dev = tables[0].device
    sends: list[list[torch.Tensor]] = []
    for t in tables:
        payload, counts = build_partition_payload(t, p, [key])
        row_mats = []
        for d, c in enumerate(counts.tolist()):
            row_mats.append(
                torch.stack([payload[n][d][:c].to(torch.float64) for n in names], dim=1)
                if c
                else torch.zeros((0, len(names)), dtype=torch.float64, device=dev)
            )
        sends.append(row_mats)
    recvs, _ = comm.alltoallv(sends, algorithm=algorithm)
    cap = max(1, sum(t.capacity for t in tables) // p * 2)
    out: list[Table] = []
    for dst in range(p):
        rows = torch.cat(recvs[dst], dim=0)
        data = {n: rows[:, i].to(tables[0].columns[n].dtype) for i, n in enumerate(names)}
        out.append(Table.from_dict(data, capacity=max(cap, rows.shape[0]), device=dev))
    return out


def sim_join(
    left: list[Table], right: list[Table], key: str, comm: Communicator,
    compress: bool = False, algorithm: str | None = None,
) -> list[Table]:
    """Distributed inner join (unique right keys) over the communicator."""
    l_sh = _shuffle_sim(left, key, comm, compress=compress, algorithm=algorithm)
    r_sh = _shuffle_sim(right, key, comm, compress=compress, algorithm=algorithm)
    comm.barrier(algorithm=algorithm)
    return [ops_local.join_unique(l, r, key) for l, r in zip(l_sh, r_sh)]


def sim_groupby(
    tables: list[Table],
    key: str,
    aggs: dict[str, str],
    comm: Communicator,
    combine: bool = True,
    compress: bool = False,
    algorithm: str | None = None,
) -> list[Table]:
    """Distributed groupby; ``combine`` applies local pre-aggregation first."""
    if compress:
        raise NotImplementedError(_NO_CODEC)
    work = tables
    final_aggs = dict(aggs)
    if combine:
        work = [_rename_back(ops_local.groupby_agg(t, key, aggs), aggs) for t in tables]
        # re-aggregating partials: sum-of-sums, max-of-maxes, sum-of-counts
        final_aggs = {c: ("sum" if op == "count" else op) for c, op in aggs.items()}
    shuffled = _shuffle_sim(work, key, comm, algorithm=algorithm)
    comm.barrier(algorithm=algorithm)
    out = [ops_local.groupby_agg(t, key, final_aggs) for t in shuffled]
    if combine:
        out = [_restore_names(t, aggs, final_aggs) for t in out]
    return out


def _rename_back(t: Table, aggs: dict[str, str]) -> Table:
    """groupby emits col_op names; map them back to col for the reduce step."""
    cols = dict(t.columns)
    for col, op in aggs.items():
        cols[col] = cols.pop(f"{col}_{op}")
    return Table(cols, t.count)


def _restore_names(t: Table, aggs: dict[str, str], final_aggs: dict[str, str]) -> Table:
    """Normalize output names to the combine=False convention (col_origop)."""
    cols = dict(t.columns)
    for col, op in aggs.items():
        fop = final_aggs[col]
        if fop != op:
            cols[f"{col}_{op}"] = cols.pop(f"{col}_{fop}")
    return Table(cols, t.count)
