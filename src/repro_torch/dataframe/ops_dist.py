"""Distributed operators: hash partition -> AllToAll shuffle -> local op —
port of ``repro.dataframe.ops_dist``.

Paper §III-D: "1) Hash applicable columns into partitioned tables, 2) Use
AllToAll to send tables to the intended destination, and 3) Execute a local
join on the received tables."  Two surfaces, same algorithm:

- **sim_***: per-rank ``list[Table]`` through a
  :class:`~repro_torch.core.communicator.Communicator` whose event log
  prices the communication; the blocks stay on the tables' device.
- ***_spmd**: the production path.  Every rank calls it with its own Table;
  the shuffle is a direct all-to-all over a mesh axis
  (``core.backends.direct``) of the mesh the caller binds with
  ``direct.use_mesh(mesh)``.  On CUDA tables the
  hash, the probe and the segment sums are the hand-written kernels, as on
  the sim surface.

The GroupBy combiner (paper §IV-C: local pre-aggregation shrinks 50M rows
to ~1e3 before the wire) is ``combine=True``.

Compressed wire (``compress=True`` on the shuffle, join and groupby): each
(src, dst) block goes through the columnar codec of
``repro_torch.dist.compression`` before the alltoallv, on the tables'
device.  Key columns are encoded **exactly** (dictionary / narrow-width
offsets / raw — never quantized), so ``hash(key) % P`` routing and join
equality see bit-identical values; float value columns ship as block-int8
with one float32 scale per block; integer value columns take the exact
treatment, keeping integer aggregates exact.  The communicator prices the
event at the compressed bytes and records the logical bytes in
``CommEvent.raw_bytes``.
"""

from __future__ import annotations

import torch

from repro_torch.core.backends import direct
from repro_torch.core.communicator import Communicator
from repro_torch.dataframe import ops_local
from repro_torch.dataframe.partition import build_partition_payload
from repro_torch.dataframe.table import Table, from_stacked
from repro_torch.dist import compression


def _shuffle_sim(
    tables: list[Table], key: str, comm: Communicator, compress: bool = False,
    algorithm: str | None = None,
) -> list[Table]:
    """Hash-shuffle each rank's table so rows land at hash(key) % P.

    ``compress=False`` ships every block as one float64 row-matrix (the
    reference's raw wire format, 8 B/value), so rows and event bytes match
    the reference; like it, this loses integer precision above 2**53.
    ``compress=True`` runs each block through the columnar codec instead:
    the key column bit-exact at any magnitude, float value columns
    block-int8, integer value columns exact — and the communicator prices
    the compressed bytes while logging the raw ones.
    """
    p = comm.world_size
    names = sorted(tables[0].columns)
    if compress:
        return _shuffle_sim_compressed(tables, key, comm, names, algorithm=algorithm)
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


def _shuffle_sim_compressed(
    tables: list[Table], key: str, comm: Communicator, names: list[str],
    algorithm: str | None = None,
) -> list[Table]:
    """Codec-per-block variant of :func:`_shuffle_sim` (same row routing)."""
    p = comm.world_size
    dtypes = {n: tables[0].columns[n].dtype for n in names}
    dev = tables[0].device
    sends: list[list[compression.EncodedBlock]] = []
    for t in tables:
        payload, counts = build_partition_payload(t, p, [key])
        sends.append([
            compression.encode_block({n: payload[n][d][:c] for n in names}, {key})
            for d, c in enumerate(counts.tolist())
        ])
    recvs = comm.compressed_alltoallv(sends, algorithm=algorithm)
    cap = max(1, sum(t.capacity for t in tables) // p * 2)
    out: list[Table] = []
    for dst in range(p):
        decoded = [compression.decode_block(b) for b in recvs[dst]]
        data = {n: torch.cat([d[n] for d in decoded]).to(dtypes[n]) for n in names}
        nrows = data[names[0]].shape[0] if names else 0
        out.append(Table.from_dict(data, capacity=max(cap, nrows), device=dev))
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
    work = tables
    final_aggs = dict(aggs)
    if combine:
        work = [_rename_back(ops_local.groupby_agg(t, key, aggs), aggs) for t in tables]
        # re-aggregating partials: sum-of-sums, max-of-maxes, sum-of-counts
        final_aggs = {c: ("sum" if op == "count" else op) for c, op in aggs.items()}
    shuffled = _shuffle_sim(work, key, comm, compress=compress, algorithm=algorithm)
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


# ---------------------------------------------------------------------------
# SPMD surface (every rank its own Table; the production path)
# ---------------------------------------------------------------------------


def shuffle_spmd(table: Table, key: str, axis: str, compress: bool = False) -> Table:
    """Hash-shuffle this rank's table across mesh axis ``axis``.

    Fixed-capacity alltoallv: the send buffer is ``[P, cap, ...]`` with cap
    the local capacity (worst-case skew absorbed by the receive pack).
    ``compress=True`` replaces each float value column's buffer with a
    block-int8 payload + per-block float32 scales across the all-to-all;
    the key column and integer columns always ship exact."""
    p = direct.axis_size(axis)
    payload, counts = build_partition_payload(table, p, [key])
    recv_counts = direct.alltoallv_counts(counts, axis)
    recv = {}
    for name, buf in payload.items():
        if compress and name != key and buf.dtype.is_floating_point:
            q, scales = compression.quantize_slots(buf)
            recv[name] = compression.dequantize_slots(
                direct.alltoall(q, axis), direct.alltoall(scales, axis), tuple(buf.shape),
                buf.dtype)
        else:
            recv[name] = direct.alltoall(buf, axis)
    return from_stacked(recv, recv_counts)


def join_spmd(left: Table, right: Table, key: str, axis: str, compress: bool = False) -> Table:
    """Distributed inner join (unique right keys) of this rank's tables."""
    l_sh = shuffle_spmd(left, key, axis, compress=compress)
    r_sh = shuffle_spmd(right, key, axis, compress=compress)
    return ops_local.join_unique(l_sh, r_sh, key)


def groupby_spmd(table: Table, key: str, aggs: dict[str, str], axis: str,
                 combine: bool = True, compress: bool = False) -> Table:
    """Distributed groupby of this rank's table; ``combine`` applies local
    pre-aggregation first."""
    work = table
    final_aggs = dict(aggs)
    if combine:
        work = _rename_back(ops_local.groupby_agg(table, key, aggs), aggs)
        final_aggs = {c: ("sum" if op == "count" else op) for c, op in aggs.items()}
    shuffled = shuffle_spmd(work, key, axis, compress=compress)
    out = ops_local.groupby_agg(shuffled, key, final_aggs)
    if combine:
        out = _restore_names(out, aggs, final_aggs)
    return out
