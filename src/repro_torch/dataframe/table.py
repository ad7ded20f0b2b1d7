"""Fixed-capacity columnar Table — the in-memory unit of the DDMF (port of
``repro.dataframe.table``).

A Table owns ``capacity`` rows of storage per column and a device-resident
int32 ``count`` of valid rows; rows at index >= count are padding, never
trusted to hold any particular value.  Every operator masks by ``count``.
The layout, the padding rules and the row orders of every operator are the
reference's, so the same input gives the same padded columns.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device

# JAX runs with 64-bit types off: its arrays canonicalize these numpy dtypes
# to their 32-bit counterparts.  The port does the same, so one numpy input
# builds the same table in both packages.
_CANONICAL = {
    np.dtype(np.int64): np.dtype(np.int32),
    np.dtype(np.uint64): np.dtype(np.uint32),
    np.dtype(np.float64): np.dtype(np.float32),
    np.dtype(np.complex128): np.dtype(np.complex64),
}
_CANONICAL_TORCH = {
    torch.int64: torch.int32,
    torch.uint64: torch.uint32,
    torch.float64: torch.float32,
    torch.complex128: torch.complex64,
}


def _as_column(v, device: torch.device) -> torch.Tensor:
    """One column as a tensor on ``device`` with the canonical dtype."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=_CANONICAL_TORCH.get(v.dtype, v.dtype))
    a = np.asarray(v)
    a = a.astype(_CANONICAL.get(a.dtype, a.dtype), copy=False)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@dataclasses.dataclass(frozen=True)
class Schema:
    names: tuple[str, ...]
    dtypes: tuple[torch.dtype, ...]
    trailing: tuple[tuple[int, ...], ...]  # per-column feature dims (beyond rows)

    def __str__(self) -> str:
        cols = ", ".join(
            f"{n}:{str(d).removeprefix('torch.')}{list(t) if t else ''}"
            for n, d, t in zip(self.names, self.dtypes, self.trailing)
        )
        return f"Schema({cols})"


@dataclasses.dataclass
class Table:
    """Columnar table: dict of [capacity, ...] tensors + valid-row count."""

    columns: dict[str, torch.Tensor]
    count: torch.Tensor  # 0-d int32 on the columns' device

    # -- construction ---------------------------------------------------------

    @classmethod
    def from_dict(
        cls,
        data: Mapping[str, np.ndarray | torch.Tensor],
        capacity: int | None = None,
        device: str | torch.device | None = None,
    ) -> Table:
        """Pad equal-length columns to ``capacity``.  ``device=None`` builds
        on the card (and raises without one); pass ``"cpu"`` for the CPU."""
        dev = resolve_device(device)
        arrays = {k: _as_column(v, dev) for k, v in data.items()}
        lengths = {v.shape[0] for v in arrays.values()}
        if len(lengths) != 1:
            raise ValueError(f"ragged columns: {lengths}")
        n = lengths.pop()
        cap = capacity or n
        if cap < n:
            raise ValueError(f"capacity {cap} < rows {n}")
        cols = {}
        for k, v in arrays.items():
            pad = torch.zeros((cap - n,) + tuple(v.shape[1:]), dtype=v.dtype, device=dev)
            cols[k] = torch.cat([v, pad], dim=0)
        return cls(cols, torch.tensor(n, dtype=torch.int32, device=dev))

    @classmethod
    def empty_like(cls, other: Table, capacity: int | None = None) -> Table:
        cap = capacity or other.capacity
        cols = {
            k: torch.zeros((cap,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
            for k, v in other.columns.items()
        }
        return cls(cols, torch.zeros((), dtype=torch.int32, device=other.device))

    # -- introspection --------------------------------------------------------

    @property
    def capacity(self) -> int:
        return next(iter(self.columns.values())).shape[0]

    @property
    def device(self) -> torch.device:
        return self.count.device

    @property
    def schema(self) -> Schema:
        names = tuple(sorted(self.columns))
        return Schema(
            names,
            tuple(self.columns[n].dtype for n in names),
            tuple(tuple(self.columns[n].shape[1:]) for n in names),
        )

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) < self.count

    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.columns.values())

    # -- materialization (host side; trims padding) ---------------------------

    def to_numpy(self) -> dict[str, np.ndarray]:
        n = int(self.count)
        return {k: v[:n].cpu().numpy() for k, v in self.columns.items()}

    def __repr__(self) -> str:
        return f"Table(rows={int(self.count)}, capacity={self.capacity}, {self.schema})"

    # -- relational basics ------------------------------------------------------

    def project(self, names: Iterable[str]) -> Table:
        return Table({n: self.columns[n] for n in names}, self.count)

    def with_column(self, name: str, values: torch.Tensor) -> Table:
        if values.shape[0] != self.capacity:
            raise ValueError("column capacity mismatch")
        cols = dict(self.columns)
        cols[name] = values
        return Table(cols, self.count)

    def gather(self, idx: torch.Tensor, new_count) -> Table:
        """Reorder/select rows by index; indices are clamped into range, as
        the reference's ``mode="clip"`` does (out-of-range drops are the
        caller's job)."""
        idx = idx.clamp(0, self.capacity - 1)
        cols = {k: v.index_select(0, idx) for k, v in self.columns.items()}
        return Table(cols, _count(new_count, self.device))

    def filter(self, pred: torch.Tensor) -> Table:
        """Keep rows where ``pred`` (and valid); result is packed to the front."""
        keep = pred & self.valid_mask()
        # stable pack: order by (not keep), preserving row order inside groups
        order = torch.argsort((~keep).to(torch.int32), stable=True)
        return self.gather(order, keep.sum(dtype=torch.int32))

    def head(self, n: int) -> Table:
        cols = {k: v[:n] for k, v in self.columns.items()}
        return Table(cols, torch.clamp(self.count, max=n).to(torch.int32))


def _count(n, device: torch.device) -> torch.Tensor:
    if isinstance(n, torch.Tensor):
        return n.to(device=device, dtype=torch.int32).reshape(())
    return torch.tensor(int(n), dtype=torch.int32, device=device)


def concat(tables: list[Table]) -> Table:
    """Concatenate padded tables, repacking valid rows to the front."""
    if not tables:
        raise ValueError("concat of no tables")
    names = sorted(tables[0].columns)
    for t in tables[1:]:
        if sorted(t.columns) != names:
            raise ValueError("schema mismatch in concat")
    cols = {n: torch.cat([t.columns[n] for t in tables], dim=0) for n in names}
    mask = torch.cat([t.valid_mask() for t in tables], dim=0)
    order = torch.argsort((~mask).to(torch.int32), stable=True)
    count = sum(t.count for t in tables)
    out = Table(cols, _count(count, tables[0].device))
    return out.gather(order, count)


def from_stacked(columns: dict[str, torch.Tensor], counts: torch.Tensor) -> Table:
    """Build a Table from [P, cap, ...] stacked buckets + per-bucket counts,
    packing all valid rows to the front (the receive side of a shuffle)."""
    p, cap = counts.shape[0], next(iter(columns.values())).shape[1]
    dev = counts.device
    flat = {k: v.reshape((p * cap,) + tuple(v.shape[2:])) for k, v in columns.items()}
    within = torch.arange(cap, device=dev).repeat(p)
    bucket = torch.arange(p, device=dev).repeat_interleave(cap)
    mask = within < counts[bucket]
    order = torch.argsort((~mask).to(torch.int32), stable=True)
    total = counts.sum(dtype=torch.int32)
    return Table(flat, total).gather(order, total)
