"""Carry a table's full state between the reference package and the port.

Both sides meet in numpy: the reference's ``Table`` exposes its padded
columns and its count as arrays, and these two functions move exactly that
state (padding rows included) into a port ``Table`` and back, so both
packages can start from identical tables.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.dataframe.table import Table
from repro_torch.device import resolve_device


def table_from_numpy(
    columns: dict[str, np.ndarray], count: int, device: str | torch.device | None = None
) -> Table:
    """A port Table holding these padded columns as they are (dtype and
    padding rows unchanged) and ``count`` valid rows."""
    dev = resolve_device(device)
    # copy: the table owns its storage, even on the CPU
    cols = {k: torch.from_numpy(np.array(v, order="C")).to(dev) for k, v in columns.items()}
    caps = {v.shape[0] for v in cols.values()}
    if len(caps) != 1:
        raise ValueError(f"ragged columns: {caps}")
    if not 0 <= count <= caps.pop():
        raise ValueError(f"count {count} outside the capacity")
    return Table(cols, torch.tensor(int(count), dtype=torch.int32, device=dev))


def table_to_numpy(table: Table) -> tuple[dict[str, np.ndarray], int]:
    """(padded columns as numpy arrays, count) of a port Table."""
    return {k: v.cpu().numpy() for k, v in table.columns.items()}, int(table.count)
