"""Table -> tensor handoff (paper §III-A: "conversion from tabular or table
format to tensor format required for Machine Learning/Deep Learning") — the
port of ``repro.dataframe.tensor``.

The data-engineering output (a packed token table) becomes fixed-shape
training batches here, on the table's device: reshaping and masking only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dataframe.table import Table


def to_matrix(table: Table, columns: list[str], dtype=torch.float32) -> torch.Tensor:
    """Stack 1-D columns into a [capacity, n_cols] feature matrix (masked)."""
    mask = table.valid_mask()
    cols = [torch.where(mask, table.columns[c], 0).to(dtype) for c in columns]
    return torch.stack(cols, dim=1)


def to_token_batches(
    table: Table, token_col: str, batch: int, seq_len: int, pad_id: int = 0,
    nbatches: int | None = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack a token column into [nbatches * batch, seq_len] int32 (+ bool
    loss mask), truncating or padding as needed.  Rows must already be in
    document order.  ``nbatches=None`` packs every full batch the tokens
    allow (minimum one) instead of truncating the corpus to a single batch."""
    if nbatches is None:
        nbatches = max(int(table.valid_mask().sum()) // (batch * seq_len), 1)
    need = nbatches * batch * seq_len
    mask = table.valid_mask()
    toks = torch.where(mask, table.columns[token_col], pad_id)
    if toks.shape[0] < need:
        toks = F.pad(toks, (0, need - toks.shape[0]), value=pad_id)
        mask = F.pad(mask, (0, need - mask.shape[0]), value=False)
    toks = toks[:need].reshape(nbatches * batch, seq_len).to(torch.int32)
    return toks, mask[:need].reshape(nbatches * batch, seq_len)
