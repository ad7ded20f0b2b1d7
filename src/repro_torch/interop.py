"""Carry state between the reference package and the port.

Both sides meet in numpy.  Tables: the reference's ``Table`` exposes its
padded columns and its count as arrays, and ``table_from_numpy`` /
``table_to_numpy`` move exactly that state (padding rows included) into a
port ``Table`` and back.  Models: ``params_from_numpy`` takes the
reference's parameter tree as numpy arrays (``jax.tree.map(np.asarray,
params)``) and gives the port's tree; ``cache_from_numpy`` does the same for
a KV cache.  ``opt_state_from_numpy`` / ``opt_state_to_numpy`` move the
optimizer state (float32 or int8 {"q", "scale"} moments and the step).  So
both packages can start from identical state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.dataframe.table import Table
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig


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


def _tensor(a, device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``; a bfloat16 array (numpy's
    extension dtype, by name) is carried bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.uint16), order="C")).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def params_from_numpy(cfg: ArchConfig, tree: dict, device: str | torch.device | None = None,
                      *, master: bool = False) -> dict:
    """The port's parameter tree from the reference's (numpy leaves, same
    keys, stacked [L, ...]).  Float leaves become float32.  For serving the
    matrix weights are held as the float32 value of their ``cfg.dtype``
    rounding, which is what the reference's products read (``transformer``
    doc); ``master`` keeps them unrounded, as training's master weights."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _tensor(t, dev).float()

    params = conv(tree)
    if not master:
        transformer.round_matrix_leaves(cfg, params)
    return params


def params_to_numpy(params: dict) -> dict:
    """The port's parameter tree as float32 numpy arrays, same keys."""
    return {k: params_to_numpy(v) if isinstance(v, dict) else v.cpu().numpy()
            for k, v in params.items()}


def cache_from_numpy(cache: dict, device: str | torch.device | None = None) -> dict:
    """The port's KV cache ({"kv": tensor, "len": host int}) from the
    reference's ({"kv": [L, 2, B, S, KV, hd], "len": int32 scalar})."""
    return {"kv": _tensor(cache["kv"], resolve_device(device)), "len": int(cache["len"])}


def cache_to_numpy(cache: dict) -> dict:
    """{"kv": numpy array, "len": int32 scalar}; a bfloat16 cache comes back
    as float32 (every bfloat16 value is exact in float32)."""
    kv = cache["kv"]
    kv = kv.float() if kv.dtype == torch.bfloat16 else kv
    return {"kv": kv.cpu().numpy(), "len": np.int32(cache["len"])}


def opt_state_from_numpy(state: dict, device: str | torch.device | None = None) -> dict:
    """The port's optimizer state from the reference's ({"m", "v", "step"},
    numpy leaves): every leaf keeps its dtype (float32 moments, int8 ``q``
    with float32 ``scale``, int32 step)."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _tensor(t, dev)

    return conv(state)


def opt_state_to_numpy(state: dict) -> dict:
    """The port's optimizer state as numpy arrays, same keys and dtypes."""
    return {k: opt_state_to_numpy(v) if isinstance(v, dict) else v.cpu().numpy()
            for k, v in state.items()}
