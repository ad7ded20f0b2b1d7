"""Carry state between the reference package and the port.

Both sides meet in numpy.  Tables: the reference's ``Table`` exposes its
padded columns and its count as arrays, and ``table_from_numpy`` /
``table_to_numpy`` move exactly that state (padding rows included) into a
port ``Table`` and back.  Models: ``params_from_numpy`` takes the
reference's parameter tree as numpy arrays (``jax.tree.map(np.asarray,
params)``) and gives the port's tree, each leaf in the type its family's
products read; ``cache_from_numpy`` does the same for a KV cache, and
``state_from_numpy`` / ``state_to_numpy`` for any family's decode state
(the transformer's KV cache, RWKV's recurrent state, Griffin's group /
remainder state, the encoder-decoder's self and cross K/V).  ``opt_state_from_numpy`` / ``opt_state_to_numpy`` move the
optimizer state (float32 or int8 {"q", "scale"} moments and the step).  So
both packages can start from identical state.  ``expert_slice`` cuts one
expert-parallel rank's experts from the reference's parameter tree.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.dataframe.table import Table
from repro_torch.device import resolve_device
from repro_torch.models import api
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
    keys and nesting, stacked [L, ...]).  Each leaf takes the reference's
    ``cfg.param_dtype`` value (a bfloat16 leaf carried bit for bit) and is
    held in the type its products read (``api.hold_leaf``): the
    transformer's float32 matrix weights as the float32 value of their
    ``cfg.dtype`` rounding (``transformer`` doc), Griffin's and Whisper's
    cast leaves in ``cfg.dtype``; ``master`` keeps every leaf unrounded in
    ``cfg.param_dtype``, as training's master weights."""
    dev = resolve_device(device)
    pd = getattr(torch, cfg.param_dtype)

    def conv(t, path):
        if isinstance(t, dict):
            return {k: conv(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return tuple(conv(v, path) for v in t)
        return api.hold_leaf(cfg, path, _tensor(t, dev).to(pd), master)

    return conv(tree, ())


def expert_slice(cfg: ArchConfig, tree: dict, rank: int, ep_size: int) -> dict:
    """The reference's parameter tree (numpy leaves) with each MoE layer's
    expert stacks (``blocks.moe.wi`` / ``wo``, [L, E_pad, ...]) cut to rank
    ``rank``'s E_pad / ``ep_size`` experts, the slice ``moe._moe_ep`` runs
    on that rank of the expert-parallel axis.  Other leaves are shared."""
    e_pad = cfg.num_experts_padded
    if e_pad % ep_size:
        raise ValueError(f"{e_pad} padded experts do not split over {ep_size} ranks")
    n = e_pad // ep_size
    moe = dict(tree["blocks"]["moe"])
    for name in ("wi", "wo"):
        moe[name] = moe[name][:, rank * n:(rank + 1) * n]
    return {**tree, "blocks": {**tree["blocks"], "moe": moe}}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bfloat16 comes back as float32 (exact)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def params_to_numpy(params):
    """The port's parameter tree as numpy arrays, same keys and nesting
    (bfloat16 leaves as float32)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (tuple, list)):
        return tuple(params_to_numpy(v) for v in params)
    return _to_numpy(params)


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


def state_from_numpy(state, device: str | torch.device | None = None):
    """Any family's decode state from the reference's (numpy leaves, same
    keys and nesting): every array keeps its dtype (a bfloat16 cache bit
    for bit), ``len`` becomes a host int."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: int(v) if k == "len" else conv(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return tuple(conv(v) for v in t)
        return _tensor(t, dev)

    return conv(state)


def state_to_numpy(state):
    """A decode state as numpy arrays, same keys and nesting; ``len`` an
    int32 scalar, a bfloat16 array as float32 (exact)."""
    if isinstance(state, dict):
        return {k: np.int32(v) if k == "len" else state_to_numpy(v) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return tuple(state_to_numpy(v) for v in state)
    return _to_numpy(state)


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
