"""Host copies of tensor payloads, for everything the port pickles.

The reference pickles numpy arrays where the port holds tensors: a BSP
checkpoint's per-rank states (``core/bsp.py``) and the map results a
``map_reduce`` gathers (``jobs/executor.py``).  Both are priced by their
pickled size, and a pickled ``torch.Tensor`` is not the size of the equal
numpy array.  So the port pickles :func:`to_host` of a payload — every
tensor leaf as a numpy copy, everything else as it stands — and the store's
and the gather's modeled seconds stay those of the reference for the same
values.  :func:`to_device` makes the numpy leaves tensors again on a device.
"""

from __future__ import annotations

import copy
import dataclasses
import pickle
from collections.abc import Callable
from typing import Any

import numpy as np
import torch


def _map_leaves(obj: Any, leaf: Callable[[Any], Any]) -> Any:
    """``obj`` rebuilt with ``leaf`` applied to every tensor / ndarray in its
    dicts, lists, tuples and dataclass fields."""
    if isinstance(obj, torch.Tensor | np.ndarray):
        return leaf(obj)
    if isinstance(obj, dict):
        return type(obj)((k, _map_leaves(v, leaf)) for k, v in obj.items())
    if isinstance(obj, list):
        return [_map_leaves(v, leaf) for v in obj]
    if isinstance(obj, tuple):
        items = [_map_leaves(v, leaf) for v in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else type(obj)(items)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = copy.copy(obj)
        for f in dataclasses.fields(obj):
            object.__setattr__(out, f.name, _map_leaves(getattr(obj, f.name), leaf))
        return out
    return obj


def _host_leaf(x):
    if isinstance(x, torch.Tensor) and x.dtype != torch.bfloat16:
        return x.detach().cpu().numpy()
    return x


def to_host(obj: Any) -> Any:
    """``obj`` with every tensor leaf as a host numpy copy (bfloat16, which
    numpy lacks, stays a tensor)."""
    return _map_leaves(obj, _host_leaf)


def to_device(obj: Any, device: torch.device) -> Any:
    """``obj`` with every numeric numpy leaf as a tensor on ``device``."""
    def leaf(x):
        if isinstance(x, np.ndarray) and x.dtype.kind in "biufc":
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)
        return x
    return _map_leaves(obj, leaf)


def dumps(obj: Any) -> bytes:
    """``pickle.dumps(to_host(obj))``."""
    return pickle.dumps(to_host(obj))
