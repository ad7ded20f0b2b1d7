"""Sharding helpers — the port's ``repro.dist.sharding``, so far only the
piece the BSP runtime's mid-run shrink needs: :func:`repartition_states`.
The name-driven PartitionSpec rules of the reference (``param_specs``,
``batch_specs``, ``cache_specs``) are ROADMAP A 8."""

from __future__ import annotations

import numpy as np
import torch


def repartition_states(states: list, new_world: int) -> list:
    """Repartition per-rank BSP state over a different world size.

    The mid-run shrink path (``BSPRuntime.run(recovery_policy="shrink")``)
    rolls back to the last checkpoint — a list of ``old_world`` per-rank
    states — and redistributes it over the survivors.  Supported shapes:

    - every state a tensor: concatenate on dim 0 (0-d tensors as one row)
      and split into ``new_world`` contiguous chunks on the states' device
      (``torch.tensor_split``: ``np.array_split``'s sizes, the larger chunks
      first, so the global concatenation is preserved exactly and chunk
      sizes differ by at most one row);
    - every state a list/tuple: flatten and re-chunk the same way;
    - anything else raises ``TypeError`` — pass an explicit
      ``repartition=`` callable to the runtime for richer state.
    """
    new_world = int(new_world)
    if new_world < 1:
        raise ValueError("new_world must be >= 1")
    states = list(states)
    if states and all(isinstance(s, torch.Tensor) for s in states):
        flat = torch.cat([s.reshape(1) if s.dim() == 0 else s for s in states], dim=0)
        return list(torch.tensor_split(flat, new_world, dim=0))
    if all(isinstance(s, list | tuple) for s in states):
        flat = [x for s in states for x in s]
        bounds = np.linspace(0, len(flat), new_world + 1).astype(int)
        return [flat[bounds[i]:bounds[i + 1]] for i in range(new_world)]
    raise TypeError(
        "repartition_states handles per-rank tensors or lists/tuples; "
        f"got {sorted({type(s).__name__ for s in states})} — pass an "
        "explicit repartition= callable for richer state"
    )
