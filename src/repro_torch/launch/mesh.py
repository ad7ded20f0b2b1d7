"""Production and host meshes — the port of ``repro.launch.mesh``.

Single pod: (data=16, model=16) = 256 chips.
Multi-pod:  (pod=2, data=16, model=16) = 512 chips; the 'pod' axis composes
with 'data' for gradient reduction (hierarchical reduce: reduce-scatter
intra-pod, cross-pod all-reduce).

The production mesh is abstract (axis names and sizes, no devices): the
sharding rules (``dist.sharding``) and the resharded restore
(``dist.checkpoint.restore_sharded``) read only those.  The host mesh is a
``DeviceMesh`` over the process group the caller has already started.
"""

from __future__ import annotations

from repro_torch.dist.sharding import AbstractMesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def make_host_mesh(*, model: int = 2):
    """A ("data", "model") ``DeviceMesh`` of (world // model, model) over the
    initialised default process group: on the cards for NCCL, on the CPU for
    gloo.  Raises when no group is up (it never starts one)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised torch.distributed process group")
    world = dist.get_world_size()
    model = min(model, world)
    if world % model:
        raise ValueError(f"a world of {world} does not split into model groups of {model}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world // model, model), mesh_dim_names=("data", "model"))
