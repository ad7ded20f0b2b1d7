"""Direct-communication backend: the SPMD surface of the communicator — the
port of ``repro.core.backends.direct`` onto ``torch.distributed``.

The reference runs one global-view program under ``shard_map`` over a named
mesh axis.  Here every rank runs its own program on its own shard, and a
mesh axis is a dimension name of a
``torch.distributed.device_mesh.DeviceMesh``: ``axis="data"`` resolves to
``mesh.get_group("data")``, a tuple of names to the group of the ranks that
differ only along those dimensions (the first name major, as
``lax.axis_index`` numbers them).  The collectives keep the reference's
vocabulary and results, lowered to ``all_reduce``, ``reduce_scatter``,
``all_gather_into_tensor``, ``all_to_all_single``, ``broadcast`` and
``batch_isend_irecv``: direct rank-to-rank transfers (NCCL over NVLink on
the card, gloo on the CPU), the analogue of the paper's NAT hole-punched
TCP.  The process group's backend is whatever the caller initialised; the
code never swaps one for another.

Which mesh: each function takes ``mesh=``; without one it uses the mesh
bound by :func:`use_mesh` (``with direct.use_mesh(mesh): ...``).  The
dataframe operators (``ops_dist.*_spmd``) take the bound mesh, as the
reference's take the ``shard_map`` they run in; the model code passes its
``DistContext``'s mesh.

Every function returns a new tensor (the input is never written), on the
input's device.  The variable-length collectives follow the paper's
FMI-extension structure: a fixed-size count exchange first, then a
fixed-capacity payload exchange with masking.

Autograd.  ``allreduce`` (and so ``allreduce_mean``), ``allreduce_alike``,
``allgather``, ``allgather_alike``, ``alltoall`` and ``ppermute`` carry
gradients, as ``lax.psum``, ``all_gather``, ``all_to_all`` and
``ppermute`` do under ``jax.grad``.  Each rule is the exact gradient of
the sum of every rank's loss, each rank's output being a function of every
rank's input: ``allreduce``'s backward is the ``allreduce`` of the
cotangents, ``allgather``'s the ``reduce_scatter`` of them (rank s gets the
sum of every rank's cotangent piece s), and ``alltoall``'s the reverse
all-to-all (``split_dim`` and ``concat_dim`` swapped), ``ppermute``'s the
inverse pairs.  Where every rank computes the same loss from replicated
activations, that sum is P copies of it: the caller scales
(``moe._moe_ep``), or takes the ``_alike`` variant, whose backward passes
the rank's own cotangent on (``allreduce_alike``: the identity;
``allgather_alike``: its piece).  Every rank must run the same
backward, so that the backward's collectives meet.
"""

from __future__ import annotations

import contextlib
import math
from collections.abc import Sequence

import torch
import torch.distributed as dist

_bound: list = []                 # the meshes bound by use_mesh, innermost last
_groups: dict[tuple, object] = {}  # (mesh id, axes) -> this rank's group


@contextlib.contextmanager
def use_mesh(mesh):
    """Bind ``mesh`` for the calls inside the block that name no mesh."""
    _bound.append(mesh)
    try:
        yield mesh
    finally:
        _bound.pop()


def _mesh(mesh):
    if mesh is not None:
        return mesh
    if not _bound:
        raise RuntimeError("no device mesh: pass mesh= or bind one with direct.use_mesh(mesh)")
    return _bound[-1]


def _axes(axis: str | Sequence[str]) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def group(axis: str | Sequence[str], mesh=None):
    """The process group of mesh axis (or axes) ``axis`` that holds this rank."""
    mesh = _mesh(mesh)
    axes = _axes(axis)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _groups:
        # every rank makes every group of the sub-mesh, in one order (the
        # mesh's rank tensor is a real one: outside any dispatch mode, such
        # as a dry-run's fake tensors)
        from torch.utils._python_dispatch import _disable_current_modes

        names = list(mesh.mesh_dim_names)
        dims = [names.index(a) for a in axes]
        with _disable_current_modes():
            ranks = mesh.mesh
            rest = [d for d in range(ranks.dim()) if d not in dims]
            rows = ranks.permute(*rest, *dims).reshape(
                -1, math.prod(ranks.shape[d] for d in dims)).tolist()
        me = dist.get_rank()
        for row in rows:
            g = dist.new_group(row)
            if me in row:
                _groups[key] = g
    return _groups[key]


def axis_index(axis: str | Sequence[str], mesh=None) -> int:
    return dist.get_rank(group(axis, mesh))


def axis_size(axis: str | Sequence[str], mesh=None) -> int:
    return dist.get_world_size(group(axis, mesh))


def _device(mesh) -> torch.device:
    mesh = _mesh(mesh)
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def barrier(axis: str | Sequence[str], mesh=None) -> torch.Tensor:
    """A zero-payload all-reduce: every rank must arrive before any can
    read the result (int32 0 on the mesh's device)."""
    return allreduce(torch.zeros((), dtype=torch.int32, device=_device(mesh)), axis, mesh)


def _all_reduce(x: torch.Tensor, axis, mesh, op) -> torch.Tensor:
    out = x.clone().contiguous()
    dist.all_reduce(out, op=op, group=group(axis, mesh))
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return _all_reduce(x, axis, mesh, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis, ctx.mesh, dist.ReduceOp.SUM), None, None


def allreduce(x: torch.Tensor, axis: str | Sequence[str], mesh=None) -> torch.Tensor:
    """The sum over the axis, on every rank (``lax.psum``)."""
    return _AllReduce.apply(x, axis, mesh)


class _AllReduceAlike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        return _all_reduce(x, axis, mesh, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def allreduce_alike(x: torch.Tensor, axis: str | Sequence[str], mesh=None) -> torch.Tensor:
    """:func:`allreduce` for a sum every rank of the axis then computes alike
    from (the partial sums of a row-parallel product, Megatron's *g*): the
    ranks' cotangents are equal and each is the whole one, so the backward
    is the identity (an all-reduce would count it P times)."""
    return _AllReduceAlike.apply(x, axis, mesh)


def allreduce_mean(x: torch.Tensor, axis: str | Sequence[str], mesh=None) -> torch.Tensor:
    """The sum over the axis divided by its size, as ``lax.pmean``."""
    return allreduce(x, axis, mesh) / axis_size(axis, mesh)


def allreduce_max(x: torch.Tensor, axis: str | Sequence[str], mesh=None) -> torch.Tensor:
    return _all_reduce(x, axis, mesh, dist.ReduceOp.MAX)


_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def reduce_scatter(x: torch.Tensor, axis: str | Sequence[str], *, dim: int = 0,
                   mesh=None) -> torch.Tensor:
    """Tiled ``psum_scatter``: ``x`` cut along ``dim`` into P pieces; rank r
    gets the sum of every rank's piece r."""
    p = axis_size(axis, mesh)
    xs = x.movedim(dim, 0).contiguous()
    out = torch.empty((xs.shape[0] // p,) + tuple(xs.shape[1:]), dtype=x.dtype, device=x.device)
    _reduce_scatter(out, xs, group=group(axis, mesh))
    return out.movedim(0, dim)


def allreduce_decomposed(x: torch.Tensor, axis: str, *, mean: bool = False,
                         mesh=None) -> torch.Tensor:
    """Rabenseifner lowering: allreduce as reduce_scatter + all_gather.  The
    payload is flattened and zero-padded to a multiple of the axis size so
    the scatter divides evenly; the same sum as :func:`allreduce`."""
    p = axis_size(axis, mesh)
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % p
    if pad:
        flat = torch.cat([flat, torch.zeros((pad,), dtype=flat.dtype, device=flat.device)])
    scattered = reduce_scatter(flat, axis, dim=0, mesh=mesh)
    if mean:
        scattered = scattered / p
    full = allgather(scattered, axis, dim=0, mesh=mesh)
    return full[: x.numel()].reshape(x.shape)


def _allgather(x: torch.Tensor, axis, dim: int, mesh) -> torch.Tensor:
    p = axis_size(axis, mesh)
    xs = x.movedim(dim, 0).contiguous()
    out = torch.empty((p * xs.shape[0],) + tuple(xs.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, xs, group=group(axis, mesh))
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, mesh
        return _allgather(x, axis, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.axis, dim=ctx.dim, mesh=ctx.mesh), None, None, None


def allgather(x: torch.Tensor, axis: str | Sequence[str], *, dim: int = 0,
              mesh=None) -> torch.Tensor:
    """Tiled ``all_gather``: the ranks' tensors concatenated along ``dim``."""
    return _AllGather.apply(x, axis, dim, mesh)


class _AllGatherAlike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.rank = axis_index(axis, mesh)
        return _allgather(x, axis, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(), None, None, None


def allgather_alike(x: torch.Tensor, axis: str | Sequence[str], *, dim: int = 0,
                    mesh=None) -> torch.Tensor:
    """:func:`allgather` for a result every rank of the axis then computes
    alike from (activations replicated over it): the ranks' cotangents are
    equal, so the backward keeps this rank's piece of its own (a
    ``reduce_scatter`` would count it P times)."""
    return _AllGatherAlike.apply(x, axis, dim, mesh)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim, mesh):
        ctx.args = (axis, split_dim, concat_dim, mesh)
        return _alltoall(x, axis, split_dim, concat_dim, mesh)

    @staticmethod
    def backward(ctx, g):
        axis, split_dim, concat_dim, mesh = ctx.args
        return _alltoall(g, axis, concat_dim, split_dim, mesh), None, None, None, None


def alltoall(x: torch.Tensor, axis: str | Sequence[str], *, split_dim: int = 0,
             concat_dim: int = 0, mesh=None) -> torch.Tensor:
    """Fixed-capacity tiled all-to-all: ``x`` cut along ``split_dim`` into P
    pieces, piece s to rank s; the pieces received concatenated along
    ``concat_dim`` in source order (``lax.all_to_all(tiled=True)``)."""
    return _AllToAll.apply(x, axis, split_dim, concat_dim, mesh)


def _alltoall(x: torch.Tensor, axis, split_dim: int, concat_dim: int, mesh) -> torch.Tensor:
    p = axis_size(axis, mesh)
    xs = x.movedim(split_dim, 0).contiguous()
    recv = torch.empty_like(xs)
    dist.all_to_all_single(recv, xs, group=group(axis, mesh))
    # [P, piece...]: each source's piece, with its split dim back in place
    pieces = recv.reshape((p, xs.shape[0] // p) + tuple(xs.shape[1:])).movedim(1, split_dim + 1)
    merged = pieces.movedim(0, concat_dim)
    shape = list(merged.shape)
    shape[concat_dim: concat_dim + 2] = [shape[concat_dim] * shape[concat_dim + 1]]
    return merged.reshape(shape)


def bcast(x: torch.Tensor, axis: str, *, root: int = 0, mesh=None) -> torch.Tensor:
    """Broadcast the axis rank ``root``'s tensor to every rank of the axis."""
    g = group(axis, mesh)
    out = x.clone().contiguous()
    dist.broadcast(out, src=dist.get_global_rank(g, root), group=g)
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm, mesh):
        ctx.args = (axis, [(dst, src) for src, dst in perm], mesh)
        return _ppermute(x, axis, perm, mesh)

    @staticmethod
    def backward(ctx, g):
        axis, inverse, mesh = ctx.args
        return _ppermute(g, axis, inverse, mesh), None, None, None


def ppermute(x: torch.Tensor, axis: str, perm: list[tuple[int, int]], mesh=None) -> torch.Tensor:
    """Each (src, dst) pair of axis ranks sends src's tensor to dst; a rank
    that receives nothing gets zeros (``lax.ppermute``).  The backward sends
    each cotangent back along the inverse pairs (a rank that sent nothing
    gets a zero gradient)."""
    return _PPermute.apply(x, axis, perm, mesh)


def _ppermute(x: torch.Tensor, axis: str, perm, mesh) -> torch.Tensor:
    g = group(axis, mesh)
    me = dist.get_rank(g)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(g, dst), g))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(g, src), g))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def send_recv_ring(x: torch.Tensor, axis: str, *, shift: int = 1, mesh=None) -> torch.Tensor:
    """Point-to-point ring shift (the send/recv analogue under SPMD)."""
    n = axis_size(axis, mesh)
    return ppermute(x, axis, [(i, (i + shift) % n) for i in range(n)], mesh)


def alltoallv_counts(counts: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """Phase 1 of alltoallv: exchange per-destination valid counts ([P] -> [P])."""
    return alltoall(counts.reshape(-1, 1), axis, mesh=mesh).reshape(-1)


def alltoallv(payload: torch.Tensor, counts: torch.Tensor, axis: str,
              mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Variable-length all-to-all with fixed capacity (the shuffle primitive).

    ``payload`` is ``[P, cap, ...]``: slot ``d`` holds the rows destined for
    rank ``d``, valid in ``[:counts[d]]``.  Returns (``[P, cap, ...]``,
    ``[P]``): slot ``s`` holds what rank ``s`` sent here, with its count."""
    recv_counts = alltoallv_counts(counts, axis, mesh)
    return alltoall(payload, axis, mesh=mesh), recv_counts
