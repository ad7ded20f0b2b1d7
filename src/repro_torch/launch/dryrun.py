"""Multi-pod dry-run: trace one rank of every (arch x shape x mesh) cell —
the port of ``repro.launch.dryrun``.

The reference AOT-compiles each cell's step against shapes on the
production mesh and reads XLA's analyses.  The port's SPMD program is
written per rank, so the dry-run runs one rank of it: a ``fake`` process
group of the mesh's world (its collectives move nothing) holds this
process's rank at ``--coords``, the rank's parameters, optimizer state,
inputs and decode state are its ``local_shard`` under the sharding rules,
as fake tensors (``torch._subclasses.FakeTensorMode``: shapes and types,
no storage), and ``launch.hlo_analysis.count_step`` runs the real step
(``make_train_step`` at ``TRAIN_MICROBATCH`` / ``cell.microbatches``,
``api.prefill_fn``, or ``make_serve_step`` at ``len`` = seq_len - 1, so
that every key is read) once, gathering each leaf at use
(``dist.sharding.use``), and counts it.  Each record has the reference
record's keys and meanings (``memory_analysis.argument_size_bytes``: the
rank's argument trees; ``cost_analysis.flops``; ``collectives``;
``roofline`` on the H100), plus ``coords``, ``trace_s`` in place of
``compile_s``, ``roofline_tpu_v5e`` (the port's counts at the reference's
constants) and a ``reference`` block that copies the reference artifact's
figures beside them.

Artifacts land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma3-4b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing]
        [--coords data=3,model=5] [--device cpu|cuda]

The fake process group is the process's default group, so one process
traces cells of one mesh and rank only.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.dist import sharding, treepath
from repro_torch.launch import hlo_analysis, shapes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import DistContext
from repro_torch.serve.serve_step import make_serve_step
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step

REPO = Path(__file__).resolve().parents[3]
ARTIFACT_DIR = REPO / "experiments" / "dryrun_torch"
REFERENCE_DIR = REPO / "experiments" / "dryrun"


def _mesh_tag(mesh) -> str:
    return "x".join(str(s) for s in mesh.axis_sizes)


def _ctx_for(cfg: ArchConfig, mesh) -> DistContext:
    dp, tp = sharding.mesh_axes(mesh)
    # MoE: joint ('data','model') expert parallelism (pod stays pure DP)
    ep = sharding.ep_axes(cfg, mesh) if cfg.family == "moe" else None
    return DistContext(mesh=mesh, ep_axis=ep, dp_axes=dp, tp_axis=tp)


def fake_mesh(mesh, coords: dict, device: str = "cpu"):
    """A ``DeviceMesh`` of ``mesh``'s shape over a ``fake`` default process
    group (started here if none is up), this process its rank at
    ``coords``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    sizes = mesh.shape
    rank = 0
    for a in mesh.axis_names:  # row-major, the first axis slowest
        rank = rank * sizes[a] + int(coords[a])
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=mesh.size)
    elif dist.get_rank() != rank or dist.get_world_size() != mesh.size:
        raise RuntimeError(f"the default group is rank {dist.get_rank()} of "
                           f"{dist.get_world_size()}, not {rank} of {mesh.size}")
    return init_device_mesh(device, tuple(mesh.axis_sizes), mesh_dim_names=tuple(mesh.axis_names))


@dataclasses.dataclass
class RankCell:
    """One rank's program of a cell: its step, the spec trees and the
    rank's argument trees (meta tensors: shapes and types)."""

    ctx: DistContext
    kind: str
    args: dict           # name -> meta local tree, in the step's argument order
    microbatches: int = 1


def rank_cell(cfg: ArchConfig, cell: shapes.ShapeCell, mesh, coords: dict,
              microbatches: int | None = None) -> RankCell:
    """The rank's spec trees and its ``local_shard`` argument trees (meta)."""
    sizes = mesh.shape
    ctx = _ctx_for(cfg, mesh)
    p_meta = shapes.params_specs(cfg)
    p_specs = sharding.param_specs(cfg, p_meta, sizes)
    args = {"params": sharding.local_shard(p_meta, p_specs, sizes, coords)}
    if cell.kind == "train":
        o_meta = shapes.opt_state_specs(cfg, cfg.opt_state_dtype)
        o_specs = sharding.param_specs(cfg, o_meta, sizes)
        b_meta = shapes.input_specs(cfg, cell)
        args["opt_state"] = sharding.local_shard(o_meta, o_specs, sizes, coords)
        args["batch"] = sharding.local_shard(
            b_meta, sharding.batch_specs(cfg, b_meta, sizes), sizes, coords)
        ctx = dataclasses.replace(ctx, param_specs=p_specs, opt_specs=o_specs)
        micro = microbatches or shapes.TRAIN_MICROBATCH.get(cfg.name, cell.microbatches)
        return RankCell(ctx, "train", args, micro)
    s_meta = shapes.decode_state_specs(cfg, cell)
    s_specs = sharding.cache_specs(cfg, s_meta, sizes, cell.global_batch)
    b_meta = shapes.input_specs(cfg, cell)
    if cell.kind == "decode":  # the reference's decode lowers with the tokens only
        b_meta = {"tokens": b_meta["tokens"]}
    args["batch"] = sharding.local_shard(b_meta, sharding.batch_specs(cfg, b_meta, sizes),
                                         sizes, coords)
    state = sharding.local_shard(s_meta, s_specs, sizes, coords)
    if cell.kind == "decode":
        state = {**state, "len": cell.seq_len - 1}
    args["state"] = state
    ctx = dataclasses.replace(ctx, param_specs=p_specs, state_specs=s_specs)
    return RankCell(ctx, cell.kind, args)


def materialize(rc: RankCell, make) -> dict:
    """The rank's argument trees, each tensor leaf made by ``make(meta)``."""
    return {k: treepath.tree_map(lambda t: make(t) if isinstance(t, torch.Tensor) else t, v)
            for k, v in rc.args.items()}


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in treepath.leaves(tree)
               if isinstance(t, torch.Tensor))


def rank_step(cfg: ArchConfig, rc: RankCell, mesh_dev, args: dict):
    """``fn()``: the rank's step on ``args`` (``materialize``), its
    collectives over ``mesh_dev``."""
    ctx = dataclasses.replace(rc.ctx, mesh=mesh_dev)
    if rc.kind == "train":
        opt_cfg = opt.OptConfig(state_dtype=cfg.opt_state_dtype)
        step = make_train_step(cfg, opt_cfg, ctx=ctx, microbatches=rc.microbatches,
                               grad_dtype=getattr(torch, cfg.param_dtype))
        return lambda: step(args["params"], args["opt_state"], args["batch"])
    if rc.kind == "prefill":
        return lambda: api.prefill_fn(cfg, args["params"], args["batch"], args["state"],
                                      ctx=ctx)
    serve = make_serve_step(cfg, ctx=ctx)
    return lambda: serve(args["params"], args["batch"]["tokens"], args["state"])


def count_rank(cfg: ArchConfig, rc: RankCell, mesh_dev, args: dict):
    """(result, HloStats) of one rank step under ``count_step`` (serving
    steps without autograd)."""
    fn = rank_step(cfg, rc, mesh_dev, args)
    with torch.no_grad() if rc.kind != "train" else contextlib.nullcontext():
        return hlo_analysis.count_step(fn, held=list(args.values()))


def trace_cell(cfg: ArchConfig, cell: shapes.ShapeCell, mesh, coords: dict, *,
               device: str = "cpu", microbatches: int | None = None):
    """(RankCell, HloStats) of the rank at ``coords``: the step run on fake
    tensors on ``device``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rc = rank_cell(cfg, cell, mesh, coords, microbatches)
    mesh_dev = fake_mesh(mesh, coords, device)
    with FakeTensorMode():
        args = materialize(rc, lambda t: torch.empty(t.shape, dtype=t.dtype, device=device))
        _, stats = count_rank(cfg, rc, mesh_dev, args)
    return rc, stats


def _reference(tag: str) -> dict | None:
    path = REFERENCE_DIR / f"{tag}.json"
    if not path.exists():
        return None
    ref = json.loads(path.read_text())
    if ref.get("status") != "ok":
        return {"status": ref.get("status")}
    return {"memory_analysis": ref["memory_analysis"],
            "cost_analysis": {"flops": ref["cost_analysis"].get("flops")},
            "collectives": {"wire_bytes": ref["collectives"]["wire_bytes"]},
            "roofline": ref["roofline"]}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False, coords: dict | None = None,
             device: str = "cpu", save: bool = True, variant: str = "baseline",
             overrides: dict | None = None) -> dict:
    """Trace one rank of a cell and record it.  ``variant`` tags the record
    (``__{variant}`` on the file name unless "baseline"); ``overrides``
    replaces config fields, but ``microbatches``, which goes to the trace."""
    cfg = configs.get(arch)
    micro = None
    if overrides:
        overrides = dict(overrides)
        micro = overrides.pop("microbatches", None)
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
    cell = shapes.SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    coords = {a: int((coords or {}).get(a, 0)) for a in mesh.axis_names}
    ok, reason = shapes.cell_supported(cfg, cell)
    tag = f"{arch}__{shape_name}__{_mesh_tag(mesh)}"
    if variant != "baseline":
        tag += f"__{variant}"
    record: dict = {
        "arch": arch, "shape": shape_name, "mesh": list(mesh.axis_sizes),
        "axes": list(mesh.axis_names), "chips": mesh.size, "variant": variant,
        "coords": coords,
    }
    if not ok:
        record["status"] = "skipped"
        record["reason"] = reason
        _save(tag, record, save)
        return record
    t0 = time.time()
    try:
        rc, stats = trace_cell(cfg, cell, mesh, coords, device=device, microbatches=micro)
    except Exception as e:  # record the failure; dry-run failures are bugs
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        _save(tag, record, save)
        raise
    trace_s = time.time() - t0
    mf = hlo_analysis.model_flops(cfg, cell)
    roofs = {chip: hlo_analysis.Roofline(stats.flops, stats.hbm_bytes,
                                         stats.collective_wire_bytes, mf, mesh.size, chip)
             for chip in (hlo_analysis.H100, hlo_analysis.TPU_V5E)}
    arg_bytes = sum(tree_bytes(t) for t in rc.args.values())
    record.update(
        status="ok",
        trace_s=round(trace_s, 1),
        microbatches=rc.microbatches,
        memory_analysis={
            "argument_size_bytes": arg_bytes,
            "temp_size_bytes": int(stats.peak_bytes) - arg_bytes,
            "peak_bytes_per_device": int(stats.peak_bytes),
            "peak_by_kind": stats.peak_by_kind,
        },
        cost_analysis={"flops": stats.flops, "bytes accessed": stats.hbm_bytes,
                       "bytes accessed by op (8 largest)": stats.hbm_by_op},
        collectives={"counts": stats.collective_counts,
                     "wire_bytes": int(stats.collective_wire_bytes),
                     "by_kind": stats.collective_by_kind},
        roofline=roofs[hlo_analysis.H100].as_dict(),
        roofline_tpu_v5e=roofs[hlo_analysis.TPU_V5E].as_dict(),
        params=cfg.param_count(),
        active_params=cfg.active_param_count(),
        reference=_reference(tag),
    )
    roof = roofs[hlo_analysis.H100]
    print(f"[dryrun] {tag} @ {coords}: trace {trace_s:.0f}s | args "
          f"{arg_bytes / 2**30:.2f} GiB, peak {stats.peak_bytes / 2**30:.2f} GiB | "
          f"{stats.flops:.3e} flops | H100: compute {roof.compute_s * 1e3:.2f} ms, memory "
          f"{roof.memory_s * 1e3:.2f} ms, collective {roof.collective_s * 1e3:.2f} ms -> "
          f"{roof.dominant}-bound", flush=True)
    _save(tag, record, save)
    return record


def _save(tag: str, record: dict, save: bool):
    if not save:
        return
    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    with open(ARTIFACT_DIR / f"{tag}.json", "w") as f:
        json.dump(record, f, indent=1)


def _parse_coords(text: str | None) -> dict:
    if not text:
        return {}
    return {k: int(v) for k, v in (kv.split("=") for kv in text.split(","))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--coords", default=None, help="e.g. data=3,model=5 (default: every axis 0)")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"),
                    help="the fake tensors' device")
    args = ap.parse_args()

    cells: list[tuple[str, str]] = []
    if args.all:
        for a in configs.ARCH_IDS:
            for s in shapes.SHAPES:
                cells.append((a, s))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape (or --all) required")
        cells.append((args.arch, args.shape))

    failures = []
    mesh_tag = "2x16x16" if args.multi_pod else "16x16"
    for arch, shape_name in cells:
        out = ARTIFACT_DIR / f"{arch}__{shape_name}__{mesh_tag}.json"
        if args.skip_existing and out.exists():
            st = json.loads(out.read_text()).get("status")
            if st in ("ok", "skipped"):
                print(f"[dryrun] skip existing {out.name} ({st})")
                continue
        try:
            run_cell(arch, shape_name, multi_pod=args.multi_pod,
                     coords=_parse_coords(args.coords), device=args.device)
        except Exception as e:
            failures.append((arch, shape_name, str(e)))
            print(f"[dryrun] FAIL {arch} {shape_name}: {e}")
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        print(f"[dryrun] {len(failures)} failures:")
        for f in failures:
            print("   ", f)
        raise SystemExit(1)
    print("[dryrun] all requested cells OK")


if __name__ == "__main__":
    main()
