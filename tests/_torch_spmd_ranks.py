"""The ranks of the port's SPMD checks: gloo on the CPU (the tier-1 tests,
``tests/test_torch_spmd.py``) or NCCL on the cards, each rank a process
with a ``FileStore`` it is given, inputs from a pickle (``make_inputs``, made
with numpy from fixed seeds), its results pickled beside it.

    python tests/_torch_spmd_ranks.py JOB RANK WORLD STORE INPUTS OUT [DEVICE]

JOB ``main`` runs the world-4 checks (collectives and their backward,
compression, the dataframe operators, attention_sharded, the dense model,
the dp train steps, the driver's gate, the expert-parallel dispatch over a
replicated axis of 4, also at decode scale, and over the dp axis); ``moe``
the world-8 expert-parallel dispatch on a (2, 4) mesh; ``shard`` (world 4) distributes
the ``shard_trees`` over ``launch.mesh.make_host_mesh``'s (2, 2) mesh with
``dist.sharding.shardings_for``'s placements; ``sharded`` (world 4, the same
mesh) runs one train step, and a prefill with two decode steps, on every
leaf held whole and again on each leaf's ``local_shard``, gathered at use;
``tp`` (world 4, the (1, 4) and (2, 2) meshes) holds the tensor-parallel
products (gradients, serving, the pieces alone, the FLOP count) against
the whole leaves' run; ``tp_families`` does the same for RWKV-6, Griffin
and Whisper, with each rank's final decode state against ``local_shard``
of the whole run's and the vocabulary-parallel cross-entropy on bfloat16
logits.
DEVICE is ``cpu`` (gloo, the default) or ``cuda`` (NCCL, one card a rank).

    python tests/_torch_spmd_ranks.py cards [WORLD] [OUT]

runs the ``main`` job on WORLD cards (default 4) over NCCL and again on the
CPU over gloo, and holds every card result against the CPU's (the limits
of ``CARD_TOL``); it prints one JSON line and exits non-zero on a mismatch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import configs, interop
from repro_torch.core.backends import direct, mediated
from repro_torch.dataframe import ops_dist
from repro_torch.dist import compression, sharding, treepath
from repro_torch.interop import table_from_numpy, table_to_numpy
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api, moe
from repro_torch.models import layers as L
from repro_torch.models.transformer import DistContext
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

REPO = Path(__file__).resolve().parents[1]
JOB_TIMEOUT_S = 300
PG_TIMEOUT_S = 120

CFG_OVER = dict(vocab_size=512, d_model=128, num_heads=4, head_dim=32, num_kv_heads=2)
MOE_OVER = dict(num_experts=8, experts_per_token=2, moe_d_ff=32, d_model=64,
                capacity_factor=8.0)
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=8, schedule="wsd")
# attention_sharded: (mesh (dp, tp), b, t, h, kvh, hd, window); the
# reference's plan: "head" where H % tp == 0, else "seq" (t / tp >= 256)
ATTENTION = {
    "head_tp2": ((2, 2), 2, 64, 4, 2, 32, 0),
    "head_tp4_window": ((1, 4), 1, 96, 4, 2, 32, 24),
    "seq_tp2": ((2, 2), 2, 512, 3, 1, 32, 0),
    "seq_tp4_window": ((1, 4), 1, 1024, 6, 2, 32, 300),
}
# the collectives whose results move data (==) and those that sum floats
EXACT = ("axis_index", "axis_size", "barrier", "allreduce_max", "allreduce_max_int32",
         "allgather_dim0", "allgather_dim1", "alltoall_00", "alltoall_01", "alltoall_10",
         "alltoall_11", "bcast_root2", "ppermute", "ring_shift1", "ring_shift3",
         "alltoallv_counts", "alltoallv_payload", "alltoallv_recv_counts", "staged_all_to_all",
         "staged_all_to_all_chunked2", "staged_all_to_all_chunked4", "two_axes_index",
         "two_axes_alltoall", "model_axis_allgather")
SUMS = ("allreduce", "allreduce_mean", "reduce_scatter_dim0", "reduce_scatter_dim1",
        "staged_allreduce", "two_axes_allreduce", "compressed_pmean", "compressed_pmean_err",
        "compressed_pmean_ef", "compressed_pmean_ef_err",
        *(f"allreduce_decomposed_{m}{n}" for m in ("", "mean_") for n in ("64", "3x5", "13")))

# each differentiable collective's output shape at world 4 on the [8, 12]
# input (the cotangent each rank puts on it)
BACKWARD_SHAPES = {"allreduce": (8, 12), "allreduce_mean": (8, 12), "allgather_dim0": (32, 12),
                   "allgather_dim1": (8, 48), "alltoall_00": (8, 12), "alltoall_01": (2, 48),
                   "alltoall_10": (32, 3), "alltoall_11": (8, 12)}
# the decode-scale dispatch: MOE_OVER's 8 experts padded to 16, so that over
# an ep axis of 4 the last two ranks hold padding experts only, which get no
# token; fewer tokens than the axis's 4, as a production decode rank hands
# its 16 replicated ranks 8 (MOE_DECODE_TOKENS[1])
MOE_DECODE_OVER = dict(MOE_OVER, moe_pad_experts=8)
MOE_DECODE_TOKENS = (1, 2, 3)
# the MoE train step: qwen3-moe at MOE_OVER, float32 storage, 2 layers
MOE_STEP_OVER = dict(MOE_OVER, num_layers=2, vocab_size=CFG_OVER["vocab_size"],
                     param_dtype="float32")

DEV = torch.device("cpu")  # this rank's device (main sets it)


def t_(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a)).to(DEV)


def np_(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bfloat16 as its float32 values (exact)."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def make_inputs() -> dict:
    """Every job's inputs, from numpy seeds (the model weights from the port's
    seeded init on the CPU)."""
    rng = np.random.default_rng(20)
    p = 4
    inp = {
        "x": rng.normal(size=(p, 8, 12)).astype(np.float32) * 4,
        "counts": rng.integers(0, 6, (p, p)).astype(np.int32),
        "payload": rng.normal(size=(p, p, 5, 3)).astype(np.float32),
        "staged": rng.normal(size=(p, p, 8, 4)).astype(np.float32),
        "grad": rng.normal(size=(p, 1000)).astype(np.float32),
        "grad_err": (rng.normal(size=(p, 1000)) * 0.01).astype(np.float32),
        "dec_64": rng.normal(size=(p, 64)).astype(np.float32),
        "dec_3x5": rng.normal(size=(p, 3, 5)).astype(np.float32),
        "dec_13": rng.normal(size=(p, 13)).astype(np.float32),
    }
    # the dataframe: per rank 64 rows in a capacity of 128 (the groupby 100)
    n, cap = 64, 128
    keys = rng.permutation(p * n).astype(np.int32)
    rkeys = rng.permutation(p * n).astype(np.int32)[: p * n // 2]

    def stacked(cols, per):
        out = {}
        for name, v in cols.items():
            a = np.zeros((p, cap), v.dtype)
            for r in range(p):
                a[r, :per] = v[r * per:(r + 1) * per]
            out[name] = a
        return {"columns": out, "count": np.full(p, per, np.int32)}

    inp["df"] = {
        "left": stacked({"k": keys, "v": (rng.normal(size=p * n) * 10).astype(np.float32)}, n),
        "right": stacked({"k": rkeys, "w": rng.integers(0, 9, p * n // 2).astype(np.int32)},
                         n // 2),
        "group": stacked({"g": rng.integers(0, 50, p * 100).astype(np.int32),
                          "amount": rng.integers(1, 500, p * 100).astype(np.int32),
                          "score": rng.normal(size=p * 100).astype(np.float32)}, 100),
    }
    inp["attention"] = {}
    for case, (mesh, b, t, h, kvh, hd, window) in ATTENTION.items():
        q, do = (rng.normal(size=(b, t, h, hd)).astype(np.float32) for _ in range(2))
        k, v = (rng.normal(size=(b, t, kvh, hd)).astype(np.float32) for _ in range(2))
        inp["attention"][case] = {"mesh": mesh, "q": q, "k": k, "v": v, "do": do,
                                  "window": window}
    cfg = configs.get("gemma3-4b").reduced(**CFG_OVER)
    gen = torch.Generator().manual_seed(3)
    inp["params"] = interop.params_to_numpy(api.init_params(cfg, gen, device="cpu", master=True))
    mask = (rng.random((8, 16)) < 0.8).astype(np.float32)   # the shards' masks differ
    mask[0, :] = 1.0
    inp["batch"] = {"tokens": rng.integers(0, CFG_OVER["vocab_size"], (8, 16)).astype(np.int32),
                    "mask": mask}
    inp["cfg_over"], inp["opt"], inp["moe_over"] = CFG_OVER, OPT, MOE_OVER
    mcfg = configs.get("qwen3-moe-235b-a22b").reduced(**MOE_OVER)
    inp["moe_params"] = {"blocks": {"moe": interop.params_to_numpy(
        api.init_params(mcfg, torch.Generator().manual_seed(4), device="cpu"))["blocks"]["moe"]}}
    inp["moe_x"] = rng.normal(size=(8, 16, MOE_OVER["d_model"])).astype(np.float32)
    # the backward checks: a cotangent per rank for each collective's output,
    # one for the MoE output of each dp shard, and the MoE train step's batch
    inp["cot"] = {name: rng.normal(size=(p,) + shape).astype(np.float32)
                  for name, shape in BACKWARD_SHAPES.items()}
    inp["moe_cot"] = rng.normal(size=(8, 16, MOE_OVER["d_model"])).astype(np.float32)
    inp["moe_cot_aux"] = np.float32(rng.normal() * 10)
    inp["moe_batch"] = {"tokens": rng.integers(0, CFG_OVER["vocab_size"], (8, 16)).astype(np.int32),
                        "mask": (rng.random((8, 16)) < 0.8).astype(np.float32)}
    dcfg = configs.get("qwen3-moe-235b-a22b").reduced(**MOE_DECODE_OVER)
    inp["moe_decode_params"] = {k: w[0].numpy() for k, w in moe.init_moe_block(
        dcfg, torch.Generator().manual_seed(33), 1, "cpu").items()}
    inp["moe_decode_x"] = np.random.default_rng(33).normal(
        size=(max(MOE_DECODE_TOKENS), 1, dcfg.d_model)).astype(np.float32)
    return inp


def launch(job: str, world: int, tmp: Path, inputs: Path, device: str = "cpu"):
    """The ``world`` rank processes of ``job``, their outputs in ``tmp``."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    store = tmp / f"{job}_{device}_store"
    return [subprocess.Popen([sys.executable, __file__, job, str(r), str(world), str(store),
                              str(inputs), str(tmp), device], env=env, cwd=tmp,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def wait(procs, what: str) -> None:
    """Wait for ``procs`` at most JOB_TIMEOUT_S each; kill them all and raise
    on a timeout, raise with the log of one that failed."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOB_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise RuntimeError(f"{what} did not finish in {JOB_TIMEOUT_S} s") from None
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"{what} failed:\n{log[-4000:]}")


def load(tmp: Path, job: str, world: int, device: str = "cpu") -> list[dict]:
    return [pickle.loads((tmp / f"{job}_{device}_rank{r}.pkl").read_bytes())
            for r in range(world)]


def collectives(inp, rank, out):
    mesh = init_device_mesh(DEV.type, (4,), mesh_dim_names=("data",))
    x = t_(inp["x"][rank])                                   # [8, 12]
    r = {}
    with direct.use_mesh(mesh):
        r["axis_index"] = np.int32(direct.axis_index("data"))
        r["axis_size"] = np.int32(direct.axis_size("data"))
        r["barrier"] = np_(direct.barrier("data"))
        r["allreduce"] = np_(direct.allreduce(x, "data"))
        r["allreduce_mean"] = np_(direct.allreduce_mean(x, "data"))
        r["allreduce_max"] = np_(direct.allreduce_max(x, "data"))
        r["allreduce_max_int32"] = np_(direct.allreduce_max(x.to(torch.int32), "data"))
        r["reduce_scatter_dim0"] = np_(direct.reduce_scatter(x, "data", dim=0))
        r["reduce_scatter_dim1"] = np_(direct.reduce_scatter(x, "data", dim=1))
        for name in ("64", "3x5", "13"):
            d = t_(inp[f"dec_{name}"][rank])
            r[f"allreduce_decomposed_{name}"] = np_(direct.allreduce_decomposed(d, "data"))
            r[f"allreduce_decomposed_mean_{name}"] = np_(
                direct.allreduce_decomposed(d, "data", mean=True))
        r["allgather_dim0"] = np_(direct.allgather(x, "data", dim=0))
        r["allgather_dim1"] = np_(direct.allgather(x, "data", dim=1))
        for s_, c_ in ((0, 0), (0, 1), (1, 0), (1, 1)):
            r[f"alltoall_{s_}{c_}"] = np_(direct.alltoall(x, "data", split_dim=s_, concat_dim=c_))
        r["bcast_root2"] = np_(direct.bcast(x, "data", root=2))
        r["ppermute"] = np_(direct.ppermute(x, "data", [(0, 2), (1, 0), (2, 1)]))
        r["ring_shift1"] = np_(direct.send_recv_ring(x, "data", shift=1))
        r["ring_shift3"] = np_(direct.send_recv_ring(x, "data", shift=3))
        counts, payload = t_(inp["counts"][rank]), t_(inp["payload"][rank])
        r["alltoallv_counts"] = np_(direct.alltoallv_counts(counts, "data"))
        recv, rc = direct.alltoallv(payload, counts, "data")
        r["alltoallv_payload"], r["alltoallv_recv_counts"] = np_(recv), np_(rc)
        st = t_(inp["staged"][rank])                         # [4, 8, 4]
        r["staged_all_to_all"] = np_(mediated.staged_all_to_all(st, "data"))
        r["staged_allreduce"] = np_(mediated.staged_allreduce(st, "data"))
        for chunks in (2, 4):
            r[f"staged_all_to_all_chunked{chunks}"] = np_(
                mediated.staged_all_to_all_chunked(st, "data", chunks=chunks))
        g = t_(inp["grad"][rank])
        mean, err = compression.compressed_pmean(g, "data")
        r["compressed_pmean"], r["compressed_pmean_err"] = np_(mean), np_(err)
        mean, err = compression.compressed_pmean(g, "data", t_(inp["grad_err"][rank]))
        r["compressed_pmean_ef"], r["compressed_pmean_ef_err"] = np_(mean), np_(err)
    # two axes: the (data, model) group, data major
    mesh22 = init_device_mesh(DEV.type, (2, 2), mesh_dim_names=("data", "model"))
    both = ("data", "model")
    r["two_axes_index"] = np.int32(direct.axis_index(both, mesh22))
    r["two_axes_allreduce"] = np_(direct.allreduce(x, both, mesh22))
    r["two_axes_alltoall"] = np_(direct.alltoall(x, both, mesh=mesh22))
    r["model_axis_allgather"] = np_(direct.allgather(x, "model", dim=0, mesh=mesh22))
    out["collectives"] = r
    # each differentiable collective's backward: this rank's gradient of the
    # sum over ranks of <output_r, cot_r>
    bwd = {}
    with direct.use_mesh(mesh):
        calls = {"allreduce": lambda t: direct.allreduce(t, "data"),
                 "allreduce_mean": lambda t: direct.allreduce_mean(t, "data"),
                 "allgather_dim0": lambda t: direct.allgather(t, "data", dim=0),
                 "allgather_dim1": lambda t: direct.allgather(t, "data", dim=1),
                 **{f"alltoall_{s_}{c_}": (lambda t, s_=s_, c_=c_: direct.alltoall(
                     t, "data", split_dim=s_, concat_dim=c_)) for s_ in (0, 1) for c_ in (0, 1)}}
        for name, call in calls.items():
            leaf = x.detach().clone().requires_grad_()
            y = call(leaf)
            (y * t_(inp["cot"][name][rank])).sum().backward()
            bwd[name] = np_(leaf.grad)
    out["collectives_backward"] = bwd


def dataframe(inp, rank, out):
    mesh = init_device_mesh(DEV.type, (4,), mesh_dim_names=("data",))
    df = inp["df"]

    def table(cols):
        return table_from_numpy({k: v[rank] for k, v in cols["columns"].items()},
                                int(cols["count"][rank]), DEV)

    left, right, grp = table(df["left"]), table(df["right"]), table(df["group"])
    r = {}
    with direct.use_mesh(mesh):
        for compress in (False, True):
            tag = "compressed" if compress else "raw"
            r[f"shuffle_{tag}"] = table_to_numpy(
                ops_dist.shuffle_spmd(left, "k", "data", compress=compress))
            r[f"join_{tag}"] = table_to_numpy(
                ops_dist.join_spmd(left, right, "k", "data", compress=compress))
            for combine in (True, False):
                r[f"groupby_{tag}_combine{combine}"] = table_to_numpy(ops_dist.groupby_spmd(
                    grp, "g", {"amount": "sum", "score": "max"}, "data", combine=combine,
                    compress=compress))
    out["dataframe"] = r


def attention(inp, rank, out):
    r = {}
    for case, spec in inp["attention"].items():
        shape = spec["mesh"]
        mesh = init_device_mesh(DEV.type, shape, mesh_dim_names=("data", "model"))
        ctx = DistContext(mesh=mesh, dp_axes=("data",), tp_axis="model")
        d = direct.axis_index("data", mesh)
        b = spec["q"].shape[0] // shape[0]
        rows = slice(d * b, (d + 1) * b)
        q, k, v = (t_(spec[n][rows]).requires_grad_() for n in "qkv")
        o = L.attention_sharded(q, k, v, ctx, causal=True, window=spec["window"])
        o.backward(t_(spec["do"][rows]))
        r[case] = {"o": np_(o), "dq": np_(q.grad), "dk": np_(k.grad), "dv": np_(v.grad),
                   "plan": L.shard_plan(q.shape[2], k.shape[2], q.shape[1], shape[1])}
    out["attention"] = r


def dense(inp, rank, out):
    cfg = configs.get("gemma3-4b").reduced(**inp["cfg_over"])
    # serving weights for the forward, master weights for the loss (its graph casts them)
    params = interop.params_from_numpy(cfg, inp["params"], DEV)
    master = interop.params_from_numpy(cfg, inp["params"], DEV, master=True)
    batch = inp["batch"]
    r = {}
    # forward and loss under a (2, 2) context: dp shard d, replicated over tp
    mesh22 = init_device_mesh(DEV.type, (2, 2), mesh_dim_names=("data", "model"))
    ctx = DistContext(mesh=mesh22, dp_axes=("data",), tp_axis="model")
    d = direct.axis_index("data", mesh22)
    n = batch["tokens"].shape[0] // 2
    shard = {k: t_(v[d * n:(d + 1) * n]) for k, v in batch.items()}
    with torch.no_grad():
        logits, _ = api.logits_fn(cfg, params, shard, ctx=ctx)
        loss, metrics = api.loss_fn(cfg, master, shard, ctx=ctx)
    r["logits"], r["loss"], r["ce"] = np_(logits), float(loss), float(metrics["ce"])
    # make_train_step(ctx) at dp 4
    mesh4 = init_device_mesh(DEV.type, (4,), mesh_dim_names=("data",))
    ctx4 = DistContext(mesh=mesh4, dp_axes=("data",))
    oc = opt.OptConfig(**inp["opt"])
    n = batch["tokens"].shape[0] // 4
    shard = {k: t_(v[rank * n:(rank + 1) * n]) for k, v in batch.items()}
    p = interop.params_from_numpy(cfg, inp["params"], DEV, master=True)
    state = opt.init_state(p, oc)
    p, state, m = ts.make_train_step(cfg, oc, ctx=ctx4)(p, state, shard)
    r["dp_step"] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                    "params": interop.params_to_numpy(p)}
    # the compressed dp step at dp 4, 3 steps, from the global batch
    ccfg = dataclasses.replace(cfg, grad_compression=True)
    p = interop.params_from_numpy(ccfg, inp["params"], DEV, master=True)
    state = opt.init_state(p, oc)
    step, init_err = ts.make_compressed_dp_train_step(ccfg, oc, mesh4)
    err = init_err(p)
    full = {k: t_(v) for k, v in batch.items()}
    losses = []
    for _ in range(3):
        p, state, err, m = step(p, state, err, full)
        losses.append(float(m["loss"]))
    r["compressed_step"] = {"losses": losses, "params": interop.params_to_numpy(p),
                            "err_max": max(float(e.abs().max()) for e in treepath.leaves(err))}
    out["dense"] = r


def driver(inp, rank, out, ckpt_dir: Path):
    from repro_torch.launch import train as ltrain

    cfg = dataclasses.replace(configs.get("gemma3-4b").reduced(**inp["cfg_over"]),
                              grad_compression=True)
    kw = dict(steps=4, batch=8, seq_len=16, device=DEV)
    lines = []
    _, full = ltrain.train(cfg, log=lines.append, **kw)
    ltrain.train(cfg, ckpt_dir=ckpt_dir, ckpt_every=2, stop_after=2, log=lambda *a: None, **kw)
    _, resumed = ltrain.train(cfg, ckpt_dir=ckpt_dir, resume=True, log=lambda *a: None, **kw)
    out["driver"] = {"full": full, "resumed": resumed, "log": lines}


def _moe_run(cfg, x, cot, cot_aux, tree, ctx, shares: int = 0) -> dict:
    """One MoE layer's output, aux loss and gradients (of <out, cot> +
    cot_aux x aux: every rank of the ep axis computes the same loss) for x,
    the router, wi and wo.  The leaves are the float32 values of the stored
    bfloat16 weights, so that the gradients stay float32 (a bfloat16 leaf's
    gradient is its float32 sum rounded, whose ulp is no tolerance of
    the dispatch)."""
    blk = {k: w[0].detach().float().requires_grad_() for k, w in tree["blocks"]["moe"].items()}
    x = x.clone().requires_grad_()
    y, aux = moe.moe_block(x, blk, cfg, ctx)
    if shares:  # the replicated dispatch's aux loss: the mean of each token share's
        x2d = x.reshape(-1, x.shape[-1])
        aux = sum(moe._route(part, blk["router"], cfg)[2] for part in x2d.chunk(shares)) / shares
    ((y * cot).sum() + cot_aux * aux).backward()
    return {"out": np_(y), "aux": float(aux), "grads": {"x": np_(x.grad),
            **{k: np_(blk[k].grad) for k in ("router", "wi", "wo")}}}


def moe_ep(inp, rank, out, mesh, ep_axis, shard_axis=None):
    """The expert-parallel dispatch over ``ep_axis`` of ``mesh`` (the tokens
    replicated over it: each dp shard of ``shard_axis`` holds its own), each
    rank holding every expert or only its slice, against the local
    dispatch of the same shard: outputs and gradients."""
    cfg = configs.get("qwen3-moe-235b-a22b").reduced(**inp["moe_over"])
    ctx = DistContext(mesh=mesh, ep_axis=ep_axis, tp_axis=ep_axis,
                      dp_axes=(shard_axis,) if shard_axis else ())
    m = direct.axis_index(ep_axis, mesh)
    p = direct.axis_size(ep_axis, mesh)
    x, cot = t_(inp["moe_x"]), t_(inp["moe_cot"])
    if shard_axis:
        d, n = direct.axis_index(shard_axis, mesh), x.shape[0] // direct.axis_size(shard_axis,
                                                                                    mesh)
        x, cot = x[d * n:(d + 1) * n], cot[d * n:(d + 1) * n]
    cot_aux = float(inp["moe_cot_aux"])
    full = interop.params_from_numpy(cfg, inp["moe_params"], DEV)
    sliced = interop.params_from_numpy(cfg, interop.expert_slice(cfg, inp["moe_params"], m, p),
                                       DEV)
    r = {name: _moe_run(cfg, x, cot, cot_aux, tree, ctx)
         for name, tree in (("full", full), ("slice", sliced))}
    r["local"] = _moe_run(cfg, x, cot, cot_aux, full, None, shares=p)
    r["expert_rows"] = int(sliced["blocks"]["moe"]["wi"].shape[1])
    r["ep_rank"], r["ep_size"] = m, p
    return r


def moe_ep_decode(inp, mesh, ep_axis) -> dict:
    """_moe_ep under ``torch.no_grad`` at decode scale over ``ep_axis``, which
    the tokens are replicated over: each count of ``MOE_DECODE_TOKENS`` (one
    token a sequence), padded to the axis's size, every padded expert on
    every rank, against the local dispatch of the same tokens."""
    cfg = configs.get("qwen3-moe-235b-a22b").reduced(**MOE_DECODE_OVER)
    blk = {k: t_(w).requires_grad_() for k, w in inp["moe_decode_params"].items()}
    ctx = DistContext(mesh=mesh, ep_axis=ep_axis, tp_axis=ep_axis)
    p, m = direct.axis_size(ep_axis, mesh), direct.axis_index(ep_axis, mesh)
    e_loc = cfg.num_experts_padded // p
    r = {"experts": (m * e_loc, (m + 1) * e_loc), "live": cfg.num_experts, "axis": p}
    with torch.no_grad():
        for n in MOE_DECODE_TOKENS:
            x = t_(inp["moe_decode_x"][:n])
            y, aux = moe.moe_block(x, blk, cfg, ctx)
            y_loc, aux_loc = moe.moe_block(x, blk, cfg, None)
            r[n] = {"ep": np_(y), "local": np_(y_loc), "aux": float(aux),
                    "requires_grad": y.requires_grad}
    return r


def moe_train_step(inp, mesh, ep_axis, dp_axis):
    """make_train_step on a 2-layer qwen3-moe, each rank on its dp shard of
    the batch, with the experts over ``ep_axis`` (every expert on every
    rank, and each rank's slice) and without: the losses, gradient norms
    and updated parameters of each.  Over a replicated axis
    the aux loss is off: there the reference's is the mean of the token
    shares' (``pmean``), not the dp shard's, so the two steps' losses
    differ by definition (the dispatch's checks hold that aux loss and its
    gradient against the shares' mean)."""
    over = MOE_STEP_OVER if ep_axis == dp_axis else dict(MOE_STEP_OVER, router_aux_coef=0.0)
    cfg = configs.get("qwen3-moe-235b-a22b").reduced(**over)
    oc = opt.OptConfig(**inp["opt"])
    d, n = direct.axis_index(dp_axis, mesh), 8 // direct.axis_size(dp_axis, mesh)
    shard = {k: t_(v[d * n:(d + 1) * n]) for k, v in inp["moe_batch"].items()}
    e_rank, n_ep = direct.axis_index(ep_axis, mesh), direct.axis_size(ep_axis, mesh)
    r = {"ep_rank": e_rank, "expert_rows": cfg.num_experts_padded // n_ep}
    for name, ep in (("ep", ep_axis), ("ep_slice", ep_axis), ("local", None)):
        p = api.init_params(cfg, torch.Generator(device=DEV).manual_seed(5), device=DEV,
                            master=True)
        if name == "ep_slice":
            moe, rows = p["blocks"]["moe"], r["expert_rows"]
            for w in ("wi", "wo"):
                moe[w] = moe[w][:, e_rank * rows:(e_rank + 1) * rows].clone()
        state = opt.init_state(p, oc)
        step = ts.make_train_step(cfg, oc, ctx=DistContext(mesh=mesh, ep_axis=ep,
                                                           dp_axes=(dp_axis,)))
        p, state, m = step(p, state, shard)
        r[name] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                   "params": interop.params_to_numpy(p)}
    return r


def shard_trees() -> dict:
    """The ``shard`` job's trees, from seeded generators on the CPU: a reduced
    minicpm-2b's float32 masters and a reduced qwen3-moe's bfloat16 weights
    (its experts on the joint ('data', 'model') axis)."""
    out = {}
    for seed, arch, master in ((5, "minicpm-2b", True), (6, "qwen3-moe-235b-a22b", False)):
        cfg = configs.get(arch).reduced()
        out[arch] = (cfg, api.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu",
                                          master=master))
    return out


def raw(t: torch.Tensor) -> tuple:
    """(shape, dtype name, bytes) of a tensor: equal means bit-equal."""
    t = t.detach().cpu().contiguous()
    return (tuple(t.shape), str(t.dtype).removeprefix("torch."),
            t.reshape(-1).view(torch.uint8).numpy().tobytes())


def shard(out) -> None:
    from torch.distributed.tensor import distribute_tensor

    mesh = make_host_mesh(model=2)
    out["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out["coords"] = mesh.get_coordinate()
    out["local"] = {}
    for name, (cfg, tree) in shard_trees().items():
        specs = sharding.param_specs(cfg, tree, mesh)
        placed = sharding.shardings_for(mesh, specs)
        out["local"][name] = {
            treepath.path_str(path): raw(distribute_tensor(
                leaf.to(DEV), mesh, _node(placed, path)).to_local())
            for path, leaf in treepath.flatten_with_path(tree)}


def _node(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _own(tree, specs, mesh) -> dict:
    """This rank's ``local_shard`` of ``tree``, each leaf a copy of its own."""
    coords = {n: direct.axis_index(n, mesh) for n in mesh.mesh_dim_names}
    local = sharding.local_shard(tree, specs, mesh, coords)
    return treepath.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, local)


def _step_spying(step, params, state, batch):
    """``step(params, state, batch)``, and the reduced gradients and clip
    norm its AdamW update was handed."""
    seen, real = {}, opt.apply_updates

    def spy(p, grads, st, cfg, gnorm=None, ctx=None):
        seen["grads"], seen["gnorm"] = grads, float(gnorm)
        return real(p, grads, st, cfg, gnorm=gnorm, ctx=ctx)

    opt.apply_updates = spy
    try:
        return step(params, state, batch) + (seen,)
    finally:
        opt.apply_updates = real


def sharded_steps(inp, out) -> None:
    """The ``sharded`` job: per case of ``inp["sharded"]`` (arch, optimizer
    state type, config overrides, AdamW eps), one ``make_train_step`` on the
    rank's dp shard of the batch with every leaf whole (replicated over the
    mesh), and one on the ``local_shard`` of params and optimizer state
    under the spec trees (``DistContext.param_specs`` / ``opt_specs``); the
    MoE over the joint ('data', 'model') ep axis.  Each step's reduced
    gradients and clip norm are kept beside its result.  Then per case of
    ``inp["sharded"]["serve"]`` a prefill and two decode steps, whole and on
    sharded params and decode state (``state_specs``)."""
    mesh = make_host_mesh(model=2)
    data = direct.axis_index("data", mesh)
    res = {}
    for case, (arch, state_dtype, over, eps) in inp["sharded"]["cases"].items():
        cfg = configs.get(arch).reduced(**over)
        ctx = DistContext(mesh=mesh, dp_axes=("data",), tp_axis="model",
                          ep_axis=sharding.ep_axes(cfg, mesh) if cfg.family == "moe" else None)
        params = interop.params_from_numpy(cfg, inp["sharded"]["params"][case], DEV, master=True)
        ocfg = opt.OptConfig(**inp["opt"], eps=eps, state_dtype=state_dtype)
        state = opt.init_state(params, ocfg)
        p_specs = sharding.param_specs(cfg, params, mesh)
        o_specs = sharding.param_specs(cfg, state, mesh)
        lp, lo = _own(params, p_specs, mesh), _own(state, o_specs, mesh)
        n = inp["sharded"]["batch"]["tokens"].shape[0] // 2
        batch = {k: t_(v[data * n:(data + 1) * n]) for k, v in inp["sharded"]["batch"].items()}
        p1, o1, m1, s1 = _step_spying(ts.make_train_step(cfg, ocfg, ctx=ctx), params, state,
                                      batch)
        sctx = dataclasses.replace(ctx, param_specs=p_specs, opt_specs=o_specs)
        p2, o2, m2, s2 = _step_spying(ts.make_train_step(cfg, ocfg, ctx=sctx), lp, lo, batch)

        def flat(tree):
            return {treepath.path_str(pa): np_(t) for pa, t in treepath.flatten_with_path(tree)}

        res[case] = {
            "loss": (float(m1["loss"]), float(m2["loss"])),
            "gnorm": (s1["gnorm"], s2["gnorm"]),
            "lr": float(opt.lr_at(torch.ones((), dtype=torch.int32), ocfg)),
            "grads": (flat(_own(s1["grads"], p_specs, mesh)), flat(s2["grads"])),
            "bf16": sorted("params/" + treepath.path_str(pa) for pa, t
                           in treepath.flatten_with_path(p2) if t.dtype == torch.bfloat16),
            "want": flat({"params": _own(p1, p_specs, mesh), "opt": _own(o1, o_specs, mesh)}),
            "got": flat({"params": p2, "opt": o2}),
        }
    # serving: per case a prefill and two decode steps on the case's first
    # sequences of the prompt; the MoE over the joint ('data', 'model') axis
    # in both runs, as on the production mesh (dryrun.rank_cell)
    res["serve"] = {}
    for case, (arch, over, seqs) in inp["sharded"]["serve"].items():
        cfg = configs.get(arch).reduced(**over)
        ctx = DistContext(mesh=mesh, dp_axes=("data",), tp_axis="model",
                          ep_axis=sharding.ep_axes(cfg, mesh) if cfg.family == "moe" else None)
        params = interop.params_from_numpy(cfg, inp["sharded"]["serve_params"][case], DEV)
        prompt = inp["sharded"]["prompt"][:seqs]
        b, t = prompt.shape
        n = b // 2
        whole = api.init_decode_state(cfg, b, t + 2, torch.float32, device=DEV)
        s_specs = sharding.cache_specs(cfg, whole, mesh, b)
        sctx = dataclasses.replace(ctx, param_specs=sharding.param_specs(cfg, params, mesh),
                                   state_specs=s_specs)
        runs = {"whole": (ctx, params,
                          api.init_decode_state(cfg, n, t + 2, torch.float32, device=DEV)),
                "sharded": (sctx, _own(params, sctx.param_specs, mesh),
                            _own(whole, s_specs, mesh))}
        batch = {"tokens": t_(prompt[data * n:(data + 1) * n])}
        if cfg.family == "audio":
            batch["frames"] = t_(inp["sharded"]["frames"][data * n:(data + 1) * n])
        logits, tokens = {}, {}
        real = moe._moe_ep

        def spy(x2d, *a):  # the tokens each expert-parallel dispatch is handed
            tokens[name][-1].append(int(x2d.shape[0]))
            return real(x2d, *a)

        moe._moe_ep = spy
        try:
            with torch.inference_mode():
                for name, (c, p, st) in runs.items():
                    tokens[name] = [[]]
                    lg, st = api.prefill_fn(cfg, p, batch, st, ctx=c)
                    steps = [np_(lg)]
                    for i in range(2):
                        tokens[name].append([])
                        tok = t_(inp["sharded"]["decode"][i][data * n:(data + 1) * n])
                        lg, st = api.decode_fn(cfg, p, tok, st, ctx=c)
                        steps.append(np_(lg))
                    logits[name] = steps
        finally:
            moe._moe_ep = real
        res["serve"][case] = {**logits, "ep_tokens": tokens}
    out["sharded"] = res


def _tp_collectives(inp, mesh) -> dict:
    """The tensor-parallel pieces on ``mesh``'s 'model' axis, each rank on
    its block of the inputs (``inp["tp"]["unit"]``): values and gradients,
    each against the same rank's block of the whole computation in the test."""
    u, r = inp["tp"]["unit"], {}
    tp, p = "model", direct.axis_size("model", mesh)
    m, d = direct.axis_index("model", mesh), direct.axis_index("data", mesh)

    def block(a, dim):
        n = a.shape[dim] // p
        return t_(np.take(a, range(m * n, (m + 1) * n), axis=dim))

    # the row-parallel sum (g), and a planted all-reduce in its place
    x, w, cot = t_(u["x"]), t_(u["w"]), t_(u["cot"])
    for name, fn in (("g", direct.allreduce_alike), ("planted", direct.allreduce)):
        xl = block(u["x"], -1).requires_grad_()
        wl = block(u["w"], 0).requires_grad_()
        y = fn(xl @ wl, tp, mesh)
        (y * cot).sum().backward()
        r[name] = {"y": np_(y), "dx": np_(xl.grad), "dw": np_(wl.grad)}
    # the column-parallel product (f): y alike, w's columns split
    y0 = x.clone().requires_grad_()
    wl = block(u["w"], -1).requires_grad_()
    out = L.column_parallel(y0, wl, tp, mesh)
    (out * block(u["cot"], -1)).sum().backward()
    r["f"] = {"out": np_(out), "dy": np_(y0.grad), "dw": np_(wl.grad)}
    # the split of an alike tensor to the rank's columns (Megatron's scatter)
    xs = x.clone().requires_grad_()
    part = L.split_to_group(xs, tp, mesh)
    (part * block(u["cot"][:, :x.shape[-1]], -1)).sum().backward()
    r["split"] = {"out": np_(part), "dx": np_(xs.grad)}
    # the gate / up exchange: the rank's columns of gate and up, and the
    # gradient of the rank's block of gate || up
    gu = block(u["gu"], -1).requires_grad_()
    gate, up = L.gate_up_exchange(gu, tp, mesh)
    ((gate * block(u["cot_gate"], -1)).sum() + (up * block(u["cot_up"], -1)).sum()).backward()
    r["exchange"] = {"gate": np_(gate), "up": np_(up), "dgu": np_(gu.grad)}
    # ppermute's backward along the inverse pairs
    xp = x.clone().requires_grad_()
    perm = [(s, s + 1) for s in range(p - 1)]   # the last rank sends nothing
    (direct.ppermute(xp, tp, perm, mesh) * cot[..., :x.shape[-1]] * (m + 1)).sum().backward()
    r["ppermute_dx"] = np_(xp.grad)
    # the vocabulary-parallel embedding and cross-entropy, each dp rank on its rows
    n = u["tokens"].shape[0] // direct.axis_size("data", mesh)
    rows = slice(d * n, (d + 1) * n)
    tokens, labels, mask = (t_(u[k][rows]) for k in ("tokens", "labels", "mask"))
    table = block(u["table"], 0).requires_grad_()
    e = L.embed_parallel(tokens, table, tp, mesh, scale=True)
    (e * t_(u["cot_embed"][rows])).sum().backward()
    r["embed"] = {"x": np_(e), "dtable": np_(table.grad)}
    logits = block(u["logits"][rows], -1).requires_grad_()
    total, count = L.vocab_parallel_cross_entropy_terms(logits, labels, mask, tp, mesh)
    total.backward()
    r["ce"] = {"total": float(total), "count": float(count), "dlogits": np_(logits.grad)}
    return r


def _batch(b, rows=slice(None)) -> dict:
    """A batch of the ``tp`` inputs as tensors (``rows`` of each): a dict of
    arrays, or a token array alone."""
    b = b if isinstance(b, dict) else {"tokens": b}
    return {k: t_(v[rows]) for k, v in b.items()}


def _tp_flops(tpi, mesh) -> dict:
    """The rank's FLOPs of one serving forward (``count_step``) per flop
    case of ``tpi``: the whole products and the sharded ones."""
    from repro_torch.launch import hlo_analysis

    out = {}
    for case, (arch, over) in tpi["flops"].items():
        cfg = configs.get(arch).reduced(**over)
        params = interop.params_from_numpy(cfg, tpi["params"][case], DEV)
        ctx = DistContext(mesh=mesh, dp_axes=("data",), tp_axis="model",
                          param_specs=sharding.param_specs(cfg, params, mesh))
        batch = _batch(tpi["tokens"][case])
        local = _own(params, ctx.param_specs, mesh)
        with torch.no_grad():
            _, st = hlo_analysis.count_step(lambda: api.logits_fn(cfg, local, batch, ctx=ctx))
        out[case] = st.flops
    return out


def _global_state(whole, like, mesh):
    """The whole run's decode state (each rank's dp rows) all-gathered over
    'data' into the global batch's, ``like`` (a global state) giving each
    leaf's shape."""
    def leaf(t, g):
        if not isinstance(t, torch.Tensor) or t.shape == g.shape:
            return t
        dim = next(i for i, (a, b) in enumerate(zip(t.shape, g.shape)) if a != b)
        return direct.allgather(t.contiguous(), "data", dim=dim, mesh=mesh)

    return treepath.unflatten_like(whole, [leaf(t, g) for t, g in zip(treepath.leaves(whole),
                                                                       treepath.leaves(like))])


@contextlib.contextmanager
def _island_heads(seen: list):
    """Within the block, every ``layers.attention_island`` call appends
    ("island", its q heads, the k / v heads it is handed) to ``seen``, and
    every ``layers.attention`` call (an island's own too) ("attention", its
    q heads, the k / v heads it reads)."""
    island, plain = L.attention_island, L.attention

    def island_spy(q_l, k, v, *args, **kw):
        seen.append(("island", q_l.shape[2], k.shape[2]))
        return island(q_l, k, v, *args, **kw)

    def spy(q, k, v, **kw):
        seen.append(("attention", q.shape[2], k.shape[2]))
        return plain(q, k, v, **kw)

    L.attention_island, L.attention = island_spy, spy
    try:
        yield
    finally:
        L.attention_island, L.attention = island, plain


def _tp_case(tpi, case, mesh) -> dict:
    """One case of ``tpi["cases"]`` on ``mesh``: the gradients of one
    microbatch (``train_step``'s, reduced over dp, and the clip's norm) on
    every leaf whole and on each leaf's ``local_shard`` under
    ``param_specs`` (the tensor-parallel products); a prefill and two
    decode steps the same two ways (with ``tpi["states"]``, the tp run's
    final state beside ``local_shard`` of the whole runs' global one), and
    the q and k / v heads of each attention island and call of the tp run's
    decode steps; and the tp run's full-sequence logits."""
    arch, over = tpi["cases"][case]
    data = direct.axis_index("data", mesh)
    n_dp = direct.axis_size("data", mesh)
    cfg = configs.get(arch).reduced(**over)
    ctx = DistContext(mesh=mesh, dp_axes=("data",), tp_axis="model",
                      ep_axis=sharding.ep_axes(cfg, mesh) if cfg.family == "moe" else None)
    tree = tpi["params"][case]
    master = interop.params_from_numpy(cfg, tree, DEV, master=True)
    specs = sharding.param_specs(cfg, master, mesh)
    sctx = dataclasses.replace(ctx, param_specs=specs)
    batch = tpi["batch"][case]
    n = batch["tokens"].shape[0] // n_dp
    shard = _batch(batch, slice(data * n, (data + 1) * n))
    got = {}
    for name, c, p in (("whole", ctx, master), ("tp", sctx, _own(master, specs, mesh))):
        loss, _, grads = ts._make_grads_of(cfg, c, 1, torch.float32)(p, shard)
        gnorm = ts._reduce(grads, ts._shard_axes(cfg, c, p), ("data",), mesh)
        got[name] = (float(loss), float(gnorm), grads)

    def flat(tree):
        return {treepath.path_str(pa): np_(t) for pa, t in treepath.flatten_with_path(tree)
                if isinstance(t, torch.Tensor)}

    rc = {"loss": (got["whole"][0], got["tp"][0]), "gnorm": (got["whole"][1], got["tp"][1]),
          "want": flat(_own(got["whole"][2], specs, mesh)), "got": flat(got["tp"][2])}
    # serving from the same weights (held as serving holds them)
    params = interop.params_from_numpy(cfg, tree, DEV)
    local = _own(params, specs, mesh)
    with torch.inference_mode():
        rc["logits"] = np_(api.logits_fn(cfg, local, shard, ctx=sctx)[0])
        prompt = tpi["prompt"][case]
        b, t = (prompt if isinstance(prompt, np.ndarray) else prompt["tokens"]).shape
        m = b // n_dp
        whole = api.init_decode_state(cfg, b, t + 2, torch.float32, device=DEV)
        s_specs = sharding.cache_specs(cfg, whole, mesh, b)
        runs = {"whole": (ctx, params, api.init_decode_state(cfg, m, t + 2, torch.float32,
                                                             device=DEV)),
                "tp": (dataclasses.replace(sctx, state_specs=s_specs), local,
                       _own(whole, s_specs, mesh))}
        steps, final, heads = {}, {}, []
        for name, (c, p, st) in runs.items():
            lg, st = api.prefill_fn(cfg, p, _batch(prompt, slice(data * m, (data + 1) * m)), st,
                                    ctx=c)
            steps[name] = [np_(lg)]
            for i in range(2):
                tok = t_(tpi["decode"][case][i][data * m:(data + 1) * m])
                with _island_heads(heads if name == "tp" else []):
                    lg, st = api.decode_fn(cfg, p, tok, st, ctx=c)
                steps[name].append(np_(lg))
            final[name] = st
        rc["serve"] = steps
        rc["decode_heads"] = heads
        if tpi.get("states"):
            coords = {a: direct.axis_index(a, mesh) for a in mesh.mesh_dim_names}
            glob = _global_state(final["whole"], whole, mesh)
            rc["state"] = {"want": flat(sharding.local_shard(glob, s_specs, mesh, coords)),
                           "got": flat(final["tp"]),
                           "specs": {treepath.path_str(pa): tuple(sp) for pa, sp in
                                     treepath.flatten_with_path(s_specs)}}
    return rc


def tp_steps(inp, out, key: str = "tp") -> None:
    """The ``tp`` job (and ``tp_families``, on ``inp[key]``): per mesh of
    ``inp[key]["meshes"]`` (model sizes of ``make_host_mesh``) each case
    (``_tp_case``); for ``tp`` the tensor-parallel pieces alone; then the
    FLOP count."""
    res = {}
    for model in inp[key]["meshes"]:
        mesh = make_host_mesh(model=model)
        r = {case: _tp_case(inp[key], case, mesh) for case in inp[key]["cases"]}
        if key == "tp":
            r["unit"] = _tp_collectives(inp, mesh)
        else:
            r["unit"] = _tp_family_pieces(inp[key], mesh)
        r["coords"] = {"data": direct.axis_index("data", mesh),
                       "model": direct.axis_index("model", mesh)}
        if model == 4:
            r["flops"] = _tp_flops(inp[key], mesh)
        res[model] = r
    out[key] = res


def _tp_family_pieces(tpi, mesh) -> dict:
    """The vocabulary-parallel cross-entropy on bfloat16 logits (Griffin's
    head makes them): each rank's terms and the gradient of its block, the
    dp rank's rows of ``tpi["unit"]``."""
    u = tpi["unit"]
    p, m = direct.axis_size("model", mesh), direct.axis_index("model", mesh)
    n = u["logits"].shape[0] // direct.axis_size("data", mesh)
    rows = slice(direct.axis_index("data", mesh) * n, (direct.axis_index("data", mesh) + 1) * n)
    v = u["logits"].shape[-1] // p
    logits = t_(u["logits"][rows, :, m * v:(m + 1) * v]).to(torch.bfloat16).requires_grad_()
    total, count = L.vocab_parallel_cross_entropy_terms(
        logits, t_(u["labels"][rows]), t_(u["mask"][rows]), "model", mesh)
    total.backward()
    return {"ce_bf16": {"total": float(total), "count": float(count),
                        "dlogits": np_(logits.grad), "grad_dtype": str(logits.grad.dtype)}}


def run_rank(job: str, rank: int, world: int, store_path: str, inputs: str, out_dir: str,
             device: str) -> None:
    global DEV
    if device == "cuda":
        torch.cuda.set_device(rank)
        DEV = torch.device("cuda", rank)
    torch.set_num_threads(1)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            store=dist.FileStore(store_path, world), rank=rank, world_size=world,
                            timeout=timedelta(seconds=PG_TIMEOUT_S))
    inp = pickle.loads(Path(inputs).read_bytes())
    out = {"backend": dist.get_backend()}
    if job == "main":
        collectives(inp, rank, out)
        dataframe(inp, rank, out)
        attention(inp, rank, out)
        dense(inp, rank, out)
        driver(inp, rank, out, Path(out_dir) / f"ckpt_{device}")
        # the MoE over a replicated axis of 4, and over the dp axis itself
        model = init_device_mesh(DEV.type, (4,), mesh_dim_names=("model",))
        data = init_device_mesh(DEV.type, (4,), mesh_dim_names=("data",))
        out["moe"] = moe_ep(inp, rank, out, model, "model")
        out["moe"]["decode"] = moe_ep_decode(inp, model, "model")
        out["moe"]["step_over_dp"] = moe_train_step(inp, data, "data", "data")
    elif job == "shard":
        shard(out)
    elif job == "sharded":
        sharded_steps(inp, out)
    elif job == "tp":
        tp_steps(inp, out)
    elif job == "tp_families":
        tp_steps(inp, out, "tp_families")
    else:
        mesh = init_device_mesh(DEV.type, (2, 4), mesh_dim_names=("data", "model"))
        out["moe"] = moe_ep(inp, rank, out, mesh, "model", "data")
        out["moe"]["step"] = moe_train_step(inp, mesh, "model", "data")
    (Path(out_dir) / f"{job}_{device}_rank{rank}.pkl").write_bytes(pickle.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


# card results against the CPU's: (absolute + relative) limits by part, each
# the limit its tier-1 test holds the CPU run to against the reference.  The
# driver draws its weights from a generator on its own device, so its card
# and CPU losses differ from step 0: each is held to its own kill/resume.
CARD_TOL = {"collectives": 1e-6, "attention": 1e-4, "logits": 1e-4, "loss": 1e-5}


def _close(a, b, tol) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind in "iub" or tol == 0:
        return a.shape == b.shape and bool(np.array_equal(a, b))
    return a.shape == b.shape and bool(np.all(np.abs(a - b) <= tol + tol * np.abs(b)))


def compare_cards(card: list[dict], cpu: list[dict]) -> dict:
    """Every card rank's results against the same rank's on the CPU: the
    names that fail, and the largest differences by part."""
    lr = OPT["lr"]
    bad, worst = [], {}

    def check(name, a, b, tol):
        ok = _close(a, b, tol)
        if np.asarray(b).dtype.kind == "f" and np.asarray(a).shape == np.asarray(b).shape:
            d = float(np.max(np.abs(np.asarray(a) - np.asarray(b)), initial=0.0))
            part = name.split("/")[1]
            worst[part] = max(worst.get(part, 0.0), d)
        if not ok:
            bad.append(name)

    for r, (g, c) in enumerate(zip(card, cpu)):
        if g["backend"] != "nccl":
            bad.append(f"rank{r}/backend {g['backend']}")
        for name in EXACT:
            check(f"{r}/collectives/{name}", g["collectives"][name], c["collectives"][name], 0)
        for name in SUMS:
            check(f"{r}/collectives/{name}", g["collectives"][name], c["collectives"][name],
                  CARD_TOL["collectives"])
        for run, (cols, count) in c["dataframe"].items():
            gcols, gcount = g["dataframe"][run]
            if gcount != count:
                bad.append(f"{r}/dataframe/{run}/count")
            for k, v in cols.items():
                check(f"{r}/dataframe/{run}/{k}", gcols[k], v, 0)
        for case, res in c["attention"].items():
            for k in ("o", "dq", "dk", "dv"):
                check(f"{r}/attention/{case}/{k}", g["attention"][case][k], res[k],
                      CARD_TOL["attention"])
        gd, cd = g["dense"], c["dense"]
        check(f"{r}/dense/logits", gd["logits"], cd["logits"], CARD_TOL["logits"])
        for k in ("loss", "ce"):
            check(f"{r}/dense/{k}", gd[k], cd[k], CARD_TOL["loss"])
        check(f"{r}/dense/dp_step_loss", gd["dp_step"]["loss"], cd["dp_step"]["loss"],
              CARD_TOL["loss"])
        for step, limit in (("dp_step", 2 * lr), ("compressed_step", 2 * 3 * lr)):
            gp, cp = treepath.leaves(gd[step]["params"]), treepath.leaves(cd[step]["params"])
            diff = max(float(np.abs(a - b).max()) for a, b in zip(gp, cp))
            worst[step] = max(worst.get(step, 0.0), diff)
            if diff > limit:
                bad.append(f"{r}/dense/{step}_params {diff} > {limit}")
        for li, lc in zip(gd["compressed_step"]["losses"], cd["compressed_step"]["losses"]):
            if abs(li - lc) > 0.02 * abs(lc):
                bad.append(f"{r}/dense/compressed_step_losses")
        drv = g["driver"]
        if not np.allclose(drv["resumed"], drv["full"][2:], rtol=1e-6) \
                or not any("explicit path ON" in line for line in drv["log"]):
            bad.append(f"{r}/driver")
    return {"mismatches": bad, "max_abs_diff": worst, "driver_losses": card[0]["driver"]["full"]}


def cards(world: int = 4, out: str | None = None) -> int:
    """The ``main`` job on ``world`` cards (NCCL) and on the CPU (gloo) at
    once; the card results held against the CPU's (module doc)."""
    if torch.cuda.device_count() < world:
        print(f"cards: {world} cards wanted, {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 2
    tmp = Path(out or tempfile.mkdtemp())
    tmp.mkdir(parents=True, exist_ok=True)
    inputs = tmp / "inputs.pkl"
    inputs.write_bytes(pickle.dumps(make_inputs()))
    t0 = time.perf_counter()
    card, cpu = launch("main", world, tmp, inputs, "cuda"), launch("main", world, tmp, inputs)
    wait(card, f"the {world}-card NCCL job")
    card_s = time.perf_counter() - t0
    wait(cpu, f"the {world}-rank gloo job")
    res = compare_cards(load(tmp, "main", world, "cuda"), load(tmp, "main", world))
    print(json.dumps({"world": world, "backend": "nccl", "card_job_wall_s": card_s, **res}))
    return 1 if res["mismatches"] else 0


if __name__ == "__main__":
    if sys.argv[1] == "cards":
        sys.exit(cards(*(int(a) if i == 0 else a for i, a in enumerate(sys.argv[2:]))))
    job, rank, world, store, inputs_, out_dir = sys.argv[1:7]
    run_rank(job, int(rank), int(world), store, inputs_, out_dir,
             sys.argv[7] if len(sys.argv) > 7 else "cpu")
