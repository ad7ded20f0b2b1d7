"""Training entry point: data pipeline -> train loop -> checkpoint/restart — the
port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b --steps 30
    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b --device cpu

Runs on the card unless ``--device cpu`` is given (and raises without one).
The config is the reduced one unless ``--no-reduced``, as in the
reference's ``launch.train``.  Fault tolerance: a checkpoint every
``ckpt_every`` steps and on the way out; ``--resume`` continues from the
latest, and ``--stop-after`` exits early (the preemption drill).  Parameters come from an explicit
``torch.Generator`` seeded with ``seed``; the data from the pipeline's numpy
seeds, equal to the reference's.

The modeled communication session (``comm_session``, ``burst_*``,
``shrink_*``, ``recovery_policy``; ``--comm-world`` / ``--comm-fabric``) and
the span ``tracer`` (``--trace-out``) are the reference's, with the same log
lines and spans:

    python -m repro_torch.launch.train --no-reduced --comm-world 64 \
        --comm-fabric lambda --trace-out t.json
    python scripts/trace_to_chrome.py t.json

The reference's gate for the explicit compressed data-parallel step:
with ``cfg.grad_compression``, a dp world above 1 and a batch it divides,
every rank runs ``make_compressed_dp_train_step`` on its slice of the
global batch (int8 + error feedback on the wire) and logs "explicit path
ON" beside the modeled implicit-vs-explicit dp reduction.  The dp world is
every rank of an initialised ``torch.distributed`` process group (one rank
a card, or gloo processes on the CPU), as the reference's is every device.
The error-feedback residual is training state: each rank's joins the
checkpoint, stacked ``[world, ...]`` as the reference stores it, so a
killed and resumed run reproduces the uninterrupted losses.  With more than
one rank, rank 0 writes the checkpoints.
"""

from __future__ import annotations

import argparse
import json
import time
from collections.abc import Callable
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core import algorithms, netsim
from repro_torch.core.backends import direct
from repro_torch.core.communicator import Communicator
from repro_torch.core.session import CommSession
from repro_torch.core.trace import Tracer
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist import compression, treepath
from repro_torch.dist.object_store import Store, as_store
from repro_torch.models import api
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_compressed_dp_train_step, make_train_step


def build_dataset(cfg, batch: int, seq_len: int, seed: int = 0, device=None):
    """Preprocess a synthetic corpus through the dataframe pipeline."""
    return pipeline.preprocess_local(
        *pipeline.synthesize_corpus(ndocs=512, doc_len=seq_len, vocab=cfg.vocab_size, seed=seed),
        batch=batch, seq_len=seq_len, device=device,
    )


def data_iter(cfg, batch: int, seq_len: int, seed: int = 0, start: int = 0, device=None):
    """Infinite size-``batch`` slices, aligned to the *global* step.

    Each synthesized corpus shard is consumed as its ``n`` full batches
    before the next shard is built.  The (shard, slice) cursor is a pure
    function of the global step, so a run resumed at ``start`` consumes
    exactly the slices an uninterrupted run would."""
    step = 0
    shard = 0
    while True:
        (toks, mask), _ = build_dataset(cfg, batch, seq_len, seed=seed + shard, device=device)
        n = max(toks.shape[0] // batch, 1)
        for i in range(n):
            if step >= start:
                sl = slice(i * batch, (i + 1) * batch)
                yield {"tokens": toks[sl], "mask": mask[sl].to(torch.float32)}
            step += 1
        shard += 1


def train(
    cfg,
    *,
    steps: int = 100,
    batch: int = 4,
    seq_len: int = 64,
    lr: float = 3e-3,
    ckpt_dir: str | Path | Store | None = None,
    ckpt_every: int = 50,
    log_every: int = 10,
    resume: bool = False,
    stop_after: int | None = None,
    comm_session=None,
    burst_at: int | None = None,
    burst_world: int = 0,
    burst_provider: str | None = None,
    shrink_at: int | None = None,
    shrink_world: int = 0,
    recovery_policy: str = "incremental",
    tracer=None,
    log=print,
    device=None,
    seed: int = 0,
    on_step: Callable[[int, float], None] | None = None,
):
    """Train ``cfg`` for ``steps`` steps on ``device`` (default: the card);
    returns (params, per-step losses).

    ``stop_after`` simulates a bounded worker lifetime: the LR schedule stays
    pinned to ``steps`` but the loop exits after that many global steps, and
    a later ``resume=True`` call with the same ``steps`` continues the
    identical trajectory from the latest checkpoint.  ``on_step(step, loss)``
    is called as each step's loss reaches the host.

    ``comm_session`` (a :class:`repro_torch.core.session.CommSession`) models
    the worker's communication fabric: a resumed run is a preempted rank
    coming back, so it re-bootstraps through the session (re-rendezvous +
    re-punch, priced into the session's event log) before training continues.

    ``burst_at``/``burst_world``/``burst_provider`` admit ``burst_world``
    workers (optionally from another provider) at that global step through
    ``CommSession.expand``; ``shrink_at``/``shrink_world`` evict the top
    ``shrink_world`` ranks at that step (detector, then ``CommSession.shrink``
    per ``recovery_policy``: ``"incremental"`` or ``"cold"``).  Both change
    only the priced fabric, never the training math, so kill/resume traces
    stay identical; a run resumed past either step re-applies it to its
    fresh session.

    ``tracer`` (a :class:`repro_torch.core.trace.Tracer`) collects the run's
    modeled timeline on rank 0's lanes: per-step ``compute`` spans (measured
    step time), ``overhead`` spans for data fetch, ``store`` spans for every
    checkpoint op, ``bootstrap`` spans mirrored from the session lifecycle,
    and — with a ``comm_session`` — one ``comm`` span per step for the
    modeled gradient all-reduce over that session's world."""
    dev = resolve_device(device)
    opt_cfg = opt.OptConfig(
        lr=lr, warmup_steps=max(steps // 20, 5), total_steps=steps,
        schedule=cfg.schedule, state_dtype=cfg.opt_state_dtype,
    )
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = api.init_params(cfg, gen, device=dev, master=True)
    opt_state = opt.init_state(params, opt_cfg)

    grad_comm = None
    grad_nbytes = 0
    if tracer is not None:
        if comm_session is not None:
            # live mirroring: rebootstrap/expand events land as rank-0
            # bootstrap spans the moment the session prices them
            comm_session.attach_tracer(tracer, ranks=(0,))
            grad_comm = Communicator(session=comm_session)
            grad_nbytes = int(sum(x.numel() * x.element_size() for x in api.tree_leaves(params)))
            if cfg.grad_compression:
                grad_nbytes = int(compression.wire_bytes_saved(params)["compressed_bytes"])
        if ckpt_dir is not None:
            # wrap once so every checkpoint op mirrors onto the store lane
            ckpt_dir = as_store(ckpt_dir)
            ckpt_dir.attach_tracer(tracer)

    # the explicit compressed dp-reduction: the reference's gate
    dp = dist.get_world_size() if dist.is_initialized() else 1
    use_explicit_dp = bool(cfg.grad_compression) and dp > 1 and batch % dp == 0
    writer = not dist.is_initialized() or dist.get_rank() == 0
    grad_err = None
    if use_explicit_dp:
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh(dev.type, (dp,), mesh_dim_names=("data",))
        step_fn, init_err = make_compressed_dp_train_step(cfg, opt_cfg, mesh)
        grad_err = init_err(params)
    else:
        step_fn = make_train_step(cfg, opt_cfg)

    def ckpt_tree():
        tree = {"params": params, "opt": opt_state}
        if use_explicit_dp:  # every rank's residual, [world, ...]
            tree["grad_err"] = treepath.tree_map(
                lambda e: direct.allgather(e[None], "data", dim=0, mesh=mesh), grad_err)
        return tree

    def save(step):
        tree = ckpt_tree()  # a collective with the explicit path: every rank
        if writer:
            ckpt.save(ckpt_dir, step, tree)
        if dist.is_initialized():
            dist.barrier()

    start = 0
    if resume and ckpt_dir and (last := ckpt.latest(ckpt_dir)):
        like = {"params": params, "opt": opt_state}
        if use_explicit_dp:
            like["grad_err"] = treepath.tree_map(lambda e: torch.empty((dp,) + e.shape), grad_err)
        tree = ckpt.restore(last, like)
        params, opt_state = tree["params"], tree["opt"]
        if use_explicit_dp:
            rank = direct.axis_index("data", mesh)
            grad_err = treepath.tree_map(lambda e: e[rank].to(dev), tree["grad_err"])
        start = ckpt.read_manifest(last)["step"]
        log(f"resumed from step {start}")
        if comm_session is not None and start > 0:
            reboot_s = comm_session.rebootstrap_rank(0)
            log(f"re-bootstrap: rank 0 re-joined its CommSession "
                f"(world {comm_session.world}) in {reboot_s:.1f}s modeled "
                f"rendezvous + re-punch")

    if cfg.grad_compression:
        rep = compression.wire_bytes_saved(params)
        log(f"grad compression: int8+scales {rep['compressed_bytes']/2**20:.1f} MiB "
            f"vs bf16 {rep['bf16_bytes']/2**20:.1f} MiB "
            f"({rep['ratio_vs_bf16']:.2f}x) per exchange")
        # the dp-reduction model (against the implicit float32 all-reduce),
        # Lambda-direct at the paper's 64-node point
        implicit = algorithms.select_algorithm(
            "allreduce", 64, 4 * rep["elements"], netsim.LAMBDA_DIRECT)
        explicit = algorithms.select_algorithm(
            "allgather", 64, rep["compressed_bytes"], netsim.LAMBDA_DIRECT)
        why_off = (
            "" if use_explicit_dp
            else " (single device)" if dp == 1
            else f" (batch {batch} not divisible by {dp} devices)"
        )
        log(f"dp-reduction model @64/lambda-direct: implicit f32 all-reduce "
            f"{implicit.time_s*1e3:.1f} ms ({implicit.algorithm}) vs explicit "
            f"int8 allgather {explicit.time_s*1e3:.1f} ms ({explicit.algorithm}); "
            f"explicit path {'ON' if use_explicit_dp else 'off' + why_off}")

    def apply_burst():
        nonlocal grad_comm
        expand_s = comm_session.expand(burst_world, provider=burst_provider)
        if grad_comm is not None:
            grad_comm = Communicator(session=comm_session)
        full_s = comm_session.full_rebootstrap_time_s()
        who = f" from {burst_provider}" if burst_provider else ""
        log(f"burst: +{burst_world} workers{who} admitted at step {burst_at} "
            f"-> world {comm_session.world}; incremental expand {expand_s:.1f}s "
            f"modeled vs {full_s:.1f}s cold re-bootstrap of the grown world "
            f"({expand_s / max(full_s, 1e-9):.0%})")

    def apply_shrink():
        nonlocal grad_comm
        dead = list(range(comm_session.world - shrink_world, comm_session.world))
        label = "_".join(f"r{r}" for r in dead)
        detect_s = comm_session.detect_failure(label)
        shrink_s = comm_session.shrink(dead, policy=recovery_policy)
        if grad_comm is not None:
            grad_comm = Communicator(session=comm_session)
        # baseline: what a cold re-bootstrap of the survivor world costs
        full_s = comm_session.full_rebootstrap_time_s()
        log(f"shrink: ranks {dead} evicted at step {shrink_at} -> world "
            f"{comm_session.world}; detect {detect_s:.1f}s + "
            f"{recovery_policy} shrink {shrink_s:.1f}s modeled vs "
            f"{full_s:.1f}s cold re-bootstrap of the survivor world "
            f"({(detect_s + shrink_s) / max(full_s, 1e-9):.0%})")

    do_burst = comm_session is not None and burst_at is not None and burst_world > 0
    if do_burst and start > burst_at:
        # resumed past the burst: the expanded world is part of history
        apply_burst()
        do_burst = False
    do_shrink = comm_session is not None and shrink_at is not None and shrink_world > 0
    if do_shrink and start > shrink_at:
        # resumed past the eviction: the shrunk world is part of history
        apply_shrink()
        do_shrink = False

    # start the iterator at the global step so a resumed run consumes the
    # same data slices an uninterrupted run would (loss-trace continuity)
    it = data_iter(cfg, batch, seq_len, start=start, device=dev)
    losses = []
    t0 = time.time()
    end = steps if stop_after is None else min(steps, stop_after)
    for step in range(start, end):
        if do_burst and step == burst_at:
            apply_burst()
            do_burst = False
        if do_shrink and step == shrink_at:
            apply_shrink()
            do_shrink = False
        t_fetch = time.perf_counter()
        batch_data = next(it)
        fetch_s = time.perf_counter() - t_fetch
        t_step = time.perf_counter()
        if use_explicit_dp:
            params, opt_state, grad_err, metrics = step_fn(params, opt_state, grad_err,
                                                           batch_data)
        else:
            params, opt_state, metrics = step_fn(params, opt_state, batch_data)
        losses.append(float(metrics["loss"]))
        if tracer is not None:
            tracer.span(0, "overhead", "data_fetch", duration_s=fetch_s, step=step)
            tracer.span(0, "compute", "train_step",
                        duration_s=time.perf_counter() - t_step, step=step)
            if grad_comm is not None:
                tracer.span(
                    0, "comm", "grad_allreduce",
                    duration_s=grad_comm.collective_time_s("allreduce", grad_nbytes),
                    nbytes=grad_nbytes, step=step, world=comm_session.world,
                )
        if on_step is not None:
            on_step(step, losses[-1])
        if step % log_every == 0 or step == end - 1:
            log(f"step {step:4d} loss {losses[-1]:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"({(time.time() - t0) / max(step - start + 1, 1):.2f}s/step)")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save(step + 1)
    # checkpoint on the way out (graceful preemption / end of run) so a
    # stop_after drill never exits with unsaved progress
    if ckpt_dir and end > start and end % ckpt_every != 0:
        save(end)
    if tracer is not None and tracer.spans:
        lanes = ", ".join(
            f"{lane} {tracer.lane_time_s(lane):.3f}s"
            for lane in ("compute", "comm", "store", "bootstrap", "overhead")
            if tracer.lane_time_s(lane) > 0.0
        )
        log(f"trace: {len(tracer.spans)} spans — {lanes}")
    return params, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True,
                    help="the reduced config (default), or --no-reduced for full width")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--stop-after", type=int, default=None,
                    help="exit after this many global steps (preemption drill)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--comm-world", type=int, default=32,
                    help="modeled communication-session world for the "
                         "re-bootstrap pricing on --resume")
    ap.add_argument("--comm-fabric", default="lambda",
                    help="fabric or registered provider name for the modeled "
                         "communication session (e.g. lambda, aws-ec2)")
    ap.add_argument("--burst-at", type=int, default=None,
                    help="global step at which the modeled session absorbs a "
                         "traffic burst (requires --burst-world)")
    ap.add_argument("--burst-world", type=int, default=0,
                    help="workers admitted at --burst-at via the incremental "
                         "expand path")
    ap.add_argument("--burst-provider", default=None,
                    help="provider the burst workers come from (cross-provider "
                         "pairs relay; default: the core fabric's)")
    ap.add_argument("--shrink-at", type=int, default=None,
                    help="global step at which a fault domain evicts workers "
                         "from the modeled session (requires --shrink-world)")
    ap.add_argument("--shrink-world", type=int, default=0,
                    help="workers evicted at --shrink-at (the top ranks)")
    ap.add_argument("--recovery-policy", default="incremental",
                    choices=("incremental", "cold"),
                    help="how the session recovers from the eviction: "
                         "incremental shrink (membership compaction + relay "
                         "GC) or a cold re-bootstrap of the survivors")
    ap.add_argument("--trace-out", default=None,
                    help="write the run's modeled span timeline here as raw "
                         "JSON (convert with scripts/trace_to_chrome.py for "
                         "chrome://tracing)")
    args = ap.parse_args()
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    comm_session = None
    # --trace-out wants comm spans too, so it also builds the modeled session
    if args.resume or (args.burst_at is not None and args.burst_world > 0) \
            or (args.shrink_at is not None and args.shrink_world > 0) \
            or args.trace_out is not None:
        comm_session = CommSession.bootstrap(args.comm_world, args.comm_fabric)
    tracer = Tracer() if args.trace_out is not None else None
    _, losses = train(
        cfg, steps=args.steps, batch=args.batch, seq_len=args.seq_len,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        resume=args.resume, stop_after=args.stop_after,
        comm_session=comm_session,
        burst_at=args.burst_at, burst_world=args.burst_world,
        burst_provider=args.burst_provider,
        shrink_at=args.shrink_at, shrink_world=args.shrink_world,
        recovery_policy=args.recovery_policy,
        tracer=tracer, device=args.device, seed=args.seed,
    )
    if tracer is not None:
        Path(args.trace_out).write_text(json.dumps(tracer.to_json()))
        cp = tracer.critical_path()
        lanes = ", ".join(f"{k} {v:.3f}s" for k, v in cp["lanes"].items())
        print(f"trace written to {args.trace_out}: {len(tracer.spans)} spans; "
              f"critical rank {cp['rank']} chain {cp['total_s']:.3f}s ({lanes})")
    if losses:
        print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})")
    else:
        print("no steps to run (already at or past the target step)")


if __name__ == "__main__":
    main()
