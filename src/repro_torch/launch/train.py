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

Not ported yet (they raise ``NotImplementedError`` naming ROADMAP A 2): the
modeled communication session (``comm_session``, ``burst_*``, ``shrink_*``,
``recovery_policy``) and the span ``tracer``; the compressed data-parallel step
(``cfg.grad_compression``), which needs the SPMD surface (A 5).
"""

from __future__ import annotations

import argparse
import time
from collections.abc import Callable
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist.object_store import Store
from repro_torch.models import api
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step


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
    is called as each step's loss reaches the host."""
    if (comm_session, tracer, burst_at, burst_provider, shrink_at) != (None,) * 5 \
            or burst_world or shrink_world or recovery_policy != "incremental":
        raise NotImplementedError("the modeled communication session and the Tracer are not "
                                  "ported yet (ROADMAP A 2)")
    if cfg.grad_compression:
        raise NotImplementedError("the compressed data-parallel step needs the SPMD surface "
                                  "(ROADMAP A 5)")
    dev = resolve_device(device)
    opt_cfg = opt.OptConfig(
        lr=lr, warmup_steps=max(steps // 20, 5), total_steps=steps,
        schedule=cfg.schedule, state_dtype=cfg.opt_state_dtype,
    )
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = api.init_params(cfg, gen, device=dev, master=True)
    opt_state = opt.init_state(params, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg)

    def ckpt_tree():
        return {"params": params, "opt": opt_state}

    start = 0
    if resume and ckpt_dir and (last := ckpt.latest(ckpt_dir)):
        tree = ckpt.restore(last, ckpt_tree())
        params, opt_state = tree["params"], tree["opt"]
        start = ckpt.read_manifest(last)["step"]
        log(f"resumed from step {start}")

    # start the iterator at the global step so a resumed run consumes the
    # same data slices an uninterrupted run would (loss-trace continuity)
    it = data_iter(cfg, batch, seq_len, start=start, device=dev)
    losses = []
    t0 = time.time()
    end = steps if stop_after is None else min(steps, stop_after)
    for step in range(start, end):
        params, opt_state, metrics = step_fn(params, opt_state, next(it))
        losses.append(float(metrics["loss"]))
        if on_step is not None:
            on_step(step, losses[-1])
        if step % log_every == 0 or step == end - 1:
            log(f"step {step:4d} loss {losses[-1]:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"({(time.time() - t0) / max(step - start + 1, 1):.2f}s/step)")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1, ckpt_tree())
    # checkpoint on the way out (graceful preemption / end of run) so a
    # stop_after drill never exits with unsaved progress
    if ckpt_dir and end > start and end % ckpt_every != 0:
        ckpt.save(ckpt_dir, end, ckpt_tree())
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
    args = ap.parse_args()
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    _, losses = train(
        cfg, steps=args.steps, batch=args.batch, seq_len=args.seq_len,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        resume=args.resume, stop_after=args.stop_after, device=args.device, seed=args.seed,
    )
    if losses:
        print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})")
    else:
        print("no steps to run (already at or past the target step)")


if __name__ == "__main__":
    main()
