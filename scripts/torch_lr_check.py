#!/usr/bin/env python3
"""Whether the reference and the port diverge alike at the training driver's
default learning rate, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_lr_check.py \
        [--layers 2] [--steps 12] [--batch 2] [--seq-len 256] [--lr 3e-3]

Runs ``repro.launch.train.train`` (JAX) and ``repro_torch.launch.train.train``
(``device="cpu"``, the plain versions of the kernels) on minicpm-2b at full
width with ``--layers`` layers, each in its own process, one after the other,
so that the two never share memory.  Both start from the same weights (the
reference's ``init_params`` at ``PRNGKey(0)``, handed to the port through
``interop.params_from_numpy(..., master=True)``) and read the same batches
(each driver's own ``data_iter``, equal by ``tests/test_torch_pipeline.py``).
One JSON line per package with its per-step losses, then one comparing them
step by step: the largest relative difference, and whether each run stayed
finite and ended below its first loss.  A 2-layer run holds about 10 GB at
its peak.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time


def run_reference(args) -> dict:
    from repro import configs as jconfigs
    from repro.launch import train as jtrain

    cfg = dataclasses.replace(jconfigs.get(args.arch), num_layers=args.layers)
    t0 = time.perf_counter()
    _, losses = jtrain.train(cfg, steps=args.steps, batch=args.batch, seq_len=args.seq_len,
                             lr=args.lr, log_every=1, log=lambda *a: None)
    return {"package": "repro", "losses": [float(x) for x in losses],
            "wall_s": time.perf_counter() - t0}


def run_port(args) -> dict:
    import jax
    import numpy as np

    from repro.models import api as japi
    from repro_torch import configs as tconfigs, interop
    from repro_torch.launch import train as ttrain

    import repro.configs as jconfigs

    jcfg = dataclasses.replace(jconfigs.get(args.arch), num_layers=args.layers)
    np_params = jax.tree.map(np.asarray, japi.init_params(jcfg, jax.random.PRNGKey(0)))
    cfg = dataclasses.replace(tconfigs.get(args.arch), num_layers=args.layers)
    init = ttrain.api.init_params

    def same_weights(cfg_, gen, device=None, master=False):
        return interop.params_from_numpy(cfg_, np_params, device, master=master)

    ttrain.api.init_params = same_weights  # the reference's weights, not the port's own
    try:
        t0 = time.perf_counter()
        _, losses = ttrain.train(cfg, steps=args.steps, batch=args.batch, seq_len=args.seq_len,
                                 lr=args.lr, log_every=1, log=lambda *a: None, device="cpu")
    finally:
        ttrain.api.init_params = init
    return {"package": "repro_torch", "losses": [float(x) for x in losses],
            "wall_s": time.perf_counter() - t0}


def summary(ref: list[float], port: list[float]) -> dict:
    rel = [abs(a - b) / abs(a) for a, b in zip(ref, port)]

    def verdict(losses):
        finite = all(math.isfinite(x) for x in losses)
        return {"finite": finite, "falls": finite and losses[-1] < losses[0],
                "max_rise_over_first": max(losses) - losses[0] if finite else None}

    return {"max_rel_diff": max(rel), "rel_diff_per_step": rel,
            "first_step_over_1e-3": next((i for i, r in enumerate(rel) if r > 1e-3), None),
            "repro": verdict(ref), "repro_torch": verdict(port)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--one", choices=("repro", "repro_torch"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        out = run_reference(args) if args.one == "repro" else run_port(args)
        print(json.dumps({**vars(args), **out, "one": None}), flush=True)
        return 0
    rows = {}
    for pkg in ("repro", "repro_torch"):
        cmd = [sys.executable, __file__, "--one", pkg] + [
            f"--{k.replace('_', '-')}={v}" for k, v in vars(args).items() if k != "one"]
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        line = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        rows[pkg] = line["losses"]
    print(json.dumps(summary(rows["repro"], rows["repro_torch"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
