"""Host-bound timings of the serving and RWKV-6, Griffin and Whisper paths,
or of the dry-run's decode ranks, two trees of the port side by side on one
card.

    python scripts/torch_host_ab.py PARENT_TREE [CHANGE_TREE]
    python scripts/torch_host_ab.py --rank-decode [--steps N] PARENT_TREE [CHANGE_TREE]

Each tree (a checkout of the repo; CHANGE_TREE defaults to this one) runs in
a process of its own with its ``src`` first on ``PYTHONPATH``, in turns:
parent, change, change, parent.  A run serves each model at full width
from random weights (a generator seeded 0; gemma3-4b whole, as
``chip_smoke.py``'s serve phase, with a prompt of 4 x 4096 tokens;
rwkv6-7b at 8 of its 32 layers and recurrentgemma-9b at 6 of its 38 with
4 x 256; whisper-medium whole, 4 tokens over 1500 frames), then 32 greedy
tokens, each step ended by its token on the host; and whisper-medium's
training step (``make_train_step``, B 4 x 448 tokens over 1500 frames). It
prints per run the median token gap of steps 3-32 (ms) and the median of
training steps 2-5 (s), one JSON line each, and the card's name and power
limit.  With ``--rank-decode`` a run holds rank (0, 0) of the 16 x 16
production mesh under a ``fake`` process group (``launch.dryrun``: its
collectives move nothing) for gemma3-4b and internvl2-2b ``decode_32k``,
its arguments made on the card from a generator seeded 0 (the caches
zeros), and times N serving steps (default 100) after 3, each ended by
``cuda.synchronize``: it prints their median and 10th and 90th percentile
walls (s) and the aten ops one step dispatches (a ``TorchDispatchMode``
count: the host's work).  Only for the card: it exits 2 without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

RUN = r'''
import dataclasses, json, statistics, time, torch
from repro_torch import configs
from repro_torch.models import api
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
dev = torch.device("cuda")
res = {}
for arch, over, b, t in (("gemma3-4b", {}, 4, 4096), ("rwkv6-7b", {"num_layers": 8}, 4, 256),
                         ("recurrentgemma-9b", {"num_layers": 6}, 4, 256),
                         ("whisper-medium", {}, 4, 4)):
    cfg = dataclasses.replace(configs.get(arch), **over)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = api.init_params(cfg, gen, device=dev)
    state = api.init_decode_state(cfg, b, t + 40, torch.bfloat16, device=dev)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, t), generator=gen, device=dev,
                                     dtype=torch.int32)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn(b, cfg.source_positions, cfg.d_model, generator=gen,
                                      device=dev)
    with torch.inference_mode():
        logits, state = api.prefill_fn(cfg, params, batch, state)
        tok = logits.argmax(-1).to(torch.int32)
        gaps = []
        for _ in range(32):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, state = api.decode_fn(cfg, params, tok, state)
            tok = logits.argmax(-1).to(torch.int32)
            tok.cpu()
            gaps.append((time.perf_counter() - t0) * 1e3)
    res[f"{arch}/gap_ms"] = statistics.median(gaps[2:])
    del params, state, logits
    torch.cuda.empty_cache()
cfg = configs.get("whisper-medium")
gen = torch.Generator(device=dev).manual_seed(0)
params = api.init_params(cfg, gen, device=dev, master=True)
ocfg = opt.OptConfig(lr=3e-4)
ostate = opt.init_state(params, ocfg)
step = make_train_step(cfg, ocfg)
batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 448), generator=gen, device=dev,
                                 dtype=torch.int32),
         "mask": torch.ones(4, 448, device=dev),
         "frames": torch.randn(4, 1500, cfg.d_model, generator=gen, device=dev)}
steps = []
for _ in range(5):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, ostate, metrics = step(params, ostate, batch)
    float(metrics["loss"])
    steps.append(time.perf_counter() - t0)
res["whisper-medium/train_step_s"] = statistics.median(steps[1:])
print(json.dumps(res))
'''

RANK_DECODE = r'''
import json, statistics, sys, time, torch
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch import configs
from repro_torch.launch import dryrun, shapes
from repro_torch.launch.mesh import make_production_mesh


class Ops(TorchDispatchMode):
    n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


steps = int(sys.argv[1])
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
mesh = make_production_mesh()
coords = {"data": 0, "model": 0}
mesh_dev = dryrun.fake_mesh(mesh, coords, "cuda")
gen = torch.Generator(device=dev).manual_seed(0)
res = {}
for arch in ("gemma3-4b", "internvl2-2b"):
    cfg = configs.get(arch)
    rc = dryrun.rank_cell(cfg, shapes.SHAPES["decode_32k"], mesh, coords)

    def make(t, cfg=cfg):
        if t.dtype == torch.int32:
            return torch.randint(0, cfg.vocab_size, tuple(t.shape), generator=gen, device=dev,
                                 dtype=torch.int32)
        if not t.dtype.is_floating_point or t.dim() >= 5:   # the caches
            return torch.zeros(tuple(t.shape), dtype=t.dtype, device=dev)
        return (torch.randn(tuple(t.shape), generator=gen, device=dev) * 0.02).to(t.dtype)

    args = dryrun.materialize(rc, make)
    step = dryrun.rank_step(cfg, rc, mesh_dev, args)
    walls = []
    with torch.no_grad():
        for _ in range(3 + steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        ops = Ops()
        with ops:
            step()
    deciles = statistics.quantiles(walls[3:], n=10)
    res[arch] = {"step_s": statistics.median(walls[3:]), "p10_s": deciles[0],
                 "p90_s": deciles[-1], "steps": steps, "aten_ops": ops.n}
    del args, step
    torch.cuda.empty_cache()
print(json.dumps(res))
'''


def main() -> int:
    argv = sys.argv[1:]
    rank_decode = "--rank-decode" in argv
    steps = argv[argv.index("--steps") + 1] if "--steps" in argv else "100"
    paths = [a for i, a in enumerate(argv) if not a.startswith("--")
             and (i == 0 or argv[i - 1] != "--steps")]
    if not paths:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("torch_host_ab: no CUDA device", file=sys.stderr)
        return 2
    trees = {"parent": Path(paths[0]).resolve(),
             "change": Path(paths[1] if len(paths) > 1 else
                            Path(__file__).resolve().parents[1]).resolve()}
    body = [RANK_DECODE, steps] if rank_decode else [RUN]
    for name in ("parent", "change", "change", "parent"):
        env = dict(os.environ, PYTHONPATH=str(trees[name] / "src"))
        proc = subprocess.run([sys.executable, "-c", *body], env=env, cwd=trees[name],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        print(json.dumps({"tree": name, **json.loads(proc.stdout.strip().splitlines()[-1])}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
