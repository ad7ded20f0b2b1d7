"""Host-bound timings of the serving and RWKV-6, Griffin and Whisper paths,
two trees of the port side by side on one card.

    python scripts/torch_host_ab.py PARENT_TREE [CHANGE_TREE]

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
limit.  Only for the card: it exits 2 without one.
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


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("torch_host_ab: no CUDA device", file=sys.stderr)
        return 2
    trees = {"parent": Path(sys.argv[1]).resolve(),
             "change": Path(sys.argv[2] if len(sys.argv) > 2 else
                            Path(__file__).resolve().parents[1]).resolve()}
    for name in ("parent", "change", "change", "parent"):
        env = dict(os.environ, PYTHONPATH=str(trees[name] / "src"))
        proc = subprocess.run([sys.executable, "-c", RUN], env=env, cwd=trees[name],
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
