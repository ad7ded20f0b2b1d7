#!/usr/bin/env python3
"""Check and time the flash-attention backward kernel on the card, for one or
more copies of the port (to compare a change with its parent in one call).

    python3 scripts/torch_flash_bwd_bench.py [SRC_DIR ...] [--reps N]

Each SRC_DIR is a ``src`` directory holding a ``repro_torch`` package
(default: this checkout's ``src``); each runs in its own process, in the
order given (list a parent and a change as A B B A).  Per package: the
build time and each ``bwd_wgmma`` kernel's registers and spilled bytes
(ptxas); then at minicpm-2b's train shape, h2o-danube's and two ragged
ones, whether dq, dk, dv lie within ``BWD_TOL`` of ``ref.attention_bwd_ref``
(and, where not, how many entries fail and the median signed deviation of
those, relative to the expected value), whether a repeat is bit-equal, and
the time (``chip_smoke.Timer``: CUDA events behind a sleep kernel, L2
flushed, median).  One JSON line each.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BWD_TOL = 1e-4
# (b, t, h, kvh, hd, window): minicpm-2b's train shape, h2o-danube's, ragged ones
SHAPES = ((2, 4096, 36, 36, 64, 0), (1, 4096, 32, 8, 120, 4096), (1, 4097, 8, 2, 64, 300),
          (2, 333, 8, 4, 32, 50))


def run_one(src: str, reps: int) -> None:
    sys.path.insert(0, src)
    sys.path.insert(0, str(ROOT))
    import torch

    from chip_smoke import Timer
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa_k, ref as fa_r

    t0 = time.perf_counter()
    _build.library()
    ptx = {name.split("_cu_")[-1]: [r["registers"], r["spill_store_bytes"]]
           for name, r in _build.ptxas_report("bwd_wgmma").items()}
    print(json.dumps({"src": src, "build_s": time.perf_counter() - t0, "ptxas": ptx}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    timer = Timer(torch, reps=reps)
    for b, t, h, kvh, hd, window in SHAPES:
        q, do = (torch.randn(b, t, h, hd, generator=gen, device=dev) for _ in range(2))
        k, v = (torch.randn(b, t, kvh, hd, generator=gen, device=dev) for _ in range(2))
        kw = dict(causal=True, window=window, softcap=0.0)
        o, lse = fa_k.flash_attention_lse(q, k, v, **kw)
        got = fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        exp = fa_r.attention_bwd_ref(q, k, v, o, lse, do, **kw)
        design = getattr(fa_k, "bwd_design", None)  # a parent may predate it
        out = {"src": src, "shape": [b, t, h, kvh, hd, window],
               "design": design(hd) if design else None,
               "max_abs_err": max(float((a - e).abs().max()) for a, e in zip(got, exp))}
        for name, a, e in zip(("dq", "dk", "dv"), got, exp):
            bad = (a - e).abs() > BWD_TOL + BWD_TOL * e.abs()
            if bool(bad.any()):
                out[f"{name}_over_limit"] = int(bad.sum())
                out[f"{name}_median_rel_dev"] = float(((a - e) / e)[bad].median())
        out["within_tol"] = not any(key.endswith("_over_limit") for key in out)
        again = fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        out["repeat_bit_equal"] = all(torch.equal(x, y) for x, y in zip(got, again))
        del exp, again
        out["ms"] = timer.ms(lambda: fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw))
        print(json.dumps(out), flush=True)
        del q, k, v, do, o, lse, got
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("srcs", nargs="*", default=[str(ROOT / "src")])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--one", help=argparse.SUPPRESS)  # the child process's package
    args = ap.parse_args()
    if args.one:
        run_one(args.one, args.reps)
        return 0
    rc = 0
    for src in args.srcs:
        rc |= subprocess.run([sys.executable, __file__, "--one", src, "--reps",
                              str(args.reps)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
