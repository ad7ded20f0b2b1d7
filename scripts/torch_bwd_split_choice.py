#!/usr/bin/env python3
"""How many bf16 products the attention backward's tensor-core design needs
per float32 product (``BWD_SPLIT`` in ``csrc/flash_attention_bwd.cu``), on
the CPU through the design's emulation ``ref.attention_bwd_split_ref``.

    PYTHONPATH=src python scripts/torch_bwd_split_choice.py [--skip-step]

Two measurements, one JSON line each per product count (the first ``n`` of
``ref.BWD_PAIRS``):

* ``tolerance``: the worst |error| / (BWD_TOL (1 + |expected|)) of dq, dk,
  dv against the plain backward ``ref.attention_bwd_ref`` at three shapes;
  below 1 passes the kernel's limit.
* ``step``: the share of each bf16-rounded weight gradient of one train
  step (minicpm-2b at full width, 2 layers, 2 x 256 tokens: the shape of
  ``chip_smoke.py``'s ``train_check`` (a)) that comes out bit-equal with the
  split backward in place of the plain one, both on the CPU.  train_check
  (a) requires >= 99% bit-equal between the card and the CPU, and the card's
  float32 products alone already cost up to 0.8% (PERF.md), so a product
  count whose emulation alone falls below ~99.8% does not pass there.

The step part builds the 2-layer model on the CPU (about 11 GB at peak,
half a minute in all on 8 cores).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json

import numpy as np
import torch

from repro_torch.kernels.flash_attention import ref as fa_r

BWD_TOL = 1e-4
MATRIX = ("wq", "wk", "wv", "wo_att", "wi", "wo", "lm_head", "embed")


def tolerance(pairs: int) -> dict:
    gen = torch.Generator().manual_seed(0)
    out = {}
    for b, t, h, kvh, hd, window, softcap in ((1, 1024, 4, 4, 64, 0, 0.0),
                                              (1, 1024, 4, 2, 128, 300, 30.0),
                                              (1, 512, 4, 1, 32, 0, 0.0)):
        q, do = (torch.randn(b, t, h, hd, generator=gen) for _ in range(2))
        k, v = (torch.randn(b, t, kvh, hd, generator=gen) for _ in range(2))
        kw = dict(causal=True, window=window, softcap=softcap)
        o, lse = fa_r.attention_lse_ref(q, k, v, **kw)
        exp = fa_r.attention_bwd_ref(q, k, v, o, lse, do, **kw)
        got = fa_r.attention_bwd_split_ref(q, k, v, o, lse, do, **kw, pairs=pairs)
        out[f"hd{hd}_T{t}_groups{h // kvh}"] = max(
            float(((g - e).abs() / (BWD_TOL * (1 + e.abs()))).max()) for g, e in zip(got, exp))
    return out


@contextlib.contextmanager
def split_backward(pairs: int):
    """ops.FlashAttention's CPU backward through the split emulation."""
    plain = fa_r.attention_bwd_ref
    fa_r.attention_bwd_ref = lambda *a, **kw: fa_r.attention_bwd_split_ref(*a, **kw, pairs=pairs)
    try:
        yield
    finally:
        fa_r.attention_bwd_ref = plain


def step_shares(counts: list[int]) -> dict[int, dict[str, float]]:
    from repro_torch import configs
    from repro_torch.dist.treepath import flatten_with_path, path_str
    from repro_torch.models import api
    from repro_torch.train.train_step import _make_grads_of

    cfg = dataclasses.replace(configs.get("minicpm-2b"), num_layers=2)
    params = api.init_params(cfg, torch.Generator().manual_seed(0), device="cpu", master=True)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256))
                                        .astype(np.int32)),
             "mask": torch.from_numpy((rng.uniform(size=(2, 256)) > 0.1).astype(np.float32))}
    grads_of = _make_grads_of(cfg, None, 1, torch.float32)

    def grads():
        _, _, g = grads_of(params, batch)
        return {path_str(p): t for p, t in flatten_with_path(g)}

    plain = grads()
    out = {}
    for n in counts:
        with split_backward(n):
            got = grads()
        out[n] = {name: float((got[name] == g).float().mean()) for name, g in plain.items()
                  if name.rsplit("/", 1)[-1] in MATRIX}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-step", action="store_true", help="only the tolerance part")
    args = ap.parse_args()
    torch.set_num_threads(min(8, torch.get_num_threads()))
    for n in range(1, len(fa_r.BWD_PAIRS) + 1):
        print(json.dumps({"part": "tolerance", "products": n, "worst_over_limit": tolerance(n)}),
              flush=True)
    if not args.skip_step:
        for n, shares in step_shares([3, 4, 5, 6]).items():
            print(json.dumps({"part": "step", "products": n, "min_bit_equal": min(shares.values()),
                              "bit_equal": shares}), flush=True)


if __name__ == "__main__":
    main()
