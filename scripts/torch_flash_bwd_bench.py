#!/usr/bin/env python3
"""Check and time the flash-attention kernels on the card, forward and
backward, for one or more copies of the port (to compare a change with its
parent in one call).

    python3 scripts/torch_flash_bwd_bench.py [SRC_DIR ...] [--reps N] [--only fwd|bwd]
        [--shapes NAME,...]

Each SRC_DIR is a ``src`` directory holding a ``repro_torch`` package
(default: this checkout's ``src``); each runs in its own process, in the
order given (list a parent and a change as A B B A).  Per package: the
build time, the registers and spilled bytes (ptxas) of the tensor-core
kernels and the ``HGMMA`` instructions in each ``flash_wgmma`` instance's
SASS; then one JSON line per shape: the design that ran (where the
package names it), whether the outputs lie within the kernel's limit of its
plain version (forward 2e-5 against ``ref.attention_ref`` /
``attention_lse_ref``; backward ``BWD_TOL`` against
``ref.attention_bwd_ref``; where not, how many entries fail and the median
signed deviation of those, relative to the expected value), whether a
repeat is bit-equal, and the time (``chip_smoke.Timer``: CUDA events behind
a sleep kernel, L2 flushed, median).

Forward shapes: every forward row of ``PERF.md`` §6 that runs a prefill
design (``FWD_SHAPES``): gemma3-4b's serve prefill (q [4, 4096, 8, 256] over
a bf16 cache slice of 4128 positions, window 1024 and 0), its global layer
at 32,768 keys (q [1, 512, 8, 256] at q_offset 32,256; v of mean 0 and 1),
the float32-k/v training forwards with lse (minicpm-2b's [2, 4096, 36, 64],
h2o-danube's hd 120, gemma3-4b's global layer, gemma3-4b's and minicpm-2b's
sequence-split islands), h2o-danube's and kimi-k2's bf16 prefill, the
families' serving prefills and their 16-row decodes (whisper-medium's
encoder, qwen3-moe, recurrentgemma-9b), whisper-medium's float32
cross-attention; then the forwards of ``chip_smoke.FAMILY_TRAIN_SHAPES``
and ``chip_smoke.TP_RANK_SHAPES`` (the serving ranks' prefill over kv head 0
of the bf16 cache, a strided view; the decode ranks run ``flash_decode``
and are left out) and minicpm-2b's ``DRYRUN_ISLANDS`` island.  Each forward
line carries its bound (``chip_smoke.bound`` over ``flash_work``'s bytes and
operations at the bf16 products its operands need, ``attn_products``) and
``scaled_dot_product_attention``'s time (``library_ms``,
``chip_smoke.sdpa_call``) and the plain version's (``plain_ms``); past
``chip_smoke.PLAIN_ROWS`` query rows the plain version checks the first
and the last ``PLAIN_ROWS`` rows, and runs ``PLAIN_ROWS`` rows at a time.
Backward shapes: minicpm-2b's, h2o-danube's, gemma3-4b's local and global
layers (window 1024 and 0), two ragged ones, the gemma3 island,
recurrentgemma-9b's local MQA (16 query heads over one kv head of 256,
window 2048) on bf16 k/v (its training path) and on float32 k/v, the
islands of the dry-run's training ranks (``chip_smoke.TP_RANK_SHAPES``,
whisper-medium's encoder and cross-attention on bf16 k/v, and the
minicpm-2b sequence islands of ``DRYRUN_ISLANDS`` and the spmd phase;
kimi-k2's whole-width layer at hd 112), and whisper-medium's training
attention (``chip_smoke.FAMILY_TRAIN_SHAPES``: the encoder and the
cross-attention over its 1500 frames on bf16 k/v, non-causal, and the
decoder's self-attention) and the spmd phase's float32 cross-attention;
each backward line also carries the device time of each pass
(``torch.profiler`` through ``chip_smoke.trace``, mean of 3 calls, L2
flushed before each), autograd through float32
``scaled_dot_product_attention`` on the same inputs (``library_ms``) and,
where the package has them, its plan's head subsets and k/v parts, and the
call's count in ``bf16_kv_launches`` by design (bf16 k/v taken as they
are).
``--shapes`` keeps the named shapes only (both tables' names).  dk and
dv of bf16 k/v come back as bfloat16: held at the limit plus one rounding
(2^-8 of the value).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the shapes; no torch at import)

FLASH_TOL = 2e-5
BWD_TOL = 1e-4


def _fwd(q, kv, kv_dtype, *, causal=True, window=0, q_offset=0, kv_len=None, v_mean=0.0,
         lse=False, q_bf16=False, cache_heads=None) -> dict:
    return dict(q=q, kv=kv, kv_dtype=kv_dtype, causal=causal, window=window, q_offset=q_offset,
                kv_len=kv_len, v_mean=v_mean, lse=lse, q_bf16=q_bf16, cache_heads=cache_heads)


# name -> a forward call: q [B, Tq, H, hd], k/v [B, Tk, KV, hd]; lse: the
# training forward (kv_len Tk); q_bf16: q holds bf16 values; cache_heads: k/v
# are kv head 0 of a cache of that many kv heads (a strided view)
FWD_SHAPES = {
    "serve_prefill_local": _fwd((4, 4096, 8, 256), (4, 4128, 4, 256), "bfloat16", window=1024,
                                kv_len=4096),
    "serve_prefill_global": _fwd((4, 4096, 8, 256), (4, 4128, 4, 256), "bfloat16", kv_len=4096),
    "global_32k": _fwd((1, 512, 8, 256), (1, 32768, 4, 256), "bfloat16", q_offset=32256,
                       kv_len=32768),
    "global_32k_v_mean_1": _fwd((1, 512, 8, 256), (1, 32768, 4, 256), "bfloat16",
                                q_offset=32256, kv_len=32768, v_mean=1.0),
    "minicpm_train_fwd": _fwd((2, 4096, 36, 64), (2, 4096, 36, 64), "float32", lse=True),
    "h2o_hd120_fwd": _fwd((1, 4096, 32, 120), (1, 4096, 8, 120), "float32", window=4096,
                          lse=True),
    "h2o_hd120_bf16": _fwd((1, 4096, 32, 120), (1, 4096, 8, 120), "bfloat16", window=4096,
                           kv_len=4096),
    "gemma3_global_f32_fwd": _fwd((1, 4096, 8, 256), (1, 4096, 4, 256), "float32", lse=True),
    "gemma3_island_fwd": _fwd((1, 256, 8, 256), (1, 4096, 4, 256), "float32", q_offset=3840,
                              lse=True),
    "minicpm_island_fwd": _fwd((2, 512, 36, 64), (2, 4096, 36, 64), "float32", q_offset=3584,
                               lse=True),
    "whisper_cross_f32_fwd": _fwd((4, 128, 16, 64), (4, 1500, 16, 64), "float32", causal=False,
                                  lse=True),
    "kimi_hd112_bf16": _fwd((1, 4096, 64, 112), (1, 4096, 8, 112), "bfloat16", kv_len=4096),
    "kimi_hd112_f32_fwd": _fwd((1, 4096, 64, 112), (1, 4096, 8, 112), "float32", lse=True),
    "whisper_encoder": _fwd((4, 1500, 16, 64), (4, 1500, 16, 64), "bfloat16", causal=False),
    "qwen3_moe_prefill": _fwd((4, 2048, 64, 128), (4, 2080, 4, 128), "bfloat16", kv_len=2048),
    "griffin_local": _fwd((4, 4096, 16, 256), (4, 4096, 1, 256), "bfloat16", window=2048,
                          kv_len=4096),
    "qwen3_moe_decode": _fwd((4, 1, 64, 128), (4, 2080, 4, 128), "bfloat16", q_offset=2048,
                             kv_len=2049),
    "griffin_decode": _fwd((4, 1, 16, 256), (4, 4128, 1, 256), "bfloat16", window=2048,
                           q_offset=4096, kv_len=4097),
    **{f"{row[0]}_fwd": _fwd(row[1], row[2], row[3], lse=True, q_bf16=row[6], **row[4])
       for row in chip_smoke.FAMILY_TRAIN_SHAPES},
    **{f"{row[0]}_fwd": (_fwd(row[1], row[2], row[3], lse=True, q_bf16=row[6], **row[4])
                         if "kv_len" not in row[4] else
                         _fwd(row[1], row[2], row[3], cache_heads=row[7], **row[4]))
       for row in chip_smoke.TP_RANK_SHAPES if row[1][1] > 1},
    # minicpm-2b's dry-run island (DRYRUN_ISLANDS): rank (0, 0) of tp 16
    "minicpm_rank_island_fwd": _fwd((4, 256, 36, 64), (4, 4096, 36, 64), "float32", lse=True),
}
BF16_ROUND = 2.0**-8
# name -> (b, tq, tk, h, kvh, hd, window, q_offset, kv dtype, causal):
# minicpm-2b's train shape, h2o-danube's, gemma3-4b's local and global
# layers, ragged ones, the gemma3 island, recurrentgemma-9b's local MQA (bf16
# k/v, and float32); the dry-run's training-rank islands (kimi-k2's and
# qwen3-moe's GQA-4 head plans, h2o-danube's, internvl2-2b's,
# starcoder2-3b's sequence islands at model rank 0 and 15, whisper-medium's
# decoder, encoder and cross-attention), the minicpm-2b sequence islands
# (the spmd phase's at q_offset 3584, the dry-run rank's at 0), kimi-k2's
# whole layer; whisper-medium's training attention (families_train) and the
# spmd phase's cross-attention
BWD_SHAPES = {
    "minicpm_train": (2, 4096, 4096, 36, 36, 64, 0, 0, "float32", True),
    "h2o_hd120": (1, 4096, 4096, 32, 8, 120, 4096, 0, "float32", True),
    "gemma3_local": (1, 4096, 4096, 8, 4, 256, 1024, 0, "float32", True),
    "gemma3_global": (1, 4096, 4096, 8, 4, 256, 0, 0, "float32", True),
    "ragged_4097": (1, 4097, 4097, 8, 2, 64, 300, 0, "float32", True),
    "ragged_333": (2, 333, 333, 8, 4, 32, 50, 0, "float32", True),
    "gemma3_island": (1, 256, 4096, 8, 4, 256, 0, 3840, "float32", True),
    "griffin_bf16": (1, 4096, 4096, 16, 1, 256, 2048, 0, "bfloat16", True),
    "griffin_f32": (1, 4096, 4096, 16, 1, 256, 2048, 0, "float32", True),
    "kimi_rank_train": (2, 4096, 4096, 4, 1, 112, 0, 0, "float32", True),
    "qwen3_rank_train": (2, 4096, 4096, 4, 1, 128, 0, 0, "float32", True),
    "h2o_rank_train": (4, 4096, 4096, 2, 1, 120, 4096, 0, "float32", True),
    "internvl2_rank_train": (4, 4096, 4096, 1, 1, 128, 0, 0, "float32", True),
    "starcoder2_rank_seq0": (4, 256, 4096, 24, 2, 128, 0, 0, "float32", True),
    "starcoder2_rank_seq3840": (4, 256, 4096, 24, 2, 128, 0, 3840, "float32", True),
    "whisper_rank_self": (4, 4096, 4096, 1, 1, 64, 0, 0, "float32", True),
    "whisper_rank_encoder": (4, 1500, 1500, 1, 1, 64, 0, 0, "bfloat16", False),
    "whisper_rank_cross": (4, 4096, 1500, 1, 1, 64, 0, 0, "bfloat16", False),
    "minicpm_island": (2, 512, 4096, 36, 36, 64, 0, 3584, "float32", True),
    "minicpm_rank_island": (4, 256, 4096, 36, 36, 64, 0, 0, "float32", True),
    "kimi_hd112": (1, 4096, 4096, 64, 8, 112, 0, 0, "float32", True),
    "whisper_encoder_train": (4, 1500, 1500, 16, 16, 64, 0, 0, "bfloat16", False),
    "whisper_cross_train": (4, 448, 1500, 16, 16, 64, 0, 0, "bfloat16", False),
    "whisper_self_train": (4, 448, 448, 16, 16, 64, 0, 0, "float32", True),
    "whisper_cross_f32": (4, 128, 1500, 16, 16, 64, 0, 0, "float32", False),
}


def limits(got, exp, tol: float, names) -> dict:
    out = {"max_abs_err": max(float((a.float() - e).abs().max()) for a, e in zip(got, exp))}
    for name, a, e in zip(names, got, exp):
        rounded = BF16_ROUND if a.dtype == torch.bfloat16 else 0.0
        bad = (a.float() - e).abs() > tol + (tol + rounded) * e.abs()
        if bool(bad.any()):
            out[f"{name}_over_limit"] = int(bad.sum())
            out[f"{name}_median_rel_dev"] = float(((a.float() - e) / e)[bad].median())
    out["within_tol"] = not any(key.endswith("_over_limit") for key in out)
    return out


def run_one(src: str, reps: int, only: str | None, names: set[str] | None) -> None:
    sys.path.insert(0, src)
    from chip_smoke import BWD_PASSES, Timer, trace
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa_k, ref as fa_r

    t0 = time.perf_counter()
    _build.library()
    ptx = {name.split("_cu_")[-1]: [r["registers"], r["spill_store_bytes"]]
           for pat in ("flash_wgmma", "fwd_prep", "flash_tiled", "bwd_wgmma", "bwd_wide", "bwd_dq",
                       "bwd_kv")
           for name, r in _build.ptxas_report(pat).items()}
    hgmma = chip_smoke.sass_count(_build.build(), "flash_wgmma", "HGMMA")
    print(json.dumps({"src": src, "build_s": time.perf_counter() - t0, "ptxas": ptx,
                      "flash_wgmma_hgmma": hgmma}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    timer = Timer(torch, reps=reps)
    # a parent may predate the design names
    fwd_design = getattr(fa_k, "fwd_design", None)
    bwd_design = getattr(fa_k, "bwd_design", None)
    for name, f in (FWD_SHAPES.items() if only != "bwd" else ()):
        if names is not None and name not in names:
            continue
        b, tq, h, hd = f["q"]
        tk, kvh = f["kv"][1], f["kv"][2]
        kvt = getattr(torch, f["kv_dtype"])
        q = torch.randn(f["q"], generator=gen, device=dev)
        if f["q_bf16"]:
            q = q.to(torch.bfloat16).float()
        heads = f["cache_heads"] or kvh
        k, v = ((torch.randn(b, tk, heads, hd, generator=gen, device=dev) + mean).to(kvt)
                for mean in (0.0, f["v_mean"]))
        if f["cache_heads"]:  # kv head 0 of the cache, in place
            k, v = k[:, :, :1], v[:, :, :1]
        mask = dict(causal=f["causal"], window=f["window"], q_offset=f["q_offset"])
        out = {"src": src, "shape": name, "q": list(f["q"]), "kv": list(f["kv"]),
               "kv_dtype": f["kv_dtype"], **mask, "kv_len": f["kv_len"],
               "design": (fwd_design(hd, kvt, tq * h // kvh, lse=f["lse"]) if fwd_design
                          else None)}
        if f["lse"]:
            call = lambda: fa_k.flash_attention_lse(q, k, v, **mask)  # noqa: E731
            got, exp = call(), fa_r.attention_lse_ref(q, k, v, **mask)
            out.update(limits(got, exp, FLASH_TOL, ("o", "lse")))
        else:
            kw = dict(mask, kv_len=f["kv_len"])
            call = lambda: (fa_k.flash_attention(q, k, v, **kw),)  # noqa: E731
            got = call()
            # past PLAIN_ROWS rows the plain version's scores would not fit:
            # the first and the last PLAIN_ROWS rows, each at its q_offset
            rows = chip_smoke.PLAIN_ROWS
            blocks = [(0, tq)] if tq <= rows else [(0, rows), (tq - rows, tq)]
            part = [(got[0][:, i:j], fa_r.attention_ref(
                q[:, i:j], k, v, **dict(kw, q_offset=kw["q_offset"] + i))) for i, j in blocks]
            out.update(limits([g for g, _ in part], [e for _, e in part], FLASH_TOL,
                              ("o",) * len(part)))
            out["mean_signed_rel_err"] = (sum(float(((g - e) * e.sign()).sum()) for g, e in part)
                                          / sum(float(e.abs().sum()) for _, e in part))
            exp = None
        out["repeat_bit_equal"] = all(torch.equal(x, y) for x, y in zip(got, call()))
        del exp, got
        out["ms"] = timer.ms(call)
        full = dict(mask, kv_len=tk if f["kv_len"] is None else f["kv_len"])
        nbytes, ops = chip_smoke.flash_work(torch, q, k, **full)
        nbytes += 4 * b * h * tq if f["lse"] else 0
        split, _ = chip_smoke.attn_products(f["q_bf16"], kvt == torch.bfloat16)
        out["bound_ms"], out["bound_by"] = chip_smoke.bound(nbytes, ops, "bf16_tensor", split)
        out["share_of_bound"] = out["bound_ms"] / out["ms"]
        out["library_ms"] = timer.ms(chip_smoke.sdpa_call(
            torch, q, k, v, **full, expand=f["cache_heads"] is not None))
        # the plain version over the whole call, PLAIN_ROWS rows at a time
        if f["lse"]:
            out["plain_ms"] = timer.ms(lambda: fa_r.attention_lse_ref(q, k, v, **mask))
        else:
            out["plain_ms"] = timer.ms(lambda: [
                fa_r.attention_ref(q[:, i:i + rows], k, v, **dict(kw, q_offset=kw["q_offset"] + i))
                for i in range(0, tq, rows)])
        print(json.dumps(out), flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, (b, t, tk, h, kvh, hd, window, q_offset, kv_dtype, causal) in (
            BWD_SHAPES.items() if only != "fwd" else ()):
        if names is not None and name not in names:
            continue
        q, do = (torch.randn(b, t, h, hd, generator=gen, device=dev) for _ in range(2))
        k, v = (torch.randn(b, tk, kvh, hd, generator=gen, device=dev).to(getattr(torch, kv_dtype))
                for _ in range(2))
        kw = dict(causal=causal, window=window, softcap=0.0, q_offset=q_offset)
        o, lse = fa_k.flash_attention_lse(q, k, v, **kw)
        bf16_before = dict(fa_k.bf16_kv_launches)
        got = fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        bf16_kv = {d: n - bf16_before.get(d, 0) for d, n in fa_k.bf16_kv_launches.items()
                   if n != bf16_before.get(d, 0)}
        exp = fa_r.attention_bwd_ref(q, k, v, o, lse, do, **kw)
        out = {"src": src, "name": name, "shape": [b, t, tk, h, kvh, hd, window, q_offset],
               "kv_dtype": kv_dtype, "causal": causal,
               "design": bwd_design(hd) if bwd_design else None, "bf16_kv_launches": bf16_kv,
               **limits(got, exp, BWD_TOL, ("dq", "dk", "dv"))}
        if "kv_bf16" in inspect.signature(fa_k.bwd_plan).parameters:  # a parent may predate it
            plan = fa_k.bwd_plan(hd, b, t, tk, h, kvh, causal=causal, window=window,
                                 q_offset=q_offset, sms=sms, kv_bf16=kv_dtype == "bfloat16")
            out.update(head_splits=plan.head_splits, kv_parts=plan.kv_parts)
        again = fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        out["repeat_bit_equal"] = all(torch.equal(x, y) for x, y in zip(got, again))
        del exp, again
        out["ms"] = timer.ms(lambda: fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw))

        def three():
            for _ in range(3):
                timer.scratch.zero_()
                fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)

        passes = trace(torch, three, groups={**BWD_PASSES, "flush": ("",)})["by_group_ms"]
        out["passes_ms"] = {g: ms / 3 for g, (ms, _) in passes.items() if g != "flush"}
        # the yardstick: autograd through float32 SDPA on the same inputs
        mask = fa_r.key_mask(t, tk, causal=causal, window=window, q_offset=q_offset, kv_len=None,
                             device=dev)
        leaves = [x.float().transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
        sdpa = torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                                                enable_gqa=True)
        out["library_ms"] = timer.ms(lambda: torch.autograd.grad(sdpa, leaves, do.transpose(1, 2),
                                                                 retain_graph=True))
        print(json.dumps(out), flush=True)
        del q, k, v, do, o, lse, got, mask, leaves, sdpa
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("srcs", nargs="*", default=[str(ROOT / "src")])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--only", choices=("fwd", "bwd"), default=None)
    ap.add_argument("--shapes", default=None, help="comma-separated shape names (default: all)")
    ap.add_argument("--one", help=argparse.SUPPRESS)  # the child process's package
    args = ap.parse_args()
    if args.one:
        run_one(args.one, args.reps, args.only,
                set(args.shapes.split(",")) if args.shapes else None)
        return 0
    rc = 0
    for src in args.srcs:
        cmd = [sys.executable, __file__, "--one", src, "--reps", str(args.reps)]
        cmd += ["--only", args.only] if args.only else []
        rc |= subprocess.run(cmd + (["--shapes", args.shapes] if args.shapes else [])).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
