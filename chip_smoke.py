#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each:

1. device  — the card's name and power limit (``nvidia-smi``), and the time
   to build the hand-written kernels from ``src/repro_torch/kernels/csrc``.
   Then a ``ptxas`` line (registers, static shared memory, spills of the
   redesigned kernels, from the build's ptxas report); the run fails
   unless the SASS (``cuobjdump -sass``) of every tensor-core kernel holds
   ``HGMMA`` (warpgroup tensor-core) instructions: the forward's
   ``flash_wgmma`` for bf16 and for float32 k/v (``flash_wgmma_split``),
   the backward's ``bwd_wgmma`` and ``bwd_wide``.
2. kernels — each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it (hash_partition at the join's and the
   groupby's shuffle, segment_reduce at groupby_agg's three calls), with its
   time (CUDA events behind a sleep kernel, so that they time the device
   and not the host's launches; median of repeats, L2 flushed before each
   repeat; the hash kernel, well under 0.1 ms, timed as 8-16 launches back
   to back per event pair), the plain version's time, one PyTorch library call's time
   where one computes the same function, and the bound: the larger of bytes
   moved over 3.35 TB/s and operations over the peak of the engine that
   does them (H100 SXM data sheet): 67 TFLOP/s for float32 on the CUDA
   cores, or 989 TFLOP/s for bf16 on the tensor cores times the number of
   bf16 products a design makes of each float32 product (``FLASH_SPLIT``: 3
   where only one operand is split, 6 where both are).  The summary line carries one shape per kernel; the ``kernel``
   lines carry every shape.  join_probe's positions and hits must equal the
   plain version's on every row.
3. join    — ``ops_dist.sim_join`` at the paper's weak-scaling size: P = 8
   simulated workers on the one card, 9.1M rows per worker per side
   (``benchmarks/scaling_join.py`` WEAK_ROWS), checked row by row against
   numpy.
3b. comm   — the serverless communicator on the card.  (a) Phase 3's
   tables joined again over four fabrics: all-direct Lambda (phase 3's),
   a hybrid session with 7 of the 28 pairs blocked behind a Redis relay
   (a quarter, drawn from ``--seed`` by the rule of
   ``benchmarks/hybrid_links.py``), ``redis_communicator(8)`` and
   ``s3_communicator(8)``.  Each run must give phase 3's rows bit for bit,
   launch hash_partition 16 and join_probe 8 times, and receive every
   block on the card; its line gives the modeled comm seconds, bytes on
   the wire, each event's schedule (algo, relay, relayed pairs), the
   bootstrap events and the host wall.  (b) Every collective of the
   communicator on CUDA float32 tensors of 16M elements (64 MB) per rank
   over 8 ranks (allreduce and reduce_scatter with add and max,
   allgather(v), bcast, gather, scatter, send, alltoallv, the
   non-blocking handles, ping, and a 2-colour split): results on the card,
   bit-equal to numpy on host copies folded in rank order, each rank its
   own buffer, and every event's modeled seconds equal to the same call's
   on CPU tensors of the same shapes.  (c) A world-64 session on the
   Lambda fabric (the paper's 64-node point): bootstrap, ``expand`` by 16
   Cloud Run workers, detect + ``shrink`` of 8 ranks under each recovery
   policy, ``recover_link`` (transient and permanent), ``rebootstrap_rank``,
   each modeled price printed.
4. groupby — ``ops_dist.sim_groupby`` at the paper's §IV-C size: P = 4
   workers x 50M rows over 1000 groups, ``{"v": "sum"}``, combiner on and
   off, checked against ``np.bincount``.
5. kernel  — flash_attention against its plain version at the serving
   path's shapes (gemma3-4b: prefill of a local and of a global layer,
   decode of a global and of a local layer), with the same timings and
   bound (operations: 4 hd per visible (query, key) pair; bytes: q, o and
   the k/v rows some query can see; the prefill rows give both the bound
   of the tensor-core design that runs them and the float32 CUDA-core
   bound, each with its share), and
   ``scaled_dot_product_attention``'s time as the library yardstick; plus
   rows with no valid key and a softcap at a small shape; and gemma3-4b's
   global layer at 32,768 keys (q [1, 512, 8, 256] at q_offset 32,256,
   bf16 k/v [1, 32768, 4, 256]; timed, and checked again with v of mean 1,
   where |O| ~ 1).  Both sides read the same k/v, so they differ only in
   the order of float32 sums: 2e-5 for either k/v type; at each main-path
   shape the kernel must also fail that limit given one key too few.
   The same phase checks the float32-k/v forwards with each row's
   log-sum-exp, o and lse within 2e-5, failing it given one key too few,
   and bit-equal across two runs: ``flash_wgmma_split`` (the training
   path's forward) at minicpm-2b's train shape and h2o-danube-3-4b's head
   width 120 (q [1, 4096, 32, 120], k/v [1, 4096, 8, 120], window 4096;
   there also the bf16 prefill and decode designs), and ``flash_tiled`` at
   gemma3-4b's global layer (q [1, 4096, 8, 256], k/v 4 heads), each timed
   with its own bound and its float32 CUDA-core bound.
6. kernel  — flash_attention_bwd (the hand-written backward) against its
   plain version (``ref.attention_bwd_ref``) from the same o and lse, at
   minicpm-2b's train shape (q/k/v [2, 4096, 36, 64], causal), gemma3-4b's
   (q [1, 4096, 8, 256], k/v 4 heads, window 1024 and 0) and h2o-danube's
   (hd 120, window 4096), plus small cases with a softcap, GQA and ragged
   tiles at every head width; within ``BWD_TOL``, and failing it given one
   key too few.  Each shape names the design that ran (``bwd_wgmma`` for
   hd <= 128, ``bwd_wide`` for hd 256, both on the bf16 tensor cores) and
   gives both bounds with their shares: the tensor-core one (10 hd
   operations per visible pair, ``BWD_SPLIT`` bf16 products each, at 989
   TFLOP/s; ``bound_ms``) and the float32 CUDA-core one (10 hd at 67
   TFLOP/s), each against the bytes.  Its time, the plain version's time
   and autograd through float32 ``scaled_dot_product_attention`` as the
   library yardstick.
7. serve   — ``serve_step.generate`` on gemma3-4b at full width (random
   weights from ``--seed``, made on the card): B = 4 requests of 4096
   prompt tokens, 32 new tokens each, greedy.  The one run that is counted
   is also the one that is timed: each step's tokens are brought to the
   host as a server streams them, which gives the time to first token, the
   gaps between tokens (median, max) and decode tokens/s; plus its wall
   and peak device memory.  Fixed lengths: a smoke measurement, not a
   traffic mix.
8. serve_check — (a) a teacher-forced ``forward`` of request 0's prompt +
   generated tokens (no cache) against the prefill and every decode step's
   logits, and each greedy token against its step's argmax; (b) a reduced
   gemma3-4b (6 layers, one global) on the card against the plain versions
   on the CPU from the same weights.  Its weights are freed before training.
9. train   — ``launch.train.train`` on minicpm-2b at full width and depth
   (2,724,880,896 parameters, random from ``--seed``): B 2 x 4096 tokens
   from its own pipeline (``data_iter``), 6 steps with its own
   ``OptConfig`` (WSD, float32 moments) at lr 3e-4 (``TRAIN_LR``).  Each
   step's host wall ends when its loss is on the host; the median of steps
   2-6, tokens/s, the model
   FLOPs of a step as a share of the float32 CUDA-core peak (the products
   stay float32 SGEMM, as in the reference; TF32 stays refused), the loss
   per step and peak device memory.  A smoke measurement (synthetic
   corpus), not a traffic result.  It fails unless flash attention's
   forward ran exactly 6 x 40 x 2 times (each layer's forward and its
   recompute), all in ``flash_wgmma_split``, and its backward 6 x 40
   times, all in ``bwd_wgmma``.  The run carries a modeled 64-worker
   Lambda session and a span ``Tracer``: 16 Cloud Run workers join at
   step 3, the top 8 ranks are evicted at step 5; the line gives the
   burst and shrink log lines, the spans per lane, ``critical_path()``
   and the size of the written trace JSON.
10. train_check — (a) one step (``make_train_step``'s gradients, then
   ``apply_updates``) on the card against the same step on the CPU (plain
   versions), at minicpm-2b's width with 2 layers and 2 x 256 tokens, from
   the same weights and batch: loss, every gradient, the updated weights
   and moments within the stated limits; (b) the same update with int8
   moments; (c) the kill/resume drill on the card (reduced minicpm-2b, a
   ``LocalStore`` checkpoint), each call with its own modeled 8-worker
   Lambda session: 2 steps, exit, resume to 4 must give the loss trace of
   4 uninterrupted steps, bit for bit, and the resumed call must log its
   re-bootstrap through the session.

After each of the join, groupby, serve and train runs, a ``trace`` line:
one more run (or step) of the same cell under ``torch.profiler``, with the
device's busy time, its idle share of the wall and the device ops that took
longest.

The launch counters of every kernel are set to 0 just before each of the
main-path runs (join, each of the comm phase's four joins, groupby, serve,
train) and read just after; a kernel
of the path that did not launch, a serve run without exactly 34 + 31 x 34
flash-attention launches, or a train run without the counts above, fails
the run.  Then a ``launches`` line (each counter by run: the kernels, and
flash attention's calls by design), the kernels' summary line (one row per
kernel, and for flash attention one per design the main path runs), and as
the last line ``{"ok": true, "device": {...}}``.  Any mismatch or exception
exits non-zero before that line.  Without a CUDA device, or without the
repository's ``src/`` beside this file, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
OPS_PER_S = {
    "fp32": 67e12,         # H100 SXM float32 outside the tensor cores
    "bf16_tensor": 989e12, # H100 SXM bf16 on the tensor cores, dense
}
# bf16 products per float32 product on the tensor cores: flash_wgmma splits
# q and p (bf16 k/v are exact), flash_wgmma_split and the backward split both
# operands of every product
FLASH_SPLIT = {"flash_wgmma": 3, "flash_wgmma_split": 6}

JOIN_P, JOIN_ROWS = 8, int(9.1e6)            # benchmarks/scaling_join.py:50
GROUPBY_P, GROUPBY_ROWS, GROUPS = 4, int(50e6), 1000  # benchmarks/groupby_scaling.py:16-17
SERVE_ARCH, SERVE_B, SERVE_PROMPT, SERVE_NEW = "gemma3-4b", 4, 4096, 32
TRAIN_ARCH, TRAIN_B, TRAIN_SEQ, TRAIN_STEPS = "minicpm-2b", 2, 4096, 6
# OptConfig's own default learning rate.  ``train``'s default (3e-3) is
# sized for its reduced config: at full width it diverges once the warmup
# reaches it (losses 12.37 -> 12.12 -> 13.90 over 6 steps on the H100).
TRAIN_LR = 3e-4
# phase 9's modeled fabric: the paper's 64-node Lambda point, 16 Cloud Run
# workers admitted at step 3, the top 8 ranks evicted at step 5
TRAIN_COMM_WORLD = 64
TRAIN_BURST_SHRINK = dict(burst_at=3, burst_world=16, burst_provider="gcp-cloudrun",
                          shrink_at=5, shrink_world=8)
# phase 3b: a quarter of the 28 pairs of the P = 8 join blocked behind a
# relay (benchmarks/hybrid_links.py FRACTIONS); the collectives at 16M float32
# elements (64 MB) per rank over 8 ranks; the lifecycle at the paper's
# 64-node point
COMM_BLOCKED_SHARE = 1.0 / 4.0
COMM_WORLD, COMM_ELEMS = 8, 16 << 20
LIFECYCLE_WORLD = 64
SIZE_CUTS: list[str] = []  # none: every path runs at its full size and depth

# flash attention against its plain version: both read the same k/v (bfloat16
# converts to float32 exactly) and compute in float32, so they differ only in
# the order of float32 sums: 2e-5, absolute plus relative, for either k/v
# type.  A key too many or too few at a mask edge moves an output by ~1e-3.
# The serving path's logits: 2e-2 between the
# cached path (k/v rounded to bfloat16) and a cache-free forward, as the
# reference's own decode test holds them (tests/test_models.py:73); card
# against CPU 1e-4 where nothing is rounded to bfloat16 (float32 sums in
# another order), and 2e-2 through the bfloat16 cache, where float32 k/v
# a few ulps apart (cuBLAS against the CPU's matmul) can round to
# neighbouring bfloat16 values.
FLASH_TOL = 2e-5
SERVE_LOGIT_TOL = 2e-2
REDUCED_F32_TOL = 1e-4
# the backward kernel against its plain version from the same o and lse:
# both float32, sums in another order, dk and dv sum up to T x groups terms:
# 1e-4 absolute plus relative.  One key too few moves some gradient by
# ~1e-3 or more.
BWD_TOL = 1e-4
# train_check, card against CPU (cuBLAS against the CPU's float32 products):
# loss 1e-5 relative; gradients of float32 leaves 1e-4 of the leaf's largest
# plus relative; bf16-rounded gradients (every matrix weight: the in-graph
# cast's transpose rounds them) each within one bf16 ulp (2^-7 relative; a
# tied embedding, the sum of two rounded terms, within one ulp of the leaf's
# largest) and >= 99% bit-equal; updated weights within 2 lr (a flipped
# update sign where |g| is tiny) and >= 99.9% within 2 bf16 ulps of lr.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_F32_GRAD_TOL = 1e-4
BF16_ULP = 2.0**-7

INT32_MAX = 2**31 - 1
# float32 segment sum over rows in [0, 1): a sum whose longest chain of
# float additions has m links errs by at most m * 2**-24 of the total.  The
# plain version (index_add_ atomics) chains up to 50k rows per segment
# (<= 3e-3); the kernel chains 185 warp steps of a 5-level shuffle tree and
# ~10 atomic flushes per segment (<= 1.2e-5).
SEGSUM_F32_RTOL_VS_PLAIN = 4e-3
SEGSUM_F32_RTOL_VS_EXACT = 2e-5


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of one call, L2 flushed before each repeat.

    ``ms(fn)`` times one launch per event pair.  ``ms(f0, f1, ...)`` launches
    all of them back to back inside one event pair and divides by their
    number: for kernels of well under 0.1 ms, whose single-launch times
    spread by tens of percent.  The callables then work on distinct copies
    of the inputs, so each launch still reads its inputs from HBM.  A sleep
    kernel queued ahead of the start event (~10 ms) keeps the device busy
    while the host enqueues the timed calls, so the pair measures the
    device's time and not the host's rate of launching."""

    SLEEP_CYCLES = 20_000_000

    def __init__(self, torch, reps: int = 10):
        self.torch = torch
        self.reps = reps
        self.scratch = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, *fns) -> float:
        torch = self.torch
        for fn in fns:
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(self.reps):
            self.scratch.zero_()  # 128 MB > the 50 MB L2
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(self.SLEEP_CYCLES)
            start.record()
            for fn in fns:
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / len(fns))
        return statistics.median(times)


def bound(nbytes: int, ops: int, engine: str = "fp32", split: int = 1) -> tuple[float, str]:
    """Least time (ms) for moving ``nbytes`` and doing ``ops`` operations on
    ``engine``, which makes ``split`` products of its type per operation."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = split * ops / OPS_PER_S[engine] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def find_cuobjdump() -> str:
    """The toolkit's cuobjdump, or the copy Triton's package carries."""
    import os
    import shutil

    cands = [shutil.which("cuobjdump"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")]
    try:
        import triton

        cands.append(str(Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump"))
    except ImportError:
        pass
    for c in cands:
        if c and os.path.isfile(c):
            return c
    fail("cuobjdump not found: the prefill kernel's SASS cannot be checked")


def sass_has(lib: Path, kernel: str, opcode: str) -> dict[str, bool]:
    """For each function of ``lib`` whose mangled name holds ``kernel``,
    whether its SASS holds ``opcode``."""
    out = subprocess.run([find_cuobjdump(), "-sass", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    found: dict[str, bool] = {}
    for section in out.split("Function : ")[1:]:
        name = section.split(None, 1)[0]
        if kernel in name:
            found[name] = opcode in section
    return found


def rotating(fn, copies: list, launches: int) -> list:
    """``launches`` calls of ``fn``, cycling over the input ``copies``."""
    return [lambda c=copies[i % len(copies)]: fn(c) for i in range(launches)]


def trace(torch, fn, top: int = 8, groups: dict[str, tuple[str, ...]] | None = None) -> dict:
    """One more run of ``fn`` under ``torch.profiler``: its host wall, the
    device's busy time (the union of kernel, memcpy and memset intervals),
    the idle share of the wall, and the device ops that took longest.  With
    ``groups`` (label -> name substrings, first match wins, "" matches
    all), also the device ms and op count of each group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end  # microseconds
        spans.append((start, end))
        agg = by_name.setdefault(ev.name[:100], [0.0, 0])
        agg[0] += (end - start) / 1e3
        agg[1] += 1
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    out = {"wall_s": wall, "device_ops": len(spans), "device_busy_s": busy_us / 1e6,
           "idle_share": 1.0 - busy_us / 1e6 / wall,
           "top_ms": [[name, ms, n] for name, (ms, n) in ranked]}
    if groups:
        sums = {g: [0.0, 0] for g in groups}
        for name, (ms, n) in by_name.items():
            g = next(g for g, keys in groups.items() if any(k in name for k in keys))
            sums[g][0] += ms
            sums[g][1] += n
        out["by_group_ms"] = sums
    return out


def counters(hp_k, jp_k, sr_k, fa_k) -> dict[str, int]:
    return {
        # the row-bucket entry (every shuffle) and the single-column one
        # (hash32: the pipeline's content hash)
        "hash_partition": hp_k.launches + hp_k.single_launches,
        "join_probe": jp_k.launches,
        "segment_reduce": sr_k.launches,
        "flash_attention": fa_k.launches,
        "flash_attention_bwd": fa_k.bwd_launches,
        # the calls of each flash design (each also counted above)
        **{f"flash_attention/{d}": n for d, n in fa_k.fwd_design_launches.items()},
        **{f"flash_attention_bwd/{d}": n for d, n in fa_k.bwd_design_launches.items()},
    }


def reset_counters(hp_k, jp_k, sr_k, fa_k) -> None:
    hp_k.launches = hp_k.single_launches = 0
    jp_k.launches = 0
    sr_k.launches = 0
    fa_k.launches = 0
    fa_k.bwd_launches = 0
    for designs in (fa_k.fwd_design_launches, fa_k.bwd_design_launches):
        for design in designs:
            designs[design] = 0


def flash_work(torch, q, k, *, causal, window, q_offset, kv_len) -> tuple[int, int]:
    """(bytes, operations) one flash-attention call must move and do: q read
    and o written once (float32), k and v read once over the keys some
    query can see, 4 hd operations per visible (query, key) pair; a row that
    sees no key averages all Tk.  Counted from the plain version's mask."""
    from repro_torch.kernels.flash_attention import ref as fa_r

    b, tq, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    mask = fa_r.key_mask(tq, tk, causal=causal, window=window, q_offset=q_offset,
                         kv_len=kv_len, device=q.device)
    per_row = mask.sum(1)
    pairs = int(torch.where(per_row > 0, per_row, tk).sum()) * b * h
    keys = tk if bool((per_row == 0).any()) else int(mask.any(0).sum())
    nbytes = 2 * q.numel() * 4 + 2 * b * kvh * hd * keys * k.element_size()
    return nbytes, 4 * hd * pairs


def sdpa_call(torch, q, k, v, *, causal, window, q_offset, kv_len):
    """One ``scaled_dot_product_attention`` call computing the same function
    (the library yardstick; the port never calls it): k/v upcast to float32
    and the mask made outside the timed call."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ref as fa_r

    mask = fa_r.key_mask(q.shape[1], k.shape[1], causal=causal, window=window,
                         q_offset=q_offset, kv_len=kv_len, device=q.device)
    qt, kt, vt = q.transpose(1, 2), k.float().transpose(1, 2), v.float().transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)


def flash_bwd_phase(torch, gen, timer, configs, fa_k, fa_r) -> dict:
    """The backward kernel against its plain version at the training path's
    shapes (module doc, phase 6); its summary row with every shape."""
    import torch.nn.functional as F

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def within(got, exp) -> bool:
        return all(bool(((a - e).abs() <= BWD_TOL + BWD_TOL * e.abs()).all())
                   for a, e in zip(got, exp))

    def errs(got, exp) -> float:
        return max(float((a - e).abs().max()) for a, e in zip(got, exp))

    mc, gc, hc = (configs.get(a) for a in (TRAIN_ARCH, "gemma3-4b", "h2o-danube-3-4b"))
    shapes = {}
    for cell, b, cfg, window in (
        ("minicpm_train", TRAIN_B, mc, 0),
        ("gemma3_local", 1, gc, gc.sliding_window),
        ("gemma3_global", 1, gc, 0),
        ("h2o_hd120", 1, hc, hc.sliding_window),
    ):
        h, kvh, hd, t = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, TRAIN_SEQ
        q, do = randn(b, t, h, hd), randn(b, t, h, hd)
        k, v = randn(b, t, kvh, hd), randn(b, t, kvh, hd)
        kw = dict(causal=True, window=window, softcap=cfg.attn_softcap)
        o, lse = fa_k.flash_attention_lse(q, k, v, **kw)
        got = fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        exp = fa_r.attention_bwd_ref(q, k, v, o, lse, do, **kw)
        if not within(got, exp):
            fail(f"flash_attention_bwd differs from the plain version ({cell}): "
                 f"max |err| {errs(got, exp)}")
        err = errs(got, exp)
        del exp
        # one key too few: the oldest in the window (or key 0 for the last row)
        near = dict(kw, window=(window or t) - 1)
        o_n, lse_n = fa_r.attention_lse_ref(q, k, v, **near)
        exp_n = fa_r.attention_bwd_ref(q, k, v, o_n, lse_n, do, **near)
        if within(got, exp_n):
            fail(f"flash_attention_bwd limit {BWD_TOL} does not tell one key too few ({cell})")
        one_key_off = errs(got, exp_n)
        del got, o_n, lse_n, exp_n
        torch.cuda.empty_cache()
        mask = fa_r.key_mask(t, t, causal=True, window=window, q_offset=0, kv_len=t, device=dev)
        pairs = int(mask.sum()) * b * h
        # q, o, do, dq and k, v, dk, dv once each, lse once
        nbytes = 4 * (4 * q.numel() + 4 * k.numel() + lse.numel())
        design = fa_k.bwd_design(hd)
        tms, tby = bound(nbytes, 10 * hd * pairs, "bf16_tensor", fa_k.BWD_SPLIT)
        fms, fby = bound(nbytes, 10 * hd * pairs)
        bms, bby = tms, tby  # both designs run on the tensor cores
        ms = timer.ms(lambda: fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw))
        plain_ms = timer.ms(lambda: fa_r.attention_bwd_ref(q, k, v, o, lse, do, **kw))
        # the library yardstick: autograd through float32 SDPA (its backward)
        leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, enable_gqa=True)
        dout = do.transpose(1, 2)
        library_ms = timer.ms(lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True))
        shapes[cell] = {
            "q": list(q.shape), "kv": list(k.shape), **kw, "design": design, "max_abs_err": err,
            "one_key_off_max_abs_err": one_key_off, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": bby, "share_of_bound": bms / ms,
            "bound_tensor_ms": tms, "bound_tensor_by": tby, "share_of_tensor_bound": tms / ms,
            "bound_fp32_ms": fms, "bound_fp32_by": fby, "share_of_fp32_bound": fms / ms,
            "bytes": nbytes, "operations": 10 * hd * pairs, "split": fa_k.BWD_SPLIT,
            "library_ms": library_ms,
        }
        del q, do, k, v, o, lse, leaves, out, dout, mask
        torch.cuda.empty_cache()
    # small cases: a softcap, GQA (2 here; minicpm 1, h2o 4, below), windows,
    # every head width, ragged tiles (200 and 4097 positions)
    small = {}
    for hd, t, h, kvh in ((32, 200, 8, 4), (64, 200, 8, 4), (120, 200, 8, 4), (128, 200, 8, 4),
                          (256, 200, 8, 4), (64, 4097, 4, 4), (120, 300, 8, 2)):
        for softcap, window in ((30.0, 50), (0.0, 0)):
            q, do = randn(2, t, h, hd), randn(2, t, h, hd)
            k, v = randn(2, t, kvh, hd), randn(2, t, kvh, hd)
            kw = dict(causal=True, window=window, softcap=softcap)
            o, lse = fa_k.flash_attention_lse(q, k, v, **kw)
            got = fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            exp = fa_r.attention_bwd_ref(q, k, v, o, lse, do, **kw)
            if not within(got, exp):
                fail(f"flash_attention_bwd differs from the plain version (hd {hd}, T {t}, "
                     f"groups {h // kvh}, softcap {softcap}): max |err| {errs(got, exp)}")
            small[f"hd{hd}_T{t}_groups{h // kvh}_softcap{softcap:g}_window{window}"] = \
                errs(got, exp)
            del q, do, k, v, o, lse, got, exp
    ptx = _ptxas("bwd_")
    return {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/layers.py:114",
        **shapes["minicpm_train"],
        "max_abs_err": max(sh["max_abs_err"] for sh in shapes.values()),
        "shapes": shapes, "small_checks_max_abs_err": small, "tol": BWD_TOL, "ptxas": ptx,
    }


def blocked_pairs_for(world: int, fraction: float, seed: int = 0) -> list[tuple[int, int]]:
    """Deterministic sample of hole-punch-failed pairs at one fraction (the
    rule of ``benchmarks/hybrid_links.py``, copied so that no module of the
    JAX package is imported here)."""
    import numpy as np

    pairs = [(a, b) for a in range(world) for b in range(a + 1, world)]
    k = int(round(fraction * len(pairs)))
    if fraction > 0.0:
        k = max(k, 1)  # a nonzero fraction always blocks at least one pair
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(pairs))
    return [pairs[i] for i in order[:k]]


def event_rows(events) -> list[tuple]:
    """Every field of each priced event, for ``==`` comparisons."""
    return [(e.kind.value, e.world, e.bytes_per_rank, e.raw_bytes, e.algo, e.wire_total,
             e.relay, e.relayed_pairs, e.time_s) for e in events]


def comm_join_phase(torch, seed, left, right, ref_out, launches, hp_k, jp_k, sr_k, fa_k) -> dict:
    """Phase 3's join over four fabrics (module doc, phase 3b): the same rows
    on each, only the modeled price moves."""
    from repro_torch.core import make_communicator
    from repro_torch.core.backends.mediated import redis_communicator, s3_communicator
    from repro_torch.core.session import hybrid_session
    from repro_torch.dataframe import ops_dist

    p = len(left)
    blocked = blocked_pairs_for(p, COMM_BLOCKED_SHARE, seed)
    fabrics = {
        "lambda_direct": lambda: make_communicator(p, "direct"),
        "hybrid_redis": lambda: hybrid_session(p, blocked, relay="redis").communicator(),
        "redis": lambda: redis_communicator(p),
        "s3": lambda: s3_communicator(p),
    }
    out_rows = {}
    for name, make in fabrics.items():
        comm = make()
        received: set[str] = set()
        shuffle = comm.alltoallv

        def alltoallv(sends, algorithm=None, _shuffle=shuffle, _seen=received):
            recvs, counts = _shuffle(sends, algorithm=algorithm)
            _seen.update(b.device.type for row in recvs for b in row)
            return recvs, counts

        comm.alltoallv = alltoallv
        torch.cuda.synchronize()
        reset_counters(hp_k, jp_k, sr_k, fa_k)
        t0 = time.perf_counter()
        out = ops_dist.sim_join(left, right, "k", comm)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counters(hp_k, jp_k, sr_k, fa_k)
        if got["hash_partition"] != 2 * p or got["join_probe"] != p:
            fail(f"comm join over {name}: launches {got}, want hash == {2 * p}, probe == {p}")
        if received != {"cuda"}:
            fail(f"comm join over {name}: received blocks on {sorted(received)}, want cuda only")
        for kname, c in got.items():
            by = launches.setdefault(kname, {})
            by["comm"] = by.get("comm", 0) + c
        for rank, (a, b) in enumerate(zip(out, ref_out)):
            n = int(a.count)
            if n != int(b.count) or set(a.columns) != set(b.columns) or not all(
                    torch.equal(a.columns[c][:n], b.columns[c][:n]) for c in a.columns):
                fail(f"comm join over {name}: rank {rank}'s rows differ from phase 3's")
        boot = [e for e in comm.events if e.kind.value == "bootstrap"]
        coll = [e for e in comm.events if e.kind.value != "bootstrap"]
        out_rows[name] = {
            "wall_s": wall, "comm_time_s": comm.comm_time_s,
            "bootstrap_time_s": comm.session.bootstrap_time_s,
            "bytes_on_wire": comm.bytes_on_wire,
            "relayed_pairs": len(comm.session.link_map.relayed_pairs()),
            "events": [{"kind": e.kind.value, "bytes_per_rank": e.bytes_per_rank,
                        "algo": e.algo, "relay": e.relay, "relayed_pairs": e.relayed_pairs,
                        "time_s": e.time_s} for e in coll],
            "bootstrap": [{"algo": e.algo, "time_s": e.time_s, "relay": e.relay,
                           "relayed_pairs": e.relayed_pairs} for e in boot],
            "launches": {k: got[k] for k in ("hash_partition", "join_probe")},
            "rows_bit_equal_to_join": True}
        del out
    return {"P": p, "blocked_pairs": blocked, "fabrics": out_rows}


def collectives_check(torch, gen) -> dict:
    """Every collective on CUDA float32 tensors of ``COMM_ELEMS`` elements per
    rank (module doc, phase 3b): results on the card, bit-equal to numpy on
    host copies folded in rank order; each event priced as the same call on
    CPU tensors of the same shapes."""
    import numpy as np

    from repro_torch.core import Communicator

    w, n = COMM_WORLD, COMM_ELEMS
    xs = [torch.randn(n, generator=gen, device="cuda") for _ in range(w)]
    host = [x.cpu().numpy() for x in xs]
    cpu = [torch.from_numpy(h) for h in host]
    lens = [n - r * 4096 for r in range(w)]  # allgatherv: ragged
    part = n // w

    def fold(op, arrays):
        acc = arrays[0].copy()
        for a in arrays[1:]:
            acc = op(acc, a)
        return acc

    def ops(comm, t, binop):
        """(name, call) of each collective; ``binop`` is the elementwise max."""
        sends = lambda: [[t[s][d * part:(d + 1) * part] for d in range(w)] for s in range(w)]  # noqa: E731
        return [
            ("allreduce_add", lambda: comm.allreduce(t)),
            ("allreduce_max", lambda: comm.allreduce(t, op=binop)),
            ("reduce_scatter_add", lambda: comm.reduce_scatter(t)),
            ("reduce_scatter_max", lambda: comm.reduce_scatter(t, op=binop)),
            ("allgather", lambda: comm.allgather(t)),
            ("allgatherv", lambda: comm.allgatherv([x[:m] for x, m in zip(t, lens)])),
            ("bcast", lambda: comm.bcast(t[3], root=3)),
            ("gather", lambda: comm.gather(t, root=2)),
            ("scatter", lambda: comm.scatter(t, root=1)),
            ("send", lambda: comm.send(t[0], dst=5)),
            ("alltoallv", lambda: comm.alltoallv(sends())[0]),
            ("iallreduce_wait", lambda: comm.wait(comm.iallreduce(t))),
            ("iallgatherv_wait", lambda: comm.wait(comm.iallgatherv(t))),
            ("ialltoallv_wait", lambda: comm.wait(comm.ialltoallv(sends()))[0]),
            ("ping", lambda: comm.ping(7)),
        ]

    def expect(name):
        if name in ("allreduce_add", "iallreduce_wait"):
            return [fold(np.add, host)] * w
        if name == "allreduce_max":
            return [fold(np.maximum, host)] * w
        if name.startswith("reduce_scatter"):
            return np.split(fold(np.add if name.endswith("add") else np.maximum, host), w)
        if name in ("allgather", "iallgatherv_wait"):
            return [np.concatenate(host)] * w
        if name == "allgatherv":
            return [np.concatenate([h[:m] for h, m in zip(host, lens)])] * w
        if name == "bcast":
            return [host[3]] * w
        if name == "gather":
            return [None, None, host] + [None] * (w - 3)
        if name == "scatter":
            return host
        if name in ("alltoallv", "ialltoallv_wait"):
            return [[host[s][d * part:(d + 1) * part] for s in range(w)] for d in range(w)]
        return None  # send, ping: priced events only

    def flat(x) -> list:
        if isinstance(x, (list, tuple)):
            return [y for v in x for y in flat(v)]
        return [x]

    dev_comm, cpu_comm = Communicator(w), Communicator(w)
    report = {}
    for (name, run_d), (_, run_c) in zip(ops(dev_comm, xs, torch.maximum),
                                         ops(cpu_comm, cpu, torch.maximum)):
        k0 = len(dev_comm.events)
        got = run_d()
        run_c()
        exp = expect(name)
        if exp is not None:
            g, e = flat(got), flat(exp)
            if len(g) != len(e) or any((a is None) != (b is None) for a, b in zip(g, e)):
                fail(f"collective {name}: result layout differs from numpy's")
            tensors = [a for a in g if a is not None]
            if any(a.device.type != "cuda" for a in tensors):
                fail(f"collective {name}: a result left the card")
            ptrs = [a.data_ptr() for a in tensors]
            if len(set(ptrs)) != len(ptrs):
                fail(f"collective {name}: two ranks share one result buffer")
            seen: dict[int, torch.Tensor] = {}
            for a, b in zip(g, e):
                if a is None:
                    continue
                # replicated outputs: the first copy on the host against
                # numpy, the other ranks' copies against it on the card
                first = seen.get(id(b))
                if first is None:
                    if not np.array_equal(a.cpu().numpy(), b):
                        fail(f"collective {name}: the card's result differs from numpy's")
                    seen[id(b)] = a
                elif not torch.equal(a, first):
                    fail(f"collective {name}: ranks got different copies")
        del got
        ev_d, ev_c = event_rows(dev_comm.events[k0:]), event_rows(cpu_comm.events[k0:])
        if ev_d != ev_c:
            fail(f"collective {name}: events on the card {ev_d} != on the CPU {ev_c}")
        report[name] = {"events": [{"kind": r[0], "bytes_per_rank": r[2], "algo": r[4],
                                    "time_s": r[8]} for r in ev_d],
                        "bit_equal_to_numpy": exp is not None}
    # a 2-colour split: each sub-communicator's allreduce folds its members
    subs = dev_comm.split([r % 2 for r in range(w)])
    for color in (0, 1):
        sub = subs[color]
        members = list(sub.group)
        got = sub.allreduce([xs[r] for r in members])
        exp = fold(np.add, [host[r] for r in members])
        if got[0].device.type != "cuda" or not np.array_equal(got[0].cpu().numpy(), exp):
            fail(f"split colour {color}: allreduce differs from numpy's")
        report[f"split_{color}_allreduce"] = {"group": members,
                                              "time_s": dev_comm.events[-1].time_s,
                                              "bit_equal_to_numpy": True}
    if len(dev_comm.events) != len(cpu_comm.events) + 2:
        fail("split: the sub-communicators did not log on the shared session")
    return {"world": w, "elements_per_rank": n, "dtype": "float32",
            "comm_time_s": dev_comm.comm_time_s, "bytes_on_wire": dev_comm.bytes_on_wire,
            "collectives": report}


def lifecycle_check() -> dict:
    """A world-64 session on the Lambda fabric (module doc, phase 3b): each
    lifecycle step's modeled seconds."""
    from repro_torch.core.session import CommSession

    out = {}
    for policy in ("incremental", "cold"):
        s = CommSession.bootstrap(LIFECYCLE_WORLD, "lambda")
        row = {"bootstrap_s": s.bootstrap_time_s}
        row["expand_s"] = s.expand(16, provider="gcp-cloudrun")
        row["world_after_expand"] = s.world
        row["full_rebootstrap_after_expand_s"] = s.full_rebootstrap_time_s()
        dead = list(range(s.world - 8, s.world))
        row["detect_s"] = s.detect_failure("_".join(f"r{r}" for r in dead))
        row["shrink_s"] = s.shrink(dead, policy=policy)
        row["world_after_shrink"] = s.world
        row["recover_link_s"], row["recover_link_action"] = s.recover_link(0, 1)
        row["recover_link_permanent_s"], row["recover_link_permanent_action"] = \
            s.recover_link(2, 3, permanent=True)
        row["rebootstrap_rank0_s"] = s.rebootstrap_rank(0)
        row["full_rebootstrap_s"] = s.full_rebootstrap_time_s()
        row["events"] = [{"kind": e.kind.value, "algo": e.algo, "time_s": e.time_s}
                         for e in s.events]
        out[policy] = row
    return out


def step_flops(cfg, batch: int, seq: int) -> dict[str, int]:
    """FLOPs of one causal training step.  ``model``: 3 x the forward's, the
    forward being 2 per weight of every product per token (q, k, v, o, the
    gated MLP, the head) and 4 hd per visible (query, key) pair per head.
    ``products``: every matrix product the step runs, the layers' forward
    recompute included (the backward's two products per forward one);
    ``attention``: the flash kernels' work (forward and recompute 4 hd per
    pair, backward 10 hd)."""
    d, hd, h, kv = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    per_layer = d * h * hd + 2 * d * kv * hd + h * hd * d + d * 2 * cfg.d_ff + cfg.d_ff * d
    tokens = batch * seq
    layers = 2 * tokens * cfg.num_layers * per_layer
    head = 2 * tokens * d * cfg.vocab_size
    pairs = h * batch * (seq * (seq + 1) // 2) * cfg.num_layers
    return {"model": 3 * (layers + head + 4 * hd * pairs),
            "products": 4 * layers + 3 * head,
            "attention": (4 + 4 + 10) * hd * pairs}


def train_phase(torch, seed, launches, hp_k, jp_k, sr_k, fa_k) -> None:
    """``launch.train.train`` on minicpm-2b at full width (module doc, phase
    9), counted and timed in one run; then one more step under the profiler."""
    import math

    import tempfile

    from repro_torch import configs
    from repro_torch.core.session import CommSession
    from repro_torch.core.trace import LANES, Tracer
    from repro_torch.launch import train as ltrain
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    cfg = configs.get(TRAIN_ARCH)
    dev = torch.device("cuda")
    arrivals, log = [], []
    session = CommSession.bootstrap(TRAIN_COMM_WORLD, "lambda")
    tracer = Tracer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(hp_k, jp_k, sr_k, fa_k)
    t0 = time.perf_counter()
    params, losses = ltrain.train(
        cfg, steps=TRAIN_STEPS, batch=TRAIN_B, seq_len=TRAIN_SEQ, lr=TRAIN_LR, log=log.append,
        log_every=1, comm_session=session, tracer=tracer, **TRAIN_BURST_SHRINK,
        device=dev, seed=seed, on_step=lambda step, loss: arrivals.append(time.perf_counter()))
    wall = time.perf_counter() - t0
    lifecycle = [line for line in log if line.startswith(("burst:", "shrink:"))]
    if len(lifecycle) != 2:
        fail(f"train did not log one burst and one shrink: {log}")
    spans = {lane: sum(1 for sp in tracer.spans if sp.lane == lane) for lane in LANES}
    if spans["compute"] != TRAIN_STEPS or spans["comm"] != TRAIN_STEPS:
        fail(f"train's tracer holds {spans}, want {TRAIN_STEPS} compute and comm spans")
    with tempfile.TemporaryDirectory() as tmp:
        trace_path = Path(tmp) / "train_trace.json"
        trace_path.write_text(json.dumps(tracer.to_json()))
        trace_bytes = trace_path.stat().st_size
        if len(Tracer.from_json(json.loads(trace_path.read_text())).spans) != len(tracer.spans):
            fail("train's trace JSON does not round-trip")
    modeled = {"world_start": TRAIN_COMM_WORLD, "world_end": session.world,
               "lifecycle_log": lifecycle, "spans_by_lane": spans,
               "critical_path": tracer.critical_path(), "trace_json_bytes": trace_bytes,
               "comm_lane_s": tracer.lane_time_s("comm"),
               "bootstrap_lane_s": tracer.lane_time_s("bootstrap")}
    got = counters(hp_k, jp_k, sr_k, fa_k)
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention": TRAIN_STEPS * cfg.num_layers * 2,
            "flash_attention_bwd": TRAIN_STEPS * cfg.num_layers}
    for name, n in want.items():
        if got[name] != n:
            fail(f"train launched {name} {got[name]} times, want {n}")
    designs = {**fa_k.fwd_design_launches, **fa_k.bwd_design_launches}
    if designs["flash_wgmma_split"] != want["flash_attention"]:
        fail(f"train's forward did not run flash_wgmma_split every time: {designs}")
    if designs["bwd_wgmma"] != want["flash_attention_bwd"]:
        fail(f"train's backward did not run bwd_wgmma every time: {designs}")
    if got["hash_partition"] < 1 or got["join_probe"] < 1:
        fail(f"train's pipeline did not reach the dataframe kernels: {got}")
    for name, c in got.items():
        launches.setdefault(name, {})["train"] = c
    if not all(math.isfinite(x) for x in losses) or not losses[-1] <= losses[0]:
        fail(f"train losses not finite and falling: {losses}")
    step_s = [arrivals[0] - t0] + [b - a for a, b in zip(arrivals, arrivals[1:])]
    median_s = statistics.median(step_s[1:])
    flops = step_flops(cfg, TRAIN_B, TRAIN_SEQ)
    emit({"phase": "train", "arch": TRAIN_ARCH, "params": cfg.param_count(), "B": TRAIN_B,
          "seq_len": TRAIN_SEQ, "steps": TRAIN_STEPS, "wall_s": wall,
          "step_s": step_s, "median_step_s_2_to_6": median_s,
          "tokens_per_s": TRAIN_B * TRAIN_SEQ / median_s, "losses": losses,
          "flops_per_step": flops,
          "model_flops_share_of_fp32_cuda_core_peak":
              flops["model"] / median_s / OPS_PER_S["fp32"],
          "peak_mem_bytes": peak, "launches": got, "designs": designs, "log": log,
          "modeled": modeled})
    # one more step under the profiler, from fresh optimizer state
    opt_cfg = opt.OptConfig(lr=TRAIN_LR, warmup_steps=max(TRAIN_STEPS // 20, 5),
                            total_steps=TRAIN_STEPS, schedule=cfg.schedule,
                            state_dtype=cfg.opt_state_dtype)
    opt_state = opt.init_state(params, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg)
    batch = next(ltrain.data_iter(cfg, TRAIN_B, TRAIN_SEQ, start=TRAIN_STEPS, device=dev))
    emit({"phase": "trace", "cell": "train", **trace(
        torch, lambda: float(step_fn(params, opt_state, batch)[2]["loss"]), top=12,
        groups={"products (gemm)": ("gemm",), "flash_attention_bwd": ("bwd_",),
                "flash_attention": ("flash_", "fwd_prep"), "other": ("",)})})


def train_check_phase(torch, seed) -> dict:
    """Card against CPU for one step at full width (2 layers), float32 and
    int8 moments, and the kill/resume drill on the card (module doc)."""
    import dataclasses
    import tempfile

    import numpy as np

    from repro_torch import configs
    from repro_torch.core.session import CommSession
    from repro_torch.dist.treepath import flatten_with_path, path_str, tree_map
    from repro_torch.launch import train as ltrain
    from repro_torch.models import api
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import _make_grads_of

    def leafwise(tree) -> dict:
        return {path_str(p): t for p, t in flatten_with_path(tree)}

    dev = torch.device("cuda")
    cfg = dataclasses.replace(configs.get(TRAIN_ARCH), num_layers=2)
    gen = torch.Generator()
    gen.manual_seed(seed)
    p_cpu = api.init_params(cfg, gen, device="cpu", master=True)
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256))
                                        .astype(np.int32)),
             "mask": torch.from_numpy((rng.uniform(size=(2, 256)) > 0.1).astype(np.float32))}
    grads_of = _make_grads_of(cfg, None, 1, torch.float32)
    p_dev = tree_map(lambda t: t.to(dev), p_cpu)
    loss_d, _, g_d = grads_of(p_dev, {k: v.to(dev) for k, v in batch.items()})
    loss_c, _, g_c = grads_of(p_cpu, batch)
    out = {"a": {"loss_card": float(loss_d), "loss_cpu": float(loss_c)}}
    if abs(float(loss_d) - float(loss_c)) > TRAIN_LOSS_RTOL * abs(float(loss_c)):
        fail(f"train_check: loss on the card {float(loss_d)} vs the CPU {float(loss_c)}")
    matrix = ("wq", "wk", "wv", "wo_att", "wi", "wo", "lm_head", "embed")
    grad_report = {}
    for name, gc in leafwise(g_c).items():
        gd = leafwise(g_d)[name].cpu()
        err = (gd - gc).abs()
        scale = float(gc.abs().max())
        leaf = name.rsplit("/", 1)[-1]
        if leaf in matrix:
            tied = leaf == "embed" and cfg.tie_embeddings
            limit = (BF16_ULP * scale if tied
                     else BF16_ULP * gc.abs() + TRAIN_F32_GRAD_TOL * scale)
            equal = float((gd == gc).float().mean())
            ok = bool((err <= limit).all()) and equal >= 0.99
        else:
            equal = float((gd == gc).float().mean())
            ok = bool((err <= TRAIN_F32_GRAD_TOL * (scale + gc.abs())).all())
        grad_report[name] = {"max_abs_err": float(err.max()), "scale": scale,
                             "bit_equal_share": equal}
        if not ok:
            fail(f"train_check: gradient {name} on the card differs from the CPU's: "
                 f"{grad_report[name]}")
    out["a"]["grads"] = grad_report
    # the update, float32 and int8 moments, from each side's own gradients
    opt_cfg = opt.OptConfig(lr=TRAIN_LR, warmup_steps=5, total_steps=TRAIN_STEPS, schedule="wsd")
    lr1 = float(opt.lr_at(torch.tensor(1), opt_cfg))
    for label, state_dtype in (("a", "float32"), ("b", "int8")):
        oc = dataclasses.replace(opt_cfg, state_dtype=state_dtype)
        pc, pd = (tree_map(torch.clone, p) for p in (p_cpu, p_dev))
        pc, sc = opt.apply_updates(pc, g_c, opt.init_state(pc, oc), oc)
        pd, sd = opt.apply_updates(pd, g_d, opt.init_state(pd, oc), oc)
        worst, share = 0.0, 1.0
        for name, wc in leafwise(pc).items():
            err = (leafwise(pd)[name].cpu() - wc).abs()
            worst = max(worst, float(err.max()))
            share = min(share, float((err <= 2 * BF16_ULP * lr1 + 1e-6).float().mean()))
        if worst > 2 * lr1 + 1e-6 or share < 0.999:
            fail(f"train_check ({label}, {state_dtype} moments): updated weights differ: "
                 f"max {worst}, share within 2 bf16 ulps of lr {share}")
        q_equal = 1.0
        for name, mc in leafwise(sc["m"]).items():
            md = leafwise(sd["m"])[name].cpu()
            if md.dtype == torch.int8:
                q_equal = min(q_equal, float((md == mc).float().mean()))
        if q_equal < 0.99:
            fail(f"train_check (b): int8 moments differ in {1 - q_equal} of their entries")
        out.setdefault(label, {}).update({
            "state_dtype": state_dtype, "lr_step1": lr1, "weights_max_abs_err": worst,
            "weights_share_within_2_bf16_ulps_of_lr": share,
            "int8_m_equal_share": q_equal if state_dtype == "int8" else None})
        del pc, pd, sc, sd
    del p_cpu, p_dev, g_c, g_d
    torch.cuda.empty_cache()
    # (c) the kill/resume drill on the card, LocalStore checkpoints, each call
    # with its own modeled session: the resumed one re-bootstraps through it
    rcfg = configs.get(TRAIN_ARCH).reduced()
    kw = dict(batch=2, seq_len=64, ckpt_every=10, device=dev, seed=seed)
    logs: list[str] = []
    with tempfile.TemporaryDirectory() as tmp:
        _, ref = ltrain.train(rcfg, steps=4, ckpt_dir=f"{tmp}/ref", log=logs.append,
                              comm_session=CommSession.bootstrap(8, "lambda"), **kw)
        _, first = ltrain.train(rcfg, steps=4, stop_after=2, ckpt_dir=f"{tmp}/el",
                                log=logs.append, comm_session=CommSession.bootstrap(8, "lambda"),
                                **kw)
        resumed = CommSession.bootstrap(8, "lambda")
        rlog: list[str] = []
        _, rest = ltrain.train(rcfg, steps=4, ckpt_dir=f"{tmp}/el", resume=True, log=rlog.append,
                               comm_session=resumed, **kw)
    if first + rest != ref:
        fail(f"train_check (c): kill/resume trace {first + rest} != uninterrupted {ref}")
    reboot = [line for line in rlog if line.startswith("re-bootstrap:")]
    if len(reboot) != 1 or resumed.rebootstrap_time_s <= 0.0:
        fail(f"train_check (c): the resumed run did not re-bootstrap its session: {rlog}")
    out["c"] = {"uninterrupted": ref, "killed_and_resumed": first + rest, "bit_equal": True,
                "rebootstrap_log": reboot[0], "rebootstrap_s": resumed.rebootstrap_time_s}
    return out


def _ptxas(pattern: str) -> dict:
    """Registers and spills of each built kernel whose name holds ``pattern``."""
    from repro_torch.kernels import _build

    return {name.split("_cu_")[-1]: rep for name, rep in _build.ptxas_report(pattern).items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import make_communicator
    from repro_torch.dataframe import Table, ops_dist
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa_k, ref as fa_r
    from repro_torch.kernels.hash_partition import kernel as hp_k, ref as hp_r
    from repro_torch.kernels.join_probe import kernel as jp_k, ref as jp_r
    from repro_torch.kernels.segment_reduce import kernel as sr_k, ref as sr_r

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    # -- 1. device + build ----------------------------------------------------
    smi = smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "size_cuts": SIZE_CUTS})
    emit({"phase": "ptxas", **{pat: _build.ptxas_report(pat) for pat in (
        "flash_wgmma", "fwd_prep_kv", "flash_decode", "flash_tiled", "bwd_wgmma", "bwd_wide",
        "bwd_prep", "probe_kernel", "build_index")}})
    # flash_wgmma<HD, false> (bf16 k/v) and <HD, true> (flash_wgmma_split),
    # bwd_wgmma and bwd_wide: every instance on the tensor cores
    for name, instances in (("flash_wgmma", ("ELb0E", "ELb1E")), ("bwd_wgmma", ("",)),
                            ("bwd_wide", ("",))):
        hgmma = sass_has(_build.build(), name, "HGMMA")
        if not all(any(i in f for f in hgmma) for i in instances) or not all(hgmma.values()):
            fail(f"{name}'s SASS holds no HGMMA (tensor-core) instruction: {hgmma}")

    timer = Timer(torch)
    kernels: dict[str, dict] = {}

    # -- 2. kernels against their plain versions --------------------------------
    def abs_err(a, b) -> int:
        """Largest |a - b| over two integer (or uint32) tensors, as an int."""
        if a.dtype == torch.uint32:
            a, b = (t.view(torch.int32).long() & 0xFFFFFFFF for t in (a, b))
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    # hash/bucket/histogram at the two shapes the shuffles give it: one join
    # worker's table (capacity int(1.1 * 9.1M) + 8, 9.1M valid rows, P = 8)
    # and one groupby worker's table (50M rows, all valid, P = 4).  Timed 4
    # launches per input copy back to back (see Timer).
    hash_shapes = {}
    for cell, n, valid, parts, copies in (
        ("join", int(1.1 * JOIN_ROWS) + 8, JOIN_ROWS, JOIN_P, 4),
        ("groupby", GROUPBY_ROWS, GROUPBY_ROWS, GROUPBY_P, 2),
    ):
        keys = [torch.randint(-(2**31), INT32_MAX, (n,), generator=gen, device=dev,
                              dtype=torch.int32) for _ in range(copies)]
        count = torch.tensor(valid, dtype=torch.int32, device=dev)
        _, b_k, hist_k = hp_k.row_buckets([keys[0]], parts, count)
        b_p, hist_p = hp_r.row_buckets_ref([keys[0]], parts, count)
        err = max(abs_err(b_k, b_p), abs_err(hist_k, hist_p))
        if err:
            fail(f"hash_partition row buckets/histogram differ from the plain version ({cell})")
        bms, bby = bound(4 * n + 4 + 4 * n + 4 * (parts + 1), 12 * n)
        hash_shapes[cell] = {
            "n": n, "valid": valid, "P": parts, "max_abs_err": err,
            "ms": timer.ms(*rotating(lambda k, p=parts, c=count: hp_k.row_buckets([k], p, c),
                                     keys, 4 * copies)),
            "plain_ms": timer.ms(lambda p=parts, c=count: hp_r.row_buckets_ref([keys[0]], p, c)),
            "bound_ms": bms, "bound_by": bby,
        }
        if cell == "join":
            h1, b1 = hp_k.hash_partition(keys[0], num_partitions=parts)
            h2, b2 = hp_r.hash_partition_ref(keys[0], num_partitions=parts)
            single_err = max(abs_err(h1, h2), abs_err(b1, b2))
            if single_err:
                fail("hash_partition single-column entry differs from the plain version")
            single = {
                "max_abs_err": single_err,
                "ms": timer.ms(*rotating(lambda k, p=parts: hp_k.hash_partition(k, num_partitions=p),
                                         keys, 4 * copies)),
                "plain_ms": timer.ms(
                    lambda p=parts: hp_r.hash_partition_ref(keys[0], num_partitions=p)),
            }
            del h1, b1, h2, b2
        del keys, b_k, hist_k, b_p, hist_p
    kernels["hash_partition"] = {
        "name": "hash_partition", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hash_partition.cu",
        "replaces": "src/repro/kernels/hash_partition/kernel.py:23",
        **hash_shapes["join"],
        "max_abs_err": max(s["max_abs_err"] for s in hash_shapes.values()),
        "library_ms": None,
        "shapes": hash_shapes,
    }
    emit({"phase": "kernel", **kernels["hash_partition"], "single_column_entry": single})

    # probe: the receive page of a join worker, ~20M int32 of which half are
    # INT32_MAX padding, probed by ~20M left keys
    page = JOIN_P * (int(1.1 * JOIN_ROWS) + 8) // JOIN_P * 2
    key_space = 2 * JOIN_ROWS * JOIN_P
    real = page // 2
    right = torch.randperm(key_space, generator=gen, device=dev)[:real].to(torch.int32)
    right = torch.cat([torch.sort(right).values,
                       torch.full((page - real,), INT32_MAX, dtype=torch.int32, device=dev)])
    left = torch.randint(0, key_space, (page,), generator=gen, device=dev, dtype=torch.int32)
    left[:16] = INT32_MAX  # the sentinel-equal keys join_unique must guard
    i_k, hit_k = jp_k.probe_sorted(right, left)
    i_p, hit_p = jp_r.probe_sorted_ref(right, left)
    if not (torch.equal(i_k, i_p) and torch.equal(hit_k, hit_p)):
        fail(f"join_probe differs from the plain version: {int((i_k != i_p).sum())} positions, "
             f"{int((hit_k != hit_p).sum())} hits")
    steps = max(1, page.bit_length())
    bms, bby = bound(4 * page + 4 * page + 4 * page + page, page * steps)
    kernels["join_probe"] = {
        "name": "join_probe", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/join_probe.cu",
        "replaces": "src/repro/kernels/join_probe/kernel.py:23",
        "max_abs_err": int((i_k - i_p).abs().max()),
        "ms": timer.ms(lambda: jp_k.probe_sorted(right, left)),
        "plain_ms": timer.ms(lambda: jp_r.probe_sorted_ref(right, left)),
        "bound_ms": bms, "bound_by": bby,
        "library_ms": timer.ms(lambda: torch.searchsorted(right, left)),
        "shape": {"page": page, "real": real, "left": page,
                  "hits": int(hit_k.sum())},
    }
    emit({"phase": "kernel", **kernels["join_probe"]})
    del right, left, i_k, hit_k, i_p, hit_p

    # segment sum at the three shapes groupby_agg gives it.  There a table of
    # capacity cap is sorted by key; each valid row's segment id is the rank
    # of its key among the distinct keys, every padding row sits in the
    # overflow segment cap, and num_segments is cap + 1 (so each call also
    # writes 4 * (cap + 1) bytes of output).
    #   combine        a worker's 50M rows over 1000 groups: cap 50M, no padding
    #                  (combiner on, before the shuffle);
    #   merge_combined a received table, cap 2 * sum(cap) / P = 100M, holding
    #                  the ~1000 partial rows of the ~250 groups hashed to it,
    #                  the rest padding (combiner on, after the shuffle);
    #   merge_raw      the same cap holding ~50M raw rows of ~250 groups, the
    #                  rest padding (combiner off, after the shuffle).
    def groupby_segments(cap: int, valid: int, groups: int):
        seg = torch.full((cap,), cap, dtype=torch.int32, device=dev)
        seg[:valid] = torch.sort(torch.randint(0, groups, (valid,), generator=gen, device=dev,
                                               dtype=torch.int32)).values
        return seg

    merge_cap = GROUPBY_P * GROUPBY_ROWS // GROUPBY_P * 2
    seg_shapes = {}
    for cell, cap, valid, groups in (
        ("combine", GROUPBY_ROWS, GROUPBY_ROWS, GROUPS),
        ("merge_combined", merge_cap, GROUPS, GROUPS // GROUPBY_P),
        ("merge_raw", merge_cap, GROUPBY_ROWS, GROUPS // GROUPBY_P),
    ):
        seg = groupby_segments(cap, valid, groups)
        nseg = cap + 1
        vi = torch.randint(0, 100, (cap,), generator=gen, device=dev, dtype=torch.int32)
        s_k = sr_k.segment_sum(seg, vi, nseg)
        s_p = sr_r.segment_sum_ref(seg, vi, nseg)
        err = abs_err(s_k, s_p)
        if err:
            fail(f"segment_reduce int32 differs from the plain version ({cell})")
        acc = torch.zeros(nseg, dtype=torch.int32, device=dev)
        bms, bby = bound(4 * cap + 4 * cap + 4 * nseg, cap)
        seg_shapes[cell] = {
            "n": cap, "num_segments": nseg, "valid": valid, "groups": groups,
            "dtype": "int32", "max_abs_err": err,
            "ms": timer.ms(lambda: sr_k.segment_sum(seg, vi, nseg)),
            "plain_ms": timer.ms(lambda: sr_r.segment_sum_ref(seg, vi, nseg)),
            "bound_ms": bms, "bound_by": bby,
            "library_ms": timer.ms(lambda: acc.index_add_(0, seg, vi)),
        }
        if cell == "combine":
            vf = torch.rand(cap, generator=gen, device=dev)
            f_k = sr_k.segment_sum(seg, vf, nseg).double()
            f_p = sr_r.segment_sum_ref(seg, vf, nseg).double()
            f_x = sr_r.segment_sum_ref(seg, vf.double(), nseg)
            f32_err_plain = float(((f_k - f_p).abs() / f_x.abs().clamp(min=1)).max())
            f32_err_exact = float(((f_k - f_x).abs() / f_x.abs().clamp(min=1)).max())
            if f32_err_plain > SEGSUM_F32_RTOL_VS_PLAIN or f32_err_exact > SEGSUM_F32_RTOL_VS_EXACT:
                fail(f"segment_reduce float32 off: rel err {f32_err_plain} vs plain, "
                     f"{f32_err_exact} vs float64")
            # dense: ~5 rows per segment (far above the Pallas kernel's 128 per block)
            dense = torch.sort(torch.randint(0, cap // 5, (cap,), generator=gen, device=dev,
                                             dtype=torch.int32)).values
            if not torch.equal(sr_k.segment_sum(dense, vi, cap // 5),
                               sr_r.segment_sum_ref(dense, vi, cap // 5)):
                fail("segment_reduce int32 differs from the plain version at 10M segments")
            del vf, f_k, f_p, f_x, dense
        del seg, vi, s_k, s_p, acc
        torch.cuda.empty_cache()
    kernels["segment_reduce"] = {
        "name": "segment_reduce", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_reduce.cu",
        "replaces": "src/repro/kernels/segment_reduce/kernel.py:23",
        **seg_shapes["merge_combined"],
        "max_abs_err": max(s["max_abs_err"] for s in seg_shapes.values()),
        "f32_max_rel_err_vs_plain": f32_err_plain,
        "f32_max_rel_err_vs_float64": f32_err_exact,
        "f32_rtol": {"vs_plain": SEGSUM_F32_RTOL_VS_PLAIN, "vs_float64": SEGSUM_F32_RTOL_VS_EXACT},
        "shapes": seg_shapes,
    }
    emit({"phase": "kernel", **kernels["segment_reduce"]})
    del timer
    torch.cuda.empty_cache()

    # counter name -> main-path run -> launches (see ``counters``)
    launches: dict[str, dict[str, int]] = {}

    # -- 3. sim_join at the weak-scaling size -----------------------------------
    p, rows = JOIN_P, JOIN_ROWS
    cap = int(rows * 1.1) + 8
    key_space = 2 * rows * p
    lk = torch.randperm(key_space, generator=gen, device=dev)[: rows * p].to(torch.int32)
    rk = torch.randperm(key_space, generator=gen, device=dev)[: rows * p].to(torch.int32)
    lv = torch.randint(0, 1 << 20, (rows * p,), generator=gen, device=dev, dtype=torch.int32)
    rw = torch.randint(0, 1 << 20, (rows * p,), generator=gen, device=dev, dtype=torch.int32)
    left = [Table.from_dict({"k": lk[i * rows:(i + 1) * rows], "v": lv[i * rows:(i + 1) * rows]},
                            capacity=cap, device=dev) for i in range(p)]
    right = [Table.from_dict({"k": rk[i * rows:(i + 1) * rows], "w": rw[i * rows:(i + 1) * rows]},
                             capacity=cap, device=dev) for i in range(p)]
    comm = make_communicator(p, "direct")
    torch.cuda.synchronize()
    reset_counters(hp_k, jp_k, sr_k, fa_k)
    t0 = time.perf_counter()
    out = ops_dist.sim_join(left, right, "k", comm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counters(hp_k, jp_k, sr_k, fa_k)
    for name, c in got.items():
        launches.setdefault(name, {})["join"] = c
    if got["hash_partition"] < 2 * p or got["join_probe"] != p:
        fail(f"join launches {got}: want hash >= {2 * p}, probe == {p}")
    emit({"phase": "trace", "cell": "join", **trace(
        torch, lambda: ops_dist.sim_join(left, right, "k", make_communicator(p, "direct")))})

    # independent check in numpy: every joined row is (k, left v of k, right w of k)
    lk_h, rk_h, lv_h, rw_h = (t.cpu().numpy() for t in (lk, rk, lv, rw))
    del lk, rk, lv, rw
    v_of = np.zeros(key_space, np.int64)
    w_of = np.zeros(key_space, np.int64)
    v_of[lk_h] = lv_h
    w_of[rk_h] = rw_h
    hit_l = np.isin(lk_h, rk_h, kind="table")
    hit_r = np.isin(rk_h, lk_h, kind="table")
    exp = {"rows": int(hit_l.sum()), "sum_v": int(lv_h[hit_l].sum(dtype=np.int64)),
           "sum_w": int(rw_h[hit_r].sum(dtype=np.int64))}
    seen = np.zeros(key_space, bool)
    res = {"rows": 0, "sum_v": 0, "sum_w": 0}
    for t in out:
        cols = t.to_numpy()
        k = cols["k"].astype(np.int64)
        if not (np.array_equal(cols["v"], v_of[k]) and np.array_equal(cols["w"], w_of[k])):
            fail("sim_join produced a row whose v or w does not belong to its key")
        if seen[k].any():
            fail("sim_join produced a key twice")
        seen[k] = True
        res["rows"] += k.shape[0]
        res["sum_v"] += int(cols["v"].sum(dtype=np.int64))
        res["sum_w"] += int(cols["w"].sum(dtype=np.int64))
    if res != exp:
        fail(f"sim_join result {res} != numpy {exp}")
    emit({"phase": "join", "P": p, "rows_per_worker": rows, "capacity": cap, "wall_s": wall,
          "bytes_on_wire": comm.bytes_on_wire, "comm_time_s": comm.comm_time_s,
          "events": len(comm.events), "launches": got, **res})
    del v_of, w_of, seen, lk_h, rk_h, lv_h, rw_h

    # -- 3b. comm: the join over four fabrics, the collectives, the lifecycle ---
    t0 = time.perf_counter()
    comm_join = comm_join_phase(torch, args.seed, left, right, out, launches,
                                hp_k, jp_k, sr_k, fa_k)
    del left, right, out
    torch.cuda.empty_cache()
    for name, row in comm_join["fabrics"].items():
        emit({"phase": "comm", "part": "join", "fabric": name, "P": comm_join["P"],
              "blocked_pairs": comm_join["blocked_pairs"] if name.startswith("hybrid") else [],
              **row})
    emit({"phase": "comm", "part": "collectives", **collectives_check(torch, gen)})
    torch.cuda.empty_cache()
    emit({"phase": "comm", "part": "lifecycle", "world": LIFECYCLE_WORLD, "fabric": "lambda",
          **lifecycle_check()})
    emit({"phase": "comm", "part": "wall", "wall_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()

    # -- 4. sim_groupby at the §IV-C size --------------------------------------
    p, rows = GROUPBY_P, GROUPBY_ROWS
    gk = torch.randint(0, GROUPS, (rows * p,), generator=gen, device=dev, dtype=torch.int32)
    gv = torch.randint(0, 100, (rows * p,), generator=gen, device=dev, dtype=torch.int32)
    expected = np.bincount(gk.cpu().numpy(), weights=gv.cpu().numpy(), minlength=GROUPS)
    expected = expected.astype(np.int64)
    for combine in (True, False):
        tables = [Table.from_dict({"k": gk[i * rows:(i + 1) * rows], "v": gv[i * rows:(i + 1) * rows]},
                                  device=dev) for i in range(p)]
        comm = make_communicator(p, "direct")
        torch.cuda.synchronize()
        reset_counters(hp_k, jp_k, sr_k, fa_k)
        t0 = time.perf_counter()
        out = ops_dist.sim_groupby(tables, "k", {"v": "sum"}, comm, combine=combine)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counters(hp_k, jp_k, sr_k, fa_k)
        want_seg = 2 * p if combine else p
        if got["segment_reduce"] != want_seg or got["hash_partition"] != p:
            fail(f"groupby combine={combine} launches {got}: want segment_reduce == "
                 f"{want_seg}, hash == {p}")
        cols = [t.to_numpy() for t in out]
        k = np.concatenate([c["k"] for c in cols])
        s = np.concatenate([c["v_sum"] for c in cols])
        if not np.array_equal(np.sort(k), np.arange(GROUPS)):
            fail(f"sim_groupby combine={combine}: groups are not exactly 0..{GROUPS - 1}")
        if not np.array_equal(s.astype(np.int64), expected[k]):
            fail(f"sim_groupby combine={combine}: sums differ from np.bincount")
        run = f"groupby_combine_{str(combine).lower()}"
        for name, c in got.items():
            launches.setdefault(name, {})[run] = c
        emit({"phase": "groupby", "P": p, "rows_per_worker": rows, "groups": GROUPS,
              "combine": combine, "wall_s": wall, "bytes_on_wire": comm.bytes_on_wire,
              "comm_time_s": comm.comm_time_s, "launches": got})
        del out
        emit({"phase": "trace", "cell": run, **trace(torch, lambda: ops_dist.sim_groupby(
            tables, "k", {"v": "sum"}, make_communicator(p, "direct"), combine=combine))})
        del tables
        torch.cuda.empty_cache()

    # -- 5. flash attention at the serving path's shapes -------------------------
    from repro_torch import configs

    scfg = configs.get(SERVE_ARCH)
    hd, nh, kvh = scfg.resolved_head_dim, scfg.num_heads, scfg.num_kv_heads
    layers = scfg.num_layers
    cache_len = SERVE_PROMPT + SERVE_NEW
    timer = Timer(torch)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def within(got, exp) -> bool:
        return bool(((got - exp).abs() <= FLASH_TOL + FLASH_TOL * exp.abs()).all())

    def flash_err(got, exp) -> float:
        err = float((got - exp).abs().max())
        if not within(got, exp):
            fail(f"flash_attention differs from the plain version: max |err| {err}")
        return err

    # the cache's layer slice [B, prompt + new, KV, hd] bfloat16; 4 copies
    # (4 x 34 MB > the L2) for the decode timings, 16 launches per event pair
    kv_copies = [(randn(SERVE_B, cache_len, kvh, hd, dtype=torch.bfloat16),
                  randn(SERVE_B, cache_len, kvh, hd, dtype=torch.bfloat16)) for _ in range(4)]
    q_prefill = randn(SERVE_B, SERVE_PROMPT, nh, hd)
    q_decode = randn(SERVE_B, 1, nh, hd)
    flash_shapes = {}
    for cell, q, window, q_offset, kv_len in (
        ("prefill_local", q_prefill, scfg.sliding_window, 0, SERVE_PROMPT),
        ("prefill_global", q_prefill, 0, 0, SERVE_PROMPT),
        ("decode", q_decode, 0, SERVE_PROMPT, SERVE_PROMPT + 1),
        ("decode_local", q_decode, scfg.sliding_window, SERVE_PROMPT, SERVE_PROMPT + 1),
    ):
        kw = dict(causal=True, window=window, q_offset=q_offset, kv_len=kv_len)
        k, v = kv_copies[0]
        got = fa_k.flash_attention(q, k, v, **kw)
        err = flash_err(got, fa_r.attention_ref(q, k, v, **kw))
        # the limit must see one key too few: the oldest in the window, or
        # the newest in the cache
        near = dict(kw, window=window - 1) if window else dict(kw, kv_len=kv_len - 1)
        exp_near = fa_r.attention_ref(q, k, v, **near)
        if within(got, exp_near):
            fail(f"flash_attention limit {FLASH_TOL} does not tell one key too few ({cell})")
        one_key_off = float((got - exp_near).abs().max())
        del got, exp_near
        nbytes, ops = flash_work(torch, q, k, **kw)
        prefill = q.shape[1] * (nh // kvh) > fa_k.SPLIT_ROWS
        # the design that runs: the bf16 tensor cores at prefill (bf16 k/v),
        # float32 on the CUDA cores at decode (a byte bound either way)
        bms, bby = (bound(nbytes, ops, "bf16_tensor", FLASH_SPLIT["flash_wgmma"]) if prefill
                    else bound(nbytes, ops))
        fms, fby = bound(nbytes, ops)
        per_pair = 16 if q.shape[1] == 1 else 1
        ms = timer.ms(*rotating(lambda c, q=q, kw=kw: fa_k.flash_attention(q, *c, **kw),
                                kv_copies, per_pair))
        flash_shapes[cell] = {
            "q": list(q.shape), "kv": list(k.shape), "kv_dtype": "bfloat16", **kw,
            "design": "flash_wgmma" if prefill else "flash_decode",
            "max_abs_err": err, "one_key_off_max_abs_err": one_key_off, "ms": ms,
            "plain_ms": timer.ms(lambda q=q, kw=kw: fa_r.attention_ref(q, k, v, **kw)),
            "bound_ms": bms, "bound_by": bby, "share_of_bound": bms / ms,
            "bound_fp32_ms": fms, "bound_fp32_by": fby, "share_of_fp32_bound": fms / ms,
            "bytes": nbytes, "operations": ops,
            "library_ms": timer.ms(sdpa_call(torch, q, k, v, **kw)),
        }
        torch.cuda.empty_cache()
    # gemma3-4b's global layer at 32,768 keys (ROADMAP C 1): 512 queries at
    # q_offset 32,256 over a bf16 cache of 32,768 positions, 1,024 rows per kv
    # head (flash_wgmma, which sums each row's O over 512 key tiles); within
    # the limit and not given one key too few; also with v of mean 1, where
    # |O| ~ 1 and a bias of O toward zero would show against the limit
    lq = randn(1, 512, nh, hd)
    for v_mean in (0.0, 1.0):
        lk = randn(1, 32768, kvh, hd, dtype=torch.bfloat16)
        lv = (randn(1, 32768, kvh, hd) + v_mean).to(torch.bfloat16)
        kw = dict(causal=True, window=0, q_offset=32256, kv_len=32768)
        got = fa_k.flash_attention(lq, lk, lv, **kw)
        exp = fa_r.attention_ref(lq, lk, lv, **kw)
        err = flash_err(got, exp)
        mean_rel = float(((got - exp) * exp.sign()).mean() / exp.abs().mean())
        del exp
        exp_near = fa_r.attention_ref(lq, lk, lv, **dict(kw, kv_len=32767))
        if within(got, exp_near):
            fail(f"flash_attention limit {FLASH_TOL} does not tell one key too few (32k keys)")
        one_key_off = float((got - exp_near).abs().max())
        del got, exp_near
        if v_mean:
            flash_shapes["prefill_global_32k"]["v_mean_1"] = {
                "max_abs_err": err, "mean_signed_rel_err": mean_rel,
                "one_key_off_max_abs_err": one_key_off}
            continue
        nbytes, ops = flash_work(torch, lq, lk, **kw)
        bms, bby = bound(nbytes, ops, "bf16_tensor", FLASH_SPLIT["flash_wgmma"])
        ms = timer.ms(lambda: fa_k.flash_attention(lq, lk, lv, **kw))
        flash_shapes["prefill_global_32k"] = {
            "q": list(lq.shape), "kv": list(lk.shape), "kv_dtype": "bfloat16", **kw,
            "design": "flash_wgmma", "max_abs_err": err, "mean_signed_rel_err": mean_rel,
            "one_key_off_max_abs_err": one_key_off, "ms": ms,
            "plain_ms": timer.ms(lambda: fa_r.attention_ref(lq, lk, lv, **kw)),
            "bound_ms": bms, "bound_by": bby, "share_of_bound": bms / ms,
            "bytes": nbytes, "operations": ops,
            "library_ms": timer.ms(sdpa_call(torch, lq, lk, lv, **kw)),
        }
    del lq, lk, lv
    torch.cuda.empty_cache()
    # rows with no valid key (the uniform mean of v) and a softcap, through
    # the three designs (64 rows: wgmma with bf16 k/v, tiled with float32;
    # 1 row: decode), k/v in both types
    small = {}
    q_small = randn(2, 64, nh, hd)
    for kv_dtype in ("float32", "bfloat16"):
        ks = randn(2, 96, kvh, hd, dtype=getattr(torch, kv_dtype))
        vs = randn(2, 96, kvh, hd, dtype=getattr(torch, kv_dtype))
        for tq in (64, 1):
            for what, kw in (("kv_len_0", dict(kv_len=0)),
                             ("softcap_50", dict(softcap=50.0, kv_len=90, q_offset=90 - tq))):
                q = q_small[:, :tq]
                small[f"{what}_{kv_dtype}_tq{tq}"] = flash_err(
                    fa_k.flash_attention(q, ks, vs, **kw), fa_r.attention_ref(q, ks, vs, **kw))
    del ks, vs
    # the float32-k/v designs, each with its own bound: flash_wgmma_split (k,
    # v split too: six bf16 products per float32 product) at minicpm-2b's
    # train shape (with lse, as the training forward) and h2o-danube-3-4b's
    # hd 120 (q [1, 4096, 32, 120], k/v 8 heads, window 4096; there also the
    # bf16 prefill and decode designs), and flash_tiled (float32 CUDA cores)
    # at gemma3-4b's global layer with float32 k/v (its cache-free and
    # training forward); each within 2e-5, o and lse, and failing it given
    # one key too few
    hcfg = configs.get("h2o-danube-3-4b")
    tcfg = configs.get(TRAIN_ARCH)
    hd120 = {}
    for cell, b_, cfg_, window in (("train_fwd", TRAIN_B, tcfg, 0),
                                   ("h2o_hd120", 1, hcfg, hcfg.sliding_window),
                                   ("gemma3_global_f32", 1, scfg, 0)):
        fq = randn(b_, TRAIN_SEQ, cfg_.num_heads, cfg_.resolved_head_dim)
        fk, fv = (randn(b_, TRAIN_SEQ, cfg_.num_kv_heads, cfg_.resolved_head_dim)
                  for _ in range(2))
        kw = dict(causal=True, window=window)
        design = fa_k.fwd_design(cfg_.resolved_head_dim, torch.float32,
                                 TRAIN_SEQ * cfg_.num_heads // cfg_.num_kv_heads, lse=True)
        before = fa_k.fwd_design_launches[design]
        o, lse = fa_k.flash_attention_lse(fq, fk, fv, **kw)
        if fa_k.fwd_design_launches[design] != before + 1:
            fail(f"flash_attention_lse did not run {design} ({cell})")
        o_r, lse_r = fa_r.attention_lse_ref(fq, fk, fv, **kw)
        err = max(flash_err(o, o_r), flash_err(lse, lse_r))
        del o_r, lse_r
        o_n, _ = fa_r.attention_lse_ref(fq, fk, fv, causal=True, window=(window or TRAIN_SEQ) - 1)
        if within(o, o_n):
            fail(f"flash_attention limit {FLASH_TOL} does not tell one key too few ({cell})")
        one_key_off = float((o - o_n).abs().max())
        del o_n
        o2, lse2 = fa_k.flash_attention_lse(fq, fk, fv, **kw)
        repeat_equal = torch.equal(o, o2) and torch.equal(lse, lse2)
        if not repeat_equal:
            fail(f"flash_attention_lse is not bit-equal across two runs ({cell})")
        del o, lse, o2, lse2
        torch.cuda.empty_cache()
        full = dict(kw, q_offset=0, kv_len=TRAIN_SEQ)
        nbytes, ops = flash_work(torch, fq, fk, **full)
        nbytes += 4 * b_ * cfg_.num_heads * TRAIN_SEQ  # lse
        fms, fby = bound(nbytes, ops)
        bms, bby = (bound(nbytes, ops, "bf16_tensor", FLASH_SPLIT[design])
                    if design in FLASH_SPLIT else (fms, fby))
        ms = timer.ms(lambda: fa_k.flash_attention_lse(fq, fk, fv, **kw))
        flash_shapes[cell] = {
            "q": list(fq.shape), "kv": list(fk.shape), "kv_dtype": "float32", **kw,
            "design": design + " (+ lse)", "max_abs_err": err,
            "one_key_off_max_abs_err": one_key_off, "repeat_bit_equal": repeat_equal, "ms": ms,
            "plain_ms": timer.ms(lambda: fa_r.attention_lse_ref(fq, fk, fv, **kw)),
            "bound_ms": bms, "bound_by": bby, "share_of_bound": bms / ms,
            "bound_fp32_ms": fms, "bound_fp32_by": fby, "share_of_fp32_bound": fms / ms,
            "bytes": nbytes, "operations": ops,
            "library_ms": timer.ms(sdpa_call(torch, fq, fk, fv, **full)),
        }
        if cell != "h2o_hd120":
            del fq, fk, fv
            torch.cuda.empty_cache()
            continue
        # h2o-danube's hd 120 through the bf16 prefill and the decode designs
        hd120["flash_wgmma_split"] = err
        for design, tq in (("flash_wgmma", TRAIN_SEQ), ("flash_decode", 1)):
            kw = dict(causal=True, window=window, q_offset=TRAIN_SEQ - tq, kv_len=TRAIN_SEQ)
            kk, vv = fk.to(torch.bfloat16), fv.to(torch.bfloat16)
            qq = fq[:, -tq:]
            hd120[design] = flash_err(fa_k.flash_attention(qq, kk, vv, **kw),
                                      fa_r.attention_ref(qq, kk, vv, **kw))
            if tq == 1:
                continue
            nbytes, ops = flash_work(torch, qq, kk, **kw)
            bms, bby = bound(nbytes, ops, "bf16_tensor", FLASH_SPLIT[design])
            ms = timer.ms(lambda: fa_k.flash_attention(qq, kk, vv, **kw))
            flash_shapes[f"h2o_hd120_{design}"] = {
                "q": list(qq.shape), "kv": list(kk.shape), "kv_dtype": "bfloat16", **kw,
                "design": design, "max_abs_err": hd120[design], "ms": ms,
                "plain_ms": timer.ms(lambda: fa_r.attention_ref(qq, kk, vv, **kw)),
                "bound_ms": bms, "bound_by": bby, "share_of_bound": bms / ms,
                "bytes": nbytes, "operations": ops,
                "library_ms": timer.ms(sdpa_call(torch, qq, kk, vv, **kw)),
            }
        del fq, fk, fv, kk, vv, qq
        torch.cuda.empty_cache()
    kernels["flash_attention"] = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:31",
        **flash_shapes["prefill_local"],
        "max_abs_err": max(sh["max_abs_err"] for sh in flash_shapes.values()),
        "shapes": flash_shapes,
    }
    emit({"phase": "kernel", **kernels["flash_attention"], "small_checks_max_abs_err": small,
          "hd120_max_abs_err": hd120, "tol": FLASH_TOL})
    del kv_copies, q_prefill, q_decode, q_small
    torch.cuda.empty_cache()

    # -- 6. flash attention backward at the training path's shapes ---------------
    kernels["flash_attention_bwd"] = flash_bwd_phase(torch, gen, timer, configs, fa_k, fa_r)
    emit({"phase": "kernel", **kernels["flash_attention_bwd"]})
    del timer
    torch.cuda.empty_cache()

    # -- 7. serve: generate on gemma3-4b at full width ---------------------------
    from repro_torch.models import api
    from repro_torch.serve import serve_step

    # the reference's float32 products; PyTorch's default, stated
    torch.backends.cuda.matmul.allow_tf32 = False
    sgen = torch.Generator(device=dev)
    sgen.manual_seed(args.seed)
    t0 = time.perf_counter()
    params = api.init_params(scfg, sgen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.randint(0, scfg.vocab_size, (SERVE_B, SERVE_PROMPT), generator=sgen,
                            device=dev, dtype=torch.int32)
    batch = {"tokens": prompts}
    # the counted run is the timed run: each step's tokens reach the host as
    # a server streams them, and its logits are kept for serve_check
    step_logits, arrivals = [], []

    def on_step(tok, logits):
        tok.cpu()
        arrivals.append(time.perf_counter())
        step_logits.append(logits)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(hp_k, jp_k, sr_k, fa_k)
    t0 = time.perf_counter()
    toks, _ = serve_step.generate(scfg, params, batch, SERVE_NEW, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counters(hp_k, jp_k, sr_k, fa_k)
    peak = torch.cuda.max_memory_allocated()
    want = layers + (SERVE_NEW - 1) * layers
    if got["flash_attention"] != want:
        fail(f"serve launched flash_attention {got['flash_attention']} times, want {want}")
    for name, c in got.items():
        launches.setdefault(name, {})["serve"] = c
    ttft = arrivals[0] - t0
    gaps = [b - a for a, b in zip(arrivals, arrivals[1:])]
    decode_s = arrivals[-1] - arrivals[0]
    emit({"phase": "serve", "arch": SERVE_ARCH, "params": scfg.param_count(), "B": SERVE_B,
          "prompt": SERVE_PROMPT, "new": SERVE_NEW, "init_s": init_s, "wall_s": wall,
          "ttft_s": ttft, "prefill_tokens_per_s": SERVE_B * SERVE_PROMPT / ttft,
          "decode_ms_per_step": decode_s / (SERVE_NEW - 1) * 1e3,
          "token_gap_ms_median": statistics.median(gaps) * 1e3,
          "token_gap_ms_max": max(gaps) * 1e3,
          "decode_tokens_per_s": SERVE_B * (SERVE_NEW - 1) / decode_s,
          "peak_mem_bytes": peak, "launches": got, "tokens_req0": toks[0].tolist()})
    emit({"phase": "trace", "cell": "serve", **trace(
        torch, lambda: serve_step.generate(scfg, params, batch, SERVE_NEW))})
    torch.cuda.empty_cache()

    # -- 8. serve_check ----------------------------------------------------------
    # (a) request 0's prompt + generated tokens through the cache-free
    # forward: position 4095 + i holds step i's logits (0 = prefill)
    with torch.inference_mode():
        full, _ = api.logits_fn(scfg, params, {"tokens": torch.cat([prompts[:1], toks[:1]], 1)})
        tf = full[0, SERVE_PROMPT - 1: SERVE_PROMPT - 1 + SERVE_NEW].clone()
        del full
    cached = torch.stack([lg[0] for lg in step_logits])
    err_a = (cached - tf).abs()
    if not bool((err_a <= SERVE_LOGIT_TOL + SERVE_LOGIT_TOL * tf.abs()).all()):
        fail(f"cached logits differ from the teacher-forced forward: {float(err_a.max())}")
    argmax_ok = all(torch.equal(toks[:, i], lg.argmax(-1).to(torch.int32))
                    for i, lg in enumerate(step_logits))
    if not argmax_ok:
        fail("a greedy token is not the argmax of its step's logits")
    check_a = {"positions": SERVE_PROMPT + SERVE_NEW, "max_abs_err": float(err_a.max()),
               "tol": SERVE_LOGIT_TOL, "tokens_are_argmax": argmax_ok}
    del params, step_logits, cached, tf, err_a
    torch.cuda.empty_cache()
    # (b) reduced width, 6 layers (5 local + 1 global): the card against the
    # plain versions on the CPU from the same weights
    import dataclasses

    rcfg = scfg.reduced(num_layers=6)
    rparams = api.init_params(rcfg, sgen, device=dev)
    rparams_cpu = {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict) else v.cpu())
                   for k, v in rparams.items()}
    rprompt = torch.randint(0, rcfg.vocab_size, (2, 160), generator=sgen, device=dev,
                            dtype=torch.int32)
    check_b = {}
    # stock bfloat16 config through generate (bfloat16 cache)
    lg_card, lg_cpu = [], []
    t_card, _ = serve_step.generate(rcfg, rparams, {"tokens": rprompt}, 16,
                                    on_step=lambda _, lg: lg_card.append(lg))
    t_cpu, _ = serve_step.generate(rcfg, rparams_cpu, {"tokens": rprompt.cpu()}, 16,
                                   on_step=lambda _, lg: lg_cpu.append(lg))
    if not torch.equal(t_card.cpu(), t_cpu):
        fail(f"reduced generate: card tokens {t_card.tolist()} != CPU {t_cpu.tolist()}")
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(lg_card, lg_cpu))
    if err > SERVE_LOGIT_TOL:
        fail(f"reduced generate: card logits differ from the CPU's by {err}")
    check_b["bfloat16_generate"] = {"max_abs_err": err, "tol": SERVE_LOGIT_TOL, "tokens": True}
    # float32 compute and a float32 cache: nothing rounds to bfloat16
    fcfg = dataclasses.replace(rcfg, dtype="float32")

    def steps(p, prompt, device):
        out_t, out_l = [], []
        with torch.inference_mode():
            st = api.init_decode_state(fcfg, 2, 176, torch.float32, device=device)
            lg, st = api.prefill_fn(fcfg, p, {"tokens": prompt}, st)
            for _ in range(16):
                t = serve_step.greedy_sample(lg)
                out_t.append(t.cpu())
                out_l.append(lg[:, -1].cpu())
                lg, st = api.decode_fn(fcfg, p, t, st)
        return torch.cat(out_t, 1), out_l

    f_card, fl_card = steps(rparams, rprompt, dev)
    f_cpu, fl_cpu = steps(rparams_cpu, rprompt.cpu(), torch.device("cpu"))
    if not torch.equal(f_card, f_cpu):
        fail("reduced float32 steps: card tokens differ from the CPU's")
    err = max(float((a - b).abs().max()) for a, b in zip(fl_card, fl_cpu))
    if any(not torch.allclose(a, b, atol=REDUCED_F32_TOL, rtol=REDUCED_F32_TOL)
           for a, b in zip(fl_card, fl_cpu)):
        fail(f"reduced float32 steps: card logits differ from the CPU's by {err}")
    check_b["float32_steps"] = {"max_abs_err": err, "tol": REDUCED_F32_TOL, "tokens": True}
    emit({"phase": "serve_check", "full_width": check_a, "reduced": check_b})
    del rparams, rparams_cpu
    torch.cuda.empty_cache()

    # -- 9. train: minicpm-2b at full width and depth ---------------------------
    train_phase(torch, args.seed, launches, hp_k, jp_k, sr_k, fa_k)
    torch.cuda.empty_cache()

    # -- 10. train_check ----------------------------------------------------------
    emit({"phase": "train_check", **train_check_phase(torch, args.seed)})
    torch.cuda.empty_cache()

    # the summary: one row per kernel, and for flash attention one per design
    # the main path runs, each at its main-path shape (the designs off the
    # path, flash_tiled and bwd_wide, are in the phase lines)
    summary = {name: kernels[name] for name in ("hash_partition", "join_probe", "segment_reduce")}
    fa, bwd = kernels["flash_attention"], kernels["flash_attention_bwd"]
    for design, shape in (("flash_wgmma", "prefill_local"), ("flash_decode", "decode"),
                          ("flash_wgmma_split", "train_fwd")):
        summary[f"flash_attention/{design}"] = {**fa, **fa["shapes"][shape],
                                                "name": f"flash_attention/{design}"}
    summary["flash_attention_bwd/bwd_wgmma"] = {**bwd, "name": "flash_attention_bwd/bwd_wgmma"}
    for name, row in summary.items():
        by_path = launches.get(name, {})
        if sum(by_path.values()) <= 0:
            fail(f"kernel {name} was not launched on the main path")
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    emit({"phase": "launches", **launches})

    keys_out = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi_line(), flush=True)
    emit({"kernels": [{k: row[k] for k in keys_out} for row in summary.values()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
