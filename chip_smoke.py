#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each:

1. device  — the card's name and power limit (``nvidia-smi``), and the time
   to build the hand-written kernels from ``src/repro_torch/kernels/csrc``.
   Then a ``ptxas`` line (registers, static shared memory, spills of the
   redesigned kernels, from the build's ptxas report); the run fails
   unless the SASS of the prefill kernel (``cuobjdump -sass``) holds
   ``HGMMA`` (warpgroup tensor-core) instructions.
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
   products a design makes of each (3 for flash attention's three-part
   split).  The summary line carries one shape per kernel; the ``kernel``
   lines carry every shape.  join_probe's positions and hits must equal the
   plain version's on every row.
3. join    — ``ops_dist.sim_join`` at the paper's weak-scaling size: P = 8
   simulated workers on the one card, 9.1M rows per worker per side
   (``benchmarks/scaling_join.py`` WEAK_ROWS), checked row by row against
   numpy.
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
   rows with no valid key and a softcap at a small shape.  Both sides read
   the same k/v, so they differ only in the order of float32 sums: 2e-5
   for either k/v type; at each main-path shape the kernel must also fail
   that limit against the plain version given one key too few.
6. serve   — ``serve_step.generate`` on gemma3-4b at full width (random
   weights from ``--seed``, made on the card): B = 4 requests of 4096
   prompt tokens, 32 new tokens each, greedy.  The one run that is counted
   is also the one that is timed: each step's tokens are brought to the
   host as a server streams them, which gives the time to first token, the
   gaps between tokens (median, max) and decode tokens/s; plus its wall
   and peak device memory.  Fixed lengths: a smoke measurement, not a
   traffic mix.
7. serve_check — (a) a teacher-forced ``forward`` of request 0's prompt +
   generated tokens (no cache) against the prefill and every decode step's
   logits, and each greedy token against its step's argmax; (b) a reduced
   gemma3-4b (6 layers, one global) on the card against the plain versions
   on the CPU from the same weights.

After each of the join, groupby and serve runs, a ``trace`` line: one more
run of the same cell under ``torch.profiler``, with the device's busy time,
its idle share of the wall and the device ops that took longest.

The launch counters of every kernel are set to 0 just before each of the
main-path runs (join, groupby, serve) and read just after; a kernel of the
path that did not launch, or a serve run without exactly 34 + 31 x 34
flash-attention launches, fails the run.  Then the kernels' summary line, and as
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
FLASH_SPLIT = 3            # bf16 products per float32 product in flash_wgmma

JOIN_P, JOIN_ROWS = 8, int(9.1e6)            # benchmarks/scaling_join.py:50
GROUPBY_P, GROUPBY_ROWS, GROUPS = 4, int(50e6), 1000  # benchmarks/groupby_scaling.py:16-17
SERVE_ARCH, SERVE_B, SERVE_PROMPT, SERVE_NEW = "gemma3-4b", 4, 4096, 32
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


def trace(torch, fn, top: int = 8) -> dict:
    """One more run of ``fn`` under ``torch.profiler``: its host wall, the
    device's busy time (the union of kernel, memcpy and memset intervals),
    the idle share of the wall, and the device ops that took longest."""
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
    return {"wall_s": wall, "device_ops": len(spans), "device_busy_s": busy_us / 1e6,
            "idle_share": 1.0 - busy_us / 1e6 / wall,
            "top_ms": [[name, ms, n] for name, (ms, n) in ranked]}


def counters(hp_k, jp_k, sr_k, fa_k) -> dict[str, int]:
    return {
        "hash_partition": hp_k.launches,
        "join_probe": jp_k.launches,
        "segment_reduce": sr_k.launches,
        "flash_attention": fa_k.launches,
    }


def reset_counters(hp_k, jp_k, sr_k, fa_k) -> None:
    hp_k.launches = hp_k.single_launches = 0
    jp_k.launches = 0
    sr_k.launches = 0
    fa_k.launches = 0


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
        "flash_wgmma", "flash_decode", "probe_kernel", "build_index")}})
    hgmma = sass_has(_build.build(), "flash_wgmma", "HGMMA")
    if not hgmma or not all(hgmma.values()):
        fail(f"flash_wgmma's SASS holds no HGMMA (tensor-core) instruction: {hgmma}")

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

    launches = {name: {} for name in (*kernels, "flash_attention")}

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
        launches[name]["join"] = c
    if got["hash_partition"] < 2 * p or got["join_probe"] != p:
        fail(f"join launches {got}: want hash >= {2 * p}, probe == {p}")
    emit({"phase": "trace", "cell": "join", **trace(
        torch, lambda: ops_dist.sim_join(left, right, "k", make_communicator(p, "direct")))})
    del left, right

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
    del out, v_of, w_of, seen, lk_h, rk_h, lv_h, rw_h
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
            launches[name][run] = c
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
        bms, bby = (bound(nbytes, ops, "bf16_tensor", FLASH_SPLIT) if prefill
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
    kernels["flash_attention"] = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:31",
        **flash_shapes["prefill_local"],
        "max_abs_err": max(sh["max_abs_err"] for sh in flash_shapes.values()),
        "shapes": flash_shapes,
    }
    emit({"phase": "kernel", **kernels["flash_attention"], "small_checks_max_abs_err": small,
          "tol": FLASH_TOL})
    del timer, kv_copies, q_prefill, q_decode, q_small, ks, vs
    torch.cuda.empty_cache()

    # -- 6. serve: generate on gemma3-4b at full width ---------------------------
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
        launches[name]["serve"] = c
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

    # -- 7. serve_check ----------------------------------------------------------
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

    for name, by_path in launches.items():
        total = sum(by_path.values())
        if total <= 0:
            fail(f"kernel {name} was not launched on the main path")
        kernels[name]["launches"] = total
        kernels[name]["launches_by_path"] = by_path

    keys_out = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi_line(), flush=True)
    emit({"kernels": [{k: kernels[name][k] for k in keys_out} for name in kernels]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
