#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each:

1. device  — the card's name and power limit (``nvidia-smi``), and the time
   to build the hand-written kernels from ``src/repro_torch/kernels/csrc``.
2. kernels — each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it (hash_partition at the join's and the
   groupby's shuffle, segment_reduce at groupby_agg's three calls), with its
   time (CUDA events, median of repeats, L2 flushed before each repeat; the
   hash kernel, well under 0.1 ms, timed as 8-16 launches back to back per
   event pair), the plain version's time, one PyTorch library call's time
   where one computes the same function, and the bound: the larger of bytes
   moved over 3.35 TB/s and operations over 67 TFLOP/s (H100 SXM data
   sheet).  The summary line carries one shape per kernel; the ``kernel``
   lines carry every shape.
3. join    — ``ops_dist.sim_join`` at the paper's weak-scaling size: P = 8
   simulated workers on the one card, 9.1M rows per worker per side
   (``benchmarks/scaling_join.py`` WEAK_ROWS), checked row by row against
   numpy.
4. groupby — ``ops_dist.sim_groupby`` at the paper's §IV-C size: P = 4
   workers x 50M rows over 1000 groups, ``{"v": "sum"}``, combiner on and
   off, checked against ``np.bincount``.

After each of those three runs, a ``trace`` line: one more run of the same
cell under ``torch.profiler``, with the device's busy time, its idle share
of the wall and the device ops that took longest.

The launch counters of every kernel are set to 0 just before each of the
two main-path runs (join, groupby) and read just after; a kernel of the path
that did not launch fails the run.  Then the kernels' summary line, and as
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
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores

JOIN_P, JOIN_ROWS = 8, int(9.1e6)            # benchmarks/scaling_join.py:50
GROUPBY_P, GROUPBY_ROWS, GROUPS = 4, int(50e6), 1000  # benchmarks/groupby_scaling.py:16-17
SIZE_CUTS: list[str] = []  # none: both paths run at the paper's sizes

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
    of the inputs, so each launch still reads its inputs from HBM."""

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
            start.record()
            for fn in fns:
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / len(fns))
        return statistics.median(times)


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def counters(hp_k, jp_k, sr_k) -> dict[str, int]:
    return {
        "hash_partition": hp_k.launches,
        "join_probe": jp_k.launches,
        "segment_reduce": sr_k.launches,
    }


def reset_counters(hp_k, jp_k, sr_k) -> None:
    hp_k.launches = hp_k.single_launches = 0
    jp_k.launches = 0
    sr_k.launches = 0


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
    if not (torch.equal(hit_k, hit_p) and torch.equal(i_k[hit_k], i_p[hit_p])):
        fail("join_probe differs from the plain version")
    steps = max(1, page.bit_length())
    bms, bby = bound(4 * page + 4 * page + 4 * page + page, page * steps)
    kernels["join_probe"] = {
        "name": "join_probe", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/join_probe.cu",
        "replaces": "src/repro/kernels/join_probe/kernel.py:23",
        "max_abs_err": int((i_k[hit_k] - i_p[hit_p]).abs().max()) if bool(hit_k.any()) else 0,
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

    launches = {name: {} for name in kernels}

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
    reset_counters(hp_k, jp_k, sr_k)
    t0 = time.perf_counter()
    out = ops_dist.sim_join(left, right, "k", comm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counters(hp_k, jp_k, sr_k)
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
        reset_counters(hp_k, jp_k, sr_k)
        t0 = time.perf_counter()
        out = ops_dist.sim_groupby(tables, "k", {"v": "sum"}, comm, combine=combine)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counters(hp_k, jp_k, sr_k)
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
