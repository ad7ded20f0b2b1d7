#!/usr/bin/env python3
"""Variants of ``flash_wgmma<256, false>`` (the hd-256 forward on bf16 k/v,
every serving prefill): each is this checkout's ``src`` with one edit,
compiled side by side for ptxas's registers and spilled bytes, and the two
that spill least (with ``tn32`` when it is not among them) timed against the
given trees on the hd-256 rows.

    python3 scripts/torch_flash_fwd_variants.py [TREE ...] [--no-time]

TREE: ``src`` directories of other builds (a parent from ``git archive``),
timed before and after the variants: TREE ... variants ... variants reversed
... TREE reversed, in one call (``scripts/torch_flash_bwd_bench.py --only
fwd``, whose lines follow).  The variants live under
``build/fwd_variants/<name>/`` (git-ignored); one JSON line each: its edit,
nvcc's exit code and, per ``flash_wgmma`` instance, registers and spill
stores / loads (bytes).  Then the SASS places of ``tn32``'s spills: each
local store or load with the counts of ``HGMMA``, ``MUFU.EX2`` and barriers
before it.  Needs ``nvcc`` (CUDA_HOME or /usr/local/cuda) and, to time, a
CUDA device.

Variants (the source's hd 256: 64-key tiles in two stages, each tile's P . V
16 columns of O at a time, two accumulators in turn):
``tn16``: as it is; ``tn32``: 32 columns; ``*_bounds``: a row's key bounds
made in the mask branch, not held across the loop; ``tn32_halves``: P . V
over each tile's two 32-key halves, the second's split fenced behind the
first's products; ``tn32_bn32``: 32-key tiles in four stages;
``tn32_guard``: the shared addresses behind the wgmma descriptors hidden
from the compiler on every tile; ``tn32_nocap`` / ``tn32_nomask`` (not
timed): the softcap / the mask branch left out, to see what each holds.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "fwd_variants"
CU = "repro_torch/kernels/csrc/flash_attention.cu"
PLAN = "repro_torch/kernels/csrc/attn_plan.h"
ROWS = ("serve_prefill_local,serve_prefill_global,global_32k,global_32k_v_mean_1,griffin_local,"
        "griffin_decode,griffin_local_train_fwd,griffin_rank_train_fwd")
INSTANCE = "ILi256ELb0E"  # flash_wgmma<256, false> in the mangled names


def sub(a: str, b: str):
    def edit(s: str) -> str:
        if s.count(a) != 1:
            raise ValueError(f"the source changed: {a[:60]!r}")
        return s.replace(a, b)
    return edit


def chain(*edits):
    def edit(s: str) -> str:
        for e in edits:
            s = e(s)
        return s
    return edit


def same(s: str) -> str:
    return s


tn32 = sub("static constexpr int TN = HD == 256 ? 16 : HD < 64 ? HD : 64;",
           "static constexpr int TN = HD == 256 ? 32 : HD < 64 ? HD : 64;")
bounds = chain(
    sub("  int klo[2], khi[2];  // the keys each of the thread's two rows may see\n", ""),
    sub("#pragma unroll\n  for (int h = 0; h < 2; ++h)\n"
        "    key_bounds(a, a.q_offset + (m0 + r_lo + 8 * h) / a.groups, klo[h], khi[h]);\n", ""),
    sub("""      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = n0 + 8 * j + cq + e;
            float x = sc[4 * j + 2 * h + e];
            x = klo[h] <= kpos && kpos <= khi[h] ? x : kMask;
            sc[4 * j + 2 * h + e] = kpos < a.Tk ? x : -INFINITY;  // past Tk: not a key at all
          }
""", """      for (int h = 0; h < 2; ++h) {
        int klo, khi;
        key_bounds(a, a.q_offset + (m0 + r_lo + 8 * h) / a.groups, klo, khi);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = n0 + 8 * j + cq + e;
            float x = sc[4 * j + 2 * h + e];
            x = klo <= kpos && kpos <= khi ? x : kMask;
            sc[4 * j + 2 * h + e] = kpos < a.Tk ? x : -INFINITY;  // past Tk: not a key at all
          }
      }
"""))
guard = chain(
    sub("    float sc[BN / 2];\n    wgmma_fence();",
        "    uint32_t q_base = s_q;\n    asm volatile(\"\" : \"+r\"(q_base));\n"
        "    float sc[BN / 2];\n    wgmma_fence();"),
    sub("gmma_desc(s_q + qa * C::Q_PART + col", "gmma_desc(q_base + qa * C::Q_PART + col"),
    sub("        for (int i = 0; i < C::TN / 2; ++i) acc[c % 2][i] = 0.f;\n        wgmma_fence();",
        "        for (int i = 0; i < C::TN / 2; ++i) acc[c % 2][i] = 0.f;\n"
        "        uint32_t v_base = s_v;\n        asm volatile(\"\" : \"+r\"(v_base));\n"
        "        wgmma_fence();"),
    sub("gmma_desc(s_v + vb * C::KV_TILE", "gmma_desc(v_base + vb * C::KV_TILE"))
bn32 = chain(sub("return split && hd == 128 ? 32 : 64;",
                 "return (split && hd == 128) || hd == 256 ? 32 : 64;"),
             sub("return hd == 256 ? 2 :", "return hd == 256 ? 4 :"))
nocap = sub("    if (a.softcap > 0.f) {\n#pragma unroll\n"
            "      for (int i = 0; i < BN / 2; ++i) sc[i] = cap * tanhf(sc[i] / cap);\n    }\n", "")
nomask = sub("    if (n0 < in_lo || n0 + BN - 1 > in_hi) {", "    if (false) {")

HALVES = """    constexpr int NS = HD / C::TN;
    constexpr int KS = HD == 256 ? 2 : BN / 16;  // 16-key steps a pass
#pragma unroll
    for (int pv = 0; pv < BN / 16 / KS; ++pv) {
      if (pv > 0) {  // this pass's p after the last pass's products
#pragma unroll
        for (int i = 8 * KS * pv; i < 8 * KS * (pv + 1); ++i)
          asm volatile("" : "+f"(sc[i])::"memory");
      }
      uint32_t fr[KS][kParts][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int i = 8 * (pv * KS + kk) + 2 * f;
          split3(sc[i], sc[i + 1], fr[kk][0][f], fr[kk][1][f], fr[kk][2][f]);
        }
      float acc[2][C::TN / 2];
#pragma unroll
      for (int c = 0; c <= NS; ++c) {
        if (c < NS) {
#pragma unroll
          for (int i = 0; i < C::TN / 2; ++i) acc[c % 2][i] = 0.f;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
#pragma unroll
            for (int p = 0; p < C::NPROD; ++p) {
              const int pa = SPLIT ? pair_a(p) : p, vb = SPLIT ? pair_b(p) : 0;
              const uint32_t col = (c * C::TN / C::ATOM) * C::KV_ATOM + (c * C::TN % C::ATOM) * 2;
              wgmma_rs<C::TN>(acc[c % 2], fr[kk][pa],
                              gmma_desc(s_v + vb * C::KV_TILE + col + (pv * KS + kk) * 16 * C::SW,
                                        C::KV_ATOM, 8 * C::SW, C::LAYOUT));
            }
          wgmma_commit();
        }
        const int d = c - 1;
        if (d >= 0) {
          if (c < NS) {
            wgmma_wait<1>();
          } else {
            wgmma_wait<0>();
          }
          fence_regs(acc[d % 2]);
#pragma unroll
          for (int i = 0; i < C::TN / 2; ++i) o[d * C::TN / 2 + i] += acc[d % 2][i];
        }
      }
    }
"""


def halves(s: str) -> str:
    """P . V over 32-key passes: the block from p's split to the last add."""
    start = s.index("    uint32_t fr[BN / 16][kParts][4];")
    end = s.index("    mbar_arrive(bar_empty + 8 * s);\n", start)
    return s[:start] + HALVES + s[end:]


# name -> (edit of flash_attention.cu, edit of attn_plan.h), in the order of
# preference among equal spills
VARIANTS = {
    "tn16": (same, same), "tn16_bounds": (bounds, same),
    "tn32": (tn32, same), "tn32_bounds": (chain(tn32, bounds), same),
    "tn32_halves": (chain(tn32, halves), same),
    "tn32_halves_bounds": (chain(tn32, halves, bounds), same),
    "tn32_bn32": (tn32, bn32), "tn32_bn32_bounds": (chain(tn32, bounds), bn32),
    "tn32_guard": (chain(tn32, guard), same),
    "tn32_nocap": (chain(tn32, nocap), same), "tn32_nomask": (chain(tn32, nomask), same),
}
UNTIMED = ("tn32_nocap", "tn32_nomask")


def nvcc() -> str:
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def ptxas(log: str) -> dict:
    """Per flash_wgmma instance (its template arguments, mangled): registers,
    spill stores and loads in bytes."""
    out, fn = {}, None
    for line in log.splitlines():
        m = (re.search(r"Compiling entry function '(\S+)'", line)
             or re.search(r"Function properties for (\S+)", line))
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            out.setdefault(fn, {}).update(spill_st=int(m.group(1)), spill_ld=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.setdefault(fn, {})["registers"] = int(m.group(1))
    return {k.split("flash_wgmma")[1][:12]: v for k, v in out.items() if "flash_wgmmaILi" in k}


def build(name: str) -> dict:
    e_cu, e_plan = VARIANTS[name]
    dst = OUT / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src", dst / "src", ignore=shutil.ignore_patterns("__pycache__"))
    for rel, e in ((CU, e_cu), (PLAN, e_plan)):
        f = dst / "src" / rel
        f.write_text(e(f.read_text()))
    r = subprocess.run([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c", str(dst / "src" / CU),
                        "-o", str(dst / "fa.o")], capture_output=True, text=True)
    (dst / "ptxas.log").write_text(r.stdout + r.stderr)
    return {"variant": name, "nvcc_rc": r.returncode, "flash_wgmma": ptxas(r.stdout + r.stderr)}


def spill_places(obj: Path) -> dict:
    """Where the local stores and loads of flash_wgmma<256, false> lie in its
    SASS: each with the HGMMA, MUFU.EX2 and BAR counts before it."""
    sass = subprocess.run([str(Path(nvcc()).parent / "cuobjdump"), "-sass", str(obj)],
                          capture_output=True, text=True).stdout
    keep, marks, places = False, {"HGMMA": 0, "MUFU.EX2": 0, "BAR": 0}, []
    for line in sass.splitlines():
        if "Function :" in line:
            keep = INSTANCE in line
        if not keep:
            continue
        for k in marks:
            marks[k] += k in line
        if "STL" in line or "LDL" in line:
            places.append({"op": line.split(";")[0].split("*/")[-1].strip(), **marks})
    return {"local_ops": len(places), "places": places}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="src directories timed around the variants")
    ap.add_argument("--no-time", action="store_true")
    args = ap.parse_args()
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        built = list(ex.map(build, VARIANTS))
    spill = {}
    for b in built:
        print(json.dumps(b), flush=True)
        inst = b["flash_wgmma"].get(INSTANCE + "E")
        if b["nvcc_rc"] == 0 and inst is not None:
            spill[b["variant"]] = inst.get("spill_st", 0)
    if "tn32" in spill:
        print(json.dumps({"variant": "tn32", **spill_places(OUT / "tn32" / "fa.o")}), flush=True)
    timed = sorted((n for n in spill if n not in UNTIMED),
                   key=lambda n: (spill[n], list(VARIANTS).index(n)))[:2]
    timed += ["tn32"] if "tn32" in spill and "tn32" not in timed else []
    print(json.dumps({"spill_st": spill, "timed": timed}), flush=True)
    if args.no_time:
        return 0
    trees = list(args.trees) + [str(OUT / n / "src") for n in timed]
    return subprocess.run([sys.executable, str(ROOT / "scripts" / "torch_flash_bwd_bench.py"),
                           *trees, *trees[::-1], "--only", "fwd", "--shapes", ROWS]).returncode


if __name__ == "__main__":
    sys.exit(main())
