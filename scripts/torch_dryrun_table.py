"""The port's dry-run records beside the reference's, as markdown.

    PYTHONPATH=src python scripts/torch_dryrun_table.py [--cells]

Reads ``experiments/dryrun_torch/*.json`` (one rank of each cell of the
16 x 16 mesh, traced by ``python -m repro_torch.launch.dryrun --all``) and
the reference's ``experiments/dryrun/*.json``.  One row per arch, one
column per shape: the port's FLOPs a device and their ratio to the
reference's compiled ``roofline.flops_per_device``, then the port's peak
estimate against the reference's compiled peak (GB).  ``--cells`` prints
one row per cell with the wire bytes, argument bytes and the H100 roofline
terms too.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def load() -> dict:
    out = {}
    for path in sorted((REPO / "experiments" / "dryrun_torch").glob("*.json")):
        port = json.loads(path.read_text())
        ref = json.loads((REPO / "experiments" / "dryrun" / path.name).read_text())
        out[(port["arch"], port["shape"])] = (port, ref)
    return out


def gb(n: float) -> str:
    return f"{n / 1e9:.1f}"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", action="store_true")
    args = ap.parse_args()
    recs = load()
    archs = list(dict.fromkeys(a for a, _ in recs))
    if not args.cells:
        print("| arch | " + " | ".join(SHAPES) + " |")
        print("|---|" + "---|" * len(SHAPES))
        for arch in archs:
            row = []
            for shape in SHAPES:
                port, ref = recs[(arch, shape)]
                if port["status"] != "ok":
                    row.append("skipped")
                    continue
                f, rf = port["cost_analysis"]["flops"], ref["roofline"]["flops_per_device"]
                row.append(f"{f:.2e} ({f / rf:.1f}x); "
                           f"{gb(port['memory_analysis']['peak_bytes_per_device'])} / "
                           f"{gb(ref['memory_analysis']['peak_bytes_per_device'])}")
            print(f"| {arch} | " + " | ".join(row) + " |")
        return
    print("| cell | FLOPs (ref) | wire GB (ref) | args B (ref) | peak GB (ref) | "
          "H100 compute / memory / collective s |")
    print("|---|---|---|---|---|---|")
    for (arch, shape), (port, ref) in recs.items():
        if port["status"] != "ok":
            continue
        r = port["roofline"]
        print(f"| {arch} {shape} | {port['cost_analysis']['flops']:.3e} "
              f"({ref['roofline']['flops_per_device']:.3e}) | "
              f"{gb(port['collectives']['wire_bytes'])} ({gb(ref['collectives']['wire_bytes'])}) | "
              f"{port['memory_analysis']['argument_size_bytes']:,} "
              f"({ref['memory_analysis']['argument_size_bytes']:,}) | "
              f"{gb(port['memory_analysis']['peak_bytes_per_device'])} "
              f"({gb(ref['memory_analysis']['peak_bytes_per_device'])}) | "
              f"{r['compute_s']:.3g} / {r['memory_s']:.3g} / {r['collective_s']:.3g} |")


if __name__ == "__main__":
    main()
