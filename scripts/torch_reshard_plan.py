#!/usr/bin/env python3
"""The GET plan of ``dist.checkpoint.restore_sharded`` for minicpm-2b's
full-width training state, priced on the CPU without any data.

    PYTHONPATH=src python scripts/torch_reshard_plan.py

The tree is ``chip_smoke.py``'s ``reshard`` phase's: float32 masters and
AdamW with int8 moments, on the meta device (``launch.shapes``).  For the
full restore (one GET a leaf) and for each shard the phase restores (every
model coord of the (1, 4) mesh of ``benchmarks/ckpt_store.py``; coords
(0, 0), (7, 11), (15, 15) of the 16 x 16 production mesh), one JSON line:
bytes, GETs and modeled seconds on ``netsim.S3_STAGED`` (the pooled
client's latency once per ``S3Store.request_pool`` ranged GETs), and their
shares of the full restore's.  The manifest's one GET is left out of every
figure.  The plan is ``restore_sharded``'s own (``_ranged_plan``):
replicated leaves and shards whose covering ranges would read the whole
leaf take one full GET; other shards their C-order runs merged down to
``_MAX_RANGED_GETS`` ranges.
"""

from __future__ import annotations

import json
import math

from repro_torch import configs
from repro_torch.core import netsim
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist import sharding, treepath
from repro_torch.dist.object_store import S3Store
from repro_torch.launch import mesh, shapes

ARCH = "minicpm-2b"
MESHES = (
    ("ckpt_store_1x4", {"data": 1, "model": 4}, [(0, m) for m in range(4)]),
    ("production_16x16", mesh.make_production_mesh(), [(0, 0), (7, 11), (15, 15)]),
)


def plan(leaves: list, specs: list | None, sizes: dict, coords: dict) -> dict:
    """Bytes, GETs and modeled seconds of one restore (``specs`` None: the
    full ``restore``, one unpooled GET a leaf)."""
    ch = netsim.S3_STAGED
    per_request = ch.alpha_s + ch.store_alpha_s
    nbytes, gets, seconds, seq = 0, 0, 0.0, 0
    for i, t in enumerate(leaves):
        shape, itemsize = tuple(t.shape), t.element_size()
        nelems = max(math.prod(shape), 1)
        if specs is None:
            nbytes += nelems * itemsize
            gets += 1
            seconds += per_request + nelems * itemsize * ch.beta_s_per_byte
            continue
        runs = ckpt._element_runs(shape, ckpt._shard_bounds(shape, specs[i], sizes, coords))
        ranges = ckpt._ranged_plan(shape, runs, ckpt._MAX_RANGED_GETS) or [(0, nelems)]
        for _, length in ranges:  # the pooled client: one round trip a pool width
            seconds += (per_request if seq % S3Store.request_pool == 0 else 0.0)
            seconds += length * itemsize * ch.beta_s_per_byte
            seq += 1
            nbytes += length * itemsize
            gets += 1
    return {"bytes": nbytes, "gets": gets, "modeled_s": seconds}


def main() -> None:
    cfg = configs.get(ARCH)
    tree = {"params": shapes.params_specs(cfg), "opt": shapes.opt_state_specs(cfg, "int8")}
    leaves = treepath.leaves(tree)
    full = plan(leaves, None, {}, {})
    print(json.dumps({"arch": ARCH, "restore": "full", "leaves": len(leaves), **full}))
    for name, m, coord_list in MESHES:
        sizes = ckpt._axis_sizes(m)
        specs = treepath.leaves(sharding.param_specs(cfg, tree, m))
        for d, mo in coord_list:
            got = plan(leaves, specs, sizes, {"data": d, "model": mo})
            print(json.dumps({"arch": ARCH, "restore": name, "coords": [d, mo], **got,
                              "bytes_share": got["bytes"] / full["bytes"],
                              "modeled_s_share": got["modeled_s"] / full["modeled_s"]}))


if __name__ == "__main__":
    main()
