"""The slice as a whole: the port's ``sim_join`` and ``sim_groupby`` against
the reference's on the CPU, plus the port's import hygiene.

Data is the quickstart's (``examples/quickstart.py``: 4096 orders x 2048
users, made with numpy from seed 0).  Rows per rank must match bit for bit,
in order, and the CommEvent logs must be identical: (kind, world,
bytes_per_rank, algo, time_s) with ``==``.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import make_communicator as j_make
from repro.dataframe import Table as JTable, ops_dist as j_dist
from repro_torch.core import make_communicator as t_make
from repro_torch.dataframe import ops_dist as t_dist
from repro_torch.interop import table_from_numpy, table_to_numpy

REPO = Path(__file__).resolve().parents[1]
ROWS = 4096


def quickstart_data():
    rng = np.random.default_rng(0)
    orders = {"order_id": rng.permutation(ROWS).astype(np.int32),
              "amount": rng.integers(1, 500, ROWS).astype(np.int32)}
    users = {"order_id": rng.permutation(ROWS).astype(np.int32)[: ROWS // 2],
             "user": rng.integers(0, 50, ROWS // 2).astype(np.int32)}
    joined = {"user": rng.integers(0, 50, ROWS).astype(np.int32),
              "amount": rng.integers(1, 500, ROWS).astype(np.int32),
              "score": rng.normal(size=ROWS).astype(np.float32)}
    return orders, users, joined


def shard(cols: dict, world: int) -> list[JTable]:
    per = len(next(iter(cols.values()))) // world
    return [JTable.from_dict({k: v[i * per:(i + 1) * per] for k, v in cols.items()}, capacity=ROWS)
            for i in range(world)]


def to_port(tables):
    return [table_from_numpy({k: np.asarray(v) for k, v in t.columns.items()}, int(t.count), "cpu")
            for t in tables]


def events(comm):
    return [(e.kind.value, e.world, e.bytes_per_rank, e.algo, e.time_s) for e in comm.events]


def assert_same_ranks(j_out, t_out):
    assert len(j_out) == len(t_out)
    for jt, tt in zip(j_out, t_out):
        cols, count = table_to_numpy(tt)
        assert count == int(jt.count)
        assert sorted(cols) == sorted(jt.columns)
        for k, v in jt.columns.items():
            np.testing.assert_array_equal(cols[k], np.asarray(v), err_msg=k)


@pytest.mark.parametrize("env", ["direct", "redis", "s3"])
@pytest.mark.parametrize("world", [1, 4, 8])
def test_sim_join_matches_reference(world, env):
    orders, users, _ = quickstart_data()
    left, right = shard(orders, world), shard(users, world)
    jc, tc = j_make(world, env), t_make(world, env)
    j_out = j_dist.sim_join(left, right, "order_id", jc)
    t_out = t_dist.sim_join(to_port(left), to_port(right), "order_id", tc)
    assert_same_ranks(j_out, t_out)
    assert sum(int(t.count) for t in t_out) == ROWS // 2
    assert events(tc) == events(jc)
    assert (tc.comm_time_s, tc.bytes_on_wire) == (jc.comm_time_s, jc.bytes_on_wire)


@pytest.mark.parametrize("combine", [True, False])
@pytest.mark.parametrize("env", ["direct", "redis", "s3"])
@pytest.mark.parametrize("world", [1, 4, 8])
def test_sim_groupby_matches_reference(world, env, combine):
    _, _, joined = quickstart_data()
    tables = shard({k: joined[k] for k in ("user", "amount")}, world)
    jc, tc = j_make(world, env), t_make(world, env)
    aggs = {"amount": "sum"}
    j_out = j_dist.sim_groupby(tables, "user", aggs, jc, combine=combine)
    t_out = t_dist.sim_groupby(to_port(tables), "user", aggs, tc, combine=combine)
    assert_same_ranks(j_out, t_out)
    assert events(tc) == events(jc)


@pytest.mark.parametrize("combine", [True, False])
def test_sim_groupby_every_agg(combine):
    _, _, joined = quickstart_data()
    tables = shard(joined, 4)
    aggs = {"amount": "count", "score": "max"}
    jc, tc = j_make(4, "direct"), t_make(4, "direct")
    j_out = j_dist.sim_groupby(tables, "user", aggs, jc, combine=combine)
    t_out = t_dist.sim_groupby(to_port(tables), "user", aggs, tc, combine=combine)
    assert_same_ranks(j_out, t_out)
    assert events(tc) == events(jc)
    mins = j_dist.sim_groupby(tables, "user", {"amount": "min"}, j_make(4), combine=combine)
    assert_same_ranks(
        mins, t_dist.sim_groupby(to_port(tables), "user", {"amount": "min"}, t_make(4), combine=combine)
    )


def test_compressed_wire_is_not_ported_yet():
    """Kept under its old name: ``compress=True`` used to raise here.  The
    codec is ported now, so the quickstart's compressed join and groupby
    must give the reference's rows per rank and its event log (wire and raw
    bytes included); ``tests/test_torch_codec.py`` covers the codec."""
    orders, users, joined = quickstart_data()
    jc, tc = j_make(2), t_make(2)
    j_out = j_dist.sim_join(shard(orders, 2), shard(users, 2), "order_id", jc, compress=True)
    t_out = t_dist.sim_join(to_port(shard(orders, 2)), to_port(shard(users, 2)), "order_id",
                            tc, compress=True)
    assert_same_ranks(j_out, t_out)
    jc2, tc2 = j_make(2), t_make(2)
    aggs = {"amount": "sum", "score": "max"}
    assert_same_ranks(
        j_dist.sim_groupby(shard(joined, 2), "user", aggs, jc2, compress=True),
        t_dist.sim_groupby(to_port(shard(joined, 2)), "user", aggs, tc2, compress=True))
    for t, j in ((tc, jc), (tc2, jc2)):
        assert events(t) == events(j)
        assert [e.raw_bytes for e in t.events] == [e.raw_bytes for e in j.events]
        assert t.bytes_on_wire < t.raw_bytes_on_wire


def test_interop_round_trip_keeps_padding():
    rng = np.random.default_rng(5)
    cols = {"k": rng.integers(0, 9, 12).astype(np.int32),
            "x": rng.normal(size=(12, 2)).astype(np.float32)}
    jt = JTable.from_dict({k: v[:7] for k, v in cols.items()}, capacity=12)
    jt = JTable({k: jnp.asarray(v) for k, v in cols.items()}, jt.count)  # garbage padding
    tt = table_from_numpy({k: np.asarray(v) for k, v in jt.columns.items()}, int(jt.count), "cpu")
    back, count = table_to_numpy(tt)
    assert count == 7
    for k in cols:
        np.testing.assert_array_equal(back[k], cols[k])
    tt.columns["k"].zero_()  # the port's table owns its storage
    np.testing.assert_array_equal(np.asarray(jt.columns["k"]), cols["k"])
    with pytest.raises(ValueError):
        table_from_numpy({"a": np.zeros(3), "b": np.zeros(4)}, 1, "cpu")
    with pytest.raises(ValueError):
        table_from_numpy({"a": np.zeros(3)}, 4, "cpu")


# ---------------------------------------------------------------------------
# hygiene
# ---------------------------------------------------------------------------


def _port_files():
    return sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_reference():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            bad += [f"{path.relative_to(REPO)}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert len(_port_files()) > 20
    assert bad == []


def test_importing_the_port_leaves_jax_unloaded():
    code = (
        "import sys, repro_torch, repro_torch.interop, repro_torch.core, repro_torch.dataframe;"
        "import repro_torch.kernels.hash_partition.kernel, repro_torch.kernels.join_probe.kernel,"
        " repro_torch.kernels.segment_reduce.kernel, repro_torch.kernels.flash_attention.kernel;"
        "import repro_torch.configs, repro_torch.models.api, repro_torch.serve.serve_step;"
        "import repro_torch.dist.sharding, repro_torch.launch.mesh, repro_torch.launch.shapes;"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
