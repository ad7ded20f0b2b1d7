"""The port's columnar wire codec (``repro_torch.dist.compression``), its
``Communicator.compressed_alltoallv`` and ``compress=True`` on ``sim_join`` /
``sim_groupby`` against the reference, mirroring the compressed cases of
``tests/test_dataframe.py`` and the codec part of ``tests/test_dist.py``.

The same numpy columns go through both codecs (the port's as CPU tensors):
every kind (raw, narrow at each width, dict, int8), the wire and raw bytes
and the decoded values are equal, at the int32 and int64 extremes too.  The
compressed shuffles give the reference's rows per rank, in order, and its
event log, wire and raw bytes included.
"""

import numpy as np
import pytest
import torch

from repro.core import make_communicator as j_make
from repro.dataframe import Table as JTable, ops_dist as j_dist
from repro.dist import compression as j_codec
from repro_torch.core import make_communicator as t_make
from repro_torch.core import communicator as t_comm
from repro_torch.dataframe import ops_dist as t_dist
from repro_torch.dist import compression as t_codec
from repro_torch.interop import table_from_numpy, table_to_numpy

I32, I64 = np.iinfo(np.int32), np.iinfo(np.int64)
RNG = np.random.default_rng(0)

COLUMNS = {
    "empty_i32": np.array([], np.int32),
    "one_i32": np.array([7], np.int32),
    "i32_extremes": np.array([I32.min, I32.max, 0, -1], np.int32),
    "i32_near_min": np.array([I32.min, I32.min + 200, I32.min + 3] * 50, np.int32),
    "i32_near_max": np.array([I32.max, I32.max - 60000] * 40, np.int32),
    "i32_u16_span": (I32.max - RNG.integers(0, 60000, 2000)).astype(np.int32),
    "i32_wide_few": np.array([I32.min, 0, I32.max] * 300, np.int32),
    "i32_random": RNG.integers(I32.min, I32.max, 2000, dtype=np.int64).astype(np.int32),
    "i32_small": RNG.integers(0, 5, 1000).astype(np.int32),
    "i64_extremes": np.array([I64.min, I64.max, 0], np.int64),
    "i64_near_min": np.array([I64.min, I64.min + 5, I64.min + 255] * 20, np.int64),
    "i64_near_max": np.array([I64.max, I64.max - 65535, I64.max - 7] * 30, np.int64),
    "i64_span_u32": np.array([I64.min, I64.min + 2**32 - 1] * 10, np.int64),
    "i64_wide_few": np.array([I64.min, -1, I64.max] * 400, np.int64),
    "i64_range": np.arange(70000, dtype=np.int64) * 3 - 10**12,
    "i16": RNG.integers(-300, 300, 500).astype(np.int16),
    "i8": RNG.integers(-128, 127, 300).astype(np.int8),
    "f32": (RNG.normal(size=300) * 40).astype(np.float32),
    "f32_block": (RNG.normal(size=256)).astype(np.float32),
    "f32_zeros": np.zeros(130, np.float32),
    "f64": RNG.normal(size=77),
    "bool": RNG.integers(0, 2, 40).astype(bool),
}


def enc_row(enc):
    return (enc.kind, enc.count, enc.origin, enc.wire_nbytes, enc.raw_nbytes,
            sorted(enc.parts), [tuple(v.shape) for _, v in sorted(enc.parts.items())])


def as_np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("name", list(COLUMNS))
def test_encode_decode_column_equal(name, exact):
    col = COLUMNS[name]
    j = j_codec.encode_column(col, exact=exact)
    t = t_codec.encode_column(torch.from_numpy(col.copy()), exact=exact)
    assert enc_row(t) == enc_row(j)
    for part, v in j.parts.items():
        got = as_np(t.parts[part])
        assert got.dtype == v.dtype, part
        np.testing.assert_array_equal(got, v, err_msg=part)
    dj, dt = j_codec.decode_column(j), as_np(t_codec.decode_column(t))
    assert dt.dtype == dj.dtype
    np.testing.assert_array_equal(dt, dj)
    if j.kind != "int8":
        np.testing.assert_array_equal(dt, col)


def test_every_kind_and_width_is_covered():
    kinds = set()
    for col in COLUMNS.values():
        enc = t_codec.encode_column(torch.from_numpy(col.copy()), exact=False)
        kinds.add((enc.kind, str(next(iter(enc.parts.values())).dtype)
                   if enc.kind in ("narrow", "dict") else ""))
    assert {k for k, _ in kinds} == {"raw", "narrow", "dict", "int8"}
    assert {w for k, w in kinds if k == "narrow"} >= {"torch.uint8", "torch.uint16",
                                                       "torch.uint32"}


def test_narrow_dtype_and_errors_equal():
    for spread in (0, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, 2**64):
        j, t = j_codec._narrow_dtype(spread), t_codec._narrow_dtype(spread)
        assert (None if j is None else j.itemsize) == (None if t is None else t.itemsize)
    for m, arr in ((j_codec, np.zeros((2, 2))), (t_codec, torch.zeros(2, 2))):
        with pytest.raises(ValueError, match="1-D"):
            m.encode_column(arr, exact=True)
        with pytest.raises(ValueError, match="ragged"):
            m.encode_block({"a": arr[0], "b": arr[0][:1]}, {"a"})
    with pytest.raises(ValueError, match="unknown encoding"):
        t_codec.decode_column(t_codec.EncodedColumn("zstd", torch.int32, 0, {}))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_block_equal(seed):
    rng = np.random.default_rng(seed)
    cols = {"k": rng.integers(-(2**31), 2**31 - 1, 300).astype(np.int32),
            "v": (rng.normal(size=300) * 9).astype(np.float32),
            "g": rng.integers(0, 3, 300).astype(np.int32)}
    j = j_codec.encode_block(cols, {"k"})
    t = t_codec.encode_block({n: torch.from_numpy(c) for n, c in cols.items()}, {"k"})
    assert (t.count, t.wire_nbytes, t.raw_nbytes) == (j.count, j.wire_nbytes, j.raw_nbytes)
    assert {n: enc_row(c) for n, c in t.columns.items()} == \
        {n: enc_row(c) for n, c in j.columns.items()}
    dj, dt = j_codec.decode_block(j), t_codec.decode_block(t)
    for n in cols:
        np.testing.assert_array_equal(as_np(dt[n]), dj[n])


# -- the compressed alltoallv ----------------------------------------------------

def _blocks(codec, world, make):
    rng = np.random.default_rng(world)
    return [[codec.encode_block({"k": make(rng.integers(0, 50 * (s + d + 1), 20 + 3 * d)
                                           .astype(np.int32))}, {"k"})
             for d in range(world)] for s in range(world)]


@pytest.mark.parametrize("env", ["direct", "redis", "s3"])
@pytest.mark.parametrize("world", [1, 3, 4, 8])
def test_compressed_alltoallv_events_equal(world, env):
    jc, tc = j_make(world, env), t_make(world, env)
    js = _blocks(j_codec, world, lambda a: a)
    ts = _blocks(t_codec, world, torch.from_numpy)
    jr, tr = jc.compressed_alltoallv(js), tc.compressed_alltoallv(ts)
    for dst in range(world):
        for src in range(world):
            assert tr[dst][src] is ts[src][dst]  # passed through, not copied
            np.testing.assert_array_equal(as_np(t_codec.decode_block(tr[dst][src])["k"]),
                                          j_codec.decode_block(jr[dst][src])["k"])
    rows = [[(e.kind.value, e.world, e.bytes_per_rank, e.raw_bytes, e.algo, e.time_s,
              e.total_bytes, e.total_raw_bytes, e.compression_ratio) for e in c.events]
            for c in (tc, jc)]
    assert rows[0] == rows[1]
    assert (tc.bytes_on_wire, tc.raw_bytes_on_wire, tc.comm_time_s) == \
        (jc.bytes_on_wire, jc.raw_bytes_on_wire, jc.comm_time_s)
    assert tc.events[-1].raw_bytes >= tc.events[-1].bytes_per_rank
    with pytest.raises(ValueError, match="full P x P"):
        t_comm.Communicator(2).compressed_alltoallv([[None, None], [None]])


# -- compress=True on the shuffle, join and groupby (test_dataframe.py) ------------

def make_table(keys, vals, cap=None, names=("k", "v")):
    return JTable.from_dict(
        {names[0]: np.asarray(keys, np.int32), names[1]: np.asarray(vals, np.int32)},
        capacity=cap)


def split(keys, vals, p, cap, names=("k", "v")):
    per = len(keys) // p
    return [make_table(keys[i * per:(i + 1) * per], vals[i * per:(i + 1) * per],
                       cap=cap, names=names) for i in range(p)]


def to_port(tables):
    return [table_from_numpy({k: np.asarray(v) for k, v in t.columns.items()},
                             int(t.count), "cpu") for t in tables]


def assert_same_ranks(j_out, t_out):
    assert len(j_out) == len(t_out)
    for jt, tt in zip(j_out, t_out):
        cols, count = table_to_numpy(tt)
        assert count == int(jt.count)
        for k, v in jt.columns.items():
            assert cols[k].dtype == np.asarray(v).dtype
            np.testing.assert_array_equal(cols[k], np.asarray(v), err_msg=k)


def events(comm):
    return [(e.kind.value, e.world, e.bytes_per_rank, e.raw_bytes, e.algo, e.time_s)
            for e in comm.events]


def test_compressed_shuffle_keys_bit_exact():
    rng = np.random.default_rng(7)
    keys = rng.integers(-(2**31), 2**31 - 1, 512).astype(np.int64)
    tables = split(keys, keys, 4, 256)
    jc, tc = j_make(4, "direct"), t_make(4, "direct")
    comp_j = j_dist._shuffle_sim(tables, "k", jc, compress=True)
    comp_t = t_dist._shuffle_sim(to_port(tables), "k", tc, compress=True)
    raw_t = t_dist._shuffle_sim(to_port(tables), "k", t_make(4, "direct"))
    assert_same_ranks(comp_j, comp_t)
    assert events(tc) == events(jc)
    for a, b in zip(raw_t, comp_t):
        np.testing.assert_array_equal(a.to_numpy()["k"], b.to_numpy()["k"])


@pytest.mark.parametrize("env", ["direct", "redis", "s3"])
def test_compressed_join_matches_uncompressed(env):
    rng = np.random.default_rng(3)
    keys = rng.permutation(512).astype(np.int64)
    vals = rng.integers(0, 999, 512)
    rk = rng.permutation(512)[:256]
    rv = rk * 3
    left, right = split(keys, vals, 4, 256), split(rk, rv, 4, 256, names=("k", "w"))
    wire, outs = {}, {}
    for compress in (False, True):
        jc, tc = j_make(4, env), t_make(4, env)
        j_out = j_dist.sim_join(left, right, "k", jc, compress=compress)
        t_out = t_dist.sim_join(to_port(left), to_port(right), "k", tc, compress=compress)
        assert_same_ranks(j_out, t_out)
        assert events(tc) == events(jc)
        wire[compress] = tc.bytes_on_wire
        outs[compress] = sorted(r for t in t_out for r in zip(
            *[t.to_numpy()[c].tolist() for c in ("k", "v", "w")]))
    assert outs[True] == outs[False]
    assert wire[True] * 1.5 <= wire[False]


def test_compressed_float_values_error_bounded():
    rng = np.random.default_rng(11)
    keys = rng.permutation(256).astype(np.int32)
    vals = (rng.normal(size=256) * 50).astype(np.float32)
    tables = [JTable.from_dict({"k": keys[i * 64:(i + 1) * 64], "v": vals[i * 64:(i + 1) * 64]},
                               capacity=128) for i in range(4)]
    jc, tc = j_make(4, "direct"), t_make(4, "direct")
    comp_j = j_dist._shuffle_sim(tables, "k", jc, compress=True)
    comp_t = t_dist._shuffle_sim(to_port(tables), "k", tc, compress=True)
    assert_same_ranks(comp_j, comp_t)  # the lossy int8 values included, bit for bit
    assert events(tc) == events(jc)
    raw = t_dist._shuffle_sim(to_port(tables), "k", t_make(4, "direct"))
    bound = np.abs(vals).max() / 254 * 1.01 + 1e-9
    for t_raw, t_comp in zip(raw, comp_t):
        a, b = t_raw.to_numpy(), t_comp.to_numpy()
        np.testing.assert_array_equal(a["k"], b["k"])
        assert b["v"].dtype == np.float32
        if a["v"].size:
            assert np.abs(a["v"] - b["v"]).max() <= bound


@pytest.mark.parametrize("combine", [False, True])
def test_compressed_groupby_matches(combine):
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 16, 1024).astype(np.int64)
    vals = rng.integers(-99, 99, 1024)
    tables = split(keys, vals, 4, 512)
    merged = {}
    for compress in (False, True):
        jc, tc = j_make(4, "direct"), t_make(4, "direct")
        j_out = j_dist.sim_groupby(tables, "k", {"v": "sum"}, jc, combine=combine,
                                   compress=compress)
        t_out = t_dist.sim_groupby(to_port(tables), "k", {"v": "sum"}, tc, combine=combine,
                                   compress=compress)
        assert_same_ranks(j_out, t_out)
        assert events(tc) == events(jc)
        merged[compress] = {int(k): int(s) for t in t_out
                            for k, s in zip(t.to_numpy()["k"], t.to_numpy()["v_sum"])}
    assert merged[True] == merged[False]
