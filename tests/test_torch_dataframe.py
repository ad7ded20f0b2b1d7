"""Parity of the port's dataframe layer (``repro_torch.dataframe``) with the
reference (``repro.dataframe``), on the CPU.

Each test makes its inputs with numpy from a seed, carries the same padded
tables into both packages, and compares.  Tolerances: integer and routing
outputs (hashes, buckets, counts, row orders, int sums) bit-exact; float32
aggregates at 1e-5 relative / 1e-4 absolute (sums may add in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dataframe import ops_local as j_ops
from repro.dataframe import partition as j_part
from repro.dataframe import table as j_table
from repro_torch.dataframe import ops_local as t_ops
from repro_torch.dataframe import partition as t_part
from repro_torch.dataframe import table as t_table
from repro_torch.interop import table_from_numpy, table_to_numpy

INT32_MIN, INT32_MAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max
F32_RTOL, F32_ATOL = 1e-5, 1e-4


def to_port(jt: j_table.Table) -> t_table.Table:
    return table_from_numpy({k: np.asarray(v) for k, v in jt.columns.items()}, int(jt.count), "cpu")


def assert_same_table(jt: j_table.Table, tt: t_table.Table, float_tol: bool = False):
    """Same count and same padded columns (padding rows included)."""
    cols, count = table_to_numpy(tt)
    assert int(jt.count) == count
    assert sorted(jt.columns) == sorted(cols)
    for k, v in jt.columns.items():
        ref = np.asarray(v)
        assert cols[k].dtype == ref.dtype, k
        if float_tol and np.issubdtype(ref.dtype, np.floating):
            np.testing.assert_allclose(cols[k], ref, rtol=F32_RTOL, atol=F32_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(cols[k], ref, err_msg=k)


def padded_table(rng, n: int, pad: int, cols: dict) -> j_table.Table:
    """A reference table of ``n`` valid rows and ``pad`` padding rows whose
    padding holds garbage (operators must never trust it)."""
    jt = j_table.Table.from_dict(cols, capacity=n + pad)
    garbage = {}
    for k, v in jt.columns.items():
        a = np.asarray(v).copy()
        if pad:
            a[n:] = rng.integers(-1000, 1000, (pad,) + a.shape[1:]).astype(a.dtype)
        garbage[k] = jnp.asarray(a)
    return j_table.Table(garbage, jt.count)


# ---------------------------------------------------------------------------
# Table
# ---------------------------------------------------------------------------


def test_from_dict_without_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_table.Table.from_dict({"a": np.arange(3)})


def test_from_dict_canonicalizes_dtypes_like_jax():
    data = {
        "i64": np.array([1, -2, 2**40 + 5], np.int64),
        "f64": np.array([0.1, 1e300, -2.5]),
        "u64": np.array([1, 2, 3], np.uint64),
        "b": np.array([True, False, True]),
        "i16": np.array([1, 2, -3], np.int16),
        "f32x2": np.arange(6, dtype=np.float32).reshape(3, 2),
    }
    jt = j_table.Table.from_dict(data, capacity=5)
    tt = t_table.Table.from_dict(data, capacity=5, device="cpu")
    assert_same_table(jt, tt)
    assert tt.count.dtype == torch.int32 and tt.count.dim() == 0
    assert tt.capacity == 5 and tt.nbytes() == jt.nbytes()
    assert str(tt.schema).replace("torch.", "") == str(jt.schema).replace("bool_", "bool")
    with pytest.raises(ValueError):
        t_table.Table.from_dict({"a": np.arange(3), "b": np.arange(4)}, device="cpu")
    with pytest.raises(ValueError):
        t_table.Table.from_dict({"a": np.arange(3)}, capacity=2, device="cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_table_ops_match_reference(seed):
    rng = np.random.default_rng(seed)
    n, pad = 37, 11
    cols = {
        "k": rng.integers(INT32_MIN, INT32_MAX, n).astype(np.int32),
        "x": rng.normal(size=n).astype(np.float32),
        "m": rng.integers(0, 5, (n, 3)).astype(np.int32),
    }
    jt = padded_table(rng, n, pad, cols)
    tt = to_port(jt)
    cap = n + pad

    np.testing.assert_array_equal(tt.valid_mask().numpy(), np.asarray(jt.valid_mask()))
    for k, v in jt.to_numpy().items():
        np.testing.assert_array_equal(tt.to_numpy()[k], v)
    assert_same_table(jt.project(["k", "m"]), tt.project(["k", "m"]))
    new = rng.integers(0, 9, cap).astype(np.int32)
    assert_same_table(jt.with_column("z", jnp.asarray(new)), tt.with_column("z", torch.from_numpy(new)))
    with pytest.raises(ValueError):
        tt.with_column("z", torch.zeros(cap + 1))

    # gather clamps out-of-range indices like mode="clip"
    idx = rng.integers(-5, cap + 5, 20).astype(np.int32)
    assert_same_table(jt.gather(jnp.asarray(idx), 13), tt.gather(torch.from_numpy(idx), 13))

    pred = rng.random(cap) < 0.5
    assert_same_table(jt.filter(jnp.asarray(pred)), tt.filter(torch.from_numpy(pred)))
    for h in (0, 5, n, cap):
        assert_same_table(jt.head(h), tt.head(h))
    assert_same_table(j_table.Table.empty_like(jt, 9), t_table.Table.empty_like(tt, 9))


@pytest.mark.parametrize("seed", [0, 1])
def test_concat_and_from_stacked_match_reference(seed):
    rng = np.random.default_rng(seed)
    jts = []
    for n, pad in ((5, 3), (0, 4), (9, 0), (2, 7)):
        cols = {"k": rng.integers(0, 100, n).astype(np.int32),
                "x": rng.normal(size=n).astype(np.float32)}
        jts.append(padded_table(rng, n, pad, cols) if n else j_table.Table.from_dict(cols, capacity=pad))
    assert_same_table(j_table.concat(jts), t_table.concat([to_port(t) for t in jts]))
    with pytest.raises(ValueError):
        t_table.concat([])

    p, cap = 4, 6
    stacked = {"k": rng.integers(0, 50, (p, cap)).astype(np.int32),
               "x": rng.normal(size=(p, cap, 2)).astype(np.float32)}
    counts = np.array([3, 0, 6, 1], np.int32)
    jt = j_table.from_stacked({k: jnp.asarray(v) for k, v in stacked.items()}, jnp.asarray(counts))
    tt = t_table.from_stacked({k: torch.from_numpy(v) for k, v in stacked.items()},
                              torch.from_numpy(counts))
    assert_same_table(jt, tt)


# ---------------------------------------------------------------------------
# Hash partitioning: bit-exact over the full int32 range, padding included
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("p", [4, 16, 37])
@pytest.mark.parametrize("n", [128, 1000, 8192, 20000])
def test_partition_bit_exact(n, p, seed):
    rng = np.random.default_rng(seed * 100003 + n)
    valid = n - n // 10
    cols = {
        "k": rng.integers(INT32_MIN, INT32_MAX, valid, endpoint=True).astype(np.int32),
        "k2": rng.integers(INT32_MIN, INT32_MAX, valid, endpoint=True).astype(np.int32),
        "v": rng.normal(size=valid).astype(np.float32),
    }
    jt = padded_table(rng, valid, n - valid, cols)
    tt = to_port(jt)

    def same(a, b):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert b.numpy().dtype == np.asarray(a).dtype

    same(j_part.hash32(jt.columns["k"], seed), t_part.hash32(tt.columns["k"], seed))
    for keys in (["k"], ["k", "k2"]):
        same(j_part.hash_columns(jt, keys, seed), t_part.hash_columns(tt, keys, seed))
        same(j_part.bucket_ids(jt, keys, p, seed), t_part.bucket_ids(tt, keys, p, seed))
        same(j_part.partition_counts(jt, keys, p, seed), t_part.partition_counts(tt, keys, p, seed))
    for cap_dst in (None, max(1, n // (2 * p))):  # full slots, then a truncating skew bound
        j_pay, j_cnt = j_part.build_partition_payload(jt, p, ["k"], cap_per_dest=cap_dst, seed=seed)
        t_pay, t_cnt = t_part.build_partition_payload(tt, p, ["k"], cap_per_dest=cap_dst, seed=seed)
        same(j_cnt, t_cnt)
        assert sorted(j_pay) == sorted(t_pay)
        for k in j_pay:
            same(j_pay[k], t_pay[k])


def test_partition_int64_key_truncates_like_astype_uint32():
    keys = np.array([-1, 0, 2**31 - 1, -(2**31), 12345], np.int32)
    wide = torch.from_numpy(keys.astype(np.int64) + (7 << 32))  # same low 32 bits
    tt = t_table.Table({"k": wide}, torch.tensor(5, dtype=torch.int32))
    jt = j_table.Table.from_dict({"k": keys})
    np.testing.assert_array_equal(
        t_part.hash_columns(tt, ["k"], 3).numpy(), np.asarray(j_part.hash_columns(jt, ["k"], 3))
    )


# ---------------------------------------------------------------------------
# Local operators
# ---------------------------------------------------------------------------


def _kv_table(rng, n, pad, key_hi, vdtype=np.int32, name="v"):
    vals = (rng.integers(-50, 50, n) if vdtype == np.int32 else rng.normal(size=n)).astype(vdtype)
    return padded_table(rng, n, pad, {"k": rng.integers(0, key_hi, n).astype(np.int32), name: vals})


@pytest.mark.parametrize("seed", [0, 1])
def test_sort_by_key(seed):
    rng = np.random.default_rng(seed)
    jt = _kv_table(rng, 300, 45, 40)
    assert_same_table(j_ops.sort_by_key(jt, "k"), t_ops.sort_by_key(to_port(jt), "k"))


@pytest.mark.parametrize("vdtype", [np.int32, np.float32])
@pytest.mark.parametrize("agg", ["sum", "max", "min", "count"])
@pytest.mark.parametrize("seed", [0, 1])
def test_groupby_agg(agg, vdtype, seed):
    rng = np.random.default_rng(seed)
    for n, pad, key_hi in ((500, 30, 17), (64, 0, 1000), (1, 5, 3), (0, 8, 3)):
        jt = _kv_table(rng, n, pad, key_hi, vdtype) if n else j_table.Table.from_dict(
            {"k": np.zeros(0, np.int32), "v": np.zeros(0, vdtype)}, capacity=pad)
        assert_same_table(
            j_ops.groupby_agg(jt, "k", {"v": agg}), t_ops.groupby_agg(to_port(jt), "k", {"v": agg}),
            float_tol=True,
        )


def test_groupby_int32_sum_wraps_like_reference():
    big = np.array([2**31 - 1, 2**31 - 1, 5, -(2**31), -1], np.int32)
    jt = j_table.Table.from_dict({"k": np.array([1, 1, 1, 2, 2], np.int32), "v": big})
    assert_same_table(j_ops.groupby_agg(jt, "k", {"v": "sum"}),
                      t_ops.groupby_agg(to_port(jt), "k", {"v": "sum"}))
    with pytest.raises(ValueError):
        t_ops.groupby_agg(to_port(jt), "k", {"v": "median"})


@pytest.mark.parametrize("seed", [0, 1])
def test_join_unique(seed):
    rng = np.random.default_rng(seed)
    n_l, n_r = 400, 250
    lk = rng.permutation(1000)[:n_l].astype(np.int32)
    rk = rng.permutation(1000)[:n_r].astype(np.int32)
    lk[:3] = INT32_MAX  # sentinel-equal keys "find" right padding: must not join
    left = padded_table(rng, n_l, 20, {"k": lk, "v": rng.normal(size=n_l).astype(np.float32)})
    right = padded_table(rng, n_r, 30, {"k": rk, "v": rng.integers(0, 9, n_r).astype(np.int32),
                                        "w": rng.integers(0, 9, n_r).astype(np.int32)})
    out = j_ops.join_unique(left, right, "k")
    assert_same_table(out, t_ops.join_unique(to_port(left), to_port(right), "k"))
    assert int(out.count) > 0

    # a valid INT32_MAX key on both sides does join
    rk2 = rk.copy()
    rk2[0] = INT32_MAX
    right2 = padded_table(rng, n_r, 30, {"k": rk2, "w": rng.integers(0, 9, n_r).astype(np.int32)})
    assert_same_table(j_ops.join_unique(left, right2, "k"),
                      t_ops.join_unique(to_port(left), to_port(right2), "k"))

    # an empty right side, and a left side with count 0
    empty_r = j_table.Table.from_dict({"k": np.zeros(0, np.int32), "w": np.zeros(0, np.int32)},
                                      capacity=16)
    assert_same_table(j_ops.join_unique(left, empty_r, "k"),
                      t_ops.join_unique(to_port(left), to_port(empty_r), "k"))
    empty_l = j_table.Table(left.columns, jnp.asarray(0, jnp.int32))
    assert_same_table(j_ops.join_unique(empty_l, right, "k"),
                      t_ops.join_unique(to_port(empty_l), to_port(right), "k"))
    with pytest.raises(NotImplementedError):
        t_ops.join_unique(to_port(left), to_port(right), "k", how="left")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("out_capacity", [1, 60, 4000])
def test_join_sorted_expand(seed, out_capacity):
    rng = np.random.default_rng(seed)
    left = _kv_table(rng, 120, 10, 30)                  # many-to-many: repeated keys
    right = _kv_table(rng, 90, 7, 30, np.float32, "w")
    right_dup = _kv_table(rng, 90, 7, 30)               # name clash -> v_r
    for r in (right, right_dup):
        assert_same_table(
            j_ops.join_sorted_expand(left, r, "k", out_capacity),
            t_ops.join_sorted_expand(to_port(left), to_port(r), "k", out_capacity),
        )
