"""The port's kernels on the CPU: each plain version (``ref.py``) against the
reference's Pallas TPU kernel run with ``interpret=True`` (as
``tests/test_kernels.py`` runs it), and the device dispatch of ``ops.py``.

The CUDA kernels themselves run only on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``).  Tolerances: hashes, buckets, probe hits and
positions (on every row) and int32 sums bit-exact; float32 segment sums at
1e-4 absolute / 1e-5 relative, as ``tests/test_kernels.py`` holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hash_partition import kernel as j_hp_kernel
from repro.kernels.join_probe import kernel as j_jp_kernel
from repro.kernels.segment_reduce import ops as j_sr_ops
from repro_torch.kernels import _build
from repro_torch.kernels.hash_partition import kernel as hp_k, ops as hp_ops, ref as hp_r
from repro_torch.kernels.join_probe import kernel as jp_k, ops as jp_ops, ref as jp_r
from repro_torch.kernels.segment_reduce import kernel as sr_k, ops as sr_ops, ref as sr_r

INT32_MAX = np.iinfo(np.int32).max


@pytest.mark.parametrize("n", [128, 1000, 8192, 20000])
@pytest.mark.parametrize("p", [4, 16, 37])
def test_hash_partition_ref_matches_pallas(n, p):
    rng = np.random.default_rng(n)
    keys = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
    h_j, b_j = j_hp_kernel.hash_partition(
        jnp.asarray(keys), num_partitions=p, interpret=True, block=4096
    )
    h_t, b_t = hp_r.hash_partition_ref(torch.from_numpy(keys), num_partitions=p)
    assert h_t.dtype == torch.uint32 and b_t.dtype == torch.int32
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))


@pytest.mark.parametrize("seed", [0, 7])
def test_hash_partition_ref_seeds(seed):
    keys = np.array([-(2**31), -1, 0, 1, INT32_MAX], np.int32)
    h_j, b_j = j_hp_kernel.hash_partition(
        jnp.asarray(keys), num_partitions=5, seed=seed, interpret=True
    )
    h_t, b_t = hp_r.hash_partition_ref(torch.from_numpy(keys), num_partitions=5, seed=seed)
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))


@pytest.mark.parametrize("m,n,keys", [
    (128, 512, "inside"), (1024, 4096, "inside"), (777, 1000, "inside"),
    (1, 16, "inside"),         # a page of one key
    (1, 16, "outside"),
    (128, 512, "outside"),     # keys below the first, above the last, INT32_MIN/MAX
    (777, 1000, "outside"),
])
def test_probe_ref_matches_pallas(m, n, keys):
    rng = np.random.default_rng(m)
    rkeys = np.unique(rng.integers(0, 10 * m, m)).astype(np.int32)
    rkeys = np.concatenate([rkeys, np.full(m - len(rkeys), INT32_MAX, np.int32)])
    if keys == "inside":
        lkeys = rng.integers(0, 10 * m, n).astype(np.int32)
    else:
        lkeys = np.concatenate([rng.integers(-(2**31), 1, n // 2),
                                rng.integers(10 * m, INT32_MAX, n - n // 2)]).astype(np.int32)
        lkeys[-1] = -(2**31)
    lkeys[:2] = INT32_MAX  # "hits" the sentinel padding in both
    idx_j, hit_j = j_jp_kernel.probe_sorted(
        jnp.asarray(rkeys), jnp.asarray(lkeys), interpret=True, block=512
    )
    idx_t, hit_t = jp_r.probe_sorted_ref(torch.from_numpy(rkeys), torch.from_numpy(lkeys))
    assert idx_t.dtype == torch.int32 and hit_t.dtype == torch.bool
    np.testing.assert_array_equal(hit_t.numpy(), np.asarray(hit_j))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))


@pytest.mark.parametrize("n,nseg,block,max_seg", [
    (1024, 16, 256, 128),
    (4096, 100, 512, 128),
    (1000, 7, 256, 64),      # padded tail
])
def test_segment_sum_ref_matches_pallas(n, nseg, block, max_seg):
    rng = np.random.default_rng(7)
    seg = np.sort(rng.integers(0, nseg, n)).astype(np.int32)
    vals = rng.normal(size=n).astype(np.float32)
    got_j = j_sr_ops.segment_sum(
        jnp.asarray(seg), jnp.asarray(vals), nseg, block=block, max_seg=max_seg, force_kernel=True
    )
    got_t = sr_r.segment_sum_ref(torch.from_numpy(seg), torch.from_numpy(vals), nseg)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(got_j), atol=1e-4, rtol=1e-5)


def test_segment_sum_ref_drops_no_row_beyond_max_seg():
    """~1 row per segment: every 256-row block spans ~256 segments, twice
    the Pallas kernel's max_seg=128, which drops the rows beyond it."""
    rng = np.random.default_rng(3)
    n, nseg = 4096, 4000
    seg = np.sort(rng.integers(0, nseg, n)).astype(np.int32)
    vals = rng.normal(size=n).astype(np.float32)
    exact = jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(seg), num_segments=nseg)
    got = sr_r.segment_sum_ref(torch.from_numpy(seg), torch.from_numpy(vals), nseg)
    np.testing.assert_allclose(got.numpy(), np.asarray(exact), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(got.numpy().sum(), vals.sum(dtype=np.float64), atol=1e-3)


def test_segment_sum_ref_int32_wraps_and_drops_out_of_range():
    seg = np.array([-1, 0, 0, 1, 2, 5], np.int32)
    vals = np.array([9, INT32_MAX, 3, -7, 4, 8], np.int32)
    exact = jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(seg), num_segments=3)
    got = sr_r.segment_sum_ref(torch.from_numpy(seg), torch.from_numpy(vals), 3)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(exact))


def test_cpu_tensors_take_the_plain_version_without_launching():
    before = (hp_k.launches, hp_k.single_launches, jp_k.launches, sr_k.launches)
    keys = torch.arange(-50, 50, dtype=torch.int32)
    count = torch.tensor(90, dtype=torch.int32)
    b, hist = hp_ops.row_buckets([keys], 4, count)
    b_r, hist_r = hp_r.row_buckets_ref([keys], 4, count)
    assert torch.equal(b, b_r) and torch.equal(hist, hist_r)
    assert torch.equal(hp_ops.row_hash([keys]), hp_r.row_hash_u32([keys]).to(torch.uint32))
    h, _ = hp_ops.hash_partition(keys, num_partitions=3)
    assert torch.equal(h, hp_r.hash_partition_ref(keys, num_partitions=3)[0])
    page = torch.arange(0, 100, 3, dtype=torch.int32)
    assert all(torch.equal(a, c) for a, c in
               zip(jp_ops.probe_sorted(page, keys), jp_r.probe_sorted_ref(page, keys)))
    seg = torch.sort(torch.randint(0, 9, (100,), generator=torch.Generator().manual_seed(0))).values
    assert torch.equal(sr_ops.segment_sum(seg.int(), keys, 9), sr_r.segment_sum_ref(seg.int(), keys, 9))
    assert (hp_k.launches, hp_k.single_launches, jp_k.launches, sr_k.launches) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    t = torch.zeros(8, dtype=torch.int32)
    for call in (
        lambda: hp_k.row_buckets([t], 2, None),
        lambda: hp_k.hash_partition(t, num_partitions=2),
        lambda: jp_k.probe_sorted(t, t),
        lambda: sr_k.segment_sum(t, t, 2),
    ):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_build_signatures_name_every_entry_point():
    text = "".join((_build.CSRC / s).read_text() for s in _build.SOURCES)
    for name in _build.SIGNATURES:
        assert f'extern "C" int {name}(' in text


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_build_signatures_match_argument_counts(name):
    """ctypes passes exactly the C entry point's arguments: a missing or
    extra one would shift every argument after it."""
    text = "".join((_build.CSRC / s).read_text() for s in _build.SOURCES)
    params = text.split(f'extern "C" int {name}(', 1)[1].split(")", 1)[0]
    assert len(params.split(",")) == len(_build.SIGNATURES[name])
