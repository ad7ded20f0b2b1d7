"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (so it counts no pass
on a CPU-only machine).  The file imports neither jax nor the reference
package, so it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.hash_partition import kernel as hp_k, ops as hp_ops, ref as hp_r
from repro_torch.kernels.join_probe import kernel as jp_k, ops as jp_ops, ref as jp_r
from repro_torch.kernels.segment_reduce import kernel as sr_k, ops as sr_ops, ref as sr_r

pytestmark = pytest.mark.cuda

INT32_MAX = np.iinfo(np.int32).max


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 128, 1000, 8192, 20001])
@pytest.mark.parametrize("p", [1, 4, 16, 37])
def test_row_buckets_match_plain(cuda, n, p):
    rng = np.random.default_rng(n + p)
    k32 = torch.tensor(rng.integers(-(2**31), 2**31 - 1, n), dtype=torch.int32, device=cuda)
    k64 = torch.tensor(rng.integers(-(2**62), 2**62, n), dtype=torch.int64, device=cuda)
    count = torch.tensor(max(0, n - 7), dtype=torch.int32, device=cuda)
    for cols in ([k32], [k32, k64], [k64]):
        h, b, hist = hp_k.row_buckets(cols, p, count, seed=3, want_hash=True)
        b_p, hist_p = hp_r.row_buckets_ref(cols, p, count, seed=3)
        assert torch.equal(h.to(torch.int64) & 0xFFFFFFFF, hp_r.row_hash_u32(cols, 3))
        assert torch.equal(b, b_p) and torch.equal(hist, hist_p)


@pytest.mark.parametrize("n", [128, 1000, 20000])
@pytest.mark.parametrize("p", [4, 16, 37])
def test_hash_partition_single_column(cuda, n, p):
    rng = np.random.default_rng(n)
    keys = torch.tensor(rng.integers(-(2**31), 2**31 - 1, n), dtype=torch.int32, device=cuda)
    h_k, b_k = hp_ops.hash_partition(keys, num_partitions=p, seed=1)
    h_r, b_r = hp_r.hash_partition_ref(keys, num_partitions=p, seed=1)
    assert torch.equal(h_k.view(torch.int32), h_r.view(torch.int32))
    assert torch.equal(b_k, b_r)


@pytest.mark.parametrize("page,n", [(1, 10), (128, 512), (777, 1000), (40000, 100000)])
def test_probe_matches_plain(cuda, page, n):
    rng = np.random.default_rng(page)
    real = np.unique(rng.integers(0, 10 * page, page)).astype(np.int32)
    rk = np.concatenate([real, np.full(page - len(real), INT32_MAX, np.int32)])
    lk = rng.integers(0, 10 * page, n).astype(np.int32)
    lk[:2] = INT32_MAX
    right = torch.tensor(rk, device=cuda)
    left = torch.tensor(lk, device=cuda)
    before = jp_k.launches
    idx, hit = jp_ops.probe_sorted(right, left)
    assert jp_k.launches == before + 1
    idx_r, hit_r = jp_r.probe_sorted_ref(right, left)
    assert torch.equal(hit, hit_r)
    assert torch.equal(idx[hit], idx_r[hit_r])


@pytest.mark.parametrize("n,nseg", [(1, 1), (33, 3), (1000, 7), (4096, 2048), (100000, 1000)])
def test_segment_sum_matches_plain(cuda, n, nseg):
    rng = np.random.default_rng(n)
    seg = torch.tensor(np.sort(rng.integers(0, nseg, n)).astype(np.int32), device=cuda)
    vi = torch.tensor(rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32), device=cuda)
    # int32 wraps mod 2^32 in both: exact
    assert torch.equal(sr_ops.segment_sum(seg, vi, nseg + 1), sr_r.segment_sum_ref(seg, vi, nseg + 1))
    vf = torch.tensor(rng.normal(size=n).astype(np.float32), device=cuda)
    # float atomics reorder the sum: tolerance of the f32 segment-sum tests
    torch.testing.assert_close(
        sr_k.segment_sum(seg, vf, nseg), sr_r.segment_sum_ref(seg, vf, nseg), atol=1e-4, rtol=1e-5
    )

