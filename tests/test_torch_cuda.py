"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (so it counts no pass
on a CPU-only machine).  The file imports neither jax nor the reference
package, so it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as fa_k, ops as fa_ops, ref as fa_r
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


def _probe_page(rng, page, pad):
    """A sorted right page of ``page`` int32 keys: distinct even keys, the
    last ``pad`` of them INT32_MAX sentinels."""
    pool = np.unique(rng.integers(0, 10 * page, int(1.2 * page) + 16))
    real = np.sort(rng.choice(pool, page - pad, replace=False)) * 2
    return np.concatenate([real, np.full(pad, INT32_MAX)]).astype(np.int32)


def _probe_check(right, left):
    """The kernel against the plain version on every row: idx and hit."""
    before = jp_k.launches
    idx, hit = jp_ops.probe_sorted(right, left)
    assert jp_k.launches == before + 1
    idx_r, hit_r = jp_r.probe_sorted_ref(right, left)
    assert torch.equal(hit, hit_r)
    assert torch.equal(idx, idx_r)


# pages: one key; no index (<= 8192 keys, the shared-memory top level); one
# index level; not a multiple of either index stride; larger than the L2
@pytest.mark.parametrize("page,n", [(1, 10), (128, 512), (777, 1000), (8192, 3000), (8193, 3000),
                                    (40000, 100000), (1_000_003, 200_000),
                                    (16_777_259, 1_000_000), (40000, 0)])
def test_probe_matches_plain(cuda, page, n):
    rng = np.random.default_rng(page)
    rk = _probe_page(rng, page, page // 2)
    lk = (rng.integers(0, 10 * page, n) * 2).astype(np.int32)  # about half of them hit
    lk[:2] = INT32_MAX
    _probe_check(torch.tensor(rk, device=cuda), torch.tensor(lk, device=cuda))


@pytest.mark.parametrize("page", [1, 8192, 8193, 1_000_003, 16_777_259])
@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("keys", ["missing", "int32_max", "outside"])
def test_probe_edge_keys(cuda, page, pad, keys):
    """Every key missing (odd keys against even ones), every key INT32_MAX
    (with and without a sentinel in the page), and keys below the first and
    above the last."""
    pad = min(pad, page - 1) if page > 1 else pad
    rng = np.random.default_rng(page + pad)
    rk = _probe_page(rng, page, pad)
    n = 5000
    if keys == "missing":
        lk = rng.integers(-1, 10 * page + 1, n) * 2 + 1
    elif keys == "int32_max":
        lk = np.full(n, INT32_MAX)
    else:
        last = int(rk[page - pad - 1]) if page > pad else 0
        lk = np.concatenate([rng.integers(-(2**31), int(rk[0]) + 1, n // 2),
                             rng.integers(last, INT32_MAX, n - n // 2)])
    _probe_check(torch.tensor(rk, device=cuda), torch.tensor(lk.astype(np.int32), device=cuda))


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



# flash attention: the kernel and its plain version read the same k/v (bf16
# or f32) and both compute in float32, so only the order of the float32 sums
# differs: 2e-5 for both k/v types.
FLASH_TOL = 2e-5


def _flash_inputs(cuda, b, tq, tk, h, kvh, hd, kv_dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.tensor(rng.normal(size=(b, tq, h, hd)), dtype=torch.float32, device=cuda)
    k = torch.tensor(rng.normal(size=(b, tk, kvh, hd)), dtype=torch.float32, device=cuda)
    v = torch.tensor(rng.normal(size=(b, tk, kvh, hd)), dtype=torch.float32, device=cuda)
    return q, k.to(kv_dtype), v.to(kv_dtype)


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "b,tq,tk,h,kvh,hd,window,q_offset,kv_len,softcap",
    [
        (2, 160, 176, 4, 2, 32, 32, 0, 160, 0.0),       # reduced gemma3 prefill, ragged Tk
        (1, 100, 100, 4, 4, 64, 0, 0, None, 0.0),        # forward, ragged tiles
        (2, 70, 300, 8, 2, 128, 0, 200, 270, 50.0),      # chunked prefill, softcap
        (1, 130, 4128, 8, 4, 256, 1024, 3968, 4098, 0.0),  # gemma3 widths, window
        (4, 1, 4128, 8, 4, 256, 0, 4096, 4097, 0.0),     # main-path decode, global
        (4, 1, 4128, 8, 4, 256, 1024, 4096, 4097, 0.0),  # main-path decode, local
        (2, 3, 500, 4, 2, 64, 16, 300, 303, 0.0),        # decode design, 6 rows per kv head
        (2, 1, 37, 2, 1, 32, 0, 36, 37, 30.0),           # decode design, tiny Tk (one chunk)
        (2, 90, 130, 8, 2, 120, 32, 20, 110, 0.0),       # hd 120 (h2o-danube), prefill
        (2, 1, 300, 8, 4, 120, 64, 250, 251, 20.0),      # hd 120, decode
    ],
)
def test_flash_attention_matches_plain(cuda, kv_dtype, b, tq, tk, h, kvh, hd, window,
                                       q_offset, kv_len, softcap):
    q, k, v = _flash_inputs(cuda, b, tq, tk, h, kvh, hd, kv_dtype)
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=q_offset, kv_len=kv_len)
    before = fa_k.launches
    got = fa_ops.flash_attention(q, k, v, **kw)
    assert fa_k.launches == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fa_r.attention_ref(q, k, v, **kw), atol=FLASH_TOL,
                               rtol=FLASH_TOL)


@pytest.mark.parametrize("tq", [1, 64, 200])
def test_flash_attention_rows_without_keys(cuda, tq):
    """kv_len = 0, and rows past kv_len + window: the uniform mean of v."""
    q, k, v = _flash_inputs(cuda, 2, tq, 150, 4, 2, 64, torch.bfloat16, seed=1)
    for kw in (dict(kv_len=0), dict(kv_len=20, window=8, q_offset=40)):
        got = fa_k.flash_attention(q, k, v, causal=True, **kw)
        torch.testing.assert_close(got, fa_r.attention_ref(q, k, v, causal=True, **kw),
                                   atol=FLASH_TOL, rtol=FLASH_TOL)
    mean = v.float().mean(1, keepdim=True).repeat_interleave(2, 2).expand(-1, tq, -1, -1)
    torch.testing.assert_close(fa_k.flash_attention(q, k, v, kv_len=0), mean,
                               atol=FLASH_TOL, rtol=FLASH_TOL)


@pytest.mark.parametrize("causal,groups", [(True, 2), (False, 1)])
def test_flash_attention_heads_layout(cuda, causal, groups):
    """The Pallas kernel's head-major contract, through the same kernel."""
    rng = np.random.default_rng(3)
    q = torch.tensor(rng.normal(size=(4 * groups, 256, 64)), dtype=torch.float32, device=cuda)
    k = torch.tensor(rng.normal(size=(4, 512, 64)), dtype=torch.float32, device=cuda)
    v = torch.tensor(rng.normal(size=(4, 512, 64)), dtype=torch.float32, device=cuda)
    kw = dict(groups=groups, causal=causal, window=0, softcap=20.0)
    torch.testing.assert_close(fa_ops.flash_attention_heads(q, k, v, 300, **kw),
                               fa_r.attention_heads_ref(q, k, v, 300, **kw),
                               atol=FLASH_TOL, rtol=FLASH_TOL)


@pytest.mark.parametrize("hd", [32, 64, 120, 128, 256])
@pytest.mark.parametrize("groups", [1, 2, 8])
def test_flash_wgmma_design_matches_plain(cuda, hd, groups):
    """bf16 k/v and more than 8 rows per kv head: the tensor-core design.
    k/v read in place from a layer's slice of a [L, 2, B, S, KV, hd] cache,
    Tq = 100 (not a multiple of 64), a ragged Tk of 200, windows, a softcap
    and rows with no valid key."""
    rng = np.random.default_rng(hd + groups)
    kvh = 2
    cache = torch.tensor(rng.normal(size=(3, 2, 2, 200, kvh, hd)), dtype=torch.bfloat16,
                         device=cuda)
    k, v = cache[1, 0], cache[1, 1]
    q = torch.tensor(rng.normal(size=(2, 100, kvh * groups, hd)), dtype=torch.float32,
                     device=cuda)
    for kw in (dict(window=0, q_offset=60, kv_len=160),
               dict(window=48, q_offset=60, kv_len=160, softcap=30.0),
               dict(window=0, q_offset=100, kv_len=200),
               dict(kv_len=0),
               dict(kv_len=20, window=8, q_offset=40)):
        got = fa_k.flash_attention(q, k, v, causal=True, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, fa_r.attention_ref(q, k, v, causal=True, **kw),
                                   atol=FLASH_TOL, rtol=FLASH_TOL)


@pytest.mark.parametrize("v_mean", [0.0, 1.0])
def test_flash_wgmma_long_context_and_one_key_too_few(cuda, v_mean):
    """gemma3-4b's global layer at 32,768 keys: 512 queries at q_offset
    32,256 over a bf16 cache of 32,768 positions, causal, no window (1,024
    rows per kv head: the tensor-core design, which sums each row's O over
    512 key tiles).  Within the float32 limit, and not given one key too
    few.  v with a mean of 1 makes |O| about 1, where a bias of O toward zero
    that grows with the number of tiles shows against the limit."""
    rng = np.random.default_rng(32768)
    q = torch.tensor(rng.normal(size=(1, 512, 8, 256)), dtype=torch.float32, device=cuda)
    k, v = (torch.tensor(rng.normal(size=(1, 32768, 4, 256)), dtype=torch.float32,
                         device=cuda) for _ in range(2))
    k, v = k.to(torch.bfloat16), (v + v_mean).to(torch.bfloat16)
    kw = dict(causal=True, window=0, q_offset=32256, kv_len=32768)
    got = fa_k.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    exp = fa_r.attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got, exp, atol=FLASH_TOL, rtol=FLASH_TOL)
    del exp
    near = fa_r.attention_ref(q, k, v, **dict(kw, kv_len=32767))
    assert not torch.allclose(got, near, atol=FLASH_TOL, rtol=FLASH_TOL)


@pytest.mark.parametrize("hd", [32, 64, 120, 128])
@pytest.mark.parametrize("groups", [1, 2, 8])
def test_flash_wgmma_split_design_matches_plain(cuda, hd, groups):
    """float32 k/v and more than 8 rows per kv head: the tensor-core design
    on k's and v's parts.  k/v read from a layer's slice of a float32
    [L, 2, B, S, KV, hd] cache (the prologue takes any strides), Tq = 100, a
    ragged Tk of 200, windows, a softcap and rows with no valid key; and the
    training forward's lse."""
    rng = np.random.default_rng(hd + groups)
    kvh = 2
    cache = torch.tensor(rng.normal(size=(3, 2, 2, 200, kvh, hd)), dtype=torch.float32,
                         device=cuda)
    k, v = cache[1, 0], cache[1, 1]
    q = torch.tensor(rng.normal(size=(2, 100, kvh * groups, hd)), dtype=torch.float32,
                     device=cuda)
    before = fa_k.fwd_design_launches["flash_wgmma_split"]
    kws = (dict(window=0, q_offset=60, kv_len=160),
           dict(window=48, q_offset=60, kv_len=160, softcap=30.0),
           dict(window=0, q_offset=100, kv_len=200),
           dict(kv_len=0),
           dict(kv_len=20, window=8, q_offset=40))
    for kw in kws:
        got = fa_k.flash_attention(q, k, v, causal=True, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, fa_r.attention_ref(q, k, v, causal=True, **kw),
                                   atol=FLASH_TOL, rtol=FLASH_TOL)
    qt = q[:, :, :kvh * groups]
    kt, vt = k[:, :100].contiguous(), v[:, :100].contiguous()
    for kw in (dict(causal=True, window=0, softcap=0.0),
               dict(causal=True, window=30, softcap=20.0),
               dict(causal=False, window=0, softcap=0.0)):
        o, lse = fa_k.flash_attention_lse(qt, kt, vt, **kw)
        o_r, lse_r = fa_r.attention_lse_ref(qt, kt, vt, **kw)
        torch.testing.assert_close(o, o_r, atol=FLASH_TOL, rtol=FLASH_TOL)
        torch.testing.assert_close(lse, lse_r, atol=FLASH_TOL, rtol=FLASH_TOL)
    assert fa_k.fwd_design_launches["flash_wgmma_split"] == before + len(kws) + 3


@pytest.mark.parametrize("hd,h,kvh,window", [(64, 36, 36, 0), (120, 32, 8, 4096)])
def test_flash_wgmma_split_train_shapes_and_one_key_too_few(cuda, hd, h, kvh, window):
    """minicpm-2b's training forward (q/k/v [2, 4096, 36, 64], causal) and
    h2o-danube's (hd 120, GQA 32/8, window 4096): o and lse within the
    float32 limit, o not given one key too few; and a repeat is bit-equal."""
    b = 2 if hd == 64 else 1
    q, k, v = _flash_inputs(cuda, b, 4096, 4096, h, kvh, hd, torch.float32, seed=hd)
    kw = dict(causal=True, window=window, softcap=0.0)
    before = dict(fa_k.fwd_design_launches)
    o, lse = fa_k.flash_attention_lse(q, k, v, **kw)
    after = fa_k.fwd_design_launches
    assert {d: after[d] - before[d] for d in after} == \
        {d: int(d == "flash_wgmma_split") for d in after}
    o_r, lse_r = fa_r.attention_lse_ref(q, k, v, **kw)
    torch.testing.assert_close(o, o_r, atol=FLASH_TOL, rtol=FLASH_TOL)
    torch.testing.assert_close(lse, lse_r, atol=FLASH_TOL, rtol=FLASH_TOL)
    del o_r, lse_r
    o_n, _ = fa_r.attention_lse_ref(q, k, v, **dict(kw, window=(window or 4096) - 1))
    assert not torch.allclose(o, o_n, atol=FLASH_TOL, rtol=FLASH_TOL)
    del o_n
    o2, lse2 = fa_k.flash_attention_lse(q, k, v, **kw)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_flash_forward_design_that_ran(cuda):
    """Each forward design's counter moves by one for its call, and only it."""
    for hd, kv_dtype, tq, design in ((64, torch.float32, 80, "flash_wgmma_split"),
                                     (256, torch.float32, 80, "flash_tiled"),
                                     (64, torch.bfloat16, 80, "flash_wgmma"),
                                     (64, torch.bfloat16, 1, "flash_decode")):
        q, k, v = _flash_inputs(cuda, 1, tq, 80, 4, 2, hd, kv_dtype, seed=hd)
        before = dict(fa_k.fwd_design_launches)
        fa_k.flash_attention(q, k, v, causal=True, q_offset=80 - tq, kv_len=80)
        after = fa_k.fwd_design_launches
        assert {d: after[d] - before[d] for d in after} == {d: int(d == design) for d in after}
        assert fa_k.fwd_design(hd, kv_dtype, tq * 2) == design


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float32])
def test_flash_decode_repeats(cuda, kv_dtype):
    """The decode design's chunk counters are back at 0 after each call:
    repeated calls, on shapes with many chunks and with one, agree."""
    for tk in (4128, 37):
        q, k, v = _flash_inputs(cuda, 4, 1, tk, 8, 4, 256, kv_dtype, seed=tk)
        kw = dict(window=0, q_offset=tk - 2, kv_len=tk - 1)
        exp = fa_r.attention_ref(q, k, v, **kw)
        for _ in range(3):
            got = fa_k.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, exp, atol=FLASH_TOL, rtol=FLASH_TOL)


def test_flash_attention_reads_cache_slice_in_place(cuda):
    """k/v as a layer's [B, S, KV, hd] slice of the [L, 2, B, S, KV, hd] cache."""
    rng = np.random.default_rng(4)
    cache = torch.tensor(rng.normal(size=(3, 2, 2, 96, 2, 128)), dtype=torch.bfloat16,
                         device=cuda)
    q = torch.tensor(rng.normal(size=(2, 1, 4, 128)), dtype=torch.float32, device=cuda)
    k, v = cache[1, 0], cache[1, 1]
    kw = dict(window=0, q_offset=80, kv_len=81)
    torch.testing.assert_close(fa_k.flash_attention(q, k, v, **kw),
                               fa_r.attention_ref(q, k, v, **kw), atol=FLASH_TOL, rtol=FLASH_TOL)


def test_flash_attention_h2o_danube_shape(cuda):
    """h2o-danube-3-4b's attention at 4096 positions (hd 120, GQA 32/8, window
    4096): the float32 forward, the bf16 prefill and the training forward."""
    q, k, v = _flash_inputs(cuda, 1, 4096, 4096, 32, 8, 120, torch.float32, seed=120)
    kw = dict(causal=True, window=4096)
    exp = fa_r.attention_ref(q, k, v, **kw)
    torch.testing.assert_close(fa_k.flash_attention(q, k, v, **kw), exp, atol=FLASH_TOL,
                               rtol=FLASH_TOL)
    o, lse = fa_k.flash_attention_lse(q, k, v, **kw)
    o_r, lse_r = fa_r.attention_lse_ref(q, k, v, **kw)
    torch.testing.assert_close(o, exp, atol=FLASH_TOL, rtol=FLASH_TOL)
    torch.testing.assert_close(lse, lse_r, atol=FLASH_TOL, rtol=FLASH_TOL)
    kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
    torch.testing.assert_close(fa_k.flash_attention(q, kb, vb, **kw),
                               fa_r.attention_ref(q, kb, vb, **kw), atol=FLASH_TOL,
                               rtol=FLASH_TOL)


def test_every_dense_config_head_dim_runs(cuda):
    """Each dense / vlm config's head width through the three forward
    designs and the backward."""
    from repro_torch import configs as tc

    widths = sorted({tc.get(n).resolved_head_dim for n in tc.ARCH_IDS
                     if tc.get(n).family in ("dense", "vlm")})
    assert 120 in widths
    for hd in widths:
        q, k, v = _flash_inputs(cuda, 1, 80, 80, 4, 2, hd, torch.float32, seed=hd)
        for kv, tq in ((k, 80), (k.to(torch.bfloat16), 80), (k.to(torch.bfloat16), 1)):
            vv = v.to(kv.dtype)
            kw = dict(causal=True, q_offset=80 - tq, kv_len=80)
            torch.testing.assert_close(fa_k.flash_attention(q[:, :tq], kv, vv, **kw),
                                       fa_r.attention_ref(q[:, :tq], kv, vv, **kw),
                                       atol=FLASH_TOL, rtol=FLASH_TOL)
        _bwd_check(q, k, v, dict(causal=True, window=0, softcap=0.0))


# the backward kernel against its plain version (ref.attention_bwd_ref) from
# the same o and lse: both float32, sums in another order; dk and dv sum up to
# T x groups terms.  1e-4 absolute plus relative; one key too few moves some
# gradient by ~1e-3 or more.
BWD_TOL = 1e-4


def _bwd_check(q, k, v, kw, seed=0):
    """The backward against its plain version from the same o and lse; with
    bf16 k/v, dk and dv (bfloat16) within BWD_TOL plus one rounding."""
    g = torch.Generator(device=q.device)
    g.manual_seed(seed)
    do = torch.randn(q.shape, generator=g, device=q.device)
    o, lse = fa_k.flash_attention_lse(q, k, v, **kw)
    before = fa_k.bwd_launches
    got = fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert fa_k.bwd_launches == before + 1
    torch.cuda.synchronize()
    exp = fa_r.attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for name, a, e in zip("qkv", got, exp):
        if a.dtype == torch.bfloat16:
            err = (a.float() - e).abs()
            assert bool((err <= BWD_TOL + (BWD_TOL + BF16_ROUND) * e.abs()).all()), \
                (f"d{name}", float(err.max()))
        else:
            torch.testing.assert_close(a, e, atol=BWD_TOL, rtol=BWD_TOL, msg=f"d{name}")
    return got, exp, do


@pytest.mark.parametrize(
    "b,t,h,kvh,hd,causal,window,softcap",
    [
        (2, 100, 4, 4, 64, True, 0, 0.0),        # ragged tiles
        (1, 300, 8, 2, 32, True, 64, 0.0),       # GQA, window
        (1, 200, 4, 1, 128, True, 0, 30.0),      # MQA, softcap
        (1, 150, 8, 4, 256, True, 40, 50.0),     # gemma3 widths (bwd_wide)
        (1, 130, 8, 2, 120, True, 100, 0.0),     # hd 120
        (1, 96, 2, 1, 64, False, 0, 0.0),        # bidirectional
        (1, 96, 4, 2, 32, False, 20, 20.0),      # bidirectional, window, softcap
        (1, 1, 2, 1, 64, True, 0, 0.0),          # one position
        # the tensor-core design's tiles: 64 (hd 32, 64) or 32 (hd 120, 128)
        # streamed rows against 128 or 64 fixed ones; ragged T (200, 257,
        # 333, 4097); the GQA groups of minicpm-2b (1), gemma3-4b (2) and
        # h2o-danube (4)
        (1, 200, 4, 4, 64, True, 0, 0.0),
        (1, 4097, 4, 4, 64, True, 0, 0.0),
        (2, 333, 8, 4, 64, True, 100, 30.0),
        (1, 200, 8, 4, 32, True, 50, 30.0),
        (1, 4097, 4, 2, 32, False, 300, 0.0),
        (1, 200, 8, 2, 120, True, 64, 0.0),
        (1, 4097, 8, 2, 120, True, 4096, 0.0),
        (1, 200, 8, 2, 128, False, 0, 20.0),
        (1, 257, 8, 4, 128, True, 0, 0.0),
        (1, 200, 8, 4, 256, True, 50, 30.0),
        # bwd_wide: 16-row streamed tiles against 64 fixed rows; ragged T
        (1, 4097, 8, 4, 256, True, 1024, 0.0),
        (2, 333, 4, 1, 256, False, 100, 20.0),
        (1, 1, 2, 1, 256, True, 0, 0.0),
    ],
)
def test_flash_bwd_matches_plain(cuda, b, t, h, kvh, hd, causal, window, softcap):
    q, k, v = _flash_inputs(cuda, b, t, t, h, kvh, hd, torch.float32, seed=t + hd)
    _bwd_check(q, k, v, dict(causal=causal, window=window, softcap=softcap))


@pytest.mark.parametrize(
    "b,tq,tk,h,kvh,hd,causal,window,softcap,q_offset",
    [
        # sequence-split islands: Tq rows at q_offset of Tk keys, causal
        (1, 128, 512, 4, 4, 64, True, 0, 0.0, 384),
        (2, 64, 256, 8, 2, 32, True, 0, 0.0, 64),
        (1, 100, 333, 4, 1, 128, True, 50, 30.0, 200),    # ragged, window, softcap
        (1, 96, 200, 8, 1, 112, True, 0, 0.0, 104),       # kimi-k2's width
        (1, 256, 1024, 8, 4, 256, True, 0, 0.0, 512),     # bwd_wide
        (1, 64, 300, 8, 4, 256, True, 100, 20.0, 236),    # bwd_wide, ragged
        # cross-attention: non-causal, Tq != Tk (keys no query reaches: 0)
        (2, 128, 1500, 4, 4, 64, False, 0, 0.0, 0),
        (1, 40, 333, 8, 4, 256, False, 0, 0.0, 0),
        (1, 77, 129, 4, 2, 112, False, 30, 0.0, 20),
        (1, 200, 50, 4, 2, 64, False, 0, 0.0, 0),
    ],
)
def test_flash_bwd_at_offset_matches_plain(cuda, b, tq, tk, h, kvh, hd, causal, window, softcap,
                                           q_offset):
    q, k, v = _flash_inputs(cuda, b, tq, tk, h, kvh, hd, torch.float32, seed=tq + hd)
    _bwd_check(q, k, v, dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset))


# bwd_wide's head split (csrc/attn_plan.h: bwd_kv_head_splits): hd-256 shapes
# whose dK/dV grid is under a wave of SMs and whose dQ grid is not (off the
# dS path), GQA groups of 16, 8 and 4: (b, tq, tk, h, kvh, causal, window,
# softcap, q_offset)
HEAD_SPLIT_SHAPES = {
    # recurrentgemma-9b's training attention: 64 dK/dV blocks, 2 subsets of 8
    "griffin": (1, 4096, 4096, 16, 1, True, 2048, 0.0, 0),
    # ragged T, softcap: 10 blocks, 13 subsets of 1 or 2 heads
    "mqa16_ragged_softcap": (1, 577, 577, 16, 1, True, 100, 30.0, 0),
    # 18 blocks, 7 subsets of 1 or 2
    "mqa8_ragged": (1, 1100, 1100, 8, 1, True, 0, 0.0, 0),
    # 44 blocks, 3 subsets of 1, 1, 2 heads; bidirectional, window, softcap
    "gqa4_bidirectional": (2, 700, 700, 8, 2, False, 200, 20.0, 0),
    # at a query offset (an island of 600 rows over 1000 keys): 8 subsets
    "mqa16_offset": (1, 600, 1000, 16, 1, True, 0, 0.0, 400),
    # a cross-attention, Tq != Tk: 48 blocks, 2 subsets of 4
    "gqa8_cross": (1, 530, 1500, 16, 2, False, 0, 0.0, 0),
    # an island with a window and a softcap: 60 blocks, 2 subsets of 2
    "gqa4_offset_window_softcap": (1, 700, 900, 16, 4, True, 50, 25.0, 200),
}


def _head_split_inputs(cuda, name, kv_dtype, seed=0):
    b, tq, tk, h, kvh, causal, window, softcap, off = HEAD_SPLIT_SHAPES[name]
    q, k, v = _flash_inputs(cuda, b, tq, tk, h, kvh, 256, torch.float32, seed=seed + tq)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
    return q, k.to(kv_dtype), v.to(kv_dtype), kw


def _head_split_plan(q, k, kw):
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    b, tq, h, hd = q.shape
    return fa_k.bwd_plan(hd, b, tq, k.shape[1], h, k.shape[2], causal=kw["causal"],
                         window=kw["window"], q_offset=kw["q_offset"], sms=sms,
                         kv_bf16=k.dtype == torch.bfloat16)


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(HEAD_SPLIT_SHAPES))
def test_flash_bwd_head_split_matches_plain(cuda, name, kv_dtype):
    """The head-split dK/dV pass (partials merged in subset order), float32
    k/v and bf16 k/v taken as they are (one part), against the plain
    backward; each call counted once in head_split_launches, and bf16 k/v
    in bf16_kv_launches."""
    q, k, v, kw = _head_split_inputs(cuda, name, kv_dtype)
    plan = _head_split_plan(q, k, kw)
    bf16 = kv_dtype == torch.bfloat16
    assert plan.chunks == 0 and plan.head_splits > 1 and plan.kv_parts == (1 if bf16 else 3)
    before = fa_k.head_split_launches["bwd_wide"], fa_k.bf16_kv_launches["bwd_wide"]
    _bwd_check(q, k, v, kw)
    assert (fa_k.head_split_launches["bwd_wide"], fa_k.bf16_kv_launches["bwd_wide"]) == \
        (before[0] + 1, before[1] + int(bf16))


@pytest.mark.parametrize("name", ["griffin", "mqa16_ragged_softcap", "gqa4_bidirectional",
                                  "gemma3_full_gqa2"])
def test_flash_bwd_bf16_kv_equals_float32_kv_path(cuda, name):
    """bwd_wide on bf16 k/v (one part: the three non-zero products of the
    six, in the same order) against the same call on their float32 values
    (three parts, two of them zeros): the dropped products add exact zeros,
    so dq is bit-equal and dk, dv are the float32 path's rounded to
    bfloat16.  gemma3_full_gqa2: the unsplit bf16 instance (72 dK/dV
    blocks)."""
    if name == "gemma3_full_gqa2":
        q, k, v = _flash_inputs(cuda, 1, 1100, 1100, 8, 4, 256, torch.float32, seed=11)
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        kw = dict(causal=True, window=300, softcap=0.0, q_offset=0)
        assert _head_split_plan(q, k, kw).head_splits == 1
    else:
        q, k, v, kw = _head_split_inputs(cuda, name, torch.bfloat16, seed=11)
    assert _head_split_plan(q, k, kw).kv_parts == 1
    do = torch.randn_like(q)
    o, lse = fa_k.flash_attention_lse(q, k, v, **kw)
    before = fa_k.bf16_kv_launches["bwd_wide"]
    dq, dk, dv = fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert fa_k.bf16_kv_launches["bwd_wide"] == before + 1
    dq32, dk32, dv32 = fa_k.flash_attention_bwd(q, k.float(), v.float(), o, lse, do, **kw)
    assert fa_k.bf16_kv_launches["bwd_wide"] == before + 1
    assert torch.equal(dq, dq32)
    assert torch.equal(dk, dk32.to(torch.bfloat16)) and torch.equal(dv, dv32.to(torch.bfloat16))


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_head_split_is_deterministic(cuda, kv_dtype):
    """recurrentgemma-9b's training shape: the subsets' partials merge in
    subset order, so repeats are bit-equal."""
    q, k, v, kw = _head_split_inputs(cuda, "griffin", kv_dtype, seed=4)
    assert _head_split_plan(q, k, kw).head_splits == 2
    o, lse = fa_k.flash_attention_lse(q, k, v, **kw)
    do = torch.randn_like(q)
    first = fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    for _ in range(3):
        again = fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["mqa16_ragged_softcap", "gqa4_bidirectional"])
def test_flash_bwd_head_split_reads_no_unwritten_scratch(cuda, name, kv_dtype, monkeypatch):
    """Every byte of the backward's scratch starts as 0xff (a float32 NaN):
    the dK and dV partials and the k/v parts are read only where the
    kernels wrote them, so the gradients stay finite and right."""
    made = []

    def nan_scratch(nbytes, dev):
        made.append(nbytes)
        return torch.full((nbytes,), 255, dtype=torch.uint8, device=dev)

    monkeypatch.setattr(fa_k, "_scratch_bytes", nan_scratch)
    q, k, v, kw = _head_split_inputs(cuda, name, kv_dtype, seed=2)
    plan = _head_split_plan(q, k, kw)
    got, _, _ = _bwd_check(q, k, v, kw)
    assert made == [plan.scratch_bytes]
    assert all(bool(torch.isfinite(x).all()) for x in got)


# bwd_wgmma's head split (the 128-wide template; attn_plan.h: a grid under
# two waves that subsets shorten): (b, tq, tk, h, kvh, hd, causal, window,
# softcap, q_offset)
WGMMA_HEAD_SPLIT_SHAPES = {
    # qwen3-moe's and kimi-k2's rank islands: 128 causal blocks, 2 subsets
    "qwen3_rank": (2, 4096, 4096, 4, 1, 128, True, 0, 0.0, 0),
    "kimi_rank": (2, 4096, 4096, 4, 1, 112, True, 0, 0.0, 0),
    # ragged T, a window and a softcap at hd 120
    "gqa4_ragged_window_softcap": (2, 333, 333, 8, 2, 120, True, 100, 30.0, 0),
    # an island: 300 rows at q_offset 400 of 700 keys
    "gqa4_offset": (1, 300, 700, 8, 2, 128, True, 0, 0.0, 400),
    # a cross-attention, Tq != Tk, a group of 8 over one kv head
    "mqa8_cross": (1, 200, 900, 8, 1, 128, False, 0, 0.0, 0),
}


def _wgmma_head_split_inputs(cuda, name, seed=0):
    b, tq, tk, h, kvh, hd, causal, window, softcap, off = WGMMA_HEAD_SPLIT_SHAPES[name]
    q, k, v = _flash_inputs(cuda, b, tq, tk, h, kvh, hd, torch.float32, seed=seed + tq + hd)
    return q, k, v, dict(causal=causal, window=window, softcap=softcap, q_offset=off)


@pytest.mark.parametrize("name", sorted(WGMMA_HEAD_SPLIT_SHAPES))
def test_flash_bwd_wgmma_head_split_matches_plain(cuda, name):
    """bwd_wgmma's head-split dK/dV pass (partials merged in subset order)
    against the plain backward; each call counted once in
    head_split_launches["bwd_wgmma"]."""
    q, k, v, kw = _wgmma_head_split_inputs(cuda, name)
    plan = _head_split_plan(q, k, kw)
    assert plan.chunks == 0 and plan.head_splits > 1 and plan.kv_parts == 3
    before = fa_k.head_split_launches["bwd_wgmma"]
    _bwd_check(q, k, v, kw)
    assert fa_k.head_split_launches["bwd_wgmma"] == before + 1


@pytest.mark.parametrize("name", ["qwen3_rank", "gqa4_ragged_window_softcap"])
def test_flash_bwd_wgmma_head_split_is_deterministic(cuda, name):
    """The subsets' partials merge in subset order and the two consumer
    warpgroups' sums in warpgroup order, so repeats are bit-equal."""
    q, k, v, kw = _wgmma_head_split_inputs(cuda, name, seed=4)
    o, lse = fa_k.flash_attention_lse(q, k, v, **kw)
    do = torch.randn_like(q)
    first = fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    for _ in range(3):
        again = fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


# bwd_wgmma's hd-64 template (two consumer warpgroups taking the streamed
# tiles of a block's 64 fixed rows in turns) on float32 k/v and on bf16 k/v
# (its bf16-k/v instances, one k/v part): (b, tq, tk, h, kvh, causal,
# window, softcap, q_offset)
HD64_SHAPES = {
    "causal_mha": (2, 300, 300, 4, 4, True, 0, 0.0, 0),
    # Whisper's encoder over its 1500 frames (ragged: 23 x 64 + 28) and its
    # cross-attention (448 decoder positions over them)
    "whisper_encoder": (2, 1500, 1500, 4, 4, False, 0, 0.0, 0),
    "whisper_cross": (2, 448, 1500, 4, 4, False, 0, 0.0, 0),
    "gqa4_window_softcap": (1, 700, 700, 8, 2, True, 100, 30.0, 0),
    "island": (1, 256, 1024, 4, 4, True, 0, 0.0, 768),
    "mqa4_bidirectional_window_offset": (1, 77, 200, 4, 1, False, 30, 0.0, 60),
    "one_tile": (1, 40, 40, 2, 1, True, 0, 0.0, 0),
}


def _hd64_inputs(cuda, name, kv_dtype, seed=0):
    b, tq, tk, h, kvh, causal, window, softcap, off = HD64_SHAPES[name]
    q, k, v = _flash_inputs(cuda, b, tq, tk, h, kvh, 64, torch.float32, seed=seed + tq + tk)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
    return q, k.to(kv_dtype), v.to(kv_dtype), kw


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(HD64_SHAPES))
def test_flash_bwd_hd64_matches_plain(cuda, name, kv_dtype):
    """The hd-64 template against the plain backward; bf16 k/v run the
    bf16-k/v instances (one k/v part), each call counted once in
    bf16_kv_launches["bwd_wgmma"], float32 k/v in none."""
    q, k, v, kw = _hd64_inputs(cuda, name, kv_dtype)
    bf16 = kv_dtype == torch.bfloat16
    plan = _head_split_plan(q, k, kw)
    assert (plan.chunks, plan.head_splits, plan.kv_parts) == (0, 1, 1 if bf16 else 3)
    before = dict(fa_k.bf16_kv_launches)
    _bwd_check(q, k, v, kw)
    assert fa_k.bf16_kv_launches == {**before, "bwd_wgmma": before["bwd_wgmma"] + int(bf16)}


@pytest.mark.parametrize("name", sorted(HD64_SHAPES))
def test_flash_bwd_hd64_bf16_kv_equals_float32_kv_path(cuda, name):
    """bwd_wgmma<64> on bf16 k/v (one part: the three non-zero products of
    the six, in the same order) against the same call on their float32
    values (three parts, two of them zeros): the dropped products add exact
    zeros, so dq is bit-equal and dk, dv are the float32 path's rounded to
    bfloat16."""
    q, k, v, kw = _hd64_inputs(cuda, name, torch.bfloat16, seed=11)
    do = torch.randn_like(q)
    o, lse = fa_k.flash_attention_lse(q, k, v, **kw)
    dq, dk, dv = fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    dq32, dk32, dv32 = fa_k.flash_attention_bwd(q, k.float(), v.float(), o, lse, do, **kw)
    assert torch.equal(dq, dq32)
    assert torch.equal(dk, dk32.to(torch.bfloat16)) and torch.equal(dv, dv32.to(torch.bfloat16))


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["whisper_encoder", "gqa4_window_softcap"])
def test_flash_bwd_hd64_is_deterministic(cuda, name, kv_dtype):
    """The two consumer warpgroups' sums are added in warpgroup order, so
    repeats are bit-equal."""
    q, k, v, kw = _hd64_inputs(cuda, name, kv_dtype, seed=4)
    o, lse = fa_k.flash_attention_lse(q, k, v, **kw)
    do = torch.randn_like(q)
    first = fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["whisper_encoder", "whisper_cross", "causal_mha", "island"])
def test_flash_bwd_hd64_fails_its_limit_one_key_too_few(cuda, name, kv_dtype):
    """The plain backward given one key too few (causal: a window one
    shorter than the longest row's reach; else the last key dropped) lies
    outside the limit that the kernel's gradients meet."""
    q, k, v, kw = _hd64_inputs(cuda, name, kv_dtype)
    got, _, do = _bwd_check(q, k, v, kw)
    if kw["causal"]:
        near, kn, vn = dict(kw, window=kw["q_offset"] + q.shape[1] - 1), k, v
    else:
        near, kn, vn = kw, k[:, :-1], v[:, :-1]
    o_n, lse_n = fa_r.attention_lse_ref(q, kn, vn, **near)
    exp_n = fa_r.attention_bwd_ref(q, kn, vn, o_n, lse_n, do, **near)
    within = True
    for a, e in zip(got, exp_n):
        rounded = BF16_ROUND if a.dtype == torch.bfloat16 else 0.0
        err = (a.float()[:, :e.shape[1]] - e).abs()
        within &= bool((err <= BWD_TOL + (BWD_TOL + rounded) * e.abs()).all())
    assert not within


@pytest.mark.parametrize("hd,tps", [(64, 4), (256, 2), (256, 4)])
def test_flash_bwd_islands_reassemble_the_full_call(cuda, hd, tps):
    """The sequence split's islands (rank r: rows r T / tps .. at q_offset
    r T / tps, every key): dq concatenated and dk, dv summed give the full
    call's gradients."""
    t = 512
    q, k, v = _flash_inputs(cuda, 1, t, t, 4, 2, hd, torch.float32, seed=hd)
    kw = dict(causal=True, window=0, softcap=0.0)
    full, _, do = _bwd_check(q, k, v, kw)
    tl = t // tps
    dq, dk, dv = [], torch.zeros_like(k), torch.zeros_like(v)
    for r in range(tps):
        rows = slice(r * tl, (r + 1) * tl)
        ql, dol = q[:, rows].contiguous(), do[:, rows].contiguous()
        o, lse = fa_k.flash_attention_lse(ql, k, v, **kw, q_offset=r * tl)
        g = fa_k.flash_attention_bwd(ql, k, v, o, lse, dol, **kw, q_offset=r * tl)
        dq.append(g[0])
        dk += g[1]
        dv += g[2]
    for name, a, e in zip("qkv", (torch.cat(dq, 1), dk, dv), full):
        torch.testing.assert_close(a, e, atol=BWD_TOL, rtol=BWD_TOL, msg=f"d{name}")


# -- the key split of the hd-256 float32 designs (csrc/attn_plan.h) ---------------

# islands that split: name -> (tq, tk, h, kvh, q_offset): gemma3-4b's last
# island at tp 16 (32 blocks, 4 chunks), and a smaller one (8 blocks, 4 chunks)
SPLIT_ISLANDS = {
    "gemma3_island": (256, 4096, 8, 4, 3840),
    "small_island": (128, 1024, 4, 2, 896),
}


def _island(cuda, name, seed=0):
    tq, tk, h, kvh, off = SPLIT_ISLANDS[name]
    q, k, v = _flash_inputs(cuda, 1, tq, tk, h, kvh, 256, torch.float32, seed=seed + tq)
    return q, k, v, dict(causal=True, window=0, softcap=0.0, q_offset=off)


def _split_check(q, k, v, kw):
    """The split forward (with lse) and the dS-path backward against their
    plain versions; each call counted once in split_launches."""
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    b, tq, h, _ = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    pkw = dict(causal=kw["causal"], window=kw["window"], q_offset=kw["q_offset"])
    assert fa_k.tiled_plan(b, tq, tk, h, kvh, kv_len=tk, sms=sms, **pkw).chunks > 1
    assert fa_k.bwd_plan(256, b, tq, tk, h, kvh, sms=sms, **pkw).chunks > 1
    before = dict(fa_k.split_launches)
    o, lse = fa_k.flash_attention_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    o_r, lse_r = fa_r.attention_lse_ref(q, k, v, **kw)
    torch.testing.assert_close(o, o_r, atol=FLASH_TOL, rtol=FLASH_TOL)
    torch.testing.assert_close(lse, lse_r, atol=FLASH_TOL, rtol=FLASH_TOL)
    got, _, _ = _bwd_check(q, k, v, kw)       # one more split forward, and the backward
    after = fa_k.split_launches
    assert {d: after[d] - before[d] for d in after} == {"flash_tiled": 2, "bwd_wide": 1}
    return (o, lse), got


@pytest.mark.parametrize("name", sorted(SPLIT_ISLANDS))
def test_key_split_matches_plain_at_islands(cuda, name):
    _split_check(*_island(cuda, name))


def test_key_split_rows_without_keys(cuda):
    """kv_len = 0, and rows past kv_len + window: the split forward (no lse,
    all Tk keys in chunks) gives them the uniform mean of v."""
    q, k, v = _flash_inputs(cuda, 1, 200, 1500, 4, 2, 256, torch.float32, seed=2)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for kw in (dict(kv_len=0), dict(kv_len=300, window=16, q_offset=280)):
        full = dict(dict(window=0, q_offset=0), **kw)
        assert fa_k.tiled_plan(1, 200, 1500, 4, 2, causal=True, sms=sms, **full).chunks > 1
        before = fa_k.split_launches["flash_tiled"]
        got = fa_k.flash_attention(q, k, v, causal=True, **kw)
        assert fa_k.split_launches["flash_tiled"] == before + 1
        torch.testing.assert_close(got, fa_r.attention_ref(q, k, v, causal=True, **kw),
                                   atol=FLASH_TOL, rtol=FLASH_TOL)
    mean = v.mean(1, keepdim=True).repeat_interleave(2, 2).expand(-1, 200, -1, -1)
    torch.testing.assert_close(fa_k.flash_attention(q, k, v, kv_len=0), mean,
                               atol=FLASH_TOL, rtol=FLASH_TOL)


def test_key_split_is_deterministic(cuda):
    """The chunks merge in chunk order: repeats of the split forward and the
    dS-path backward are bit-equal."""
    q, k, v, kw = _island(cuda, "gemma3_island", seed=1)
    do = torch.randn_like(q)
    o, lse = fa_k.flash_attention_lse(q, k, v, **kw)
    first = fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    for _ in range(3):
        o2, lse2 = fa_k.flash_attention_lse(q, k, v, **kw)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        again = fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("name", sorted(SPLIT_ISLANDS))
def test_key_split_reads_no_unwritten_scratch(cuda, name, monkeypatch):
    """Every byte of the calls' scratch starts as 0xff (a float32 NaN): the
    forward's partials and the backward's dS and dQ partials are read only
    where the kernels wrote them, so the results stay finite and right."""
    made = []

    def nan_scratch(nbytes, dev):
        made.append(nbytes)
        return torch.full((nbytes,), 255, dtype=torch.uint8, device=dev)

    monkeypatch.setattr(fa_k, "_scratch_bytes", nan_scratch)
    (o, lse), grads = _split_check(*_island(cuda, name, seed=2))
    assert len(made) == 3   # two split forwards and the backward
    assert all(bool(torch.isfinite(x).all()) for x in (o, lse, *grads))


def test_key_split_wider_after_narrower(cuda):
    """A wider split call right after a narrower one, and back (the C 5
    pattern): each call's scratch is its own, so both are right in either
    order."""
    narrow, wide = _island(cuda, "small_island", seed=3), _island(cuda, "gemma3_island", seed=3)
    for case in (narrow, wide, narrow, wide):
        _split_check(*case)


def test_kimi_head_width_runs(cuda):
    """Head width 112 (kimi-k2) in the 128-wide template: the bf16 and
    float32 prefill designs, decode, and the backward."""
    q, k, v = _flash_inputs(cuda, 1, 300, 300, 8, 2, 112, torch.float32, seed=112)
    for kv, tq in ((k, 300), (k.to(torch.bfloat16), 300), (k.to(torch.bfloat16), 1)):
        vv = v.to(kv.dtype)
        kw = dict(causal=True, q_offset=300 - tq, kv_len=300)
        torch.testing.assert_close(fa_k.flash_attention(q[:, :tq], kv, vv, **kw),
                                   fa_r.attention_ref(q[:, :tq], kv, vv, **kw),
                                   atol=FLASH_TOL, rtol=FLASH_TOL)
    _bwd_check(q, k, v, dict(causal=True, window=0, softcap=0.0))


@pytest.mark.parametrize("hd,window", [(64, 0), (256, 1024), (120, 4096)])
def test_flash_bwd_main_path_shapes_and_one_key_too_few(cuda, hd, window):
    """minicpm-2b's, gemma3-4b's and h2o-danube's train shapes at 4096
    positions (heads cut to 4); the limit must see one key too few."""
    kvh = {64: 4, 256: 2, 120: 1}[hd]
    q, k, v = _flash_inputs(cuda, 1, 4096, 4096, 4, kvh, hd, torch.float32, seed=hd)
    kw = dict(causal=True, window=window, softcap=0.0)
    got, _, do = _bwd_check(q, k, v, kw)
    near = dict(kw, window=(window or 4096) - 1)
    o_n, lse_n = fa_r.attention_lse_ref(q, k, v, **near)
    exp_n = fa_r.attention_bwd_ref(q, k, v, o_n, lse_n, do, **near)
    assert not all(torch.allclose(a, e, atol=BWD_TOL, rtol=BWD_TOL) for a, e in zip(got, exp_n))


@pytest.mark.parametrize("hd", [64, 256])
def test_flash_bwd_is_deterministic(cuda, hd):
    q, k, v = _flash_inputs(cuda, 2, 700, 700, 8, 2, hd, torch.float32, seed=5)
    kw = dict(causal=True, window=300, softcap=0.0)
    o, lse = fa_k.flash_attention_lse(q, k, v, **kw)
    do = torch.randn_like(q)
    first = fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    for _ in range(3):
        again = fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_flash_autograd_through_the_kernels(cuda):
    """ops.flash_attention with q, k, v requiring grad: one forward and one
    backward launch, grads as the plain versions give on the CPU."""
    q, k, v = _flash_inputs(cuda, 2, 150, 150, 8, 4, 64, torch.float32, seed=9)
    do = torch.randn_like(q)
    kw = dict(causal=True, window=50, softcap=25.0)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = fa_k.launches, fa_k.bwd_launches
    out = fa_ops.flash_attention(*leaves, **kw)
    out.backward(do)
    assert (fa_k.launches, fa_k.bwd_launches) == (before[0] + 1, before[1] + 1)
    cpu = [x.cpu().requires_grad_() for x in (q, k, v)]
    out_c = fa_ops.flash_attention(*cpu, **kw)
    out_c.backward(do.cpu())
    torch.testing.assert_close(out.detach().cpu(), out_c.detach(), atol=FLASH_TOL, rtol=FLASH_TOL)
    for a, e in zip(leaves, cpu):
        torch.testing.assert_close(a.grad.cpu(), e.grad, atol=BWD_TOL, rtol=BWD_TOL)


BF16_U = 2.0**-8  # bfloat16's unit roundoff (round to nearest)


def _bf16_grad_ok(got, exact, term):
    """Whether bfloat16 gradients ``got`` lie within what the kernel may give
    of the exact float32 ones: its float32 value x' within BWD_TOL of x =
    ``exact`` - ``term``, rounded to bfloat16, and where ``term`` (the rows
    that see no key, added after the kernel) is not None, x' + term rounded
    again.  |got - exact| <= B (1 + u) + u |x| (the first rounding, where
    there are two) + u |got| / (1 - u) (the last), B = BWD_TOL (1 + |x|).
    (ok, the largest |got - exact| over its bound)."""
    u = BF16_U
    x = exact if term is None else exact - term
    bound = BWD_TOL * (1 + x.abs()) * (1 + u) + u / (1 - u) * got.abs()
    if term is not None:
        bound = bound + u * x.abs()
    ratio = float(((got - exact).abs() / bound).max())
    return ratio <= 1.0, ratio


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,kw", [
    (64, dict(q_offset=40, kv_len=150)),             # a partly filled cache
    (128, dict(q_offset=110, window=40)),            # rows past the keys; the last see none
    (256, dict(q_offset=-10, kv_len=170)),           # rows before the first key
    (112, dict(q_offset=200, window=8, kv_len=120)),  # no row sees a key
])
def test_flash_autograd_through_a_cache_and_past_the_keys(cuda, hd, kw, kv_dtype):
    """The gradient at kv_len < Tk and of rows that lie past (or before) the
    keys, through the kernels (one forward and one backward launch, on the
    first kv_len keys), against the plain versions' exact float32 gradient
    on the CPU (k, v as their float32 values): BWD_TOL, and for bfloat16 dk,
    dv the roundings to bfloat16 (``_bf16_grad_ok``).  Where a row sees the
    last key, the kernels given one key too few fail that check."""
    q, k, v = _flash_inputs(cuda, 2, 120, 180, 8, 2, hd, kv_dtype, seed=11)
    do = torch.randn_like(q)
    kw = dict(causal=True, **kw)

    def grads(**over):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fa_ops.flash_attention(*leaves, **{**kw, **over})
        out.backward(do)
        return out.detach().cpu(), [x.grad.float().cpu() for x in leaves]

    before = fa_k.launches, fa_k.bwd_launches
    out, got = grads()
    assert (fa_k.launches, fa_k.bwd_launches) == (before[0] + 1, before[1] + 1)
    cpu = [x.cpu().float().detach().requires_grad_() for x in (q, k, v)]
    out_c = fa_ops.flash_attention(*cpu, **kw)
    out_c.backward(do.cpu())
    exact = [x.grad for x in cpu]
    term = fa_ops._empty_rows_dv(do.cpu(), cpu[1], causal=True, window=kw.get("window", 0),
                                 q_offset=kw["q_offset"], kv_len=kw.get("kv_len"))

    def ok(g):
        if not torch.allclose(g[0], exact[0], atol=BWD_TOL, rtol=BWD_TOL):
            return False, "dq"
        if kv_dtype == torch.float32:
            return all(torch.allclose(a, e, atol=BWD_TOL, rtol=BWD_TOL)
                       for a, e in zip(g[1:], exact[1:])), "dk, dv"
        (ok_k, r_k), (ok_v, r_v) = (_bf16_grad_ok(g[1], exact[1], None),
                                    _bf16_grad_ok(g[2], exact[2], term))
        return ok_k and ok_v, f"dk {r_k:.3f}, dv {r_v:.3f} of their bounds"

    torch.testing.assert_close(out, out_c.detach(), atol=FLASH_TOL, rtol=FLASH_TOL)
    good, why = ok(got)
    assert good, why
    kv_len = kw.get("kv_len")
    seen = fa_r.key_mask(120, 180, causal=True, window=kw.get("window", 0),
                         q_offset=kw["q_offset"], kv_len=kv_len, device="cpu")
    if kv_len is not None and seen[:, kv_len - 1].any():
        _, short = grads(kv_len=kv_len - 1)
        assert not ok(short)[0], "one key too few passes the check"


@pytest.mark.parametrize("hd,design", [(32, "bwd_wgmma"), (64, "bwd_wgmma"),
                                       (120, "bwd_wgmma"), (128, "bwd_wgmma"),
                                       (256, "bwd_wide")])
def test_flash_bwd_design_that_ran(cuda, hd, design):
    """Every width runs on the tensor cores: hd 64 (minicpm-2b's training
    path) in bwd_wgmma, gemma3-4b's 256 in bwd_wide."""
    q, k, v = _flash_inputs(cuda, 1, 130, 130, 4, 2, hd, torch.float32, seed=hd)
    before = dict(fa_k.bwd_design_launches)
    _bwd_check(q, k, v, dict(causal=True, window=0, softcap=0.0))
    after = fa_k.bwd_design_launches
    assert {d: after[d] - before[d] for d in after} == \
        {d: int(d == design) for d in after}
    assert fa_k.bwd_design(hd) == design


@pytest.mark.parametrize("hd", [64, 256])
def test_flash_bwd_is_deterministic_at_the_train_shape(cuda, hd):
    """minicpm-2b's train shape [2, 4096, 36, 64] and gemma3-4b's global
    layer [1, 4096, 8 / 4, 256]: repeats are bit-equal."""
    b, h, kvh = (2, 36, 36) if hd == 64 else (1, 8, 4)
    q, k, v = _flash_inputs(cuda, b, 4096, 4096, h, kvh, hd, torch.float32, seed=4)
    kw = dict(causal=True, window=0, softcap=0.0)
    o, lse = fa_k.flash_attention_lse(q, k, v, **kw)
    do = torch.randn_like(q)
    first = fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    for _ in range(4):
        again = fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


# -- the communicator on the card -------------------------------------------------

def _collectives(comm, xs, mx):
    w = comm.world_size
    return [comm.allreduce(xs), comm.allreduce(xs, op=mx), comm.reduce_scatter(xs),
            comm.reduce_scatter(xs, op=mx), comm.allgather(xs),
            comm.allgatherv([x[: 3 * r] for r, x in enumerate(xs)]), comm.bcast(xs[1], root=1),
            comm.gather(xs, root=w - 1), comm.scatter(xs), comm.alltoall(
                [[x[d * 4:(d + 1) * 4] for d in range(w)] for x in xs]),
            comm.alltoallv([[x[:d] for d in range(w)] for x in xs])[0],
            comm.wait(comm.iallreduce(xs)), comm.wait(comm.iallgatherv(xs)),
            comm.wait(comm.ialltoallv([[x[:d] for d in range(w)] for x in xs]))[0]]


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _flat(v)]
    return [x]


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.int64])
@pytest.mark.parametrize("fabric", ["direct", "hybrid", "s3"])
def test_collectives_on_the_card_match_the_cpu(cuda, dtype, fabric):
    """Every collective on CUDA tensors: results stay on the card, each rank
    its own buffer, bit-equal to the same calls on the CPU, and the same
    priced events."""
    from repro_torch.core import make_communicator
    from repro_torch.core.session import hybrid_session

    w = 8

    def comm():
        if fabric == "hybrid":
            return hybrid_session(w, [(0, 3), (1, 2), (5, 7)], relay="redis").communicator()
        return make_communicator(w, fabric)

    gen = torch.Generator().manual_seed(w)
    xs = [(torch.randn(w * 64, 3, generator=gen) * 1000).to(dtype) for _ in range(w)]
    cd, cc = comm(), comm()
    got = _flat(_collectives(cd, [x.to(cuda) for x in xs], torch.maximum))
    exp = _flat(_collectives(cc, xs, torch.maximum))
    assert len(got) == len(exp)
    tensors = [g for g in got if isinstance(g, torch.Tensor)]
    assert all(g.device.type == "cuda" for g in tensors)
    assert len({g.data_ptr() for g in tensors if g.numel()}) == \
        len([g for g in tensors if g.numel()])
    for g, e in zip(got, exp):
        if isinstance(e, torch.Tensor):
            assert g.dtype == e.dtype and torch.equal(g.cpu(), e)
        else:
            assert g == e
    rows = lambda c: [(e.kind, e.bytes_per_rank, e.algo, e.relay, e.relayed_pairs,  # noqa: E731
                       e.wire_total, e.time_s) for e in c.events]
    assert rows(cd) == rows(cc)


@pytest.mark.parametrize("fabric", ["hybrid", "s3"])
def test_sim_join_over_other_fabrics_gives_the_direct_rows(cuda, fabric):
    """``sim_join`` over a hybrid (relayed pairs) and an S3 communicator on
    the card: the all-direct run's rows, bit for bit; only the price moves."""
    from repro_torch.core import make_communicator
    from repro_torch.core.backends.mediated import s3_communicator
    from repro_torch.core.session import hybrid_session
    from repro_torch.dataframe import Table, ops_dist

    p, rows = 8, 20000
    gen = torch.Generator(device=cuda).manual_seed(5)
    lk = torch.randperm(4 * rows * p, generator=gen, device=cuda)[: rows * p].to(torch.int32)
    rk = torch.randperm(4 * rows * p, generator=gen, device=cuda)[: rows * p].to(torch.int32)
    v = torch.arange(rows * p, device=cuda, dtype=torch.int32)
    left = [Table.from_dict({"k": lk[i * rows:(i + 1) * rows], "v": v[i * rows:(i + 1) * rows]},
                            device=cuda) for i in range(p)]
    right = [Table.from_dict({"k": rk[i * rows:(i + 1) * rows], "w": -v[i * rows:(i + 1) * rows]},
                             device=cuda) for i in range(p)]
    direct = make_communicator(p, "direct")
    ref = ops_dist.sim_join(left, right, "k", direct)
    comm = (hybrid_session(p, [(0, 1), (2, 6), (3, 7)], relay="redis").communicator()
            if fabric == "hybrid" else s3_communicator(p))
    before = (hp_k.launches, jp_k.launches)
    out = ops_dist.sim_join(left, right, "k", comm)
    assert (hp_k.launches - before[0], jp_k.launches - before[1]) == (2 * p, p)
    for a, b in zip(out, ref):
        n = int(b.count)
        assert int(a.count) == n and n > 0
        assert all(a.columns[c].device.type == "cuda" and torch.equal(a.columns[c][:n],
                                                                     b.columns[c][:n])
                   for c in b.columns)
    assert comm.comm_time_s > direct.comm_time_s


# -- the BSP runtime, the job executor and the codec on the card ----------------

def _sleep_cycles(cuda, ms: float) -> int:
    """Cycles of ``torch.cuda._sleep`` that keep the card busy >= ``ms``
    (timed with CUDA events)."""
    cycles = 1 << 20
    while True:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        torch.cuda.synchronize()
        if start.elapsed_time(end) >= ms:
            return cycles
        cycles *= 2


def test_measured_compute_waits_for_the_card(cuda):
    """A rank function (and a map task) that launches ~10 ms of device work
    returns at once; the runtime and the executor drain the card before the
    closing stamp, so each reports at least 10 ms / cpu_speed."""
    from repro_torch.core import BSPRuntime
    from repro_torch.jobs import JobExecutor

    cycles = _sleep_cycles(cuda, 10.0)

    def busy(*_):
        torch.cuda._sleep(cycles)
        return 0

    rt = BSPRuntime(2, provider="aws-lambda", device=cuda)
    _, rep = rt.run([("sleep", lambda r, s, c, w: busy())], [0, 0])
    floor = 0.010 / rt.platform.cpu_speed
    assert rep.supersteps[0].compute_s >= floor
    assert all(s.duration_s >= floor for s in rt.tracer.spans if s.lane == "compute")
    ex = JobExecutor(provider="aws-lambda", device=cuda)
    fs = ex.map(busy, range(2))
    assert all(f.record.attempts[0].billed_s >= 0.010 / ex.provider.platform.cpu_speed
               for f in fs)
    red = JobExecutor(provider="aws-lambda", device=cuda).map_reduce(
        busy, range(2), lambda rs: busy())
    assert red.job.reduce_s >= 0.010 / ex.provider.platform.cpu_speed


@pytest.mark.parametrize("exact", [True, False])
def test_codec_round_trip_on_the_card(cuda, exact):
    """Every codec kind on CUDA tensors: the CPU encoding's kinds, parts and
    wire bytes, every part on the card, and the CPU decoding."""
    from repro_torch.dist import compression as codec

    i32, i64 = np.iinfo(np.int32), np.iinfo(np.int64)
    rng = np.random.default_rng(4)
    cols = [
        np.array([], np.int32), np.array([i32.min, i32.max, 0], np.int32),
        np.array([i32.min, i32.min + 200] * 70, np.int32),
        (i32.max - rng.integers(0, 60000, 3000)).astype(np.int32),
        np.array([i32.min, 0, i32.max] * 300, np.int32),
        np.array([i64.min, i64.max, 0], np.int64),
        np.array([i64.max, i64.max - 65535, i64.max - 7] * 30, np.int64),
        np.array([i64.min, i64.min + 2**32 - 1] * 10, np.int64),
        np.arange(70000, dtype=np.int64) * 3 - 10**12,
        (rng.normal(size=1000) * 40).astype(np.float32), rng.normal(size=77),
    ]
    kinds = set()
    for col in cols:
        host = torch.from_numpy(col)
        c = codec.encode_column(host, exact=exact)
        g = codec.encode_column(host.to(cuda), exact=exact)
        kinds.add(g.kind)
        assert (g.kind, g.count, g.origin, g.wire_nbytes, g.raw_nbytes) == \
            (c.kind, c.count, c.origin, c.wire_nbytes, c.raw_nbytes)
        for name, part in g.parts.items():
            assert part.device.type == "cuda" and part.dtype == c.parts[name].dtype
            assert torch.equal(part.cpu(), c.parts[name]), name
        dec = codec.decode_column(g)
        assert dec.device.type == "cuda" and torch.equal(dec.cpu(), codec.decode_column(c))
    assert kinds >= ({"raw", "narrow", "dict"} | (set() if exact else {"int8"}))


def test_repartition_states_and_checkpoints_on_the_card(cuda):
    from repro_torch.core import BSPRuntime, FaultPlan
    from repro_torch.dist.object_store import S3Store
    from repro_torch.dist.sharding import repartition_states

    states = [torch.arange(r * 5, r * 5 + 5, dtype=torch.float64, device=cuda)
              for r in range(6)]
    for new in (1, 4, 5, 9):
        parts = repartition_states(states, new)
        host = repartition_states([s.cpu() for s in states], new)
        assert [p.shape for p in parts] == [h.shape for h in host]
        assert all(p.device.type == "cuda" and torch.equal(p.cpu(), h)
                   for p, h in zip(parts, host))

    def step(rank, state, comm, world):
        return state * 2.0 + 1.0

    runs = []
    for device in (cuda, torch.device("cpu")):
        store = S3Store()
        rt = BSPRuntime(6, provider="aws-lambda", checkpoint_dir=store, device=device,
                        cpu_scale=0.0)
        out, rep = rt.run([(f"s{i}", step) for i in range(3)], [s.to(device) for s in states],
                          faults=FaultPlan(rank_losses=((1, 5),)), recovery_policy="shrink")
        assert all(s.device.type == device.type for s in out)
        ckpt = BSPRuntime.latest_checkpoint(store, device=device)
        assert all(s.device.type == device.type for s in ckpt["states"])
        runs.append((torch.cat([s.cpu() for s in out]), rep,
                     [(op.kind, op.nbytes, op.time_s) for op in store.ops]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert runs[0][1:] == runs[1][1:]


# -- the MoE, RWKV-6, Griffin and Whisper families ------------------------------

@pytest.mark.parametrize("q_shape,kv_shape,kw", [
    # whisper-medium's encoder over its 1500 frames (non-causal, 23 x 64 + 28 keys)
    ((2, 1500, 16, 64), (2, 1500, 16, 64), dict(causal=False)),
    # its cross-attention of the 4-token prompt (flash_decode)
    ((2, 4, 16, 64), (2, 1500, 16, 64), dict(causal=False)),
    # 16 rows per kv head at decode: qwen3-moe (64 / 4 heads of 128) and
    # recurrentgemma (16 / 1 of 256, window 2048), past SPLIT_ROWS
    ((2, 1, 64, 128), (2, 2080, 4, 128), dict(q_offset=2048, kv_len=2049)),
    ((2, 1, 16, 256), (2, 4128, 1, 256), dict(window=2048, q_offset=4096, kv_len=4097)),
    # qwen3-moe's prefill: 16 query heads per kv head over its 2080-position cache
    ((2, 2048, 64, 128), (2, 2080, 4, 128), dict(kv_len=2048)),
    # whisper's decoder self-attention over its 128-position cache: the
    # 4-token prompt and the last decode step (flash_decode)
    ((2, 4, 16, 64), (2, 128, 16, 64), dict(kv_len=4)),
    ((2, 1, 16, 64), (2, 128, 16, 64), dict(q_offset=126, kv_len=127)),
])
def test_flash_forward_at_the_families_shapes(cuda, q_shape, kv_shape, kw):
    rng = np.random.default_rng(q_shape[1] + kv_shape[1])
    q = torch.tensor(rng.normal(size=q_shape), dtype=torch.float32, device=cuda)
    k, v = (torch.tensor(rng.normal(size=kv_shape), dtype=torch.float32,
                         device=cuda).to(torch.bfloat16) for _ in range(2))
    design = fa_k.fwd_design(q_shape[3], torch.bfloat16, q_shape[1] * q_shape[2] // kv_shape[2])
    assert design == ("flash_decode" if q_shape[1] * q_shape[2] // kv_shape[2] <= 8
                      else "flash_wgmma")
    before = fa_k.fwd_design_launches[design]
    got = fa_k.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_k.fwd_design_launches[design] == before + 1
    torch.testing.assert_close(got, fa_r.attention_ref(q, k, v, **kw), atol=FLASH_TOL,
                               rtol=FLASH_TOL)


@pytest.mark.parametrize("arch,over,tol", [
    ("qwen3-moe-235b-a22b", dict(num_layers=1), 1e-4),
    ("rwkv6-7b", dict(num_layers=1), 1e-4),
    ("recurrentgemma-9b", dict(num_layers=3), 2e-2),
    ("whisper-medium", dict(num_layers=1, encoder_layers=1), 2e-2),
])
def test_family_full_width_forward_on_the_card(cuda, monkeypatch, arch, over, tol):
    """One full-width layer (Griffin: one rec, rec, attn group) of each
    family on the card against the plain versions on the CPU, from the same
    weights: 1e-4 where the model computes in float32, 2e-2 where its
    activations are bfloat16 (Griffin's bfloat16 logits: of the largest),
    with bfloat16 products summed in float32 as the entry points require."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import api

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction",
                        False)
    cfg = dataclasses.replace(configs.get(arch), **over)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = api.init_params(cfg, gen, device=cuda)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16), generator=gen, device=cuda,
                                     dtype=torch.int32)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((2, cfg.source_positions, cfg.d_model), generator=gen,
                                      device=cuda)

    def cpu(tree):
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(cpu(v) for v in tree)
        return tree.cpu()

    with torch.inference_mode():
        got, _ = api.logits_fn(cfg, params, batch)
        exp, _ = api.logits_fn(cfg, cpu(params), cpu(batch))
    assert got.dtype == exp.dtype and bool(torch.isfinite(got).all())
    atol = tol * max(1.0, float(exp.float().abs().max())) if exp.dtype == torch.bfloat16 else tol
    torch.testing.assert_close(got.cpu().float(), exp.float(), atol=atol, rtol=tol)


def test_flash_decode_after_a_narrower_decode(cuda):
    """The decode design's scratch is shared by every call: a call over 16
    (batch, kv head) pairs leaves partials where a later call over 64 pairs
    keeps its counters (gemma3's decode, then whisper's cross-attention).
    Both must be right, in either order."""
    rng = np.random.default_rng(64)

    def case(b, kvh, tk):
        q = torch.tensor(rng.normal(size=(b, 1, kvh, 64)), dtype=torch.float32, device=cuda)
        k, v = (torch.tensor(rng.normal(size=(b, tk, kvh, 64)), dtype=torch.float32,
                             device=cuda).to(torch.bfloat16) for _ in range(2))
        return q, k, v

    narrow, wide = case(4, 4, 4097), case(4, 16, 1500)
    for q, k, v in (narrow, wide, narrow, wide):
        got = fa_k.flash_attention(q, k, v, causal=False)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, fa_r.attention_ref(q, k, v, causal=False),
                                   atol=FLASH_TOL, rtol=FLASH_TOL)


# -- the training path with bfloat16 k/v (the families' training) -----------------

# (q, k/v shapes, mask): q float32 (Whisper's encoder: the float32 values of
# bfloat16 q, as ``layers.attention`` passes them), k/v bfloat16
BF16_TRAIN_SHAPES = {
    # recurrentgemma-9b's local MQA: 16 query heads over 1 kv head of 256
    "griffin_local": ((1, 4096, 16, 256), (1, 4096, 1, 256), dict(causal=True, window=2048)),
    # whisper-medium's encoder over its 1500 frames (non-causal, 23 x 64 + 28)
    "whisper_encoder": ((4, 1500, 16, 64), (4, 1500, 16, 64), dict(causal=False)),
    # its cross-attention: 448 decoder positions over the 1500 frames
    "whisper_cross": ((4, 448, 16, 64), (4, 1500, 16, 64), dict(causal=False)),
}
# dk and dv come back rounded to bfloat16: BWD_TOL on their float32 values,
# plus one rounding (half an ulp is 2^-9 of the value; 2^-8 allowed)
BF16_ROUND = 2.0**-8


def _bf16_train_inputs(cuda, name, seed=0):
    q_shape, kv_shape, kw = BF16_TRAIN_SHAPES[name]
    rng = np.random.default_rng(seed + q_shape[1])
    q = torch.tensor(rng.normal(size=q_shape), dtype=torch.float32, device=cuda)
    if name == "whisper_encoder":
        q = q.to(torch.bfloat16).float()
    k, v = (torch.tensor(rng.normal(size=kv_shape), dtype=torch.float32,
                         device=cuda).to(torch.bfloat16) for _ in range(2))
    return q, k, v, dict(dict(window=0, softcap=0.0, q_offset=0), **kw)


def _bf16_train_check(q, k, v, kw, seed=0):
    """flash_attention_lse (flash_wgmma, bf16 k/v) and flash_attention_bwd
    against the plain versions: o and lse within FLASH_TOL, dq within
    BWD_TOL, dk and dv (bfloat16) within BWD_TOL plus one rounding."""
    g = torch.Generator(device=q.device).manual_seed(seed)
    do = torch.randn(q.shape, generator=g, device=q.device)
    o, lse = fa_k.flash_attention_lse(q, k, v, **kw)
    dq, dk, dv = fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert dq.dtype == torch.float32 and dk.dtype == dv.dtype == torch.bfloat16
    o_r, lse_r = fa_r.attention_lse_ref(q, k, v, **kw)
    torch.testing.assert_close(o, o_r, atol=FLASH_TOL, rtol=FLASH_TOL, msg="o")
    torch.testing.assert_close(lse, lse_r, atol=FLASH_TOL, rtol=FLASH_TOL, msg="lse")
    exp = fa_r.attention_bwd_ref(q, k, v, o, lse, do, **kw)
    torch.testing.assert_close(dq, exp[0], atol=BWD_TOL, rtol=BWD_TOL, msg="dq")
    for name, got, e in (("dk", dk, exp[1]), ("dv", dv, exp[2])):
        err = (got.float() - e).abs()
        assert bool((err <= BWD_TOL + (BWD_TOL + BF16_ROUND) * e.abs()).all()), \
            (name, float(err.max()))
    return o, lse, (dq, dk, dv)


@pytest.mark.parametrize("name", sorted(BF16_TRAIN_SHAPES))
def test_flash_bf16_kv_training_matches_plain(cuda, name):
    """The families' training attention with bfloat16 k/v: the forward with
    lse in flash_wgmma, the backward in bwd_wgmma (hd 64) or bwd_wide (hd
    256, Griffin's 16 query heads over one kv head) from the float32 values
    of k and v, each against its plain version."""
    q, k, v, kw = _bf16_train_inputs(cuda, name)
    fwd0, bwd0 = dict(fa_k.fwd_design_launches), dict(fa_k.bwd_design_launches)
    _bf16_train_check(q, k, v, kw)
    assert fa_k.fwd_design_launches["flash_wgmma"] == fwd0["flash_wgmma"] + 1
    design = fa_k.bwd_design(q.shape[3])
    assert fa_k.bwd_design_launches[design] == bwd0[design] + 1


@pytest.mark.parametrize("name", sorted(BF16_TRAIN_SHAPES))
def test_flash_bf16_kv_training_reads_no_unwritten_memory(cuda, name, monkeypatch):
    """Every byte of the forward's o and lse and of the backward's scratch
    starts as 0xff (a float32 NaN): the kernels write what they read, so the
    results stay finite and right."""
    made = []

    def nan_bytes(nbytes, dev):
        made.append(nbytes)
        return torch.full((nbytes,), 255, dtype=torch.uint8, device=dev)

    def nan_out(shape, dev):
        made.append(shape)
        return torch.full(shape, float("nan"), dtype=torch.float32, device=dev)

    monkeypatch.setattr(fa_k, "_scratch_bytes", nan_bytes)
    monkeypatch.setattr(fa_k, "_empty_out", nan_out)
    q, k, v, kw = _bf16_train_inputs(cuda, name, seed=1)
    split0 = fa_k.head_split_launches["bwd_wide"]
    o, lse, grads = _bf16_train_check(q, k, v, kw, seed=1)
    assert len(made) == 3   # o, lse and the backward's scratch
    # Griffin's backward takes the head split: its dK and dV partials lie in
    # that scratch too
    assert fa_k.head_split_launches["bwd_wide"] == split0 + int(name == "griffin_local")
    assert all(bool(torch.isfinite(x).all()) for x in (o, lse, *grads))


def test_flash_autograd_with_bf16_inputs(cuda):
    """ops.flash_attention on bfloat16 q, k, v requiring grad: the forward
    with lse on bf16 k/v, the backward kernel, each gradient in bfloat16,
    equal to the CPU path's (plain versions) within the kernels' limits
    plus one bfloat16 rounding."""
    q, k, v = _flash_inputs(cuda, 2, 200, 200, 8, 2, 64, torch.bfloat16, seed=10)
    q = q.to(torch.bfloat16)
    do = torch.randn(q.shape, device=cuda)
    kw = dict(causal=True, window=64, softcap=0.0)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa_ops.flash_attention(*leaves, **kw)
    out.backward(do)
    cpu = [x.cpu().requires_grad_() for x in (q, k, v)]
    out_c = fa_ops.flash_attention(*cpu, **kw)
    out_c.backward(do.cpu())
    torch.testing.assert_close(out.detach().cpu(), out_c.detach(), atol=FLASH_TOL,
                               rtol=FLASH_TOL)
    for a, e in zip(leaves, cpu):
        assert a.grad.dtype == e.grad.dtype == torch.bfloat16
        err = (a.grad.cpu().float() - e.grad.float()).abs()
        assert bool((err <= BWD_TOL + (BWD_TOL + 2 * BF16_ROUND) * e.grad.float().abs()).all())


def test_restore_sharded_onto_the_card(cuda):
    """A reduced minicpm-2b training state (float32 masters, int8 moments)
    restored shard by shard into a like_tree on the card: every leaf on the
    card, bit-equal to the same shard restored onto the CPU, with the same
    store ops."""
    from repro_torch import configs
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.dist import object_store as obs
    from repro_torch.dist import sharding, treepath
    from repro_torch.models import api
    from repro_torch.train import optimizer as opt

    cfg = configs.get("minicpm-2b").reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(3), device="cpu", master=True)
    tree = {"params": params, "opt": opt.init_state(params, opt.OptConfig(state_dtype="int8"))}
    store = obs.S3Store()
    ref = ckpt.save(store, 1, tree)
    sizes = {"data": 2, "model": 2}
    specs = sharding.param_specs(cfg, tree, sizes)
    on_card = treepath.tree_map(lambda t: t.to(cuda), tree)
    for d in range(2):
        for m in range(2):
            at = {"data": d, "model": m}
            store.reset_ops()
            cpu = ckpt.restore_sharded(ref, tree, specs, sizes, at)
            cpu_ops = list(store.ops)
            store.reset_ops()
            card = ckpt.restore_sharded(ref, on_card, specs, sizes, at)
            assert store.ops == cpu_ops
            for a, b in zip(treepath.leaves(card), treepath.leaves(cpu)):
                assert a.device.type == "cuda" and a.dtype == b.dtype
                assert torch.equal(a.cpu(), b)
