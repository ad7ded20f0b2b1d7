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
