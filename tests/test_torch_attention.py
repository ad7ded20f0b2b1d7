"""The port's attention on the CPU (``ops.flash_attention`` dispatches a CPU
tensor to the plain ``ref.py``) against the reference: the Pallas kernel in
interpret mode (the grid of ``tests/test_kernels.py``), ``layers.
_attention_direct`` with q_offset, a run-time window and kv_len (the cached
prefill and decode shapes), ``layers._attention_flash`` at 2048 positions,
and rows with no valid key.  Inputs come from numpy seeds.

Tolerances: 2e-5 in float32 (the sums run in another order), 2e-2 where
q/k/v are bfloat16 as ``tests/test_kernels.py`` holds them.  The CUDA
kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); here its host-side planning is checked.
"""

import heapq

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as j_fa_kernel, ref as j_fa_ref
from repro.models import layers as JL
from repro_torch.kernels.flash_attention import kernel as fa_k, ops as fa_ops, ref as fa_r
from repro_torch.models import layers as TL

F32_TOL = 2e-5


def _jt(a: np.ndarray, jdtype, tdtype):
    return jnp.asarray(a, jdtype), torch.from_numpy(a).to(tdtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "bh,bkv,tq,tk,hd,causal,window",
    [
        (4, 4, 256, 256, 64, True, 0),
        (4, 2, 128, 256, 64, True, 0),      # GQA groups=2, tq != tk
        (2, 1, 256, 256, 128, True, 64),    # MQA + sliding window
        (2, 2, 256, 512, 32, False, 0),     # bidirectional (encoder)
    ],
)
def test_heads_layout_matches_pallas(bh, bkv, tq, tk, hd, causal, window, dtype):
    rng = np.random.default_rng(0)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    qj, qt = _jt(rng.normal(size=(bh, tq, hd)).astype(np.float32), jd, td)
    kj, kt = _jt(rng.normal(size=(bkv, tk, hd)).astype(np.float32), jd, td)
    vj, vt = _jt(rng.normal(size=(bkv, tk, hd)).astype(np.float32), jd, td)
    g = bh // bkv
    exp = j_fa_kernel.flash_attention(qj, kj, vj, jnp.asarray(tk), groups=g, causal=causal,
                                      window=window, q_block=128, kv_block=128, interpret=True)
    before = fa_k.launches
    got = fa_ops.flash_attention_heads(qt, kt, vt, tk, groups=g, causal=causal, window=window)
    assert fa_k.launches == before  # a CPU tensor never reaches the kernel wrapper
    assert got.dtype == td and got.shape == (bh, tq, hd)
    tol = 2e-2 if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(exp, np.float32), atol=tol, rtol=tol)


def test_heads_layout_kv_len_and_softcap_matches_pallas():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 128, 64)).astype(np.float32)
    k = rng.normal(size=(2, 256, 64)).astype(np.float32)
    v = rng.normal(size=(2, 256, 64)).astype(np.float32)
    exp = j_fa_kernel.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(100), groups=1, causal=False, softcap=20.0,
                                      q_block=128, kv_block=128, interpret=True)
    got = fa_ops.flash_attention_heads(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), 100, groups=1, causal=False,
                                       softcap=20.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=F32_TOL, rtol=F32_TOL)
    ref = j_fa_ref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 100, groups=1,
                                 causal=False, softcap=20.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=F32_TOL, rtol=F32_TOL)


def _model_inputs(b, tq, tk, h, kvh, hd, seed, kv_bf16):
    """q float32; k/v float32 or bfloat16 (the cache's type), same values in both."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, tq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, tk, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(b, tk, kvh, hd)).astype(np.float32)
    kd = (jnp.bfloat16, torch.bfloat16) if kv_bf16 else (jnp.float32, torch.float32)
    qj, qt = _jt(q, jnp.float32, torch.float32)
    kj, kt = _jt(k, *kd)
    vj, vt = _jt(v, *kd)
    return (qj, kj, vj), (qt, kt, vt)


@pytest.mark.parametrize(
    "name,b,tq,tk,h,kvh,hd,window,q_offset,kv_len,softcap",
    [
        # prefill into a cache of prompt + max_new positions: kv_len = prompt
        ("prefill_local", 2, 160, 176, 4, 2, 32, 32, 0, 160, 0.0),
        ("prefill_global", 2, 160, 176, 4, 2, 32, 0, 0, 160, 0.0),
        ("prefill_softcap", 1, 96, 128, 8, 4, 64, 0, 0, 96, 50.0),
        # decode: one query at position kv_len - 1
        ("decode_local", 2, 1, 176, 4, 2, 32, 32, 170, 171, 0.0),
        ("decode_global", 2, 1, 176, 4, 2, 32, 0, 170, 171, 0.0),
        ("decode_gemma_width", 1, 1, 300, 8, 4, 256, 64, 250, 251, 0.0),
        # the forward path: no cache, no kv_len
        ("forward", 2, 100, 100, 4, 4, 64, 0, 0, None, 0.0),
        # a chunk of queries past the start of the cache
        ("chunk", 1, 40, 200, 4, 1, 32, 16, 120, 160, 0.0),
    ],
)
@pytest.mark.parametrize("kv_bf16", [False, True])
def test_model_layout_matches_attention_direct(name, b, tq, tk, h, kvh, hd, window, q_offset,
                                               kv_len, softcap, kv_bf16):
    (qj, kj, vj), (qt, kt, vt) = _model_inputs(b, tq, tk, h, kvh, hd, len(name), kv_bf16)
    exp = JL._attention_direct(qj, kj, vj, causal=True, window=jnp.asarray(window),
                               softcap=softcap, q_offset=q_offset,
                               kv_len=None if kv_len is None else jnp.asarray(kv_len))
    got = TL.attention(qt, kt, vt, causal=True, window=window, softcap=softcap,
                       q_offset=q_offset, kv_len=kv_len)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("window", [0, 512])
def test_model_layout_matches_attention_flash_2048(window):
    """The reference's blocked path (taken from 2048 query positions)."""
    (qj, kj, vj), (qt, kt, vt) = _model_inputs(1, 2048, 2048, 2, 1, 32, 9, kv_bf16=False)
    exp = JL._attention_flash(qj, kj, vj, causal=True, window=jnp.asarray(window), softcap=0.0,
                              q_offset=0, kv_len=None)
    got = TL.attention(qt, kt, vt, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("tq,kw", [
    (8, dict(kv_len=0)),                            # an empty cache
    (1, dict(kv_len=0, q_offset=5)),
    (6, dict(kv_len=20, window=8, q_offset=40)),    # rows past kv_len + window
])
def test_rows_without_keys_are_the_mean_of_v(tq, kw):
    (qj, kj, vj), (qt, kt, vt) = _model_inputs(2, tq, 48, 4, 2, 32, 3, kv_bf16=True)
    exp = JL._attention_direct(qj, kj, vj, causal=True, window=jnp.asarray(kw.get("window", 0)),
                               softcap=0.0, q_offset=kw.get("q_offset", 0),
                               kv_len=jnp.asarray(kw["kv_len"]))
    got = TL.attention(qt, kt, vt, causal=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=F32_TOL, rtol=F32_TOL)
    mean = vt.float().mean(1, keepdim=True).repeat_interleave(2, 2).expand(-1, tq, -1, -1)
    np.testing.assert_allclose(got.numpy(), mean.numpy(), atol=F32_TOL, rtol=F32_TOL)


SPLIT_CASES = {
    # name: (tq, tk, kw)
    "global": (40, 128, dict(window=0, q_offset=80, kv_len=120)),
    "window": (40, 128, dict(window=16, q_offset=80, kv_len=120)),
    "softcap": (40, 128, dict(window=0, q_offset=80, kv_len=120, softcap=30.0)),
    "kv_len_0": (40, 128, dict(kv_len=0)),
    "ragged_tk": (40, 77, dict(window=0, q_offset=30, kv_len=70)),
}


@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_ref_matches_attention(hd, case):
    """The tensor-core design's arithmetic (three bf16 parts of q and p,
    float32 sums) against the plain float32 version and the reference's
    _attention_direct, bf16 k/v, at the float32 limit."""
    tq, tk, kw = SPLIT_CASES[case]
    (qj, kj, vj), (qt, kt, vt) = _model_inputs(2, tq, tk, 4, 2, hd, hd + len(case), kv_bf16=True)
    block = _tile_keys(hd, torch.bfloat16)
    got = fa_r.attention_split_ref(qt, kt, vt, causal=True, block=block, **kw)
    exp = fa_r.attention_ref(qt, kt, vt, causal=True, **kw)
    np.testing.assert_allclose(got.numpy(), exp.numpy(), atol=F32_TOL, rtol=F32_TOL)
    exp_j = JL._attention_direct(qj, kj, vj, causal=True, window=jnp.asarray(kw.get("window", 0)),
                                 softcap=kw.get("softcap", 0.0), q_offset=kw.get("q_offset", 0),
                                 kv_len=jnp.asarray(kw["kv_len"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(exp_j), atol=F32_TOL, rtol=F32_TOL)


def test_split_bf16_parts_rebuild_float32_and_one_part_is_too_coarse():
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, 4096))
                         .astype(np.float32))
    parts = fa_r.split_bf16(x, 3)
    assert all(p.dtype == torch.bfloat16 for p in parts)
    rebuilt = parts[0].double() + parts[1].double() + parts[2].double()
    # three 8-bit parts hold a float32's 24-bit mantissa: within its rounding
    assert bool(((rebuilt - x.double()).abs() <= 2.0**-24 * x.double().abs()).all())
    # a single bf16 part of q and p is a different result: the 2e-5 limit sees it
    tq, tk, kw = SPLIT_CASES["global"]
    _, (qt, kt, vt) = _model_inputs(2, tq, tk, 4, 2, 256, 11, kv_bf16=True)
    exp = fa_r.attention_ref(qt, kt, vt, causal=True, **kw)
    one = fa_r.attention_split_ref(qt, kt, vt, causal=True, parts=1, **kw)
    assert not np.allclose(one.numpy(), exp.numpy(), atol=F32_TOL, rtol=F32_TOL)
    three = fa_r.attention_split_ref(qt, kt, vt, causal=True, parts=3, **kw)
    np.testing.assert_allclose(three.numpy(), exp.numpy(), atol=F32_TOL, rtol=F32_TOL)


def _visible(tq, tk, causal, window, q_offset, kv_len):
    mask = fa_r.key_mask(tq, tk, causal=causal, window=window, q_offset=q_offset,
                         kv_len=kv_len, device="cpu").numpy()
    return mask


@pytest.mark.parametrize("seed", range(6))
def test_key_range_covers_every_visible_key(seed):
    """The decode design's key range holds every key some row can see, and all
    Tk keys exactly when some row sees none."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        tq, tk = int(rng.integers(1, 9)), int(rng.integers(1, 300))
        causal = bool(rng.integers(0, 2))
        window = int(rng.choice([0, 1, 7, 64]))
        q_offset = int(rng.integers(0, 320))
        kv_len = int(rng.integers(0, tk + 20))
        lo, hi = fa_k.key_range(tq, tk, causal=causal, window=window, q_offset=q_offset,
                                kv_len=kv_len)
        mask = _visible(tq, tk, causal, window, q_offset, kv_len)
        if not mask.any(axis=1).all():
            assert (lo, hi) == (0, tk)
        else:
            cols = np.nonzero(mask.any(axis=0))[0]
            assert (lo, hi) == (cols.min(), cols.max() + 1)


@pytest.mark.parametrize("n_keys,blocks", [(1, 16), (37, 16), (1024, 16), (4097, 16),
                                           (4097, 1), (70000, 2), (5000, 512)])
def test_split_plan_chunks(n_keys, blocks):
    nsplit, chunk = fa_k.split_plan(n_keys, blocks, sms=132)
    assert 1 <= chunk <= fa_k.MAX_CHUNK
    assert (nsplit - 1) * chunk < n_keys <= nsplit * chunk  # no empty chunk
    # one wave: at most one block per SM unless MAX_CHUNK forces more chunks,
    # and as many as the SMs and MIN_CHUNK-key chunks allow
    assert nsplit * blocks <= max(132, blocks) or nsplit == -(-n_keys // fa_k.MAX_CHUNK)
    assert nsplit >= min(max(1, 132 // blocks), -(-n_keys // fa_k.MIN_CHUNK))


@pytest.mark.parametrize("n_keys,blocks", [(2_000_000, 16), (2**31 - 1, 1)])
def test_split_plan_caps_chunks(n_keys, blocks):
    """Past MAX_CHUNKS chunks of MAX_CHUNK keys the chunks grow instead, so
    the decode merge's per-chunk weights fit in shared memory."""
    nsplit, chunk = fa_k.split_plan(n_keys, blocks, sms=132)
    assert nsplit <= fa_k.MAX_CHUNKS
    assert (nsplit - 1) * chunk < n_keys <= nsplit * chunk


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 4, 2, 32)
    k = torch.zeros(1, 4, 1, 32)
    with pytest.raises(ValueError, match="CUDA"):
        fa_k.flash_attention(q, k, k)


# -- the training path: gradients ------------------------------------------------

# the reference's gradient is jax.grad through its jnp attention; the port's
# is the explicit backward (ref.attention_bwd_ref, the plain version of the
# backward kernel).  Both float32, sums in another order: 2e-5 absolute plus
# relative on outputs and grads of O(1).
GRAD_TOL = 2e-5

GRAD_CASES = {
    # name: (b, t, h, kvh, hd, causal, window, softcap)
    "causal_hd64": (2, 96, 4, 4, 64, True, 0, 0.0),
    "window_gqa_hd32": (2, 96, 4, 2, 32, True, 24, 0.0),
    "softcap_hd64": (1, 80, 4, 1, 64, True, 0, 30.0),
    "window_softcap_hd120": (1, 72, 4, 2, 120, True, 16, 50.0),
    "bidirectional_hd120": (1, 40, 2, 1, 120, False, 0, 0.0),
    "bidirectional_window_hd32": (1, 40, 4, 2, 32, False, 8, 0.0),
    # recurrentgemma-9b's local MQA group: 16 query heads over one kv head of 256
    "mqa16_window_hd256": (1, 80, 16, 1, 256, True, 24, 0.0),
}


def _grad_inputs(b, t, h, kvh, hd, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(b, t, h, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, t, kvh, hd)).astype(np.float32) for _ in range(2))
    return q, k, v, do


def _jax_grads(q, k, v, do, *, causal, window, softcap, impl):
    import jax

    def f(q_, k_, v_):
        out = JL.attention(q_, k_, v_, causal=causal, window=window, softcap=softcap, impl=impl)
        return jnp.sum(out * jnp.asarray(do)), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_grads(q, k, v, do, **kw):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = fa_k.launches, fa_k.bwd_launches
    out = TL.attention(qt, kt, vt, **kw)
    out.backward(torch.from_numpy(do))
    assert (fa_k.launches, fa_k.bwd_launches) == before  # CPU: the plain versions
    return out.detach().numpy(), [x.grad.numpy() for x in (qt, kt, vt)]


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_attention_grads_match_jax_direct(case):
    b, t, h, kvh, hd, causal, window, softcap = GRAD_CASES[case]
    q, k, v, do = _grad_inputs(b, t, h, kvh, hd, len(case))
    kw = dict(causal=causal, window=window, softcap=softcap)
    exp_o, exp_g = _jax_grads(q, k, v, do, impl="direct", **kw)
    got_o, got_g = _port_grads(q, k, v, do, **kw)
    np.testing.assert_allclose(got_o, exp_o, atol=GRAD_TOL, rtol=GRAD_TOL)
    for name, g, e in zip("qkv", got_g, exp_g):
        np.testing.assert_allclose(g, e, atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("window", [0, 700])
def test_attention_grads_match_jax_blocked_2048(window):
    """The reference's blocked branch (2048 positions, under jax.checkpoint)."""
    q, k, v, do = _grad_inputs(1, 2048, 2, 1, 32, 17)
    kw = dict(causal=True, window=window, softcap=0.0)
    exp_o, exp_g = _jax_grads(q, k, v, do, impl="flash", **kw)
    got_o, got_g = _port_grads(q, k, v, do, **kw)
    np.testing.assert_allclose(got_o, exp_o, atol=GRAD_TOL, rtol=GRAD_TOL)
    for name, g, e in zip("qkv", got_g, exp_g):
        np.testing.assert_allclose(g, e, atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("case", ["window_gqa_hd32", "window_softcap_hd120"])
def test_attention_bwd_ref_matches_autograd_of_plain_forward(case):
    """The explicit formulas against torch autograd of ``attention_ref``;
    and the saved lse is the forward's."""
    b, t, h, kvh, hd, causal, window, softcap = GRAD_CASES[case]
    q, k, v, do = (torch.from_numpy(x) for x in _grad_inputs(b, t, h, kvh, hd, 3))
    kw = dict(causal=causal, window=window, softcap=softcap)
    qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
    fa_r.attention_ref(qa, ka, va, **kw).backward(do)
    o, lse = fa_r.attention_lse_ref(q, k, v, **kw)
    np.testing.assert_allclose(o.numpy(), fa_r.attention_ref(q, k, v, **kw).numpy(),
                               atol=GRAD_TOL, rtol=GRAD_TOL)
    got = fa_r.attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for name, g, e in zip("qkv", got, (qa.grad, ka.grad, va.grad)):
        np.testing.assert_allclose(g.numpy(), e.numpy(), atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"d{name}")


# the gradient through a partly filled cache (kv_len < Tk) and of rows that
# lie past the keys: name -> (b, tq, tk, h, kvh, hd, causal, window,
# q_offset, kv_len); the last four have rows that see no key (the mean of v
# over all Tk keys: do / Tk on every row of dv, nothing on dq or dk)
CACHE_GRAD_CASES = {
    "kv_len_causal": (2, 24, 64, 4, 4, 32, True, 0, 30, 50),
    "kv_len_window": (1, 24, 64, 4, 4, 32, True, 12, 30, 48),
    "kv_len_gqa_hd64": (1, 30, 48, 8, 2, 64, True, 0, 10, 40),
    "past_the_keys_causal_hd120": (1, 40, 32, 4, 2, 120, True, 0, 8, None),
    "past_the_keys_window": (2, 40, 32, 4, 2, 32, True, 10, 8, None),
    "no_key_rows_kv_len": (2, 6, 48, 4, 2, 32, True, 8, 40, 20),
    "empty_cache": (1, 8, 24, 4, 1, 32, True, 0, 0, 0),
    "before_the_keys": (1, 20, 32, 4, 4, 64, True, 0, -5, 28),
}


@pytest.mark.parametrize("impl", ["direct", "flash"])
@pytest.mark.parametrize("case", sorted(CACHE_GRAD_CASES))
def test_attention_grads_through_a_cache_match_jax(case, impl):
    """TL.attention's output and gradients (the plain backward, through
    ops.FlashAttention's cut to kv_len and its term for rows that see no
    key) against jax.grad of the reference's _attention_direct and
    _attention_flash (one block of every query and key) at the same
    kv_len, q_offset and window, 1e-4 (float32 sums in another order); no
    case raises."""
    import jax

    b, tq, tk, h, kvh, hd, causal, window, off, kv_len = CACHE_GRAD_CASES[case]
    q, k, v, do = _offset_inputs(b, tq, tk, h, kvh, hd, len(case))
    fn = JL._attention_direct if impl == "direct" else JL._attention_flash
    mask = dict(causal=causal, window=window, q_offset=off, kv_len=kv_len)

    def f(q_, k_, v_):
        out = fn(q_, k_, v_, causal=causal, window=jnp.asarray(window), softcap=0.0,
                 q_offset=off, kv_len=None if kv_len is None else jnp.asarray(kv_len))
        return jnp.sum(out * jnp.asarray(do)), out

    (_, exp_o), exp_g = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got_o, got_g = _port_grads(q, k, v, do, **mask)
    np.testing.assert_allclose(got_o, np.asarray(exp_o), atol=1e-4, rtol=1e-4)
    for name, g, e in zip("qkv", got_g, exp_g):
        np.testing.assert_allclose(g, np.asarray(e), atol=1e-4, rtol=1e-4, err_msg=f"d{name}")
    first, end = fa_k.rows_seeing_keys(tq, tk, causal=causal, window=window, q_offset=off,
                                       kv_len=kv_len)
    sees = _visible(tq, tk, causal, window, off, kv_len).any(axis=1)
    assert (np.nonzero(sees)[0].tolist() == list(range(first, end)))
    assert ((first, end) != (0, tq)) == (case in ("past_the_keys_window", "no_key_rows_kv_len",
                                                  "empty_cache", "before_the_keys"))
    if kv_len is not None and kv_len < tk:  # no row sees a key past kv_len
        assert not got_g[1][:, kv_len:].any()


# the gradient at a query offset and Tq != Tk (a sequence-split island, a
# cross-attention): name -> (b, tq, tk, h, kvh, hd, causal, window, softcap,
# q_offset)
OFFSET_GRAD_CASES = {
    "island_causal_hd64": (2, 32, 96, 4, 4, 64, True, 0, 0.0, 64),
    "island_mid_causal_gqa_hd32": (1, 24, 96, 4, 2, 32, True, 0, 0.0, 40),
    "island_window_softcap_hd120": (1, 16, 80, 4, 2, 120, True, 20, 30.0, 48),
    "island_window_hd112": (1, 32, 64, 4, 1, 112, True, 12, 0.0, 32),
    "cross_bidirectional_hd64": (2, 12, 50, 4, 4, 64, False, 0, 0.0, 0),
    "cross_bidirectional_window_hd32": (1, 20, 40, 4, 2, 32, False, 8, 0.0, 10),
}


def _offset_inputs(b, tq, tk, h, kvh, hd, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(b, tq, h, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, tk, kvh, hd)).astype(np.float32) for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("case", sorted(OFFSET_GRAD_CASES))
def test_attention_grads_at_offset_match_jax(case):
    """The port's gradient (the plain backward) at q_offset != 0 and
    Tq != Tk, causal, windowed and not, against jax.grad of the reference's
    attention at the same offset; and the split arithmetic of the backward
    kernel at its own limit against the plain backward."""
    import jax

    b, tq, tk, h, kvh, hd, causal, window, softcap, off = OFFSET_GRAD_CASES[case]
    q, k, v, do = _offset_inputs(b, tq, tk, h, kvh, hd, len(case))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)

    def f(q_, k_, v_):
        out = JL.attention(q_, k_, v_, impl="direct", **kw)
        return jnp.sum(out * jnp.asarray(do)), out

    (_, exp_o), exp_g = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got_o, got_g = _port_grads(q, k, v, do, **kw)
    np.testing.assert_allclose(got_o, np.asarray(exp_o), atol=GRAD_TOL, rtol=GRAD_TOL)
    for name, g, e in zip("qkv", got_g, exp_g):
        np.testing.assert_allclose(g, np.asarray(e), atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"d{name}")
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = fa_r.attention_lse_ref(qt, kt, vt, **kw)
    split = fa_r.attention_bwd_split_ref(qt, kt, vt, o, lse, dot, **kw, pairs=fa_k.BWD_SPLIT)
    for name, g, e in zip("qkv", split, got_g):
        np.testing.assert_allclose(g.numpy(), e, atol=1e-4, rtol=1e-4, err_msg=f"split d{name}")


def test_every_dense_config_head_dim_is_served():
    """Every served config's head width is one the kernels take (dense and
    vlm; qwen3-moe 128, recurrentgemma 256, whisper 64; h2o-danube-3-4b's
    120 and kimi-k2's 112 run the 128-wide template; rwkv6 has no
    attention)."""
    from repro_torch import configs as tc
    from repro_torch.models import api

    served = set()
    for name in tc.ARCH_IDS:
        cfg = tc.get(name)
        if cfg.family == "ssm":
            continue
        hd = cfg.resolved_head_dim
        assert fa_k.kernel_head_dim(hd) >= hd, name
        api.check_card_head_dim(cfg)
        served.add(hd)
    assert {64, 112, 128, 256} <= served
    assert fa_k.kernel_head_dim(120) == fa_k.kernel_head_dim(112) == 128
    assert fa_k.bwd_design(112) == "bwd_wgmma"
    with pytest.raises(ValueError, match="head_dim"):
        fa_k.kernel_head_dim(96)
    with pytest.raises(NotImplementedError, match="head width 96"):
        api.check_card_head_dim(tc.get("kimi-k2-1t-a32b").reduced(head_dim=96))
    api.check_card_head_dim(tc.get("rwkv6-7b"))   # attention-free: nothing to check


# -- the backward kernel's tensor-core arithmetic (bwd_wgmma) --------------------

# ref.attention_bwd_split_ref emulates the kernel's products of bf16 parts
# with float32 sums; it is held at the kernel's own limit against the plain
# backward (BWD_TOL, as tests/test_torch_cuda.py and chip_smoke.py hold the
# kernel) and against the reference's jax.grad.
BWD_TOL = 1e-4

BWD_SPLIT_CASES = {
    # name: (b, t, h, kvh, hd, causal, window, softcap)
    "hd32_gqa2_ragged": (2, 100, 4, 2, 32, True, 0, 0.0),
    "hd64_mha": (1, 130, 4, 4, 64, True, 0, 0.0),
    "hd64_gqa8_window": (1, 150, 8, 1, 64, True, 40, 0.0),
    "hd64_gqa4_bidirectional": (1, 70, 4, 1, 64, False, 0, 0.0),
    "hd120_gqa2_window_softcap": (1, 72, 4, 2, 120, True, 16, 50.0),
    "hd128_gqa2_softcap": (1, 96, 4, 2, 128, True, 0, 30.0),
    "hd128_gqa8_window": (1, 80, 8, 1, 128, True, 24, 0.0),
    # bwd_wide: the same split arithmetic, each product's columns summed in
    # two halves (the two consumer warpgroups' shares of S and dP)
    "hd256_gqa2_window_softcap": (1, 90, 8, 4, 256, True, 30, 50.0),
    "hd256_gqa2_ragged": (1, 77, 4, 2, 256, True, 0, 0.0),
}


def _bwd_inputs(b, t, h, kvh, hd, causal, window, softcap, seed):
    q, k, v, do = (torch.from_numpy(x) for x in _grad_inputs(b, t, h, kvh, hd, seed))
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = fa_r.attention_lse_ref(q, k, v, **kw)
    return (q, k, v, o, lse, do), kw


@pytest.mark.parametrize("case", sorted(BWD_SPLIT_CASES))
def test_bwd_split_ref_matches_bwd_ref(case):
    args, kw = _bwd_inputs(*BWD_SPLIT_CASES[case], seed=len(case))
    got = fa_r.attention_bwd_split_ref(*args, **kw, pairs=fa_k.BWD_SPLIT)
    exp = fa_r.attention_bwd_ref(*args, **kw)
    for name, g, e in zip("qkv", got, exp):
        np.testing.assert_allclose(g.numpy(), e.numpy(), atol=BWD_TOL, rtol=BWD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_bwd_split_ref_matches_jax_direct(case):
    b, t, h, kvh, hd, causal, window, softcap = GRAD_CASES[case]
    q, k, v, do = _grad_inputs(b, t, h, kvh, hd, len(case))
    kw = dict(causal=causal, window=window, softcap=softcap)
    _, exp_g = _jax_grads(q, k, v, do, impl="direct", **kw)
    args, _ = _bwd_inputs(b, t, h, kvh, hd, causal, window, softcap, len(case))
    got = fa_r.attention_bwd_split_ref(*args, **kw, pairs=fa_k.BWD_SPLIT)
    for name, g, e in zip("qkv", got, exp_g):
        np.testing.assert_allclose(g.numpy(), e, atol=BWD_TOL, rtol=BWD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("window", [0, 700])
def test_bwd_split_ref_matches_jax_blocked_2048(window):
    """The reference's blocked branch (2048 positions, under jax.checkpoint)."""
    q, k, v, do = _grad_inputs(1, 2048, 2, 1, 32, 17)
    kw = dict(causal=True, window=window, softcap=0.0)
    _, exp_g = _jax_grads(q, k, v, do, impl="flash", **kw)
    args, _ = _bwd_inputs(1, 2048, 2, 1, 32, True, window, 0.0, 17)
    got = fa_r.attention_bwd_split_ref(*args, **kw, pairs=fa_k.BWD_SPLIT)
    for name, g, e in zip("qkv", got, exp_g):
        np.testing.assert_allclose(g.numpy(), e, atol=BWD_TOL, rtol=BWD_TOL, err_msg=f"d{name}")


def test_bwd_split_one_product_fewer():
    """BWD_SPLIT on record.  At 4 x 512 positions of hd 64 the worst
    |error| / (BWD_TOL (1 + |expected|)) against the plain backward is 0.013
    with the six products and 0.15 with five: the sixth, (2, 0), cuts the
    error tenfold.  Five (and three) would still pass BWD_TOL; six
    are chosen because train_check (a) also holds the bf16-rounded weight
    gradients of a full-width step >= 99% bit-equal to the CPU's, and fewer
    products alone move too many of them (scripts/torch_bwd_split_choice.py).
    One or two products are a different result: the limit sees them."""
    args, kw = _bwd_inputs(1, 512, 4, 4, 64, True, 0, 0.0, seed=3)
    exp = fa_r.attention_bwd_ref(*args, **kw)

    def worst(pairs):
        got = fa_r.attention_bwd_split_ref(*args, **kw, pairs=pairs)
        return max(float(((g - e).abs() / (BWD_TOL * (1 + e.abs()))).max())
                   for g, e in zip(got, exp))

    at = {n: worst(n) for n in (1, 2, fa_k.BWD_SPLIT - 1, fa_k.BWD_SPLIT)}
    assert fa_k.BWD_SPLIT == len(fa_r.BWD_PAIRS) == 6
    assert at[6] < 0.05 and at[5] > 4 * at[6], at
    assert at[1] > 1 and at[2] > 1, at
    with pytest.raises(ValueError, match="parts"):
        fa_r.attention_bwd_split_ref(*args, **kw, parts=2, pairs=6)


def test_bwd_design_by_head_width():
    """bwd_wgmma for every width but 256 (the dense configs' 32 to 128);
    gemma3's 256 runs bwd_wide, both on the tensor cores."""
    assert [fa_k.bwd_design(hd) for hd in (32, 64, 120, 128, 256)] == \
        ["bwd_wgmma"] * 4 + ["bwd_wide"]
    with pytest.raises(ValueError, match="head_dim"):
        fa_k.bwd_design(96)


# k and v as one bf16 part (three products in S, dP and dQ): bwd_wide's
# bf16-k/v instances at hd 256 with its head split (the dK/dV pass over n
# subsets of a group's query heads, the subsets' partial dK, dV added in
# order), and bwd_wgmma's at hd 64 (Whisper's encoder and cross-attention
# with Tq != Tk, and a q_offset island; one subset): name -> (hd, b, tq, tk,
# h, kvh, causal, window, softcap, q_offset, head subsets)
BWD_ONE_KV_PART_CASES = {
    "mqa16_window_2_subsets": (256, 1, 80, 80, 16, 1, True, 24, 0.0, 0, 2),
    "mqa16_16_subsets": (256, 1, 50, 50, 16, 1, True, 0, 0.0, 0, 16),
    "gqa4_softcap_3_subsets": (256, 1, 70, 70, 8, 2, True, 0, 30.0, 0, 3),
    "mqa8_bidirectional_4_subsets": (256, 1, 40, 40, 8, 1, False, 10, 0.0, 0, 4),
    "whisper_encoder": (64, 2, 75, 75, 4, 4, False, 0, 0.0, 0, 1),
    "whisper_cross": (64, 2, 24, 75, 4, 4, False, 0, 0.0, 0, 1),
    "gqa2_causal_window_softcap": (64, 1, 90, 90, 4, 2, True, 30, 20.0, 0, 1),
    "island": (64, 1, 32, 96, 4, 4, True, 0, 0.0, 64, 1),
}


@pytest.mark.parametrize("case", sorted(BWD_ONE_KV_PART_CASES))
def test_bwd_split_ref_one_kv_part_and_head_splits(case):
    """k and v as one bf16 part (numpy inputs from a seed, k and v rounded
    to bfloat16), with the head split: within BWD_TOL of the plain backward
    and of jax.grad of the reference's attention (on the float32 values of
    the bf16 k/v), and bit-equal to the six-product emulation with the same
    head split, whose k/v parts past the first are zeros."""
    import jax

    hd, b, tq, tk, h, kvh, causal, window, softcap, off, n = BWD_ONE_KV_PART_CASES[case]
    q, k, v, do = _offset_inputs(b, tq, tk, h, kvh, hd, len(case))
    qt, dot = torch.from_numpy(q), torch.from_numpy(do)
    kt, vt = (torch.from_numpy(x).to(torch.bfloat16) for x in (k, v))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
    o, lse = fa_r.attention_lse_ref(qt, kt, vt, **kw)
    args = (qt, kt, vt, o, lse, dot)
    got = fa_r.attention_bwd_split_ref(*args, **kw, kv_parts=1, head_splits=n)
    six = fa_r.attention_bwd_split_ref(*args, **kw, head_splits=n)
    exp = fa_r.attention_bwd_ref(*args, **kw)

    def f(q_, k_, v_):
        return jnp.sum(JL.attention(q_, k_, v_, impl="direct", **kw) * jnp.asarray(do))

    kf, vf = (x.float().numpy() for x in (kt, vt))
    exp_j = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(kf), jnp.asarray(vf))
    for name, g, s6, e, ej in zip("qkv", got, six, exp, exp_j):
        assert torch.equal(g, s6), f"d{name}"
        np.testing.assert_allclose(g.numpy(), e.numpy(), atol=BWD_TOL, rtol=BWD_TOL,
                                   err_msg=f"d{name}")
        np.testing.assert_allclose(g.numpy(), np.asarray(ej), atol=BWD_TOL, rtol=BWD_TOL,
                                   err_msg=f"jax d{name}")


def test_bwd_split_ref_one_kv_part_needs_bf16_values():
    """One k/v part is exact only for bf16 values: on float32 k/v it rounds
    k and v to bfloat16, which moves the gradients past BWD_TOL; so the
    bf16 instances are taken for bf16 k/v only (``bwd_plan``)."""
    args, kw = _bwd_inputs(1, 80, 16, 1, 256, True, 24, 0.0, seed=5)
    exp = fa_r.attention_bwd_ref(*args, **kw)
    got = fa_r.attention_bwd_split_ref(*args, **kw, kv_parts=1, head_splits=2)
    assert not all(torch.allclose(g, e, atol=BWD_TOL, rtol=BWD_TOL) for g, e in zip(got, exp))
    three = fa_r.attention_bwd_split_ref(*args, **kw, head_splits=2)
    for name, g, e in zip("qkv", three, exp):
        np.testing.assert_allclose(g.numpy(), e.numpy(), atol=BWD_TOL, rtol=BWD_TOL,
                                   err_msg=f"d{name}")


def test_bwd_products_by_kv_parts():
    """The instance's products: six in each of the five for float32 k/v;
    for bf16 k/v, three where k or v is an operand (S, dP, dQ): 4.2 on
    average, what chip_smoke.attn_products counts as needed."""
    assert fa_k.bwd_products(3) == dict.fromkeys(("S", "dP", "dV", "dK", "dQ"), fa_k.BWD_SPLIT)
    bf16 = fa_k.bwd_products(1)
    assert bf16 == {"S": 3, "dP": 3, "dV": 6, "dK": 6, "dQ": 3}
    assert sum(bf16.values()) / 5 == 4.2
    assert sum(1 for _, j in fa_r.BWD_PAIRS if j < 1) == bf16["S"]


# -- the float32-k/v forward's tensor-core arithmetic (flash_wgmma_split) --------

# ref.attention_fwd_split_ref emulates it: q log2(e) / sqrt(hd), k and v
# split into three bf16 parts, six products per float32 product, an exp2
# softmax over key tiles taken in two turns (each tile's P . V a fresh
# float32 sum), the turns' states merged.  Held at the forward kernel's own
# limit (2e-5, as tests/test_torch_cuda.py holds the kernel) against the
# plain forward with lse and the reference.
FWD_SPLIT_CASES = {
    # name: (b, t, h, kvh, causal, window, softcap); t not a multiple of the
    # 32- or 64-key tiles
    "causal_mha": (2, 100, 4, 4, True, 0, 0.0),
    "gqa2_window_softcap": (1, 90, 8, 4, True, 24, 50.0),
    "gqa4_bidirectional": (1, 70, 8, 2, False, 0, 0.0),
    "mqa_window": (1, 130, 4, 1, True, 40, 0.0),
}


def _tile_keys(hd, kv_dtype):
    """The keys of flash_wgmma's streamed tile at hd on k/v of kv_dtype."""
    return fa_k.fwd_plan(hd, kv_dtype, 1, 64, 64, 1, 1, causal=True, window=0, q_offset=0,
                         kv_len=64).tile_keys


@pytest.mark.parametrize("hd", [32, 64, 112, 120, 128])
@pytest.mark.parametrize("case", sorted(FWD_SPLIT_CASES))
def test_fwd_split_ref_matches_lse_ref_and_jax_direct(hd, case):
    b, t, h, kvh, causal, window, softcap = FWD_SPLIT_CASES[case]
    (qj, kj, vj), (qt, kt, vt) = _model_inputs(b, t, t, h, kvh, hd, hd + len(case), kv_bf16=False)
    kw = dict(causal=causal, window=window, softcap=softcap)
    block = _tile_keys(hd, torch.float32)  # the kernel's key tiles
    got_o, got_lse = fa_r.attention_fwd_split_ref(qt, kt, vt, block=block, **kw)
    exp_o, exp_lse = fa_r.attention_lse_ref(qt, kt, vt, **kw)
    np.testing.assert_allclose(got_o.numpy(), exp_o.numpy(), atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(got_lse.numpy(), exp_lse.numpy(), atol=F32_TOL, rtol=F32_TOL)
    exp_j = JL._attention_direct(qj, kj, vj, causal=causal, window=jnp.asarray(window),
                                 softcap=softcap, q_offset=0, kv_len=None)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(exp_j), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("kv_bf16", [False, True])
@pytest.mark.parametrize("hd", [64, 112, 120, 128])
def test_fwd_turns_merge_rows_of_one_turn(hd, kv_bf16):
    """The two turns' merge where a row's keys all lie in one warpgroup's
    tiles (a window shorter than a tile: the other turn holds only masked
    keys, or no tile at all) and where a row sees no key (kv_len 0 past
    the window: the mean of v over all Tk), on float32 k/v (six products)
    and bf16 k/v (three), against the plain forward and _attention_direct
    at 2e-5; lse too on float32 k/v."""
    kv_dtype = torch.bfloat16 if kv_bf16 else torch.float32
    block = _tile_keys(hd, kv_dtype)
    tq, tk, window = 3 * block, 3 * block, block // 4
    (qj, kj, vj), (qt, kt, vt) = _model_inputs(1, tq, tk, 4, 2, hd, hd, kv_bf16=kv_bf16)
    # rows near a tile's end see keys of that tile only: in tile j's turn (j mod 2)
    mask = _visible(tq, tk, True, window, 0, None)
    tiles = [set(np.nonzero(row)[0] // block) for row in mask]
    assert any(t == {0} for t in tiles) and any(t == {1} for t in tiles)
    # some row blocks start at an odd tile: their turns count from it
    first = fa_r._first_tiles(tq, 2, tk, causal=True, window=window, q_offset=0, kv_len=None,
                              block=block)
    assert (first % 2 == 1).any() and (first % 2 == 0).any()
    for kw in (dict(causal=True, window=window), dict(causal=True, window=window, q_offset=tk,
                                                      kv_len=tk - window - 4)):
        if kv_bf16:
            got = fa_r.attention_split_ref(qt, kt, vt, block=block, **kw)
        else:
            got, got_lse = fa_r.attention_fwd_split_ref(qt, kt, vt, block=block, **kw)
            if "kv_len" not in kw:
                _, exp_lse = fa_r.attention_lse_ref(qt, kt, vt, **kw)
                np.testing.assert_allclose(got_lse.numpy(), exp_lse.numpy(), atol=F32_TOL,
                                           rtol=F32_TOL)
        exp = fa_r.attention_ref(qt, kt, vt, **kw)
        np.testing.assert_allclose(got.numpy(), exp.numpy(), atol=F32_TOL, rtol=F32_TOL)
        kv_len = None if "kv_len" not in kw else jnp.asarray(kw["kv_len"])
        exp_j = JL._attention_direct(qj, kj, vj, causal=True, window=jnp.asarray(window),
                                     softcap=0.0, q_offset=kw.get("q_offset", 0), kv_len=kv_len)
        np.testing.assert_allclose(got.numpy(), np.asarray(exp_j), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("window", [0, 512])
def test_fwd_split_ref_matches_jax_blocked_2048(window):
    """The reference's blocked path (taken from 2048 query positions)."""
    (qj, kj, vj), (qt, kt, vt) = _model_inputs(1, 2048, 2048, 2, 1, 64, 19, kv_bf16=False)
    exp = JL._attention_flash(qj, kj, vj, causal=True, window=jnp.asarray(window), softcap=0.0,
                              q_offset=0, kv_len=None)
    got, _ = fa_r.attention_fwd_split_ref(qt, kt, vt, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=F32_TOL, rtol=F32_TOL)


def test_fwd_split_ref_cached_shape_and_one_product_too_few():
    """A cached prefill (q_offset, kv_len, GQA) matches the plain forward;
    fewer products (one or two pairs) are a different result at the limit."""
    _, (qt, kt, vt) = _model_inputs(2, 40, 128, 4, 2, 64, 23, kv_bf16=False)
    kw = dict(causal=True, window=0, q_offset=80, kv_len=120)
    exp = fa_r.attention_ref(qt, kt, vt, **kw)
    got, _ = fa_r.attention_fwd_split_ref(qt, kt, vt, **kw)
    np.testing.assert_allclose(got.numpy(), exp.numpy(), atol=F32_TOL, rtol=F32_TOL)
    for pairs in (1, 2):
        few, _ = fa_r.attention_fwd_split_ref(qt, kt, vt, pairs=pairs, **kw)
        assert not np.allclose(few.numpy(), exp.numpy(), atol=F32_TOL, rtol=F32_TOL), pairs


# flash_wgmma's plan (csrc/attn_plan.h, through kernel.fwd_plan) at the
# forward rows of PERF.md §6: name -> ((hd, kv bf16, b, tq, tk, h, kvh,
# window, q_offset), (tile keys, stages, first and end key of the split
# prologue's parts)); every call causal over all Tk keys but the cross
# attention (non-causal).  Scratch: [k, v][3 parts][B KV][keys][hdk] bf16.
FWD_PLANS = {
    "train_fwd": ((64, False, 2, 4096, 4096, 36, 36, 0, 0), (64, 4, 0, 4096)),
    # the dry-run rank's island sees 256 of 4,096 keys: 1/16 of the parts
    "minicpm_rank_island": ((64, False, 4, 256, 4096, 36, 36, 0, 0), (64, 4, 0, 256)),
    "minicpm_island": ((64, False, 2, 512, 4096, 36, 36, 0, 3584), (64, 4, 0, 4096)),
    "whisper_rank_self": ((64, False, 4, 4096, 4096, 1, 1, 0, 0), (64, 4, 0, 4096)),
    "whisper_cross_f32": ((64, False, 4, 128, 1500, 16, 16, 0, 0), (64, 4, 0, 1500)),
    "qwen3_rank_train": ((128, False, 2, 4096, 4096, 4, 1, 0, 0), (32, 3, 0, 4096)),
    "kimi_rank_train": ((112, False, 2, 4096, 4096, 4, 1, 0, 0), (32, 3, 0, 4096)),
    "h2o_rank_train": ((120, False, 4, 4096, 4096, 2, 1, 4096, 0), (32, 3, 0, 4096)),
    "starcoder2_rank_seq0": ((128, False, 4, 256, 4096, 24, 2, 0, 0), (32, 3, 0, 256)),
    "starcoder2_rank_seq3840": ((128, False, 4, 256, 4096, 24, 2, 0, 3840), (32, 3, 0, 4096)),
    # a windowed island: its first key (3840 - 1023) rounded down to 64
    "window_island": ((64, False, 1, 256, 4096, 8, 8, 1024, 3840), (64, 4, 2816, 4096)),
    "qwen3_rank_prefill": ((128, True, 2, 32768, 32768, 4, 1, 0, 0), (64, 4, 0, 32768)),
    "kimi_rank_prefill": ((112, True, 2, 32768, 32768, 4, 1, 0, 0), (64, 4, 0, 32768)),
    "whisper_encoder": ((64, True, 4, 1500, 1500, 16, 16, 0, 0), (64, 4, 0, 1500)),
    "serve_prefill": ((256, True, 4, 4096, 4128, 8, 4, 1024, 0), (64, 2, 0, 4128)),
    "griffin_local": ((256, True, 4, 4096, 4096, 16, 1, 2048, 0), (64, 2, 0, 4096)),
}


@pytest.mark.parametrize("cell", sorted(FWD_PLANS))
def test_fwd_plan_at_the_forward_rows(cell):
    """Keys a tile and ring stages by instance (64-key tiles in four
    stages, at hd 256 in two, and at hd 112-128 on float32 k/v 32 keys in
    three), and the float32 prologue's parts: the keys some row sees, sized
    for those alone."""
    (hd, bf16, b, tq, tk, h, kvh, window, q_offset), want = FWD_PLANS[cell]
    causal = cell != "whisper_cross_f32"
    kv_dtype = torch.bfloat16 if bf16 else torch.float32
    plan = fa_k.fwd_plan(hd, kv_dtype, b, tq, tk, h, kvh, causal=causal, window=window,
                         q_offset=q_offset, kv_len=tk)
    assert (plan.tile_keys, plan.stages, plan.k_begin, plan.k_end) == want
    keys = want[3] - want[2]
    hdk = fa_k.kernel_head_dim(hd)
    assert plan.scratch_bytes == (0 if bf16 else 2 * 3 * b * kvh * keys * hdk * 2)
    lo, hi = fa_k.key_range(tq, tk, causal=causal, window=window, q_offset=q_offset, kv_len=tk)
    assert bf16 or (plan.k_begin == lo // 64 * 64 and plan.k_end == hi)
    assert fa_k.fwd_design(hd, kv_dtype, tq * h // kvh, lse=not bf16) == (
        "flash_wgmma" if bf16 else "flash_wgmma_split")


@pytest.mark.parametrize("hd,kv_dtype,rows,lse,design", [
    (64, torch.float32, 4096, True, "flash_wgmma_split"),    # minicpm-2b's training forward
    (120, torch.float32, 4096, False, "flash_wgmma_split"),  # h2o-danube's cache-free forward
    (256, torch.float32, 8192, False, "flash_tiled"),        # gemma3-4b's cache-free forward
    (256, torch.bfloat16, 8192, False, "flash_wgmma"),       # every prefill of the serve path
    (256, torch.bfloat16, 2, False, "flash_decode"),         # its decode
    (64, torch.float32, 1, True, "flash_wgmma_split"),       # lse: never the decode design
])
def test_fwd_design_by_shape(hd, kv_dtype, rows, lse, design):
    assert fa_k.fwd_design(hd, kv_dtype, rows, lse=lse) == design
    assert set(fa_k.fwd_design_launches) == {"flash_wgmma", "flash_wgmma_split", "flash_tiled",
                                             "flash_decode"}


def test_decode_scratch_zeroes_counters_a_wider_call_needs():
    """The decode design's scratch is reused across calls: its counters must
    be 0 when a call starts.  A call with 16 (batch, kv head) pairs writes
    its partials from word 32 on; a later call with 64 pairs counts in words
    0..63, which must be zeroed again first."""
    dev = torch.device("cpu")
    fa_k._scratch.pop(str(dev), None)
    buf = fa_k._decode_scratch(dev, 16, 100)
    assert buf.numel() == 132 and not bool(buf.any())
    buf[32:].fill_(7.0)                       # the first call's partials
    again = fa_k._decode_scratch(dev, 64, 50)
    assert again is buf                       # reused: 114 words fit
    assert not bool(again[:64].any())         # the wider call's counters are zero
    assert bool((again[64:] == 7.0).all())    # its partial area is not cleared
    fa_k._scratch.pop(str(dev), None)


# -- the key split of the hd-256 float32 designs (flash_tiled, bwd_wide's dQ) -----

# The plan is csrc/attn_plan.h's rule, read here through the same functions
# the wrappers use (kernel.tiled_plan, kernel.bwd_plan: the host-compiled
# plan library); an H100 has 132 SMs.  gemma3-4b: 8 q / 4 kv heads of 256;
# its training attention over tp 16 is 16 sequence-split islands of 256 rows
# at q_offset 256 r over 4,096 keys.
SMS = 132
GEMMA3 = dict(h=8, kvh=4)


def _visible_range(tq, tk, causal, window, q_offset, kv_len):
    mask = _visible(tq, tk, causal, window, q_offset, kv_len)
    if not mask.any(axis=1).all():
        return 0, tk
    cols = np.nonzero(mask.any(axis=0))[0]
    return int(cols.min()), int(cols.max()) + 1


def _check_chunks(plan, lo, hi, blocks):
    """The chunks cover [lo, hi) exactly once, in order, none empty and (more
    than one) each of >= 256 keys with inner bounds on 64-key tiles, and the
    grid stays within one wave when it splits."""
    bounds = plan.bounds
    assert len(bounds) == plan.chunks + 1 and bounds[0] == lo and bounds[-1] == hi
    sizes = np.diff(bounds)
    assert (sizes > 0).all()
    if plan.chunks > 1:
        assert (sizes >= 256).all() and all(x % 64 == 0 for x in bounds[1:-1])
        assert blocks * plan.chunks <= SMS


@pytest.mark.parametrize("r", range(16))
def test_key_split_plan_at_gemma3_islands(r):
    """Island r sees 256 (r + 1) keys: the first runs one chunk (forward
    unsplit; backward on the dS path with one chunk), the second 2, the
    third 3, every later one 4 (32 blocks x 4 = 128 of 132 SMs)."""
    kw = dict(causal=True, window=0, q_offset=256 * r)
    fwd = fa_k.tiled_plan(1, 256, 4096, **GEMMA3, kv_len=4096, sms=SMS, **kw)
    bwd = fa_k.bwd_plan(256, 1, 256, 4096, **GEMMA3, sms=SMS, **kw)
    want = min(r + 1, 4)
    assert fwd.chunks == bwd.chunks == want
    assert fwd.bounds == bwd.bounds
    blocks = 256 * 2 // 64 * 4   # rows (position, group) / 64 x kv heads; dQ: 8 heads x 4
    _check_chunks(fwd, 0, 256 * (r + 1), blocks)
    assert fwd.scratch_bytes == (0 if want == 1 else want * 4 * 512 * 258 * 4)
    if r == 15:
        assert fwd.bounds == (0, 1024, 2048, 3072, 4096)
        # dS [8 heads][256][4096] and the dQ partials [4][8][256][256], float32
        recompute = fa_k.bwd_plan(256, 1, 256, 4096, **GEMMA3, sms=32, **kw)
        assert recompute.chunks == 0  # 32 blocks fill a wave of 32 SMs
        assert bwd.scratch_bytes - recompute.scratch_bytes == 4 * (8 * 256 * 4096 +
                                                                   4 * 8 * 256 * 256)


@pytest.mark.parametrize("tq,window", [(4096, 0), (4096, 1024)])
def test_key_split_plan_keeps_full_layers_whole(tq, window):
    """gemma3-4b's full layers fill the card: the forward runs one chunk with
    no scratch, the backward the recomputing dQ pass (0 chunks): the
    unsplit kernels."""
    kw = dict(causal=True, window=window, q_offset=0)
    fwd = fa_k.tiled_plan(1, tq, 4096, **GEMMA3, kv_len=4096, sms=SMS, **kw)
    assert (fwd.chunks, fwd.scratch_bytes) == (1, 0)
    assert fa_k.bwd_plan(256, 1, tq, 4096, **GEMMA3, sms=SMS, **kw).chunks == 0
    # every other width: the recomputing pass whatever the grid
    assert fa_k.bwd_plan(64, 1, 64, 4096, 4, 4, sms=SMS, **dict(kw, q_offset=4032)).chunks == 0


@pytest.mark.parametrize("seed", range(4))
def test_key_split_plan_covers_the_visible_keys(seed):
    """Across random shapes (windows, offsets, kv_len, GQA, rows that see no
    key): the chunks cover the visible key range exactly once, as the
    forward's key_range and the plain mask give it, none empty."""
    rng = np.random.default_rng(seed)
    for _ in range(150):
        b, kvh = int(rng.integers(1, 3)), int(rng.choice([1, 2, 4]))
        h = kvh * int(rng.choice([1, 2, 4]))
        tq, tk = int(rng.integers(1, 400)), int(rng.integers(1, 5000))
        causal, window = bool(rng.integers(0, 2)), int(rng.choice([0, 1, 100, 1024]))
        q_offset = int(rng.integers(0, tk + 50))
        kv_len = int(rng.integers(0, tk + 10))
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        plan = fa_k.tiled_plan(b, tq, tk, h, kvh, kv_len=kv_len, sms=SMS, **kw)
        lo, hi = _visible_range(tq, tk, causal, window, q_offset, kv_len)
        assert (lo, hi) == fa_k.key_range(tq, tk, kv_len=kv_len, **kw)
        _check_chunks(plan, lo, hi, -(-tq * (h // kvh) // 64) * b * kvh)
        if causal or window:
            q_offset = min(q_offset, tk - min(tq, tk))   # the gradient's shapes
            tq = min(tq, tk - q_offset)
            kw["q_offset"] = q_offset
        bwd = fa_k.bwd_plan(256, b, tq, tk, h, kvh, sms=SMS, **kw)
        blocks = b * h * -(-tq // 64)
        assert (bwd.chunks == 0) == (blocks >= SMS)   # the dS path exactly under one wave
        if bwd.chunks:
            _check_chunks(bwd, *_visible_range(tq, tk, causal, window, q_offset, tk), blocks)


def _bwd_layout_bytes(hdk, b, tq, tk, h, kvh, nchunk, nsplit, kv_parts):
    """csrc/attn_plan.h's bwd_layout total, written out: parts of q and dO,
    k/v parts, lse and D padded to 128 rows, the dQ partials and dS (dS
    path), the dK and dV partials at the template's width (head split); each
    256-byte aligned."""
    def a256(n):
        return -(-n // 256) * 256

    tp = -(-tq // 128) * 128
    total = 2 * a256(3 * 2 * b * h * tq * hdk) + 2 * a256(kv_parts * 2 * b * kvh * tk * hdk)
    total += 2 * a256(4 * b * h * tp)
    total += a256(4 * nchunk * b * h * tq * 256) if nchunk > 1 else 0
    total += a256(4 * b * h * tq * tk) if nchunk > 0 else 0
    total += a256(2 * 4 * nsplit * b * kvh * tk * hdk) if nsplit > 1 else 0
    return total


GRIFFIN = dict(h=16, kvh=1)   # recurrentgemma-9b's local MQA: 16 q heads over 1 kv head of 256


@pytest.mark.parametrize("kv_bf16", [True, False])
def test_head_split_plan_at_griffin_and_gemma3(kv_bf16):
    """recurrentgemma-9b's training attention ([1, 4096, 16 / 1, 256],
    window 2048) has 64 dK/dV blocks: 2 head subsets (128 blocks of 132
    SMs), the dK and dV partials [2][1][4096][256] float32 in the scratch
    (16.8 MB), one k/v part for bf16 k/v.  gemma3-4b's full layers and its
    islands keep the whole group (256 dK/dV blocks); the islands' dS path
    takes bf16 k/v as their float32 values."""
    kw = dict(causal=True, window=2048, q_offset=0)
    griffin = fa_k.bwd_plan(256, 1, 4096, 4096, **GRIFFIN, sms=SMS, kv_bf16=kv_bf16, **kw)
    parts = 1 if kv_bf16 else 3
    assert (griffin.chunks, griffin.head_splits, griffin.kv_parts) == (0, 2, parts)
    assert griffin.scratch_bytes == _bwd_layout_bytes(256, 1, 4096, 4096, 16, 1, 0, 2, parts)
    whole = fa_k.bwd_plan(256, 1, 4096, 4096, **GRIFFIN, sms=64, kv_bf16=kv_bf16, **kw)
    assert whole.head_splits == 1   # 64 blocks fill a wave of 64 SMs
    assert griffin.scratch_bytes - whole.scratch_bytes == 2 * 4 * 2 * 4096 * 256
    for window in (0, 1024):
        full = fa_k.bwd_plan(256, 1, 4096, 4096, **GEMMA3, sms=SMS, kv_bf16=kv_bf16,
                             causal=True, window=window, q_offset=0)
        assert (full.chunks, full.head_splits, full.kv_parts) == (0, 1, parts)
        assert full.scratch_bytes == _bwd_layout_bytes(256, 1, 4096, 4096, 8, 4, 0, 1, parts)
    island = fa_k.bwd_plan(256, 1, 256, 4096, **GEMMA3, sms=SMS, kv_bf16=kv_bf16, causal=True,
                           window=0, q_offset=3840)
    assert (island.chunks, island.head_splits, island.kv_parts) == (4, 1, 3)
    assert island.scratch_bytes == _bwd_layout_bytes(256, 1, 256, 4096, 8, 4, 4, 1, 3)
    # hd 64 (bwd_wgmma's bf16-k/v instances) takes bf16 k/v as they are too,
    # the whole group; the 128-wide template takes their float32 values
    mini = fa_k.bwd_plan(64, 1, 4096, 4096, 4, 1, sms=SMS, kv_bf16=kv_bf16, **kw)
    assert (mini.head_splits, mini.kv_parts) == (1, parts)
    assert mini.scratch_bytes == _bwd_layout_bytes(64, 1, 4096, 4096, 4, 1, 0, 1, parts)
    assert fa_k.bwd_plan(128, 1, 4096, 4096, 4, 1, sms=SMS, kv_bf16=kv_bf16, **kw).kv_parts == 3


def _kv_pass_makespan(n, bkv, tiles, groups, sms):
    """attn_plan.h's kv_pass_makespan, written out: the dK/dV pass's blocks in
    launch order (subset, key tile, batch x kv head), each to the SM that
    frees first (the lowest index among equals), a block costing 2 streamed
    tiles plus its own (tiles of its key tile x heads of its subset)."""
    load = [(0, i) for i in range(sms)]
    heapq.heapify(load)
    for s in range(n):
        heads = (s + 1) * groups // n - s * groups // n
        for t in tiles:
            for _ in range(bkv):
                busy, at = heapq.heappop(load)
                heapq.heappush(load, (busy + 2 + t * heads, at))
    return max(busy for busy, _ in load)


def _kv_tile_queries(kt, tq, tk, q_offset, window, causal):
    """The 32-row query tiles that key tile kt's 64 keys are seen from."""
    r_first, r_last = 64 * kt, min(64 * kt + 64, tk) - 1
    lo = max(0, r_first - q_offset) if causal else 0
    hi = min(tq - 1, r_last + window - 1 - q_offset) if window > 0 else tq - 1
    return 0 if hi < lo else hi // 32 - lo // 32 + 1


def _head_splits(hd, b, tq, tk, h, kvh, causal, window, q_offset, chunks, sms):
    """The dK/dV pass's head subsets by the rule of attn_plan.h's
    bwd_kv_head_splits, written out."""
    groups, blocks = h // kvh, b * kvh * -(-tk // 64)
    if groups < 2:
        return 1
    if hd == 256:
        return min(groups, sms // blocks) if chunks == 0 and blocks < sms else 1
    if hd not in (112, 120, 128) or blocks >= 2 * sms:
        return 1
    tiles = [_kv_tile_queries(kt, tq, tk, q_offset, window, causal) for kt in range(-(-tk // 64))]
    spans = {n: _kv_pass_makespan(n, b * kvh, tiles, groups, sms) for n in range(1, groups + 1)}
    best = min(spans, key=lambda n: (spans[n], n))
    return best if 10 * spans[best] <= 9 * spans[1] else 1


@pytest.mark.parametrize("seed", range(4))
def test_head_split_plan_rule(seed):
    """Across random shapes: the dK/dV pass splits the heads of a group of
    more than one head at hd 256 off the dS path with fewer dK/dV blocks
    than SMs (into the most subsets that keep the grid within one wave, at
    most one per head), and at hd 112-128 under two waves of blocks where
    the launch-order schedule of the split grid is at least a tenth shorter
    than the whole one's (the n that makes it shortest); the scratch is
    bwd_layout's, the partials at the template's width."""
    rng = np.random.default_rng(seed)
    for _ in range(150):
        hd = int(rng.choice([64, 112, 120, 128, 256, 256]))
        b, kvh = int(rng.integers(1, 3)), int(rng.choice([1, 2, 4]))
        h = kvh * int(rng.choice([1, 2, 4, 8, 16]))
        tk = int(rng.integers(1, 5000))
        tq = int(rng.integers(1, tk + 1))
        causal, window = bool(rng.integers(0, 2)), int(rng.choice([0, 100, 2048]))
        q_offset = int(rng.integers(0, tk - tq + 1))
        sms = int(rng.choice([16, 132]))
        kv_bf16 = bool(rng.integers(0, 2))
        plan = fa_k.bwd_plan(hd, b, tq, tk, h, kvh, causal=causal, window=window,
                             q_offset=q_offset, sms=sms, kv_bf16=kv_bf16)
        n = plan.head_splits
        assert n == _head_splits(hd, b, tq, tk, h, kvh, causal, window, q_offset, plan.chunks,
                                 sms)
        assert 1 <= n <= h // kvh
        one_part = hd == 64 or (hd == 256 and plan.chunks == 0)
        assert plan.kv_parts == (1 if kv_bf16 and one_part else 3)
        hdk = 128 if hd in (112, 120) else hd
        assert plan.scratch_bytes == _bwd_layout_bytes(hdk, b, tq, tk, h, kvh, plan.chunks, n,
                                                       plan.kv_parts)


# the dry-run's training-rank islands (chip_smoke.TP_RANK_SHAPES) and
# minicpm-2b's train shape: (hd, b, tq, tk, h, kvh, window, q_offset) ->
# (dS-path chunks, head subsets, k/v parts) on 132 SMs
RANK_PLANS = {
    # 128 causal dK/dV blocks in one wave, the first streaming 4 x 128 query
    # tiles and the last 4 x 2: 2 subsets of 2 heads (258 tiles against 514)
    "kimi_rank_train": ((112, 2, 4096, 4096, 4, 1, 0, 0), (0, 2, 3)),
    "qwen3_rank_train": ((128, 2, 4096, 4096, 4, 1, 0, 0), (0, 2, 3)),
    # 256 blocks of 2 heads: already balanced (258 against 260 split)
    "h2o_rank_train": ((120, 4, 4096, 4096, 2, 1, 4096, 0), (0, 1, 3)),
    # a group of one head
    "internvl2_rank_train": ((128, 4, 4096, 4096, 1, 1, 0, 0), (0, 1, 3)),
    # 512 blocks: two waves and more
    "starcoder2_rank_seq0": ((128, 4, 256, 4096, 24, 2, 0, 0), (0, 1, 3)),
    "starcoder2_rank_seq3840": ((128, 4, 256, 4096, 24, 2, 0, 3840), (0, 1, 3)),
    # 4,608 blocks, MHA
    "minicpm_train": ((64, 2, 4096, 4096, 36, 36, 0, 0), (0, 1, 3)),
}


@pytest.mark.parametrize("cell", sorted(RANK_PLANS))
def test_head_split_plan_at_the_rank_islands(cell):
    """The plans chip_smoke.py holds the rank islands to: kimi-k2's and
    qwen3-moe's GQA-4 islands split the group in 2 subsets (their partials
    [2][2][4096][128] float32, 16.8 MB, in the scratch), every other island
    and minicpm-2b's train shape keep the whole group."""
    (hd, b, tq, tk, h, kvh, window, q_offset), want = RANK_PLANS[cell]
    plan = fa_k.bwd_plan(hd, b, tq, tk, h, kvh, causal=True, window=window, q_offset=q_offset,
                         sms=SMS)
    assert (plan.chunks, plan.head_splits, plan.kv_parts) == want
    hdk = 128 if hd in (112, 120) else hd
    whole = _bwd_layout_bytes(hdk, b, tq, tk, h, kvh, 0, 1, 3)
    assert plan.scratch_bytes - whole == (2 * 4 * 2 * b * kvh * tk * hdk if want[1] == 2 else 0)


# the head split at hd 128 (bwd_wgmma's 128-wide template) on a GQA-4 group:
# name -> (tq, tk, causal, window, softcap, q_offset, head subsets)
HD128_HEAD_SPLIT_CASES = {
    "causal_2_subsets": (128, 128, True, 0, 0.0, 0, 2),
    "island_4_subsets": (64, 192, True, 0, 0.0, 128, 4),
    "window_softcap_3_subsets": (128, 128, True, 48, 30.0, 0, 3),
}


@pytest.mark.parametrize("case", sorted(HD128_HEAD_SPLIT_CASES))
def test_bwd_split_ref_head_splits_at_hd128(case):
    """ref.attention_bwd_split_ref with the dK/dV pass's heads in subsets,
    at hd 128 over a 4-head group (numpy inputs from a seed): within
    BWD_TOL of the unsplit emulation and of jax.grad of the reference's
    blocked attention (layers._attention_flash, blocks of 16 queries and 64
    keys) on the same inputs."""
    import jax

    tq, tk, causal, window, softcap, q_offset, n = HD128_HEAD_SPLIT_CASES[case]
    q, _, _, do = _grad_inputs(1, tq, 4, 1, 128, seed=len(case))
    _, k, v, _ = _grad_inputs(1, tk, 4, 1, 128, seed=len(case) + 1)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = fa_r.attention_lse_ref(qt, kt, vt, **kw)
    got = fa_r.attention_bwd_split_ref(qt, kt, vt, o, lse, dot, **kw, head_splits=n)
    whole = fa_r.attention_bwd_split_ref(qt, kt, vt, o, lse, dot, **kw)

    def f(q_, k_, v_):
        out = JL._attention_flash(q_, k_, v_, causal=causal, window=jnp.asarray(window),
                                  softcap=softcap, q_offset=q_offset, kv_len=None, q_block=16,
                                  kv_block=64)
        return jnp.sum(out * jnp.asarray(do))

    exp_j = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    assert torch.equal(got[0], whole[0])   # dQ does not split
    for name, g, w, e in zip("qkv", got, whole, exp_j):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=BWD_TOL, rtol=BWD_TOL,
                                   err_msg=f"d{name}")
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=BWD_TOL, rtol=BWD_TOL,
                                   err_msg=f"jax d{name}")


# island-like shapes (q_offset > 0, Tq < Tk, GQA 2, hd 256) that split:
# name -> (b, tq, tk, h, kvh, causal, window, softcap, q_offset)
CHUNK_CASES = {
    "island": (1, 64, 512, 4, 2, True, 0, 0.0, 448),
    "island_mid": (1, 96, 1000, 4, 2, True, 0, 0.0, 500),
    "island_window_softcap": (1, 80, 1500, 4, 2, True, 600, 30.0, 1300),
    "causal_full": (1, 512, 512, 4, 2, True, 0, 0.0, 0),
    "cross": (2, 40, 700, 4, 2, False, 0, 0.0, 0),
}


def _chunk_inputs(case):
    b, tq, tk, h, kvh, causal, window, softcap, off = CHUNK_CASES[case]
    q, k, v, do = _offset_inputs(b, tq, tk, h, kvh, 256, len(case) + 40)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
    return (b, tq, tk, h, kvh), (q, k, v, do), kw


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunked_forward_ref_matches_lse_ref_and_jax(case):
    """flash_tiled's split (ref.attention_fwd_chunked_ref, the chunks as the
    plan gives them) against the plain forward with lse and the reference's
    blocked _attention_flash (its blocks dividing Tq and Tk) or
    _attention_direct: rows at the start of a causal island see no key of
    the later chunks."""
    (b, tq, tk, h, kvh), (q, k, v, _), kw = _chunk_inputs(case)
    plan = fa_k.tiled_plan(b, tq, tk, h, kvh, kv_len=tk, sms=SMS,
                           **{x: kw[x] for x in ("causal", "window", "q_offset")})
    assert plan.chunks >= 2
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    got_o, got_lse = fa_r.attention_fwd_chunked_ref(qt, kt, vt, plan.bounds, **kw)
    exp_o, exp_lse = fa_r.attention_lse_ref(qt, kt, vt, **kw)
    np.testing.assert_allclose(got_o.numpy(), exp_o.numpy(), atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(got_lse.numpy(), exp_lse.numpy(), atol=F32_TOL, rtol=F32_TOL)
    jkw = dict(causal=kw["causal"], window=jnp.asarray(kw["window"]), softcap=kw["softcap"],
               q_offset=kw["q_offset"], kv_len=None)
    if tq % 16 == 0 and tk % 64 == 0:
        exp_j = JL._attention_flash(*(jnp.asarray(x) for x in (q, k, v)), **jkw, q_block=16,
                                    kv_block=64)
    else:
        exp_j = JL._attention_direct(*(jnp.asarray(x) for x in (q, k, v)), **jkw)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(exp_j), atol=F32_TOL, rtol=F32_TOL)
    if case == "causal_full":  # row 0 sees no key of the second chunk: its partial weighs 0
        assert not _visible(tq, tk, True, 0, 0, tk)[0, plan.bounds[1]:].any()


def test_chunked_forward_ref_rows_without_any_key():
    """kv_len and a window leave the last rows with no key at all: the plan
    then splits all Tk keys, and the merge gives those rows the mean of v
    over all of them, as the plain forward does."""
    b, tq, tk, h, kvh = 1, 70, 800, 4, 2
    q, k, v, _ = _offset_inputs(b, tq, tk, h, kvh, 256, 71)
    kw = dict(causal=True, window=16, q_offset=300, kv_len=320)
    plan = fa_k.tiled_plan(b, tq, tk, h, kvh, sms=SMS, **{x: kw[x] for x in kw if x != "softcap"})
    assert plan.chunks >= 2 and plan.bounds[0] == 0 and plan.bounds[-1] == tk
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    got, _ = fa_r.attention_fwd_chunked_ref(qt, kt, vt, plan.bounds, **kw)
    exp = fa_r.attention_ref(qt, kt, vt, **kw)
    np.testing.assert_allclose(got.numpy(), exp.numpy(), atol=F32_TOL, rtol=F32_TOL)
    mean = vt.mean(1, keepdim=True).repeat_interleave(2, 2)
    np.testing.assert_allclose(got[:, -1:].numpy(), mean.numpy(), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_ds_path_dq_ref_matches_bwd_ref_and_jax_grad(case):
    """bwd_wide's dS path (ref.attention_bwd_ds_ref: dS stored with NaN where
    a row cannot see the key, dQ from each row's visible keys, the plan's
    chunks summed in order) against the plain backward and jax.grad of the
    reference's attention at the same offset."""
    import jax

    (b, tq, tk, h, kvh), (q, k, v, do), kw = _chunk_inputs(case)
    plan = fa_k.bwd_plan(256, b, tq, tk, h, kvh, sms=SMS,
                         **{x: kw[x] for x in ("causal", "window", "q_offset")})
    assert plan.chunks >= 2
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = fa_r.attention_lse_ref(qt, kt, vt, **kw)
    got = fa_r.attention_bwd_ds_ref(qt, kt, vt, o, lse, dot, plan.bounds, **kw)
    exp = fa_r.attention_bwd_ref(qt, kt, vt, o, lse, dot, **kw)
    for name, g, e in zip("qkv", got, exp):
        assert bool(torch.isfinite(g).all()), f"d{name}"
        np.testing.assert_allclose(g.numpy(), e.numpy(), atol=BWD_TOL, rtol=BWD_TOL,
                                   err_msg=f"d{name}")

    def f(q_, k_, v_):
        out = JL.attention(q_, k_, v_, impl="direct", **kw)
        return jnp.sum(out * jnp.asarray(do))

    exp_g = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for name, g, e in zip("qkv", got, exp_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=BWD_TOL, rtol=BWD_TOL,
                                   err_msg=f"jax d{name}")
