"""The port's MoE, RWKV-6, Griffin and Whisper families on the CPU against
the JAX reference, from the same parameters (the reference's, carried over
by ``interop.params_from_numpy``) and seeded numpy inputs.

Every config is a ``reduced()`` one, over ``DTYPES`` (``cfg.dtype``).
Tolerances (absolute plus relative): 1e-4 where the model computes in
float32 (RWKV whatever its ``dtype``; every family at ``dtype="float32"``;
the MoE models' cache-free forward, float32 with bfloat16-stored weights);
2e-2, the reference's bfloat16 tolerance, where activations or the cache
are bfloat16 (Griffin's and Whisper's bfloat16 configs: each product
rounds to bfloat16, and the port's and XLA's float32 sums round to
neighbouring values; the MoE models' bfloat16 cache).  Greedy tokens and
every integer and routing output of the MoE (``topi``, the stable expert
order, the slots, ``keep``) are identical.

Griffin's bfloat16 config also returns bfloat16 logits, and there 2e-2 is
taken relative to the largest logit (``_close``).  The port rounds every op
to bfloat16 as the reference's code says; the reference's compiled layer
scans keep some of those values in float32 (XLA's excess precision), so
the reference is not reproducible at 2e-2 elementwise by itself: its
compiled logits and the same code run op by op (``jax.disable_jit``)
differ by up to 0.070 on 2.6% of the logits (6 layers, 2 x 32 tokens,
largest logit 4.56), as the port and the compiled reference do (0.078,
2.7%).  Each Griffin layer alone matches the reference's op-by-op
evaluation bit for bit (``test_griffin_layers_match_op_by_op``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import griffin as JG
from repro.models import moe as JM
from repro.models import rwkv as JR
from repro.serve import serve_step as jserve
from repro_torch import configs as tconfigs, interop
from repro_torch.models import api as tapi
from repro_torch.models import griffin as TG
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import rwkv as TR
from repro_torch.serve import serve_step as tserve

F32_TOL = 1e-4
BF16_TOL = 2e-2
DTYPES = ("float32", "bfloat16")
MOE = ("qwen3-moe-235b-a22b", "kimi-k2-1t-a32b")
RECURRENT_AUDIO = ("rwkv6-7b", "recurrentgemma-9b", "whisper-medium")
FAMILIES = MOE + RECURRENT_AUDIO


def _tol(arch: str, dtype: str) -> float:
    """1e-4 for float32 arithmetic, 2e-2 where the path rounds to bfloat16."""
    if arch == "rwkv6-7b" or dtype == "float32":
        return F32_TOL
    return BF16_TOL


def _setup(arch: str, b: int, s: int, seed: int = 0, dtype: str = "bfloat16", **over):
    jcfg = jconfigs.get(arch).reduced(dtype=dtype, **over)
    tcfg = tconfigs.get(arch).reduced(dtype=dtype, **over)
    assert jcfg == jcfg.__class__(**{f: getattr(tcfg, f) for f in jcfg.__dataclass_fields__})
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = interop.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    jbatch, tbatch = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if jcfg.family == "audio":
        frames = rng.normal(size=(b, jcfg.source_positions, jcfg.d_model)).astype(np.float32)
        jbatch["frames"], tbatch["frames"] = jnp.asarray(frames), torch.from_numpy(frames)
    return jcfg, tcfg, jparams, tparams, jbatch, tbatch


def _close(got: torch.Tensor, exp, tol: float, msg: str = "", scaled: bool | None = None):
    """Within ``tol`` absolute plus relative; ``scaled`` (default: for
    bfloat16 logits) takes the absolute part as ``tol`` of the largest
    value (module doc)."""
    exp = np.asarray(exp, np.float32)
    scaled = got.dtype == torch.bfloat16 if scaled is None else scaled
    atol = tol * max(1.0, float(np.abs(exp).max())) if scaled else tol
    np.testing.assert_allclose(got.float().numpy(), exp, atol=atol, rtol=tol, err_msg=msg)


def _tree_close(got, exp, tol: float, scaled: bool = False):
    """A port state tree (tensors, ``len`` an int) against a reference one
    (numpy): equal structure and ``len``, each array as ``_close`` holds it
    (``scaled``: every array, as for a state computed from Griffin's
    bfloat16 activations)."""
    if isinstance(exp, dict):
        assert set(got) == set(exp)
        for k in exp:
            _tree_close(got[k], exp[k], tol, scaled)
    elif isinstance(exp, (tuple, list)):
        assert len(got) == len(exp)
        for g, e in zip(got, exp):
            _tree_close(g, e, tol, scaled)
    elif isinstance(got, torch.Tensor):
        _close(got, exp, tol, scaled=scaled)
    else:
        assert int(got) == int(exp)


# ---------------------------------------------------------------------------
# the model path, per family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", RECURRENT_AUDIO)
def test_forward_matches(arch, dtype):
    jcfg, tcfg, jp, tp, jb, tb = _setup(arch, b=2, s=32, dtype=dtype)
    exp, exp_aux = japi.logits_fn(jcfg, jp, jb)
    got, aux = tapi.logits_fn(tcfg, tp, tb)
    assert got.dtype == getattr(torch, str(exp.dtype)) and got.shape == exp.shape
    assert float(aux) == float(exp_aux) == 0.0
    _close(got, exp, _tol(arch, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_matches(arch, dtype):
    """loss_fn's value (CE + aux), against the reference's."""
    b, s = 2, 32
    jcfg, tcfg, jp, tp, jb, tb = _setup(arch, b=b, s=s, seed=3, dtype=dtype)
    mask = (np.random.default_rng(5).random((b, s)) > 0.2).astype(np.float32)
    jb["mask"], tb["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    exp, exp_m = japi.loss_fn(jcfg, jp, jb)
    got, got_m = tapi.loss_fn(tcfg, tp, tb)
    tol = _tol(arch, dtype)
    _close(got, exp, tol)
    _close(got_m["aux"], exp_m["aux"], F32_TOL)
    assert (float(got_m["aux"]) > 0) == (arch in MOE)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", RECURRENT_AUDIO)
def test_prefill_and_decode_steps_match(arch, dtype):
    """Logits at every step, the greedy token of every step, the state."""
    b, s, steps = 2, 16, 6
    jcfg, tcfg, jp, tp, jb, tb = _setup(arch, b=b, s=s, seed=2, dtype=dtype)
    tol = _tol(arch, dtype)
    jstate = japi.init_decode_state(jcfg, b, s + steps, getattr(jnp, dtype))
    tstate = tapi.init_decode_state(tcfg, b, s + steps, getattr(torch, dtype), device="cpu")
    jl, jstate = japi.prefill_fn(jcfg, jp, jb, jstate)
    tl, tstate = tapi.prefill_fn(tcfg, tp, tb, tstate)
    _close(tl, jl, tol, msg="prefill")
    for i in range(steps):
        jtok, ttok = jserve.greedy_sample(jl), tserve.greedy_sample(tl)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jstate = japi.decode_fn(jcfg, jp, jtok, jstate)
        tl, tstate = tapi.decode_fn(tcfg, tp, ttok, tstate)
        _close(tl, jl, tol, msg=f"decode step {i}")
    assert int(tstate["len"]) == int(jstate["len"]) == s + steps
    _tree_close(tstate, jax.tree.map(np.asarray, jstate), tol,
                scaled=arch == "recurrentgemma-9b" and dtype == "bfloat16")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", RECURRENT_AUDIO)
def test_generate_matches(arch, dtype):
    b, s, max_new = 2, 32, 8
    jcfg, tcfg, jp, tp, jb, tb = _setup(arch, b=b, s=s, seed=4, dtype=dtype)
    jtoks, _ = jserve.generate(jcfg, jp, jb, max_new)
    steps = []
    ttoks, _ = tserve.generate(tcfg, tp, tb, max_new,
                               on_step=lambda tok, lg: steps.append((tok, lg)))
    assert ttoks.dtype == torch.int32 and ttoks.shape == (b, max_new)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    assert len(steps) == max_new
    for i, (tok, lg) in enumerate(steps):
        np.testing.assert_array_equal(tok[:, 0].numpy(), ttoks[:, i].numpy())


@pytest.mark.parametrize("arch", RECURRENT_AUDIO)
def test_state_interop_round_trip(arch):
    """The reference's state after a prefill, carried into the port, gives
    the reference's next decode step; and back to numpy unchanged."""
    b, s = 2, 16
    jcfg, tcfg, jp, tp, jb, tb = _setup(arch, b=b, s=s, seed=6)
    jstate = japi.init_decode_state(jcfg, b, s + 2)
    jl, jstate = japi.prefill_fn(jcfg, jp, jb, jstate)
    jnp_state = jax.tree.map(np.asarray, jstate)
    tstate = interop.state_from_numpy(jnp_state, device="cpu")
    assert tstate["len"] == s and isinstance(tstate["len"], int)
    back = interop.state_to_numpy(tstate)
    _tree_close(interop.state_from_numpy(back, device="cpu"), jnp_state, 0.0)
    for t, j in zip(tapi.tree_leaves(tstate), jax.tree.leaves(jstate)):
        if isinstance(t, torch.Tensor):
            assert str(t.dtype).split(".")[1] == str(j.dtype)   # bfloat16 stays bfloat16
    tok = np.array(jserve.greedy_sample(jl))
    jl2, _ = japi.decode_fn(jcfg, jp, jnp.asarray(tok), jstate)
    tl2, _ = tapi.decode_fn(tcfg, tp, torch.from_numpy(tok), tstate)
    _close(tl2, jl2, _tol(arch, "bfloat16"))


# ---------------------------------------------------------------------------
# MoE routing and dispatch
# ---------------------------------------------------------------------------

def _moe_inputs(arch: str, n: int, seed: int, **over):
    jcfg = jconfigs.get(arch).reduced(**over)
    tcfg = tconfigs.get(arch).reduced(**over)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, jcfg.d_model)).astype(np.float32)
    mp = jax.tree.map(np.array, JM.init_moe_block(jcfg, jax.random.PRNGKey(seed), 1))
    mp = {k: v[0] for k, v in mp.items()}
    return jcfg, tcfg, x, mp


@pytest.mark.parametrize("capacity_factor", [1.25, 16.0])
@pytest.mark.parametrize("arch", MOE)
def test_routing_matches_bit_for_bit(arch, capacity_factor):
    """topi, the stable expert order, counts, slots and keep: identical;
    weights and aux within float32 sums."""
    n = 96
    jcfg, tcfg, x, mp = _moe_inputs(arch, n, seed=7, capacity_factor=capacity_factor)
    e, k = jcfg.num_experts, jcfg.experts_per_token
    cap = int(np.ceil(n * k / e * capacity_factor))
    jv, ji, jaux = JM._route(jnp.asarray(x), jnp.asarray(mp["router"]), jcfg)
    tv, ti, taux = TM._route(torch.from_numpy(x), torch.from_numpy(mp["router"]), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tv, jv, 1e-6)
    _close(taux, jaux, 1e-6)
    jbuf, jmeta = JM._bucket_by_expert(jnp.asarray(x), jv, ji, e, cap)
    tbuf, tmeta = TM._bucket_by_expert(torch.from_numpy(x), torch.from_numpy(np.array(jv)),
                                       torch.from_numpy(np.array(ji)), e, cap)
    for name, g, j in zip(("e_sorted", "slot_row", "tok_sorted", "w_sorted", "keep"), tmeta,
                          jmeta):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j), err_msg=name)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    keep = tmeta[4].numpy()
    if capacity_factor == 16.0:
        assert keep.all()
    else:
        assert not keep.all()    # 1.25 drops pairs at this skew
    counts = np.bincount(np.asarray(ji).reshape(-1), minlength=e)
    assert keep.sum() == np.minimum(counts, cap).sum()


def _moe_block(cfg, x, mp, wi=None):
    """moe_block over x [N, d] as [1, N, d], in the reference or the port."""
    if isinstance(cfg, tconfigs.get("rwkv6-7b").__class__):
        mp = {k: torch.from_numpy(v) for k, v in mp.items()}
        if wi is not None:
            mp["wi"] = wi
        out, aux = TM.moe_block(torch.from_numpy(x)[None], mp, cfg)
    else:
        out, aux = JM.moe_block(jnp.asarray(x)[None], {k: jnp.asarray(v) for k, v in mp.items()},
                                cfg)
    return out[0], aux


@pytest.mark.parametrize("capacity_factor", [1.25, 16.0])
@pytest.mark.parametrize("arch", MOE)
def test_moe_block_matches(arch, capacity_factor):
    """moe_block (experts cast to cfg.dtype, then _moe_local) against the
    reference's."""
    n = 64
    jcfg, tcfg, x, mp = _moe_inputs(arch, n, seed=8, capacity_factor=capacity_factor)
    jout, jaux = _moe_block(jcfg, x, mp)
    tout, taux = _moe_block(tcfg, x, mp)
    _close(tout, jout, F32_TOL)
    _close(taux, jaux, 1e-6)


def test_dead_experts_are_skipped_exactly():
    """At moe_pad_experts=4 the reference computes every padded expert; the
    port buckets and computes only the live ones (module doc of
    ``models.moe``) and agrees, layer and model."""
    arch = "qwen3-moe-235b-a22b"
    n = 48
    jcfg, tcfg, x, mp = _moe_inputs(arch, n, seed=9, moe_pad_experts=4)
    assert mp["wi"].shape[0] == jcfg.num_experts + 4
    jout, _ = _moe_block(jcfg, x, mp)
    tout, _ = _moe_block(tcfg, x, mp)
    _close(tout, jout, F32_TOL)
    # the dead experts' weights are never read: NaN there changes nothing
    wi = torch.from_numpy(mp["wi"]).clone()
    wi[jcfg.num_experts:] = float("nan")
    tout2, _ = _moe_block(tcfg, x, mp, wi=wi)
    assert torch.equal(tout, tout2)
    jcfg, tcfg, jp, tp, jb, tb = _setup(arch, b=2, s=16, seed=10, moe_pad_experts=4)
    exp, exp_aux = japi.logits_fn(jcfg, jp, jb)
    got, aux = tapi.logits_fn(tcfg, tp, tb)
    _close(got, exp, F32_TOL)
    _close(aux, exp_aux, 1e-6)


def test_moe_params_held_in_bfloat16():
    """bfloat16 weight storage: every leaf as the reference's astype."""
    _, tcfg, jp, tp, _, _ = _setup("kimi-k2-1t-a32b", b=1, s=4)
    assert tcfg.param_dtype == "bfloat16"
    leaves = tapi.tree_leaves(tp)
    assert leaves and all(t.dtype == torch.bfloat16 for t in leaves)
    ref = jax.tree.leaves(jax.tree.map(np.asarray, jp))
    for t, r in zip(leaves, ref):
        np.testing.assert_array_equal(t.float().numpy(), r.astype(np.float32))
    fresh = tapi.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert set(fresh["blocks"]) == set(tp["blocks"]) >= {"moe", "wi_sh", "wo_sh"}
    assert all(t.dtype == torch.bfloat16 for t in tapi.tree_leaves(fresh))


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_held_the_same_by_init_and_interop(arch):
    """``api.init_params`` and ``interop.params_from_numpy`` hold each leaf
    alike (``api.hold_leaf``): the port's tree through numpy and back is
    the same tree, dtype and bits."""
    tcfg = tconfigs.get(arch).reduced()
    tp = tapi.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    back = interop.params_from_numpy(tcfg, interop.params_to_numpy(tp), device="cpu")
    leaves, again = tapi.tree_leaves(tp), tapi.tree_leaves(back)
    assert len(leaves) == len(again)
    for a, c in zip(leaves, again):
        assert a.dtype == c.dtype and torch.equal(a, c)


@pytest.mark.parametrize("flag", ["allow_tf32", "allow_bf16_reduced_precision_reduction"])
@pytest.mark.parametrize("arch", ("gemma3-4b",) + FAMILIES)
def test_card_products_refuse_other_arithmetic(monkeypatch, arch, flag):
    """On the card the entry points refuse TF32 for every family, and
    bfloat16 partial sums where the family's products read bfloat16
    (Griffin, Whisper); on the CPU neither flag matters."""
    cfg = tconfigs.get(arch)
    matmul = torch.backends.cuda.matmul
    monkeypatch.setattr(matmul, "allow_tf32", False)
    monkeypatch.setattr(matmul, "allow_bf16_reduced_precision_reduction", False)
    dtype = tapi.compute_dtype(cfg)
    assert dtype == (torch.bfloat16 if cfg.family in ("hybrid", "audio") else torch.float32)
    TL.check_products(torch.device("cuda"), dtype)
    monkeypatch.setattr(matmul, flag, True)
    TL.check_products(torch.device("cpu"), dtype)
    if flag == "allow_tf32" or dtype == torch.bfloat16:
        with pytest.raises(RuntimeError, match=flag):
            TL.check_products(torch.device("cuda"), dtype)
    else:
        TL.check_products(torch.device("cuda"), dtype)


# ---------------------------------------------------------------------------
# the recurrences alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [False, True])
def test_rg_lru_matches(with_h0):
    """The doubling scan against the reference's associative scan (float32
    sums in another order), with and without a carried h."""
    b, t, w = 2, 45, 24
    rng = np.random.default_rng(11)
    x = rng.normal(size=(b, t, w)).astype(np.float32)
    blk = {"wa": rng.normal(size=(w, w)).astype(np.float32) / w ** 0.5,
           "wi_g": rng.normal(size=(w, w)).astype(np.float32) / w ** 0.5,
           "a_param": rng.normal(size=(w,)).astype(np.float32)}
    h0 = rng.normal(size=(b, w)).astype(np.float32) if with_h0 else None
    jh, jlast = JG._rg_lru(jnp.asarray(x), {k: jnp.asarray(v) for k, v in blk.items()},
                           None if h0 is None else jnp.asarray(h0))
    th, tlast = TG._rg_lru(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in blk.items()},
                           None if h0 is None else torch.from_numpy(h0))
    _close(th, jh, 1e-5)
    _close(tlast, jlast, 1e-5)


def test_linear_scan_is_the_recurrence():
    rng = np.random.default_rng(12)
    a = torch.from_numpy(rng.random((3, 37, 5)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(3, 37, 5)).astype(np.float32))
    h, want = torch.zeros(3, 5), []
    for i in range(37):
        h = a[:, i] * h + b[:, i]
        want.append(h)
    torch.testing.assert_close(TG._linear_scan(a, b), torch.stack(want, 1), atol=1e-5, rtol=1e-5)


def _linear_scan_in_place(a, b):
    """The doubling scan as it ran before it made new tensors per step (in
    place on clones: no gradient)."""
    t, span = a.shape[1], 1
    a, b = a.clone(), b.clone()
    while span < t:
        b[:, span:] += a[:, span:] * b[:, :-span]
        a[:, span:] = a[:, span:] * a[:, :-span]
        span *= 2
    return b


@pytest.mark.parametrize("t", [1, 2, 37, 64, 4096])
def test_linear_scan_equals_the_in_place_scan(t):
    """The out-of-place scan keeps the in-place one's order of sums: bit for
    bit, so serving's results do not move."""
    rng = np.random.default_rng(t)
    a = torch.from_numpy(rng.random((2, t, 8)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(2, t, 8)).astype(np.float32))
    assert torch.equal(TG._linear_scan(a, b), _linear_scan_in_place(a, b))


def test_linear_scan_gradcheck():
    """Autograd through the scan against finite differences, float64."""
    rng = np.random.default_rng(14)
    a = torch.from_numpy(rng.uniform(0.2, 0.9, (2, 11, 3))).requires_grad_()
    b = torch.from_numpy(rng.normal(size=(2, 11, 3))).requires_grad_()
    assert torch.autograd.gradcheck(TG._linear_scan, (a, b))


def test_causal_conv_matches():
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    carry = rng.normal(size=(2, 3, 6)).astype(np.float32)
    for c in (None, carry):
        jo, jc = JG._causal_conv(jnp.asarray(x), jnp.asarray(w), None if c is None else jnp.asarray(c))
        to, tc = TG._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                 None if c is None else torch.from_numpy(c))
        _close(to, jo, 1e-6)
        _close(tc, jc, 0.0)


@pytest.mark.parametrize("chunk,n", [(1, 1), (16, 1), (4, 3)])
def test_wkv_chunk_matches(chunk, n):
    """The port's _wkv_chunk over n consecutive chunks at once against the
    reference's, one chunk at a time."""
    b, h, dk = 2, 3, 8
    rng = np.random.default_rng(14 + chunk)
    S = rng.normal(size=(b, h, dk, dk)).astype(np.float32)
    r, k, v = (rng.normal(size=(b, n * chunk, h, dk)).astype(np.float32) for _ in range(3))
    logw = -np.exp(rng.normal(size=(b, n * chunk, h, dk)).astype(np.float32) - 2)
    u = rng.normal(size=(h, dk)).astype(np.float32)
    jS, outs = jnp.asarray(S), []
    for c in range(0, n * chunk, chunk):
        jS, jo = JR._wkv_chunk(jS, *(jnp.asarray(a[:, c:c + chunk]) for a in (r, k, v, logw)),
                               jnp.asarray(u), chunk)
        outs.append(np.asarray(jo))
    tS, to = TR._wkv_chunk(*(torch.from_numpy(a) for a in (S, r, k, v, logw, u)), chunk)
    _close(tS, jS, 1e-5)
    _close(to, np.concatenate(outs, axis=1), 1e-5)


@pytest.mark.parametrize("kind", ["rec", "attn"])
def test_griffin_layers_match_op_by_op(kind):
    """One bfloat16 Griffin layer against the reference's, op by op: bit
    for bit (the gelu's rounding steps included, ``layers.gelu``)."""
    jcfg, tcfg, jp, tp, _, _ = _setup("recurrentgemma-9b", b=1, s=4, seed=16)
    j = jcfg.block_pattern.index(kind)
    jblk = jax.tree.map(lambda a: a[0], jp["group"][j])
    tblk = {n: w[0] for n, w in tp["group"][j].items()}
    x = np.random.default_rng(17).normal(size=(2, 24, jcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    with jax.disable_jit():
        if kind == "rec":
            exp, _ = JG._rec_layer(jcfg, jx, jblk)
            got, _ = TG._rec_layer(tcfg, tx, tblk)
        else:
            exp, _ = JG._attn_layer(jcfg, jx, jblk, jnp.arange(24))
            got = TG._attn_layer(tcfg, tx, tblk, torch.arange(24))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(exp, np.float32))


# ---------------------------------------------------------------------------
# attention with bfloat16 activations
# ---------------------------------------------------------------------------

def test_attention_takes_bf16_q_and_returns_bf16():
    """bfloat16 q goes to the kernel as its float32 value and comes back in
    bfloat16, as the reference's attention upcasts and casts back."""
    from repro.models import layers as JL

    rng = np.random.default_rng(15)
    q = torch.from_numpy(rng.normal(size=(2, 5, 4, 32)).astype(np.float32)).to(torch.bfloat16)
    k = torch.from_numpy(rng.normal(size=(2, 9, 2, 32)).astype(np.float32)).to(torch.bfloat16)
    v = torch.from_numpy(rng.normal(size=(2, 9, 2, 32)).astype(np.float32)).to(torch.bfloat16)
    got = TL.attention(q, k, v, causal=False)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v))
    exp = JL.attention(jq, jk, jv, causal=False)
    assert exp.dtype == jnp.bfloat16
    # both round the same float32 output to bfloat16: at most one ulp apart
    _close(got, exp, 1e-2)
    assert TL.kv_as(k, torch.float32) is k   # bfloat16 k/v reach the kernel as they are
    assert TL.kv_as(k.float(), torch.bfloat16).dtype == torch.bfloat16
