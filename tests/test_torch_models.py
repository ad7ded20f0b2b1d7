"""The port's model path on the CPU against the JAX reference: layers,
``forward``, ``prefill``, ``decode_step`` and ``generate``, from the same
parameters (the reference's, carried over by ``interop.params_from_numpy``).

Tolerances: layers 1e-6 (float32, one op each); greedy tokens identical;
logits 1e-4 where nothing is rounded to bfloat16 (float32 through several
layers, sums in another order).  Every config is a reduced one: gemma3-4b
with 6 layers (5 local, 1 global), starcoder2-3b (gelu, GQA),
internvl2-2b (patch prefix) and the MoE models qwen3-moe-235b-a22b and
kimi-k2-1t-a32b (bfloat16 weight storage; kimi-k2's shared expert; aux
loss within 1e-6).  The other families are in ``test_torch_families.py``.  Each runs with ``dtype="float32"`` and with
its stock bfloat16 ``dtype``, which the reference also computes in float32
(see ``repro_torch.models.transformer``) except that the KV cache holds k/v
rounded to bfloat16.  There the two packages' float32 k/v, a few float32
ulps apart (another matmul library), can round to neighbouring bfloat16
values: the first layer's cache agrees within one bfloat16 ulp, and the
deeper layers' cache and the logits of the cached path within 2e-2, the reference's own bfloat16 tolerance
(``tests/test_kernels.py``, ``tests/test_models.py``); the largest gap
measured on these inputs is 1.4e-3.  The cache-free ``forward`` holds 1e-4
under either dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve import serve_step as jserve
from repro_torch import configs as tconfigs, interop
from repro_torch.models import api as tapi
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve import serve_step as tserve

LAYER_TOL = 1e-6
LOGIT_TOL = 1e-4
BF16_CACHE_TOL = 2e-2
DTYPES = ("float32", "bfloat16")

CASES = {
    "gemma3-4b": dict(num_layers=6),
    "starcoder2-3b": {},
    "internvl2-2b": {},
    "qwen3-moe-235b-a22b": {},
    "kimi-k2-1t-a32b": {},
}
DENSE_VLM = ("gemma3-4b", "minicpm-2b", "starcoder2-3b", "h2o-danube-3-4b", "internvl2-2b")
OTHER_FAMILIES = ("qwen3-moe-235b-a22b", "kimi-k2-1t-a32b", "rwkv6-7b", "recurrentgemma-9b",
                  "whisper-medium")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def test_rms_norm_matches():
    rng = np.random.default_rng(0)
    x, s = _normal(rng, 2, 5, 64), _normal(rng, 64)
    exp = JL.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6)
    got = TL.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=LAYER_TOL, rtol=LAYER_TOL)


@pytest.mark.parametrize("theta,pos_2d", [(10000.0, False), (1_000_000.0, True)])
def test_rope_matches(theta, pos_2d):
    rng = np.random.default_rng(1)
    x = _normal(rng, 2, 12, 4, 32)
    pos = np.arange(12, dtype=np.int32) + 3
    if pos_2d:
        pos = np.stack([pos, pos + 7])
    exp = JL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=LAYER_TOL, rtol=LAYER_TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_mlp_matches(act):
    rng = np.random.default_rng(2)
    x, wi, wo = _normal(rng, 2, 3, 16), _normal(rng, 16, 48) / 4, _normal(rng, 24, 16) / 5
    exp = JL.gated_mlp(jnp.asarray(x), jnp.asarray(wi), jnp.asarray(wo), act)
    got = TL.gated_mlp(torch.from_numpy(x), torch.from_numpy(wi), torch.from_numpy(wo), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=LAYER_TOL, rtol=LAYER_TOL)


def test_embed_promotes_bf16_table_to_float32():
    rng = np.random.default_rng(3)
    table = _normal(rng, 50, 40)
    toks = rng.integers(0, 50, (2, 7)).astype(np.int32)
    exp = JL.embed(jnp.asarray(toks), jnp.asarray(table, jnp.bfloat16), scale=True)
    got = TL.embed(torch.from_numpy(toks), torch.from_numpy(table).to(torch.bfloat16), scale=True)
    assert exp.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=LAYER_TOL, rtol=LAYER_TOL)
    plain = TL.embed(torch.from_numpy(toks), torch.from_numpy(table))
    np.testing.assert_array_equal(plain.numpy(), table[toks])


def test_layer_windows_match():
    for arch in DENSE_VLM:
        cfg = jconfigs.get(arch)
        assert TT._layer_windows(tconfigs.get(arch)) == np.asarray(JT._layer_windows(cfg)).tolist()


# ---------------------------------------------------------------------------
# the model path
# ---------------------------------------------------------------------------

def _setup(arch: str, b: int, s: int, seed: int = 0, dtype: str = "bfloat16"):
    jcfg = jconfigs.get(arch).reduced(dtype=dtype, **CASES[arch])
    tcfg = tconfigs.get(arch).reduced(dtype=dtype, **CASES[arch])
    assert jcfg == jcfg.__class__(**{f: getattr(tcfg, f) for f in jcfg.__dataclass_fields__})
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = interop.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    jbatch, tbatch = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if jcfg.family == "vlm":
        patches = _normal(rng, b, jcfg.frontend_tokens, jcfg.d_model)
        jbatch["patches"], tbatch["patches"] = jnp.asarray(patches), torch.from_numpy(patches)
    return jcfg, tcfg, jparams, tparams, jbatch, tbatch


def _close(got: torch.Tensor, exp, tol=LOGIT_TOL, msg=""):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(exp, np.float32), atol=tol,
                               rtol=tol, err_msg=msg)


def _assert_cache_close(tcache, jcache, dtype: str):
    """A float32 cache within LOGIT_TOL.  A bfloat16 one: the first layer's
    k/v (one rounding of float32 values a few ulps apart) within one
    bfloat16 ulp; deeper layers, whose inputs went through the rounding of
    the layers before, within the cached path's tolerance."""
    got = interop.cache_to_numpy(tcache)["kv"]
    exp = np.asarray(jcache["kv"]).astype(np.float32)
    assert int(tcache["len"]) == int(jcache["len"])
    if dtype == "float32":
        np.testing.assert_allclose(got, exp, atol=LOGIT_TOL, rtol=LOGIT_TOL)
        return
    mag = np.maximum(np.abs(got[0]), np.abs(exp[0]))
    # bfloat16 keeps 8 significand bits: one ulp at |x| is 2^(floor(log2|x|) - 7)
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(got[0] - exp[0]) <= ulp)
    np.testing.assert_allclose(got, exp, atol=BF16_CACHE_TOL, rtol=BF16_CACHE_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", list(CASES))
def test_forward_matches(arch, dtype):
    jcfg, tcfg, jp, tp, jb, tb = _setup(arch, b=2, s=40, dtype=dtype)
    exp, exp_aux = japi.logits_fn(jcfg, jp, jb)
    got, aux = tapi.logits_fn(tcfg, tp, tb)
    assert got.dtype == torch.float32
    assert (float(aux) == 0.0) == (jcfg.family != "moe")
    _close(aux, exp_aux, 1e-6)
    _close(got, exp)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", list(CASES))
def test_prefill_and_decode_steps_match(arch, dtype):
    """Logits at every step, the greedy token of every step, the cache."""
    b, s, steps = 2, 36, 6
    jcfg, tcfg, jp, tp, jb, tb = _setup(arch, b=b, s=s, seed=2, dtype=dtype)
    tol = LOGIT_TOL if dtype == "float32" else BF16_CACHE_TOL
    jstate = japi.init_decode_state(jcfg, b, s + steps, getattr(jnp, dtype))
    tstate = tapi.init_decode_state(tcfg, b, s + steps, getattr(torch, dtype), device="cpu")
    jl, jstate = japi.prefill_fn(jcfg, jp, jb, jstate)
    tl, tstate = tapi.prefill_fn(tcfg, tp, tb, tstate)
    _close(tl, jl, tol, msg="prefill")
    _assert_cache_close(tstate, jstate, dtype)
    for i in range(steps):
        jtok, ttok = jserve.greedy_sample(jl), tserve.greedy_sample(tl)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jstate = japi.decode_fn(jcfg, jp, jtok, jstate)
        tl, tstate = tapi.decode_fn(tcfg, tp, ttok, tstate)
        _close(tl, jl, tol, msg=f"decode step {i}")
    _assert_cache_close(tstate, jstate, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", list(CASES))
def test_generate_matches(arch, dtype):
    b, s, max_new = 2, 44, 8
    jcfg, tcfg, jp, tp, jb, tb = _setup(arch, b=b, s=s, seed=4, dtype=dtype)
    jtoks, jstate = jserve.generate(jcfg, jp, jb, max_new)
    steps = []
    ttoks, tstate = tserve.generate(tcfg, tp, tb, max_new,
                                    on_step=lambda tok, lg: steps.append((tok, lg)))
    assert ttoks.dtype == torch.int32 and ttoks.shape == (b, max_new)
    assert tstate["kv"].dtype == torch.bfloat16  # generate's cache, as the reference's
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    _assert_cache_close(tstate, jstate, "bfloat16")
    # each step's streamed token is the one generate returned, and its argmax
    assert len(steps) == max_new
    for i, (tok, lg) in enumerate(steps):
        np.testing.assert_array_equal(tok[:, 0].numpy(), ttoks[:, i].numpy())
        np.testing.assert_array_equal(lg.argmax(-1).numpy(), ttoks[:, i].numpy())


def test_gemma3_prefill_spans_the_window():
    """A prompt longer than the reduced local window (32) and than one
    64-row tile, with a ragged edge: the 5 local and 1 global layers."""
    b, s = 1, 100
    jcfg, tcfg, jp, tp, jb, tb = _setup("gemma3-4b", b=b, s=s, seed=6, dtype="float32")
    assert TT._layer_windows(tcfg) == [32] * 5 + [0]
    jl, _ = japi.prefill_fn(jcfg, jp, jb, japi.init_decode_state(jcfg, b, s + 3, jnp.float32))
    tl, _ = tapi.prefill_fn(tcfg, tp, tb, tapi.init_decode_state(tcfg, b, s + 3, torch.float32,
                                                                  device="cpu"))
    _close(tl, jl)


def test_decode_matches_teacher_forced_forward():
    """The port's own consistency: prefill + decode == its forward, as the
    reference's ``test_decode_matches_forward`` holds (float32 cache)."""
    jcfg, tcfg, jp, tp, jb, tb = _setup("gemma3-4b", b=2, s=12, seed=7)
    full, _ = tapi.logits_fn(tcfg, tp, tb)
    npfx = 8
    state = tapi.init_decode_state(tcfg, 2, 13, dtype=torch.float32, device="cpu")
    logits, state = tapi.prefill_fn(tcfg, tp, {"tokens": tb["tokens"][:, :npfx]}, state)
    torch.testing.assert_close(logits[:, 0], full[:, npfx - 1], atol=2e-2, rtol=2e-2)
    for i in range(npfx, 12):
        logits, state = tapi.decode_fn(tcfg, tp, tb["tokens"][:, i:i + 1], state)
        torch.testing.assert_close(logits[:, 0], full[:, i], atol=2e-2, rtol=2e-2)


def test_float32_cache_is_read_back_in_compute_dtype():
    """With a float32 cache the reference still reads k/v as cfg.dtype:
    bfloat16-rounded k/v, so the bfloat16 tolerance of the cached path."""
    b, s = 2, 20
    jcfg, tcfg, jp, tp, jb, tb = _setup("starcoder2-3b", b=b, s=s, seed=8)
    jl, js = japi.prefill_fn(jcfg, jp, jb, japi.init_decode_state(jcfg, b, s + 2, jnp.float32))
    tl, ts = tapi.prefill_fn(tcfg, tp, tb, tapi.init_decode_state(tcfg, b, s + 2, torch.float32,
                                                                  device="cpu"))
    _close(tl, jl, BF16_CACHE_TOL)
    tok = np.array(jserve.greedy_sample(jl))
    jl, _ = japi.decode_fn(jcfg, jp, jnp.asarray(tok), js)
    tl, _ = tapi.decode_fn(tcfg, tp, torch.from_numpy(tok), ts)
    _close(tl, jl, BF16_CACHE_TOL)


# ---------------------------------------------------------------------------
# parameters, interop, entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE_VLM + OTHER_FAMILIES)
def test_param_count_matches_reference(arch):
    assert tconfigs.get(arch).param_count() == jconfigs.get(arch).param_count()


def test_active_param_count_and_analytic_count():
    cfg = tconfigs.get("starcoder2-3b")
    assert cfg.active_param_count() == cfg.param_count() == cfg._param_count_analytic()
    assert cfg._param_count_analytic() == jconfigs.get("starcoder2-3b")._param_count_analytic()


def test_params_interop_round_trip():
    jcfg, tcfg, jp, tp, _, _ = _setup("internvl2-2b", b=1, s=4)
    # the port's tree -> numpy -> the port's tree: exact
    back = interop.params_from_numpy(tcfg, interop.params_to_numpy(tp), device="cpu")
    for a, c in zip(tapi.tree_leaves(tp), tapi.tree_leaves(back)):
        assert torch.equal(a, c)
    # the reference's tree -> the port's: norms exact, matrix weights at their
    # bfloat16 rounding (what the reference's products read)
    out = interop.params_to_numpy(tp)
    ref = jax.tree.map(np.asarray, jp)
    np.testing.assert_array_equal(out["final_norm"], ref["final_norm"])
    np.testing.assert_array_equal(out["blocks"]["ln1"], ref["blocks"]["ln1"])
    for name in ("wq", "wi"):
        exp = np.asarray(jnp.asarray(ref["blocks"][name]).astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(out["blocks"][name], exp)
    # a float32-compute config keeps every leaf exact
    f32 = tcfg.__class__(**{**tcfg.__dict__, "dtype": "float32"})
    exact = interop.params_to_numpy(interop.params_from_numpy(f32, ref, device="cpu"))
    np.testing.assert_array_equal(exact["blocks"]["wq"], ref["blocks"]["wq"])
    np.testing.assert_array_equal(exact["embed"], ref["embed"])


def test_cache_interop_round_trip():
    jcfg = jconfigs.get("gemma3-4b").reduced(num_layers=2)
    cache = JT.init_cache(jcfg, 2, 8)
    kv = np.random.default_rng(9).normal(size=cache["kv"].shape).astype(np.float32)
    cache = {"kv": jnp.asarray(kv, jnp.bfloat16), "len": jnp.asarray(5, jnp.int32)}
    tc = interop.cache_from_numpy(jax.tree.map(np.asarray, cache), device="cpu")
    assert tc["kv"].dtype == torch.bfloat16 and tc["len"] == 5
    back = interop.cache_to_numpy(tc)
    np.testing.assert_array_equal(back["kv"], np.asarray(cache["kv"]).astype(np.float32))
    assert back["len"] == 5


def test_init_params_shapes_match_reference():
    cfg = "gemma3-4b"
    jcfg, tcfg = jconfigs.get(cfg).reduced(num_layers=6), tconfigs.get(cfg).reduced(num_layers=6)
    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in tree.items()}

    tp = tapi.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert shapes(tp) == shapes(japi.init_params(jcfg, jax.random.PRNGKey(0)))
    wq = tp["blocks"]["wq"]
    assert torch.equal(wq, wq.to(torch.bfloat16).float())  # held at bfloat16 rounding
    again = tapi.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tapi.tree_leaves(tp), tapi.tree_leaves(again)))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    cfg = tconfigs.get("gemma3-4b").reduced(num_layers=6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.init_decode_state(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.params_from_numpy(cfg, {"final_norm": np.zeros(4, np.float32)})


@pytest.mark.parametrize("arch", ("starcoder2-3b",) + OTHER_FAMILIES)
def test_sharded_context_raises(arch):
    """A DistContext flows through every family and entry point (it raised
    before the SPMD surface was ported); without a mesh it changes nothing:
    the logits equal those of ctx=None bit for bit.  Sharded meshes are
    tests/test_torch_spmd.py's."""
    tcfg = tconfigs.get(arch).reduced()
    tp = tapi.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    tb = {"tokens": torch.arange(4, dtype=torch.int32)[None] % tcfg.vocab_size}
    if tcfg.family == "audio":
        tb["frames"] = torch.zeros((1, tcfg.source_positions, tcfg.d_model))
    ctx = TT.DistContext(ep_axis=None, dp_axes=())
    outs = []
    for c in (None, ctx):
        state = tapi.init_decode_state(tcfg, 1, 8, device="cpu")
        outs.append((tapi.logits_fn(tcfg, tp, tb, ctx=c)[0],
                     tapi.prefill_fn(tcfg, tp, tb, state, ctx=c)[0]))
        outs[-1] += (tapi.decode_fn(tcfg, tp, tb["tokens"][:, :1], state, ctx=c)[0],)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_sampling():
    logits = torch.tensor([[[0.0, 3.0, 3.0, 1.0]], [[5.0, 0.0, 0.0, 5.0]]])
    tok = tserve.greedy_sample(logits)
    assert tok.dtype == torch.int32 and tok.tolist() == [[1], [0]]  # first of the ties
    np.testing.assert_array_equal(np.asarray(jserve.greedy_sample(jnp.asarray(logits.numpy()))),
                                  tok.numpy())
    gen = torch.Generator().manual_seed(0)
    peaked = torch.full((3, 1, 10), -1e4)
    peaked[:, 0, 7] = 0.0
    drawn = tserve.temperature_sample(peaked, gen)
    assert drawn.dtype == torch.int32 and drawn.tolist() == [[7]] * 3
