"""The port's training path on the CPU against the JAX reference:
``cross_entropy``, ``loss_fn`` and its gradients, the optimizer (``lr_at``,
int8 moments, ``apply_updates``), ``make_train_step`` with microbatches, and
the training loop's kill/resume drill.  Both packages start from the same numpy
parameters (the reference's, loaded unrounded as master weights by
``interop.params_from_numpy(..., master=True)``) and the same batches.

Tolerances, each with its reason:

- ``LOSS_TOL`` 1e-5: float32 losses through a few layers, sums in another
  order.
- ``F32_GRAD_TOL`` 1e-4 (absolute, scaled by the leaf's largest gradient,
  plus relative): gradients of leaves the reference keeps in float32
  (norm scales).
- bfloat16-rounded gradients (every matrix weight: the transpose of the
  in-graph cast rounds them, in both packages): a float32 gradient a few
  ulps off can round to the neighbouring bfloat16 value, one bfloat16 ulp
  (<= 2^-7 relative) away.  So each element is within ``BF16_ULP`` relative
  (plus ``F32_GRAD_TOL`` of the leaf's scale) and at least 99% of the
  elements are bit-equal.
- parameters after AdamW steps: where |g| is tiny the step-1 update
  m_hat / sqrt(v_hat) is +-1, so one flipped sign moves a weight by 2 lr.
  Each weight is within 2 lr x steps, and at least 99.9% within 2 bfloat16
  ulps of lr per step (a gradient on its neighbouring bfloat16 value); the
  first moments likewise within 2 bfloat16 ulps.  (The reference's jitted
  step differs from its own ``value_and_grad`` by more at one microbatch
  than at two: its gradient norm moves by 2e-6 relative.)  The optimizer
  alone, from identical gradients, holds ``F32_PARAM_TOL`` 1e-6.
- ``lr_at``: 1e-6 relative (float32 schedule arithmetic; cos in two libms).
- int8 quantization: bit-exact; ``apply_updates`` float32 moments 1e-6
  relative plus 1e-6 of the leaf's largest (beta m + (1 - beta) g can
  cancel), int8 ``q`` within one level where the float32 moment sits on a
  rounding edge.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist import checkpoint as jckpt
from repro.launch import train as jtrain
from repro.models import api as japi
from repro.models import layers as JL
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import configs as tconfigs, interop
from repro_torch.dist import checkpoint as tckpt
from repro_torch.dist.object_store import S3Store
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models import layers as TL
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

LOSS_TOL = 1e-5
F32_GRAD_TOL = 1e-4
BF16_ULP = 2.0**-7
F32_PARAM_TOL = 1e-6
LR_TOL = 1e-6

MATRIX = ("wq", "wk", "wv", "wo_att", "wi", "wo", "lm_head")

CASES = {
    "minicpm-2b": ("minicpm-2b", dict(num_layers=2)),
    "gemma3-4b": ("gemma3-4b", dict(num_layers=6)),  # 5 local (window 32) + 1 global, qk-norm, GQA
    "minicpm-2b-untied": ("minicpm-2b", dict(num_layers=2, tie_embeddings=False)),
}


def _cfgs(case, **over):
    arch, kw = CASES[case]
    kw = dict(kw, **over)
    return jconfigs.get(arch).reduced(**kw), tconfigs.get(arch).reduced(**kw)


def _np_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, japi.init_params(jcfg, jax.random.PRNGKey(seed)))


def _batch(cfg, b, t, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    mask = (rng.uniform(size=(b, t)) > 0.2).astype(np.float32)
    return {"tokens": tokens, "mask": mask}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _close_bf16(got, exp, name, tied=False):
    """A tied embedding's gradient is the float32 sum of two bfloat16-rounded
    terms (the lookup's and the head's), each of which can flip by one ulp of
    its own size, which cancellation can make large against the sum: there
    the bound is one bfloat16 ulp of the leaf's largest gradient."""
    scale = max(float(np.abs(exp).max()), 1e-30)
    err = np.abs(got - exp)
    bound = BF16_ULP * scale if tied else BF16_ULP * np.abs(exp) + F32_GRAD_TOL * scale
    assert (err <= bound).all(), (name, float(err.max()))
    assert np.mean(got == exp) >= 0.99, (name, float(np.mean(got == exp)))


def _close_f32(got, exp, name):
    scale = max(float(np.abs(exp).max()), 1e-30)
    np.testing.assert_allclose(got, exp, atol=F32_GRAD_TOL * scale, rtol=F32_GRAD_TOL,
                               err_msg=name)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches(masked):
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(3, 17, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 17)).astype(np.int32)
    mask = (rng.uniform(size=(3, 17)) > 0.3).astype(np.float32) if masked else None
    exp = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                           None if mask is None else jnp.asarray(mask))
    got = TL.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(exp), rtol=LOSS_TOL)


def _jax_loss_and_grads(jcfg, params, batch):
    fn = jax.jit(jax.value_and_grad(lambda p, b: japi.loss_fn(jcfg, p, b), has_aux=True))
    (loss, metrics), grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in metrics.items()}, _flat(grads)


def _port_loss_and_grads(tcfg, np_params, batch):
    params = interop.params_from_numpy(tcfg, np_params, "cpu", master=True)
    leaves = {k: v for k, v in _flat_t(params).items()}
    for t in leaves.values():
        t.requires_grad_()
    loss, metrics = tapi.loss_fn(tcfg, params, _tbatch(batch))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return (float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()},
            {k: g.numpy() for k, g in zip(leaves, grads)})


def _flat_t(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_t(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_fn_and_grads_match(case):
    """loss_fn's value and the gradient of every leaf, against
    jax.value_and_grad(repro.models.api.loss_fn)."""
    jcfg, tcfg = _cfgs(case)
    np_params = _np_params(jcfg)
    batch = _batch(jcfg, 2, 48)
    jl, jm, jg = _jax_loss_and_grads(jcfg, np_params, batch)
    tl, tm, tg = _port_loss_and_grads(tcfg, np_params, batch)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_TOL)
    np.testing.assert_allclose(tm["ce"], jm["ce"], rtol=LOSS_TOL)
    assert tm["aux"] == jm["aux"] == 0.0
    assert sorted(tg) == sorted(jg)
    for name, exp in jg.items():
        leaf = name.rsplit("/", 1)[-1]
        if leaf in MATRIX or leaf == "embed":
            _close_bf16(tg[name], exp, name, tied=leaf == "embed" and tcfg.tie_embeddings)
        else:
            _close_f32(tg[name], exp, name)


def test_weight_grads_are_bf16_exact():
    """The transpose of the in-graph cast rounds every matrix weight's
    gradient to bfloat16, in the reference and in the port.  (The tied
    embedding's gradient is the float32 sum of two rounded terms.)"""
    jcfg, tcfg = _cfgs("minicpm-2b")
    np_params = _np_params(jcfg, seed=3)
    batch = _batch(jcfg, 2, 32, seed=3)
    _, _, jg = _jax_loss_and_grads(jcfg, np_params, batch)
    _, _, tg = _port_loss_and_grads(tcfg, np_params, batch)
    for grads in (jg, tg):
        for name, g in grads.items():
            if name.rsplit("/", 1)[-1] in MATRIX:
                assert np.array_equal(g, np.asarray(jnp.asarray(g).astype(jnp.bfloat16),
                                                    np.float32)), name
    # serving's pre-rounded weights give the same loss value
    served = interop.params_from_numpy(tcfg, np_params, "cpu")
    with torch.no_grad():
        loss_served, _ = tapi.loss_fn(tcfg, served, _tbatch(batch))
        loss_master, _ = tapi.loss_fn(tcfg, interop.params_from_numpy(
            tcfg, np_params, "cpu", master=True), _tbatch(batch))
    assert float(loss_served) == float(loss_master)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_lr_at_matches(schedule):
    cfg = dict(lr=3e-3, warmup_steps=7, total_steps=95, schedule=schedule)
    jc, tc = jopt.OptConfig(**cfg), topt.OptConfig(**cfg)
    for step in (0, 1, 3, 7, 8, 40, 84, 85, 86, 90, 95, 120):
        exp = float(jopt.lr_at(jnp.asarray(step, jnp.int32), jc))
        got = topt.lr_at(torch.tensor(step, dtype=torch.int32), tc)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), exp, rtol=LR_TOL, err_msg=f"step {step}")


def test_quantize_dequantize_bit_exact():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(3, 4, 512)) * 10.0 ** rng.integers(-8, 3, (3, 4, 1))).astype(np.float32)
    x[0, 0, :256] = 0.0  # an all-zero block: scale 0
    x[1, 1, 7] = 2.5 * np.abs(x[1, 1, :256]).max() / 127.0 * 127  # an exact half-way value
    jq = jopt._quantize(jnp.asarray(x))
    tq = topt._quantize(torch.from_numpy(x))
    assert tq["q"].dtype == torch.int8 and tq["scale"].dtype == torch.float32
    np.testing.assert_array_equal(tq["q"].numpy(), np.asarray(jq["q"]))
    np.testing.assert_array_equal(tq["scale"].numpy(), np.asarray(jq["scale"]))
    np.testing.assert_array_equal(topt._dequantize(tq, x.shape).numpy(),
                                  np.asarray(jopt._dequantize(jq, x.shape)))


def _opt_tree(rng):
    return {
        "big": rng.normal(size=(2, 64, 256)).astype(np.float32),    # chunked (threshold patched)
        "mat": rng.normal(size=(32, 256)).astype(np.float32),       # quantizable
        "vec": rng.normal(size=(256,)).astype(np.float32),          # small: stays float32
        "odd": rng.normal(size=(40, 100)).astype(np.float32),       # last dim not /256
    }


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_apply_updates_matches(state_dtype, monkeypatch):
    """Three AdamW steps from identical numpy grads.  The port's threshold
    for per-layer updates is lowered so that ``big`` takes that path (the
    reference's is fixed at 2^28 elements; the two paths compute the same)."""
    monkeypatch.setattr(topt, "_CHUNK_THRESHOLD", 1 << 12)
    rng = np.random.default_rng(4)
    params = _opt_tree(rng)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, schedule="wsd", state_dtype=state_dtype)
    jc, tc = jopt.OptConfig(**cfg), topt.OptConfig(**cfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init_state(jp, jc)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = topt.init_state(tp, tc)
    for step in range(3):
        grads = {k: (rng.normal(size=v.shape) * 0.1).astype(np.float32) for k, v in params.items()}
        jp, js = jopt.apply_updates(jp, {k: jnp.asarray(v) for k, v in grads.items()}, js, jc)
        tp, ts = topt.apply_updates(tp, {k: torch.from_numpy(v) for k, v in grads.items()}, ts, tc)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for k in params:
            if state_dtype == "float32":
                np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=F32_PARAM_TOL,
                                           rtol=F32_PARAM_TOL, err_msg=k)
            else:  # a moment one int8 level apart moves that weight's update
                _close_params({k: tp[k].numpy()}, {k: np.asarray(jp[k])}, cfg["lr"], step + 1)
            for mom in ("m", "v"):
                jm, tm = js[mom][k], ts[mom][k]
                if isinstance(jm, dict):
                    assert set(tm) == {"q", "scale"}
                    np.testing.assert_allclose(tm["scale"].numpy(), np.asarray(jm["scale"]),
                                               rtol=F32_PARAM_TOL)
                    dq = np.abs(tm["q"].numpy().astype(np.int32) - np.asarray(jm["q"], np.int32))
                    assert dq.max() <= 1 and np.mean(dq == 0) >= 0.999, (k, mom)
                else:  # beta m + (1 - beta) g can cancel: scale by the leaf's largest
                    jm = np.asarray(jm)
                    np.testing.assert_allclose(tm.numpy(), jm, rtol=F32_PARAM_TOL,
                                               atol=F32_PARAM_TOL * np.abs(jm).max(),
                                               err_msg=f"{mom}/{k}")
    assert isinstance(ts["m"]["mat"], dict) == (state_dtype == "int8")
    assert isinstance(ts["m"]["big"], dict) == (state_dtype == "int8")
    assert not isinstance(ts["m"]["vec"], dict) and not isinstance(ts["m"]["odd"], dict)
    np.testing.assert_allclose(float(topt.global_norm(tp)), float(jopt.global_norm(jp)),
                               rtol=F32_PARAM_TOL)
    assert topt.state_bytes(ts) == jopt.state_bytes(js)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def _close_params(got: dict, exp: dict, lr: float, steps: int):
    """Every weight within 2 lr per step (a flipped update sign); 99.9%
    within 2 bf16 ulps of lr per step (a gradient element on its neighbouring
    bfloat16 value moves m and v, and so the update, by ~2^-7 relative)."""
    for name, e in exp.items():
        err = np.abs(got[name] - e)
        assert err.max() <= 2 * lr * steps + F32_PARAM_TOL, (name, float(err.max()))
        assert np.mean(err <= steps * lr * 2 * BF16_ULP + F32_PARAM_TOL) >= 0.999, name


def _close_moments(got: dict, exp: dict):
    """First moments: an EMA of the clipped gradients, so every element
    within 2 bf16 ulps of the leaf's largest, and 99% within 2 ulps of its
    own (the rest are near zero, where steps of opposite sign cancel)."""
    for name, e in exp.items():
        err = np.abs(got[name] - e)
        scale = max(float(np.abs(e).max()), 1e-30)
        assert err.max() <= 2 * BF16_ULP * scale, (name, float(err.max()))
        assert np.mean(err <= 2 * BF16_ULP * np.abs(e) + F32_PARAM_TOL * scale) >= 0.99, name


@pytest.mark.parametrize("microbatches", [1, 2])
def test_make_train_step_matches(microbatches):
    jcfg, tcfg = _cfgs("minicpm-2b")
    np_params = _np_params(jcfg, seed=5)
    oc = dict(lr=1e-3, warmup_steps=2, total_steps=20, schedule="wsd")
    jstep = jax.jit(jts.make_train_step(jcfg, jopt.OptConfig(**oc), microbatches=microbatches))
    tstep = tts.make_train_step(tcfg, topt.OptConfig(**oc), microbatches=microbatches)
    jp = jax.tree.map(jnp.asarray, np_params)
    js = jopt.init_state(jp, jopt.OptConfig(**oc))
    tp = interop.params_from_numpy(tcfg, np_params, "cpu", master=True)
    ts = topt.init_state(tp, topt.OptConfig(**oc))
    steps = 3
    for i in range(steps):
        batch = _batch(jcfg, 4, 32, seed=10 + i)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
        tp, ts, tm = tstep(tp, ts, _tbatch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_TOL)
        np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=LOSS_TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    _close_params(_flat(interop.params_to_numpy(tp)), _flat(jp), oc["lr"], steps)
    got_state = interop.opt_state_to_numpy(ts)
    assert int(got_state["step"]) == steps
    _close_moments(_flat(got_state["m"]), _flat(js["m"]))


def test_eval_step_matches_loss_fn():
    jcfg, tcfg = _cfgs("minicpm-2b")
    np_params = _np_params(jcfg, seed=6)
    batch = _batch(jcfg, 2, 32, seed=6)
    exp = jts.make_eval_step(jcfg)(jax.tree.map(jnp.asarray, np_params),
                                   {k: jnp.asarray(v) for k, v in batch.items()})
    got = tts.make_eval_step(tcfg)(interop.params_from_numpy(tcfg, np_params, "cpu", master=True),
                                   _tbatch(batch))
    assert set(got) == set(exp)
    np.testing.assert_allclose(float(got["loss"]), float(exp["loss"]), rtol=LOSS_TOL)
    with pytest.raises(NotImplementedError, match="A 5"):
        tts.make_compressed_dp_train_step(tcfg, topt.OptConfig(), None)


def test_opt_state_interop_round_trip():
    jcfg, tcfg = _cfgs("minicpm-2b")
    jc = jopt.OptConfig(state_dtype="int8")
    js = jax.tree.map(np.asarray, jopt.init_state(japi.init_params(jcfg, jax.random.PRNGKey(0)),
                                                  jc))
    ts = interop.opt_state_from_numpy(js, "cpu")
    assert ts["m"]["blocks"]["wi"]["q"].dtype == torch.int8 and ts["step"].dtype == torch.int32
    back = interop.opt_state_to_numpy(ts)
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the training loop: kill / resume (mirrors tests/test_integration.py::TestTrainLoop)
# ---------------------------------------------------------------------------

def _small():
    return tconfigs.get("minicpm-2b").reduced(num_layers=2, d_model=64, d_ff=128)


KW = dict(batch=2, seq_len=32, ckpt_every=10, log=lambda *a: None, device="cpu")


def test_loss_decreases_and_resumes(tmp_path):
    cfg = _small()
    _, losses = ttrain.train(cfg, steps=30, ckpt_dir=tmp_path, **KW)
    assert losses[-1] < losses[0]
    _, losses2 = ttrain.train(cfg, steps=40, ckpt_dir=tmp_path, resume=True, **KW)
    assert len(losses2) == 10  # only the remaining steps ran


@pytest.mark.parametrize("backend", ["local", "s3"])
def test_elastic_restart_trace_continuity(tmp_path, backend):
    """Kill/resume equals one uninterrupted run, bit for bit on the CPU:
    train 20 steps straight, then 10 + drop every in-process object +
    resume from ckpt.latest."""
    cfg = _small()
    _, ref = ttrain.train(cfg, steps=20, ckpt_dir=tmp_path / "ref", **KW)
    target = tmp_path / "elastic" if backend == "local" else S3Store()
    _, first = ttrain.train(cfg, steps=20, stop_after=10, ckpt_dir=target, **KW)
    latest = tckpt.latest(target)
    assert latest is not None and latest.name == "step_00000010"
    assert tckpt.read_manifest(latest)["step"] == 10
    if backend == "s3":
        assert target.op_time_s > 0 and target.puts > 0  # priced PUT traffic
    _, rest = ttrain.train(cfg, steps=20, ckpt_dir=target, resume=True, **KW)
    assert len(first) == 10 and len(rest) == 10
    assert first + rest == ref


def test_wsd_schedule_arch():
    cfg = _small()
    assert cfg.schedule == "wsd"
    _, losses = ttrain.train(cfg, steps=12, batch=2, seq_len=16, log=lambda *a: None,
                             device="cpu")
    assert np.isfinite(losses).all()


def test_train_checkpoint_restores_in_the_reference(tmp_path):
    """The port's training-loop checkpoint (params + int8-free optimizer state)
    restores into the reference's tree of the same config, and the
    reference's resume continues from its step."""
    cfg = _small()
    jcfg = jconfigs.get("minicpm-2b").reduced(num_layers=2, d_model=64, d_ff=128)
    params, _ = ttrain.train(cfg, steps=3, ckpt_dir=tmp_path, **KW)
    latest = jckpt.latest(tmp_path)
    assert latest.name == "step_00000003"
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    like = {"params": jp, "opt": jopt.init_state(jp, jopt.OptConfig())}
    tree = jckpt.restore(latest, like)
    np.testing.assert_array_equal(np.asarray(tree["params"]["embed"]),
                                  params["embed"].numpy())
    assert int(tree["opt"]["step"]) == 3
    _, losses = jtrain.train(jcfg, steps=5, batch=2, seq_len=32, ckpt_dir=tmp_path,
                             ckpt_every=10, resume=True, log=lambda *a: None)
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_train_refuses_what_is_not_ported():
    cfg = _small()
    with pytest.raises(NotImplementedError, match="A 5"):
        ttrain.train(dataclasses.replace(cfg, grad_compression=True), steps=1, **KW)


# ---------------------------------------------------------------------------
# the modeled session and the span Tracer in the driver (mirrors
# tests/test_session.py::test_train_resume_rebootstraps and
# tests/test_providers.py::test_kill_resume_during_burst_identical_traces)
# ---------------------------------------------------------------------------

MEASURED = ("train_step", "data_fetch")  # compute / overhead spans: host time


def _gen_masked(key):
    parts = key.split("/")
    if len(parts) == 3 and len(parts[1]) == 8:
        parts[1] = "<gen>"
    return "/".join(parts)


def _span_rows(tracer):
    """Spans by lane, name, bytes, usd and metadata, with the modeled
    interval; spans that carry measured host time by count only, and the
    modeled spans on their lanes (the detector's, on ``overhead``) by
    duration, since they start after measured ones."""
    rows = []
    for sp in tracer.spans:
        meta = {k: (_gen_masked(v) if k == "key" else v) for k, v in sp.meta}
        if sp.kind in MEASURED:
            interval = None
        elif sp.lane in ("compute", "overhead"):
            interval = sp.duration_s
        else:
            interval = (sp.t0, sp.t1)
        rows.append((sp.rank, sp.lane, sp.kind, sp.nbytes, sp.usd, interval, meta))
    return rows


def _driver_run(mod, cfg, sess_mod, trace_mod, store, policy, **kw):
    """Kill at step 5, resume to 8; the logs and spans of both calls, with a
    local store's root (it differs between the packages' runs) masked."""
    logs, traces = [], []
    common = dict(steps=8, batch=2, seq_len=32, ckpt_every=3, burst_at=2, burst_world=4,
                  burst_provider="gcp-cloudrun", shrink_at=6, shrink_world=3,
                  recovery_policy=policy, log=logs.append, **kw)
    for extra in (dict(stop_after=5), dict(resume=True)):
        tr = trace_mod.Tracer()
        mod.train(cfg, ckpt_dir=store, comm_session=sess_mod.CommSession.bootstrap(16, "lambda"),
                  tracer=tr, **common, **extra)
        traces.append([row[:6] + ({k: "<root>" if v == str(store) else v
                                    for k, v in row[6].items()},) for row in _span_rows(tr)])
    # step lines carry losses of each package's own weights and host times;
    # the trace summary line carries measured lanes
    kept = [line for line in logs if not line.startswith(("step ", "trace:"))]
    return kept, traces


@pytest.mark.parametrize("policy,backend", [("incremental", "s3"), ("cold", "local")])
def test_driver_session_and_tracer_match_reference(tmp_path, policy, backend):
    """A run with a modeled 16-worker session, a burst, a shrink, a kill and a
    resume under a Tracer logs the reference's lines (re-bootstrap, burst,
    shrink) and lays the same spans by lane, name and modeled duration."""
    from repro.core import session as jsess, trace as jtrace
    from repro.dist import object_store as jobs
    from repro_torch.core import session as tsess, trace as ttrace

    jcfg, tcfg = _cfgs("minicpm-2b", d_model=64, d_ff=128)
    stores = ((jobs.S3Store(), S3Store()) if backend == "s3"
              else (tmp_path / "j", tmp_path / "t"))
    exp = _driver_run(jtrain, jcfg, jsess, jtrace, stores[0], policy)
    got = _driver_run(ttrain, tcfg, tsess, ttrace, stores[1], policy, device="cpu")
    assert got == exp
    logs = got[0]
    assert [line.split(":")[0] for line in logs] == \
        ["burst", "resumed from step 5", "re-bootstrap", "burst", "shrink"]
    lanes = {row[1] for row in got[1][0] + got[1][1]}
    assert lanes == {"compute", "comm", "store", "bootstrap", "overhead"}


def test_driver_cli_flags_match_reference(tmp_path, monkeypatch, capsys):
    """The reference's CLI flags with their defaults, choices and help; then
    a kill + ``--resume --trace-out`` run of the port's CLI on the CPU."""
    import argparse
    import sys

    class Parsed(Exception):
        pass

    def flags(main):
        seen = {}

        def grab(parser, *a, **k):
            seen.update({a.dest: (tuple(a.option_strings), a.default, a.choices, a.help)
                         for a in parser._actions})
            raise Parsed

        monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(Parsed):
            main()
        monkeypatch.undo()
        return seen

    jflags, tflags = flags(jtrain.main), flags(ttrain.main)
    session_flags = ("comm_world", "comm_fabric", "burst_at", "burst_world", "burst_provider",
                     "shrink_at", "shrink_world", "recovery_policy", "trace_out")
    for dest in session_flags:
        assert tflags[dest] == jflags[dest], dest
    assert set(jflags) - set(tflags) == set()
    argv = ["train", "--device", "cpu", "--steps", "3", "--batch", "2", "--seq-len", "16",
            "--ckpt-dir", str(tmp_path / "ck"), "--comm-world", "8"]
    monkeypatch.setattr(sys, "argv", argv + ["--stop-after", "2"])
    ttrain.main()
    out = tmp_path / "t.json"
    monkeypatch.setattr(sys, "argv", argv + ["--resume", "--trace-out", str(out)])
    ttrain.main()
    text = capsys.readouterr().out
    assert "re-bootstrap: rank 0 re-joined its CommSession (world 8) in 18.9s" in text
    assert f"trace written to {out}" in text
    from repro.core.trace import Tracer as JTracer
    assert {sp.lane for sp in JTracer.from_json(json.loads(out.read_text())).spans} >= \
        {"compute", "comm", "bootstrap"}
