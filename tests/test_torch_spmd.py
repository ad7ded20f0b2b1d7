"""The port's SPMD surface on the CPU against the JAX reference's.

The reference runs once per module in a subprocess with eight host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
``tests/test_spmd.py::run_spmd`` does), under ``shard_map`` over named mesh
axes; the port runs as gloo process groups of 4 ranks (and 8 for the
expert-parallel MoE on a (2, 4) mesh), each rank a process of
``tests/_torch_spmd_ranks.py`` with its own ``FileStore`` under the test's
temporary directory (no fixed port: tier-1 runs files in parallel).  Both
sides read the same inputs, made here with numpy from fixed seeds, and
every process group and process has a time limit, so a hang fails these
tests instead of the suite.

Tolerances, each with its reason:

- data movement (gathers, all-to-alls, broadcasts, permutes, staging, the
  dataframe shuffles, joins and groupbys, the int8 payloads): ``==``;
- float32 reductions over 4 ranks: 1e-6 (gloo's ring sums in another order
  than XLA's);
- ``compressed_pmean``: the reference's int8 values and scales are ``==``
  (same quantizer), the means and residuals 1e-6 (the mean over ranks in
  another order; XLA fuses the residual's product and subtraction);
- attention_sharded: the forward 2e-5 and the gradients 1e-4, the
  attention kernels' own limits (FLASH_TOL, BWD_TOL);
- the dense model's logits 1e-4 and loss 1e-5 (float32 through 4 layers,
  sums in another order; ``tests/test_torch_models.py``'s limits);
- the dp train step: loss 1e-5 relative; parameters within 2 lr of the
  reference's single-device step (a flipped AdamW update sign where |g| is
  tiny, ``tests/test_torch_train.py``) and 99% within 2 bf16 ulps of lr
  (that file holds 99.9% between two single-device steps; here each
  weight gradient is the mean of 4 ranks' bf16-rounded gradients, the
  in-graph cast's transpose rounding each, not the rounded total: 0.114%
  of gemma3's tied embedding moves further);
- the compressed dp step: the reference's own test bounds
  (``tests/test_spmd.py::TestCompressedDPStep``): losses within 2% of the
  implicit step's, parameters within 2 x 3 x lr after three steps, the
  residual alive and below 1;
- the expert-parallel MoE against the port's local dispatch: 2e-4, the
  reference test's limit, for the outputs and for the gradients of x, the
  router, wi and wo (the experts' bucket rows sum in another order);
- each collective's backward against its definition: 1e-6 (float32 sums
  over 4 ranks in another order);
- make_train_step with the experts over an ep axis against the same step
  without: the loss 1e-5 relative, the gradient norm 1e-4, and every
  parameter within 2 lr, 99.9% within 2 bf16 ulps of lr (the first AdamW
  step moves a weight by +-lr whatever its gradient's size, so only a
  flipped sign where |g| is tiny, or a bf16-rounded weight gradient on its
  neighbouring value, moves it further).
"""

import datetime
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _torch_spmd_ranks as ranks_
from _torch_spmd_ranks import ATTENTION, EXACT, OPT, REPO, SUMS
from repro_torch.dist import compression as tcomp

BF16_ULP = 2.0**-7
ATTN_PLAN = {"head_tp2": "head", "head_tp4_window": "head", "seq_tp2": "seq",
             "seq_tp4_window": "seq"}

REFERENCE = r'''
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro import configs
from repro.core.backends import direct, mediated
from repro.dataframe import Table, ops_dist
from repro.dist import compression
from repro.models import api, layers as JL, moe as JM
from repro.models.transformer import DistContext
from repro.train import optimizer as jopt, train_step as jts

inp = pickle.load(open(sys.argv[1], "rb"))
devs = np.array(jax.devices())
mesh4 = Mesh(devs[:4], ("data",))
mesh22 = Mesh(devs[:4].reshape(2, 2), ("data", "model"))
out = {}

def per_shard(fn, *arrs, mesh=mesh4, spec=P("data")):
    def body(*xs):
        res = fn(*[x[0] for x in xs])
        return jax.tree.map(lambda y: jnp.asarray(y)[None], res)
    f = jax.shard_map(body, mesh=mesh, in_specs=(spec,) * len(arrs), out_specs=spec,
                      check_vma=False)
    return jax.tree.map(np.asarray, jax.jit(f)(*[jnp.asarray(a) for a in arrs]))

def coll(x, counts, payload, st, g, e0, *decs):
    r = {
        "axis_index": direct.axis_index("data"), "axis_size": jnp.int32(direct.axis_size("data")),
        "barrier": direct.barrier("data"),
        "allreduce": direct.allreduce(x, "data"), "allreduce_mean": direct.allreduce_mean(x, "data"),
        "allreduce_max": direct.allreduce_max(x, "data"),
        "allreduce_max_int32": direct.allreduce_max(x.astype(jnp.int32), "data"),
        "reduce_scatter_dim0": direct.reduce_scatter(x, "data", dim=0),
        "reduce_scatter_dim1": direct.reduce_scatter(x, "data", dim=1),
        "allgather_dim0": direct.allgather(x, "data", dim=0),
        "allgather_dim1": direct.allgather(x, "data", dim=1),
        "bcast_root2": direct.bcast(x, "data", root=2),
        "ppermute": direct.ppermute(x, "data", [(0, 2), (1, 0), (2, 1)]),
        "ring_shift1": direct.send_recv_ring(x, "data", shift=1),
        "ring_shift3": direct.send_recv_ring(x, "data", shift=3),
        "alltoallv_counts": direct.alltoallv_counts(counts, "data"),
        "staged_all_to_all": mediated.staged_all_to_all(st, "data"),
        "staged_allreduce": mediated.staged_allreduce(st, "data"),
    }
    for s_, c_ in ((0, 0), (0, 1), (1, 0), (1, 1)):
        r[f"alltoall_{s_}{c_}"] = direct.alltoall(x, "data", split_dim=s_, concat_dim=c_)
    r["alltoallv_payload"], r["alltoallv_recv_counts"] = direct.alltoallv(payload, counts, "data")
    for chunks in (2, 4):
        r[f"staged_all_to_all_chunked{chunks}"] = mediated.staged_all_to_all_chunked(
            st, "data", chunks=chunks)
    for name, d in zip(("64", "3x5", "13"), decs):
        r[f"allreduce_decomposed_{name}"] = direct.allreduce_decomposed(d, "data")
        r[f"allreduce_decomposed_mean_{name}"] = direct.allreduce_decomposed(d, "data", mean=True)
    r["compressed_pmean"], r["compressed_pmean_err"] = compression.compressed_pmean(g, "data")
    r["compressed_pmean_ef"], r["compressed_pmean_ef_err"] = compression.compressed_pmean(
        g, "data", e0)
    return r

out["collectives"] = per_shard(coll, inp["x"], inp["counts"], inp["payload"], inp["staged"],
                               inp["grad"], inp["grad_err"], inp["dec_64"], inp["dec_3x5"],
                               inp["dec_13"])
both = ("data", "model")
out["collectives"].update(per_shard(
    lambda x: {"two_axes_index": jax.lax.axis_index(both),
               "two_axes_allreduce": direct.allreduce(x, both),
               "two_axes_alltoall": direct.alltoall(x, both),
               "model_axis_allgather": direct.allgather(x, "model", dim=0)},
    inp["x"], mesh=mesh22, spec=P(both)))

# the dataframe operators
df = inp["df"]
def tables(lk, lv, lc, rk, rw, rc, gg, ga, gs, gc):
    return (Table({"k": lk, "v": lv}, lc), Table({"k": rk, "w": rw}, rc),
            Table({"g": gg, "amount": ga, "score": gs}, gc))
def as_tree(t):
    return {"columns": dict(t.columns), "count": t.count}
def dfs(*a):
    left, right, grp = tables(*a)
    r = {}
    for compress in (False, True):
        tag = "compressed" if compress else "raw"
        r[f"shuffle_{tag}"] = as_tree(ops_dist.shuffle_spmd(left, "k", "data", compress=compress))
        r[f"join_{tag}"] = as_tree(ops_dist.join_spmd(left, right, "k", "data", compress=compress))
        for combine in (True, False):
            r[f"groupby_{tag}_combine{combine}"] = as_tree(ops_dist.groupby_spmd(
                grp, "g", {"amount": "sum", "score": "max"}, "data", combine=combine,
                compress=compress))
    return r
cols = [df["left"]["columns"]["k"], df["left"]["columns"]["v"], df["left"]["count"],
        df["right"]["columns"]["k"], df["right"]["columns"]["w"], df["right"]["count"],
        df["group"]["columns"]["g"], df["group"]["columns"]["amount"],
        df["group"]["columns"]["score"], df["group"]["count"]]
out["dataframe"] = per_shard(dfs, *cols)

# attention_sharded: forward and gradients
out["attention"] = {}
for case, spec in inp["attention"].items():
    dp, tp = spec["mesh"]
    mesh = Mesh(devs[:dp * tp].reshape(dp, tp), ("data", "model"))
    ctx = DistContext(mesh=mesh, dp_axes=("data",), tp_axis="model")
    do = jnp.asarray(spec["do"])
    def f(q, k, v):
        o = JL.attention_sharded(q, k, v, ctx, causal=True, window=spec["window"])
        return jnp.sum(o * do), o
    (_, o), g = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(spec[n]) for n in "qkv"))
    out["attention"][case] = {"o": np.asarray(o), "dq": np.asarray(g[0]),
                              "dk": np.asarray(g[1]), "dv": np.asarray(g[2])}

# the dense model: forward and loss under a (2, 2) context, the train steps
cfg = configs.get("gemma3-4b").reduced(**inp["cfg_over"])
params = jax.tree.map(jnp.asarray, inp["params"])
batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
ctx22 = DistContext(mesh=mesh22, dp_axes=("data",), tp_axis="model")
logits, _ = jax.jit(lambda p, b: api.logits_fn(cfg, p, b, ctx=ctx22))(params, batch)
loss, metrics = jax.jit(lambda p, b: api.loss_fn(cfg, p, b, ctx=ctx22))(params, batch)
dense = {"logits": np.asarray(logits), "loss": float(loss), "ce": float(metrics["ce"])}
oc = jopt.OptConfig(**inp["opt"], state_dtype=cfg.opt_state_dtype)
step = jax.jit(jts.make_train_step(cfg, oc))
p, s, m = step(params, jopt.init_state(params, oc), batch)
dense["step"] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                 "params": jax.tree.map(np.asarray, p)}
losses = []
p, s = params, jopt.init_state(params, oc)
for _ in range(3):
    p, s, m = step(p, s, batch)
    losses.append(float(m["loss"]))
dense["implicit3"] = {"losses": losses, "params": jax.tree.map(np.asarray, p)}
ccfg = dataclasses.replace(cfg, grad_compression=True)
cstep, init_err = jts.make_compressed_dp_train_step(ccfg, oc, mesh4)
p, s, err = params, jopt.init_state(params, oc), init_err(params)
losses = []
for _ in range(3):
    p, s, err, m = cstep(p, s, err, batch)
    losses.append(float(m["loss"]))
dense["compressed3"] = {"losses": losses}
out["dense"] = dense
pickle.dump(out, open(sys.argv[2], "wb"))
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the reference subprocess and both gloo jobs together; wait for
    all three; return (reference, [main rank results], [moe rank results],
    inputs)."""
    tmp = tmp_path_factory.mktemp("spmd")
    inp = ranks_.make_inputs()
    inputs = tmp / "inputs.pkl"
    inputs.write_bytes(pickle.dumps(inp))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(REFERENCE), str(inputs),
                            str(tmp / "reference.pkl")], env=env, cwd=REPO,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    main = ranks_.launch("main", 4, tmp, inputs)
    moe = ranks_.launch("moe", 8, tmp, inputs)
    try:
        ranks_.wait(main, "the world-4 gloo job")
        ranks_.wait(moe, "the world-8 gloo job")
        ranks_.wait([ref], "the reference's subprocess")
    except RuntimeError as e:
        for p in main + moe + [ref]:
            p.kill()
        pytest.fail(str(e))
    return (pickle.loads((tmp / "reference.pkl").read_bytes()), ranks_.load(tmp, "main", 4),
            ranks_.load(tmp, "moe", 8), inp)


# -- collectives -------------------------------------------------------------------

@pytest.mark.parametrize("name", EXACT)
def test_collective_moves_the_references_data(runs, name):
    ref, ranks, _, _ = runs
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(np.asarray(res["collectives"][name]),
                                      ref["collectives"][name][r], err_msg=f"rank {r}")


@pytest.mark.parametrize("name", SUMS)
def test_collective_sums_match_reference(runs, name):
    ref, ranks, _, _ = runs
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["collectives"][name], ref["collectives"][name][r],
                                   atol=1e-6, rtol=1e-6, err_msg=f"rank {r}")


def test_collectives_against_numpy(runs):
    """The port's results against numpy on the stacked inputs."""
    _, ranks, _, inp = runs
    x = inp["x"]
    for r, res in enumerate(ranks):
        c = res["collectives"]
        np.testing.assert_allclose(c["allreduce"], x.sum(0), atol=1e-5)
        np.testing.assert_array_equal(c["allgather_dim1"], np.concatenate(list(x), axis=1))
        np.testing.assert_array_equal(c["alltoall_00"],
                                      np.concatenate([x[s][2 * r:2 * r + 2] for s in range(4)]))
        np.testing.assert_array_equal(c["bcast_root2"], x[2])
        np.testing.assert_array_equal(c["ring_shift1"], x[(r - 1) % 4])
        np.testing.assert_array_equal(c["ppermute"], {0: x[1], 1: x[2], 2: x[0]}.get(
            r, np.zeros_like(x[0])))
        np.testing.assert_allclose(c["reduce_scatter_dim1"], x.sum(0)[:, 3 * r:3 * r + 3],
                                   atol=1e-5)
        np.testing.assert_array_equal(c["alltoallv_recv_counts"], inp["counts"][:, r])
        for n in ("64", "3x5", "13"):
            np.testing.assert_allclose(c[f"allreduce_decomposed_mean_{n}"],
                                       inp[f"dec_{n}"].mean(0), atol=1e-6)
        np.testing.assert_array_equal(c["staged_all_to_all"], inp["staged"][:, r])
        assert int(c["two_axes_index"]) == r


# -- compression ---------------------------------------------------------------------


@pytest.mark.parametrize("name", ["compressed_pmean", "compressed_pmean_ef"])
def test_compressed_pmean_matches_reference(runs, name):
    """The mean is the same on every rank and the reference's within 1e-6;
    the local residual the reference's within 1e-6 (compensated - q x scale:
    XLA fuses the product into the subtraction); and within the reference
    test's bounds of the exact mean.  (The int8 values and scales are ``==``:
    test_quantize_blocks_equal_reference.)"""
    ref, ranks, _, inp = runs
    means = [res["collectives"][name] for res in ranks]
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(means[r], means[0])
        np.testing.assert_allclose(means[r], ref["collectives"][name][r], atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(res["collectives"][name + "_err"],
                                   ref["collectives"][name + "_err"][r], atol=1e-6, rtol=0)
    comp = inp["grad"] + (inp["grad_err"] if name.endswith("_ef") else 0)
    exact = comp.mean(0)
    assert np.abs(means[0] - exact).max() <= 0.03 * np.abs(exact).max()
    errs = np.stack([res["collectives"][name + "_err"] for res in ranks])
    assert np.abs(errs).max() <= np.abs(comp).max() / 127.0 * 1.01


@pytest.mark.parametrize("shape", [(4096,), (3, 128), (2, 7, 128), (64, 1024)])
def test_quantize_blocks_equal_reference(shape):
    """Against the reference's quantizer as it runs, under ``jit``."""
    import jax
    import jax.numpy as jnp

    from repro.dist import compression as jcomp

    rng = np.random.default_rng(len(shape))
    x = (rng.normal(size=shape) * rng.uniform(0.01, 100, size=shape[-1])).astype(np.float32)
    x.reshape(-1)[:128] = 0.0                    # an all-zero block: scale 0
    jq, js = jax.jit(jcomp._quantize_blocks)(jnp.asarray(x))
    tq, tsc = tcomp._quantize_blocks(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tcomp._dequantize_blocks(tq, tsc).numpy(),
                                  np.asarray(jax.jit(jcomp._dequantize_blocks)(jq, js)))


@pytest.mark.parametrize("shape", [(4, 64), (4, 33, 3), (2, 1000), (8, 5, 2, 3), (4, 3000)])
def test_quantize_slots_equal_reference(shape):
    """Against the reference's quantizer as it runs, under ``jit``."""
    import jax
    import jax.numpy as jnp

    from repro.dist import compression as jcomp

    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(size=shape) * 10).astype(np.float32)
    jq, js = jax.jit(jcomp.quantize_slots)(jnp.asarray(x))
    tq, tsc = tcomp.quantize_slots(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(js))
    back = tcomp.dequantize_slots(tq, tsc, shape, torch.float32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jax.jit(lambda a, b: jcomp.dequantize_slots(a, b, shape, jnp.float32))(jq, js)))


def test_wire_bytes_saved_matches_reference():
    import jax.numpy as jnp

    from repro.dist import compression as jcomp

    tree = {"a": np.zeros((300, 7), np.float32), "b": {"c": np.zeros(129, np.float32)}}
    assert tcomp.wire_bytes_saved({"a": torch.zeros(300, 7), "b": {"c": torch.zeros(129)}}) == \
        jcomp.wire_bytes_saved({k: v if isinstance(v, dict) else jnp.asarray(v)
                                for k, v in tree.items()})


# -- the dataframe operators ----------------------------------------------------------

DF_RUNS = [f"{op}_{tag}" for tag in ("raw", "compressed") for op in ("shuffle", "join")] + \
    [f"groupby_{tag}_combine{c}" for tag in ("raw", "compressed") for c in (True, False)]


@pytest.mark.parametrize("run", DF_RUNS)
def test_spmd_dataframe_rows_equal_reference(runs, run):
    """Each rank's Table (every padded column and the count) bit-equal to the
    reference's shard of the same rank."""
    ref, ranks, _, _ = runs
    exp = ref["dataframe"][run]
    for r, res in enumerate(ranks):
        cols, count = res["dataframe"][run]
        assert count == int(exp["count"][r]), r
        assert sorted(cols) == sorted(exp["columns"])
        for k, v in exp["columns"].items():
            np.testing.assert_array_equal(cols[k], v[r], err_msg=f"rank {r} {k}")


def test_spmd_join_is_the_numpy_join(runs):
    _, ranks, _, inp = runs
    left, right = inp["df"]["left"], inp["df"]["right"]
    lk = np.concatenate([left["columns"]["k"][r, :64] for r in range(4)])
    rk = np.concatenate([right["columns"]["k"][r, :32] for r in range(4)])
    got = np.concatenate([cols["k"][:count]
                          for cols, count in (res["dataframe"]["join_raw"] for res in ranks)])
    assert sorted(got.tolist()) == sorted(set(lk.tolist()) & set(rk.tolist()))


# -- attention_sharded ------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(ATTENTION))
def test_attention_sharded_matches_reference(runs, case):
    """Each rank's output and gradients (its dp shard of the batch; the tp
    ranks alike) against the reference's global ones: 2e-5 and 1e-4."""
    ref, ranks, _, _ = runs
    (dp, tp), b = ATTENTION[case][0], ATTENTION[case][1]
    exp = ref["attention"][case]
    for r, res in enumerate(ranks):
        got = res["attention"][case]
        assert got["plan"] == ATTN_PLAN[case]
        d = r // tp
        rows = slice(d * b // dp, (d + 1) * b // dp)
        np.testing.assert_allclose(got["o"], exp["o"][rows], atol=2e-5, rtol=2e-5)
        for name in ("dq", "dk", "dv"):
            np.testing.assert_allclose(got[name], exp[name][rows], atol=1e-4, rtol=1e-4,
                                       err_msg=f"rank {r} {name}")


# -- the dense model and the data-parallel steps ------------------------------------


def test_dense_forward_and_loss_under_a_2x2_context(runs):
    """gemma3-4b reduced (4 layers, head split over tp 2) under a (2, 2)
    DistContext: each rank's logits are its dp shard's, and the loss is the
    global masked mean (the shards' masks differ)."""
    ref, ranks, _, _ = runs
    exp = ref["dense"]
    for r, res in enumerate(ranks):
        d = r // 2
        np.testing.assert_allclose(res["dense"]["logits"], exp["logits"][4 * d:4 * d + 4],
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(res["dense"]["loss"], exp["loss"], rtol=1e-5)
        np.testing.assert_allclose(res["dense"]["ce"], exp["ce"], rtol=1e-5)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def test_dp_train_step_matches_single_device(runs):
    """make_train_step(ctx) at dp 4 (gradients averaged over the ranks, the
    loss the global masked mean) against the reference's one-device step
    on the whole batch; every rank holds the same parameters after it."""
    ref, ranks, _, _ = runs
    exp = ref["dense"]["step"]
    first = _flat(ranks[0]["dense"]["dp_step"]["params"])
    for res in ranks:
        got = res["dense"]["dp_step"]
        np.testing.assert_allclose(got["loss"], exp["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], exp["grad_norm"], rtol=1e-4)
        for name, v in _flat(got["params"]).items():
            np.testing.assert_array_equal(v, first[name])
    lr = OPT["lr"]
    for name, e in _flat(exp["params"]).items():
        err = np.abs(first[name] - e)
        assert err.max() <= 2 * lr + 1e-6, (name, float(err.max()))
        assert np.mean(err <= lr * 2 * BF16_ULP + 1e-6) >= 0.99, name


def test_compressed_dp_step_tracks_implicit(runs):
    """make_compressed_dp_train_step at dp 4 within the reference test's
    bounds of the implicit step (losses 2%, parameters 2 x 3 x lr after 3
    steps, a residual alive below 1), the same parameters on every rank, and
    the reference's own compressed step's losses within the same 2% (its
    step-0 loss, the ranks' mean of their shards' masked means, 1e-5)."""
    ref, ranks, _, _ = runs
    imp, exp_c = ref["dense"]["implicit3"], ref["dense"]["compressed3"]
    first = _flat(ranks[0]["dense"]["compressed_step"]["params"])
    for res in ranks:
        got = res["dense"]["compressed_step"]
        for li, lc, lr_ in zip(imp["losses"], got["losses"], exp_c["losses"]):
            assert abs(li - lc) <= 0.02 * abs(li) + 1e-4, (li, lc)
            assert abs(lr_ - lc) <= 0.02 * abs(lr_) + 1e-4, (lr_, lc)
        assert 0 < got["err_max"] < 1.0
        for name, v in _flat(got["params"]).items():
            np.testing.assert_array_equal(v, first[name])
    np.testing.assert_allclose(ranks[0]["dense"]["compressed_step"]["losses"][0],
                               exp_c["losses"][0], rtol=1e-5)
    for name, e in _flat(imp["params"]).items():
        assert np.abs(first[name] - e).max() <= 2 * 3 * OPT["lr"], name


def test_driver_gates_on_flag_and_resumes(runs):
    """launch.train at a dp world of 4 with grad_compression: the explicit
    path is on and logged beside the dp-reduction model, and a killed and
    resumed run (each rank's residual in the checkpoint) reproduces the
    uninterrupted losses."""
    _, ranks, _, _ = runs
    for res in ranks:
        drv = res["driver"]
        assert len(drv["full"]) == 4 and np.isfinite(drv["full"]).all()
        np.testing.assert_allclose(drv["resumed"], drv["full"][2:], rtol=1e-6)
        joined = "\n".join(drv["log"])
        assert "explicit path ON" in joined, joined
        assert "dp-reduction model" in joined
        assert drv["full"] == ranks[0]["driver"]["full"]


# -- the expert-parallel MoE ------------------------------------------------------------------


def _moe_ranks(runs, world):
    """The MoE results of every rank of the world-8 job ((2, 4) mesh, ep over
    "model", dp over "data") or of the world-4 one (ep over all 4)."""
    _, main, moe, _ = runs
    return [r["moe"] for r in (moe if world == 8 else main)]


@pytest.mark.parametrize("experts", ["full", "slice"])
@pytest.mark.parametrize("world", [4, 8])
def test_moe_ep_grads_match_local_dispatch(runs, world, experts):
    """The gradients of x, the router, wi and wo through _moe_ep (the
    collectives' backward, then one copy's gradient: ``_moe_ep``'s doc)
    against the local dispatch's at 2e-4, with every expert on every rank
    or each rank's slice (its rows of the local gradient), the same on
    every rank of the ep axis but the slices.  The loss weighs the aux
    loss, whose local counterpart is the reference's pmean: the mean of
    the ranks' token shares' aux losses (1e-5)."""
    ranks = _moe_ranks(runs, world)
    for r, res in enumerate(ranks):
        got, exp = res[experts]["grads"], res["local"]["grads"]
        n = res["expert_rows"]
        m = res["ep_rank"]
        for name, g in got.items():
            e = exp[name]
            if experts == "slice" and name in ("wi", "wo"):
                e = e[m * n:(m + 1) * n]
            np.testing.assert_allclose(g, e, atol=2e-4, rtol=2e-4, err_msg=f"rank {r} {name}")
        np.testing.assert_allclose(res[experts]["aux"], res["local"]["aux"], rtol=1e-5)
        first = ranks[r - m]
        for name in ("x", "router") + (("wi", "wo") if experts == "full" else ()):
            np.testing.assert_array_equal(got[name], first[experts]["grads"][name])


@pytest.mark.parametrize("over", ["replicated", "dp", "replicated-slice", "dp-slice"])
def test_moe_train_step_with_ep_matches_without(runs, over):
    """make_train_step(ctx=DistContext(ep_axis=...)) gives the update of the
    same step without ep_axis: over "model" of the (2, 4) mesh (dp over
    "data", which the step averages its gradients over), and over the dp
    axis of 4 itself (each rank routes its own shard); with every expert on
    every rank, or each rank's slice of them (its rows of the update
    without ep_axis, and the same norm for the clip)."""
    ranks = [r["moe"]["step"] for r in runs[2]] if over.startswith("replicated") else \
        [r["moe"]["step_over_dp"] for r in runs[1]]
    run = "ep_slice" if over.endswith("slice") else "ep"
    sliced = ("blocks.moe.wi", "blocks.moe.wo") if run == "ep_slice" else ()
    lr = OPT["lr"]
    for res in ranks:
        got, exp = res[run], res["local"]
        np.testing.assert_allclose(got["loss"], exp["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], exp["grad_norm"], rtol=1e-4)
        m, n = res["ep_rank"], res["expert_rows"]
        for name, e in _flat(exp["params"]).items():
            if name in sliced:
                e = e[:, m * n:(m + 1) * n]
            err = np.abs(_flat(got["params"])[name] - e)
            assert err.max() <= 2 * lr + 1e-6, (name, float(err.max()))
            assert np.mean(err <= lr * 2 * BF16_ULP + 1e-6) >= 0.999, name
    for res in ranks:  # a slice equals its ep peers', every other leaf every rank's
        peer = next(r_ for r_ in ranks if r_["ep_rank"] == res["ep_rank"])
        for name, v in _flat(res[run]["params"]).items():
            first = peer if name in sliced else ranks[0]
            np.testing.assert_array_equal(v, _flat(first[run]["params"])[name])


@pytest.mark.parametrize("name", sorted(ranks_.BACKWARD_SHAPES))
def test_collective_backward_matches_definition(runs, name):
    """Each differentiable collective's backward at world 4: rank s's
    gradient of sum_r <output_r, cot_r>, from the collective's definition
    on the ranks' inputs (numpy)."""
    _, ranks, _, inp = runs
    xs, cots, p = inp["x"], inp["cot"][name], 4
    for s_, res in enumerate(ranks):
        if name == "allreduce":
            exp = cots.sum(0)
        elif name == "allreduce_mean":
            exp = cots.sum(0) / p
        elif name.startswith("allgather"):
            dim = int(name[-1])
            exp = sum(np.split(c, p, axis=dim)[s_] for c in cots)
        else:   # alltoall_<split><concat>: piece r of x_s went to rank r, at its slot s
            split, concat = int(name[-2]), int(name[-1])
            exp = np.concatenate([np.split(cots[r], p, axis=concat)[s_] for r in range(p)],
                                 axis=split)
        assert exp.shape == xs[s_].shape
        np.testing.assert_allclose(res["collectives_backward"][name], exp, atol=1e-6, rtol=1e-6,
                                   err_msg=f"rank {s_}")


@pytest.mark.parametrize("experts", ["full", "slice"])
def test_moe_ep_matches_local_dispatch(runs, experts):
    """_moe_ep on a (2, 4) mesh (ep over "model"), each rank holding every
    expert or only its slice (``interop.expert_slice``), against the port's
    local dispatch of the same dp shard at 2e-4 (capacity factor 8: no
    drops), the same output on every rank of the ep axis."""
    _, _, ranks, _ = runs
    for r, res in enumerate(ranks):
        got, exp = res["moe"][experts], res["moe"]["local"]
        np.testing.assert_allclose(got["out"], exp["out"], atol=2e-4, rtol=2e-4)
        np.testing.assert_array_equal(got["out"], ranks[(r // 4) * 4]["moe"][experts]["out"])
        assert np.isfinite(got["aux"])
        assert res["moe"]["expert_rows"] == 2   # 8 experts over 4 ranks


def _moe_guard_inputs():
    from repro_torch import configs
    from repro_torch.models import moe

    cfg = configs.get("qwen3-moe-235b-a22b").reduced(**ranks_.MOE_OVER)
    g = torch.Generator()
    g.manual_seed(3)
    blk = {k: w[0] for k, w in moe.init_moe_block(cfg, g, 1, "cpu").items()}
    x = torch.tensor(np.random.default_rng(3).normal(size=(2, 16, cfg.d_model)),
                     dtype=torch.float32)
    return cfg, blk, x


def test_moe_ep_forward_under_no_grad_matches_local(tmp_path):
    """Under torch.no_grad, with inputs that require a gradient, _moe_ep runs
    its dispatch as before: at world 1 (an in-process gloo group) it gives
    the local dispatch's output and aux loss at 2e-4."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import moe
    from repro_torch.models.transformer import DistContext

    cfg, blk, x = _moe_guard_inputs()
    for w in blk.values():
        w.requires_grad_()
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
        with torch.no_grad():
            y, aux = moe.moe_block(x, blk, cfg, DistContext(mesh=mesh, ep_axis="model"))
            y_loc, aux_loc = moe.moe_block(x, blk, cfg, None)
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(y.numpy(), y_loc.numpy(), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(float(aux), float(aux_loc), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("tokens", ranks_.MOE_DECODE_TOKENS)
def test_moe_ep_decode_scale_under_no_grad_matches_local(runs, tokens):
    """_moe_ep under torch.no_grad at decode scale on the world-4 ranks (ep
    over a replicated axis of 4): fewer tokens than the axis's size, which
    it pads to a multiple of it, so that some ranks route only padding;
    8 live experts padded to 16, so that the last two ranks hold padding
    experts only, which get no token.  The output equals the local dispatch
    of the same tokens at 2e-4 on every rank, every rank the same, with no
    graph kept; the aux loss is finite."""
    _, main, _, _ = runs
    for r, res in enumerate(main):
        dec = res["moe"]["decode"]
        assert dec["axis"] == 4 and tokens % 4
        lo, hi = dec["experts"]
        assert (hi <= dec["live"]) == (r < 2) and (lo >= dec["live"]) == (r >= 2)
        got = dec[tokens]
        assert got["ep"].shape == (tokens, 1, ranks_.MOE_DECODE_OVER["d_model"])
        np.testing.assert_allclose(got["ep"], got["local"], atol=2e-4, rtol=2e-4,
                                   err_msg=f"rank {r}")
        np.testing.assert_array_equal(got["ep"], main[0]["moe"]["decode"][tokens]["ep"])
        assert not got["requires_grad"] and np.isfinite(got["aux"])


def test_moe_ep_grads_at_world_1(tmp_path):
    """At world 1 (an in-process gloo group) _moe_ep under autograd gives the
    local dispatch's gradients of x, the router, wi and wo at 2e-4."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import moe
    from repro_torch.models.transformer import DistContext

    cfg, blk, x = _moe_guard_inputs()
    cot = torch.tensor(np.random.default_rng(4).normal(size=x.shape), dtype=torch.float32)

    def grads(ctx):
        leaves = {k: w.clone().requires_grad_() for k, w in blk.items()}
        xl = x.clone().requires_grad_()
        y, aux = moe.moe_block(xl, leaves, cfg, ctx)
        ((y * cot).sum() + 3.0 * aux).backward()
        return {"x": xl.grad, **{k: leaves[k].grad for k in ("router", "wi", "wo")}}

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
        got = grads(DistContext(mesh=mesh, ep_axis="model"))
    finally:
        dist.destroy_process_group()
    exp = grads(None)
    for name, g in got.items():
        assert g is not None and bool(g.abs().sum() > 0), name
        np.testing.assert_allclose(g.numpy(), exp[name].numpy(), atol=2e-4, rtol=2e-4,
                                   err_msg=name)
