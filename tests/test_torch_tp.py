"""Tensor-parallel products: the transformer family's projections, MLPs and
vocabulary split over 'model' as the sharding rules split them, and the
vocabulary-parallel cross-entropy.

Four gloo ranks (``tests/_torch_spmd_ranks.py``'s ``tp`` job) on the (1, 4)
and (2, 2) meshes of ``launch.mesh.make_host_mesh``, from the reference's
parameters: each rank's gradients (reduced as the train step reduces them)
and serving logits on its ``local_shard`` under ``param_specs`` against
the run on every leaf whole, the tp run's logits and decode steps against
the reference's unsharded ``forward``, each rank's decode attention on its
own q heads (counted at ``layers.attention_island`` and ``attention``) and
its final KV cache as its ``local_shard`` of the whole run's, the
collectives and the vocabulary-parallel pieces against a whole computation
here, and the rank's FLOPs in closed form.
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest
import torch

import _torch_spmd_ranks as ranks_
from repro_torch import configs
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

TRAIN_TOL = 2e-5
SERVE_TOL = 1e-4
LOGIT_TOL = 1e-4   # the float32 configs' model-parity tolerance (tests/test_torch_models.py)
UNIT_TOL = 1e-6
MESHES = (4, 2)    # make_host_mesh(model=...): (1, 4) and (2, 2)
# float32 configs: a bfloat16 product would round the split and the whole
# sums (float32 in another order) to neighbouring values
CASES = {
    # vocab 512 splits (tied head, vocabulary-parallel cross-entropy); 4 heads
    # of 2 kv: the head plan, kv % tp != 0 on tp 4; qk-norm; local windows
    "gemma3": ("gemma3-4b", {"dtype": "float32"}),
    # an odd vocabulary (the head and embedding whole), 6 heads: the sequence
    # plan on tp 4 (1024 rows), the head plan on tp 2; ff 130: on tp 4 the
    # rules split wi's 260 columns and keep wo whole
    "minicpm_seq": ("minicpm-2b", {"dtype": "float32", "vocab_size": 509, "num_heads": 6,
                                   "num_kv_heads": 6, "d_ff": 130}),
    # the MoE layer with kimi-k2's shared expert, its untied head split
    "kimi_moe": ("kimi-k2-1t-a32b", {"dtype": "float32", "param_dtype": "float32",
                                     "capacity_factor": 8.0}),
    # the other architectures' training ranks, each keeping the head ratios
    # that choose its plan at tp 16 (`test_tp_added_cases_keep_their_plans`).
    # h2o-danube-3-4b: GQA 4 (8 heads over 2 kv: 2 q heads a rank over one kv
    # head on tp 4), the window on every layer (8 of 16 rows), head dim 24
    # (no power of two, as its 120)
    "h2o_window": ("h2o-danube-3-4b", {"dtype": "float32", "num_heads": 8, "num_kv_heads": 2,
                                       "head_dim": 24, "sliding_window": 8}),
    # starcoder2-3b: 6 heads over 2 kv heads do not split over tp 4 (its 24
    # over 16): the sequence plan at 1024 rows with GQA; its GELU MLP
    "starcoder2_seq": ("starcoder2-3b", {"dtype": "float32", "num_heads": 6,
                                         "num_kv_heads": 2}),
    # internvl2-2b: 8 patch embeddings over the first positions, an odd
    # vocabulary (the head and embedding whole), 1 q head a rank over 1 kv
    # head on tp 4
    "internvl2_vlm": ("internvl2-2b", {"dtype": "float32", "vocab_size": 509}),
    # qwen3-moe-235b-a22b: a q group of 4 wider than a rank's heads (1 on tp
    # 4, 2 on tp 2), qk-norm, 4 experts: one a rank over the joint ('data',
    # 'model') axis, as its 256 padded experts over 256 ranks
    "qwen3_moe": ("qwen3-moe-235b-a22b", {"dtype": "float32", "param_dtype": "float32",
                                          "num_experts": 4, "capacity_factor": 8.0}),
}
# the cases added with the other architectures' ranks draw their data from a
# generator of their own, so the first three cases' data stay as they were
ADDED = ("h2o_window", "starcoder2_seq", "internvl2_vlm", "qwen3_moe")
# (sequences, rows); as many sequences as layers would put the dp axes on the
# KV cache's layer dim (`sharding.cache_specs`)
SEQ = {"gemma3": (8, 16), "minicpm_seq": (2, 1024), "kimi_moe": (8, 16), "h2o_window": (8, 16),
       "starcoder2_seq": (2, 1024), "internvl2_vlm": (8, 16), "qwen3_moe": (8, 16)}
# the sequence plan's cases prefill their whole rows (the plan needs 256 a
# rank); the others a 12-token prompt
PROMPT_ROWS = {"minicpm_seq": 1024, "starcoder2_seq": 1024}
# each added case's architecture at full size: the plan its training rank
# takes at tp 16 (`chip_smoke.TP_RANK_SHAPES`), which the case takes at tp 4
FULL_PLAN = {"h2o_window": "head", "starcoder2_seq": "seq", "internvl2_vlm": "head",
             "qwen3_moe": "head"}
# the FLOP count: every product split but the head (vocab 512), and one
# with k / v (1 head of 30) and the head (vocab 509) whole
FLOPS = {
    "split": ("gemma3-4b", {"dtype": "float32"}),
    "replicated": ("minicpm-2b", {"dtype": "float32", "vocab_size": 509, "num_kv_heads": 1,
                                  "head_dim": 30}),
}
FLOP_TOKENS = (2, 16)
# the pieces alone: x [n, K] @ w [K, M]; gate || up [n, 2 ff]; a vocab of 16
UNIT = dict(n=6, k=8, m=12, ff=8, vocab=16, d=4, b=4, t=9)


def _init(arch, over, i):
    import jax

    from repro import configs as jconfigs
    from repro.models import api as japi

    cfg = jconfigs.get(arch).reduced(**over)
    return cfg, jax.tree.map(np.asarray, japi.init_params(cfg, jax.random.PRNGKey(i)))


def _unit(rng) -> dict:
    u = UNIT
    labels = rng.integers(0, u["vocab"], (u["b"], u["t"]))
    # each rank boundary of tp 2 and 4 from both sides, and the ends
    labels[0, :8] = [0, 3, 4, 7, 8, 11, 12, 15]
    mask = (rng.random((u["b"], u["t"])) < 0.7).astype(np.float32)
    mask[0, :8] = 1.0
    return {
        "x": rng.normal(size=(u["n"], u["k"])).astype(np.float32),
        "w": rng.normal(size=(u["k"], u["m"])).astype(np.float32),
        "cot": rng.normal(size=(u["n"], u["m"])).astype(np.float32),
        "gu": rng.normal(size=(u["n"], 2 * u["ff"])).astype(np.float32),
        "cot_gate": rng.normal(size=(u["n"], u["ff"])).astype(np.float32),
        "cot_up": rng.normal(size=(u["n"], u["ff"])).astype(np.float32),
        "tokens": labels[:, ::-1].copy().astype(np.int32),
        "table": rng.normal(size=(u["vocab"], u["d"])).astype(np.float32),
        "cot_embed": rng.normal(size=(u["b"], u["t"], u["d"])).astype(np.float32),
        "logits": (rng.normal(size=(u["b"], u["t"], u["vocab"])) * 3).astype(np.float32),
        "labels": labels.astype(np.int32),
        "mask": mask,
    }


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    rng, added = np.random.default_rng(27), np.random.default_rng(30)
    params, batch, prompt, decode, jparams = {}, {}, {}, {}, {}
    order = [c for c in sorted(CASES) if c not in ADDED] + list(ADDED)
    for i, case in enumerate(order):
        arch, over = CASES[case]
        g = added if case in ADDED else rng
        jcfg, params[case] = _init(arch, over, i)
        jparams[case] = (jcfg, params[case])
        b, t = SEQ[case]
        v = over.get("vocab_size", 512)
        mask = (g.random((b, t)) < 0.8).astype(np.float32)
        mask[0] = 1.0
        batch[case] = {"tokens": g.integers(0, v, (b, t)).astype(np.int32), "mask": mask}
        prompt[case] = g.integers(0, v, (b, PROMPT_ROWS.get(case, 12))).astype(np.int32)
        decode[case] = g.integers(0, v, (2, b, 1)).astype(np.int32)
        if jcfg.frontend_tokens:   # the vlm's patch embeddings, in training and serving
            patches = g.normal(size=(b, jcfg.frontend_tokens, jcfg.d_model)).astype(np.float32)
            batch[case]["patches"] = patches
            prompt[case] = {"tokens": prompt[case], "patches": patches}
    flop_tokens = {}
    for i, (case, (arch, over)) in enumerate(sorted(FLOPS.items())):
        _, params[case] = _init(arch, over, 10 + i)
        flop_tokens[case] = rng.integers(0, over.get("vocab_size", 512),
                                         FLOP_TOKENS).astype(np.int32)
    inp = {"tp": {"meshes": MESHES, "cases": CASES, "params": params, "batch": batch,
                  "prompt": prompt, "decode": decode, "states": True, "unit": _unit(rng),
                  "flops": FLOPS, "tokens": flop_tokens}}
    tmp = tmp_path_factory.mktemp("tp")
    inputs = tmp / "inputs.pkl"
    inputs.write_bytes(pickle.dumps(inp))
    procs = ranks_.launch("tp", 4, tmp, inputs)
    try:
        ranks_.wait(procs, "the world-4 tp job")
    except RuntimeError as e:
        pytest.fail(str(e))
    return {"ranks": [r["tp"] for r in ranks_.load(tmp, "tp", 4)], "inp": inp["tp"],
            "jparams": jparams}


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=msg)


# -- the model on the meshes -----------------------------------------------------------

@pytest.mark.parametrize("model", MESHES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_gradients_equal_the_whole_run(tp, case, model):
    """The loss, the clip's global norm (each tp block's squares summed over
    tp once) and every leaf's gradient block of one microbatch, reduced as
    ``make_train_step`` reduces it, on the rank's ``local_shard`` with the
    tensor-parallel products: equal to ``local_shard`` of the run on whole
    leaves."""
    for rank in tp["ranks"]:
        r = rank[model][case]
        _close(r["loss"][1], r["loss"][0], TRAIN_TOL, "loss")
        _close(r["gnorm"][1], r["gnorm"][0], TRAIN_TOL, "grad norm")
        assert r["want"].keys() == r["got"].keys()
        for k, want in r["want"].items():
            got = r["got"][k]
            assert got.shape == want.shape and got.dtype == want.dtype, k
            _close(got, want, TRAIN_TOL, k)


@pytest.mark.parametrize("model", MESHES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_serving_equals_the_whole_run(tp, case, model):
    """A prefill and two decode steps with the tensor-parallel products (the
    logits all-gathered over tp) give the whole run's logits, and each
    rank's final KV cache is its ``local_shard`` of the whole runs' cache
    (their dp rows gathered): the same block, kv heads split where the rules
    put them on 'model', its values within the serving limit."""
    for rank in tp["ranks"]:
        s = rank[model][case]["serve"]
        assert len(s["whole"]) == len(s["tp"]) == 3
        for i, (a, b) in enumerate(zip(s["whole"], s["tp"])):
            _close(b, a, SERVE_TOL, f"step {i}")
        st = rank[model][case]["state"]
        assert st["want"].keys() == st["got"].keys() and st["want"]
        for k, want in st["want"].items():
            assert st["got"][k].shape == want.shape, k
            _close(st["got"][k], want, SERVE_TOL, k)


@pytest.mark.parametrize("model", MESHES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_logits_equal_the_references_forward(tp, case, model):
    """The tp run's full-sequence logits (each dp rank's rows) equal the
    reference's unsharded ``forward`` on the same parameters and tokens."""
    from repro.models import api as japi

    jcfg, jp = tp["jparams"][case]
    batch = tp["inp"]["batch"][case]
    tokens = batch["tokens"]
    want = np.asarray(japi.logits_fn(jcfg, jp, {k: v for k, v in batch.items()
                                                if k != "mask"})[0])
    for rank in tp["ranks"]:
        n = tokens.shape[0] * model // 4
        d = rank[model]["coords"]["data"]
        _close(rank[model][case]["logits"], want[d * n:(d + 1) * n], LOGIT_TOL)


@pytest.mark.parametrize("model", MESHES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_decode_equals_the_references_forward(tp, case, model):
    """The tp run's prefill and two decode steps (each dp rank's rows) give
    the reference's unsharded ``forward`` on the prompt and the two decoded
    tokens, at their last three positions."""
    from repro.models import api as japi

    jcfg, jp = tp["jparams"][case]
    prompt = tp["inp"]["prompt"][case]
    extra = {k: v for k, v in prompt.items() if k != "tokens"} if isinstance(prompt, dict) else {}
    prompt = prompt["tokens"] if isinstance(prompt, dict) else prompt
    tokens = np.concatenate([prompt, *tp["inp"]["decode"][case]], axis=1)
    want = np.asarray(japi.logits_fn(jcfg, jp, {"tokens": tokens, **extra})[0])[:, -3:]
    for rank in tp["ranks"]:
        n = tokens.shape[0] * model // 4
        d = rank[model]["coords"]["data"]
        for i, got in enumerate(rank[model][case]["serve"]["tp"]):
            _close(got[:, 0], want[d * n:(d + 1) * n, i], LOGIT_TOL, f"step {i}")


def _cache_on_model(case: str, model: int) -> bool:
    """Whether ``cache_specs`` puts the case's KV cache's kv heads on 'model'
    on the (4 / model, model) mesh."""
    from repro_torch.dist import sharding

    cfg = configs.get(CASES[case][0]).reduced(**CASES[case][1])
    b = SEQ[case][0]
    meta = T.init_cache(cfg, b, 16, device="meta")
    spec = sharding.cache_specs(cfg, meta, {"data": 4 // model, "model": model}, b)["kv"]
    return "model" in sharding.spec_axes(spec)


@pytest.mark.parametrize("model", MESHES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_decode_attends_on_the_ranks_own_heads(tp, case, model):
    """Each decode step of a tp rank attends in one island a layer, of at
    most ceil(H / tp) q heads, the tp ranks' islands together taking every
    head once; each island is handed the cache's kv heads as the rank holds
    them (its block where the rules put them on 'model') and reads only the
    kv heads its q heads map to (q head i: kv head i // (H / KV)); a rank
    past the last head calls no attention."""
    arch, over = CASES[case]
    cfg = configs.get(arch).reduced(**over)
    h, g = cfg.num_heads, cfg.num_heads // cfg.num_kv_heads
    held = cfg.num_kv_heads // model if _cache_on_model(case, model) else cfg.num_kv_heads
    events, nq = {}, {}
    for rank in tp["ranks"]:
        c = rank[model]["coords"]
        ev = events[c["data"], c["model"]] = rank[model][case]["decode_heads"]
        assert ev and ev[0][0] == "island" and ev[0][1] <= -(-h // model)
        nq[c["data"], c["model"]] = ev[0][1]
    for (d, m), n in nq.items():
        first = sum(nq[d, j] for j in range(m))
        reads = len({i // g for i in range(first, first + n)})
        want = [("island", n, held)] + ([("attention", n, reads)] if n else [])
        assert events[d, m] == want * (2 * cfg.num_layers), (d, m)
    for d in {d for d, _ in nq}:
        assert sum(nq[d, m] for m in range(model)) == h


def test_tp_decode_cases_cover_the_splits():
    """The serving cases take each decode split: (a) H divisible by tp with
    the cache whole over 'model' (gemma3 and kimi_moe on tp 4), (b) H not
    divisible, a rank holding no head (minicpm_seq: 6 heads on tp 4, 2 a
    rank), (c) the cache's kv heads on 'model' (gemma3 and minicpm_seq on
    tp 2)."""
    cfgs = {case: configs.get(arch).reduced(**over) for case, (arch, over) in CASES.items()}
    for case in ("gemma3", "kimi_moe"):   # (a)
        assert cfgs[case].num_heads % 4 == 0 and not _cache_on_model(case, 4)
    h = cfgs["minicpm_seq"].num_heads   # (b)
    assert h % 4 and 3 * -(-h // 4) >= h and not _cache_on_model("minicpm_seq", 4)
    for case in ("gemma3", "minicpm_seq"):   # (c)
        assert _cache_on_model(case, 2)


def test_tp_plans_cover_the_cases():
    """The cases take the paths they are chosen for: the head and the
    sequence plan, kv % tp != 0, an odd vocabulary, a split one."""
    g = configs.get("gemma3-4b").reduced(**CASES["gemma3"][1])
    m = configs.get("minicpm-2b").reduced(**CASES["minicpm_seq"][1])
    k = configs.get("kimi-k2-1t-a32b").reduced(**CASES["kimi_moe"][1])
    assert L.shard_plan(g.num_heads, g.num_kv_heads, 16, 4) == "head"
    assert g.num_kv_heads % 4 and g.qk_norm and g.vocab_size % 4 == 0 and g.tie_embeddings
    assert L.shard_plan(m.num_heads, m.num_kv_heads, 1024, 4) == "seq"
    assert L.shard_plan(m.num_heads, m.num_kv_heads, 1024, 2) == "head"
    assert m.vocab_size % 2 and m.d_ff % 4 and 2 * m.d_ff % 4 == 0 and m.d_ff % 2 == 0
    assert k.family == "moe" and k.n_shared_experts and not k.tie_embeddings
    assert k.moe_d_ff * k.n_shared_experts % 4 == 0


@pytest.mark.parametrize("case", ADDED)
def test_tp_added_cases_keep_their_plans(case):
    """Each added case takes at tp 4 the plan its architecture's training
    rank takes at tp 16 (the q heads over the kv heads that choose it), and
    keeps what it is chosen for: GQA 4 with 2 q heads a rank, the window on
    every layer and a head dim of no power of two (h2o-danube); the
    sequence plan with GQA and the GELU MLP (starcoder2); the patch prefix
    and an odd vocabulary, 1 q head a rank (internvl2); a q group wider
    than a rank's heads and one expert a rank over the joint axis (qwen3-moe)."""
    arch, over = CASES[case]
    full, cfg = configs.get(arch), configs.get(arch).reduced(**over)
    assert L.shard_plan(full.num_heads, full.num_kv_heads, 4096, 16) == FULL_PLAN[case]
    assert L.shard_plan(cfg.num_heads, cfg.num_kv_heads, SEQ[case][1], 4) == FULL_PLAN[case]
    g = cfg.num_heads // cfg.num_kv_heads
    if case == "h2o_window":
        assert g == full.num_heads // full.num_kv_heads == 4 and cfg.num_heads // 4 == 2
        assert set(T._layer_windows(cfg)) == {cfg.sliding_window} and 0 < cfg.sliding_window
        assert cfg.sliding_window < SEQ[case][1] and cfg.head_dim & (cfg.head_dim - 1)
    elif case == "starcoder2_seq":
        assert cfg.num_heads % 4 and g > 1 and cfg.act == full.act == "gelu"
    elif case == "internvl2_vlm":
        assert cfg.frontend_tokens and cfg.vocab_size % 2 and cfg.num_heads // 4 == 1
    else:
        assert g > cfg.num_heads // 4 and g > cfg.num_heads // 2 and cfg.qk_norm
        assert cfg.num_experts_padded // 4 == 1 == full.num_experts_padded // 256


# -- the pieces alone --------------------------------------------------------------------

def _block(a, dim, p, r):
    n = a.shape[dim] // p
    return np.take(a, range(r * n, (r + 1) * n), axis=dim)


@pytest.mark.parametrize("model", MESHES)
def test_row_parallel_sum_and_its_identity_backward(tp, model):
    """*g*: the partial products summed, alike on every rank; its identity
    backward gives each rank its blocks' whole gradients.  The planted
    ``direct.allreduce`` in its place counts them tp times."""
    u = tp["inp"]["unit"]
    x, w, cot = u["x"], u["w"], u["cot"]
    for rank in tp["ranks"]:
        m = rank[model]["coords"]["model"]
        r = rank[model]["unit"]
        dx, dw = _block(cot @ w.T, -1, model, m), _block(x.T @ cot, 0, model, m)
        _close(r["g"]["y"], x @ w, UNIT_TOL)
        _close(r["g"]["dx"], dx, UNIT_TOL)
        _close(r["g"]["dw"], dw, UNIT_TOL)
        _close(r["planted"]["dw"], model * dw, UNIT_TOL)
        assert not np.allclose(r["planted"]["dw"], dw, rtol=UNIT_TOL, atol=UNIT_TOL)


@pytest.mark.parametrize("model", MESHES)
def test_column_parallel_copy_sums_the_input_gradient(tp, model):
    """*f*: the rank's columns of y @ w, and y's whole gradient (the ranks'
    shares summed)."""
    u = tp["inp"]["unit"]
    x, w, cot = u["x"], u["w"], u["cot"]
    for rank in tp["ranks"]:
        m = rank[model]["coords"]["model"]
        r = rank[model]["unit"]["f"]
        _close(r["out"], _block(x @ w, -1, model, m), UNIT_TOL)
        _close(r["dy"], cot @ w.T, UNIT_TOL)
        _close(r["dw"], x.T @ _block(cot, -1, model, m), UNIT_TOL)


@pytest.mark.parametrize("model", MESHES)
def test_split_to_group_gathers_the_gradient(tp, model):
    """The rank's columns of a tensor every rank holds alike; its gradient
    is the whole cotangent (the ranks' blocks all-gathered)."""
    u = tp["inp"]["unit"]
    x, cot = u["x"], u["cot"][:, :u["x"].shape[-1]]
    for rank in tp["ranks"]:
        m = rank[model]["coords"]["model"]
        r = rank[model]["unit"]["split"]
        np.testing.assert_array_equal(r["out"], _block(x, -1, model, m))
        np.testing.assert_array_equal(r["dx"], cot)


@pytest.mark.parametrize("model", MESHES)
def test_gate_up_exchange(tp, model):
    """The rank's gate and up columns from blocks of ``gate || up`` that hold
    other ranks' (P = 2: rank 0 holds every gate column), bit for bit, and
    the backward's cotangent blocks."""
    u = tp["inp"]["unit"]
    gu, ff = u["gu"], UNIT["ff"]
    whole_cot = np.concatenate([u["cot_gate"], u["cot_up"]], -1)
    for rank in tp["ranks"]:
        m = rank[model]["coords"]["model"]
        r = rank[model]["unit"]["exchange"]
        np.testing.assert_array_equal(r["gate"], _block(gu[:, :ff], -1, model, m))
        np.testing.assert_array_equal(r["up"], _block(gu[:, ff:], -1, model, m))
        np.testing.assert_array_equal(r["dgu"], _block(whole_cot, -1, model, m))


@pytest.mark.parametrize("model", MESHES)
def test_ppermute_backward_follows_the_inverse_pairs(tp, model):
    """``direct.ppermute``'s gradient: each rank gets the cotangent of the
    rank it sent to; a rank that sent nothing gets zeros."""
    u = tp["inp"]["unit"]
    cot = u["cot"][..., :u["x"].shape[-1]]
    for rank in tp["ranks"]:
        m = rank[model]["coords"]["model"]
        want = (m + 2) * cot if m < model - 1 else np.zeros_like(cot)
        np.testing.assert_array_equal(rank[model]["unit"]["ppermute_dx"], want)


@pytest.mark.parametrize("model", MESHES)
def test_vocab_parallel_embedding_and_cross_entropy(tp, model):
    """``layers.embed_parallel`` and ``vocab_parallel_cross_entropy_terms``
    against ``layers.embed`` / ``cross_entropy_terms`` on the whole table
    and logits: values and the rank's block of each gradient, with labels
    on both sides of every rank boundary, masked tokens and the z-loss."""
    u = tp["inp"]["unit"]
    for rank in tp["ranks"]:
        m, d = rank[model]["coords"]["model"], rank[model]["coords"]["data"]
        n = u["tokens"].shape[0] * model // 4
        rows = slice(d * n, (d + 1) * n)
        r = rank[model]["unit"]
        table = torch.tensor(u["table"], requires_grad=True)
        x = L.embed(torch.tensor(u["tokens"][rows]), table, scale=True)
        (x * torch.tensor(u["cot_embed"][rows])).sum().backward()
        _close(r["embed"]["x"], x.detach().numpy(), UNIT_TOL)
        _close(r["embed"]["dtable"], _block(table.grad.numpy(), 0, model, m), UNIT_TOL)
        logits = torch.tensor(u["logits"][rows], requires_grad=True)
        total, count = L.cross_entropy_terms(logits, torch.tensor(u["labels"][rows]),
                                             torch.tensor(u["mask"][rows]))
        total.backward()
        _close(r["ce"]["total"], float(total.detach()), UNIT_TOL)
        assert r["ce"]["count"] == float(count)
        _close(r["ce"]["dlogits"], _block(logits.grad.numpy(), -1, model, m), UNIT_TOL)


def _products(cfg, p: int) -> int:
    """One forward's product FLOPs a rank at tp ``p``: each product 2 n K N,
    over p where the rules split its weight."""
    n = FLOP_TOKENS[0] * FLOP_TOKENS[1]
    d, hd, ff, v = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd

    def part(width):
        return p if width % p == 0 else 1

    layer = (2 * n * d * q // part(q) + 2 * 2 * n * d * kv // part(kv)
             + 2 * n * q * d // part(q) + 2 * n * d * 2 * ff // part(2 * ff)
             + 2 * n * ff * d // part(ff))
    return cfg.num_layers * layer + 2 * n * d * v // part(v)


def _attention(cfg, p: int) -> int:
    """The islands' FLOPs (the op's formula): the head plan, h / p heads."""
    b, t = FLOP_TOKENS
    assert L.shard_plan(cfg.num_heads, cfg.num_kv_heads, t, p) == "head"
    return sum(4 * cfg.resolved_head_dim * b * cfg.num_heads // p * fa_ops.visible_pairs(
        t, t, causal=True, window=w, q_offset=0, kv_len=None) for w in T._layer_windows(cfg))


@pytest.mark.parametrize("case", sorted(FLOPS))
def test_rank_flops_in_closed_form(tp, case):
    """``hlo_analysis.count_step`` of a serving forward at tp 4 counts, on
    every rank, a quarter of each split product, each replicated product
    whole (``"replicated"``: k / v, 30 columns, and the 509-column head) and
    the islands' attention."""
    arch, over = FLOPS[case]
    cfg = configs.get(arch).reduced(**over)
    want = _products(cfg, 4) + _attention(cfg, 4)
    whole = _products(cfg, 1)
    if case == "replicated":
        assert (cfg.num_kv_heads * cfg.resolved_head_dim) % 4 and cfg.vocab_size % 4
    for rank in tp["ranks"]:
        assert rank[4]["flops"][case] == want
    assert want < whole
