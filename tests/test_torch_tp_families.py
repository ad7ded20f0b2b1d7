"""Tensor-parallel products of RWKV-6, Griffin and Whisper: their
projections, recurrences, attention heads and vocabulary split over
'model' as the sharding rules split them, with the decode state kept in the
reference's specs.

Four gloo ranks (``tests/_torch_spmd_ranks.py``'s ``tp_families`` job) on
the (1, 4) and (2, 2) meshes of ``launch.mesh.make_host_mesh``, from the
reference's parameters: each rank's gradients (reduced as the train step
reduces them) and serving logits on its ``local_shard`` under
``param_specs`` against the run on every leaf whole, its final decode state
against ``local_shard`` of the whole runs' state, the tp run's logits
against the reference's unsharded ``forward``, the vocabulary-parallel
cross-entropy on bfloat16 logits against the whole one, and the rank's
FLOPs in closed form.  The state specs are the reference's.
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest
import torch

import _torch_spmd_ranks as ranks_
from repro_torch import configs
from repro_torch.dist import sharding
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import api
from repro_torch.models import layers as L

TRAIN_TOL = 2e-5
SERVE_TOL = 1e-4
LOGIT_TOL = 1e-4   # the float32 configs' model-parity tolerance (tests/test_torch_families.py)
BF16_ULP = 2.0 ** -8
MESHES = (4, 2)    # make_host_mesh(model=...): (1, 4) and (2, 2)
# float32 configs (a bfloat16 product would round the split and the whole
# sums, float32 in another order, to neighbouring values); the shapes tp 2
# and 4 divide: RWKV's 4 heads of 32 and LoRA rank 64, Griffin's 4 q heads,
# its kv head's 32 columns and lru 128, Whisper's 4 heads
CASES = {
    # num_kv_heads = the head size, as rwkv6-7b's 64 = 64: the rules put S's
    # dk dim on 'model' (they look for the kv count from the back)
    "rwkv": ("rwkv6-7b", {"dtype": "float32", "num_kv_heads": 32}),
    # 6 layers (two rec, rec, attn groups), window 32 < the 48 training rows
    "griffin": ("recurrentgemma-9b", {"dtype": "float32"}),
    # an odd vocabulary: the tied head stays whole, as whisper-medium's 51,865
    "whisper": ("whisper-medium", {"dtype": "float32", "vocab_size": 509}),
}
# (sequences, rows) of the training batch; serving: (sequences, tokens) of
# the prompt: RWKV's 4 sequences are its layer count (the dp axes land on
# the state's layer dim, as at rwkv6-7b's prefill_32k); Whisper's are not
# (its caches' layer dim cannot take them)
SEQ = {"rwkv": (4, 16), "griffin": (4, 48), "whisper": (4, 16)}
PROMPT = {"rwkv": (4, 12), "griffin": (4, 12), "whisper": (8, 6)}
FLOP_TOKENS = (2, 16)


def _cfg(case):
    arch, over = CASES[case]
    return configs.get(arch).reduced(**over)


def _init(arch, over, i):
    import jax

    from repro import configs as jconfigs
    from repro.models import api as japi

    cfg = jconfigs.get(arch).reduced(**over)
    return cfg, jax.tree.map(np.asarray, japi.init_params(cfg, jax.random.PRNGKey(i)))


def _frames(rng, case, b):
    cfg = _cfg(case)
    return rng.normal(size=(b, cfg.source_positions, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def tpf(tmp_path_factory):
    rng = np.random.default_rng(28)
    params, batch, prompt, decode, jparams, tokens = {}, {}, {}, {}, {}, {}
    for i, (case, (arch, over)) in enumerate(sorted(CASES.items())):
        jcfg, params[case] = _init(arch, over, i)
        jparams[case] = (jcfg, params[case])
        b, t = SEQ[case]
        v = jcfg.vocab_size
        mask = (rng.random((b, t)) < 0.8).astype(np.float32)
        mask[0] = 1.0
        batch[case] = {"tokens": rng.integers(0, v, (b, t)).astype(np.int32), "mask": mask}
        prompt[case] = rng.integers(0, v, PROMPT[case]).astype(np.int32)
        decode[case] = rng.integers(0, v, (2, PROMPT[case][0], 1)).astype(np.int32)
        tokens[case] = rng.integers(0, v, FLOP_TOKENS).astype(np.int32)
        if case == "whisper":
            batch[case]["frames"] = _frames(rng, case, b)
            prompt[case] = {"tokens": prompt[case], "frames": _frames(rng, case,
                                                                     PROMPT[case][0])}
            tokens[case] = {"tokens": tokens[case], "frames": _frames(rng, case, FLOP_TOKENS[0])}
    u = {"logits": (rng.normal(size=(4, 9, 16)) * 3).astype(np.float32),
         "labels": rng.integers(0, 16, (4, 9)).astype(np.int32),
         "mask": (rng.random((4, 9)) < 0.7).astype(np.float32)}
    u["labels"][0, :8] = [0, 3, 4, 7, 8, 11, 12, 15]   # both sides of each rank boundary
    inp = {"tp_families": {"meshes": MESHES, "cases": CASES, "params": params, "batch": batch,
                           "prompt": prompt, "decode": decode, "states": True, "unit": u,
                           "flops": CASES, "tokens": tokens}}
    tmp = tmp_path_factory.mktemp("tpf")
    inputs = tmp / "inputs.pkl"
    inputs.write_bytes(pickle.dumps(inp))
    procs = ranks_.launch("tp_families", 4, tmp, inputs)
    try:
        ranks_.wait(procs, "the world-4 tp_families job")
    except RuntimeError as e:
        pytest.fail(str(e))
    return {"ranks": [r["tp_families"] for r in ranks_.load(tmp, "tp_families", 4)],
            "inp": inp["tp_families"], "jparams": jparams}


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=msg)


# -- the families on the meshes ------------------------------------------------------------

@pytest.mark.parametrize("model", MESHES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_family_gradients_equal_the_whole_run(tpf, case, model):
    """The loss, the clip's global norm and every leaf's gradient block of
    one microbatch, reduced as ``make_train_step`` reduces it, on the
    rank's ``local_shard`` with the tensor-parallel products: equal to
    ``local_shard`` of the run on whole leaves."""
    for rank in tpf["ranks"]:
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
def test_tp_family_serving_equals_the_whole_run(tpf, case, model):
    """A prefill and two decode steps with the tensor-parallel products give
    the whole run's logits, and each rank's final decode state is exactly
    its ``local_shard`` (shapes, and values within the serving limit) of
    the whole runs' state, their dp rows gathered."""
    for rank in tpf["ranks"]:
        r = rank[model][case]
        s = r["serve"]
        assert len(s["whole"]) == len(s["tp"]) == 3
        for i, (a, b) in enumerate(zip(s["whole"], s["tp"])):
            _close(b, a, SERVE_TOL, f"step {i}")
        st = r["state"]
        assert st["want"].keys() == st["got"].keys() and st["want"]
        for k, want in st["want"].items():
            assert st["got"][k].shape == want.shape, k
            _close(st["got"][k], want, SERVE_TOL, k)


@pytest.mark.parametrize("model", MESHES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_family_logits_equal_the_references_forward(tpf, case, model):
    """The tp run's full-sequence logits (each dp rank's rows) equal the
    reference's unsharded ``forward`` on the same parameters and inputs."""
    from repro.models import api as japi

    jcfg, jp = tpf["jparams"][case]
    batch = tpf["inp"]["batch"][case]
    want = np.asarray(japi.logits_fn(jcfg, jp, {k: v for k, v in batch.items()
                                                if k != "mask"})[0])
    for rank in tpf["ranks"]:
        n = batch["tokens"].shape[0] * model // 4
        d = rank[model]["coords"]["data"]
        _close(rank[model][case]["logits"], want[d * n:(d + 1) * n], LOGIT_TOL)


@pytest.mark.parametrize("model", MESHES)
def test_vocab_parallel_cross_entropy_on_bf16_logits(tpf, model):
    """Griffin's head makes bfloat16 logits: the vocabulary-parallel terms
    from the rank's bf16 block equal ``cross_entropy_terms`` of the whole
    bf16 logits, and the rank's block of the bf16 gradient is the whole
    one's within one rounding of the float32 softmax (its sums run in
    another order)."""
    u = tpf["inp"]["unit"]
    for rank in tpf["ranks"]:
        m, d = rank[model]["coords"]["model"], rank[model]["coords"]["data"]
        n = u["logits"].shape[0] * model // 4
        rows = slice(d * n, (d + 1) * n)
        logits = torch.tensor(u["logits"][rows]).to(torch.bfloat16).requires_grad_()
        total, count = L.cross_entropy_terms(logits, torch.tensor(u["labels"][rows]),
                                             torch.tensor(u["mask"][rows]))
        total.backward()
        r = rank[model]["unit"]["ce_bf16"]
        _close(r["total"], float(total.detach()), 1e-6)
        assert r["count"] == float(count) and r["grad_dtype"] == "torch.bfloat16"
        v = logits.shape[-1] // model
        want = logits.grad.float().numpy()[..., m * v:(m + 1) * v]
        np.testing.assert_allclose(r["dlogits"], want, rtol=BF16_ULP, atol=1e-7)


def _roles(specs, *path) -> dict:
    """Each leaf's ``sharding.tp_role`` under ``path`` of a spec tree, read
    off its entries as the rule does (a mesh of more than one 'model' rank)."""
    node = specs
    for k in path:
        node = node[k]
    out = {}
    for name, sp in node.items():
        e = tuple(sp)
        out[name] = ("column" if e and e[-1] == "model" else
                     "row" if len(e) >= 2 and e[-2] == "model" else None)
    return out


@pytest.mark.parametrize("model", MESHES)
def test_tp_family_cases_take_their_paths(model):
    """Every product leaf of the three cases takes the role its layer's
    tensor-parallel products need on both meshes (so no layer falls back to
    whole leaves); the heads divide over 'model'; RWKV's and Griffin's
    vocabularies split, Whisper's stays whole."""
    from repro_torch.models import encdec, griffin, rwkv

    sizes = {"data": 4 // model, "model": model}
    for case in CASES:
        cfg = _cfg(case)
        specs = sharding.param_specs(cfg, api.init_params(cfg, None, device="meta"), sizes)
        if case == "rwkv":
            groups = [(rwkv.TP_ROLES, ("blocks",))]
            assert (cfg.d_model // cfg.rwkv_head_size) % model == 0
        elif case == "griffin":
            groups = [(griffin.TP_ROLES[k], ("group", j)) for j, k in enumerate(cfg.block_pattern)]
            assert cfg.num_heads % model == 0 and cfg.num_kv_heads == 1
        else:
            groups = [(encdec.TP_ROLES[part], (part,)) for part in ("encoder", "decoder")]
            assert cfg.num_heads % model == 0 and cfg.num_kv_heads % model == 0
        for want, path in groups:
            got = _roles(specs, *path)
            assert {n: got[n] for n in want} == want, (case, path)
        split = case != "whisper"
        assert (tuple(specs["embed"])[:1] == ("model",)) == split
        if split:
            assert tuple(specs["lm_head"])[-1] == "model"
        else:
            assert cfg.vocab_size % model


# -- the state specs ---------------------------------------------------------------------

# (case, arch overrides, mesh, sequences): the test configs on the host meshes
# (the serving tests' sequences), and the full configs at prefill_32k on the
# production mesh (32 sequences: rwkv6-7b's layer count)
STATE_CELLS = [(case, CASES[case][1], sizes, PROMPT[case][0], False) for case in sorted(CASES)
               for sizes in ((2, 2), (1, 4))] + \
    [(case, {}, (16, 16), 32, True) for case in sorted(CASES)]


@pytest.mark.parametrize("case, over, mesh, b, full", STATE_CELLS,
                         ids=[f"{c[0]}-{c[2][0]}x{c[2][1]}" for c in STATE_CELLS])
def test_tp_family_state_specs_stay_the_references(case, over, mesh, b, full):
    """The decode state's specs under the rules, held ``==`` the
    reference's: RWKV's ``S`` with its dk dim on 'model' (not its heads)
    and the dp axes on the layer dim where the batch equals the layer
    count; Griffin's ``h`` / ``conv`` whole over 'model' (and its one-kv-head
    cache, which tp does not divide); Whisper's ``self_kv`` / ``cross_k`` /
    ``cross_v`` with their heads on 'model'."""
    import jax
    from jax.sharding import AbstractMesh
    from jax.sharding import PartitionSpec as P

    from repro import configs as jconfigs
    from repro.dist import sharding as jsh
    from repro.dist.treepath import path_str as jpath_str
    from repro.models import api as japi
    from repro_torch.dist import treepath

    arch = CASES[case][0]
    cfg = configs.get(arch) if full else configs.get(arch).reduced(**over)
    jcfg = jconfigs.get(arch) if full else jconfigs.get(arch).reduced(**over)
    names = ("data", "model")
    state = api.init_decode_state(cfg, b, 64, torch.float32, device="meta")
    got = {treepath.path_str(pa): tuple(sp) for pa, sp in treepath.flatten_with_path(
        sharding.cache_specs(cfg, state, dict(zip(names, mesh)), b))}
    jstate = jax.eval_shape(lambda: japi.init_decode_state(jcfg, b, 64))
    want = {jpath_str(pa): tuple(sp) for pa, sp in jax.tree_util.tree_flatten_with_path(
        jsh.cache_specs(jcfg, jstate, AbstractMesh(mesh, names), b),
        is_leaf=lambda x: isinstance(x, P))[0]}
    assert got == want
    if case == "rwkv":
        assert got["S"][2:4] == (None, "model")           # dk, not the heads
        assert got["S"][:2] == ("data", None)             # the layer dim takes dp
    elif case == "griffin":
        assert all("model" not in sp for sp in got.values())
    else:
        for name, dim in (("self_kv", 4), ("cross_k", 3), ("cross_v", 3)):
            assert got[name][dim] == "model", name


# -- the rank's FLOPs ----------------------------------------------------------------------

def _pairs(t, s, causal, window=0) -> int:
    return fa_ops.visible_pairs(t, s, causal=causal, window=window, q_offset=0, kv_len=None)


def _rank_flops(case: str, p: int) -> int:
    """One serving forward's FLOPs on a rank at tp ``p``: each product
    2 n K N over p where the rules split it (every product here), the head
    whole where the vocabulary is odd; the attention ops by their formula
    (4 hd x the visible pairs of each of the rank's heads); RWKV's wkv
    products (the intra-chunk scores are elementwise: not counted)."""
    cfg = _cfg(case)
    b, t = FLOP_TOKENS
    n = b * t
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    if case == "rwkv":
        hs = cfg.rwkv_head_size
        h, c = d // hs // p, min(16, t)
        # r, k, v, g, wo and the gate's cr; the LoRA; ck and cv; the wkv products
        layer = (2 * n * d * d * 6 // p + 2 * n * d * 64 // p * 2
                 + 2 * n * d * ff * 2 // p + 2 * n * c * h * hs + 2 * 2 * n * h * hs * hs)
        return cfg.num_layers * layer + 2 * n * d * v // p
    mlp = 2 * n * d * 2 * ff // p + 2 * n * ff * d // p
    if case == "griffin":
        w, hd = cfg.lru_width, cfg.resolved_head_dim
        q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
        rec = 2 * 2 * n * d * w // p + 2 * 2 * n * w * w // p + 2 * n * w * d // p + mlp
        att = (2 * n * d * q // p + 2 * 2 * n * d * kv // p + 2 * n * q * d // p + mlp
               + 4 * hd * b * cfg.num_heads // p * _pairs(t, t, True, cfg.sliding_window))
        kinds = cfg.layer_kinds()
        return kinds.count("rec") * rec + kinds.count("attn") * att + 2 * n * d * v // p
    hd, h, s = cfg.resolved_head_dim, cfg.num_heads, cfg.source_positions
    m = b * s
    proj = 2 * d * h * hd // p
    enc = 4 * m * proj + 2 * m * d * 2 * ff // p + 2 * m * ff * d // p \
        + 4 * hd * b * h // p * _pairs(s, s, False)
    dec = (6 * n * proj + 2 * m * proj + mlp + 4 * hd * b * h // p * _pairs(t, t, True)
           + 4 * hd * b * h // p * _pairs(t, s, False))
    return cfg.encoder_layers * enc + cfg.num_layers * dec + 2 * n * d * v


@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_family_rank_flops_in_closed_form(tpf, case):
    """``hlo_analysis.count_step`` of a serving forward at tp 4 counts, on
    every rank, a quarter of each product, the rank's heads' attention and
    recurrence products, and Whisper's odd-vocabulary head whole."""
    want = _rank_flops(case, 4)
    assert want < _rank_flops(case, 1)
    for rank in tpf["ranks"]:
        assert rank[4]["flops"][case] == want


# -- the dry-run records -------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-9b", "whisper-medium"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_tp_family_records_within_the_references_work(arch, shape):
    """The committed rank (0, 0) records of the 16 x 16 mesh
    (``python -m repro_torch.launch.dryrun``): a rank's FLOPs at most 1.5x
    the reference's compiled ``roofline.flops_per_device`` (4.3-20x while
    these families gathered every leaf whole), and the two ranks that did
    not fit the card (recurrentgemma-9b ``train_4k``, 93.4 GB; rwkv6-7b
    ``prefill_32k``, 87.1 GB) estimated under 75 GB."""
    import json
    from pathlib import Path

    root = Path(__file__).resolve().parents[1] / "experiments"
    name = f"{arch}__{shape}__16x16.json"
    port = json.loads((root / "dryrun_torch" / name).read_text())
    ref = json.loads((root / "dryrun" / name).read_text())
    assert port["cost_analysis"]["flops"] <= 1.5 * ref["roofline"]["flops_per_device"]
    if (arch, shape) in (("recurrentgemma-9b", "train_4k"), ("rwkv6-7b", "prefill_32k")):
        assert port["memory_analysis"]["peak_bytes_per_device"] < 75e9
