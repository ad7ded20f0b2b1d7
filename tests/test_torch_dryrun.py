"""The dry-run slice: gather at use, the attention custom ops, the
fixed-length expert counts, ``launch.dryrun.trace_cell`` on the fake 16 x 16
mesh, the attention islands of the training and the MoE serving ranks
``chip_smoke.py`` runs on the card against the rows it times, and the committed
``experiments/dryrun_torch/*.json`` against the reference's
``experiments/dryrun/*.json``.

The sharded step and serving (the MoE families' through the
expert-parallel dispatch) run on four gloo ranks
(``tests/_torch_spmd_ranks.py``'s ``sharded`` job) from the reference's
parameters; the traces run in child
processes, because the fake process group is a process's default group.
"""

from __future__ import annotations

import dataclasses
import json
import pickle
import random
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _torch_spmd_ranks as ranks_
from _torch_spmd_ranks import OPT, REPO
from repro_torch import configs
from repro_torch.dist import sharding
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_r
from repro_torch.launch import dryrun, hlo_analysis, shapes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import moe
from repro_torch.train.optimizer import OptConfig

TRAIN_TOL = 2e-5
SERVE_TOL = 1e-4
# the training cases: (arch, optimizer state type, config overrides, AdamW
# eps).  The sharded step runs the tensor-parallel products, whose partial
# sums meet in another order than the whole product's.  At the configs' own
# dtype (bfloat16 products) and AdamW's eps the two steps' gradients agree to
# bfloat16 rounding; the "_f32" cases (float32 products and storage, eps
# above float32 rounding) hold the whole step at TRAIN_TOL.
F32 = {"dtype": "float32", "param_dtype": "float32"}
# a leaf's reduced gradients at bfloat16: within one bfloat16 ulp (2^-7) of
# its largest (measured on the CPU: up to 3.9e-3 of it, at qwen3-moe's wo_att)
GRAD_TOL = 2.0 ** -7
CLIP = OptConfig(**OPT).grad_clip
CASES = {"dense": ("minicpm-2b", "float32", {}, 1e-8),
         "dense_int8": ("minicpm-2b", "int8", {}, 1e-8),
         "moe": ("qwen3-moe-235b-a22b", "float32", {}, 1e-8),
         "dense_f32": ("minicpm-2b", "float32", F32, 1e-5),
         "dense_int8_f32": ("minicpm-2b", "int8", F32, 1e-5),
         "moe_f32": ("qwen3-moe-235b-a22b", "float32", F32, 1e-5)}
# serving: the KV cache's kv heads (minicpm-2b), RWKV-6's wkv state (its
# head dim) and Whisper's self and cross caches are sharded over 'model'
# (and, with as many layers as the batch has sequences, RWKV-6's state
# leaves get the dp axes on their layer dim, as rwkv6-7b's prefill_32k does)
# float32 compute and caches: a bf16 cache would round the sharded and the
# whole run's k/v (float32 sums in another order) to neighbouring values.
# The MoE families run the expert-parallel dispatch over the joint ('data',
# 'model') axis, as the production ranks do: qwen3-moe on the 8 shared
# sequences, kimi-k2 (its shared expert, no qk-norm, int8 moments) on the
# first 6, so that each data rank's decode step hands the dispatch 3 tokens,
# which it pads to a multiple of the replicated 'model' axis's 2 (the
# production decode rank's 8 tokens over 16); 8 sequences give 4 a rank.
# (arch, config overrides, sequences, the seed of its reference weights)
SERVE = {"dense": ("minicpm-2b", {"dtype": "float32"}, 8, 1), "ssm": ("rwkv6-7b", {}, 8, 2),
         "ssm_layer_dim": ("rwkv6-7b", {"num_layers": 8}, 8, 3),
         "audio": ("whisper-medium", {"dtype": "float32"}, 8, 0),
         "moe": ("qwen3-moe-235b-a22b", {"dtype": "float32"}, 8, 4),
         "moe_kimi": ("kimi-k2-1t-a32b", {"dtype": "float32"}, 6, 5)}
ARTIFACTS = REPO / "experiments" / "dryrun_torch"
REFERENCE = REPO / "experiments" / "dryrun"


# -- (1) the sharded step and serving on four gloo ranks ------------------------------

@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    import jax

    from repro import configs as jconfigs
    from repro.models import api as japi

    rng = np.random.default_rng(26)
    def init(arch, i, **over):
        return jax.tree.map(np.asarray, japi.init_params(jconfigs.get(arch).reduced(**over),
                                                         jax.random.PRNGKey(i)))

    seeds = {"minicpm-2b": 0, "qwen3-moe-235b-a22b": 1}
    params = {case: init(arch, seeds[arch], **over) for case, (arch, _, over, _) in CASES.items()}
    serve_params = {case: init(arch, seed, **over) for case, (arch, over, _, seed) in SERVE.items()}
    wcfg = jconfigs.get("whisper-medium").reduced()
    inp = {"opt": OPT, "sharded": {
        "cases": CASES, "serve": {case: v[:3] for case, v in SERVE.items()}, "params": params,
        "serve_params": serve_params,
        "frames": rng.normal(size=(8, wcfg.source_positions, wcfg.d_model)).astype(np.float32),
        "batch": {"tokens": rng.integers(0, 512, (8, 16)).astype(np.int32),
                  "mask": (rng.random((8, 16)) < 0.8).astype(np.float32)},
        "prompt": rng.integers(0, 512, (8, 12)).astype(np.int32),
        "decode": rng.integers(0, 512, (2, 8, 1)).astype(np.int32)}}
    tmp = tmp_path_factory.mktemp("sharded")
    inputs = tmp / "inputs.pkl"
    inputs.write_bytes(pickle.dumps(inp))
    procs = ranks_.launch("sharded", 4, tmp, inputs)
    try:
        ranks_.wait(procs, "the world-4 sharded job")
    except RuntimeError as e:
        pytest.fail(str(e))
    return [r["sharded"] for r in ranks_.load(tmp, "sharded", 4)]


def _first_step(g, gnorm, eps):
    """AdamW's first normalized step, m^ / (sqrt(v^) + eps) = g c / (|g c| +
    eps) with c the clip factor, from a run's reduced gradient and norm."""
    gc = g.astype(np.float64) * min(1.0, CLIP / max(gnorm, 1e-9))
    return gc / (np.abs(gc) + eps)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_equals_replicated(sharded, case):
    """One train step on each rank's ``local_shard`` of params and optimizer
    state (gathered at use) leaves every block equal to ``local_shard`` of
    the step with every leaf whole, on every rank of the (2, 2) mesh; the
    loss is the same.  int8 moments: the quantized blocks within one step
    (a clip factor a rounding apart may move a value across a half), the
    scales at 2e-5.

    The "_f32" cases hold the reduced gradients, the clip's norm and every
    block at 2e-5.  At the configs' own dtype each leaf's reduced gradient
    is within GRAD_TOL of its largest, and the clip's norm within GRAD_TOL;
    the moments at 2e-5; a parameter within 2e-5 of the whole step's plus
    lr times the difference of the two runs' first AdamW steps (each from
    its own gradient: near zero, g / (|g| + 1e-8) turns a rounding into up
    to a whole step) plus, for a bfloat16 leaf, one ulp of its storage."""
    eps, f32 = CASES[case][3], bool(CASES[case][2])
    for rank in sharded:
        r = rank[case]
        assert r["loss"][0] == r["loss"][1]
        gw, gs = r["grads"]
        assert gw.keys() == gs.keys()
        np.testing.assert_allclose(r["gnorm"][1], r["gnorm"][0],
                                   rtol=TRAIN_TOL if f32 else GRAD_TOL)
        for k, want in gw.items():
            got = gs[k]
            assert got.shape == want.shape, k
            if f32:
                np.testing.assert_allclose(got, want, rtol=TRAIN_TOL, atol=TRAIN_TOL, err_msg=k)
            else:
                assert np.abs(got - want).max() <= GRAD_TOL * np.abs(want).max(), k
        assert r["want"].keys() == r["got"].keys()
        for k, want in r["want"].items():
            got = r["got"][k]
            assert got.shape == want.shape and got.dtype == want.dtype, k
            if want.dtype == np.int8:
                assert np.abs(got.astype(np.int32) - want).max() <= 1, k
            elif f32 or not k.startswith("params/"):
                np.testing.assert_allclose(got, want, rtol=TRAIN_TOL, atol=TRAIN_TOL, err_msg=k)
            else:
                leaf = k[len("params/"):]
                room = r["lr"] * np.abs(_first_step(gs[leaf], r["gnorm"][1], eps)
                                        - _first_step(gw[leaf], r["gnorm"][0], eps))
                if k in r["bf16"]:  # float32 spacing x 2^16 is bfloat16's
                    room += np.spacing(np.maximum(np.abs(got), np.abs(want))) * 2.0 ** 16
                diff = np.abs(got.astype(np.float64) - want)
                assert np.all(diff <= TRAIN_TOL * (1 + np.abs(want)) + room), k


@pytest.mark.parametrize("case", sorted(SERVE))
def test_sharded_serving_equals_whole(sharded, case):
    """A prefill and two decode steps on sharded params and decode state
    (gathered at use, the rank's block of the new state written back) give
    the logits of the run on whole leaves.  The MoE families' layers go
    through the expert-parallel dispatch in both runs, every layer of every
    step; kimi-k2's decode steps hand it a token count that the replicated
    'model' axis does not divide, so that it pads them."""
    arch, _, seqs, _ = SERVE[case]
    layers = configs.get(arch).reduced().num_layers
    for rank in sharded:
        whole, shard = rank["serve"][case]["whole"], rank["serve"][case]["sharded"]
        assert len(whole) == len(shard) == 3
        for a, b in zip(whole, shard):
            np.testing.assert_allclose(b, a, rtol=SERVE_TOL, atol=SERVE_TOL)
        tokens = rank["serve"][case]["ep_tokens"]
        if configs.get(arch).family != "moe":
            assert tokens["whole"] == tokens["sharded"] == [[], [], []]
            continue
        # a data rank's sequences: the prompt's 12 tokens, then one a step
        want = [[seqs // 2 * t] * layers for t in (12, 1, 1)]
        assert tokens["whole"] == tokens["sharded"] == want
        assert any(n % 2 for n, *_ in want) == (case == "moe_kimi")


# -- (2) the attention custom ops ------------------------------------------------------

OP_CASES = [
    dict(b=2, tq=48, tk=48, h=4, kvh=2, hd=32, causal=True, window=0, q_offset=0, kv_len=None),
    dict(b=1, tq=16, tk=64, h=4, kvh=1, hd=64, causal=True, window=20, q_offset=40, kv_len=57),
    dict(b=2, tq=24, tk=40, h=2, kvh=2, hd=32, causal=False, window=0, q_offset=0, kv_len=None),
]


def _qkv(c, kv_dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(c["b"], c["tq"], c["h"], c["hd"], generator=g)
    k, v = (torch.randn(c["b"], c["tk"], c["kvh"], c["hd"], generator=g).to(kv_dtype)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("i", range(len(OP_CASES)))
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_custom_ops_equal_the_plain_version_bit_for_bit(i, kv_dtype):
    """On CPU tensors each op's implementation is the plain version: its
    outputs are the plain version's, bit for bit (forward, forward + lse,
    backward, head-major)."""
    c = OP_CASES[i]
    q, k, v = _qkv(c, kv_dtype, seed=i)
    kw = dict(causal=c["causal"], window=c["window"], q_offset=c["q_offset"])
    assert torch.equal(fa_ops.flash_attention(q, k, v, kv_len=c["kv_len"], **kw),
                       fa_r.attention_ref(q, k, v, kv_len=c["kv_len"], **kw))
    o, lse = torch.ops.repro_torch.flash_attention_lse(q, k, v, c["causal"], c["window"], 0.0,
                                                       c["q_offset"])
    o_r, lse_r = fa_r.attention_lse_ref(q, k, v, **kw)
    assert torch.equal(o, o_r) and torch.equal(lse, lse_r)
    if c["causal"] and not 0 <= c["q_offset"] <= c["tk"] - c["tq"]:
        return
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(9))
    got = torch.ops.repro_torch.flash_attention_bwd(q, k, v, o, lse, do, c["causal"],
                                                    c["window"], 0.0, c["q_offset"])
    exp = fa_r.attention_bwd_ref(q, k, v, o_r, lse_r, do, **kw)
    for a, e, t in zip(got, exp, (q, k, v)):
        assert a.dtype == t.dtype and torch.equal(a, e.to(t.dtype))
    # the head-major contract: [B KV, G Tq, hd]
    g = c["h"] // c["kvh"]
    qh = q.permute(0, 2, 1, 3).reshape(c["b"] * c["h"], c["tq"], c["hd"])
    kh, vh = (t.permute(0, 2, 1, 3).reshape(c["b"] * c["kvh"], c["tk"], c["hd"]) for t in (k, v))
    kv_len = c["kv_len"] or c["tk"]
    hk = dict(groups=g, causal=c["causal"], window=c["window"])
    assert torch.equal(fa_ops.flash_attention_heads(qh, kh, vh, kv_len, **hk),
                       fa_r.attention_heads_ref(qh, kh, vh, kv_len, **hk))


def test_visible_pairs_closed_form_equals_the_mask():
    """``ops.visible_pairs`` equals the row sums of ``ref.key_mask`` (a row
    that sees no key counted as Tk) over random masks of every kind."""
    rnd = random.Random(26)
    for _ in range(1500):
        tq, tk = rnd.randint(1, 70), rnd.randint(1, 90)
        kw = dict(causal=rnd.random() < 0.7, window=rnd.choice([0, 0, rnd.randint(1, 40)]),
                  q_offset=rnd.randint(-10, 100), kv_len=rnd.choice([None, rnd.randint(0, 100)]))
        rows = fa_r.key_mask(tq, tk, device="cpu", **kw).sum(1)
        assert fa_ops.visible_pairs(tq, tk, **kw) == int(torch.where(rows > 0, rows, tk).sum())


def _flash_work(q_shape, k_shape, **kw) -> int:
    sys.path.insert(0, str(REPO))
    import chip_smoke

    # flash_work reads shapes only: zero-stride tensors of the kernel phase's shapes
    q, k = (torch.zeros(1).expand(s) for s in (q_shape, k_shape))
    return chip_smoke.flash_work(torch, q, k, **kw)[1]


# the kernel phase's shapes (chip_smoke.py phase 5): q, k, mask
KERNEL_SHAPES = {
    "prefill_local": ((4, 4096, 8, 256), (4, 4128, 4, 256),
                      dict(causal=True, window=1024, q_offset=0, kv_len=4096)),
    "decode": ((4, 1, 8, 256), (4, 4128, 4, 256),
               dict(causal=True, window=0, q_offset=4096, kv_len=4097)),
    "prefill_global_32k": ((1, 512, 8, 256), (1, 32768, 4, 256),
                           dict(causal=True, window=0, q_offset=32256, kv_len=32768)),
    "whisper_encoder": ((4, 1500, 16, 64), (4, 1500, 16, 64),
                        dict(causal=False, window=0, q_offset=0, kv_len=None)),
}


@pytest.mark.parametrize("cell", sorted(KERNEL_SHAPES))
def test_flop_formula_equals_flash_work(cell):
    """``FlopCounterMode`` counts a forward call on fake tensors as
    ``chip_smoke.flash_work``'s operations at the kernel phase's shapes,
    and the backward as 10 / 4 of the forward's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    q_shape, k_shape, kw = KERNEL_SHAPES[cell]
    with FakeTensorMode():
        q, k = torch.empty(q_shape), torch.empty(k_shape, dtype=torch.bfloat16)
        with FlopCounterMode(display=False) as fc:
            fa_ops.flash_attention(q, k, k, **kw)
        fwd = fc.get_total_flops()
        if kw["kv_len"] in (None, k_shape[1]) and kw["q_offset"] + q_shape[1] <= k_shape[1]:
            with FlopCounterMode(display=False) as fc:
                o, lse = torch.ops.repro_torch.flash_attention_lse(
                    q, k, k, kw["causal"], kw["window"], 0.0, kw["q_offset"])
                torch.ops.repro_torch.flash_attention_bwd(q, k, k, o, lse, q, kw["causal"],
                                                          kw["window"], 0.0, kw["q_offset"])
            assert fc.get_total_flops() == fwd + fwd * 10 // 4
    assert fwd == _flash_work(q_shape, k_shape, **kw)


# backward islands: q, k/v, k/v type, mask, the keys some query sees
BWD_ISLANDS = {
    "starcoder2_rank_seq0": ((4, 256, 24, 128), (4, 4096, 2, 128), torch.float32,
                             dict(causal=True, q_offset=0), 256),
    "starcoder2_rank_seq3840": ((4, 256, 24, 128), (4, 4096, 2, 128), torch.float32,
                                dict(causal=True, q_offset=3840), 4096),
    "whisper_rank_cross": ((4, 4096, 1, 64), (4, 1500, 1, 64), torch.bfloat16,
                           dict(causal=False, q_offset=0), 1500),
}


@pytest.mark.parametrize("cell", sorted(BWD_ISLANDS))
def test_backward_bytes_read_only_the_visible_keys(cell):
    """``chip_smoke.flash_bwd_bytes``: q, o, dO and dQ float32, k and v read
    over the keys some query sees (at q_offset 0 a sequence island's 256
    rows see 256 of 4096), dK and dV written whole in k's type, lse."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    q_shape, k_shape, dtype, kw, keys = BWD_ISLANDS[cell]
    (b, tq, h, hd), (_, tk, kvh, _) = q_shape, k_shape
    q, k = torch.zeros(1).expand(q_shape), torch.zeros(1, dtype=dtype).expand(k_shape)
    lse = torch.zeros(1).expand(b, h, tq)
    mask = fa_r.key_mask(tq, tk, window=0, kv_len=None, device="cpu", **kw)
    es = k.element_size()
    want = 16 * q.numel() + 2 * b * kvh * hd * keys * es + 2 * k.numel() * es + 4 * b * h * tq
    assert chip_smoke.flash_bwd_bytes(q, k, lse, mask) == want


# -- (3) the fixed-length expert counts -------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 130])
def test_expert_counts_equal_bincount(n):
    idx = torch.randint(0, n, (4096,), generator=torch.Generator().manual_seed(n))
    idx[:3] = 0
    got = moe._counts(idx, n)
    assert got.dtype == torch.int64 and torch.equal(got, torch.bincount(idx, minlength=n))


# -- (4) trace_cell on the fake 16 x 16 mesh ----------------------------------------

TRACE = r'''
import json, sys
import torch
from repro_torch import configs
from repro_torch.dist import sharding
from repro_torch.kernels.flash_attention import ref
from repro_torch.launch import dryrun, shapes
from repro_torch.launch.mesh import make_production_mesh

def refuse(*a, **k):
    raise AssertionError("a plain attention version was called")

for name in ("attention_ref", "attention_lse_ref", "attention_bwd_ref", "attention_heads_ref"):
    setattr(ref, name, refuse)
coords = json.loads(sys.argv[1])
cfg = configs.get("minicpm-2b").reduced()
cell = shapes.ShapeCell("t", "train", 2048, 32, microbatches=2)
mesh = make_production_mesh()
rc, st = dryrun.trace_cell(cfg, cell, mesh, coords)
sizes = mesh.shape
p, o = shapes.params_specs(cfg), shapes.opt_state_specs(cfg)
b = shapes.input_specs(cfg, cell)
local = [sharding.local_shard(t, s, sizes, coords) for t, s in (
    (p, sharding.param_specs(cfg, p, sizes)), (o, sharding.param_specs(cfg, o, sizes)),
    (b, sharding.batch_specs(cfg, b, sizes)))]
print(json.dumps({
    "args": sum(dryrun.tree_bytes(t) for t in rc.args.values()),
    "local_shard": sum(dryrun.tree_bytes(t) for t in local),
    "flops": st.flops, "wire": st.collective_wire_bytes, "peak": st.peak_bytes,
    "counts": st.collective_counts,
    "scores": 32 // 16 // 2 * cfg.num_heads * 2048 * 2048 * 4}))
'''


@pytest.fixture(scope="module")
def traces():
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}
    procs = {c: subprocess.Popen([sys.executable, "-c", textwrap.dedent(TRACE),
                                  json.dumps(dict(zip(("data", "model"), c)))],
                                 env=env, cwd=REPO, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for c in ((0, 0), (9, 13))}
    out = {}
    for c, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-4000:]
        out[c] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("coords", [(0, 0), (9, 13)])
def test_trace_cell_on_the_fake_production_mesh(traces, coords):
    """A reduced minicpm-2b train step, one rank of the 16 x 16 mesh on fake
    tensors: its argument bytes are the ``local_shard`` byte sum, it does
    work and moves bytes, no plain attention version runs (the fakes reach
    the ops' fake implementations), and its peak stays below one layer's
    T x T float32 scores (the fused kernel never holds them)."""
    t = traces[coords]
    assert t["args"] == t["local_shard"] > 0
    assert t["flops"] > 0 and t["wire"] > 0
    assert set(t["counts"]) >= {"all-gather", "reduce-scatter", "all-reduce"}
    assert 0 < t["peak"] < t["scores"]


# the training ranks the dryrun phase added with every architecture: (cell,
# the TP_RANK_SHAPES row of rank (0, 0)'s island, or None: no attention)
RANK_CELLS = {"qwen3-moe-235b-a22b": "qwen3_rank_train", "h2o-danube-3-4b": "h2o_rank_train",
              "starcoder2-3b": "starcoder2_rank_seq0", "internvl2-2b": "internvl2_rank_train",
              "rwkv6-7b": None}
# the MoE serving ranks of the dryrun phase (chip_smoke.DRYRUN_SERVE_CELLS):
# the TP_RANK_SHAPES row of rank (0, 0)'s attention call (forward only)
SERVE_RANK_CELLS = {"qwen3-moe-235b-a22b/prefill_32k": "qwen3_rank_prefill",
                    "qwen3-moe-235b-a22b/decode_32k": "qwen3_rank_decode",
                    "kimi-k2-1t-a32b/prefill_32k": "kimi_rank_prefill",
                    "kimi-k2-1t-a32b/decode_32k": "kimi_rank_decode"}
# each cell's rank (0, 0) at 1 and 2 layers (rwkv6-7b, 7.8 s a layer, at 1;
# a serving step under no_grad, as the card runs it): the attention custom
# ops it calls, counted by (op, q, k/v, kv type, mask, kv_len), and the
# strides of the k each hands the op
RANK_TRACE = r"""
import dataclasses, json, sys
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch import configs
from repro_torch.launch import dryrun, shapes
from repro_torch.launch.mesh import make_production_mesh


class Calls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen, self.strides = {}, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "repro_torch":
            name = func.overloadpacket.__name__
            causal, window, _, q_offset, *kv_len = args[3 if name != "flash_attention_bwd" else 6:]
            key = json.dumps([name, list(args[0].shape), list(args[1].shape),
                              str(args[1].dtype).split(".")[1], causal, window, q_offset,
                              kv_len[0] if kv_len else None])
            self.seen[key] = self.seen.get(key, 0) + 1
            self.strides.setdefault(key, []).append(list(args[1].stride()))
        return func(*args, **(kwargs or {}))


mesh, coords = make_production_mesh(), {"data": 0, "model": 0}
mesh_dev = dryrun.fake_mesh(mesh, coords)
out, strides = {}, {}
for name in sys.argv[1:]:
    arch, shape = name.split("/")
    for layers in ((1,) if arch == "rwkv6-7b" else (1, 2)):
        cfg = dataclasses.replace(configs.get(arch), num_layers=layers)
        rc = dryrun.rank_cell(cfg, shapes.SHAPES[shape], mesh, coords)
        calls = Calls()
        with FakeTensorMode():
            args = dryrun.materialize(rc, lambda t: torch.empty(t.shape, dtype=t.dtype))
            step = dryrun.rank_step(cfg, rc, mesh_dev, args)
            with torch.no_grad() if rc.kind != "train" else torch.enable_grad(), calls:
                step()
        out[f"{name}/{layers}"] = calls.seen
        strides[f"{name}/{layers}"] = calls.strides
print(json.dumps({"calls": out, "strides": strides}))
"""


@pytest.fixture(scope="module")
def rank_calls():
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}
    cells = [f"{arch}/train_4k" for arch in RANK_CELLS] + list(SERVE_RANK_CELLS)
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(RANK_TRACE), *cells],
                          env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    def key(c):   # (op, q shape, k/v shape, kv type, causal, window, q_offset, kv_len)
        return tuple(tuple(x) if isinstance(x, list) else x for x in json.loads(c))

    got = json.loads(proc.stdout.strip().splitlines()[-1])
    return ({k: {key(c): n for c, n in v.items()} for k, v in got["calls"].items()},
            {k: {key(c): s for c, s in v.items()} for k, v in got["strides"].items()})


@pytest.mark.parametrize("arch", sorted(RANK_CELLS))
def test_rank_islands_are_the_ones_the_card_times(rank_calls, arch):
    """Each training rank the dryrun phase added, traced at (0, 0) on fake
    tensors at 1 and 2 layers: every attention call it makes is the island
    ``chip_smoke.TP_RANK_SHAPES`` holds and times for the cell (q, k/v, kv
    type, mask; starcoder2-3b's sequence island also at model rank 15's
    q_offset), each layer
    makes the same calls and nothing else does, and at the config's depth
    they are ``DRYRUN_LAUNCHES``'s flash calls by design: the rows timed
    are the ones the rank runs, as often as the card's step must."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    from repro_torch.kernels.flash_attention import kernel as fa_k

    assert (arch, "train_4k", arch in ("h2o-danube-3-4b", "starcoder2-3b", "internvl2-2b")) \
        in chip_smoke.DRYRUN_CELLS
    want = chip_smoke.DRYRUN_LAUNCHES[f"{arch}/train_4k"]
    calls = rank_calls[0]
    if RANK_CELLS[arch] is None:
        assert calls[f"{arch}/train_4k/1"] == {} and want == {}
        return
    one, two = calls[f"{arch}/train_4k/1"], calls[f"{arch}/train_4k/2"]
    assert one and two == {c: 2 * n for c, n in one.items()}   # per layer, nothing outside
    row = next(r for r in chip_smoke.TP_RANK_SHAPES if r[0] == RANK_CELLS[arch])
    _, q_shape, kv_shape, kv_dtype, mask, _, _, _ = row
    island = (q_shape, kv_shape, kv_dtype, mask["causal"], mask["window"],
              mask.get("q_offset", 0), None)
    assert {c[1:] for c in one} == {island}
    assert {c[0] for c in one} == {"flash_attention_lse", "flash_attention_bwd"}
    layers = configs.get(arch).num_layers
    hd, rows_per_kv = q_shape[3], q_shape[1] * q_shape[2] // kv_shape[2]
    designs = {fa_k.fwd_design(hd, getattr(torch, kv_dtype), rows_per_kv, lse=True):
               layers * one[("flash_attention_lse", *island)],
               fa_k.bwd_design(hd): layers * one[("flash_attention_bwd", *island)]}
    assert designs == want
    if mask.get("q_offset") is not None:   # a sequence island, at model rank 0 and 15
        cfg = configs.get(arch)
        assert q_shape == (4, 256, cfg.num_heads, cfg.resolved_head_dim)
        assert kv_shape == (4, 4096, cfg.num_kv_heads, cfg.resolved_head_dim)
        seq = [r for r in chip_smoke.TP_RANK_SHAPES if r[0].startswith("starcoder2_rank_seq")]
        assert {r[4]["q_offset"] for r in seq} == {0, 3840}
        assert all(r[1:4] == row[1:4] for r in seq)
        assert all(i[0] != arch for i in chip_smoke.DRYRUN_ISLANDS)   # held once


@pytest.mark.parametrize("cell", sorted(SERVE_RANK_CELLS))
def test_serving_islands_are_the_ones_the_card_times(rank_calls, cell):
    """Each MoE serving rank of the dryrun phase, traced at (0, 0) on fake
    tensors at 1 and 2 layers under no_grad: every attention call it makes
    is the forward-only row ``chip_smoke.TP_RANK_SHAPES`` holds and times for
    the cell (q, k/v, kv type, mask, q_offset, kv_len), its k/v kv head 0 of
    a bf16 cache of every kv head (the strides the row's k/v view has: no
    copy of the cache), each layer makes the same call and nothing else
    does, and at the config's depth the calls by design are
    ``DRYRUN_LAUNCHES``'s."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    from repro_torch.kernels.flash_attention import kernel as fa_k

    arch, shape = cell.split("/")
    assert (arch, shape, False) in chip_smoke.DRYRUN_SERVE_CELLS
    calls, strides = rank_calls
    one, two = calls[f"{cell}/1"], calls[f"{cell}/2"]
    assert one and two == {c: 2 * n for c, n in one.items()}   # per layer, nothing outside
    row = next(r for r in chip_smoke.TP_RANK_SHAPES if r[0] == SERVE_RANK_CELLS[cell])
    _, q_shape, kv_shape, kv_dtype, mask, path, _, heads = row
    call = ("flash_attention", q_shape, kv_shape, kv_dtype, mask["causal"], mask["window"],
            mask["q_offset"], mask["kv_len"])
    assert set(one) == {call} and one[call] == 1 and path == "dryrun_rank"
    cfg = configs.get(arch)
    b, tk, _, hd = kv_shape
    assert heads == cfg.num_kv_heads and hd == cfg.resolved_head_dim
    assert q_shape[2] == cfg.num_heads // 16   # the rank's q heads, tp 16
    assert tk == mask["kv_len"] == shapes.SHAPES[shape].seq_len
    for n in (1, 2):
        assert strides[f"{cell}/{n}"][call] == [[tk * heads * hd, heads * hd, hd, 1]] * n
    design = fa_k.fwd_design(hd, getattr(torch, kv_dtype), q_shape[1] * q_shape[2] // kv_shape[2])
    assert {design: cfg.num_layers * one[call]} == chip_smoke.DRYRUN_LAUNCHES[cell]


# -- (4b) run_cell's variant and overrides against the reference's run_cell -------------

RUN_CELL = r"""
import dataclasses, json, sys
pkg, arch, shape, variant, overrides = json.loads(sys.argv[1])
if pkg == "repro":
    from repro.launch import dryrun
else:
    from repro_torch.launch import dryrun

class Stop(Exception):
    pass

seen = {}
def spy(cfg, cell, mesh, *a, microbatches=None, **k):
    seen.update(config=dataclasses.asdict(cfg), microbatches=microbatches, cell=cell.name)
    raise Stop
def keep(tag, record, save):
    seen.update(tag=tag, record=record, save=save)
if pkg == "repro":
    dryrun.lower_cell = spy
else:
    dryrun.trace_cell = spy
dryrun._save = keep
try:
    returned = dryrun.run_cell(arch, shape, save=False, variant=variant, overrides=overrides)
except Stop:
    returned = None
rec = seen["record"]
print(json.dumps({"tag": seen["tag"], "variant": rec["variant"], "status": rec["status"],
                  "returned": returned is not None, "config": seen.get("config"),
                  "microbatches": seen.get("microbatches"), "cell": seen.get("cell")}))
"""

RUN_CELL_CASES = {
    "skipped": ("minicpm-2b", "long_500k", "optimized", None),
    "overrides": ("minicpm-2b", "train_4k", "mb8", {"microbatches": 8, "num_layers": 3}),
    "baseline": ("whisper-medium", "train_4k", "baseline", {"remat": False}),
}


def _run_cell(pkg: str, case: tuple) -> dict:
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
           "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_force_host_platform_device_count=256"}
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(RUN_CELL),
                           json.dumps([pkg, *case])], env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", sorted(RUN_CELL_CASES))
def test_run_cell_variant_and_overrides_are_the_references(case):
    """``run_cell(variant=, overrides=)`` (C 7): a variant other than
    "baseline" tags the record ``{arch}__{shape}__16x16__{variant}`` and
    stores it under "variant"; ``overrides`` hands its ``microbatches`` to the
    trace and replaces the other fields of the config; each as the
    reference's ``run_cell`` does (on 256 host devices, its lowering stopped
    where the port's trace is), nothing traced or saved."""
    arch, shape, variant, overrides = RUN_CELL_CASES[case]
    got, ref = _run_cell("repro_torch", RUN_CELL_CASES[case]), _run_cell("repro", RUN_CELL_CASES[case])
    tag = f"{arch}__{shape}__16x16" + ("" if variant == "baseline" else f"__{variant}")
    assert got["tag"] == ref["tag"] == tag
    assert got["variant"] == ref["variant"] == variant
    if case == "skipped":
        assert got["status"] == ref["status"] == "skipped" and got["returned"] and ref["returned"]
        assert got["config"] is None and ref["config"] is None
        return
    assert got["status"] == ref["status"] == "error" and not got["returned"]
    assert got["cell"] == ref["cell"] == shape
    assert got["microbatches"] == ref["microbatches"] == (overrides or {}).get("microbatches")
    whole = json.loads(json.dumps(dataclasses.asdict(configs.get(arch))))
    want = {k: v for k, v in overrides.items() if k != "microbatches"}
    for k in whole:
        assert got["config"][k] == (want[k] if k in want else whole[k]), k
    assert {k: ref["config"][k] for k in want} == want


# -- (5) the committed artifacts --------------------------------------------------------

def _artifacts() -> dict:
    return {p.name: json.loads(p.read_text()) for p in sorted(ARTIFACTS.glob("*.json"))}


def test_artifacts_split_and_reasons():
    """40 records, 34 ``ok`` and 6 ``skipped``, each skip with
    ``cell_supported``'s reason and the reference record's."""
    arts = _artifacts()
    assert len(arts) == 40
    assert sum(a["status"] == "ok" for a in arts.values()) == 34
    for name, a in arts.items():
        ok, reason = shapes.cell_supported(configs.get(a["arch"]), shapes.SHAPES[a["shape"]])
        ref = json.loads((REFERENCE / name).read_text())
        assert a["status"] == ("ok" if ok else "skipped") == ref["status"], name
        if not ok:
            assert a["reason"] == reason == ref["reason"], name
        else:
            assert a["memory_analysis"]["peak_bytes_per_device"] > 0, name
            assert a["cost_analysis"]["flops"] > 0, name


def test_argument_bytes_equal_the_references():
    """``argument_size_bytes`` is the reference's compiled figure in every ok
    cell, less the 4 bytes of its int32 ``len`` where the port's state has
    it as a host int (decode; RWKV's and Griffin's prefill).  Whisper's two
    serving cells hold what the reference's compiled program drops because
    it never reads it: at prefill the cross K/V state (only written), at
    decode the encoder, its norm and the decoder's cross projections."""
    mesh = make_production_mesh()
    coords = {"data": 0, "model": 0}
    unread_of = {}
    for name, a in _artifacts().items():
        if a["status"] != "ok":
            continue
        ref = json.loads((REFERENCE / name).read_text())["memory_analysis"]["argument_size_bytes"]
        cfg, cell = configs.get(a["arch"]), shapes.SHAPES[a["shape"]]
        got = a["memory_analysis"]["argument_size_bytes"]
        rc = dryrun.rank_cell(cfg, cell, mesh, coords)
        assert got == sum(dryrun.tree_bytes(t) for t in rc.args.values()), name
        has_len = cell.kind == "decode" or (cell.kind == "prefill"
                                            and cfg.family in ("ssm", "hybrid"))
        unread = 0
        if cfg.family == "audio" and cell.kind == "prefill":
            unread = dryrun.tree_bytes({k: rc.args["state"][k] for k in ("cross_k", "cross_v")})
        elif cfg.family == "audio" and cell.kind == "decode":
            p = rc.args["params"]
            unread = dryrun.tree_bytes([p["encoder"], p["enc_norm"], p["decoder"]["xk"],
                                   p["decoder"]["xv"]])
        assert got == ref - 4 * has_len + unread, name
        unread_of[name] = unread
    # the differences the records show (the reference's own figures)
    assert unread_of["whisper-medium__prefill_32k__16x16.json"] == 18_432_000
    assert unread_of["whisper-medium__decode_32k__16x16.json"] - 4 == 7_278_588


def test_roofline_reproduces_the_reference_at_its_constants():
    """``Roofline`` at ``TPU_V5E`` fed the reference's own counts, and
    ``model_flops``, give each reference record's ``roofline`` dict."""
    n = 0
    for path in sorted(REFERENCE.glob("*.json")):
        ref = json.loads(path.read_text())
        if ref["status"] != "ok":
            continue
        r = ref["roofline"]
        mf = hlo_analysis.model_flops(configs.get(ref["arch"]), shapes.SHAPES[ref["shape"]])
        got = hlo_analysis.Roofline(r["flops_per_device"], r["hbm_bytes_per_device"],
                                    r["collective_wire_bytes"], mf, ref["chips"],
                                    hlo_analysis.TPU_V5E).as_dict()
        assert got.keys() == r.keys()
        for k, v in r.items():
            assert got[k] == (v if isinstance(v, str) else pytest.approx(v, rel=1e-12)), (path, k)
        n += 1
    assert n == 34


def test_artifacts_keep_the_reference_figures_beside_the_ports():
    """Each ok record copies the reference's compiled figures (no gate) and
    carries the port's roofline on the H100 and at the reference's
    constants."""
    for name, a in _artifacts().items():
        if a["status"] != "ok":
            continue
        ref = json.loads((REFERENCE / name).read_text())
        assert a["reference"]["memory_analysis"] == ref["memory_analysis"], name
        assert a["reference"]["roofline"] == ref["roofline"], name
        assert a["roofline"]["compute_s"] == pytest.approx(
            a["cost_analysis"]["flops"] / hlo_analysis.H100.peak_flops)
        assert a["roofline_tpu_v5e"]["compute_s"] == pytest.approx(
            a["cost_analysis"]["flops"] / hlo_analysis.TPU_V5E.peak_flops)
        assert a["coords"] == {"data": 0, "model": 0} and a["trace_s"] > 0


# the transformer families' serving cells and their peak estimates while a
# decode step still attended on every q head: each decode step now attends on
# the rank's own ceil(H / tp) heads
DECODE_PEAKS = {
    ("gemma3-4b", "decode_32k"): 36_751_342_080,
    ("gemma3-4b", "long_500k"): 73_260_362_240,
    ("h2o-danube-3-4b", "decode_32k"): 24_289_798_144,
    ("h2o-danube-3-4b", "long_500k"): 48_448_513_024,
    ("internvl2-2b", "decode_32k"): 27_360_667_648,
    ("kimi-k2-1t-a32b", "decode_32k"): 69_437_044_224,
    ("minicpm-2b", "decode_32k"): 97_824_423_424,
    ("qwen3-moe-235b-a22b", "decode_32k"): 54_469_933_568,
    ("starcoder2-3b", "decode_32k"): 8_195_614_720,
}


def test_decode_cells_are_the_transformer_families():
    """``DECODE_PEAKS`` holds every ok ``decode_32k`` / ``long_500k`` record
    of the dense, vlm and moe families."""
    got = {(a["arch"], a["shape"]) for a in _artifacts().values()
           if a["status"] == "ok" and a["shape"] in ("decode_32k", "long_500k")
           and configs.get(a["arch"]).family in ("dense", "vlm", "moe")}
    assert got == set(DECODE_PEAKS)


@pytest.mark.parametrize("arch, shape", sorted(DECODE_PEAKS))
def test_decode_records_within_twice_the_references_work(arch, shape):
    """The committed rank (0, 0) record of a transformer family's serving
    cell counts at most 2x the reference's compiled
    ``roofline.flops_per_device`` (1.0-11.4x while every rank attended on
    all H heads), and its peak estimate is no higher than it was then."""
    name = f"{arch}__{shape}__16x16.json"
    port = json.loads((ARTIFACTS / name).read_text())
    ref = json.loads((REFERENCE / name).read_text())
    assert port["cost_analysis"]["flops"] <= 2.0 * ref["roofline"]["flops_per_device"]
    assert port["memory_analysis"]["peak_bytes_per_device"] <= DECODE_PEAKS[(arch, shape)]


def test_gather_at_use_without_specs_is_the_identity():
    """With no spec trees on the context every helper hands back its input."""
    t = torch.ones(3)
    assert sharding.use(None, t, "embed") is t
    assert sharding.use_state(None, t, "kv", batch_dim=1, layer=True) is t
    assert sharding.own_state(None, t, t, "kv", batch_dim=1) is t


def test_importing_the_dry_run_leaves_jax_unloaded():
    """The port's dry-run imports neither ``jax`` nor anything of ``repro``."""
    code = ("import sys; import repro_torch.launch.dryrun, repro_torch.launch.hlo_analysis; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))"
            " or m == 'repro']; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], env={"PYTHONPATH": str(REPO / "src")},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]
