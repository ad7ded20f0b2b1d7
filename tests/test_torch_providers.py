"""The port's copies of the provider registry, platform models, placement
engine and cost model (``repro_torch.core.netsim`` / ``algorithms`` /
``cost_model``) against the reference (``repro.core``), mirroring
``tests/test_providers.py``: every constant, modeled second, price and
choice is ``==`` the reference's, with no tolerance.  Both packages build the
same objects by name; nothing crosses between them but numbers."""

import dataclasses
import types
import warnings

import numpy as np
import pytest
import torch

from repro.core import algorithms as j_alg
from repro.core import cost_model as j_cm
from repro.core import netsim as j_net
from repro.core import session as j_sess
from repro_torch.core import algorithms as t_alg
from repro_torch.core import cost_model as t_cm
from repro_torch.core import netsim as t_net
from repro_torch.core import session as t_sess

PROVIDERS = ("aws-lambda", "aws-ec2", "gcp-cloudrun", "hpc-slurm")
WORLDS = [1, 2, 3, 8, 16, 32, 64]


def tup(x):
    return dataclasses.astuple(x)


def test_registry_and_constants_equal():
    assert t_net.providers() == j_net.providers()
    for name in j_net.providers():
        assert tup(t_net.get_provider(name)) == tup(j_net.get_provider(name))
        assert tup(t_net.get_provider(name).relay_channel) == \
            tup(j_net.get_provider(name).relay_channel)
    for const in ("AWS_LAMBDA", "AWS_EC2", "GCP_CLOUDRUN", "HPC_SLURM", "CLOUDRUN_DIRECT",
                  "SLURM_CPU", "DEFAULT_DETECTOR", "LAMBDA_10GB", "LAMBDA_6GB", "EC2_XL",
                  "EC2_L", "RIVANNA_10GB", "RIVANNA_6GB"):
        assert tup(getattr(t_net, const)) == tup(getattr(j_net, const)), const
    assert sorted(t_net.PLATFORMS) == sorted(j_net.PLATFORMS)
    for name in j_net.PLATFORMS:
        assert tup(t_net.resolve_platform(name)) == tup(j_net.resolve_platform(name))
    assert t_net.CHANNELS["direct"] is t_net.AWS_LAMBDA.direct is t_net.LAMBDA_DIRECT
    assert t_net.PLATFORMS["lambda-10gb"] is t_net.AWS_LAMBDA.platform
    assert tup(t_net.DEFAULT_DETECTOR) == tup(j_net.DEFAULT_DETECTOR)
    assert t_net.DEFAULT_DETECTOR.suspect_s() == j_net.DEFAULT_DETECTOR.suspect_s()
    assert t_net.DEFAULT_DETECTOR.confirm_s() == j_net.DEFAULT_DETECTOR.confirm_s()
    assert t_cm.S3_USD_PER_PUT == j_cm.S3_USD_PER_PUT and t_cm.S3_USD_PER_GET == j_cm.S3_USD_PER_GET
    for name in ("LAMBDA_USD_PER_GB_S", "EC2_M3_XLARGE_USD_PER_HR", "EC2_M3_LARGE_USD_PER_HR"):
        assert getattr(t_cm, name) == getattr(j_cm, name)


@pytest.mark.parametrize("world", WORLDS)
def test_platform_and_provider_prices_equal(world):
    for name in j_net.PLATFORMS:
        assert t_net.resolve_platform(name).init_time(world) == \
            j_net.resolve_platform(name).init_time(world)
    for name in PROVIDERS:
        t, j = t_net.get_provider(name), j_net.get_provider(name)
        assert t.bootstrap_time(world) == j.bootstrap_time(world)
        assert t.invocation_cost(10.0, 3.5 * world) == j.invocation_cost(10.0, 3.5 * world)
    for ch in ("direct", "ec2-direct", "hpc-direct", "redis", "s3"):
        assert t_net.mediated_bootstrap_time(t_net.resolve_channel(ch), world) == \
            j_net.mediated_bootstrap_time(j_net.resolve_channel(ch), world)


def test_resolve_provider_and_errors_equal():
    cases = [dict(), dict(provider="aws-ec2"), dict(channel="redis"), dict(channel="s3"),
             dict(platform="lambda-6gb"), dict(platform="rivanna-10gb", channel="hpc-direct"),
             dict(platform="lambda-10gb", channel="redis")]
    for kw in cases:
        tk = dict(kw)
        jk = dict(kw)
        if "platform" in kw:
            tk["platform"] = t_net.resolve_platform(kw["platform"])
            jk["platform"] = j_net.resolve_platform(kw["platform"])
        t, j = t_net.resolve_provider(**tk), j_net.resolve_provider(**jk)
        assert tup(t) == tup(j), kw
        assert t_net.resolve_provider(**tk) is t  # interned
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert tup(t_net.resolve_provider(channel_env="redis")) == \
            tup(j_net.resolve_provider(channel="redis"))
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    for mod in (t_net, j_net):
        with pytest.raises(ValueError, match="already names"):
            mod.resolve_provider("aws-lambda", channel="redis")
        with pytest.raises(ValueError, match="unknown provider"):
            mod.get_provider("carrier-pigeon")
        with pytest.raises(ValueError, match="unknown platform"):
            mod.resolve_platform("abacus")
        with pytest.raises(ValueError, match="already registered"):
            mod.register_provider(mod.AWS_LAMBDA)
    for mod in (t_sess, j_sess):
        with pytest.raises(ValueError, match="registered provider"):
            mod.CommSession.bootstrap(4, "nowhere")


def test_register_round_trip_is_per_package():
    """Each package has its own registry: a provider registered in the port
    is invisible to the reference, and a copy of the same profile in each
    prices alike."""
    def prof(net):
        return net.ProviderProfile(
            name="test-edge-torch", kind="serverless", platform=net.LAMBDA_6GB,
            direct=net.LAMBDA_DIRECT, staged=(net.REDIS_STAGED,),
            usd_per_gb_s=1e-5, nat_blocked_rate=0.1,
        )
    t = t_net.register_provider(prof(t_net), overwrite=True)
    try:
        assert "test-edge-torch" in t_net.providers()
        assert "test-edge-torch" not in j_net.providers()
        j = prof(j_net)
        assert tup(t) == tup(j)
        assert t.bootstrap_time(16) == j.bootstrap_time(16)
        tf, jf = t_sess.provider_fabric("test-edge-torch"), j_sess.provider_fabric(j)
        assert tf.blocked_set(16) == jf.blocked_set(16) and tf.blocked_set(16)
    finally:
        del t_net._PROVIDERS["test-edge-torch"]  # the registry is process-wide


def _workloads(mod):
    return [mod.Workload(world=world, compute_s=compute_s, mem_gb=mem,
                         collectives=(("allreduce", 1 << 22, 10), ("barrier", 0, 10),
                                      ("alltoallv", 3 << 18, 4)))
            for world, compute_s, mem in ((32, 120.0, 10.0), (8, 2.0, 6.0), (8, 600.0, 10.0),
                                          (64, 30.0, 10.0))]


def test_placement_equal():
    for tw, jw in zip(_workloads(t_alg), _workloads(j_alg)):
        tb = t_alg.placement_candidates(tw, PROVIDERS)
        jb = j_alg.placement_candidates(jw, PROVIDERS)
        assert [tup(b) for b in tb] == [tup(b) for b in jb]
        for dl in sorted([b.time_s * 1.001 for b in jb] + [min(b.time_s for b in jb) * 0.5, 1e9]):
            assert tup(t_alg.select_placement(tw, PROVIDERS, dl)) == \
                tup(j_alg.select_placement(jw, PROVIDERS, dl))
    with pytest.raises(ValueError):
        t_alg.select_placement(_workloads(t_alg)[0], (), 1e9)


@pytest.mark.parametrize("ranks", [
    ["aws-lambda", "aws-lambda", "aws-ec2", "aws-ec2"],
    ["aws-ec2"] * 4,
    ["aws-lambda"] * 3 + ["gcp-cloudrun"] * 3 + ["hpc-slurm"] * 2,
    ["gcp-cloudrun", "aws-lambda", "gcp-cloudrun", "aws-lambda", "aws-ec2"],
])
@pytest.mark.parametrize("relay", [None, "s3"])
def test_provider_links_and_hybrid_prices_equal(ranks, relay):
    tl = t_alg.provider_links(ranks, relay=None if relay is None else t_net.resolve_channel(relay))
    jl = j_alg.provider_links(ranks, relay=None if relay is None else j_net.resolve_channel(relay))
    assert tup(tl) == tup(jl)
    assert (tl.all_direct, tl.fully_relayed, tl.relay_names) == \
        (jl.all_direct, jl.fully_relayed, jl.relay_names)
    for kind in ("allreduce", "alltoallv", "allgather", "bcast", "barrier", "gather",
                 "reduce_scatter", "p2p"):
        for nbytes in (0, 4096, 1 << 22):
            tc = t_alg.select_hybrid(kind, len(ranks), nbytes, tl, use_cache=False)
            jc = j_alg.select_hybrid(kind, len(ranks), nbytes, jl, use_cache=False)
            assert tup(tc) == tup(jc), (kind, nbytes)
    for mod, net in ((t_alg, t_net), (j_alg, j_net)):
        with pytest.raises(ValueError, match="staged"):
            mod.provider_links(["aws-lambda", "aws-ec2"], relay=net.EC2_DIRECT)


def _cost_calls(cm, sess):
    s = sess.CommSession.bootstrap(8, "lambda")
    s.expand(4, provider="gcp-cloudrun")
    s.shrink([11], policy="incremental")
    comm = s.communicator()
    comm.allreduce([torch.zeros(1 << 18) for _ in range(s.world)]) if sess is t_sess else \
        comm.allreduce([np.zeros(1 << 18, np.float32) for _ in range(s.world)])
    report = types.SimpleNamespace(
        world=s.world, init_s=s.bootstrap_time_s, joined_at={8: 2, 9: 2, 10: 3},
        supersteps=[types.SimpleNamespace(index=i, total_s=1.5 + 0.25 * i) for i in range(5)],
        evicted=[{"rank": 11, "provider": "gcp-cloudrun", "step": 4}])
    return {
        "join_redis": tup(cm.join_cost(32, channel="redis")),
        "join_s3": tup(cm.join_cost(32, channel="s3")),
        "join_direct": tup(cm.join_cost(32)),
        "join_6gb": tup(cm.join_cost(16, mem_gb=6.0, shuffle_rounds=4)),
        "join_totals": [cm.join_cost(w, channel=c).total for w in (8, 32, 64)
                        for c in ("direct", "redis", "s3")],
        "steps": cm.step_function_transitions(32),
        "egress": cm.relay_egress_cost(s),
        "hetero": cm.heterogeneous_run_cost(report, s),
        "ec2": cm.ec2_cost(32, 600.0, idle_fraction=0.25),
        "ec2_large": cm.ec2_cost(8, 60.0, xlarge=False),
        "break_even": cm.break_even_utilization(32, 10.0, 30.0),
        "campaign": cm.revision_campaign_cost(),
        "invocation": cm.LambdaInvocation(10.0, 31.5).cost,
    }


def test_cost_model_equal():
    got, exp = _cost_calls(t_cm, t_sess), _cost_calls(j_cm, j_sess)
    assert got == exp
    assert got["egress"] and any(x > 0 for x in got["egress"])
