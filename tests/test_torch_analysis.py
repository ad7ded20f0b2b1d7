"""The port's sanitizers (``repro_torch.analysis``: tracecheck RPT001-011 and
lintcheck RPA000-007) against the reference, mirroring
``tests/test_analysis.py`` over the port's own timelines.

Every seeded corruption of a port timeline is caught with its rule code, and
the port's violations on each (corrupted or clean) payload are ``==`` the
reference's on the same payload.  The lint gives the reference's findings on
the same sources, and it counts a path under ``repro_torch`` as modeled code:
the port's tree lints clean under the wall-clock and seeded-RNG rules, and a
bare ``time.perf_counter()`` planted under ``repro_torch/core`` is RPA001.
"""

import copy
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from repro import analysis as j_analysis
from repro.analysis import lintcheck as j_lint
from repro_torch import analysis
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import lintcheck
from repro_torch.core import bsp, faults
from repro_torch.core.communicator import CollectiveKind, CommEvent, Communicator
from repro_torch.core.cost_model import heterogeneous_run_cost
from repro_torch.core.session import CommSession, hybrid_session
from repro_torch.core.trace import Tracer
from repro_torch.dist import compression
from repro_torch.dist.object_store import S3Store
from repro_torch.jobs import JobExecutor, SpeculationPolicy

REPO = pathlib.Path(__file__).resolve().parents[1]
SAMPLE_TRACES = (
    REPO / "experiments" / "trace_overlap_sample.json",
    REPO / "experiments" / "trace_chaos_recovery_sample.json",
)


def _codes(violations):
    return {v.rule for v in violations}


def rows(violations):
    return [dataclasses.astuple(v) for v in violations]


def check_both(payload, **kw):
    """The port's violations on ``payload``, held ``==`` the reference's."""
    got = analysis.check_trace(payload, **kw)
    assert rows(got) == rows(j_analysis.check_trace(copy.deepcopy(payload), **kw))
    return got


def _sum_step(rank, state, comm, world):
    if rank == 0:
        comm.allreduce([torch.ones(256) * (r + 1) for r in range(world)])
    return state + 1.0


@pytest.fixture(scope="module")
def shrink_run(tmp_path_factory):
    """World-8 checkpointed run that loses two ranks and shrinks."""
    store = tmp_path_factory.mktemp("ckpt")
    rt = bsp.BSPRuntime(8, provider="aws-lambda", checkpoint_dir=store, device="cpu")
    plan = faults.FaultPlan(seed=7, rank_losses=((2, 6), (2, 7)))
    _, report = rt.run([("s", _sum_step)] * 4, [torch.zeros(4) for _ in range(8)],
                       faults=plan, recovery_policy="shrink")
    return rt, report


@pytest.fixture(scope="module")
def jobs_run():
    ex = JobExecutor(workers=4, provider="aws-lambda", device="cpu")
    fut = ex.map_reduce(lambda x: x * x, list(range(12)), lambda xs: sum(xs))
    assert fut.result() == sum(x * x for x in range(12))
    return ex, fut.job


class TestSeededCorruption:
    def test_baseline_is_clean(self, shrink_run):
        rt, report = shrink_run
        assert analysis.check_trace(rt.tracer, session=rt.session, report=report) == []
        assert check_both(rt.tracer.to_json()) == []

    def test_swap_two_span_times(self, shrink_run):
        payload = copy.deepcopy(shrink_run[0].tracer.to_json())
        lanes = {}
        for s in payload["spans"]:
            lanes.setdefault((s["rank"], s["lane"]), []).append(s)
        pair = None
        for ss in lanes.values():
            ss.sort(key=lambda s: s["t0"])
            pair = next(((a, b) for a, b in zip(ss, ss[1:])
                         if a["t0"] < a["t1"] <= b["t0"] < b["t1"] and b["t0"] > a["t0"]), None)
            if pair:
                break
        assert pair is not None
        a, b = pair
        a["t1"], b["t1"] = b["t1"], a["t1"]
        assert "RPT001" in _codes(check_both(payload))

    def test_reorder_collective_ranks(self, shrink_run):
        payload = copy.deepcopy(shrink_run[0].tracer.to_json())
        target = [s for s in payload["spans"]
                  if s["lane"] == "comm" and s["kind"] == "allreduce"][0]
        shift = (target["t1"] - target["t0"]) + 1.0
        target["t0"] -= shift
        target["t1"] -= shift
        assert "RPT004" in _codes(check_both(payload))

    def test_barrier_exits_before_slowest_entrant(self, shrink_run):
        payload = copy.deepcopy(shrink_run[0].tracer.to_json())
        bars = [s for s in payload["spans"] if s["kind"] == "barrier"]
        assert bars
        bars[0]["t0"] -= 5.0
        bars[0]["t1"] -= 5.0
        assert "RPT005" in _codes(check_both(payload))

    def test_inflate_one_lane_times(self, shrink_run):
        payload = copy.deepcopy(shrink_run[0].tracer.to_json())
        for s in payload["spans"]:
            if s["rank"] == 1 and s["lane"] == "comm":
                s["t0"] *= 3.0
                s["t1"] *= 3.0
        assert "RPT004" in _codes(check_both(payload))

    @pytest.mark.parametrize("factor", [0.0, 10.0])
    def test_dollar_entry_dropped_or_inflated(self, jobs_run, factor):
        ex, job = jobs_run
        payload = copy.deepcopy(ex.tracer.to_json())
        billed = next(s for s in payload["spans"]
                      if s["usd"] > 0 and s["meta"].get("job") == job.job_id)
        billed["usd"] *= factor
        assert "RPT008" in _codes(analysis.check_trace(payload, job=job))
        assert analysis.check_job(job, ex.tracer) == []

    def test_restore_before_publish(self, shrink_run):
        payload = copy.deepcopy(shrink_run[0].tracer.to_json())
        puts = {s["meta"].get("key"): s["t1"] for s in payload["spans"]
                if s["lane"] == "store" and s["kind"] == "put"}
        get = next(s for s in payload["spans"]
                   if s["lane"] == "store" and s["kind"] == "get"
                   and s["meta"].get("key") in puts)
        width = get["t1"] - get["t0"]
        get["t0"] = puts[get["meta"]["key"]] - 10.0
        get["t1"] = get["t0"] + width
        assert "RPT006" in _codes(check_both(payload))

    def test_negative_accounting_and_bad_lane(self):
        spans = [
            {"rank": 0, "lane": "compute", "t0": 0.0, "t1": 1.0, "kind": "x", "usd": -0.5},
            {"rank": 0, "lane": "warp", "t0": 0.0, "t1": 1.0, "kind": "y"},
            {"rank": 1, "lane": "compute", "t0": 2.0, "t1": 1.0, "kind": "z"},
            "not a span",
            {"rank": 2, "lane": "comm"},
        ]
        assert {"RPT007", "RPT003", "RPT002"} <= _codes(check_both(spans))

    def test_event_checks(self):
        good = CommEvent(CollectiveKind.ALLREDUCE, 4, 100, 1.0, raw_bytes=200)
        bad = CommEvent(CollectiveKind.ALLREDUCE, 4, 300, 1.0, raw_bytes=200)
        insane = CommEvent(CollectiveKind.BARRIER, 0, 0, -1.0)
        assert analysis.check_events([good]) == []
        assert "RPT009" in _codes(analysis.check_events([bad]))
        assert "RPT011" in _codes(analysis.check_events([insane]))
        assert rows(analysis.check_events([good, bad, insane])) == rows(
            j_analysis.check_events([good, bad, insane]))

    def test_evicted_spend_resurrected_and_total_broken(self, shrink_run):
        rt, report = shrink_run
        cost = heterogeneous_run_cost(report, rt.session)
        assert cost["evicted_usd"] > 0
        assert analysis.check_run_cost(report, rt.session, cost) == []
        resurrected = dict(cost)
        per_rank = list(cost["per_rank_usd"])
        per_rank[0] += cost["evicted_usd"]
        resurrected["per_rank_usd"] = per_rank
        resurrected["evicted_usd"] = 0.0
        assert "RPT010" in _codes(analysis.check_run_cost(report, rt.session, resurrected))
        broken = dict(cost, total_usd=cost["total_usd"] + 1.0)
        assert "RPT008" in _codes(analysis.check_run_cost(report, rt.session, broken))


class TestNoFalsePositives:
    @pytest.mark.parametrize("artifact", SAMPLE_TRACES, ids=lambda p: p.stem)
    def test_shipped_sample_traces_are_clean(self, artifact):
        payload = json.loads(artifact.read_text())
        assert check_both(payload) == []
        assert analysis.check_trace(Tracer.from_json(payload)) == []
        assert analysis.check_trace(str(artifact)) == []

    @pytest.mark.parametrize("algorithm", ["auto", "fixed"])
    def test_collective_algos_family(self, algorithm):
        comm = Communicator(4, algorithm=algorithm)
        tr = comm.session.attach_tracer(Tracer(), backfill=True)
        comm.allreduce([torch.ones(2048)] * 4)
        comm.alltoallv([[torch.ones(64)] * 4] * 4)
        comm.barrier()
        assert analysis.check_trace(tr, events=comm.session.events) == []

    def test_shuffle_compression_family(self):
        comm = Communicator(4)
        tr = comm.session.attach_tracer(Tracer(), backfill=True)
        blk = compression.encode_block({"k": torch.arange(128, dtype=torch.int32)}, {"k"})
        comm.compressed_alltoallv([[blk] * 4] * 4)
        assert analysis.check_trace(tr, events=comm.session.events) == []

    def test_hybrid_links_family(self):
        sess = hybrid_session(4, [(0, 1)])
        tr = sess.attach_tracer(Tracer(), backfill=True)
        Communicator(session=sess).allreduce([torch.ones(1024)] * 4)
        assert analysis.check_trace(tr, events=sess.events) == []

    def test_ckpt_store_family(self):
        store = S3Store()
        tr = Tracer()
        store.attach_tracer(tr)
        store.put_objects_atomic("g", {"obj": np.arange(4096, dtype=np.float32).tobytes()})
        store.get_object("g", "obj")
        assert analysis.check_trace(tr) == []

    def test_provider_placement_family(self):
        sess = CommSession.bootstrap(4, "aws-lambda")
        tr = sess.attach_tracer(Tracer(), backfill=True)
        sess.expand(2, provider="gcp-cloudrun")
        Communicator(session=sess).allreduce([torch.ones(256)] * 6)
        assert analysis.check_trace(tr, events=sess.events) == []

    def test_jobs_family(self):
        plan = faults.FaultPlan(seed=3, straggle_s=4.0, straggle_rate=0.3)
        ex = JobExecutor(workers=4, provider="aws-lambda", speculation=SpeculationPolicy(),
                         device="cpu")
        futs = ex.map(lambda x: x + 1, list(range(16)), faults=plan)
        assert [f.result() for f in futs] == list(range(1, 17))
        assert analysis.check_trace(ex.tracer, job=futs[0].job) == []

    def test_overlap_family(self):
        rt = bsp.BSPRuntime(4, provider="aws-lambda", device="cpu")
        rt.run([("s", _sum_step)] * 3, [torch.zeros(4) for _ in range(4)], overlap=True)
        assert analysis.check_trace(rt.tracer, session=rt.session) == []

    def test_chaos_recovery_family(self, shrink_run):
        rt, report = shrink_run
        cost = heterogeneous_run_cost(report, rt.session)
        assert analysis.check_trace(
            rt.tracer, session=rt.session, report=report, cost=cost) == []


class TestEventSpanLinkage:
    def test_ingest_stamps_shared_eseq_and_from_json_resumes(self):
        tr = Tracer()
        ev = CommEvent(CollectiveKind.ALLREDUCE, 3, 64, 0.5)
        spans = tr.ingest_comm_event(ev, range(3))
        assert len({s.meta_dict["eseq"] for s in spans}) == 1
        assert tr.ingest_comm_event(ev, range(3))[0].meta_dict["eseq"] != \
            spans[0].meta_dict["eseq"]
        clone = Tracer.from_json(tr.to_json())
        assert clone.ingest_comm_event(ev, range(3))[0].meta_dict["eseq"] == 2

    def test_linked_groups_catch_what_heuristics_see(self):
        tr = Tracer()
        tr.ingest_comm_event(CommEvent(CollectiveKind.ALLREDUCE, 4, 64, 1.0), range(4))
        payload = tr.to_json()
        stripped = copy.deepcopy(payload)
        for s in stripped["spans"]:
            s["meta"].pop("eseq")
        for p in (payload, stripped):
            p["spans"][0]["t0"] -= 10.0
            p["spans"][0]["t1"] -= 10.0
            assert "RPT004" in _codes(check_both(p))


# ---------------------------------------------------------------------------
# lintcheck
# ---------------------------------------------------------------------------

OUTSIDE = "benchmarks/x.py"
SNIPPETS = {
    "RPA000": ("def f(:\n", OUTSIDE),
    "RPA001": ("import time\nt = time.perf_counter()\n", "MODELED"),
    "RPA001_from": ("from time import perf_counter\nt = perf_counter()\n", "MODELED"),
    "RPA001_datetime": ("from datetime import datetime\nd = datetime.now()\n", "MODELED"),
    "RPA002": ("import numpy as np\nr = np.random.default_rng()\n", "MODELED"),
    "RPA002_global": ("import random\nx = random.random()\n", "MODELED"),
    "RPA003": ("resolve_provider(channel_env='redis')\n", OUTSIDE),
    "RPA004": ("c = CHANNELS['redis']\np = netsim.PLATFORMS['x']\n", OUTSIDE),
    "RPA005": ("ev = CommEvent(k, 4, 64, 1.5)\nev = CommEvent(k, 4, 64, time_s=-2.0)\n", OUTSIDE),
    "RPA006": ("import dataclasses\n@dataclasses.dataclass\nclass C:\n    xs: list = []\n"
               "    d: dict = dataclasses.field(default={})\n", OUTSIDE),
    "RPA007": ("try:\n    x = 1\nexcept:\n    pass\n", OUTSIDE),
}


@pytest.mark.parametrize("root", ["repro", "repro_torch"])
@pytest.mark.parametrize("name", list(SNIPPETS))
def test_lint_rule_fires_as_in_the_reference(name, root):
    src, path = SNIPPETS[name]
    path = f"src/{root}/core/x.py" if path == "MODELED" else path
    got = lintcheck.lint_source(src, path)
    assert name.split("_")[0] in _codes(got)
    if root == "repro":
        assert rows(got) == rows(j_lint.lint_source(src, path))


@pytest.mark.parametrize("root", ["repro", "repro_torch"])
def test_lint_clean_snippets_and_noqa(root):
    modeled = f"src/{root}/jobs/x.py"
    clean = [
        ("import time\nt = time.time()\n", OUTSIDE),
        ("import numpy as np\nr = np.random.default_rng(7)\n", modeled),
        ("resolve_provider(channel_env='redis')\n", f"src/{root}/core/netsim.py"),
        ("c = CHANNELS['redis']\n", f"src/{root}/core/netsim.py"),
        ("ev = CommEvent(k, 4, 64, priced_t)\nev = CommEvent(k, 4, 64, 0.0)\n", OUTSIDE),
        ("import time\nt = time.perf_counter()  # noqa: RPA001\n", modeled),
        ("import time\nt = time.perf_counter()  # noqa\n", modeled),
        ("try:\n    x = 1\nexcept ValueError:\n    pass\n", OUTSIDE),
    ]
    for src, path in clean:
        assert lintcheck.lint_source(src, path) == [], (src, path)
    wrong_code = "import time\nt = time.perf_counter()  # noqa: RPA002\n"
    assert "RPA001" in _codes(lintcheck.lint_source(wrong_code, modeled))


def test_port_tree_lints_clean_with_its_modeled_packages():
    """Closes C 4: the port's core/dist/jobs are modeled code to this lint,
    and the port's tree (its sanctioned measurement points waived) is clean."""
    files = lintcheck.iter_python_files([REPO / "src" / "repro_torch"])
    modeled = [f for f in files if lintcheck._classify(f)[0]]
    assert {f.parent.name for f in modeled} >= {"core", "dist", "jobs", "backends"}
    assert any(f.name == "bsp.py" for f in modeled)
    assert any(f.name == "executor.py" for f in modeled)
    violations = lintcheck.lint_paths([REPO / "src" / "repro_torch"])
    assert violations == [], "\n".join(str(v) for v in violations)
    assert lintcheck.lint_paths([REPO / "src"]) == []


def test_planted_wall_clock_in_the_port_is_rpa001(tmp_path):
    planted = tmp_path / "src" / "repro_torch" / "core" / "x.py"
    planted.parent.mkdir(parents=True)
    planted.write_text("import time\n\n\ndef now():\n    return time.perf_counter()\n")
    got = lintcheck.lint_paths([tmp_path / "src"])
    assert [(v.rule, v.line) for v in got] == [("RPA001", 5)]
    # the reference's lint counts only a path under ``repro`` as modeled
    assert j_lint.lint_paths([tmp_path / "src"]) == []


def test_cli_lint_and_tracecheck(tmp_path, capsys):
    assert cli.main(["lint", str(REPO / "src" / "repro_torch")]) == 0
    bad = tmp_path / "repro_torch" / "dist" / "y.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import random\nx = random.random()\n")
    report = tmp_path / "lint.json"
    assert cli.main(["lint", str(tmp_path), "--json", str(report)]) == 1
    assert [r["rule"] for r in json.loads(report.read_text())["violations"]] == ["RPA002"]
    assert cli.main(["tracecheck", *map(str, SAMPLE_TRACES)]) == 0
    corrupt = json.loads(SAMPLE_TRACES[0].read_text())
    corrupt["spans"][0]["t1"] = corrupt["spans"][0]["t0"] - 1.0
    path = tmp_path / "corrupt.json"
    path.write_text(json.dumps(corrupt))
    out = tmp_path / "tc.json"
    assert cli.main(["tracecheck", str(path), "--json", str(out)]) == 1
    assert "RPT002" in {r["rule"] for r in json.loads(out.read_text())["violations"]}
    assert "clean" in capsys.readouterr().out
