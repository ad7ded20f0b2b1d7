"""The port's serverless job layer (``repro_torch.jobs``: futures, the
partitioner, ``JobExecutor``) and CSV ETL (``repro_torch.dataframe.io``)
against the reference, mirroring ``tests/test_jobs.py``.

Both packages run the same jobs with the same fault plans.  Measured task
compute is priced at ``cpu_scale=0``, so every ``JobReport`` (tasks,
attempts, retries, speculation, billed seconds, comm, reduce, USD) and every
``Tracer.to_json()`` is ``==`` the reference's; the map results are equal.
The ETL's Tables (on the CPU here) hold the reference's parsed columns; the
port's Tracers are audited by the port's tracecheck.
"""

import dataclasses

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover
    from _hypothesis_fallback import given, settings, st

from repro import jobs as j_jobs
from repro.core import algorithms as j_alg
from repro.core import faults as j_faults
from repro.dataframe import io as j_io
from repro.dist import object_store as j_store
from repro_torch import analysis as t_analysis
from repro_torch import jobs as t_jobs
from repro_torch.core import algorithms as t_alg
from repro_torch.core import cost_model as t_cost
from repro_torch.core import faults as t_faults
from repro_torch.core import trace as t_trace
from repro_torch.dataframe import io as t_io
from repro_torch.dist import object_store as t_store

J = dict(jobs=j_jobs, faults=j_faults, alg=j_alg, io=j_io, store=j_store, np=True)
T = dict(jobs=t_jobs, faults=t_faults, alg=t_alg, io=t_io, store=t_store, np=False)


@pytest.fixture(autouse=True)
def port_trace_sanitizer():
    """Audit every port Tracer the test builds with the port's tracecheck."""
    created: list = []
    t_trace.register_audit_sink(created.append)
    yield
    t_trace.unregister_audit_sink(created.append)
    violations = [v for tr in created for v in t_analysis.check_trace(tr)]
    assert violations == [], "\n".join(str(v) for v in violations[:20])


def executor(m, **kw):
    kw.setdefault("provider", "aws-lambda")
    kw.setdefault("cpu_scale", 0.0)
    if not m["np"]:
        kw["device"] = "cpu"
    return m["jobs"].JobExecutor(**kw)


def rows(report):
    return dataclasses.asdict(report)


def boom(x):
    raise ValueError(f"bad input {x}")


def plan(m, **kw):
    return m["faults"].FaultPlan(**kw)


# -- map / call_async / map_reduce reports ---------------------------------------

# name -> (executor kwargs, the call on that executor); kwargs that name a
# package's class are built per package
JOBS = {
    "map_squares": ({}, lambda ex, m: ex.map(lambda x: x * x, range(8))),
    "straggler_no_spec": (dict(speculation=dict(enabled=False)), lambda ex, m: ex.map(
        lambda x: x, range(6), faults=plan(m, straggles=((0, 2, 30.0),)))),
    "speculation": (dict(speculation=dict(min_lead_s=1.0)), lambda ex, m: ex.map(
        lambda x: x + 1, range(8), faults=plan(m, straggles=((0, 3, 25.0),)))),
    "kill_retry": ({}, lambda ex, m: ex.map(
        lambda x: x + 1, range(4), faults=plan(m, kills=((0, 2),)))),
    "kill_exhaust": (dict(retry=dict(max_retries=2)), lambda ex, m: ex.map(
        lambda x: x, [0], faults=plan(m, kills=((0, 0), (1, 0), (2, 0))))),
    "backoff": (dict(retry=dict(max_retries=2, backoff_s=1.0, multiplier=3.0)),
                lambda ex, m: ex.map(lambda x: x, [0], faults=plan(m, kills=((0, 0), (1, 0))))),
    "deadline": (dict(speculation=dict(enabled=False)), lambda ex, m: ex.map(
        lambda x: x, [5], faults=plan(m, straggles=((0, 0, 9.0),), deadline_s=2.0))),
    "errors": (dict(retry=dict(max_retries=2)), lambda ex, m: ex.map(boom, [7])),
    "mixed": (dict(mem_gb=10.0), lambda ex, m: ex.map(
        lambda x: x, range(8), faults=plan(m, straggles=((0, 1, 25.0),), kills=((0, 4),)))),
    "slurm": (dict(provider="hpc-slurm", mem_gb=10.0, speculation=dict(enabled=False)),
              lambda ex, m: ex.map(lambda x: x, range(4),
                                   faults=plan(m, straggles=((0, 0, 10.0),)))),
    "rate_faults": (dict(workers=4), lambda ex, m: ex.map(
        lambda x: x + 1, range(16), faults=plan(m, seed=3, straggle_s=4.0, straggle_rate=0.3,
                                                kill_rate=0.2))),
    "call_async": ({}, lambda ex, m: [ex.call_async(lambda x: x * 3, 14)]),
    "map_reduce": ({}, lambda ex, m: [ex.map_reduce(lambda x: x * x, range(16), sum)]),
    "map_reduce_arrays": (dict(workers=3), lambda ex, m: [ex.map_reduce(
        lambda x: (np.arange(x + 1, dtype=np.float64) if m["np"]
                   else torch.arange(x + 1, dtype=torch.float64)), range(7),
        lambda rs: float(sum(float(r.sum()) for r in rs)))]),
    "map_reduce_failure": (dict(retry=dict(max_retries=0)), lambda ex, m: [ex.map_reduce(
        lambda x: boom(x) if x == 3 else x, range(4), sum)]),
    "incremental": (dict(workers=4, speculation=dict(enabled=False)), lambda ex, m: [
        ex.map_reduce(lambda x: x * x, range(12), sum,
                      faults=plan(m, straggles=((0, 5, 10.0),)), incremental=True)]),
    "incremental_2": (dict(workers=2), lambda ex, m: [ex.map_reduce(
        lambda x: x, range(6), sum, incremental=True)]),
    "placer": (dict(provider=None, workload=dict(world=8, compute_s=5.0)),
               lambda ex, m: ex.map(lambda x: x, range(4))),
}


def run_job(m, name):
    kw, call = JOBS[name]
    kw = dict(kw)
    for key, cls in (("speculation", m["jobs"].SpeculationPolicy),
                     ("retry", m["jobs"].RetryPolicy), ("workload", m["alg"].Workload)):
        if key in kw:
            kw[key] = cls(**kw[key])
    ex = executor(m, **kw)
    return ex, call(ex, m)


def future_rows(fs):
    out = []
    for f in fs:
        exc = f.exception()
        out.append((f.job_id, f.task_id, f.done_s, f.ready, f.error,
                    None if exc is not None else f.result(),
                    None if exc is None else (type(exc).__name__, str(exc)),
                    rows(f.job)))
    return out


@pytest.mark.parametrize("name", list(JOBS))
def test_job_reports_equal(name):
    (jex, jf), (tex, tf) = run_job(J, name), run_job(T, name)
    assert future_rows(tf) == future_rows(jf)
    job_j, job_t = jf[0].job, tf[0].job
    assert (job_t.total_s, job_t.cost_usd, job_t.retries, job_t.speculative_launched,
            job_t.speculative_wins, job_t.speculative_discarded, job_t.timeline()) == \
        (job_j.total_s, job_j.cost_usd, job_j.retries, job_j.speculative_launched,
         job_j.speculative_wins, job_j.speculative_discarded, job_j.timeline())
    assert tex.tracer.to_json() == jex.tracer.to_json()
    waits = []
    for m, fs in ((J, jf), (T, tf)):
        done, not_done = m["jobs"].wait(fs, return_when=m["jobs"].ANY_COMPLETED)
        cut, _ = m["jobs"].wait(fs, return_when=m["jobs"].ALL_COMPLETED, timeout=10.0)
        waits.append(([f.task_id for f in done], [f.task_id for f in not_done],
                      [f.task_id for f in cut]))
    assert waits[0] == waits[1]
    assert t_analysis.check_job(job_t, tex.tracer) == []


def test_results_errors_and_validation_equal():
    for m in (J, T):
        fs = executor(m, retry=m["jobs"].RetryPolicy(max_retries=0)).map(
            lambda x: x if x != 1 else boom(x), range(3))
        with pytest.raises(ValueError, match="bad input 1"):
            m["jobs"].get_result(fs)
        assert m["jobs"].get_result(fs[0]) == 0
        with pytest.raises(ValueError, match="empty"):
            executor(m).map(lambda x: x, [])
        with pytest.raises(ValueError, match="return_when"):
            m["jobs"].wait(fs, return_when="SOME")
        with pytest.raises(ValueError, match="not both"):
            executor(m, workload=m["alg"].Workload(world=4, compute_s=1.0))
        assert m["jobs"].wait([]) == ([], [])


def test_executor_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_jobs.JobExecutor(provider="aws-lambda")


def test_measured_task_time_enters_the_report():
    def work(x):
        y = torch.ones(256, 256)
        for _ in range(20):
            y = y @ y / 256.0
        return x
    ex = t_jobs.JobExecutor(provider="aws-lambda", cpu_scale=1.0, device="cpu")
    red = ex.map_reduce(work, range(3), sum)
    assert red.result() == 3
    assert all(t.attempts[0].billed_s > 0.0 for t in red.job.tasks)
    assert red.job.reduce_s > 0.0


def test_job_cost_matches_cost_model():
    rep = executor(T, mem_gb=10.0).map(
        lambda x: x, range(8),
        faults=plan(T, straggles=((0, 1, 25.0),), kills=((0, 4),)))[0].job
    recomputed = sum(t_cost.LambdaInvocation(mem_gb=10.0, duration_s=a.billed_s).cost
                     for t in rep.tasks for a in t.attempts)
    assert rep.cost_usd == pytest.approx(recomputed, rel=1e-9)


# -- the partitioner ----------------------------------------------------------

@given(st.lists(st.integers(min_value=0, max_value=5000), min_size=1, max_size=5),
       st.integers(min_value=1, max_value=7000))
@settings(max_examples=30, deadline=None)
def test_partitions_equal_and_tile_every_byte(sizes, chunk):
    objects = {f"o{i}": bytes(s % 251 for s in range(n)) for i, n in enumerate(sizes)}
    got = []
    for m in (J, T):
        store = m["store"].S3Store()
        store.put_objects_atomic("ds", objects)
        parts = m["jobs"].partition_dataset(store, "ds", chunk_bytes=chunk)
        for name, blob in objects.items():
            assert b"".join(p.read(store) for p in parts if p.key == name) == blob
        got.append(([dataclasses.astuple(p) + (p.size_bytes, p.is_first, p.is_last)
                     for p in parts], [(op.kind, op.nbytes, op.time_s) for op in store.ops]))
    assert got[0] == got[1]


def test_partitioner_keys_and_errors():
    for m in (J, T):
        store = m["store"].S3Store()
        store.put_objects_atomic("ds", {"a": b"123", "b": b"456"})
        assert {p.key for p in m["jobs"].partition_dataset(
            store, "ds", chunk_bytes=2, keys=["b"])} == {"b"}
        with pytest.raises(ValueError):
            m["jobs"].partition_dataset(store, "ds", chunk_bytes=0)


# -- the CSV ETL ----------------------------------------------------------------

def _dataset(n=200, newline_at_end=True):
    rng = np.random.default_rng(7)
    a = rng.random(n)
    b = rng.integers(0, 50, n).astype(float)
    text = "\n".join(["a,b"] + [f"{float(a[i])},{float(b[i])}" for i in range(n)])
    if newline_at_end:
        text += "\n"
    return text.encode()


def table_rows(tables):
    return [(int(t.count), {k: np.asarray(v.cpu() if hasattr(v, "cpu") else v).tolist()
                            for k, v in t.columns.items()}) for t in tables]


@pytest.mark.parametrize("chunk_bytes", [17, 256, 10**6])
@pytest.mark.parametrize("newline_at_end", [True, False])
def test_etl_equal(chunk_bytes, newline_at_end):
    csv = _dataset(newline_at_end=newline_at_end)
    out = []
    for m in (J, T):
        store = m["store"].S3Store()
        store.put_objects_atomic("ds", {"t.csv": csv})
        kw = {} if m["np"] else {"device": "cpu"}
        tables = m["io"].etl_csv(store, "ds", "t.csv", chunk_bytes=chunk_bytes, **kw)
        out.append((table_rows(tables), [(op.kind, op.nbytes, op.time_s) for op in store.ops]))
    assert out[0] == out[1]
    assert all(dt == "float32" for t in tables for dt in
               (str(c.dtype).removeprefix("torch.") for c in t.columns.values()))


def test_etl_through_executor_equal():
    csv = _dataset()
    out = []
    for m in (J, T):
        store = m["store"].S3Store()
        store.put_objects_atomic("ds", {"t.csv": csv})
        ex = executor(m)
        kw = {} if m["np"] else {"device": "cpu"}
        tables = m["io"].etl_csv(store, "ds", "t.csv", chunk_bytes=512, executor=ex,
                                 faults=plan(m, kills=((0, 1),), straggles=((0, 2, 20.0),)),
                                 **kw)
        rep = ex.reports[-1]
        assert rep.ntasks == len(tables) and rep.cost_usd > 0
        out.append((table_rows(tables), rows(rep), ex.tracer.to_json()))
    assert out[0] == out[1]


def test_read_header_and_parse_errors_equal():
    for m in (J, T):
        kw = {} if m["np"] else {"device": "cpu"}
        store = m["store"].S3Store()
        store.put_objects_atomic("ds", {"t.csv": b"x, y ,z\n1,2,3\n", "bad.csv": b"a,b\n1,2,3\n",
                                        "nohead.csv": b"abc"})
        assert m["io"].read_header(store, "ds", "t.csv") == ["x", "y", "z"]
        with pytest.raises(ValueError, match="row 0 has 3 cells, expected 2"):
            m["io"].etl_csv(store, "ds", "bad.csv", chunk_bytes=100, **kw)
        with pytest.raises(ValueError, match="no header line"):
            m["io"].etl_csv(store, "ds", "nohead.csv", chunk_bytes=100, **kw)
        part = m["jobs"].partition_dataset(store, "ds", chunk_bytes=4, keys=["t.csv"])[1]
        with pytest.raises(ValueError, match="columns required"):
            m["io"].read_csv_partition(store, part, **kw)


def test_etl_defaults_to_the_card(monkeypatch):
    store = t_store.S3Store()
    store.put_objects_atomic("ds", {"t.csv": _dataset(5)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_io.etl_csv(store, "ds", "t.csv", chunk_bytes=64)
