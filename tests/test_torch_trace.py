"""The port's span timeline (``repro_torch.core.trace``) against the
reference's (``repro.core.trace``), mirroring ``tests/test_trace.py``: the
same spans give the same ``to_json()``, ``to_chrome()``,
``critical_path()`` and lane accounting, ``==`` with no tolerance; the
session and store mirrors lay the same spans; ``scripts/trace_to_chrome.py``
converts a port trace unchanged; and the port keeps its own audit-sink
registry."""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import algorithms as j_alg
from repro.core import communicator as j_comm
from repro.core import session as j_sess
from repro.core import trace as j_trace
from repro.dist import object_store as j_obs
from repro_torch.core import algorithms as t_alg
from repro_torch.core import communicator as t_comm
from repro_torch.core import session as t_sess
from repro_torch.core import trace as t_trace
from repro_torch.dist import object_store as t_obs

ROOT = Path(__file__).resolve().parents[1]


def _ops(seed, n=60):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, 4)), t_trace.LANES[int(rng.integers(0, 5))],
             float(rng.uniform(0.0, 10.0)), float(rng.uniform(0.0, 5.0)),
             int(rng.integers(0, 3))) for _ in range(n)]


def _schedule(trace, ops):
    tr = trace.Tracer()
    for i, (rank, lane, dur, gap, step) in enumerate(ops):
        if i % 3:
            tr.span(rank, lane, "op", t0=tr.lane_end(rank, lane) + gap, duration_s=dur,
                    nbytes=i * 8, usd=gap * 1e-6, step=step, tag=f"x{i % 4}")
        else:
            tr.span(rank, lane, "op", duration_s=dur, step=step)
    return tr


def _views(tr):
    return (tr.to_json(), tr.to_chrome(), tr.critical_path(), tr.end_s, tr.ranks(),
            [tr.lane_time_s(lane) for lane in t_trace.LANES],
            [tr.lane_time_s(lane, rank=r) for lane in t_trace.LANES for r in range(4)],
            [tr.lane_usd(lane) for lane in (None, *t_trace.LANES)],
            [tr.lane_end(r, lane) for lane in t_trace.LANES for r in range(4)])


@pytest.mark.parametrize("seed", range(4))
def test_schedules_and_exports_equal(seed):
    ops = _ops(seed)
    tt, jt = _schedule(t_trace, ops), _schedule(j_trace, ops)
    assert _views(tt) == _views(jt)
    # the JSON round trip re-validates and resumes the event sequence
    tb, jb = t_trace.Tracer.from_json(tt.to_json()), j_trace.Tracer.from_json(jt.to_json())
    assert _views(tb) == _views(jb) and tb._next_eseq == jb._next_eseq
    # the reference reads the port's JSON (scripts/trace_to_chrome.py's path)
    # as the port reads it back
    payload = json.loads(json.dumps(tt.to_json()))
    assert j_trace.Tracer.from_json(payload).to_chrome() == tb.to_chrome()


def test_invariant_errors_equal():
    for trace in (t_trace, j_trace):
        tr = trace.Tracer()
        tr.span(0, "comm", "x", t0=1.0, duration_s=2.0)
        with pytest.raises(trace.TraceError, match="exclusive"):
            tr.span(0, "comm", "y", t0=2.0, duration_s=0.1)
        with pytest.raises(trace.TraceError, match="before it starts"):
            tr.span(0, "compute", "x", t0=1.0, t1=0.5)
        with pytest.raises(trace.TraceError, match="unknown lane"):
            tr.span(0, "warp", "x", duration_s=1.0)
        with pytest.raises(trace.TraceError, match="exactly one"):
            tr.span(0, "compute", "x", t0=1.0, duration_s=1.0, t1=2.0)
        payload = tr.to_json()
        payload["spans"].append(dict(payload["spans"][0], t0=2.5, t1=3.5))
        with pytest.raises(trace.TraceError):
            trace.Tracer.from_json(payload)
        empty = trace.Tracer()
        assert empty.critical_path() == {"total_s": 0.0, "rank": None, "lanes": {}, "steps": []}
        assert empty.to_chrome() == {"traceEvents": [], "displayTimeUnit": "ms"}
    assert t_trace.LANES == j_trace.LANES and t_trace._EPS == j_trace._EPS


def _mirrored(m, ranks, mirror, torch_side):
    """A bootstrapped hybrid session mirrored onto a tracer, then collectives,
    a lifecycle step and store ops laid on the same timeline."""
    sess, comm, trace, obs = m
    s = sess.hybrid_session(8, [(0, 3), (2, 5)], relay="redis")
    tr = trace.Tracer()
    assert s.attach_tracer(tr, ranks=ranks, mirror=mirror) is tr
    c = comm.Communicator(session=s)
    mk = (lambda a: torch.from_numpy(a)) if torch_side else (lambda a: a)
    xs = [mk(np.full(1024, r, np.float32)) for r in range(8)]
    c.allreduce(xs)
    c.split([r % 2 for r in range(8)])[1].allgather(xs[:4])
    c.alltoallv([[x[:128 * d] for d in range(8)] for x in xs])
    s.detect_failure("r7")
    s.shrink([7])
    c2 = s.communicator()
    c2.bcast(xs[0], root=2)
    s.rebootstrap_rank(1)
    s.expand(2, provider="gcp-cloudrun")
    store = obs.S3Store()
    store.attach_tracer(tr, rank=1)
    store.put_objects_atomic("g", {"a": b"x" * 4096})
    store.get_object("g", "a")
    js = tr.to_json()
    for sp in js["spans"]:
        if "key" in sp["meta"] and sp["meta"]["key"].count("/") == 2:
            g, _, name = sp["meta"]["key"].split("/")
            sp["meta"]["key"] = f"{g}/<gen>/{name}"
    return js, tr.critical_path(), [c.event_lat_bw(e) for e in c.events]


@pytest.mark.parametrize("ranks,mirror", [(None, True), ((0,), True), ((1, 6), True),
                                          (None, False)])
def test_session_and_store_mirrors_equal(ranks, mirror):
    got = _mirrored((t_sess, t_comm, t_trace, t_obs), ranks, mirror, True)
    exp = _mirrored((j_sess, j_comm, j_trace, j_obs), ranks, mirror, False)
    assert got == exp
    lanes = {sp["lane"] for sp in got[0]["spans"]}
    assert {"bootstrap", "store"} <= lanes and (("comm" in lanes) == mirror)


def test_trace_to_chrome_script_converts_a_port_trace(tmp_path, monkeypatch, capsys):
    """``scripts/trace_to_chrome.py`` reads the port's raw timeline as it is."""
    tr = _schedule(t_trace, _ops(9, n=20))
    raw = tmp_path / "t.json"
    raw.write_text(json.dumps(tr.to_json()))
    spec = importlib.util.spec_from_file_location("trace_to_chrome",
                                                  ROOT / "scripts" / "trace_to_chrome.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["trace_to_chrome.py", str(raw)])
    assert mod.main() == 0
    assert json.loads((tmp_path / "t.chrome.json").read_text()) == \
        json.loads(json.dumps(t_trace.Tracer.from_json(tr.to_json()).to_chrome()))
    assert f"{len(tr.spans)} spans" in capsys.readouterr().out


def test_audit_sinks_are_the_ports_own():
    seen_t, seen_j = [], []
    t_trace.register_audit_sink(seen_t.append)
    j_trace.register_audit_sink(seen_j.append)
    try:
        a = t_trace.Tracer()
        b = j_trace.Tracer()
    finally:
        t_trace.unregister_audit_sink(seen_t.append)
        j_trace.unregister_audit_sink(seen_j.append)
    t_trace.unregister_audit_sink(seen_t.append)  # a second removal is a no-op
    assert seen_t == [a] and seen_j == [b]
    t_trace.Tracer()
    assert seen_t == [a]


def test_overlap_pipeline_time_equal():
    rng = np.random.default_rng(3)
    for c, lat, bw in [(0.375, 0.0216, 0.1101), (0.0, 0.0, 0.0), (5.0, 0.2, 50.0)] + \
            [tuple(rng.uniform(0, 50, 3)) for _ in range(40)]:
        for chunks in (None, 1, 2, 3, 8):
            assert t_alg.overlap_pipeline_time(c, lat, bw, chunks) == \
                j_alg.overlap_pipeline_time(c, lat, bw, chunks)
    for m in (t_alg, j_alg):
        with pytest.raises(ValueError):
            m.overlap_pipeline_time(1.0, 0.1, 0.5, chunks=0)
