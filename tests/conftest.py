"""Shared test plumbing: the tracecheck auto-sanitizer (ISSUE 10).

Every :class:`repro.core.trace.Tracer` a test constructs — directly or
through any layer (``BSPRuntime``, ``CommSession.attach_tracer``,
``JobExecutor``, store mirroring) — is audited at teardown by
:func:`repro.analysis.check_trace`.  A timeline that violates lane
exclusivity, monotone clocks, collective/barrier causality, store
publish ordering or span accounting fails the test even when none of its
own assertions looked at the trace.

Opt a test out with ``@pytest.mark.no_trace_sanitizer`` (for tests that
deliberately build corrupt timelines).
"""

import pytest

from repro import analysis
from repro.core import trace as _trace


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "no_trace_sanitizer: skip the autouse tracecheck audit for this "
        "test (deliberately-corrupt timelines)",
    )
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one",
    )


@pytest.fixture(autouse=True)
def _trace_sanitizer(request):
    if request.node.get_closest_marker("no_trace_sanitizer"):
        yield
        return
    created: list = []
    sink = created.append
    _trace.register_audit_sink(sink)
    try:
        yield
    finally:
        _trace.unregister_audit_sink(sink)
    violations = []
    for tracer in created:
        violations.extend(analysis.check_trace(tracer))
    if violations:
        listing = "\n".join(str(v) for v in violations[:20])
        pytest.fail(
            f"tracecheck: {len(violations)} violation(s) on the "
            f"{len(created)} tracer(s) this test built:\n{listing}",
            pytrace=False,
        )
