"""Sanitizers for the modeled-clock substrate: tracecheck + lintcheck — the
port's own copy of ``repro.analysis`` (the same rules and messages).

Every modeled second the port reports is a claim about the priced event
model.  This package is the layer that audits those claims instead of
trusting them:

- **tracecheck** (:mod:`repro_torch.analysis.tracecheck`) — a happens-before
  race detector and accounting auditor over exported
  :class:`~repro_torch.core.trace.Tracer` timelines and
  :class:`~repro_torch.core.communicator.CommEvent` logs.  Entry point:
  :func:`check_trace`, returning :class:`Violation` records.
- **lintcheck** (:mod:`repro_torch.analysis.lintcheck`) — an AST lint for
  modeled-code hygiene (pure stdlib).  Entry point: :func:`lint_paths`,
  returning :class:`LintViolation` records.  Modeled code is a path under
  ``repro`` *or* ``repro_torch``, so the port's own ``core``, ``dist``
  and ``jobs`` are held to the wall-clock and seeded-RNG rules.

Both run from one CLI::

    python -m repro_torch.analysis tracecheck experiments/trace_*.json
    python -m repro_torch.analysis lint src/repro_torch

Rule codes
----------

Trace rules (tracecheck, ``RPT###``):

=======  ==================================================================
RPT001   lane-exclusivity violation: two spans overlap on one (rank, lane)
RPT002   non-monotone modeled clock: span ends before it starts / t0 < 0
RPT003   malformed record: unknown lane, missing field, corrupt linkage
RPT004   collective causality: a rank consumes a collective's result
         before every peer's matching span could have started
RPT005   barrier causality: a barrier exit precedes the slowest entrant
RPT006   restore-before-publish: a store GET precedes its key's PUT commit
RPT007   negative accounting value: span bills negative $ / negative bytes
RPT008   dollar conservation: lane $ != billed $ (JobReport), or
         total_usd != sum(per_rank_usd) + evicted_usd, or egress drift
RPT009   wire bytes exceed logical bytes on a priced CommEvent
RPT010   evicted spend resurrected (or dropped) after a mid-run shrink
RPT011   event sanity: negative modeled time / empty world / negative bytes
=======  ==================================================================

Lint rules (lintcheck, ``RPA###``; suppress a sanctioned site with
``# noqa: RPA###`` plus a justification):

=======  ==================================================================
RPA000   syntax error (file could not be parsed)
RPA001   wall-clock read (``time.time``/``perf_counter``/``datetime.now``)
         inside ``{repro,repro_torch}/{core,dist,jobs}``
RPA002   RNG without a seed (global-state RNG, or a seedable constructor
         called bare) inside ``{repro,repro_torch}/{core,dist,jobs}``
RPA003   deprecated ``channel_env=`` call site outside ``netsim.py``
RPA004   direct ``CHANNELS[...]``/``PLATFORMS[...]`` subscript outside
         ``netsim.py``
RPA005   ``CommEvent(...)`` priced with a numeric literal ``time_s``
RPA006   mutable dataclass default
RPA007   bare ``except:`` in a recovery ladder
=======  ==================================================================
"""

from repro_torch.analysis.lintcheck import (  # noqa: F401
    LintViolation,
    lint_paths,
    lint_source,
)
from repro_torch.analysis.tracecheck import (  # noqa: F401
    Violation,
    check_events,
    check_job,
    check_run_cost,
    check_trace,
    format_violations,
)

__all__ = [
    "LintViolation",
    "Violation",
    "check_events",
    "check_job",
    "check_run_cost",
    "check_trace",
    "format_violations",
    "lint_paths",
    "lint_source",
]
