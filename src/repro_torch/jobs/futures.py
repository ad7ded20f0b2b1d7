"""Futures over priced simulated serverless tasks (the Lithops idiom).

The executor runs every task eagerly (the repo's simulation convention:
real local compute, modeled parallel wall time), so a :class:`Future` is
born *resolved* — what it carries is the **modeled timeline**: ``done_s``
is the simulated second at which this task's winning attempt completed.
``wait`` and ``get_result`` therefore reason about the modeled clock, not
threads: ``wait(fs, return_when=ANY_COMPLETED)`` hands back exactly the
futures that had finished at the moment the *first* one finished, which is
what a poll loop on real infrastructure would observe.

A failed task (retry budget exhausted) is still a *completed* future —
``wait`` returns it in the done set and ``result()`` re-raises the task's
exception, mirroring ``concurrent.futures`` semantics.
"""

from __future__ import annotations

from collections.abc import Iterable, Sequence
from typing import Any

ANY_COMPLETED = "ANY_COMPLETED"
ALL_COMPLETED = "ALL_COMPLETED"


class Future:
    """Handle to one task of a job: result/exception plus modeled timing."""

    def __init__(
        self,
        job_id: str,
        task_id: int,
        done_s: float,
        result: Any = None,
        exception: BaseException | None = None,
        record: Any = None,
        job: Any = None,
    ):
        self.job_id = job_id
        self.task_id = int(task_id)
        self.done_s = float(done_s)   # modeled completion time within the job
        self._result = result
        self._exception = exception
        self.record = record          # the TaskRecord (timeline, bills, retries)
        self.job = job                # the owning JobReport

    # -- state ---------------------------------------------------------------

    def done(self) -> bool:
        return True  # eager simulation: every future is resolved at creation

    @property
    def ready(self) -> bool:
        return self._exception is None

    @property
    def error(self) -> bool:
        return self._exception is not None

    def exception(self) -> BaseException | None:
        return self._exception

    def result(self) -> Any:
        """The task's output; re-raises the task exception after the retry
        budget was exhausted (serverless tasks fail loudly, not silently)."""
        if self._exception is not None:
            raise self._exception
        return self._result

    def __repr__(self) -> str:
        state = "error" if self.error else "done"
        return (
            f"Future(job={self.job_id!r}, task={self.task_id}, "
            f"{state} @ {self.done_s:.3f}s)"
        )


def wait(
    fs: Iterable[Future],
    return_when: str = ALL_COMPLETED,
    timeout: float | None = None,
) -> tuple[list[Future], list[Future]]:
    """Split ``fs`` into ``(done, not_done)`` on the modeled clock.

    ``ANY_COMPLETED``: the cut is the earliest ``done_s`` among ``fs`` —
    everything finished by that moment (ties included) is done, the rest is
    not.  ``ALL_COMPLETED``: everything is done unless ``timeout`` (modeled
    seconds) cuts the job short, in which case the stragglers past the
    timeout land in ``not_done``.  Both lists are ordered by completion
    time (``done_s``, then task id) — the order a poller would see.
    """
    fs = list(fs)
    if return_when not in (ANY_COMPLETED, ALL_COMPLETED):
        raise ValueError(
            f"return_when must be ANY_COMPLETED or ALL_COMPLETED, got {return_when!r}"
        )
    ordered = sorted(fs, key=lambda f: (f.done_s, f.job_id, f.task_id))
    if not ordered:
        return [], []
    if return_when == ANY_COMPLETED:
        cut = ordered[0].done_s
    else:
        cut = float("inf")
    if timeout is not None:
        cut = min(cut, float(timeout))
    done = [f for f in ordered if f.done_s <= cut]
    if return_when == ALL_COMPLETED and timeout is None:
        done = ordered  # no cut: everything completed
    not_done = [f for f in ordered if f not in done]
    return done, not_done


def get_result(fs: Future | Sequence[Future]) -> Any:
    """Results in task order (one future -> its bare result).  The first
    failed task re-raises its exception, like ``Future.result``."""
    if isinstance(fs, Future):
        return fs.result()
    return [f.result() for f in sorted(fs, key=lambda f: (f.job_id, f.task_id))]
