"""Pluggable object stores for durable (serverless-survivable) checkpoints
— the port of ``repro.dist.object_store``: the same contract, layouts, op
log and prices, so the op logs and modeled seconds of the two packages are
equal for the same operations.

``LocalStore``
    A root directory on this host.  A *group* (one checkpoint step) is
    published by writing every object into ``.tmp-<uuid>/`` and renaming the
    directory into place with ``os.replace`` — readers see a complete group
    or nothing.  Re-publishing an existing group parks the old directory at
    ``.old-<group>-<uuid>`` immediately before the rename and deletes it
    after; if a crash strikes between the two renames, ``_housekeep`` renames
    the parked directory back, so ``latest()`` never goes backwards.

``S3Store``
    Simulated S3: a flat key->bytes map with S3 semantics — no rename, only
    atomic single-object puts and ranged GETs.  A group is published by
    putting every object under ``<group>/<generation>/`` and then putting
    the tiny ``<group>/.commit`` record *last*.  A writer killed between
    puts leaves orphaned generation objects and the previous (or no) commit
    record; readers never observe a torn group, and the orphans are swept by
    the next publish.

Every operation is appended to the op log (:class:`StoreOp`); ``S3Store``
prices each through a ``netsim.ChannelModel`` (default ``S3_STAGED``) and
``request_cost_usd()`` maps PUT/GET counts onto S3 request prices.
``LocalStore`` ops cost zero modeled seconds but are logged all the same.

Not ported yet: the span ``Tracer`` mirror (``attach_tracer`` raises,
ROADMAP A 2) and the fault-domain outage pricing (``arm_faults``), which
belong to the session and tracer copies.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import uuid
from pathlib import Path
from collections.abc import Mapping

from repro_torch.core import netsim

# S3 request prices (USD per request), the port's copy of the two constants
# of repro.core.cost_model
S3_USD_PER_PUT = 0.005 / 1000
S3_USD_PER_GET = 0.0004 / 1000


class WriterKilled(RuntimeError):
    """Injected mid-publish death of a checkpoint writer (fault tests)."""


@dataclasses.dataclass
class StoreOp:
    """One priced storage operation (mirrors ``core.communicator.CommEvent``:
    what moved, how big it was, and what the channel model says it cost)."""

    kind: str       # "put" | "get" | "head" | "list" | "delete"
    key: str
    nbytes: int
    time_s: float


class Store:
    """Durable object storage for checkpoint groups (see module docstring)."""

    name = "store"

    def __init__(self):
        self.ops: list[StoreOp] = []

    # -- op accounting -------------------------------------------------------

    def attach_tracer(self, tracer, rank: int = 0):
        """The reference mirrors every op onto a ``Tracer``'s store lane; the
        port has no ``Tracer`` yet."""
        raise NotImplementedError("the span Tracer is not ported yet (ROADMAP A 2)")

    def _op_usd(self, op: StoreOp) -> float:
        """Request billing for one op (the per-op share of
        :meth:`request_cost_usd`)."""
        if op.kind == "put":
            return S3_USD_PER_PUT
        if op.kind == "get":
            return S3_USD_PER_GET
        return 0.0

    def _price(self, kind: str, nbytes: int) -> float:
        return 0.0

    def _emit(self, op: StoreOp) -> StoreOp:
        """Log one op."""
        self.ops.append(op)
        return op

    def _record(self, kind: str, key: str, nbytes: int) -> StoreOp:
        return self._emit(
            StoreOp(kind, key, int(nbytes), self._price(kind, int(nbytes)))
        )

    @property
    def op_time_s(self) -> float:
        """Modeled seconds for the logged ops (the T_comm analogue of the
        checkpoint path in the §IV composition)."""
        return float(sum(o.time_s for o in self.ops))

    @property
    def puts(self) -> int:
        return sum(1 for o in self.ops if o.kind == "put")

    @property
    def gets(self) -> int:
        return sum(1 for o in self.ops if o.kind == "get")

    @property
    def bytes_put(self) -> int:
        return int(sum(o.nbytes for o in self.ops if o.kind == "put"))

    @property
    def bytes_got(self) -> int:
        return int(sum(o.nbytes for o in self.ops if o.kind == "get"))

    def reset_ops(self) -> None:
        self.ops.clear()

    def request_cost_usd(self) -> float:
        """S3 request pricing for the logged ops (the reference's
        ``ServerlessJobCost.storage_cost`` line)."""
        return self.puts * S3_USD_PER_PUT + self.gets * S3_USD_PER_GET

    # -- storage interface ---------------------------------------------------

    def put_objects_atomic(self, group: str, objects: Mapping[str, bytes]) -> None:
        """All-or-nothing publish of ``objects`` as group ``group``."""
        raise NotImplementedError

    def get_object(
        self, group: str, name: str, start: int | None = None, stop: int | None = None
    ) -> bytes:
        """Read ``[start, stop)`` of a committed object (full object when
        no range is given).  Raises ``KeyError`` for uncommitted groups or
        unknown objects."""
        raise NotImplementedError

    # ranged GETs issued concurrently by get_ranges: how many in-flight
    # requests the client keeps open (S3 SDKs default to 10-50 connections).
    # 1 == fully serial; backends that price per request amortize latency
    # across the pool.
    request_pool = 1

    def get_ranges(
        self, group: str, name: str, ranges: list[tuple[int, int]]
    ) -> list[bytes]:
        """Fetch many byte ranges of ONE committed object in one batch.

        Semantically identical to ``get_object`` per range; the batch form
        exists so priced backends can model the ranges as *concurrent*
        requests over a ``request_pool``-connection client instead of
        serial round trips — the difference between a resharded restore
        paying ~1000 serial per-request latencies and paying
        ``ceil(n/pool)`` of them.  Every range is still logged (and billed)
        as its own GET.
        """
        return [self.get_object(group, name, start, stop) for start, stop in ranges]

    def object_size(self, group: str, name: str) -> int:
        raise NotImplementedError

    def list_objects(self, group: str) -> list[str]:
        """Sorted object names in a committed group (data discovery: the
        jobs-layer partitioner enumerates a dataset with this + ranged
        GETs).  Raises ``KeyError`` for uncommitted groups."""
        raise NotImplementedError

    def committed(self, group: str) -> bool:
        raise NotImplementedError

    def list_groups(self) -> list[str]:
        """Sorted names of fully committed groups."""
        raise NotImplementedError

    def delete_group(self, group: str) -> None:
        raise NotImplementedError


class LocalStore(Store):
    """Directory-per-group store publishing via atomic directory rename."""

    name = "local"

    def __init__(self, root: str | Path):
        super().__init__()
        self.root = Path(root)

    def request_cost_usd(self) -> float:
        return 0.0  # local disk: no per-request pricing

    def _op_usd(self, op: StoreOp) -> float:
        return 0.0

    def _housekeep(self) -> None:
        """Recover interrupted publishes, then sweep writer garbage.

        A ``.old-<group>-<uuid>`` directory with no live ``<group>`` means a
        re-publish crashed between its two renames — the park rename
        happened, the publish rename did not.  Renaming the parked content
        back restores the previous committed state, so ``latest()`` never
        observes the step vanishing.
        """
        if not self.root.is_dir():
            return
        for parked in self.root.glob(".old-*"):
            orig = parked.name[len(".old-"):].rsplit("-", 1)[0]
            final = self.root / orig
            if final.exists():
                shutil.rmtree(parked, ignore_errors=True)
            else:
                os.replace(parked, final)
        for stale in self.root.glob(".tmp-*"):
            shutil.rmtree(stale, ignore_errors=True)

    def put_objects_atomic(self, group: str, objects: Mapping[str, bytes]) -> None:
        self.root.mkdir(parents=True, exist_ok=True)
        self._housekeep()
        final = self.root / group
        tmp = self.root / f".tmp-{uuid.uuid4().hex[:8]}"
        tmp.mkdir()
        try:
            for name, data in objects.items():
                (tmp / name).write_bytes(data)
                self._record("put", f"{group}/{name}", len(data))
            if final.exists():
                # Re-publish of an existing group.  Park the old content and
                # rename the new one in; a crash in between is recovered by
                # _housekeep (park is renamed back), so there is no window
                # with no committed checkpoint at this step.
                parked = self.root / f".old-{group}-{uuid.uuid4().hex[:8]}"
                os.replace(final, parked)
                os.replace(tmp, final)
                shutil.rmtree(parked, ignore_errors=True)
            else:
                os.replace(tmp, final)
        finally:
            if tmp.exists():
                shutil.rmtree(tmp, ignore_errors=True)

    def get_object(
        self, group: str, name: str, start: int | None = None, stop: int | None = None
    ) -> bytes:
        path = self.root / group / name
        if not path.is_file():
            raise KeyError(f"no object {group}/{name} in {self.root}")
        with open(path, "rb") as f:
            if start is None and stop is None:
                data = f.read()
            else:
                lo = start or 0
                f.seek(lo)
                data = f.read() if stop is None else f.read(max(stop - lo, 0))
        self._record("get", f"{group}/{name}", len(data))
        return data

    def object_size(self, group: str, name: str) -> int:
        path = self.root / group / name
        if not path.is_file():
            raise KeyError(f"no object {group}/{name} in {self.root}")
        self._record("head", f"{group}/{name}", 0)
        return path.stat().st_size

    def list_objects(self, group: str) -> list[str]:
        self._housekeep()
        self._record("list", group, 0)
        gdir = self.root / group
        if not gdir.is_dir():
            raise KeyError(f"no committed group {group!r} in {self.root}")
        return sorted(p.name for p in gdir.iterdir() if p.is_file())

    def committed(self, group: str) -> bool:
        self._housekeep()
        self._record("head", group, 0)
        return (self.root / group).is_dir()

    def list_groups(self) -> list[str]:
        self._housekeep()
        self._record("list", str(self.root), 0)
        if not self.root.is_dir():
            return []
        return sorted(
            p.name for p in self.root.iterdir()
            if p.is_dir() and not p.name.startswith(".")
        )

    def delete_group(self, group: str) -> None:
        self._record("delete", group, 0)
        shutil.rmtree(self.root / group, ignore_errors=True)


class S3Store(Store):
    """Simulated S3 with per-op pricing and put-then-commit-marker publish.

    ``fail_after_puts`` injects a writer death: the Nth subsequent object
    put raises :class:`WriterKilled` before the object lands, exactly the
    mid-publish kill the atomicity contract must survive.
    """

    name = "s3"
    _COMMIT = ".commit"
    # concurrent ranged-GET connections: CRT-style transfer clients hold
    # O(100) connections open and saturate them with part-sized requests
    request_pool = 128

    def __init__(self, channel: netsim.ChannelModel | None = None):
        super().__init__()
        self.channel = channel or netsim.S3_STAGED
        self._objects: dict[str, bytes] = {}
        self.fail_after_puts: int | None = None
        self._ranged_seq = 0  # in-flight slot cursor, persists across batches

    def reset_ops(self) -> None:
        super().reset_ops()
        self._ranged_seq = 0

    def _price(self, kind: str, nbytes: int) -> float:
        per_request = self.channel.alpha_s + self.channel.store_alpha_s
        if kind in ("put", "get"):
            return per_request + nbytes * self.channel.beta_s_per_byte
        return per_request  # head / list / delete: request latency only

    def _put(self, key: str, data: bytes) -> None:
        if self.fail_after_puts is not None:
            if self.fail_after_puts <= 0:
                raise WriterKilled(f"injected writer death before put of {key!r}")
            self.fail_after_puts -= 1
        self._objects[key] = bytes(data)
        self._record("put", key, len(data))

    def _commit_record(self, group: str) -> dict | None:
        raw = self._objects.get(f"{group}/{self._COMMIT}")
        return None if raw is None else json.loads(raw)

    def put_objects_atomic(self, group: str, objects: Mapping[str, bytes]) -> None:
        generation = uuid.uuid4().hex[:8]
        for name, data in objects.items():
            self._put(f"{group}/{generation}/{name}", data)
        # the commit record is the rename-marker: a single atomic put that
        # flips the group from invisible (or its previous generation) to the
        # new generation — there is no torn intermediate state
        self._put(
            f"{group}/{self._COMMIT}",
            json.dumps({"generation": generation, "objects": sorted(objects)}).encode(),
        )
        # sweep superseded/orphaned generations only after the new commit
        # is visible (a crash before this point leaves garbage, not damage)
        live = f"{group}/{generation}/"
        commit_key = f"{group}/{self._COMMIT}"
        stale = [
            k for k in self._objects
            if k.startswith(f"{group}/") and not k.startswith(live) and k != commit_key
        ]
        for k in stale:
            del self._objects[k]
        if stale:
            self._record("delete", f"{group}/* ({len(stale)} stale)", 0)

    def _resolve(self, group: str, name: str) -> bytes:
        rec = self._commit_record(group)
        if rec is None:
            raise KeyError(f"group {group!r} has no commit record")
        key = f"{group}/{rec['generation']}/{name}"
        if key not in self._objects:
            raise KeyError(f"no object {name!r} in committed group {group!r}")
        return self._objects[key]

    def get_object(
        self, group: str, name: str, start: int | None = None, stop: int | None = None
    ) -> bytes:
        data = self._resolve(group, name)
        if start is not None or stop is not None:
            data = data[start or 0: stop]
        self._record("get", f"{group}/{name}", len(data))
        return data

    def get_ranges(
        self, group: str, name: str, ranges: list[tuple[int, int]]
    ) -> list[bytes]:
        """Ranged GETs fanned over the client's connection pool.

        The shared store NIC still serializes the byte streams (the staged
        channels' no-1/P convention), but per-request latency overlaps
        across in-flight requests: n pooled ranges pay
        ``ceil(n / request_pool)`` round trips instead of n.  The pool is a
        property of the *client*, not of one batch — the slot cursor
        persists across calls, so a restore that walks many leaves fills
        the same connections instead of paying a fresh round trip per leaf.
        Modeled by charging the round trip once per pool-width of ops and
        beta on all of them: the op log's *sum* equals the pooled wall time
        while every GET stays individually logged for request billing.
        """
        data = self._resolve(group, name)
        per_request = self.channel.alpha_s + self.channel.store_alpha_s
        pool = max(1, int(self.request_pool))
        out = []
        for start, stop in ranges:
            chunk = data[start or 0: stop]
            lat = per_request if self._ranged_seq % pool == 0 else 0.0
            self._ranged_seq += 1
            self._emit(StoreOp(
                "get", f"{group}/{name}", len(chunk),
                lat + len(chunk) * self.channel.beta_s_per_byte,
            ))
            out.append(chunk)
        return out

    def object_size(self, group: str, name: str) -> int:
        data = self._resolve(group, name)
        self._record("head", f"{group}/{name}", 0)
        return len(data)

    def list_objects(self, group: str) -> list[str]:
        rec = self._commit_record(group)
        if rec is None:
            raise KeyError(f"group {group!r} has no commit record")
        self._record("list", group, 0)
        return sorted(rec["objects"])

    def committed(self, group: str) -> bool:
        self._record("head", f"{group}/{self._COMMIT}", 0)
        return self._commit_record(group) is not None

    def list_groups(self) -> list[str]:
        self._record("list", "", 0)
        groups = {k.split("/", 1)[0] for k in self._objects}
        return sorted(
            g for g in groups if f"{g}/{self._COMMIT}" in self._objects
        )

    def delete_group(self, group: str) -> None:
        self._record("delete", group, 0)
        for k in [k for k in self._objects if k.startswith(f"{group}/")]:
            del self._objects[k]


def as_store(target: str | Path | Store) -> Store:
    """Coerce a path-or-store argument: paths get a :class:`LocalStore`."""
    if isinstance(target, Store):
        return target
    return LocalStore(target)
