"""AST-driven invariant lint for modeled-clock hygiene (rules RPA001...).

Pure stdlib (``ast`` + ``re``): no repo imports, no third-party deps.  The
port's copy of ``repro.analysis.lintcheck``: the same rules, with one
difference — a path under ``repro_torch`` is modeled code as a path under
``repro`` is (:data:`MODELED_ROOTS`), so the port's ``core``, ``dist`` and
``jobs`` are held to the wall-clock and seeded-RNG rules too.  Output is
ruff-style: ``path:line:col: RPA001 message``; suppression is ruff-style
too (``# noqa`` or ``# noqa: RPA001[, RPA003]`` on the offending line,
with a justification encouraged).

Why these rules exist: the repo's performance claims live on a *modeled*
clock — every second is a priced simulation output, and the only
sanctioned wall-clock reads are the compute-measurement points that
rescale host time by ``platform.cpu_speed`` (those carry explicit
``noqa`` waivers).  Any other wall-clock read, unseeded RNG, deprecated
provider lookup, or hand-priced event silently forks the model from the
bill.  See :mod:`repro_torch.analysis` for the full rule table.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from pathlib import Path

# rules RPA001/RPA002 (wall clock, unseeded RNG) apply to modeled code only:
# the packages whose every emitted second must come from the channel /
# platform / cost models rather than the host
MODELED_PACKAGES = ("core", "dist", "jobs")
# the package roots those live under: the reference and the port
MODELED_ROOTS = ("repro", "repro_torch")

# the one module allowed to touch the raw CHANNELS/PLATFORMS tables and to
# implement the deprecated channel_env= compat path
REGISTRY_MODULE = "netsim.py"

_WALL_CLOCK = {
    "time.time", "time.time_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "time.monotonic", "time.monotonic_ns",
    "time.process_time", "time.process_time_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
}

# numpy's legacy global-state RNG entry points (always implicitly unseeded
# at the call site) and the stdlib equivalents
_GLOBAL_RNG = {
    "numpy.random." + f for f in (
        "random", "rand", "randn", "randint", "random_sample", "choice",
        "shuffle", "permutation", "uniform", "normal", "exponential",
        "poisson", "seed",
    )
} | {
    "random." + f for f in (
        "random", "randint", "randrange", "uniform", "choice", "choices",
        "shuffle", "sample", "gauss", "normalvariate", "expovariate",
        "seed", "betavariate", "triangular",
    )
}

# seedable RNG constructors: fine *with* an explicit seed argument
_SEEDABLE_RNG = {"numpy.random.default_rng", "random.Random"}

_NOQA_RE = re.compile(
    r"#\s*noqa(?::\s*(?P<codes>[A-Z]+\d+(?:\s*,\s*[A-Z]+\d+)*))?",
    re.IGNORECASE,
)


@dataclasses.dataclass(frozen=True)
class LintViolation:
    """One lint finding, ruff-style addressable."""

    path: str
    line: int
    col: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


def _suppressed(source_lines: list[str], line: int, rule: str) -> bool:
    """True when the 1-indexed ``line`` carries a ``noqa`` for ``rule``."""
    if not 1 <= line <= len(source_lines):
        return False
    m = _NOQA_RE.search(source_lines[line - 1])
    if m is None:
        return False
    codes = m.group("codes")
    if codes is None:
        return True
    return rule.upper() in {c.strip().upper() for c in codes.split(",")}


class _Checker(ast.NodeVisitor):
    def __init__(self, path: str, *, modeled: bool, registry: bool):
        self.path = path
        self.modeled = modeled      # under {repro,repro_torch}/{core,dist,jobs}
        self.registry = registry    # netsim.py itself
        self.violations: list[LintViolation] = []
        # local alias -> canonical dotted prefix ("np" -> "numpy",
        # "perf_counter" -> "time.perf_counter", ...)
        self.aliases: dict[str, str] = {}

    # -- name resolution -----------------------------------------------------

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self.aliases[a.asname or a.name.split(".")[0]] = a.name
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module and node.level == 0:
            for a in node.names:
                self.aliases[a.asname or a.name] = f"{node.module}.{a.name}"
        self.generic_visit(node)

    def _qualname(self, node: ast.AST) -> str | None:
        """Best-effort canonical dotted name for an expression."""
        if isinstance(node, ast.Name):
            return self.aliases.get(node.id, node.id)
        if isinstance(node, ast.Attribute):
            base = self._qualname(node.value)
            return f"{base}.{node.attr}" if base else None
        return None

    def _flag(self, node: ast.AST, rule: str, message: str) -> None:
        self.violations.append(LintViolation(
            self.path, getattr(node, "lineno", 0),
            getattr(node, "col_offset", 0), rule, message,
        ))

    # -- rules ---------------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        qual = self._qualname(node.func)
        if qual is not None:
            self._check_wall_clock(node, qual)
            self._check_rng(node, qual)
        self._check_channel_env(node)
        self._check_comm_event(node)
        self.generic_visit(node)

    def _check_wall_clock(self, node: ast.Call, qual: str) -> None:
        if self.modeled and qual in _WALL_CLOCK:
            self._flag(
                node, "RPA001",
                f"wall-clock read `{qual}()` in modeled code — every "
                f"second must come from the channel/platform model (waive "
                f"sanctioned compute-measurement points with a noqa)",
            )

    def _check_rng(self, node: ast.Call, qual: str) -> None:
        if not self.modeled:
            return
        if qual in _GLOBAL_RNG:
            self._flag(
                node, "RPA002",
                f"global-state RNG `{qual}()` in modeled code — draw from "
                f"an explicitly seeded Generator so faulted runs replay "
                f"bit-identically",
            )
        elif qual in _SEEDABLE_RNG and not node.args and not node.keywords:
            self._flag(
                node, "RPA002",
                f"`{qual}()` without a seed in modeled code — pass the "
                f"plan/session seed so runs are reproducible",
            )

    def _check_channel_env(self, node: ast.Call) -> None:
        if self.registry:
            return
        for kw in node.keywords:
            if kw.arg == "channel_env":
                self._flag(
                    node, "RPA003",
                    "deprecated `channel_env=` call site — say where this "
                    "runs with provider=/channel= (resolve_provider)",
                )

    def _check_comm_event(self, node: ast.Call) -> None:
        func = node.func
        name = func.id if isinstance(func, ast.Name) else (
            func.attr if isinstance(func, ast.Attribute) else None)
        if name != "CommEvent":
            return
        # CommEvent(kind, world, bytes_per_rank, time_s, ...): the modeled
        # time is positional index 3 or the time_s keyword
        time_arg = None
        if len(node.args) > 3:
            time_arg = node.args[3]
        for kw in node.keywords:
            if kw.arg == "time_s":
                time_arg = kw.value
        if isinstance(time_arg, ast.UnaryOp):
            time_arg = time_arg.operand
        if isinstance(time_arg, ast.Constant) and isinstance(
                time_arg.value, int | float) and time_arg.value != 0:
            self._flag(
                node, "RPA005",
                f"CommEvent priced with the literal `{time_arg.value}` — "
                f"time_s must come from a netsim/algorithms pricing call",
            )

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        if self._is_dataclass(node):
            for stmt in node.body:
                value = None
                if isinstance(stmt, ast.AnnAssign):
                    value = stmt.value
                elif isinstance(stmt, ast.Assign):
                    value = stmt.value
                if value is not None and self._is_mutable_literal(value):
                    self._flag(
                        stmt, "RPA006",
                        f"mutable dataclass default in {node.name} — use "
                        f"field(default_factory=...)",
                    )
        self.generic_visit(node)

    def _is_dataclass(self, node: ast.ClassDef) -> bool:
        for dec in node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            qual = self._qualname(target) or ""
            if qual.split(".")[-1] == "dataclass":
                return True
        return False

    def _is_mutable_literal(self, node: ast.AST) -> bool:
        if isinstance(node, ast.List | ast.Dict | ast.Set | ast.ListComp
                      | ast.DictComp | ast.SetComp):
            return True
        if isinstance(node, ast.Call):
            qual = self._qualname(node.func) or ""
            tail = qual.split(".")[-1]
            if tail in ("list", "dict", "set", "defaultdict", "deque"):
                return True
            if tail == "field":
                for kw in node.keywords:
                    if kw.arg == "default" and self._is_mutable_literal(
                            kw.value):
                        return True
        return False

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        if node.type is None:
            self._flag(
                node, "RPA007",
                "bare `except:` — recovery ladders must name what they "
                "catch (a bare clause swallows KeyboardInterrupt and "
                "injected faults alike)",
            )
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if not self.registry:
            name = None
            if isinstance(node.value, ast.Name):
                name = node.value.id
            elif isinstance(node.value, ast.Attribute):
                name = node.value.attr
            if name in ("CHANNELS", "PLATFORMS"):
                self._flag(
                    node, "RPA004",
                    f"direct `{name}[...]` lookup outside {REGISTRY_MODULE}"
                    f" — go through resolve_channel/resolve_platform/"
                    f"resolve_provider",
                )
        self.generic_visit(node)


def _classify(path: Path) -> tuple[bool, bool]:
    """(modeled, registry) classification from the file's path."""
    parts = path.parts
    modeled = any(
        part in MODELED_ROOTS and parts[idx + 1] in MODELED_PACKAGES
        for idx, part in enumerate(parts[:-1])
    )
    return modeled, path.name == REGISTRY_MODULE


def lint_source(source: str, path: str | os.PathLike) -> list[LintViolation]:
    """Lint one file's source text; returns unsuppressed violations."""
    p = Path(path)
    modeled, registry = _classify(p)
    try:
        tree = ast.parse(source, filename=str(p))
    except SyntaxError as exc:
        return [LintViolation(
            str(p), exc.lineno or 0, exc.offset or 0, "RPA000",
            f"syntax error: {exc.msg}",
        )]
    checker = _Checker(str(p), modeled=modeled, registry=registry)
    checker.visit(tree)
    lines = source.splitlines()
    return [
        v for v in checker.violations
        if not _suppressed(lines, v.line, v.rule)
    ]


def iter_python_files(paths) -> list[Path]:
    out: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            out.extend(sorted(
                f for f in p.rglob("*.py")
                if "__pycache__" not in f.parts
                and not any(part.startswith(".") for part in f.parts)
            ))
        elif p.suffix == ".py":
            out.append(p)
    return out


def lint_paths(paths) -> list[LintViolation]:
    """Lint every ``.py`` file under ``paths`` (files or directories)."""
    out: list[LintViolation] = []
    for f in iter_python_files(paths):
        out.extend(lint_source(f.read_text(encoding="utf-8"), f))
    return out
