"""CLI for the sanitizers: ``python -m repro_torch.analysis <command> ...``.

Commands::

    tracecheck FILE [FILE...] [--json REPORT]
        Audit exported Tracer timelines (``Tracer.to_json()`` artifacts,
        e.g. experiments/trace_*.json).  Exits 1 when any file violates.

    lint [PATH...] [--json REPORT]
        Run the invariant lint (default path: src).  Exits 1 on findings.

``--json REPORT`` additionally writes a machine-readable violation report
(one row per violation, with its source).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from repro_torch.analysis import check_trace, format_violations, lint_paths


def _write_report(path: str, rows: list[dict]) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"violations": rows}, fh, indent=2, sort_keys=True)
        fh.write("\n")


def _cmd_tracecheck(args: argparse.Namespace) -> int:
    rows: list[dict] = []
    total = 0
    for path in args.files:
        violations = check_trace(path)
        total += len(violations)
        if violations:
            print(format_violations(violations, source=path))
        else:
            print(f"{path}: clean")
        rows.extend(
            {"source": path, **dataclasses.asdict(v)} for v in violations
        )
    if args.json:
        _write_report(args.json, rows)
    if total:
        print(f"tracecheck: {total} violation(s) across {len(args.files)} "
              f"trace(s)", file=sys.stderr)
    return 1 if total else 0


def _cmd_lint(args: argparse.Namespace) -> int:
    violations = lint_paths(args.paths)
    for v in violations:
        print(v)
    if args.json:
        _write_report(
            args.json, [dataclasses.asdict(v) for v in violations])
    if violations:
        print(f"lintcheck: {len(violations)} violation(s)", file=sys.stderr)
    return 1 if violations else 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="modeled-clock sanitizers: tracecheck + lintcheck",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    tc = sub.add_parser(
        "tracecheck", help="audit exported Tracer timeline artifacts")
    tc.add_argument("files", nargs="+", help="trace JSON files to audit")
    tc.add_argument("--json", help="write a violation report JSON here")
    tc.set_defaults(func=_cmd_tracecheck)

    li = sub.add_parser("lint", help="run the invariant lint")
    li.add_argument(
        "paths", nargs="*", default=["src"],
        help="files/directories to lint (default: src)")
    li.add_argument("--json", help="write a violation report JSON here")
    li.set_defaults(func=_cmd_lint)

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
