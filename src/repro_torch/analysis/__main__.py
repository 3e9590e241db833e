"""CLI for repro_torch.analysis (own copy of ``repro.analysis.__main__``).

Subcommands::

    python -m repro_torch.analysis lint <module[:factory]> [...]
        Import each module, call its factory (default ``build``) to get
        pipelines (a PipelineSpec, a list of them, or a tuple whose first
        element is one), validate, print diagnostics.  Exit 1 on errors.

    python -m repro_torch.analysis sanitize <path|dir> [...]
        Check journal invariants over each ``.jsonl`` file (directories
        expand to every ``*.jsonl`` inside).  Exit 1 on violations.

    python -m repro_torch.analysis codes
        Print the diagnostic-code registry.
"""
from __future__ import annotations

import argparse
import glob
import importlib
import os
import sys

from repro_torch.analysis.diagnostics import CODES
from repro_torch.analysis.sanitizer import sanitize_file
from repro_torch.analysis.validate import validate_app


def _load_pipelines(target: str):
    mod_name, _, factory = target.partition(":")
    mod = importlib.import_module(mod_name)
    fn = getattr(mod, factory or "build")
    built = fn()
    if isinstance(built, tuple):
        built = built[0]
    return built


def _cmd_lint(targets) -> int:
    rc = 0
    for target in targets:
        pipes = _load_pipelines(target)
        report = validate_app(pipes)
        n_err = len(report.errors)
        print(f"== lint {target}: {n_err} error(s), "
              f"{len(report.warnings)} warning(s)")
        if report.diagnostics:
            print(report.format())
        if n_err:
            rc = 1
    return rc


def _expand(paths):
    out = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(glob.glob(os.path.join(p, "*.jsonl"))))
        else:
            out.append(p)
    return out


def _cmd_sanitize(paths) -> int:
    rc = 0
    files = _expand(paths)
    if not files:
        print("sanitize: no journal files found", file=sys.stderr)
        return 1
    for path in files:
        if not os.path.exists(path):
            print(f"sanitize: {path}: no such journal", file=sys.stderr)
            rc = 1
            continue
        report = sanitize_file(path)
        status = "clean" if report.ok else \
            f"{len(report.errors)} violation(s)"
        print(f"== sanitize {path}: {status}")
        if report.diagnostics:
            print(report.format())
        if not report.ok:
            rc = 1
    return rc


def _cmd_codes() -> int:
    for code, (slug, desc) in sorted(CODES.items()):
        print(f"{code}  {slug:24s} {desc}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.analysis")
    sub = ap.add_subparsers(dest="cmd", required=True)
    lint = sub.add_parser("lint", help="validate PST app declarations")
    lint.add_argument("targets", nargs="+",
                      help="module[:factory] building the pipelines")
    san = sub.add_parser("sanitize", help="check journal invariants")
    san.add_argument("paths", nargs="+",
                     help="journal .jsonl files or directories of them")
    sub.add_parser("codes", help="print the diagnostic-code registry")
    args = ap.parse_args(argv)
    if args.cmd == "lint":
        return _cmd_lint(args.targets)
    if args.cmd == "sanitize":
        return _cmd_sanitize(args.paths)
    return _cmd_codes()


if __name__ == "__main__":
    sys.exit(main())
