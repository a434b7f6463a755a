"""spotlint CLI — run the repo-specific rules over a source tree.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis.spotlint src/
    PYTHONPATH=src python -m repro_torch.analysis.spotlint --no-baseline path.py

Exit status is 0 only when every finding is suppressed (inline
``# spotlint: ignore[CODE]`` on the offending line, or a matching entry in
the baseline file) *and* no baseline entry is stale. A stale entry — one
whose recorded file:line no longer holds the recorded source text — fails
the run: baseline suppressions are promises about specific lines, and a
moved or edited line must be re-justified, not silently inherited.
"""

from __future__ import annotations

import argparse
import os
import sys

from . import crash_consistency, lanes, lifetimes, locks, netguard, retries
from .core import (BaselineEntry, Finding, ModuleInfo, RepoModel,
                   load_baseline, load_module, stale_baseline_entries)

RULE_MODULES = (crash_consistency, lanes, lifetimes, locks, netguard, retries)

DEFAULT_BASELINE = "spotlint.baseline"


def collect_files(paths: list[str]) -> list[str]:
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git")]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        files.append(os.path.join(dirpath, fn))
        elif p.endswith(".py"):
            files.append(p)
    return files


def analyze(files: list[str]) -> list[Finding]:
    """Parse `files` and run every rule; returns raw (unsuppressed)
    findings, deduplicated on (path, line, col, code)."""
    modules: list[ModuleInfo] = []
    for path in files:
        mod = load_module(path, os.path.normpath(path))
        if mod is not None:
            modules.append(mod)
    model = RepoModel(modules)
    findings: list[Finding] = []
    for rule in RULE_MODULES:
        findings.extend(rule.check_repo(model))
    seen: set[tuple] = set()
    out: list[Finding] = []
    for f in sorted(findings, key=Finding.sort_key):
        k = (f.path, f.line, f.col, f.code)
        if k not in seen:
            seen.add(k)
            out.append(f)
    return out


def apply_suppressions(findings: list[Finding], modules_by_path: dict[str, ModuleInfo],
                       baseline: list[BaselineEntry]) -> list[Finding]:
    by_key = {e.key(): e for e in baseline}
    kept: list[Finding] = []
    for f in findings:
        mod = modules_by_path.get(f.path)
        if mod is not None:
            inline = mod.suppressed.get(f.line, set())
            if f.code in inline:
                continue
        entry = by_key.get((f.path, f.code, f.line))
        if entry is not None and mod is not None \
                and mod.line_text(f.line).strip() == entry.content:
            entry.used = True
            continue
        kept.append(f)
    return kept


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="spotlint",
        description="repo-specific static analysis for the checkpoint layer")
    parser.add_argument("paths", nargs="+", help="files or directories")
    parser.add_argument("--baseline", default=None,
                        help=f"baseline suppression file "
                             f"(default: ./{DEFAULT_BASELINE} when present)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore any baseline file")
    args = parser.parse_args(argv)

    baseline_path = None
    if not args.no_baseline:
        baseline_path = args.baseline or (
            DEFAULT_BASELINE if os.path.exists(DEFAULT_BASELINE) else None)

    baseline: list[BaselineEntry] = []
    stale: list[str] = []
    if baseline_path:
        try:
            baseline = load_baseline(baseline_path)
        except (OSError, ValueError) as e:
            print(f"spotlint: cannot read baseline {baseline_path}: {e}",
                  file=sys.stderr)
            return 2
        stale = stale_baseline_entries(baseline)

    files = collect_files(args.paths)
    if not files:
        print("spotlint: no python files found", file=sys.stderr)
        return 2

    modules_by_path: dict[str, ModuleInfo] = {}
    for path in files:
        mod = load_module(path, os.path.normpath(path))
        if mod is not None:
            modules_by_path[mod.relpath] = mod

    model = RepoModel(list(modules_by_path.values()))
    raw: list[Finding] = []
    for rule in RULE_MODULES:
        raw.extend(rule.check_repo(model))
    seen: set[tuple] = set()
    findings: list[Finding] = []
    for f in sorted(raw, key=Finding.sort_key):
        k = (f.path, f.line, f.col, f.code)
        if k not in seen:
            seen.add(k)
            findings.append(f)

    findings = apply_suppressions(findings, modules_by_path, baseline)

    for f in findings:
        print(f.format())
    for msg in stale:
        print(f"stale-baseline: {msg}")
    for e in baseline:
        if not e.used and not stale:
            print(f"spotlint: note: unused baseline entry "
                  f"{e.relpath}:{e.lineno} {e.code} (line still matches; "
                  f"remove it if the violation is gone)", file=sys.stderr)

    n_files = len(modules_by_path)
    if findings or stale:
        print(f"spotlint: {len(findings)} finding(s), {len(stale)} stale "
              f"baseline entr(ies) across {n_files} file(s)")
        return 1
    print(f"spotlint: clean — {n_files} file(s), "
          f"{len(baseline)} baseline suppression(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
