"""dflint — this fabric's static concurrency-and-resource analyzer.

Usage::

    python -m dragonfly2_tpu_torch.tools.dflint [--json] [--stats] \
        [--changed] [paths…]

Counterpart of ``dragonfly2_tpu/tools/dflint.py``: the same rules, flags,
schemas and exit codes, rooted at the port package.

With no paths, lints the whole ``dragonfly2_tpu_torch`` package with the
two-pass interprocedural engine: an index pass builds package-wide
symbol tables and per-function summaries, and the analysis pass resolves
call edges across module boundaries (see docs/ANALYSIS.md, "Engine").
``--changed`` lints only files differing from the git merge-base with
upstream (fast pre-commit mode). ``--json`` emits machine-readable
findings, including every suppression and its mandatory reason.
``--stats`` emits per-rule finding counts, per-pass wall time, and
per-module cache hit/miss counts. Exit status: 0 clean (or
suppressed-only), 1 unsuppressed findings, 2 usage/IO error.

Rules live in ``dragonfly2_tpu_torch.tools.dflint_rules`` — one per hazard
class this repo has actually hit (see docs/ANALYSIS.md for the
catalogue and the incident behind each rule). The tier-1 gate
(tests/test_torch_dflint.py) runs this over the package and fails on any
unsuppressed finding, so concurrency discipline is enforced
mechanically rather than by reviewer memory.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from .dflint_rules import Finding, lint_paths

PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PKG_ROOT)


def _git(args: list[str]) -> str | None:
    try:
        out = subprocess.run(["git", *args], cwd=REPO_ROOT,
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def changed_files(git=_git) -> list[str]:
    """Package python files differing from the **merge-base** with
    upstream — the cheap pre-commit surface, scoped to what the tier-1
    gate enforces (tests legitimately block their private loops).

    The changed set is one ``git diff <merge-base>`` against the working
    tree: that covers both branch-local commits (so CI on a feature
    branch lints everything the branch touched, not just dirty files)
    and uncommitted edits. The index (``--cached``) is deliberately NOT
    consulted — staging state is a laptop-local artifact CI doesn't
    have, and diffing it scoped branches wrong. Falls back through
    origin/main to plain HEAD when no upstream exists. Untracked files
    are unioned in: brand-new files never appear in ``git diff`` and are
    exactly the files most likely to carry fresh hazards.

    ``git`` is injectable for tests."""
    base = None
    for ref in ("@{upstream}", "origin/main", "origin/master"):
        base = git(["merge-base", "HEAD", ref])
        if base:
            break
    diff = git(["diff", "--name-only", base or "HEAD", "--",
                "*.py"]) or ""
    untracked = git(["ls-files", "--others", "--exclude-standard",
                     "--", "*.py"]) or ""
    diff = diff + "\n" + untracked
    out = []
    for rel in dict.fromkeys(ln for ln in diff.splitlines() if ln.strip()):
        path = os.path.join(REPO_ROOT, rel)
        if (os.path.exists(path) and rel.endswith(".py")
                and os.path.abspath(path).startswith(PKG_ROOT + os.sep)):
            out.append(path)
    return out


def run(paths: list[str], *, as_json: bool = False, with_stats: bool = False,
        out=sys.stdout) -> int:
    stats: dict = {}
    findings = lint_paths(paths, repo_root=REPO_ROOT, stats=stats)
    active = [f for f in findings if not f.suppressed]
    suppressed = [f for f in findings if f.suppressed]
    if with_stats:
        # the CI-facing shape: per-rule counts + per-pass wall time, so
        # the gate's own latency is observable and regression-gateable
        json.dump({
            "counts": {"findings": len(active),
                       "suppressed": len(suppressed),
                       "by_code": _by_code(active),
                       "by_code_suppressed": _by_code(suppressed)},
            "passes": {"index_s": stats.get("index_s", 0.0),
                       "analysis_s": stats.get("analysis_s", 0.0)},
            "cache": {"hits": stats.get("cache_hits", 0),
                      "misses": stats.get("cache_misses", 0)},
            "files": stats.get("files", 0),
            "modules_indexed": stats.get("modules_indexed", 0),
        }, out, indent=2)
        out.write("\n")
    elif as_json:
        json.dump({
            "findings": [f.as_dict() for f in active],
            "suppressed": [f.as_dict() for f in suppressed],
            "counts": {"findings": len(active),
                       "suppressed": len(suppressed),
                       "by_code": _by_code(active)},
        }, out, indent=2)
        out.write("\n")
    else:
        # text mode prints only real findings — 50+ justified
        # suppressions would bury the one line that matters; the full
        # suppression ledger (with reasons) lives behind --json
        for f in active:
            print(f.render(), file=out)
        print(f"dflint: {len(active)} finding(s), "
              f"{len(suppressed)} suppressed", file=out)
    return 1 if active else 0


def _by_code(findings: list[Finding]) -> dict[str, int]:
    counts: dict[str, int] = {}
    for f in findings:
        counts[f.code] = counts.get(f.code, 0) + 1
    return dict(sorted(counts.items()))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="dflint", description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint "
                         "(default: the dragonfly2_tpu_torch package)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output incl. suppressions")
    ap.add_argument("--stats", action="store_true", dest="with_stats",
                    help="JSON per-rule finding counts, per-pass wall "
                         "time, and cache hit/miss counts")
    ap.add_argument("--changed", action="store_true",
                    help="lint only files differing from the git "
                         "merge-base with upstream")
    args = ap.parse_args(argv)

    if args.changed:
        paths = changed_files()
        if not paths:
            if not (args.as_json or args.with_stats):
                print("dflint: no changed python files")
                return 0
            # machine-readable modes keep their schema on the empty set
            # — a CI pipeline piping --stats to jq must not get prose
            # precisely on the branches with nothing to lint. One
            # schema definition: run() on the empty file list emits the
            # same all-zeros payload the non-empty path would
            return run([], as_json=args.as_json,
                       with_stats=args.with_stats)
    elif args.paths:
        paths = [os.path.abspath(p) for p in args.paths]
        missing = [p for p in paths if not os.path.exists(p)]
        if missing:
            print(f"dflint: no such path: {', '.join(missing)}",
                  file=sys.stderr)
            return 2
    else:
        paths = [PKG_ROOT]
    return run(paths, as_json=args.as_json, with_stats=args.with_stats)


if __name__ == "__main__":
    sys.exit(main())
