"""dflint rule engine: one registry, one walker, one output format.

Counterpart of ``dragonfly2_tpu/tools/dflint_rules/__init__.py``: the
same rules, grammar and engine version, with its own cache file
(``CACHE_NAME``) so one repo root can hold both engines' results.

dflint is this fabric's project-specific static analyzer. Every rule is
distilled from a real post-mortem (the incident lives in the rule's
docstring), because three early changes each burned a debugging cycle on
the *same class* of asyncio bug: a lost ``wait_for`` cancellation, a
cross-task ``wait_for(cond.wait(), t)`` lock leak that deadlocked the pod
with zero log output, and event-loop starvation from per-byte CPU on the
loop thread. The daemon runs
ONE event loop; anything that blocks it caps feeder throughput for every
task in the process, which is exactly the core-bound bottleneck the
concurrency-limits literature (PAPERS.md) identifies.

v2 (this engine) is **two-pass and package-wide**: pass 1 builds a
``symbols.PackageIndex`` (per-module symbol tables, imports resolved
within the package, per-function summaries at fixpoint), pass 2 runs the
rules with call sites resolved against the index — so DF001/DF005 follow
calls through ``common/``/``storage/``/``daemon/``/``scheduler/``
boundaries instead of going blind at each ``import``, and the DF007–9
dataflow families can reason about resources that cross modules. Module
rules are cached per module, keyed by content hash + the interface
digest of every imported module (see ``interface_digest``): an edit
re-analyzes only the touched module and the dependents whose *observable
interface* actually moved, which is what keeps the tier-1 gate fast.
Rules that need the whole graph at once (the DF009 lock-ordering cycle
check) register as GLOBAL_RULES and re-run every time — the graph walk
is cheap once the summaries exist.

Suppression grammar (the reason is MANDATORY and surfaced in ``--json``)::

    some_call()  # dflint: disable=DF001 — tiny /proc read, not worth a hop

A suppression comment applies to findings on its own line or on the line
directly below it (banner form).  A ``# dflint:`` comment that does not
parse — unknown code, missing reason — is itself a finding (DF000) so a
suppression can never silently rot.

See docs/ANALYSIS.md for the rule catalogue and the engine design.
"""

from __future__ import annotations

import ast
import hashlib
import io
import json
import os
import re
import time
import tokenize
from dataclasses import dataclass, field
from typing import Iterable, Iterator

from .symbols import (ModuleIndex, PackageIndex, SUPPRESS_RE,
                      package_root_for)

__all__ = [
    "Finding", "Suppression", "ModuleCtx", "Rule", "RULES", "GLOBAL_RULES",
    "lint_source", "lint_file", "lint_paths",
]

#: bump when rule semantics change — invalidates every cache entry
ENGINE_VERSION = "2.1"
#: the reference engine keeps ``.dflint_cache.json`` under the same repo
#: root with the same key format and ENGINE_VERSION: a shared file would
#: serve one engine the other's results, so the port keeps its own
CACHE_NAME = ".dflint_torch_cache.json"

# the one suppression grammar, shared with the index pass (symbols.py)
_SUPPRESS_RE = SUPPRESS_RE
_MENTION_RE = re.compile(r"#\s*dflint\s*:")

#: modules whose rules sweep the whole package themselves (faultgate
#: fire sites, priority-class surfaces) — their findings depend on files
#: the import graph doesn't see, so they are never served from cache
_NEVER_CACHE = ("common/faultgate.py", "idl/messages.py")


@dataclass
class Suppression:
    """One parsed ``# dflint: disable=…`` comment."""
    codes: tuple[str, ...]
    reason: str
    line: int
    used: bool = False


@dataclass
class Finding:
    code: str
    path: str           # repo-relative when under repo_root
    line: int
    col: int
    message: str
    suppression: Suppression | None = None

    @property
    def suppressed(self) -> bool:
        return self.suppression is not None

    def as_dict(self) -> dict:
        d = {"code": self.code, "path": self.path, "line": self.line,
             "col": self.col, "message": self.message}
        if self.suppression is not None:
            d["suppressed"] = True
            d["reason"] = self.suppression.reason
        return d

    def render(self) -> str:
        tag = " (suppressed: %s)" % self.suppression.reason \
            if self.suppression else ""
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.code} {self.message}{tag}")


@dataclass
class ModuleCtx:
    """Everything a rule may need about one module under analysis."""
    path: str                   # absolute
    rel: str                    # repo-relative (display + scoping)
    src: str
    tree: ast.Module
    repo_root: str
    # cross-file caches shared by every module of one lint run (docs
    # text, package-wide faultgate fire sites, …) — see catalogue rules
    project: dict = field(default_factory=dict)
    # pass-1 products: this module's symbol table and the package index
    # it belongs to (a solo index for standalone files) — what lets the
    # analysis pass resolve call edges across module boundaries
    mod: ModuleIndex | None = None
    index: PackageIndex | None = None


class Rule:
    """Base class: subclass, set ``code``/``name``, implement ``check``.

    The class docstring of each concrete rule carries the incident that
    motivates it — dflint rules are post-mortems made executable, and the
    docstring is the part a developer reads when the rule fires on them.
    """

    code: str = "DF000"
    name: str = "base"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError


class GlobalRule(Rule):
    """A rule that needs the whole package graph at once (lock-ordering
    cycles span modules, so no per-module pass can see them). Runs once
    per package index; findings are attributed to the module each edge
    site lives in, and only sites inside *analyzed* modules report."""

    def check_package(self, index: PackageIndex,
                      analyzed: dict[str, str],
                      ) -> Iterator[Finding]:  # pragma: no cover
        """``analyzed`` maps modname -> repo-relative display path for
        every module in this lint run's scope."""
        raise NotImplementedError


#: The registries. Populated by the rule modules at import time below.
RULES: list[Rule] = []
GLOBAL_RULES: list[GlobalRule] = []


def register(rule_cls: type[Rule]) -> type[Rule]:
    RULES.append(rule_cls())
    return rule_cls


def register_global(rule_cls: type[GlobalRule]) -> type[GlobalRule]:
    GLOBAL_RULES.append(rule_cls())
    return rule_cls


# ---------------------------------------------------------------------------
# suppression scanning
# ---------------------------------------------------------------------------

def scan_suppressions(src: str, rel: str) -> tuple[list[Suppression],
                                                   list[Finding]]:
    """Parse every ``# dflint:`` comment; malformed ones become DF000
    findings (a suppression with no reason is itself a violation — the
    reason is the suppression's audit trail)."""
    sups: list[Suppression] = []
    bad: list[Finding] = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(src).readline)
        comments = [(t.start[0], t.start[1], t.string) for t in tokens
                    if t.type == tokenize.COMMENT]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return [], []
    for line, col, text in comments:
        if not _MENTION_RE.search(text):
            continue
        m = _SUPPRESS_RE.search(text)
        if m is None:
            bad.append(Finding(
                "DF000", rel, line, col,
                "malformed dflint suppression — grammar is "
                "`# dflint: disable=DF00X — <reason>` and the reason "
                "is mandatory"))
            continue
        codes = tuple(c.strip() for c in m.group("codes").split(","))
        sups.append(Suppression(codes, m.group("reason"), line))
    return sups, bad


def _apply_suppressions(findings: list[Finding], sups: list[Suppression],
                        rel: str,
                        summary_used: set[tuple[str, int]] = frozenset(),
                        ) -> None:
    by_line: dict[int, list[Suppression]] = {}
    for s in sups:
        by_line.setdefault(s.line, []).append(s)
    for f in findings:
        if f.code == "DF000":
            continue        # the suppression police cannot be suppressed
        for line in (f.line, f.line - 1):
            done = False
            for s in by_line.get(line, ()):
                if f.code in s.codes:
                    f.suppression = s
                    s.used = True
                    done = True
                    break
            if done:
                break
    # a definition-site suppression the index pass consumed (it retired
    # a hazard from a function's package-wide summary) is used even when
    # no module-local finding matched it
    for code, line in summary_used:
        for s_line in (line, line - 1):
            for s in by_line.get(s_line, ()):
                if code in s.codes:
                    s.used = True
    # a suppression that matches nothing is rot: the hazard it excused
    # was fixed or moved, and leaving it in place would silently excuse
    # the NEXT finding introduced on that line
    for s in sups:
        if not s.used:
            findings.append(Finding(
                "DF000", rel, s.line, 0,
                f"unused suppression for {', '.join(s.codes)} — no "
                f"matching finding on this or the next line; remove it "
                f"(a stale disable would mask the next real hazard here)"))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _rel_of(path: str, root: str) -> str:
    apath = os.path.abspath(path)
    return os.path.relpath(apath, root) if apath.startswith(root) else path


def _run_module_rules(ctx: ModuleCtx) -> list[Finding]:
    findings: list[Finding] = []
    for rule in RULES:
        findings.extend(rule.check(ctx))
    return findings


def lint_source(src: str, path: str, *, repo_root: str | None = None,
                project: dict | None = None) -> list[Finding]:
    """Lint one module's source text. Returns ALL findings, suppressed
    ones included (marked); callers filter on ``.suppressed``.

    This path indexes the module *solo* (imports resolve to nothing), so
    analysis is module-local — the behavior fixtures pin. Package-wide
    resolution happens in ``lint_paths``, which indexes the whole
    package a file belongs to before analyzing it."""
    root = os.path.abspath(repo_root or os.getcwd())
    apath = os.path.abspath(path)
    rel = _rel_of(apath, root)
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as exc:
        return [Finding("DF000", rel, exc.lineno or 1, exc.offset or 0,
                        f"syntax error, file not analyzed: {exc.msg}")]
    index = PackageIndex.solo(apath, src, tree)
    mi = index.by_path[apath]
    ctx = ModuleCtx(path=apath, rel=rel, src=src, tree=tree,
                    repo_root=root,
                    project=project if project is not None else {},
                    mod=mi, index=index)
    sups, bad = scan_suppressions(src, rel)
    findings: list[Finding] = list(bad)
    findings.extend(_run_module_rules(ctx))
    for rule in GLOBAL_RULES:
        findings.extend(rule.check_package(index, {mi.modname: rel}))
    _apply_suppressions(findings, sups, rel, mi.summary_used)
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    return findings


def lint_file(path: str, *, repo_root: str | None = None,
              project: dict | None = None) -> list[Finding]:
    with open(path, encoding="utf-8") as f:
        src = f.read()
    return lint_source(src, path, repo_root=repo_root, project=project)


def iter_py_files(paths: Iterable[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d != "__pycache__")
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(dirpath, name)
        elif p.endswith(".py"):
            yield p


# -- the per-module result cache --------------------------------------------

def _cache_salt(root: str) -> str:
    """Rule results also depend on the docs the catalogue rules diff
    against — fold them (and the engine version) into every key."""
    h = hashlib.sha256(ENGINE_VERSION.encode())
    for doc in ("OBSERVABILITY.md", "RESILIENCE.md"):
        try:
            with open(os.path.join(root, "docs", doc), "rb") as f:
                h.update(f.read())
        except OSError:
            h.update(b"absent")
    return h.hexdigest()


def _load_cache(root: str) -> dict:
    try:
        with open(os.path.join(root, CACHE_NAME), encoding="utf-8") as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else {}
    except (OSError, ValueError):
        return {}


def _save_cache(root: str, cache: dict) -> None:
    try:
        with open(os.path.join(root, CACHE_NAME), "w",
                  encoding="utf-8") as f:
            json.dump(cache, f)
    except OSError:
        pass        # read-only checkout: the cache is an optimization


def _from_cache_entry(entry: dict, rel: str) -> list[Finding]:
    return [Finding(d["code"], rel, d["line"], d["col"], d["message"])
            for d in entry.get("f", ())]


def lint_paths(paths: Iterable[str], *,
               repo_root: str | None = None,
               stats: dict | None = None) -> list[Finding]:
    """Lint every ``.py`` under the given files/directories.

    Two passes: index every package the files belong to (symbol tables +
    summaries at fixpoint), then analyze each requested module against
    the index. Per-module results are served from ``CACHE_NAME``
    when neither the module's content nor the interface of anything it
    imports has changed. ``stats``, when given, is filled with per-pass
    wall times and cache hit/miss counts (the ``--stats`` payload)."""
    root = os.path.abspath(repo_root or os.getcwd())
    files = list(dict.fromkeys(
        os.path.abspath(p) for p in iter_py_files(paths)))

    t0 = time.perf_counter()
    indexes: dict[str, PackageIndex] = {}
    pkg_of: dict[str, str | None] = {}
    for path in files:
        pr = package_root_for(path)
        pkg_of[path] = pr
        if pr is not None and pr not in indexes:
            indexes[pr] = PackageIndex(pr)
    t_index = time.perf_counter() - t0

    salt = _cache_salt(root)
    cache = _load_cache(root)
    next_cache: dict = {}
    hits = misses = 0
    project: dict = {}
    findings: list[Finding] = []
    # per-file raw findings + suppressions, finalized after global rules
    per_file: dict[str, tuple] = {}
    analyzed: dict[str, dict[str, str]] = {}    # pkg -> modname -> rel
    solo_mods: list[tuple[PackageIndex, str, str]] = []

    t1 = time.perf_counter()
    for path in files:
        rel = _rel_of(path, root)
        index = indexes.get(pkg_of[path]) if pkg_of[path] else None
        mi = index.by_path.get(path) if index is not None else None
        if mi is None and index is not None:
            index = None            # unparsable: fall through to solo
        if mi is None:
            try:
                with open(path, encoding="utf-8") as f:
                    src = f.read()
                tree = ast.parse(src, filename=path)
            except OSError:
                continue
            except SyntaxError as exc:
                findings.append(Finding(
                    "DF000", rel, exc.lineno or 1, exc.offset or 0,
                    f"syntax error, file not analyzed: {exc.msg}"))
                continue
            index = PackageIndex.solo(path, src, tree)
            mi = index.by_path[path]
            solo_mods.append((index, mi.modname, rel))
        else:
            analyzed.setdefault(pkg_of[path], {})[mi.modname] = rel
        sups, bad = scan_suppressions(mi.src, rel)
        key = rel.replace(os.sep, "/")
        entry = cache.get(key)
        surface = index.import_surface_digest(mi)
        cacheable = not key.endswith(_NEVER_CACHE)
        if (cacheable and entry is not None
                and entry.get("ch") == mi.content_hash
                and entry.get("ih") == surface
                and entry.get("salt") == salt):
            raw = _from_cache_entry(entry, rel)
            hits += 1
        else:
            ctx = ModuleCtx(path=path, rel=rel, src=mi.src, tree=mi.tree,
                            repo_root=root, project=project,
                            mod=mi, index=index)
            raw = _run_module_rules(ctx)
            misses += 1
        if cacheable:
            next_cache[key] = {
                "ch": mi.content_hash, "ih": surface, "salt": salt,
                "f": [{"code": f.code, "line": f.line, "col": f.col,
                       "message": f.message} for f in raw]}
        per_file[rel] = (raw, sups, bad, mi.summary_used)

    # global rules: once per package graph, cycle edges and all — their
    # findings land in the owning module's bucket so its suppressions
    # (and the DF000 unused-suppression audit) see them
    for pkg, mods in analyzed.items():
        for rule in GLOBAL_RULES:
            for f in rule.check_package(indexes[pkg], mods):
                if f.path in per_file:
                    per_file[f.path][0].append(f)
                else:
                    findings.append(f)
    # standalone files get the same global pass over their solo index
    # (lint_source already does this — the CLI must not disagree with
    # the library on a shipped rule). Runs AFTER the cache write above,
    # so global findings are never serialized into a cache entry.
    for solo_index, modname, rel in solo_mods:
        for rule in GLOBAL_RULES:
            for f in rule.check_package(solo_index, {modname: rel}):
                if f.path in per_file:
                    per_file[f.path][0].append(f)
                else:
                    findings.append(f)

    for rel, (raw, sups, bad, summary_used) in per_file.items():
        merged = raw + bad
        _apply_suppressions(merged, sups, rel, summary_used)
        findings.extend(merged)
    t_analysis = time.perf_counter() - t1

    # merge, don't replace: a scoped run (--changed, one file) must not
    # evict the full-package entries a gate run paid for — staleness is
    # already policed per entry by the ch/ih/salt key. Prune what merge
    # can't: entries for deleted/renamed files and absolute-path keys
    # (out-of-root lint targets), or the file grows across every branch
    # switch forever
    cache.update(next_cache)
    cache = {k: v for k, v in cache.items()
             if not os.path.isabs(k)
             and os.path.exists(os.path.join(root, k))}
    _save_cache(root, cache)
    if stats is not None:
        stats.update({
            "files": len(files),
            "modules_indexed": sum(len(ix.modules)
                                   for ix in indexes.values()),
            "index_s": round(t_index, 4),
            "analysis_s": round(t_analysis, 4),
            "cache_hits": hits,
            "cache_misses": misses,
        })
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    return findings


# rule modules self-register on import — keep these at the bottom so the
# registry and helpers above exist when they do
from . import concurrency  # noqa: E402,F401
from . import catalogue    # noqa: E402,F401
from . import dataflow     # noqa: E402,F401
from . import lockgraph    # noqa: E402,F401
