"""DF006: observable-vocabulary catalogue lints, consolidated.

Counterpart of ``dragonfly2_tpu/tools/dflint_rules/catalogue.py``; the
seven vocabularies read the same ``docs/OBSERVABILITY.md`` and
``docs/RESILIENCE.md``.

These started life as three ad-hoc runtime lints buried in
tests/test_observability.py (metric catalogue) and tests/test_faults.py
(faultgate sites, rung names): walk the live registry after importing
every service, then diff against the docs. Moving them into dflint makes
them static (no imports, so a module nobody imports is still covered),
gives them the one shared suppression grammar, and leaves ONE registry,
ONE walker, ONE output format for every project invariant.

Incident (catalogue audit): docs/OBSERVABILITY.md trailed the code by a third
of the metric namespace — a metric that exists only in code is invisible
to operators, and an undocumented flight-event kind or ladder rung is a
/debug/flight surface nobody can read.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterator

from . import Finding, ModuleCtx, Rule, register
from .concurrency import _terminal

_METRIC_METHODS = frozenset({"counter", "gauge", "histogram"})
_FIRE_RE = re.compile(
    r"faultgate\.(?:fire|fire_sync|corrupt)\(\s*[\"']([a-z.]+)[\"']")
_TICK_RE = re.compile(r"`([a-z0-9_.-]+)`")   # hyphens: exclusion reasons
_METRIC_NAME_RE = re.compile(r"df_[a-z0-9_]+")


def _read_doc(ctx: ModuleCtx, name: str) -> str | None:
    key = f"doc:{name}"
    if key not in ctx.project:
        path = os.path.join(ctx.repo_root, "docs", name)
        try:
            with open(path, encoding="utf-8") as f:
                ctx.project[key] = f.read()
        except OSError:
            ctx.project[key] = None
    return ctx.project[key]


def _doc_metric_names(ctx: ModuleCtx) -> set[str] | None:
    if "doc_metrics" not in ctx.project:
        doc = _read_doc(ctx, "OBSERVABILITY.md")
        ctx.project["doc_metrics"] = (
            None if doc is None else set(_METRIC_NAME_RE.findall(doc)))
    return ctx.project["doc_metrics"]


def _ticked(ctx: ModuleCtx, name: str) -> set[str]:
    key = f"ticked:{name}"
    if key not in ctx.project:
        doc = _read_doc(ctx, name)
        ctx.project[key] = set() if doc is None else \
            set(_TICK_RE.findall(doc))
    return ctx.project[key]


@register
class MetricCatalogue(Rule):
    """DF006 (metrics): every registered metric must be ``df_``-prefixed,
    carry help text, and appear in docs/OBSERVABILITY.md.

    Replaces tests/test_observability.py's runtime registry walk (the
    metric-namespace lint and the catalogue lint). Static analysis covers
    modules the old import list forgot to enumerate.
    """

    code = "DF006"
    name = "metric-catalogue"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _METRIC_METHODS
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            mname = node.args[0].value
            if not mname.startswith("df_"):
                yield Finding(
                    self.code, ctx.rel, node.lineno, node.col_offset,
                    f"metric {mname!r} is outside the df_ namespace — "
                    f"every metric this fabric exports is df_-prefixed")
                continue
            help_arg = None
            if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant):
                help_arg = node.args[1].value
            elif len(node.args) < 2:
                for kw in node.keywords:
                    if kw.arg == "help_" and isinstance(kw.value,
                                                        ast.Constant):
                        help_arg = kw.value.value
            if isinstance(help_arg, str) and not help_arg.strip() \
                    or (len(node.args) < 2
                        and not any(kw.arg == "help_"
                                    for kw in node.keywords)):
                yield Finding(
                    self.code, ctx.rel, node.lineno, node.col_offset,
                    f"metric {mname!r} registered without help text — "
                    f"/metrics must stay self-describing as it grows")
            documented = _doc_metric_names(ctx)
            if documented is None:
                if not ctx.project.get("warned_no_obs_doc"):
                    ctx.project["warned_no_obs_doc"] = True
                    yield Finding(
                        self.code, ctx.rel, node.lineno, node.col_offset,
                        "docs/OBSERVABILITY.md not found — the metric "
                        "catalogue has nothing to lint against")
            elif mname not in documented:
                yield Finding(
                    self.code, ctx.rel, node.lineno, node.col_offset,
                    f"metric {mname!r} is not documented in "
                    f"docs/OBSERVABILITY.md — a metric that exists only "
                    f"in code is invisible to operators")


@register
class FlightVocabulary(Rule):
    """DF006 (flight recorder): every event kind and ladder rung the
    journal can emit must be backticked in the docs (kinds in
    OBSERVABILITY.md; rungs there or in RESILIENCE.md, where the ladder
    lives). An undocumented stage in a /debug/flight dump is a surface
    operators cannot read. Replaces the runtime vocabulary lint."""

    code = "DF006"
    name = "flight-vocabulary"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        if not ctx.rel.replace(os.sep, "/").endswith(
                "daemon/flight_recorder.py"):
            return
        obs = _ticked(ctx, "OBSERVABILITY.md")
        any_doc = obs | _ticked(ctx, "RESILIENCE.md")
        for node in ctx.tree.body:
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            else:
                continue
            if not (isinstance(value, ast.Constant)
                    and isinstance(value.value, str) and value.value):
                continue
            for tgt in targets:
                if not (isinstance(tgt, ast.Name) and tgt.id.isupper()):
                    continue
                if tgt.id.startswith("RUNG_"):
                    if value.value not in any_doc:
                        yield Finding(
                            self.code, ctx.rel, node.lineno,
                            node.col_offset,
                            f"ladder rung {value.value!r} ({tgt.id}) is "
                            f"emitted in flight journals but undocumented "
                            f"in docs/OBSERVABILITY.md or RESILIENCE.md")
                elif value.value not in obs:
                    yield Finding(
                        self.code, ctx.rel, node.lineno, node.col_offset,
                        f"flight event kind {value.value!r} ({tgt.id}) is "
                        f"emitted in flight journals but undocumented in "
                        f"docs/OBSERVABILITY.md")


@register
class DecisionVocabulary(Rule):
    """DF006 (decision ledger): the scheduling filter's exclusion-reason
    vocabulary must stay closed and documented — the ``EXCLUSION_REASONS``
    registry in ``scheduler/scheduling.py``, the literal reasons passed to
    ``Scheduling._trace`` (which become ``df_sched_filter_excluded_total``
    labels and decision-row ``excluded`` entries), and the backticked
    vocabulary in docs/OBSERVABILITY.md must agree. Same contract as the
    flight-kind/rung and faultgate-site lints: an unregistered reason is
    an invisible metric label, a registered-but-never-fired one is dead
    vocabulary, and an undocumented one is a ledger surface operators
    cannot read.

    Incident (decision ledger): filter exclusions survived only as DEBUG
    log lines — a pod herding onto ``no-slots``/``bad-node`` was
    invisible without redeploying at DEBUG, and nothing pinned the reason
    strings the decision ledger now persists.
    """

    code = "DF006"
    name = "decision-vocabulary"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        if not ctx.rel.replace(os.sep, "/").endswith(
                "scheduler/scheduling.py"):
            return
        declared: dict[str, int] = {}
        declared_line = 1
        for node in ctx.tree.body:
            if not (isinstance(node, ast.Assign)
                    and any(isinstance(t, ast.Name)
                            and t.id == "EXCLUSION_REASONS"
                            for t in node.targets)):
                continue
            declared_line = node.lineno
            for const in ast.walk(node.value):
                if isinstance(const, ast.Constant) \
                        and isinstance(const.value, str):
                    declared[const.value] = const.lineno
        fired: dict[str, int] = {}
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "_trace"
                    and len(node.args) >= 3
                    and isinstance(node.args[2], ast.Constant)
                    and isinstance(node.args[2].value, str)):
                continue
            fired.setdefault(node.args[2].value, node.lineno)
        if not declared and not fired:
            return
        obs = _ticked(ctx, "OBSERVABILITY.md")
        for reason, line in sorted(declared.items()):
            if reason not in fired:
                yield Finding(
                    self.code, ctx.rel, line, 0,
                    f"exclusion reason {reason!r} is registered in "
                    f"EXCLUSION_REASONS but no _trace call fires it — "
                    f"dead vocabulary")
            if reason not in obs:
                yield Finding(
                    self.code, ctx.rel, line, 0,
                    f"exclusion reason {reason!r} is not documented in "
                    f"docs/OBSERVABILITY.md — decision-row excluded "
                    f"entries and the df_sched_filter_excluded_total "
                    f"label are unreadable to operators")
        for reason, line in sorted(fired.items()):
            if reason not in declared:
                yield Finding(
                    self.code, ctx.rel, line, 0,
                    f"_trace fires exclusion reason {reason!r} but it is "
                    f"not in the EXCLUSION_REASONS registry "
                    f"(line {declared_line})")


_PHASE_FIRE_RE = re.compile(
    r"phasetimer\.(?:phase|record)\(\s*[\"']([a-z-]+)[\"']")
_RULING_FIRE_RE = re.compile(
    r"phasetimer\.ruling\(\s*[\"']([a-z-]+)[\"']")


@register
class PhaseVocabulary(Rule):
    """DF006 (ruling profiler): the control-plane phase vocabulary must
    stay closed and documented — the ``PHASES``/``RULING_KINDS``
    registries in ``common/phasetimer.py``, the literals at every
    ``phasetimer.phase(…)``/``record(…)``/``ruling(…)`` call site across
    the package (which become ``df_sched_ruling_seconds``/
    ``df_ctrl_ruling_seconds`` labels and /debug/ctrl rows), and the
    backticked vocabulary in docs/OBSERVABILITY.md must agree. An
    unregistered literal raises ValueError the first armed ruling (the
    registry validates), a registered-but-never-fired phase is dead
    vocabulary, and an undocumented one is a /debug/ctrl surface
    operators cannot read. Ruling kinds are swept one-sided (literal ->
    registered + documented): the main ``_decide`` path passes its kind
    as a variable, so absence of a kind literal proves nothing.
    """

    code = "DF006"
    name = "phase-vocabulary"

    def _declared(self, ctx: ModuleCtx,
                  registry: str) -> tuple[dict[str, int], int]:
        out: dict[str, int] = {}
        reg_line = 1
        for node in ctx.tree.body:
            if not (isinstance(node, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == registry
                            for t in node.targets)):
                continue
            reg_line = node.lineno
            for const in ast.walk(node.value):
                if isinstance(const, ast.Constant) \
                        and isinstance(const.value, str):
                    out[const.value] = const.lineno
        return out, reg_line

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        if not ctx.rel.replace(os.sep, "/").endswith(
                "common/phasetimer.py"):
            return
        phases, phases_line = self._declared(ctx, "PHASES")
        kinds, kinds_line = self._declared(ctx, "RULING_KINDS")
        if not phases and not kinds:
            return
        # package-wide call-site sweep, rooted at the package holding
        # this file (…/common/phasetimer.py -> …/); dflint_rules holds
        # these regexes themselves, not call sites
        pkg_root = os.path.dirname(os.path.dirname(ctx.path))
        fired_phases: set[str] = set()
        fired_kinds: set[str] = set()
        for dirpath, dirs, files in os.walk(pkg_root):
            dirs[:] = [d for d in dirs
                       if d not in ("__pycache__", "dflint_rules")]
            for name in files:
                if not name.endswith(".py") or name == "phasetimer.py":
                    continue
                try:
                    with open(os.path.join(dirpath, name),
                              encoding="utf-8") as f:
                        src = f.read()
                except OSError:
                    continue
                fired_phases.update(_PHASE_FIRE_RE.findall(src))
                fired_kinds.update(_RULING_FIRE_RE.findall(src))
        obs = _ticked(ctx, "OBSERVABILITY.md")
        for ph, line in sorted(phases.items()):
            if ph not in fired_phases:
                yield Finding(
                    self.code, ctx.rel, line, 0,
                    f"phase {ph!r} is registered in PHASES but no "
                    f"phasetimer.phase/record call fires it — dead "
                    f"vocabulary")
            if ph not in obs:
                yield Finding(
                    self.code, ctx.rel, line, 0,
                    f"phase {ph!r} is not documented in "
                    f"docs/OBSERVABILITY.md — the "
                    f"df_sched_ruling_seconds label and /debug/ctrl "
                    f"rows are unreadable to operators")
        for kind, line in sorted(kinds.items()):
            if kind not in obs:
                yield Finding(
                    self.code, ctx.rel, line, 0,
                    f"ruling kind {kind!r} is not documented in "
                    f"docs/OBSERVABILITY.md")
        for ph in sorted(fired_phases - set(phases)):
            yield Finding(
                self.code, ctx.rel, phases_line, 0,
                f"phasetimer.phase({ph!r}) appears in the package but "
                f"{ph!r} is not in the PHASES registry — the first "
                f"armed ruling raises ValueError")
        for kind in sorted(fired_kinds - set(kinds)):
            yield Finding(
                self.code, ctx.rel, kinds_line, 0,
                f"phasetimer.ruling({kind!r}) appears in the package "
                f"but {kind!r} is not in the RULING_KINDS registry — "
                f"the first armed ruling raises ValueError")


_CLASS_USE_RES = (
    # qos_class == / != / = "x"  (comparisons, assignments, kwargs)
    re.compile(r"qos_class\s*(?:==|!=|=)\s*[\"']([a-z_]+)[\"']"),
    # getattr(x, "qos_class", "x") / d.get("qos_class", "x") defaults
    re.compile(r"(?:getattr\([^)]*|\.get\(\s*)"
               r"[\"']qos_class[\"']\s*,\s*[\"']([a-z_]+)[\"']"),
    # cls == / != "x"  (the short-name form the hot paths use)
    re.compile(r"\bcls\s*(?:==|!=)\s*[\"']([a-z_]+)[\"']"),
)


@register
class PriorityClassVocabulary(Rule):
    """DF006 (QoS classes): the multi-tenant service-class vocabulary
    must stay closed and documented — the ``PRIORITY_CLASSES`` registry
    in ``idl/messages.py``, every class literal any surface binds or
    compares to a ``qos_class``/``cls`` (admission gates, shaper splits,
    scheduler rulings, metric labels), and the backticked vocabulary in
    docs/OBSERVABILITY.md / docs/RESILIENCE.md must agree. Same contract
    as the exclusion-reason lint: an unregistered class is an invisible
    metric label and an unenforceable quota row; an undocumented one is
    a ``df_qos_*`` dimension operators cannot read.

    Incident (QoS plane): the QoS plane threads one class string through
    eleven surfaces across four services — one typo'd literal at any of
    them would silently route traffic as ``standard`` (resolve_class
    clamps unknowns by design) and the brownout would never engage for
    it.
    """

    code = "DF006"
    name = "priority-class-vocabulary"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        if not ctx.rel.replace(os.sep, "/").endswith("idl/messages.py"):
            return
        declared: dict[str, int] = {}
        declared_line = 1
        for node in ctx.tree.body:
            if not (isinstance(node, ast.Assign)
                    and any(isinstance(t, ast.Name)
                            and t.id == "PRIORITY_CLASSES"
                            for t in node.targets)):
                continue
            declared_line = node.lineno
            for const in ast.walk(node.value):
                if isinstance(const, ast.Constant) \
                        and isinstance(const.value, str):
                    declared[const.value] = const.lineno
        if not declared:
            return
        # package-wide surface sweep, rooted at the package holding this
        # file (…/idl/messages.py -> …/) so fixtures self-contain
        pkg_root = os.path.dirname(os.path.dirname(ctx.path))
        used: dict[str, str] = {}
        for dirpath, dirs, files in os.walk(pkg_root):
            # the analyzer's own rule definitions carry the patterns as
            # examples — sweeping them would lint the linter
            dirs[:] = [d for d in dirs
                       if d not in ("__pycache__", "dflint_rules")]
            for name in files:
                if not name.endswith(".py") or name == "messages.py":
                    continue
                fpath = os.path.join(dirpath, name)
                try:
                    with open(fpath, encoding="utf-8") as f:
                        text = f.read()
                except OSError:
                    continue
                for rx in _CLASS_USE_RES:
                    for m in rx.finditer(text):
                        used.setdefault(m.group(1), fpath)
        docs = _ticked(ctx, "OBSERVABILITY.md") \
            | _ticked(ctx, "RESILIENCE.md")
        for cls, line in sorted(declared.items()):
            if cls not in docs:
                yield Finding(
                    self.code, ctx.rel, line, 0,
                    f"priority class {cls!r} is not backticked in "
                    f"docs/OBSERVABILITY.md or docs/RESILIENCE.md — a "
                    f"service class operators cannot read about cannot "
                    f"be operated")
        for cls in sorted(set(used) - set(declared)):
            yield Finding(
                self.code, ctx.rel, declared_line, 0,
                f"class literal {cls!r} is bound/compared to a "
                f"qos_class surface in "
                f"{os.path.relpath(used[cls], pkg_root)} but is not in "
                f"the PRIORITY_CLASSES registry — resolve_class would "
                f"silently clamp it to 'standard' and the QoS plane "
                f"would never engage for it")


@register
class FaultgateSites(Rule):
    """DF006 (faultgate): the site registry, the ``faultgate.fire(…)``
    call sites across the package, and docs/RESILIENCE.md must agree —
    a registered-but-never-fired site is a chaos surface that tests
    nothing, a fired-but-unregistered name raises at arm time, and an
    undocumented site can't be scripted by operators. Replaces the
    runtime site lint from tests/test_faults.py."""

    code = "DF006"
    name = "faultgate-sites"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        if not ctx.rel.replace(os.sep, "/").endswith("common/faultgate.py"):
            return
        sites: dict[str, int] = {}
        sites_line = 1
        for node in ctx.tree.body:
            if not (isinstance(node, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == "SITES"
                            for t in node.targets)):
                continue
            sites_line = node.lineno
            for const in ast.walk(node.value):
                if isinstance(const, ast.Constant) \
                        and isinstance(const.value, str):
                    sites[const.value] = const.lineno
        if not sites:
            return
        # package-wide fire() sweep, rooted at the package holding this
        # file (…/common/faultgate.py -> …/) so fixtures self-contain
        pkg_root = os.path.dirname(os.path.dirname(ctx.path))
        fired: set[str] = set()
        for dirpath, dirs, files in os.walk(pkg_root):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for name in files:
                if not name.endswith(".py") or name == "faultgate.py":
                    continue
                try:
                    with open(os.path.join(dirpath, name),
                              encoding="utf-8") as f:
                        fired.update(_FIRE_RE.findall(f.read()))
                except OSError:
                    continue
        res = _ticked(ctx, "RESILIENCE.md")
        for site, line in sorted(sites.items()):
            if site not in fired:
                yield Finding(
                    self.code, ctx.rel, line, 0,
                    f"faultgate site {site!r} is registered but never "
                    f"fired anywhere in the package — dead chaos surface")
            if site not in res:
                yield Finding(
                    self.code, ctx.rel, line, 0,
                    f"faultgate site {site!r} is not documented in "
                    f"docs/RESILIENCE.md")
        for site in sorted(fired - set(sites)):
            yield Finding(
                self.code, ctx.rel, sites_line, 0,
                f"faultgate.fire({site!r}) appears in the package but "
                f"{site!r} is not in the SITES registry — arming it "
                f"raises ValueError")


_ANOMALY_FIRE_RE = re.compile(r"\._fire\(\s*[\"']([a-z-]+)[\"']")


@register
class AnomalyVocabulary(Rule):
    """DF006 (fleet pulse): the anomaly-kind vocabulary must stay closed
    and documented — the ``ANOMALY_KINDS`` registry in
    ``scheduler/fleetpulse.py``, the kind literal at every
    ``._fire(…)`` call site across the package (each becomes a
    ``df_fleet_anomalies_total`` label, a ``decision_kind=anomaly``
    ledger row, and an incident-bundle id), and the backticked
    vocabulary in docs/OBSERVABILITY.md must agree. A
    registered-but-never-fired kind is dead vocabulary the detector can
    never produce, a fired-but-unregistered kind is an invisible metric
    label dfbench --pr18's injection matrix never covers, and an
    undocumented one is a /debug/fleet surface operators cannot read.
    Unlike the phase sweep, the registry file itself IS swept: the
    detector's fire sites live beside the registry by design.
    """

    code = "DF006"
    name = "anomaly-vocabulary"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        if not ctx.rel.replace(os.sep, "/").endswith(
                "scheduler/fleetpulse.py"):
            return
        declared: dict[str, int] = {}
        declared_line = 1
        for node in ctx.tree.body:
            if not (isinstance(node, ast.Assign)
                    and any(isinstance(t, ast.Name)
                            and t.id == "ANOMALY_KINDS"
                            for t in node.targets)):
                continue
            declared_line = node.lineno
            for const in ast.walk(node.value):
                if isinstance(const, ast.Constant) \
                        and isinstance(const.value, str):
                    declared[const.value] = const.lineno
        if not declared:
            return
        # the z-score path fires through the _SIGNALS mapping (signal ->
        # (kind, floor)): the tuple HEADS are fire sites too, read from
        # the same AST so the mapping and the literal sweep agree
        fired: dict[str, str] = {}
        for node in ctx.tree.body:
            if not (isinstance(node, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == "_SIGNALS"
                            for t in node.targets)):
                continue
            for tup in ast.walk(node.value):
                if isinstance(tup, ast.Tuple) and tup.elts \
                        and isinstance(tup.elts[0], ast.Constant) \
                        and isinstance(tup.elts[0].value, str):
                    fired.setdefault(tup.elts[0].value, ctx.path)
        # package-wide fire sweep rooted at the package holding this
        # file (…/scheduler/fleetpulse.py -> …/), INCLUDING fleetpulse.py
        # itself — the detector fires beside its registry
        pkg_root = os.path.dirname(os.path.dirname(ctx.path))
        for dirpath, dirs, files in os.walk(pkg_root):
            dirs[:] = [d for d in dirs
                       if d not in ("__pycache__", "dflint_rules")]
            for name in files:
                if not name.endswith(".py"):
                    continue
                fpath = os.path.join(dirpath, name)
                try:
                    with open(fpath, encoding="utf-8") as f:
                        text = f.read()
                except OSError:
                    continue
                for m in _ANOMALY_FIRE_RE.finditer(text):
                    fired.setdefault(m.group(1), fpath)
        obs = _ticked(ctx, "OBSERVABILITY.md")
        for kind, line in sorted(declared.items()):
            if kind not in fired:
                yield Finding(
                    self.code, ctx.rel, line, 0,
                    f"anomaly kind {kind!r} is registered in "
                    f"ANOMALY_KINDS but no _fire call emits it — dead "
                    f"vocabulary the detector can never produce")
            if kind not in obs:
                yield Finding(
                    self.code, ctx.rel, line, 0,
                    f"anomaly kind {kind!r} is not documented in "
                    f"docs/OBSERVABILITY.md — a "
                    f"df_fleet_anomalies_total label and /debug/fleet "
                    f"row operators cannot read")
        for kind in sorted(set(fired) - set(declared)):
            yield Finding(
                self.code, ctx.rel, declared_line, 0,
                f"_fire({kind!r}) appears in "
                f"{os.path.relpath(fired[kind], pkg_root)} but {kind!r} "
                f"is not in the ANOMALY_KINDS registry — an invisible "
                f"anomaly label the --pr18 injection matrix never "
                f"covers")
