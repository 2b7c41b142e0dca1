"""dflint's package index: the two-pass engine's first pass.

Counterpart of ``dragonfly2_tpu/tools/dflint_rules/symbols.py``.

The first rules stopped at module boundaries — DF001 "follows module-local
call edges" and goes blind at every ``import``, while the later post-mortems
are all *interprocedural* shapes (a blocking helper in
``common/`` called from a coroutine in ``daemon/``, an admission await
taken while holding the ptm lock). This module is the fix's foundation:

* **Index pass** — parse every module under one package root, build
  per-module symbol tables (module-level defs, classes/methods, import
  bindings resolved *within* the package, lock constructors, ``self.x =
  Ctor()`` attribute types), then compute per-function **summaries** to a
  fixpoint over the package-wide call graph:

  - ``blocking`` — calling this (sync) function may execute blocking
    IO/CPU on the caller's thread (the DF001 payload);
  - ``slow``     — awaiting this coroutine may wait on network/timer
    primitives (the DF005 payload);
  - ``parks``    — awaiting this coroutine may park on capacity
    (a future/Condition/semaphore admission wait — the DF009
    priority-inversion payload);
  - ``acquires`` — asyncio locks this function may take, directly or
    transitively (the DF009 lock-ordering graph's edge source).

* **Analysis pass** (the rules) — resolves each call site against the
  index and consults the callee's summary, so a hazard is reported at
  the *call site in the caller's module*. That direction matters twice:
  it is where the fix goes (hop through an executor / move the call out
  of the lock scope), and it makes per-module result caching sound —
  a module's findings depend only on its own text plus the *interfaces*
  of the modules it imports (``ModuleIndex.interface_digest``), never on
  who imports it.

Resolution is deliberately a heuristic subset of Python (no inheritance
walk, no flow typing): module-level defs, class methods via ``self``/
``cls``, imported symbols/modules, module-level singletons (``POOL =
BufferPool()``), and ``self.attr`` receivers whose class is pinned by a
constructor assignment or an annotated ``__init__`` parameter. That set
covers every call edge in this codebase's own incidents; anything it
cannot resolve simply stays un-analyzed, exactly like v1.
"""

from __future__ import annotations

import ast
import hashlib
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Iterator

__all__ = [
    "FuncKey", "FuncInfo", "Summary", "ModuleIndex", "PackageIndex",
    "package_root_for", "display",
]

# ---------------------------------------------------------------------------
# shared AST helpers (v1 lived in concurrency.py; the index is the one
# place every rule family now imports them from)
# ---------------------------------------------------------------------------

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _dotted(node: ast.AST) -> str | None:
    """'a.b.c' for a pure Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _terminal(node: ast.AST) -> str | None:
    """The last segment of a call target: `x` for x(), `m` for a.b.m()."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _walk_scope(body: list[ast.stmt]) -> Iterator[ast.AST]:
    """Walk statements without descending into nested function scopes.

    A nested sync ``def`` or ``lambda`` inside a coroutine is (in this
    codebase) almost always an executor thunk or a callback — its body
    does not run on the event loop in the coroutine's context, so
    blocking calls there are exactly the *fix* for DF001, not the bug.
    Nested ``async def``s are separate coroutines and are visited in
    their own right by the rules' outer loops.
    """
    stack: list[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, _FUNC_NODES):
            continue    # a def seeded directly from `body` stays opaque too
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FUNC_NODES):
                continue
            stack.append(child)


# ---------------------------------------------------------------------------
# the blocking-call table (DF001's vocabulary; summaries reuse it)
# ---------------------------------------------------------------------------

_OS_IO = frozenset({
    "stat", "lstat", "listdir", "scandir", "walk", "remove", "unlink",
    "rename", "replace", "makedirs", "mkdir", "rmdir", "removedirs",
    "fsync", "ftruncate", "truncate", "utime", "link", "symlink",
    "chmod", "chown", "statvfs", "system", "popen",
})
_OSPATH_IO = frozenset({
    "getsize", "getmtime", "getctime", "exists", "isfile", "isdir",
    "islink", "samefile", "realpath",
})
_SHUTIL_IO = frozenset({
    "rmtree", "copy", "copy2", "copyfile", "copyfileobj", "copytree",
    "move", "disk_usage", "which",
})
_SOCKET_IO = frozenset({
    "getaddrinfo", "gethostbyname", "gethostbyaddr", "create_connection",
    "getfqdn",
})
_PATHLIB_IO = frozenset({
    "read_bytes", "read_text", "write_bytes", "write_text",
})
_DIGEST_HELPERS = frozenset({"hash_bytes", "hash_file"})
_FILE_METHODS = frozenset({"read", "write", "readline", "readlines",
                           "writelines"})


def _blocking_reason(call: ast.Call) -> str | None:
    d = _dotted(call.func)
    t = _terminal(call.func)
    if d in ("open", "io.open"):
        return "blocking open() — route file IO through an executor"
    if d == "time.sleep":
        return "time.sleep() parks the whole event loop — use asyncio.sleep"
    if d is not None:
        head, _, rest = d.partition(".")
        if head == "subprocess":
            return f"subprocess.{rest or d} blocks the loop — use " \
                   f"asyncio.create_subprocess_*"
        if head == "os" and rest in _OS_IO:
            return f"os.{rest} does synchronous IO on the loop thread"
        if d.startswith("os.path.") and d[len("os.path."):] in _OSPATH_IO:
            return f"{d} stats the filesystem on the loop thread"
        if head == "shutil" and rest in _SHUTIL_IO:
            return f"shutil.{rest} does synchronous IO on the loop thread"
        if head == "socket" and rest in _SOCKET_IO:
            return f"socket.{rest} can block on DNS/connect — use the " \
                   f"loop's async equivalents"
        if head == "hashlib" and call.args:
            return "whole-buffer hashlib digest on the loop thread — " \
                   "hash off-loop (see storage write_span / PR 5)"
    if t in _DIGEST_HELPERS:
        return f"{t}() traverses the whole buffer on the loop thread"
    if t in _PATHLIB_IO:
        return f".{t}() does synchronous file IO on the loop thread"
    return None


def _scan_blocking(fn_body: list[ast.stmt]) -> Iterator[tuple[ast.Call, str]]:
    """Yield (call, reason) for blocking calls lexically in this scope,
    plus reads/writes on file handles and hasher updates bound here."""
    handles: set[str] = set()
    hashers: set[str] = set()
    for node in _walk_scope(fn_body):
        if isinstance(node, ast.With):
            for item in node.items:
                if (isinstance(item.context_expr, ast.Call)
                        and _dotted(item.context_expr.func)
                        in ("open", "io.open")
                        and isinstance(item.optional_vars, ast.Name)):
                    handles.add(item.optional_vars.id)
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            d = _dotted(node.value.func)
            for tgt in node.targets:
                if not isinstance(tgt, ast.Name):
                    continue
                if d in ("open", "io.open"):
                    handles.add(tgt.id)
                elif d is not None and d.startswith("hashlib."):
                    hashers.add(tgt.id)
    for node in _walk_scope(fn_body):
        if not isinstance(node, ast.Call):
            continue
        reason = _blocking_reason(node)
        if reason is not None:
            yield node, reason
            continue
        f = node.func
        if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)):
            if f.value.id in handles and f.attr in _FILE_METHODS:
                yield node, (f"{f.value.id}.{f.attr}() on a blocking file "
                             f"handle — route file IO through an executor")
            elif f.value.id in hashers and f.attr == "update":
                yield node, ("whole-buffer hasher.update on the loop "
                             "thread — hash off-loop (PR 5 zero-stall rule)")


# ---------------------------------------------------------------------------
# slow/park await vocabulary (DF005 / DF009 payloads)
# ---------------------------------------------------------------------------

_LOCKISH_RE = re.compile(r"lock|cond|sem|mutex", re.IGNORECASE)
_CONDISH_RE = re.compile(r"cond", re.IGNORECASE)
_FUTURISH_RE = re.compile(r"fut|waiter|promise", re.IGNORECASE)
_QUEUEISH_RE = re.compile(r"queue|\bq\b|_q$", re.IGNORECASE)
_SLOW_AWAITS = frozenset({
    "sleep", "gather", "wait", "wait_for", "open_connection",
    "getaddrinfo", "connect", "request", "get", "post", "put", "patch",
    "delete", "fetch", "recv", "read", "readexactly", "readline",
    "readuntil", "drain", "send", "send_json", "json", "text",
})


def _park_reason(awaited: ast.expr,
                 lock_kind) -> str | None:
    """Why this awaited expression may park on *capacity* (an admission
    wait) rather than on the network: a future, a Condition wait, a
    semaphore/queue acquire. ``lock_kind(name)`` resolves ctor evidence.

    Parking is the DF009 payload — the QoS-admission incident was
    precisely an admission future awaited while the ptm lock was held."""
    if isinstance(awaited, ast.Name) and _FUTURISH_RE.search(awaited.id):
        return f"awaits future {awaited.id!r} (capacity/admission wait)"
    if not isinstance(awaited, ast.Call):
        return None
    fn = awaited.func
    t = _terminal(fn)
    if t == "wait_for" and awaited.args:
        inner = awaited.args[0]
        if isinstance(inner, ast.Name) and _FUTURISH_RE.search(inner.id):
            return f"waits on future {inner.id!r} with a deadline " \
                   f"(queue-admission wait)"
        if isinstance(inner, ast.Call):
            it = _terminal(inner.func)
            recv = _terminal(inner.func.value) or "" \
                if isinstance(inner.func, ast.Attribute) else ""
            if it == "wait" and (lock_kind(recv) == "cond"
                                 or _CONDISH_RE.search(recv)):
                return f"waits on condition {recv!r} with a deadline"
        return None
    if not isinstance(fn, ast.Attribute):
        return None
    recv = _terminal(fn.value) or ""
    if t == "wait" and (lock_kind(recv) == "cond"
                        or _CONDISH_RE.search(recv)):
        return f"parks on condition {recv!r}"
    if t == "acquire" and (lock_kind(recv) in ("lock", "cond")
                           or _LOCKISH_RE.search(recv)):
        return f"parks acquiring {recv!r}"
    if t in ("get", "put", "join") and _QUEUEISH_RE.search(recv):
        return f"parks on queue {recv!r}"
    return None


# ---------------------------------------------------------------------------
# per-function summary
# ---------------------------------------------------------------------------

FuncKey = tuple[str, str, str]      # (module dotted, class or '', name)


def display(key: FuncKey, top: str = "") -> str:
    """Human form of a FuncKey: daemon.qos.QosGovernor.admit."""
    mod, cls, name = key
    if top and mod.startswith(top + "."):
        mod = mod[len(top) + 1:]
    return ".".join(p for p in (mod, cls, name) if p)


@dataclass
class Summary:
    """What calling/awaiting this function can do to the caller — the
    package-wide interface the analysis pass consults at call sites.
    Each field carries (reason, via) where ``via`` names the function the
    fact was inherited from ('' when direct)."""
    blocking: tuple[str, str] | None = None
    slow: tuple[str, str] | None = None
    parks: tuple[str, str] | None = None
    acquires: dict[str, str] = field(default_factory=dict)   # lock id -> via

    def digest_parts(self) -> tuple:
        return (self.blocking and self.blocking[0],
                self.slow and self.slow[0],
                self.parks and self.parks[0],
                tuple(sorted(self.acquires)))


@dataclass
class FuncInfo:
    key: FuncKey
    node: ast.FunctionDef | ast.AsyncFunctionDef
    is_async: bool
    # resolved call edges: (kind 'call'|'await', callee FuncKey, lineno)
    edges: list[tuple[str, FuncKey, int]] = field(default_factory=list)


# ---------------------------------------------------------------------------
# per-module index
# ---------------------------------------------------------------------------

_LOCK_CTORS = {"Condition": "cond", "Event": "event", "Lock": "lock",
               "Semaphore": "lock", "BoundedSemaphore": "lock"}

#: THE suppression grammar — the finding pass (scan_suppressions, the
#: DF000 audit) and the index pass (summary-retiring suppressions) must
#: parse the same language or a comment one accepts silently fails in
#: the other; both import this one pattern.
SUPPRESS_RE = re.compile(
    r"#\s*dflint:\s*disable=(?P<codes>DF\d{3}(?:\s*,\s*DF\d{3})*)"
    r"\s*(?:—|–|--+|-)\s*(?P<reason>\S.*?)\s*$")


def _ann_names(expr: ast.expr | None) -> list[str]:
    """Class names mentioned in an annotation: QosGovernor for
    ``QosGovernor | None``, ``Optional[QosGovernor]``, plain names."""
    if expr is None:
        return []
    out = []
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and node.id[:1].isupper() \
                and node.id not in ("Optional", "Union", "Any", "None"):
            out.append(node.id)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            # string annotation "QosGovernor"
            name = node.value.strip().split("|")[0].strip()
            if name[:1].isupper():
                out.append(name)
    return out


class ModuleIndex:
    """Symbol tables for one module: defs, classes, lock ctors, import
    bindings (resolved within the package by PackageIndex), and the
    ``self.attr``-type pins that let ``self.qos.admit()`` resolve."""

    def __init__(self, path: str, modname: str, src: str,
                 tree: ast.Module, is_pkg: bool, top: str):
        self.path = path
        self.modname = modname          # dragonfly2_tpu_torch.daemon.announcer
        self.is_pkg = is_pkg            # True for __init__.py
        self.top = top                  # top package name
        self.src = src
        self.tree = tree
        self.content_hash = hashlib.sha256(src.encode()).hexdigest()
        # lines covered by a well-formed disable comment, per code. A
        # reasoned suppression at the *definition* retires
        # the hazard from the function's summary too — otherwise one
        # "hashes ≤KB strings" judgement call would resurface as a
        # finding at every cross-module call site. Comments come from
        # tokenize, same as the finding pass — a raw line regex would
        # also match the grammar quoted inside docstrings/strings and
        # silently retire real hazards with no recorded reason
        self.suppressed: set[tuple[str, int]] = set()
        # (code, hazard line) pairs a summary actually skipped — the
        # unused-suppression audit (DF000) treats the comment covering
        # such a line as used even when no module-local finding matched
        self.summary_used: set[tuple[str, int]] = set()
        try:
            tokens = tokenize.generate_tokens(io.StringIO(src).readline)
            comments = [(t.start[0], t.string) for t in tokens
                        if t.type == tokenize.COMMENT]
        except (tokenize.TokenError, IndentationError, SyntaxError):
            comments = []
        for i, text in comments:
            m = SUPPRESS_RE.search(text)
            if m:
                for code in m.group("codes").split(","):
                    self.suppressed.add((code.strip(), i))
                    self.suppressed.add((code.strip(), i + 1))
        # (class or '', name) -> def node; both sync and async
        self.defs: dict[tuple[str, str], ast.AST] = {}
        self.classes: dict[str, ast.ClassDef] = {}
        # local name -> ("mod", dotted) | ("sym", dotted, symbol)
        self.imports: dict[str, tuple] = {}
        self.dotted_mods: set[str] = set()      # plain `import a.b.c`
        # (class or '', lock attr/name) -> 'lock'|'cond'|'event'
        self.lock_ctors: dict[tuple[str, str], str] = {}
        # (class or '', attr) -> local type name (resolved lazily)
        self.attr_types: dict[tuple[str, str], str] = {}
        # module-level singleton: name -> local class/ctor name
        self.instances: dict[str, str] = {}
        self._collect()

    @property
    def disp(self) -> str:
        """Display module path without the top package: daemon.qos."""
        if self.modname.startswith(self.top + "."):
            return self.modname[len(self.top) + 1:]
        return self.modname

    def _collect(self) -> None:
        for node in self.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs[("", node.name)] = node
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        self.defs[(node.name, sub.name)] = sub
                self._collect_attrs(node)
            elif isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call):
                ctor = _terminal(node.value.func)
                for t in node.targets:
                    if isinstance(t, ast.Name) and ctor:
                        if ctor in _LOCK_CTORS:
                            self.lock_ctors[("", t.id)] = _LOCK_CTORS[ctor]
                        else:
                            self.instances[t.id] = ctor
        # module-wide lock-ctor fallback by terminal name, preserving the
        # v1 behavior for assignments anywhere (incl. inside methods)
        for node in ast.walk(self.tree):
            value, targets = None, []
            if isinstance(node, ast.Assign):
                value, targets = node.value, node.targets
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                value, targets = node.value, [node.target]
            if not isinstance(value, ast.Call):
                continue
            kind = _LOCK_CTORS.get(_terminal(value.func) or "")
            if kind is None:
                continue
            for t in targets:
                name = _terminal(t)
                if name:
                    self.lock_ctors.setdefault(("", name), kind)

    def _collect_attrs(self, cls: ast.ClassDef) -> None:
        """Pin ``self.attr`` types from ctor assignments (``self.x =
        Ctor(...)``) and from annotated ``__init__`` params passed
        straight through (``self.qos = qos`` with ``qos: QosGovernor``)."""
        for sub in cls.body:
            if not isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            ann: dict[str, str] = {}
            for a in (list(sub.args.posonlyargs) + list(sub.args.args)
                      + list(sub.args.kwonlyargs)):
                names = _ann_names(a.annotation)
                if names:
                    ann[a.arg] = names[0]
            for node in _walk_scope(sub.body):
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1):
                    continue
                tgt = node.targets[0]
                if not (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    continue
                if isinstance(node.value, ast.Call):
                    ctor = _terminal(node.value.func)
                    if ctor and ctor in _LOCK_CTORS:
                        self.lock_ctors[(cls.name, tgt.attr)] = \
                            _LOCK_CTORS[ctor]
                        self.lock_ctors.setdefault(
                            ("", tgt.attr), _LOCK_CTORS[ctor])
                    elif ctor and ctor[:1].isupper():
                        self.attr_types[(cls.name, tgt.attr)] = ctor
                elif isinstance(node.value, ast.Name) \
                        and node.value.id in ann:
                    self.attr_types[(cls.name, tgt.attr)] = \
                        ann[node.value.id]

    def lock_kind(self, owner: str, name: str) -> str | None:
        """'lock'|'cond'|'event' for ctor-pinned names, class scope
        first; None when there is no ctor evidence."""
        if owner and (owner, name) in self.lock_ctors:
            return self.lock_ctors[(owner, name)]
        return self.lock_ctors.get(("", name))


# ---------------------------------------------------------------------------
# the package index
# ---------------------------------------------------------------------------

def package_root_for(path: str) -> str | None:
    """Topmost ancestor directory of ``path`` that is a package (has
    ``__init__.py`` all the way down). None for standalone modules."""
    d = os.path.dirname(os.path.abspath(path))
    if not os.path.exists(os.path.join(d, "__init__.py")):
        return None
    while True:
        parent = os.path.dirname(d)
        if parent == d \
                or not os.path.exists(os.path.join(parent, "__init__.py")):
            return d
        d = parent


class PackageIndex:
    """Pass 1: every module under one package root, parsed and
    cross-resolved, with per-function summaries at fixpoint."""

    def __init__(self, pkg_dir: str):
        self.pkg_dir = os.path.abspath(pkg_dir)
        self.top = os.path.basename(self.pkg_dir)
        self.modules: dict[str, ModuleIndex] = {}
        self.by_path: dict[str, ModuleIndex] = {}
        self.funcs: dict[FuncKey, FuncInfo] = {}
        self.summaries: dict[FuncKey, Summary] = {}
        self._build()

    @classmethod
    def solo(cls, path: str, src: str, tree: ast.Module) -> "PackageIndex":
        """A one-module index for standalone files (and ``lint_source``
        fixtures): same API, nothing cross-module resolves — analysis
        degrades exactly to the v1 module-local behavior."""
        idx = object.__new__(cls)
        idx.pkg_dir = os.path.dirname(os.path.abspath(path))
        idx.top = ""
        idx.modules = {}
        idx.by_path = {}
        idx.funcs = {}
        idx.summaries = {}
        stem = os.path.splitext(os.path.basename(path))[0]
        mi = ModuleIndex(os.path.abspath(path), stem, src, tree,
                         False, "")
        idx.modules[stem] = mi
        idx.by_path[os.path.abspath(path)] = mi
        idx._resolve_imports(mi)
        idx._collect_funcs(mi)
        for info in idx.funcs.values():
            idx._collect_edges(mi, info)
        idx._fixpoint()
        return idx

    # -- construction -----------------------------------------------------

    def _build(self) -> None:
        for dirpath, dirs, files in os.walk(self.pkg_dir):
            dirs[:] = sorted(d for d in dirs if d != "__pycache__")
            for name in sorted(files):
                if name.endswith(".py"):
                    self._add_module(os.path.join(dirpath, name))
        for mi in self.modules.values():
            self._resolve_imports(mi)
        for mi in self.modules.values():
            self._collect_funcs(mi)
        for info in self.funcs.values():
            mi = self.modules[info.key[0]]
            self._collect_edges(mi, info)
        self._fixpoint()

    def _add_module(self, path: str) -> None:
        rel = os.path.relpath(path, os.path.dirname(self.pkg_dir))
        parts = rel[:-3].split(os.sep)
        is_pkg = parts[-1] == "__init__"
        if is_pkg:
            parts = parts[:-1]
        modname = ".".join(parts)
        try:
            with open(path, encoding="utf-8") as f:
                src = f.read()
            tree = ast.parse(src, filename=path)
        except (OSError, SyntaxError):
            return
        mi = ModuleIndex(path, modname, src, tree, is_pkg, self.top)
        self.modules[modname] = mi
        self.by_path[os.path.abspath(path)] = mi

    def _resolve_imports(self, mi: ModuleIndex) -> None:
        parts = mi.modname.split(".")
        # the anchor package relative imports resolve against
        base = parts if mi.is_pkg else parts[:-1]
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.ImportFrom):
                if node.level > 0:
                    anchor = base[:len(base) - (node.level - 1)]
                else:
                    anchor = []
                target = anchor + (node.module.split(".")
                                   if node.module else [])
                tmod = ".".join(target)
                for alias in node.names:
                    local = alias.asname or alias.name
                    full = f"{tmod}.{alias.name}" if tmod else alias.name
                    if full in self.modules:
                        mi.imports[local] = ("mod", full)
                    elif tmod in self.modules:
                        mi.imports[local] = ("sym", tmod, alias.name)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name not in self.modules:
                        continue
                    if alias.asname:
                        mi.imports[alias.asname] = ("mod", alias.name)
                    else:
                        mi.dotted_mods.add(alias.name)

    def _collect_funcs(self, mi: ModuleIndex) -> None:
        for (cls, name), node in mi.defs.items():
            key = (mi.modname, cls, name)
            info = FuncInfo(key, node,
                            isinstance(node, ast.AsyncFunctionDef))
            self.funcs[key] = info
            self.summaries[key] = self._direct_summary(mi, cls, info)

    # -- resolution -------------------------------------------------------

    def _class_key(self, modname: str, name: str,
                   _depth: int = 0) -> tuple[str, str] | None:
        """(module, Class) for a class named ``name`` visible in
        ``modname`` — local class or one import hop."""
        mi = self.modules.get(modname)
        if mi is None or _depth > 2:
            return None
        if name in mi.classes:
            return (modname, name)
        b = mi.imports.get(name)
        if b and b[0] == "sym":
            return self._class_key(b[1], b[2], _depth + 1)
        return None

    def resolve_call(self, mi: ModuleIndex, owner: str,
                     call: ast.Call) -> FuncKey | None:
        """FuncKey of the function this call lands in, or None when the
        heuristic can't tell (which keeps v1 behavior: unresolved calls
        are simply not analyzed)."""
        f = call.func
        if isinstance(f, ast.Name):
            if ("", f.id) in mi.defs:
                return (mi.modname, "", f.id)
            b = mi.imports.get(f.id)
            if b and b[0] == "sym":
                key = (b[1], "", b[2])
                if key in self.funcs:
                    return key
            return None
        if not isinstance(f, ast.Attribute):
            return None
        meth = f.attr
        recv = f.value
        if isinstance(recv, ast.Name):
            rid = recv.id
            if rid in ("self", "cls") and owner:
                key = (mi.modname, owner, meth)
                return key if key in self.funcs else None
            b = mi.imports.get(rid)
            if b is not None:
                if b[0] == "mod":
                    key = (b[1], "", meth)
                    return key if key in self.funcs else None
                ck = self._class_key(b[1], b[2]) \
                    if b[2] in self.modules.get(b[1],
                                                mi).classes else None
                if ck is None:
                    # imported module-level singleton (POOL, REGISTRY…)
                    smi = self.modules.get(b[1])
                    ctor = smi.instances.get(b[2]) if smi else None
                    ck = self._class_key(b[1], ctor) if ctor else None
                if ck:
                    key = (ck[0], ck[1], meth)
                    return key if key in self.funcs else None
                return None
            if rid in mi.classes:
                key = (mi.modname, rid, meth)
                return key if key in self.funcs else None
            ctor = mi.instances.get(rid)
            if ctor:
                ck = self._class_key(mi.modname, ctor)
                if ck:
                    key = (ck[0], ck[1], meth)
                    return key if key in self.funcs else None
            return None
        # self.attr.method() with a pinned attr type
        if isinstance(recv, ast.Attribute) \
                and isinstance(recv.value, ast.Name) \
                and recv.value.id in ("self", "cls") and owner:
            tname = mi.attr_types.get((owner, recv.attr))
            if tname:
                ck = self._class_key(mi.modname, tname)
                if ck:
                    key = (ck[0], ck[1], meth)
                    return key if key in self.funcs else None
            return None
        # fully dotted module chain (plain `import a.b.c` style)
        d = _dotted(f)
        if d:
            modpath, _, fname = d.rpartition(".")
            if modpath in self.modules:
                key = (modpath, "", fname)
                if key in self.funcs:
                    return key
        return None

    def lock_identity(self, mi: ModuleIndex, owner: str,
                      expr: ast.expr) -> tuple[str, str] | None:
        """(identity, kind) for an ``async with`` context expression that
        is an asyncio lock/condition/semaphore; identity is stable across
        modules (mod.Class.attr) so the package-wide ordering graph can
        join edges taken in different files."""
        target = expr
        if isinstance(target, ast.Call):
            target = target.func
        name = _terminal(target)
        if name is None:
            return None
        # an imported lock belongs to its DEFINING module — both sides
        # of a cross-module cycle must agree on the identity or the
        # ordering graph never joins the edges
        if isinstance(target, ast.Name):
            b = mi.imports.get(target.id)
            if b is not None and b[0] == "sym":
                smi = self.modules.get(b[1])
                if smi is not None:
                    skind = smi.lock_kind("", b[2])
                    if skind == "event":
                        return None
                    if skind is None and not _LOCKISH_RE.search(b[2]):
                        return None
                    return (f"{smi.disp}.{b[2]}", skind or "lock")
        kind = mi.lock_kind(owner, name)
        if kind == "event":
            return None
        if kind is None and not _LOCKISH_RE.search(name):
            return None
        kind = kind or "lock"
        if isinstance(target, ast.Attribute) \
                and isinstance(target.value, ast.Name) \
                and target.value.id in ("self", "cls") and owner:
            return (f"{mi.disp}.{owner}.{name}", kind)
        return (f"{mi.disp}.{name}", kind)

    # -- summaries --------------------------------------------------------

    def _direct_summary(self, mi: ModuleIndex, owner: str,
                        info: FuncInfo) -> Summary:
        s = Summary()
        body = info.node.body
        for call, reason in _scan_blocking(body):
            if ("DF001", call.lineno) in mi.suppressed:
                # a reasoned definition-site suppression retires the
                # hazard package-wide, not just in this module
                mi.summary_used.add(("DF001", call.lineno))
                continue
            s.blocking = (reason, "")
            break
        if info.is_async:
            lk = lambda name: mi.lock_kind(owner, name)  # noqa: E731
            for node in _walk_scope(body):
                if isinstance(node, ast.Await):
                    park = _park_reason(node.value, lk)
                    if park is not None:
                        if ("DF009", node.lineno) in mi.suppressed:
                            mi.summary_used.add(("DF009", node.lineno))
                        elif s.parks is None:
                            s.parks = (park, "")
                        continue
                    if (isinstance(node.value, ast.Call)
                            and _terminal(node.value.func)
                            in _SLOW_AWAITS):
                        if ("DF005", node.lineno) in mi.suppressed:
                            mi.summary_used.add(("DF005", node.lineno))
                        elif s.slow is None:
                            t = _terminal(node.value.func)
                            s.slow = (f"awaits {t}(…)", "")
                elif isinstance(node, ast.AsyncWith):
                    for item in node.items:
                        li = self.lock_identity(mi, owner,
                                                item.context_expr)
                        if li is not None:
                            s.acquires.setdefault(li[0], "")
        return s

    def _collect_edges(self, mi: ModuleIndex, info: FuncInfo) -> None:
        owner = info.key[1]
        for node in _walk_scope(info.node.body):
            if isinstance(node, ast.Await) \
                    and isinstance(node.value, ast.Call):
                key = self.resolve_call(mi, owner, node.value)
                if key is not None and key != info.key:
                    info.edges.append(("await", key, node.lineno))
            elif isinstance(node, ast.Call):
                key = self.resolve_call(mi, owner, node)
                if key is not None and key != info.key:
                    info.edges.append(("call", key, node.lineno))

    def _fixpoint(self) -> None:
        """Propagate summaries over resolved call edges until stable.
        Monotone lattice (facts only appear), so this terminates; the
        package's call graph converges in a handful of rounds."""
        changed = True
        rounds = 0
        while changed and rounds < 50:
            changed = False
            rounds += 1
            for key, info in self.funcs.items():
                s = self.summaries[key]
                for kind, callee, _line in info.edges:
                    cs = self.summaries.get(callee)
                    ci = self.funcs.get(callee)
                    if cs is None or ci is None:
                        continue
                    via = display(callee, self.top)
                    if (not ci.is_async and cs.blocking is not None
                            and s.blocking is None):
                        s.blocking = (cs.blocking[0], via)
                        changed = True
                    if kind == "await" and ci.is_async:
                        if cs.slow is not None and s.slow is None:
                            s.slow = (cs.slow[0], via)
                            changed = True
                        if cs.parks is not None and s.parks is None:
                            s.parks = (cs.parks[0], via)
                            changed = True
                        for lock in cs.acquires:
                            if lock not in s.acquires:
                                s.acquires[lock] = via
                                changed = True

    # -- interfaces for the cache ----------------------------------------

    def interface_digest(self, modname: str) -> str:
        """Digest of everything a *caller* of this module can observe
        through the analysis: exported def/class names, asyncness,
        fixpoint summaries, module-level singletons, and import bindings
        (rebinding a re-exported ``POOL`` to another class changes what
        a caller's call sites resolve to). A dependency edit that
        doesn't move any of this cannot change a dependent's findings —
        the cache key the tier-1 gate's speed rides on. Memoized per
        index (summaries are frozen once the fixpoint ran)."""
        memo = self.__dict__.setdefault("_iface_memo", {})
        if modname in memo:
            return memo[modname]
        mi = self.modules.get(modname)
        if mi is None:
            memo[modname] = "absent"
            return "absent"
        items: list = []
        for (cls, name), _node in sorted(mi.defs.items()):
            key = (modname, cls, name)
            info = self.funcs.get(key)
            summ = self.summaries.get(key)
            items.append((cls, name, bool(info and info.is_async),
                          summ.digest_parts() if summ else ()))
        items.append(tuple(sorted(mi.instances.items())))
        items.append(tuple(sorted((k, v) for k, v in mi.imports.items())))
        digest = hashlib.sha256(repr(items).encode()).hexdigest()
        memo[modname] = digest
        return digest

    def _dep_closure(self, mi: ModuleIndex) -> set[str]:
        """TRANSITIVE in-package imports: call resolution can hop
        through a re-exporting module (``from .b import POOL`` where b
        built POOL from impl's class), so a dependent's key must cover
        the modules its call sites can land in, not just the ones it
        names. Memoized: summaries are frozen once the fixpoint ran."""
        memo = self.__dict__.setdefault("_closure_memo", {})
        if mi.modname in memo:
            return memo[mi.modname]
        seen: set[str] = set()
        stack = list({b[1] for b in mi.imports.values()}
                     | set(mi.dotted_mods))
        while stack:
            dep = stack.pop()
            if dep in seen:
                continue
            seen.add(dep)
            dmi = self.modules.get(dep)
            if dmi is None:
                continue
            stack.extend({b[1] for b in dmi.imports.values()}
                         | set(dmi.dotted_mods))
        memo[mi.modname] = seen
        return seen

    def import_surface_digest(self, mi: ModuleIndex) -> str:
        """Combined interface digest of every module ``mi`` can reach
        through imports — with the module's own content hash, the cache
        key."""
        h = hashlib.sha256()
        for dep in sorted(self._dep_closure(mi)):
            h.update(dep.encode())
            h.update(self.interface_digest(dep).encode())
        return h.hexdigest()
