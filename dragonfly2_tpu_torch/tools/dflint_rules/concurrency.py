"""DF001–DF005: the asyncio hazard classes this fabric has actually hit.

Counterpart of ``dragonfly2_tpu/tools/dflint_rules/concurrency.py``.

Every rule here is a post-mortem made executable. The daemon runs ONE
event loop; these are the five ways this codebase has managed to wedge,
starve, or silently poison it in its first changes.

v2: DF001 and DF005 are **interprocedural**. The module-local pass is
unchanged (and is all that runs for standalone files / fixtures), but
when the module belongs to an indexed package, call sites that resolve
across module boundaries are checked against the callee's fixpoint
summary — a blocking helper in ``common/`` called from a coroutine in
``daemon/`` is reported *at the call site*, which is where the executor
hop (the fix) belongs.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from . import Finding, ModuleCtx, Rule, register
from .symbols import (
    _blocking_reason, _dotted, _scan_blocking, _terminal, _walk_scope,
    _CONDISH_RE, _LOCKISH_RE, _SLOW_AWAITS, display,
)

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _lock_ctor_map(tree: ast.Module) -> dict[str, str]:
    """terminal-name -> 'cond' | 'event' | 'lock' for every assignment
    like ``self._cond = asyncio.Condition()`` anywhere in the module."""
    kinds = {"Condition": "cond", "Event": "event", "Lock": "lock",
             "Semaphore": "lock", "BoundedSemaphore": "lock"}
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            value, targets = node.value, node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            value, targets = node.value, [node.target]
        else:
            continue
        if not isinstance(value, ast.Call):
            continue
        ctor = _terminal(value.func)
        kind = kinds.get(ctor or "")
        if kind is None:
            continue
        for t in targets:
            name = _terminal(t)
            if name:
                out[name] = kind
    return out


def _async_display(fn: ast.AsyncFunctionDef, owner: str | None) -> str:
    return f"{owner}.{fn.name}" if owner else fn.name


def _module_functions(tree: ast.Module):
    """(key -> sync def node, list of (async def node, owner-class-name)).

    Keys are ('', name) for module-level defs and (class, name) for
    methods — enough resolution to follow ``self.helper()`` and bare
    ``helper()`` call edges without a real type checker.
    """
    sync: dict[tuple[str, str], ast.FunctionDef] = {}
    asyncs: list[tuple[ast.AsyncFunctionDef, str | None]] = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            sync[("", node.name)] = node
        elif isinstance(node, ast.AsyncFunctionDef):
            asyncs.append((node, None))
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef):
                    sync[(node.name, sub.name)] = sub
                elif isinstance(sub, ast.AsyncFunctionDef):
                    asyncs.append((sub, node.name))
    # a NESTED async def (a coroutine/async generator defined inside
    # another function, like file_client's `chunks()`) still runs on the
    # event loop — it must be a DF001 scan root too, or blocking IO can
    # hide one indentation level down
    top = {id(fn) for fn, _ in asyncs}
    for node in ast.walk(tree):
        if isinstance(node, ast.AsyncFunctionDef) and id(node) not in top:
            asyncs.append((node, None))
    return sync, asyncs


def _call_edges(fn, owner: str | None) -> Iterator[tuple[str, str]]:
    """Keys of module-local functions this function calls directly."""
    for node in _walk_scope(fn.body):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name):
            yield ("", f.id)
        elif (isinstance(f, ast.Attribute)
              and isinstance(f.value, ast.Name)
              and f.value.id in ("self", "cls") and owner):
            yield (owner, f.attr)


# ---------------------------------------------------------------------------
# DF001 — blocking call on the event loop
# ---------------------------------------------------------------------------

@register
class BlockingInAsync(Rule):
    """DF001: blocking call reachable from a coroutine.

    Incident (zero-stall data plane): per-byte CPU and synchronous
    IO on the single event loop capped wire p95 at 68.6 ms and loop lag
    at 139 ms; moving hashing/IO off-loop cut them to 7.2 ms / 1.6 ms.
    The loop thread is the daemon's scarcest resource — a blocking
    ``open()``/``read()``/``time.sleep()``/whole-buffer hash anywhere a
    coroutine can reach stalls EVERY task in the process. Fix: hop
    through ``loop.run_in_executor`` (default executor for cold/control
    paths; the 4-thread storage pool is reserved for span landing).

    The rule follows call edges transitively — module-local ones as in
    v1, and (v2) edges that the package index resolves across module
    boundaries: a sync helper in ``common/`` whose summary says it
    blocks is reported at its call site in the coroutine's own module,
    because that call site is where the executor hop goes. Code inside
    nested sync ``def``s/lambdas is exempt because those are the
    executor thunks themselves.
    """

    code = "DF001"
    name = "blocking-call-in-coroutine"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        sync, asyncs = _module_functions(ctx.tree)
        # transitively mark sync defs reachable from any coroutine
        reached: dict[tuple[str, str], str] = {}
        frontier: list[tuple[tuple[str, str], str]] = []
        for fn, owner in asyncs:
            origin = _async_display(fn, owner)
            for key in _call_edges(fn, owner):
                if key in sync and key not in reached:
                    reached[key] = origin
                    frontier.append((key, origin))
        while frontier:
            key, origin = frontier.pop()
            node = sync[key]
            owner = key[0] or None
            for nxt in _call_edges(node, owner):
                if nxt in sync and nxt not in reached:
                    reached[nxt] = origin
                    frontier.append((nxt, origin))

        for fn, owner in asyncs:
            where = _async_display(fn, owner)
            for call, reason in _scan_blocking(fn.body):
                yield Finding(self.code, ctx.rel, call.lineno,
                              call.col_offset,
                              f"{reason} (in async def {where})")
            yield from self._cross_module(ctx, fn.body, owner or "",
                                          f"async def {where}")
        for key, origin in sorted(reached.items()):
            node = sync[key]
            where = f"{key[0]}.{key[1]}" if key[0] else key[1]
            for call, reason in _scan_blocking(node.body):
                yield Finding(self.code, ctx.rel, call.lineno,
                              call.col_offset,
                              f"{reason} (in {where}(), called from "
                              f"coroutine {origin})")
            yield from self._cross_module(
                ctx, node.body, key[0],
                f"{where}(), called from coroutine {origin}")

    def _cross_module(self, ctx: ModuleCtx, body: list[ast.stmt],
                      owner: str, where: str) -> Iterator[Finding]:
        """v2: calls in this (coroutine-reachable) scope that resolve to
        a *sync* function in another module whose summary blocks."""
        index, mi = ctx.index, ctx.mod
        if index is None or mi is None:
            return
        for node in _walk_scope(body):
            if not isinstance(node, ast.Call):
                continue
            if _blocking_reason(node) is not None:
                continue        # already flagged by the direct scan
            key = index.resolve_call(mi, owner, node)
            if key is None or key[0] == mi.modname:
                continue        # local edges are the v1 pass's job
            info = index.funcs.get(key)
            summ = index.summaries.get(key)
            if info is None or summ is None or info.is_async \
                    or summ.blocking is None:
                continue
            reason, via = summ.blocking
            callee = display(key, index.top)
            hop = f" (via {via})" if via else ""
            yield Finding(
                self.code, ctx.rel, node.lineno, node.col_offset,
                f"call into {callee}(){hop} runs blocking IO on the "
                f"loop thread: {reason} (in {where})")


# ---------------------------------------------------------------------------
# DF002 — orphaned create_task
# ---------------------------------------------------------------------------

_TASKGROUP_NAMES = frozenset({"tg", "taskgroup", "task_group", "nursery"})


@register
class OrphanedCreateTask(Rule):
    """DF002: ``create_task`` whose result is dropped on the floor.

    Incident class: the event loop keeps only a WEAK reference to tasks;
    a fire-and-forget ``create_task`` can be garbage-collected mid-
    flight, and if it isn't, its exception is swallowed silently ("Task
    exception was never retrieved" at interpreter exit, long after the
    damage). Both rpc/balancer.py and scheduler_session.py grew
    ``_close_tasks`` retain-and-discard sets after channel-close tasks
    leaked exactly this way. Fix: retain the task (and drain it on
    close), await it, or attach a done-callback that logs the exception
    — then the rule sees the result captured and stays quiet.
    """

    code = "DF002"
    name = "orphaned-create-task"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            call: ast.Call | None = None
            if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
                call = node.value
            elif (isinstance(node, ast.Assign)
                  and len(node.targets) == 1
                  and isinstance(node.targets[0], ast.Name)
                  and node.targets[0].id == "_"
                  and isinstance(node.value, ast.Call)):
                call = node.value
            if call is None or _terminal(call.func) != "create_task":
                continue
            recv = (call.func.value if isinstance(call.func, ast.Attribute)
                    else None)
            rname = (_terminal(recv) or "").lower() if recv is not None \
                else ""
            if rname in _TASKGROUP_NAMES:
                continue        # TaskGroup retains and joins its children
            yield Finding(
                self.code, ctx.rel, call.lineno, call.col_offset,
                "create_task result discarded — the loop holds only a "
                "weak ref, so the task can be GC'd mid-flight and its "
                "exception is silently swallowed; retain it (and drain "
                "on close), await it, or add a done-callback that logs")


# ---------------------------------------------------------------------------
# DF003 — wait_for around Condition.wait
# ---------------------------------------------------------------------------

@register
class WaitForOnConditionWait(Rule):
    """DF003: ``asyncio.wait_for(<cond>.wait(), t)`` — the dispatcher
    deadlock's shape.

    Incident (silent pod deadlock, zero log output):
    ``wait_for(self._cond.wait(), t)`` under the caller's ``async with``
    splits the lock scope and the wait across TWO tasks. A worker
    cancelled while parked there orphans the inner ``Condition.wait``,
    which re-acquires the condition lock in its ``finally`` and dies
    HOLDING it — every later acquirer (close(), add_parent, the
    teardown gather) queues on the poisoned lock forever. Fix: an
    atomic acquire+wait helper so the lock scope and the wait live in
    ONE coroutine (see ``piece_dispatcher._notified``), then
    ``wait_for`` that helper. ``Event.wait`` has no lock and is exempt
    when the receiver is a known ``asyncio.Event``.
    """

    code = "DF003"
    name = "wait-for-on-condition-wait"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        ctors = _lock_ctor_map(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if _terminal(node.func) != "wait_for" or not node.args:
                continue
            inner = node.args[0]
            if not (isinstance(inner, ast.Call)
                    and isinstance(inner.func, ast.Attribute)
                    and inner.func.attr == "wait"):
                continue
            rname = _terminal(inner.func.value) or ""
            kind = ctors.get(rname)
            if kind == "event":
                continue
            if kind == "cond" or (kind is None and _CONDISH_RE.search(rname)):
                yield Finding(
                    self.code, ctx.rel, node.lineno, node.col_offset,
                    f"wait_for({rname}.wait(), …) on a Condition splits "
                    f"the lock scope and the wait across two tasks — a "
                    f"cancellation leaves the condition lock held forever "
                    f"(PR 2 silent deadlock); use an atomic acquire+wait "
                    f"helper and wait_for THAT")


# ---------------------------------------------------------------------------
# DF004 — cancellation-swallowing except in a coroutine
# ---------------------------------------------------------------------------

def _type_names(expr: ast.expr | None) -> set[str]:
    if expr is None:
        return {"<bare>"}
    if isinstance(expr, ast.Tuple):
        return {t for e in expr.elts for t in _type_names(e)}
    t = _terminal(expr)
    return {t} if t else set()


def _reraises(handler: ast.ExceptHandler) -> bool:
    for node in _walk_scope(handler.body):
        if isinstance(node, ast.Raise) and node.exc is None:
            return True
    return False


@register
class BroadExceptInCoroutine(Rule):
    """DF004: bare/``BaseException`` except in a coroutine without
    re-raise — it eats ``CancelledError``.

    Incident (seed-inherited stall): ``CancelledError`` is a
    ``BaseException`` precisely so ``except Exception`` misses it; a
    broad handler that doesn't re-raise turns a cancellation into a
    normal code path, leaving an undead coroutine its owner believes is
    gone — the e2e suites timed out on exactly such an orphan. A
    handler is clean if it contains a bare ``raise``, or if an earlier
    ``except CancelledError`` arm of the same ``try`` already re-raised.
    ``except Exception`` is always fine.
    """

    code = "DF004"
    name = "cancellation-swallowing-except"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            for node in _walk_scope(fn.body):
                if not isinstance(node, ast.Try):
                    continue
                cancelled_handled = False
                for handler in node.handlers:
                    names = _type_names(handler.type)
                    if "CancelledError" in names and _reraises(handler):
                        cancelled_handled = True
                        continue
                    if not names & {"<bare>", "BaseException"}:
                        continue
                    if cancelled_handled or _reraises(handler):
                        continue
                    what = "bare except" if "<bare>" in names \
                        else "except BaseException"
                    yield Finding(
                        self.code, ctx.rel, handler.lineno,
                        handler.col_offset,
                        f"{what} in async def {fn.name} swallows "
                        f"CancelledError — re-raise it (bare `raise`, or "
                        f"an `except asyncio.CancelledError: raise` arm "
                        f"first), or narrow to `except Exception`")


# ---------------------------------------------------------------------------
# DF005 — slow await while holding an async lock
# ---------------------------------------------------------------------------

@register
class SlowAwaitUnderLock(Rule):
    """DF005: awaiting network/sleep/queue primitives while holding an
    ``async with`` lock or condition.

    Incident class (next to the dispatcher deadlock): that deadlock taught
    us that anything parked inside a held condition outlives the caller's
    patience — and a network read or sleep under a lock converts one
    slow peer into a process-wide convoy (every other task queues on
    the lock for the duration of a stranger's RTT). Inside ``async with
    <lock>:`` the only await that belongs is the lock's own
    ``wait``/``wait_for``; compute the decision under the lock, do the
    IO outside it.

    v2: besides the direct name heuristic, awaits whose call the package
    index resolves to a coroutine (any module) are checked against that
    coroutine's fixpoint summary — ``await self._flush()`` under a lock
    flags when ``_flush`` transitively awaits a network write three
    modules away.
    """

    code = "DF005"
    name = "slow-await-under-lock"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        ctors = _lock_ctor_map(ctx.tree)
        index, mi = ctx.index, ctx.mod

        def lockish(expr: ast.expr) -> str | None:
            name = _terminal(expr)
            if name is None and isinstance(expr, ast.Call):
                name = _terminal(expr.func)
            if name is None:
                return None
            kind = ctors.get(name)
            if kind in ("cond", "lock"):
                return name
            if kind is None and _LOCKISH_RE.search(name):
                return name
            return None

        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            owner = ""
            if index is not None and mi is not None:
                for (cls, name), node in mi.defs.items():
                    if node is fn:
                        owner = cls
                        break
            for node in _walk_scope(fn.body):
                if not isinstance(node, ast.AsyncWith):
                    continue
                held = {n for item in node.items
                        if (n := lockish(item.context_expr)) is not None}
                if not held:
                    continue
                for sub in _walk_scope(node.body):
                    if not (isinstance(sub, ast.Await)
                            and isinstance(sub.value, ast.Call)):
                        continue
                    call = sub.value
                    fname = _terminal(call.func)
                    recv = (call.func.value
                            if isinstance(call.func, ast.Attribute) else None)
                    if recv is not None and _terminal(recv) in held:
                        continue    # cond.wait()/.wait_for(): the pattern
                    if fname in _SLOW_AWAITS:
                        yield Finding(
                            self.code, ctx.rel, sub.lineno, sub.col_offset,
                            f"await {fname}(…) while holding "
                            f"{'/'.join(sorted(held))} — a slow peer or "
                            f"timer convoys every other task on this "
                            f"lock; move the IO outside the lock scope "
                            f"(in async def {fn.name})")
                        continue
                    if index is None or mi is None:
                        continue
                    key = index.resolve_call(mi, owner, call)
                    if key is None:
                        continue
                    info = index.funcs.get(key)
                    summ = index.summaries.get(key)
                    if info is None or summ is None or not info.is_async \
                            or summ.slow is None:
                        continue
                    reason, via = summ.slow
                    callee = display(key, index.top)
                    hop = f" via {via}" if via else ""
                    yield Finding(
                        self.code, ctx.rel, sub.lineno, sub.col_offset,
                        f"await {callee}(…) while holding "
                        f"{'/'.join(sorted(held))} — it transitively "
                        f"{reason}{hop}, convoying every task on this "
                        f"lock; move the call outside the lock scope "
                        f"(in async def {fn.name})")
