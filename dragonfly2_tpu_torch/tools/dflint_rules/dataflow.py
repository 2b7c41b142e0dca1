"""DF007/DF008: resource-lifecycle dataflow — pooled buffers and
acquire/refund pairs.

Counterpart of ``dragonfly2_tpu/tools/dflint_rules/dataflow.py``.

These two families codify this repo's own resource post-mortems the way
DF001–DF005 codify its asyncio ones. They are *dataflow* rules: a value
acquired at one site must provably reach its paired release on every
path the function can take, including the exception paths — which is
exactly where both incident classes hid.

The analysis is deliberately structural, not a full CFG: a release
counts as exception-safe when it lives in a ``finally`` or an ``except``
handler covering the acquire; a straight-line release with an ``await``
(a suspension point — and in this codebase every await can raise) or an
explicit ``raise`` in between is flagged. That approximation has no
false negatives on the shapes this repo has shipped and keeps the rule
readable; anything it over-flags takes a one-line reasoned suppression,
same as every other rule here.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from . import Finding, ModuleCtx, Rule, register
from .symbols import _terminal, _walk_scope

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
_POOLISH_RE = re.compile(r"^_?(buf(fer)?_?)?pool$", re.IGNORECASE)
_LIMITERISH_RE = re.compile(r"limit|bucket|shaper", re.IGNORECASE)


def _recv_terminal(call: ast.Call) -> str | None:
    """Terminal name of a method call's receiver: ``limiter`` for both
    ``limiter.acquire(...)`` and ``self.limiter.acquire(...)``."""
    if isinstance(call.func, ast.Attribute):
        return _terminal(call.func.value)
    return None


def _is_pool_acquire(call: ast.Call) -> bool:
    return (isinstance(call.func, ast.Attribute)
            and call.func.attr == "acquire"
            and bool(_POOLISH_RE.match(_recv_terminal(call) or "")))


def _is_pool_release(call: ast.Call, var: str) -> bool:
    return (isinstance(call.func, ast.Attribute)
            and call.func.attr == "release"
            and bool(_POOLISH_RE.match(_recv_terminal(call) or ""))
            and len(call.args) >= 1
            and isinstance(call.args[0], ast.Name)
            and call.args[0].id == var)


def _stmt_lists(fn) -> Iterator[list[ast.stmt]]:
    """Every statement list in this function scope (bodies, else arms,
    handlers, finallys), without descending into nested functions."""
    stack: list[list[ast.stmt]] = [fn.body]
    while stack:
        body = stack.pop()
        yield body
        for stmt in body:
            if isinstance(stmt, _FUNC_NODES):
                continue
            for fld in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, fld, None)
                if sub and isinstance(sub, list) \
                        and isinstance(sub[0], ast.stmt):
                    stack.append(sub)
            for h in getattr(stmt, "handlers", []) or []:
                stack.append(h.body)


def _refs_var(node: ast.AST, var: str) -> bool:
    return any(isinstance(n, ast.Name) and n.id == var
               for n in ast.walk(node))


def _protected_sites(fn, match) -> bool:
    """True when a node satisfying ``match`` lives inside a ``finally``
    body or an ``except`` handler of some try in this scope — the
    shapes that run on the exception path too."""
    for node in _walk_scope(fn.body):
        if not isinstance(node, ast.Try):
            continue
        covered = list(node.finalbody)
        for h in node.handlers:
            covered.extend(h.body)
        for stmt in covered:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Call) and match(sub):
                    return True
    return False


def _suspends_between(fn, lo: int, hi: int) -> bool:
    """Any await / raise strictly inside the (lo, hi) line window — a
    point where the function can unwind with the resource in hand."""
    for node in _walk_scope(fn.body):
        if isinstance(node, (ast.Await, ast.Raise)) \
                and lo < getattr(node, "lineno", lo) < hi:
            return True
    return False


# ---------------------------------------------------------------------------
# DF007 — pooled-buffer lifecycle
# ---------------------------------------------------------------------------

@register
class PooledBufferLifecycle(Rule):
    """DF007: a ``bufpool`` buffer must reach ``release`` on every path,
    never be retained on ``self``/closures, never be touched after
    release.

    Incident (the zero-stall data plane, made static): the piece-buffer
    pool recycles the 4–16 MiB download buffers; its module contract says
    a released buffer may be handed to ANOTHER download at any moment.
    The contract has three failure modes this rule pins:

    * **leak** — an exception path (and in this codebase every ``await``
      is one) unwinds with the buffer still checked out: the pool
      re-allocates, and at fan-out that is the page-fault storm the pool
      exists to kill. ``piece_downloader._read_body`` releases in an
      ``except BaseException`` arm; ``piece_engine`` releases in a
      ``finally`` — those are the two blessed shapes.
    * **retention** — parking the buffer on ``self`` or in a closure
      outlives the release decision and is how a "freed" buffer grows a
      second owner (the never-retain rule the pool's contract wrote in prose).
    * **use-after-release** — touching the buffer after ``release``
      reads ANOTHER download's bytes; the pool's export-probe catches
      live memoryviews but a plain reference sails through.

    A buffer that is ``return``ed or ``yield``ed transfers ownership to
    the caller (the ``download_piece`` contract) and is exempt.
    """

    code = "DF007"
    name = "pooled-buffer-lifecycle"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            yield from self._check_fn(ctx, fn)

    def _check_fn(self, ctx: ModuleCtx, fn) -> Iterator[Finding]:
        acquired: list[tuple[str, ast.Assign]] = []
        for node in _walk_scope(fn.body):
            if (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)
                    and _is_pool_acquire(node.value)):
                acquired.append((node.targets[0].id, node))
        for var, stmt in acquired:
            yield from self._check_var(ctx, fn, var, stmt)

    def _check_var(self, ctx: ModuleCtx, fn, var: str,
                   acq: ast.Assign) -> Iterator[Finding]:
        releases = [n for n in _walk_scope(fn.body)
                    if isinstance(n, ast.Call)
                    and _is_pool_release(n, var)]
        transferred = any(
            isinstance(n, (ast.Return, ast.Yield, ast.YieldFrom))
            and n.value is not None and _refs_var(n.value, var)
            for n in _walk_scope(fn.body))

        # retention: the buffer must never outlive the function's own
        # bookkeeping — not on self, not in a collection, not captured
        for node in _walk_scope(fn.body):
            if (isinstance(node, ast.Assign)
                    and any(isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                            for t in node.targets)
                    and _refs_var(node.value, var)
                    and node.lineno > acq.lineno):
                yield Finding(
                    self.code, ctx.rel, node.lineno, node.col_offset,
                    f"pooled buffer {var!r} retained on self — the pool "
                    f"may hand its memory to another download after "
                    f"release; never retain pooled buffers (bufpool "
                    f"contract)")
            elif (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("append", "add")
                    and any(isinstance(a, ast.Name) and a.id == var
                            for a in node.args)):
                yield Finding(
                    self.code, ctx.rel, node.lineno, node.col_offset,
                    f"pooled buffer {var!r} stored into a collection — "
                    f"a parked reference outlives the release decision; "
                    f"never retain pooled buffers (bufpool contract)")
        for node in ast.walk(fn):
            if isinstance(node, _FUNC_NODES) and node is not fn \
                    and _refs_var(node, var):
                yield Finding(
                    self.code, ctx.rel, node.lineno, node.col_offset,
                    f"pooled buffer {var!r} captured by a nested "
                    f"function — the closure can touch recycled memory "
                    f"after release; pass bytes, not the pooled buffer")
                break

        if not releases:
            if not transferred:
                yield Finding(
                    self.code, ctx.rel, acq.lineno, acq.col_offset,
                    f"pooled buffer {var!r} never reaches "
                    f"POOL.release() and is not returned to a caller — "
                    f"every leaked buffer re-allocates 4-16 MiB at "
                    f"fan-out (the churn the pool exists to kill)")
            return

        protected = _protected_sites(
            fn, lambda c: _is_pool_release(c, var))
        last_rel = max(r.lineno for r in releases)
        if not protected and _suspends_between(fn, acq.lineno, last_rel):
            yield Finding(
                self.code, ctx.rel, acq.lineno, acq.col_offset,
                f"pooled buffer {var!r} can leak on the exception path "
                f"— an await/raise sits between acquire and release but "
                f"no release runs in a finally/except; use "
                f"try/finally (piece_engine) or except+release+raise "
                f"(_read_body)")

        # use-after-release: a later statement in the same block that
        # touches the buffer reads another download's bytes. Releases
        # inside except handlers don't poison the fall-through path —
        # the handler's own raise/return already left the block
        # (_read_body's except BaseException: release; raise shape).
        for body in _stmt_lists(fn):
            rel_idx = None
            for i, stmt in enumerate(body):
                if isinstance(stmt, ast.Assign) \
                        and _refs_var(stmt.targets[0], var):
                    rel_idx = None      # rebound: tracking restarts
                    continue
                has_rel = any(isinstance(n, ast.Call)
                              and _is_pool_release(n, var)
                              for n in self._fallthrough_nodes(stmt))
                if rel_idx is not None and _refs_var(stmt, var):
                    yield Finding(
                        self.code, ctx.rel, stmt.lineno, stmt.col_offset,
                        f"pooled buffer {var!r} used after "
                        f"POOL.release() (released at line "
                        f"{body[rel_idx].lineno}) — its memory may "
                        f"already belong to another download")
                    break
                if has_rel:
                    rel_idx = i

    @staticmethod
    def _fallthrough_nodes(stmt: ast.stmt) -> Iterator[ast.AST]:
        """Nodes of ``stmt`` that run on the path that *continues past*
        it — skips except-handler bodies (they unwind or re-raise) and
        nested functions."""
        stack: list[ast.AST] = [stmt]
        while stack:
            n = stack.pop()
            yield n
            if isinstance(n, _FUNC_NODES):
                continue
            for c in ast.iter_child_nodes(n):
                if isinstance(c, (ast.ExceptHandler, *_FUNC_NODES)):
                    continue
                stack.append(c)


# ---------------------------------------------------------------------------
# DF008 — acquire/refund pairing for leases and limiter tokens
# ---------------------------------------------------------------------------

@register
class AcquireRefundPairing(Rule):
    """DF008: every optimistic acquire must be dominated by its paired
    release on all exits, exception paths included.

    Incident family (the 404-refund and the eviction-refund): a
    limiter token represents bytes *about to move*; when the move fails
    (404 after an optimistic acquire, a write that raises, an evicted
    span) the tokens must come back via ``refund`` or the bucket's
    capacity leaks one failure at a time until the pipe is "full" of
    ghost traffic. Same family: upload/QoS slots acquired as objects
    (``slot = await gate.acquire()``) that must ``release()`` on every
    path or the gate wedges shut.

    Two arms:

    * **token pairing** — in a function that refunds a limiter anywhere
      (proof the acquires here are optimistic), every ``await
      X.acquire(n)`` must sit inside — or be directly followed by — a
      ``try`` whose handler/finally refunds ``X``. The blessed shape is
      upload_server's: acquire, then try/write/except refund+raise.
    * **lease objects** — a var bound from ``await X.acquire(...)``
      whose ``release()`` this function owns must have a release on the
      exception path (finally/except) when awaits separate acquire from
      release; a lease with NO release that isn't handed off (returned,
      stored, passed to a call) is flagged outright.
    """

    code = "DF008"
    name = "acquire-refund-pairing"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            yield from self._tokens(ctx, fn)
            yield from self._leases(ctx, fn)

    # -- arm 1: limiter tokens -------------------------------------------

    def _tokens(self, ctx: ModuleCtx, fn) -> Iterator[Finding]:
        refunded: set[str] = set()
        for node in _walk_scope(fn.body):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "refund"):
                recv = _recv_terminal(node)
                if recv:
                    refunded.add(recv)
        if not refunded:
            return      # no refunds here: these acquires pay for bytes
                        # already moved — nothing optimistic to pair
        yield from self._visit_block(ctx, fn.body, frozenset(), refunded)

    @staticmethod
    def _try_refunds(stmt: ast.stmt) -> frozenset[str]:
        """Receivers a try statement refunds on unwind (handler or
        finally) — the coverage an acquire inside/before it enjoys."""
        if not isinstance(stmt, ast.Try):
            return frozenset()
        covered = list(stmt.finalbody)
        for h in stmt.handlers:
            covered.extend(h.body)
        out = set()
        for s in covered:
            for n in ast.walk(s):
                if (isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr == "refund"):
                    recv = _recv_terminal(n)
                    if recv:
                        out.add(recv)
        return frozenset(out)

    def _visit_block(self, ctx: ModuleCtx, body: list[ast.stmt],
                     covered: frozenset[str],
                     refunded: set[str]) -> Iterator[Finding]:
        """Walk one statement list. An acquire is refund-covered when an
        enclosing try refunds its receiver on unwind (sound — the
        handler/finally runs however the region exits), or when a try
        later in the same block does AND nothing that can unwind (an
        await or raise outside a try) stands between them — the
        acquire-then-guarded-consume shape upload_server uses.
        ``covered`` carries only the sound enclosing-try coverage into
        nested blocks: a later try in an outer list does NOT protect an
        acquire inside a loop body, because an exception mid-iteration
        never reaches it."""
        for i, stmt in enumerate(body):
            later = set()
            for nxt in body[i + 1:]:
                if isinstance(nxt, ast.Try):
                    # take the try's refunds, then stop if it can
                    # unwind: an exception its handlers don't catch
                    # skips every try after it, so coverage further
                    # down the list is unreachable from here
                    later |= self._try_refunds(nxt)
                    if any(isinstance(n, (ast.Await, ast.Raise))
                           for n in _walk_scope([nxt])):
                        break
                elif any(isinstance(n, (ast.Await, ast.Raise))
                         for n in _walk_scope([nxt])):
                    break       # this statement can unwind first
            eff = covered | later | self._try_refunds(stmt)
            for node in self._expr_nodes(stmt):
                if not (isinstance(node, ast.Await)
                        and isinstance(node.value, ast.Call)):
                    continue
                call = node.value
                if not (isinstance(call.func, ast.Attribute)
                        and call.func.attr == "acquire"):
                    continue
                recv = _recv_terminal(call)
                if recv in refunded and recv not in eff:
                    yield Finding(
                        self.code, ctx.rel, node.lineno, node.col_offset,
                        f"optimistic await {recv}.acquire(…) without a "
                        f"refund on the failure path — this function "
                        f"refunds {recv} elsewhere, so tokens here "
                        f"stand for bytes that may never move; wrap the "
                        f"consume in try/except {recv}.refund(…) "
                        f"(PR 5 404-refund contract)")
            down = covered | self._try_refunds(stmt)
            if isinstance(stmt, _FUNC_NODES):
                continue
            for fld in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, fld, None)
                if sub and isinstance(sub, list) \
                        and isinstance(sub[0], ast.stmt):
                    yield from self._visit_block(ctx, sub, down, refunded)
            for h in getattr(stmt, "handlers", []) or []:
                yield from self._visit_block(ctx, h.body, down, refunded)

    @staticmethod
    def _expr_nodes(stmt: ast.stmt) -> Iterator[ast.AST]:
        """Expression-level nodes of one statement: stop at nested
        statements (they get their own block visit) and functions."""
        stack: list[ast.AST] = [stmt]
        while stack:
            n = stack.pop()
            yield n
            for c in ast.iter_child_nodes(n):
                if isinstance(c, (ast.stmt, ast.ExceptHandler)) \
                        or isinstance(c, _FUNC_NODES):
                    continue
                stack.append(c)

    # -- arm 2: lease objects --------------------------------------------

    def _leases(self, ctx: ModuleCtx, fn) -> Iterator[Finding]:
        leases: list[tuple[str, ast.Assign]] = []
        for node in _walk_scope(fn.body):
            if (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Await)
                    and isinstance(node.value.value, ast.Call)
                    and isinstance(node.value.value.func, ast.Attribute)
                    and node.value.value.func.attr == "acquire"):
                leases.append((node.targets[0].id, node))
        for var, acq in leases:
            releases = [
                n for n in _walk_scope(fn.body)
                if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr == "release"
                and isinstance(n.func.value, ast.Name)
                and n.func.value.id == var]
            if not releases:
                handed_off = any(
                    (isinstance(n, (ast.Return, ast.Yield))
                     and n.value is not None and _refs_var(n.value, var))
                    or (isinstance(n, ast.Call)
                        and any(isinstance(a, ast.Name) and a.id == var
                                for a in n.args))
                    or (isinstance(n, ast.Assign)
                        and any(isinstance(t, ast.Attribute)
                                for t in n.targets)
                        and _refs_var(n.value, var))
                    for n in _walk_scope(fn.body))
                if not handed_off:
                    yield Finding(
                        self.code, ctx.rel, acq.lineno, acq.col_offset,
                        f"lease {var!r} acquired but never released or "
                        f"handed off — an unreleased slot wedges the "
                        f"gate shut for every later acquirer")
                continue
            protected = _protected_sites(
                fn, lambda c: (isinstance(c.func, ast.Attribute)
                               and c.func.attr == "release"
                               and isinstance(c.func.value, ast.Name)
                               and c.func.value.id == var))
            last_rel = max(r.lineno for r in releases)
            if not protected \
                    and _suspends_between(fn, acq.lineno, last_rel):
                yield Finding(
                    self.code, ctx.rel, acq.lineno, acq.col_offset,
                    f"lease {var!r} can leak on the exception path — an "
                    f"await/raise sits between acquire and release but "
                    f"no release runs in a finally/except; an abandoned "
                    f"slot starves the gate (upload-slot discipline)")


# ---------------------------------------------------------------------------
# DF008 — tmp-file fd release on persist paths (statestore idiom)
# ---------------------------------------------------------------------------

def _is_raw_open(call: ast.Call) -> bool:
    """``open(...)`` or ``os.fdopen(...)`` — a file object whose close
    this function owns (a ``with`` block never binds through Assign, so
    it is exempt by construction)."""
    if isinstance(call.func, ast.Name) and call.func.id == "open":
        return True
    return (isinstance(call.func, ast.Attribute)
            and call.func.attr == "fdopen"
            and isinstance(call.func.value, ast.Name)
            and call.func.value.id == "os")


def _calls_os_replace(fn) -> bool:
    for node in _walk_scope(fn.body):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "replace"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "os"):
            return True
    return False


@register
class TmpFdRelease(Rule):
    """DF008 family: a persist path using the tmp+rename idiom must
    release its tmp-file fd on the exception path.

    Incident class (crash-safe state store, made static):
    ``statestore.save`` runs on the GC ticker and swallows every failure
    by design — the snapshot that cannot land must never block a ruling,
    so the NEXT tick retries. On
    an ENOSPC'd or wedged disk that means the torn ``f.write`` raises
    every few seconds forever; with the fd closed only on the
    straight-line path, each retry leaks one descriptor and the process
    walks into EMFILE — at which point the scheduler cannot accept
    connections either, and the "best-effort" snapshot has taken the
    control plane down with it.

    The rule fires on any function that performs the idiom (calls
    ``os.replace``) and binds a raw ``open()``/``os.fdopen()`` to a
    name: the ``close()`` must run in a ``finally`` or ``except`` arm
    (the ``statestore._write`` / ``TaskMetadata.save``-with-``with``
    shapes). A straight-line-only close sits after writes that raise on
    a full disk; no close at all leaks even on success.
    """

    code = "DF008"
    name = "tmp-fd-release"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not _calls_os_replace(fn):
                continue
            yield from self._check_fn(ctx, fn)

    def _check_fn(self, ctx: ModuleCtx, fn) -> Iterator[Finding]:
        for node in _walk_scope(fn.body):
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)
                    and _is_raw_open(node.value)):
                continue
            var = node.targets[0].id
            closes = [
                n for n in _walk_scope(fn.body)
                if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr == "close"
                and isinstance(n.func.value, ast.Name)
                and n.func.value.id == var]
            if not closes:
                yield Finding(
                    self.code, ctx.rel, node.lineno, node.col_offset,
                    f"tmp-file fd {var!r} on a tmp+rename persist path "
                    f"is never closed — every retry of a failing persist "
                    f"leaks one fd until EMFILE; close it in a finally "
                    f"(statestore._write shape) or use `with`")
                continue
            protected = _protected_sites(
                fn, lambda c: (isinstance(c.func, ast.Attribute)
                               and c.func.attr == "close"
                               and isinstance(c.func.value, ast.Name)
                               and c.func.value.id == var))
            if not protected:
                yield Finding(
                    self.code, ctx.rel, node.lineno, node.col_offset,
                    f"tmp-file fd {var!r} closes only on the straight-"
                    f"line path — a torn write (ENOSPC, the "
                    f"sched.snapshot.io fault) raises before close and "
                    f"the retry loop leaks one fd per tick; move the "
                    f"close into a finally (statestore._write shape) or "
                    f"use `with`")
