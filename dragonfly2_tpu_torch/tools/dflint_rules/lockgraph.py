"""DF009: package-wide async lock-ordering.

Counterpart of ``dragonfly2_tpu/tools/dflint_rules/lockgraph.py``.

The only rule family that *cannot* run per module: a lock-order cycle is
two call sites in two files each holding its own lock while reaching for
the other's. It registers as a GlobalRule — the engine runs it once per
package graph after the per-module pass, and its findings land in the
module each edge site lives in (so the suppression grammar and the DF000
unused-suppression audit apply unchanged).

Incident (QoS admission): the first QoS cut awaited ``qos.admit()`` while still
holding the PeerTaskManager lock. Admission parks on a bounded brownout
queue for up to a deadline — so one bulk request under pressure held the
lock every critical-path conductor creation needs: a priority inversion
by lock, invisible to DF005 because ``admit`` looks nothing like a
network primitive and lives two modules away. The shipped fix moved
admission OUTSIDE the lock (see peertask_manager.get_or_create_conductor,
whose comment is this rule's docstring in the flesh).

Three shapes, all computed off the pass-1 summaries:

* **re-entry** — while holding lock L, a call path re-acquires L.
  asyncio locks are non-reentrant: the task deadlocks against itself,
  with zero log output (the dispatcher deadlock's silence, one abstraction up).
* **cycle** — the lock-acquisition graph (edge L→M: some path acquires
  M while holding L) has a cycle: two tasks taking the locks in
  opposite orders deadlock under load, which is precisely when it
  finally happens.
* **inversion** — while holding a lock, awaiting something whose
  summary says it *parks on capacity* (an admission future, a
  condition, a semaphore/queue) — or, name-heuristic arm, awaiting an
  unresolvable ``*.admit(...)``. The lock's critical section then lasts
  a stranger's deadline.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Iterator

from . import Finding, GlobalRule, register_global
from .symbols import (
    ModuleIndex, PackageIndex, _park_reason, _terminal, _walk_scope,
    _SLOW_AWAITS, display,
)


@dataclass
class _Edge:
    src: str            # lock identity held
    dst: str            # lock identity acquired under it
    modname: str
    rel_line: int
    via: str            # callee display when the acquire is transitive


@register_global
class LockOrdering(GlobalRule):
    """DF009: async lock-ordering — cycles, re-entry, and the
    await-admission-while-holding-a-lock priority inversion (QoS admission).
    See the module docstring for the incident."""

    code = "DF009"
    name = "async-lock-ordering"

    def check_package(self, index: PackageIndex,
                      analyzed: dict[str, str]) -> Iterator[Finding]:
        edges: list[_Edge] = []
        inversions: list[tuple[str, int, str, str]] = []  # mod, line, msg…
        for key, info in index.funcs.items():
            mi = index.modules.get(key[0])
            if mi is None:
                continue
            self._scan_fn(index, mi, key[1], info, edges, inversions)

        # ---- cycles over the package-wide graph -------------------------
        adj: dict[str, set[str]] = {}
        first_site: dict[tuple[str, str], _Edge] = {}
        for e in edges:
            adj.setdefault(e.src, set()).add(e.dst)
            first_site.setdefault((e.src, e.dst), e)

        reach_memo: dict[str, set[str]] = {}

        def reach(start: str) -> set[str]:
            if start in reach_memo:
                return reach_memo[start]
            seen: set[str] = set()
            stack = [start]
            while stack:
                n = stack.pop()
                for m in adj.get(n, ()):
                    if m not in seen:
                        seen.add(m)
                        stack.append(m)
            reach_memo[start] = seen
            return seen

        reported: set[tuple[str, int, str, str]] = set()
        for e in edges:
            if e.modname not in analyzed:
                continue
            rel = analyzed[e.modname]
            dedupe = (e.modname, e.rel_line, e.src, e.dst)
            if dedupe in reported:
                continue
            via = f" (via {e.via})" if e.via else ""
            if e.src == e.dst:
                reported.add(dedupe)
                yield Finding(
                    self.code, rel, e.rel_line, 0,
                    f"{e.src} re-acquired{via} while already held — "
                    f"asyncio locks are non-reentrant, so this task "
                    f"deadlocks against itself with zero log output")
            elif e.src in reach(e.dst):
                back = first_site.get((e.dst, e.src))
                where = ""
                if back is not None:
                    back_mod = index.modules.get(back.modname)
                    back_rel = analyzed.get(
                        back.modname,
                        back_mod.disp if back_mod else back.modname)
                    where = f" (reverse order at {back_rel}:" \
                            f"{back.rel_line})"
                reported.add(dedupe)
                yield Finding(
                    self.code, rel, e.rel_line, 0,
                    f"lock-order cycle: {e.dst} acquired{via} while "
                    f"holding {e.src}, but another path takes them in "
                    f"the opposite order{where} — two tasks interleaving "
                    f"there deadlock the pod")

        for modname, line, lockname, msg in inversions:
            if modname not in analyzed:
                continue
            yield Finding(self.code, analyzed[modname], line, 0,
                          f"priority inversion: {msg} while holding "
                          f"{lockname} — the critical section now lasts "
                          f"a stranger's admission deadline; take "
                          f"admission OUTSIDE the lock (PR 11 ptm shape)")

    # ------------------------------------------------------------------

    def _scan_fn(self, index: PackageIndex, mi: ModuleIndex, owner: str,
                 info, edges: list[_Edge],
                 inversions: list[tuple[str, int, str, str]]) -> None:
        for node in _walk_scope(info.node.body):
            if not isinstance(node, ast.AsyncWith):
                continue
            held: list[tuple[str, str]] = []    # (identity, local name)
            for item in node.items:
                li = index.lock_identity(mi, owner, item.context_expr)
                if li is not None:
                    name = _terminal(item.context_expr) or ""
                    held.append((li[0], name))
            if not held:
                continue
            held_ids = {h[0] for h in held}
            held_names = {h[1] for h in held}
            for sub in _walk_scope(node.body):
                if isinstance(sub, ast.AsyncWith):
                    for item in sub.items:
                        li = index.lock_identity(mi, owner,
                                                 item.context_expr)
                        if li is None:
                            continue
                        for hid in held_ids:
                            edges.append(_Edge(hid, li[0], mi.modname,
                                               sub.lineno, ""))
                elif isinstance(sub, ast.Await):
                    self._scan_await(index, mi, owner, sub, held,
                                     held_ids, held_names, edges,
                                     inversions)

    def _scan_await(self, index, mi, owner, sub: ast.Await, held,
                    held_ids, held_names, edges, inversions) -> None:
        awaited = sub.value
        # bare future awaited under a lock: parks on capacity DF005's
        # call-shaped heuristics can't see
        if isinstance(awaited, ast.Name):
            park = _park_reason(awaited,
                                lambda n: mi.lock_kind(owner, n))
            if park is not None:
                for hid in held_ids:
                    inversions.append((mi.modname, sub.lineno, hid, park))
            return
        if not isinstance(awaited, ast.Call):
            return
        recv = None
        if isinstance(awaited.func, ast.Attribute):
            recv = _terminal(awaited.func.value)
        if recv is not None and recv in held_names:
            return      # the held cond's own wait/wait_for: the pattern
        key = index.resolve_call(mi, owner, awaited)
        if key is None:
            # unresolved but directly park-shaped: `await sem.acquire()`
            # under a lock is the QoS-admission inversion with no helper to
            # resolve through. Names DF005 already flags (wait_for,
            # queue get/put) stay DF005's — this arm takes only the
            # park-shapes DF005's vocabulary can't see.
            t = _terminal(awaited.func)
            if t not in _SLOW_AWAITS:
                park = _park_reason(awaited,
                                    lambda n: mi.lock_kind(owner, n))
                if park is not None:
                    # an explicit lock/sem acquire also feeds the
                    # ordering graph, same as its `async with` form
                    if t == "acquire":
                        li = index.lock_identity(mi, owner,
                                                 awaited.func.value)
                        if li is not None:
                            for hid in held_ids:
                                edges.append(_Edge(hid, li[0],
                                                   mi.modname,
                                                   sub.lineno, ""))
                    for hid in held_ids:
                        inversions.append(
                            (mi.modname, sub.lineno, hid, park))
            if t == "admit":
                target = f"{recv}.admit" if recv else "admit"
                for hid in held_ids:
                    inversions.append(
                        (mi.modname, sub.lineno, hid,
                         f"await {target}(…) — admission gates park on "
                         f"queue capacity"))
            return
        if key is not None:
            summ = index.summaries.get(key)
            info = index.funcs.get(key)
            if summ is None or info is None or not info.is_async:
                return
            callee = display(key, index.top)
            for lock in summ.acquires:
                via = summ.acquires[lock]
                hop = f"{callee} via {via}" if via else callee
                for hid in held_ids:
                    edges.append(_Edge(hid, lock, mi.modname,
                                       sub.lineno, hop))
            if summ.parks is not None:
                reason, via = summ.parks
                hop = f" (via {via})" if via else ""
                for hid in held_ids:
                    inversions.append(
                        (mi.modname, sub.lineno, hid,
                         f"await {callee}(…){hop} — it {reason}"))
