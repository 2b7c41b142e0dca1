"""A small directed-acyclic-graph container.

Counterpart of ``dragonfly2_tpu/common/dag.py``: the per-task peer tree in
the scheduler's resource model. Vertices are peers; an edge parent->child
means the child streams pieces from the parent. Edge insertion refuses
cycles, which keeps the download topology a DAG.
"""

from __future__ import annotations

from typing import Generic, TypeVar

V = TypeVar("V")


class DAGError(Exception):
    pass


class DAG(Generic[V]):
    def __init__(self) -> None:
        self._values: dict[str, V] = {}
        self._children: dict[str, set[str]] = {}
        self._parents: dict[str, set[str]] = {}

    def __contains__(self, vid: str) -> bool:
        return vid in self._values

    def add_vertex(self, vid: str, value: V) -> None:
        if vid in self._values:
            raise DAGError(f"vertex exists: {vid}")
        self._values[vid] = value
        self._children[vid] = set()
        self._parents[vid] = set()

    def delete_vertex(self, vid: str) -> None:
        if vid not in self._values:
            return
        for p in self._parents.pop(vid):
            self._children[p].discard(vid)
        for c in self._children.pop(vid):
            self._parents[c].discard(vid)
        del self._values[vid]

    def add_edge(self, frm: str, to: str) -> None:
        if frm == to:
            raise DAGError("self edge")
        if frm not in self._values or to not in self._values:
            raise DAGError("vertex not found")
        if to in self._children[frm]:
            raise DAGError("edge exists")
        if self.can_reach(to, frm):
            raise DAGError(f"edge {frm}->{to} would create a cycle")
        self._children[frm].add(to)
        self._parents[to].add(frm)

    def delete_edge(self, frm: str, to: str) -> None:
        self._children.get(frm, set()).discard(to)
        self._parents.get(to, set()).discard(frm)

    def delete_in_edges(self, vid: str) -> None:
        for p in list(self._parents.get(vid, ())):
            self.delete_edge(p, vid)

    def can_reach(self, frm: str, to: str) -> bool:
        """True if ``to`` is reachable from ``frm`` along child edges."""
        seen = set()
        stack = [frm]
        while stack:
            v = stack.pop()
            if v == to:
                return True
            if v in seen:
                continue
            seen.add(v)
            stack.extend(self._children.get(v, ()))
        return False

    def children(self, vid: str) -> set[str]:
        return set(self._children.get(vid, ()))

    def parents(self, vid: str) -> set[str]:
        return set(self._parents.get(vid, ()))

    def descendants(self, vid: str) -> set[str]:
        out: set[str] = set()
        stack = list(self._children.get(vid, ()))
        while stack:
            v = stack.pop()
            if v in out:
                continue
            out.add(v)
            stack.extend(self._children.get(v, ()))
        return out
