"""Consistent hashing across scheduler instances.

Counterpart of ``HashRing`` in ``dragonfly2_tpu/rpc/balancer.py``
(reference ``pkg/balancer/consistent_hashing.go``): every daemon hashes
the task id onto the scheduler ring so all peers of one task land on the
same scheduler, whose scheduling state is in memory.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Sequence


def _hash(key: str) -> int:
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")


class HashRing:
    def __init__(self, nodes: Sequence[str] = (), replicas: int = 64):
        self.replicas = replicas
        self._ring: list[tuple[int, str]] = []
        self._nodes: set[str] = set()
        for n in nodes:
            self.add(n)

    def add(self, node: str) -> None:
        if node in self._nodes:
            return
        self._nodes.add(node)
        for i in range(self.replicas):
            self._ring.append((_hash(f"{node}#{i}"), node))
        self._ring.sort()

    def remove(self, node: str) -> None:
        if node not in self._nodes:
            return
        self._nodes.discard(node)
        self._ring = [(h, n) for h, n in self._ring if n != node]

    def nodes(self) -> set[str]:
        return set(self._nodes)

    def pick(self, key: str) -> str | None:
        if not self._ring:
            return None
        idx = bisect.bisect(self._ring, (_hash(key), ""))
        if idx == len(self._ring):
            idx = 0
        return self._ring[idx][1]

    def pick_n(self, key: str, n: int) -> list[str]:
        """The n distinct nodes clockwise from the key (failover order)."""
        if not self._ring:
            return []
        idx = bisect.bisect(self._ring, (_hash(key), ""))
        out: list[str] = []
        seen: set[str] = set()
        for i in range(len(self._ring)):
            _, node = self._ring[(idx + i) % len(self._ring)]
            if node not in seen:
                seen.add(node)
                out.append(node)
                if len(out) >= n:
                    break
        return out
