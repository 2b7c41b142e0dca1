"""Deep ``sys.getsizeof`` walk for bytes-of-state accounting.

Counterpart of ``dragonfly2_tpu/common/sizeof.py``. The control-plane
observatory (``GET /debug/ctrl``, ``scheduler/ctrl_debug.py``) reports
how many bytes of scheduler state each registered peer costs; each
control-plane component (``Resource``, ``DecisionLedger``,
``ShardAffinity``) exposes ``state_bytes()`` built on this walker.

The walk is O(objects), so callers compute it only behind the
``/debug/ctrl`` TTL cache, never on a ruling path. Containers recurse
(dict, list, tuple, set, frozenset, deque), instances recurse through
``__dict__`` and ``__slots__``; a shared object is charged once, so the
cross-references between peers and tasks cannot double-count; modules,
classes and functions are skipped (code, not per-peer state).
"""

from __future__ import annotations

import sys
from collections import deque

# code, not state: classes, modules, functions (python + builtin), and
# bound methods reached through instance attributes
_SKIP = (type, type(sys), type(lambda: 0), type(len), type([].append))


def deep_sizeof(obj, seen: set | None = None) -> int:
    """Total ``sys.getsizeof`` over ``obj`` and everything (transitively)
    reachable from it, each distinct object charged once."""
    if seen is None:
        seen = set()
    stack = [obj]
    total = 0
    while stack:
        o = stack.pop()
        oid = id(o)
        if oid in seen:
            continue
        seen.add(oid)
        if isinstance(o, _SKIP):
            continue
        try:
            total += sys.getsizeof(o)
        except TypeError:
            continue
        if isinstance(o, dict):
            stack.extend(o.keys())
            stack.extend(o.values())
        elif isinstance(o, (list, tuple, set, frozenset, deque)):
            stack.extend(o)
        else:
            d = getattr(o, "__dict__", None)
            if d is not None:
                stack.append(d)
            slots = getattr(type(o), "__slots__", ())
            if isinstance(slots, str):
                slots = (slots,)
            for name in slots:
                try:
                    stack.append(getattr(o, name))
                except AttributeError:
                    continue
    return total
