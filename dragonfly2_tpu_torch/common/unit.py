"""Byte-size units.

Counterpart of ``dragonfly2_tpu/common/unit.py``: the constants,
``parse_bytes`` ("4MiB", "1.5g", 4096) and ``format_bytes`` (``dfget``'s
progress lines).
"""

from __future__ import annotations

import re

KiB = 1024
MiB = 1024 * KiB
GiB = 1024 * MiB
TiB = 1024 * GiB

_SUFFIX = {
    "": 1, "b": 1,
    "k": KiB, "kb": KiB, "kib": KiB,
    "m": MiB, "mb": MiB, "mib": MiB,
    "g": GiB, "gb": GiB, "gib": GiB,
    "t": TiB, "tb": TiB, "tib": TiB,
}

_RE = re.compile(r"^\s*([0-9]*\.?[0-9]+)\s*([a-zA-Z]*)\s*$")


def parse_bytes(s: str | int | float) -> int:
    """Parse a human byte size ("4MiB", "1.5g", 4096) into a byte count."""
    if isinstance(s, (int, float)):
        return int(s)
    m = _RE.match(s)
    if not m:
        raise ValueError(f"invalid byte size: {s!r}")
    num, suffix = m.groups()
    mult = _SUFFIX.get(suffix.lower())
    if mult is None:
        raise ValueError(f"invalid byte-size suffix: {suffix!r}")
    return int(float(num) * mult)


def format_bytes(n: int | float) -> str:
    """Human-format a byte count: 4194304 -> "4.0MiB"."""
    n = float(n)
    for name, mult in (("TiB", TiB), ("GiB", GiB), ("MiB", MiB), ("KiB", KiB)):
        if abs(n) >= mult:
            return f"{n / mult:.1f}{name}"
    return f"{int(n)}B"
