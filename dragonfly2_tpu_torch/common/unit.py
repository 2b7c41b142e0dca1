"""Byte-size units.

Counterpart of ``dragonfly2_tpu/common/unit.py``: the constants and
``format_bytes`` (``dfget``'s progress lines).
"""

KiB = 1024
MiB = 1024 * KiB
GiB = 1024 * MiB
TiB = 1024 * GiB


def format_bytes(n: int | float) -> str:
    """Human-format a byte count: 4194304 -> "4.0MiB"."""
    n = float(n)
    for name, mult in (("TiB", TiB), ("GiB", GiB), ("MiB", MiB), ("KiB", KiB)):
        if abs(n) >= mult:
            return f"{n / mult:.1f}{name}"
    return f"{int(n)}B"
