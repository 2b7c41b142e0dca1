"""Byte-size units.

Counterpart of the constants of ``dragonfly2_tpu/common/unit.py``.
"""

KiB = 1024
MiB = 1024 * KiB
GiB = 1024 * MiB
