"""Structured logging setup for the service launchers.

Counterpart of ``dragonfly2_tpu/common/logging.py`` (reference
``internal/dflog``): the ``df`` logger tree on stderr with a key=value
formatter, optionally one rotating file per concern. Idempotent.
"""

from __future__ import annotations

import logging
import logging.handlers
import os
import sys

CONCERNS = ("core", "rpc", "gc", "http", "storage", "sched")


class KVFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        base = super().format(record)
        fields = getattr(record, "df_fields", None)
        if fields:
            kv = " ".join(f"{k}={v}" for k, v in fields.items())
            return f"{base} {kv}"
        return base


_configured = False


def setup(level: str = "INFO", log_dir: str | None = None, console: bool = True,
          max_bytes: int = 50 * 1024 * 1024, backups: int = 3) -> None:
    """Configure the ``df`` logger tree. Idempotent."""
    global _configured
    root = logging.getLogger("df")
    if _configured:
        root.setLevel(level.upper())
        return
    _configured = True
    root.setLevel(level.upper())
    root.propagate = False
    fmt = KVFormatter("%(asctime)s %(levelname).1s %(name)s %(message)s")
    if console:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(fmt)
        root.addHandler(h)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        for concern in CONCERNS:
            fh = logging.handlers.RotatingFileHandler(
                os.path.join(log_dir, f"{concern}.log"),
                maxBytes=max_bytes, backupCount=backups)
            fh.setFormatter(fmt)
            logging.getLogger(f"df.{concern}").addHandler(fh)
    if not root.handlers:
        root.addHandler(logging.NullHandler())
