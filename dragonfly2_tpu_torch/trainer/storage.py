"""Trainer dataset storage: uploaded rows keyed by (source host, dataset).

Counterpart of ``dragonfly2_tpu/trainer/storage.py``, copied whole
(reference ``trainer/storage/storage.go:148``): one file per uploading
scheduler instance, created on first chunk, cleared after a training run
consumes it. Datasets are JSONL (gzip on the wire, stored decompressed so
training can stream rows without re-inflating).
"""

from __future__ import annotations

import gzip
import json
import logging
import os
import re

log = logging.getLogger("df.trainer.storage")

DATASETS = ("download", "networktopology")


def _safe_key(hostname: str, ip: str) -> str:
    raw = f"{hostname}_{ip}"
    return re.sub(r"[^A-Za-z0-9_.-]", "-", raw) or "unknown"


class TrainerStorage:
    def __init__(self, base_dir: str):
        self.base_dir = base_dir
        os.makedirs(base_dir, exist_ok=True)

    def _path(self, dataset: str, hostname: str, ip: str) -> str:
        if dataset not in DATASETS:
            raise ValueError(f"unknown dataset {dataset!r}")
        return os.path.join(self.base_dir,
                            f"{dataset}_{_safe_key(hostname, ip)}.jsonl")

    def append_chunk(self, dataset: str, hostname: str, ip: str,
                     chunk: bytes, *, compressed: bool = True) -> int:
        """Append one uploaded chunk; returns rows written."""
        data = gzip.decompress(chunk) if compressed else chunk
        text = data.decode("utf-8")
        rows = sum(1 for line in text.splitlines() if line.strip())
        with open(self._path(dataset, hostname, ip), "a",
                  encoding="utf-8") as f:
            f.write(text if text.endswith("\n") or not text else text + "\n")
        return rows

    def rows(self, dataset: str) -> list[dict]:
        """All rows of one dataset across every uploader."""
        out: list[dict] = []
        prefix = f"{dataset}_"
        for name in sorted(os.listdir(self.base_dir)):
            if not (name.startswith(prefix) and name.endswith(".jsonl")):
                continue
            with open(os.path.join(self.base_dir, name),
                      encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except json.JSONDecodeError:
                        log.warning("bad row in %s skipped", name)
        return out

    def requeue_rows(self, dataset: str, rows: list[dict]) -> None:
        """Return consumed rows after a FAILED fit (at-least-once delivery:
        the announcer's upload already succeeded, so losing the snapshot
        here would silently drop the dataset)."""
        if not rows:
            return
        path = self._path(dataset, "requeued", "local")
        with open(path, "a", encoding="utf-8") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")

    def clear(self, dataset: str | None = None) -> None:
        """Drop consumed datasets after a training run (reference clears
        per-host files the same way)."""
        for name in os.listdir(self.base_dir):
            if not name.endswith(".jsonl"):
                continue
            if dataset is None or name.startswith(f"{dataset}_"):
                os.unlink(os.path.join(self.base_dir, name))
