"""Per-task persistent metadata.

Counterpart of ``dragonfly2_tpu/storage/metadata.py``: the JSON sidecar
that lets a restarted daemon re-index its tasks. A task directory holds
``data`` (the content) and ``metadata.json`` (this), in the same format in
both packages.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass, field

from ..idl.messages import PieceInfo, TaskType

METADATA_FILE = "metadata.json"
DATA_FILE = "data"


@dataclass
class PieceMeta:
    num: int
    start: int           # offset in the task file
    size: int
    digest: str = ""     # "crc32c:..." (or "crc32:...") of this piece
    cost_ms: int = 0     # how long the download took (ML feature)
    source: str = ""     # peer id it came from; "" = back-source

    def to_info(self) -> PieceInfo:
        return PieceInfo(piece_num=self.num, range_start=self.start,
                         range_size=self.size, digest=self.digest,
                         download_cost_ms=self.cost_ms)


@dataclass
class TaskMetadata:
    task_id: str
    task_type: TaskType = TaskType.STANDARD
    url: str = ""
    tag: str = ""
    application: str = ""
    content_length: int = -1
    total_piece_count: int = -1
    piece_size: int = 0
    digest: str = ""                     # whole-content digest if known
    header: dict = field(default_factory=dict)
    pieces: dict[int, PieceMeta] = field(default_factory=dict)
    done: bool = False
    success: bool = False
    # sub-task support: a ranged task stores into its parent's file
    parent_task_id: str = ""
    range_start: int = 0                 # offset of this task's range in parent
    range_length: int = -1
    access_time: float = field(default_factory=time.time)
    create_time: float = field(default_factory=time.time)
    # idl.Priority numeric (0 = highest) and QoS service class: the
    # reference's disk GC orders eviction by them; kept so metadata.json
    # has one format in both packages
    priority: int = 0
    qos_class: str = ""

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["task_type"] = int(self.task_type)
        d["pieces"] = {str(k): dataclasses.asdict(v) for k, v in self.pieces.items()}
        return json.dumps(d)

    @staticmethod
    def from_json(raw: str) -> "TaskMetadata":
        d = json.loads(raw)
        pieces = {int(k): PieceMeta(**v)
                  for k, v in d.pop("pieces", {}).items()}
        d["task_type"] = TaskType(d.get("task_type", 0))
        md = TaskMetadata(**d)
        md.pieces = pieces
        return md

    @staticmethod
    def load(task_dir: str) -> "TaskMetadata":
        with open(os.path.join(task_dir, METADATA_FILE)) as f:
            return TaskMetadata.from_json(f.read())

    def save(self, task_dir: str) -> None:
        """Crash-safe persist: tmp file + fsync + atomic rename + directory
        fsync. A daemon killed mid-persist must never boot with torn
        metadata — the reader sees either the old complete file or the new
        complete file, and the rename itself survives a crash because the
        directory entry is flushed too. Callers run this off-loop
        (mark_done/persist ride the storage executor)."""
        tmp = os.path.join(task_dir, METADATA_FILE + ".tmp")
        with open(tmp, "w") as f:
            f.write(self.to_json())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(task_dir, METADATA_FILE))
        try:
            dfd = os.open(task_dir, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass                    # fs without dir-fsync: best effort
