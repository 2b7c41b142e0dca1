"""StorageManager: the daemon's index of task storages.

Counterpart of ``dragonfly2_tpu/storage/manager.py`` cut to registration,
lookup and deletion. Disk GC, warm-restart reload and content-addressed
dedupe wait for a later slice.
"""

from __future__ import annotations

import os
import threading
import time

from .metadata import TaskMetadata
from .store import TaskStorage


class StorageManager:
    def __init__(self, data_dir: str):
        self.data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self._tasks: dict[str, TaskStorage] = {}
        self._lock = threading.Lock()

    def register_task(self, md: TaskMetadata) -> TaskStorage:
        with self._lock:
            ts = self._tasks.get(md.task_id)
            if ts is None:
                ts = TaskStorage(os.path.join(self.data_dir, md.task_id), md)
                self._tasks[md.task_id] = ts
            return ts

    def get(self, task_id: str) -> TaskStorage | None:
        with self._lock:
            return self._tasks.get(task_id)

    def find_completed_task(self, task_id: str) -> TaskStorage | None:
        ts = self.get(task_id)
        if ts is not None and ts.md.done and ts.md.success:
            ts.md.access_time = time.time()
            return ts
        return None

    def tasks(self) -> list[TaskStorage]:
        with self._lock:
            return list(self._tasks.values())

    def delete_task(self, task_id: str) -> bool:
        with self._lock:
            ts = self._tasks.pop(task_id, None)
        if ts is None:
            return False
        ts.destroy()
        return True
