"""Download-record storage: the trainer's dataset, written at report time.

Counterpart of ``dragonfly2_tpu/scheduler/records.py`` (reference
``scheduler/storage/storage.go:142`` CreateDownload append with rotation,
record schemas in ``scheduler/storage/types.go:30-297``). Rows carry the
exact ``trainer/features.py`` feature vector computed at piece-report
time, so the trainer fits on precisely what the ``ml`` evaluator sees at
scoring time.

Rows are JSONL: an in-memory ring for the announcer to drain + an optional
append-only file with size rotation for post-mortems. ``on_flight`` writes
the daemon flight recorder's attribution row and, as the reference does,
one ``kind=edge`` row per parent that served the flight
(``podscope.edges_from_summary``).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time

from ..common.metrics import REGISTRY
from ..common.podscope import edges_from_summary
from ..trainer.features import FEATURE_DIM, label_from_cost
from .evaluator_ml import parent_feature_row
from .resource import Peer

log = logging.getLogger("df.sched.records")

_rows_total = REGISTRY.counter(
    "df_records_rows_total", "record rows appended to the ring", ("kind",))
_dropped = REGISTRY.counter(
    "df_records_dropped_total",
    "record rows dropped by the drop-oldest ring bound")
_flush_failures = REGISTRY.counter(
    "df_records_flush_failures_total",
    "record-file flush batches that failed (rows lost from the file copy)")
_rotations = REGISTRY.counter(
    "df_records_rotations_total", "download.jsonl size rotations")

MAX_BUFFERED_ROWS = 50_000          # ring bound: drop-oldest beyond this
ROTATE_BYTES = 64 << 20             # rotate download.jsonl past 64 MiB
FLUSH_BATCH_ROWS = 64               # file-write batch size
FLUSH_MAX_AGE_S = 1.0               # flush at least this often while rows flow


class DownloadRecords:
    """Implements the ``records`` hook of ``SchedulerService``."""

    def __init__(self, records_dir: str = ""):
        self.records_dir = records_dir
        self._rows: list[dict] = []
        self._peer_rows: list[dict] = []
        self._file = None
        self._file_bytes = 0
        self._pending: list[str] = []
        self._flush_task: asyncio.Task | None = None
        self._timer_task: asyncio.Task | None = None
        self._last_flush = time.time()
        if records_dir:
            os.makedirs(records_dir, exist_ok=True)
            self._open_file()

    def _open_file(self) -> None:
        path = os.path.join(self.records_dir, "download.jsonl")
        # dflint: disable=DF001 — rotation check: two stats per rotation boundary, not per row
        if os.path.exists(path) and os.path.getsize(path) > ROTATE_BYTES:
            # dflint: disable=DF001 — rare size-boundary rotation, metadata syscall
            os.replace(path, path + ".1")
            _rotations.inc()
        # dflint: disable=DF001 — append-mode open once per rotation window
        self._file = open(path, "a", encoding="utf-8")
        self._file_bytes = self._file.tell()

    # -- hooks called by SchedulerService ------------------------------

    def on_piece(self, peer: Peer, result) -> None:
        """One row per successful piece fetched from a parent: the features
        the scheduler saw + the throughput label it observed."""
        if not result.dst_peer_id or result.piece_info is None:
            return
        parent = peer.task.peers.get(result.dst_peer_id)
        if parent is None:
            return
        info = result.piece_info
        features = parent_feature_row(
            peer, parent, total_piece_count=peer.task.total_piece_count)
        row = {
            "kind": "piece",
            "task_id": peer.task.id,
            "peer_id": peer.id,
            "host_id": peer.host.id,
            # join key to the kind=decision row whose offer this piece
            # acted on (the child's newest ruling at scoring time)
            "decision_id": peer.last_decision_id,
            "parent_peer_id": parent.id,
            "parent_host_id": parent.host.id,
            "piece_num": info.piece_num,
            "piece_length": info.range_size,
            "cost_ms": info.download_cost_ms,
            "success": True,
            "fail_code": "",
            "features": features,
            "label": label_from_cost(info.range_size, info.download_cost_ms),
            "created_at": time.time(),
        }
        if getattr(result, "relayed", False):
            # the piece rode the parent's cut-through relay path; the
            # reference marks failed rows only, so an unrelayed row stays
            # the reference's row
            row["relayed"] = True
        self._append(row)

    def on_piece_fail(self, peer: Peer, result) -> None:
        """One row per FAILED piece fetch, carrying the typed
        ``fail_code`` (idl.FAIL_CODES): the outcome join can now learn
        what KIND of failure a ruling produced — a ``corrupt`` verdict
        against a chosen parent is the signal the quarantine ladder
        promoted, and an offline replay should see it too. Label 0.0: a
        failed fetch is a zero-quality outcome for the (decision,
        parent) pair."""
        if not result.dst_peer_id:
            return
        if not getattr(result, "fail_code", ""):
            # untyped failures are backpressure shapes (the engine leaves
            # busy 503s codeless on purpose): a loaded-but-good parent
            # must not teach the trainer that offering it was a
            # zero-quality ruling
            return
        parent = peer.task.peers.get(result.dst_peer_id)
        if parent is None:
            return
        info = result.piece_info
        features = parent_feature_row(
            peer, parent, total_piece_count=peer.task.total_piece_count)
        row = {
            "kind": "piece",
            "task_id": peer.task.id,
            "peer_id": peer.id,
            "host_id": peer.host.id,
            "decision_id": peer.last_decision_id,
            "parent_peer_id": parent.id,
            "parent_host_id": parent.host.id,
            "piece_num": info.piece_num if info is not None else -1,
            "piece_length": info.range_size if info is not None else 0,
            "cost_ms": 0,
            "success": False,
            "fail_code": str(getattr(result, "fail_code", "") or ""),
            "relayed": bool(getattr(result, "relayed", False)),
            "features": features,
            "label": 0.0,
            "created_at": time.time(),
        }
        self._append(row)

    def on_peer(self, peer: Peer, result) -> None:
        """Terminal row per peer run (reference Download record: one line
        per finished download with task/host/parent context)."""
        row = {
            "kind": "peer",
            "task_id": peer.task.id,
            "peer_id": peer.id,
            "host_id": peer.host.id,
            "state": peer.state.value,
            "success": bool(result.success),
            "content_length": result.content_length,
            "total_piece_count": result.total_piece_count,
            "cost_ms": result.cost_ms,
            "finished_pieces": len(peer.finished_pieces),
            "schedule_count": peer.schedule_count,
            "report_fail_count": peer.report_fail_count,
            "created_at": time.time(),
        }
        self._append_peer_row(row)

    def on_flight(self, peer: Peer, summary: dict) -> None:
        """Latency-attribution row per finished peer run, from the
        daemon's flight recorder (the compact summary on its PeerResult):
        where the time went, per-parent throughput, tail latencies. Then
        one ``kind=edge`` row per parent that served the flight, with the
        observed edge throughput (the podscope schema; the decision
        ledger's ``stitch_outcomes`` joins them to the ruling)."""
        self._append_peer_row({
            "kind": "flight",
            "task_id": peer.task.id,
            "peer_id": peer.id,
            "host_id": peer.host.id,
            "summary": summary,
            "created_at": time.time(),
        })
        now = time.time()
        for edge in edges_from_summary(peer.task.id, peer.id,
                                       peer.host.id, summary):
            edge["created_at"] = now
            self._append_peer_row(edge)

    def on_decision(self, row: dict) -> None:
        """One row per scheduler ruling (``Scheduling._decide`` via the
        decision ledger): the candidate set with per-term decomposition,
        exclusions, and the chosen offer — the decision half that
        ``kind=piece`` / ``kind=edge`` outcome rows join against."""
        if "created_at" not in row:
            row = dict(row)
            row["created_at"] = time.time()
        self._append_peer_row(row)

    # -- internals -----------------------------------------------------

    def _append_peer_row(self, row: dict) -> None:
        """Ring-append a non-piece (peer/decision) row +
        buffer its line."""
        self._peer_rows.append(row)
        _rows_total.labels(str(row.get("kind", ""))).inc()
        if len(self._peer_rows) > MAX_BUFFERED_ROWS:
            _dropped.inc(len(self._peer_rows) - MAX_BUFFERED_ROWS)
            self._peer_rows = self._peer_rows[-MAX_BUFFERED_ROWS:]
        self._write(row)

    def _append(self, row: dict) -> None:
        self._rows.append(row)
        _rows_total.labels(str(row.get("kind", ""))).inc()
        if len(self._rows) > MAX_BUFFERED_ROWS:
            _dropped.inc(len(self._rows) - MAX_BUFFERED_ROWS)
            self._rows = self._rows[-MAX_BUFFERED_ROWS:]
        self._write(row)

    def _write(self, row: dict) -> None:
        """Buffer the row's line; file IO happens in worker threads in
        batches. This runs inside ``_handle_piece_result`` — one synchronous
        disk write per piece report would stall every scheduling RPC on the
        event loop at fan-out rates (thousands of reports/s)."""
        if self._file is None:
            return
        self._pending.append(json.dumps(row) + "\n")
        self._ensure_timer()   # from the FIRST buffered row, not first flush
        if (len(self._pending) >= FLUSH_BATCH_ROWS
                or time.time() - self._last_flush > FLUSH_MAX_AGE_S):
            self._schedule_flush()

    def _ensure_timer(self) -> None:
        if self._timer_task is not None:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return
        self._timer_task = loop.create_task(self._timer_flush())

    def _schedule_flush(self) -> None:
        batch, self._pending = self._pending, []
        self._last_flush = time.time()
        prev = self._flush_task

        async def run() -> None:
            if prev is not None and not prev.done():
                try:
                    await asyncio.shield(prev)  # keep append order
                except Exception:               # noqa: BLE001
                    # a failed earlier batch must not take this one with it
                    log.warning("previous record flush failed", exc_info=True)
            await asyncio.to_thread(self._flush_sync, batch)

        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:                    # no loop (sync tests/tools)
            self._flush_sync(batch)
            return
        self._flush_task = loop.create_task(run())

    async def _timer_flush(self) -> None:
        """Age-based flush: _write only checks FLUSH_MAX_AGE_S on the next
        row, so under a trickle the last <64 rows would sit buffered
        indefinitely without this."""
        while self._file is not None:
            await asyncio.sleep(FLUSH_MAX_AGE_S)
            if (self._pending
                    and time.time() - self._last_flush > FLUSH_MAX_AGE_S):
                self._schedule_flush()

    def _flush_sync(self, batch: list[str]) -> None:
        if self._file is None:
            return
        data = "".join(batch)
        try:
            self._file.write(data)
        except (OSError, ValueError):
            # counted at the raise site so every flush path (batch task,
            # timer, sync fallback, close) is covered; ValueError is the
            # closed-file race. The batch is lost from the FILE copy only
            # — the ring already holds the rows
            _flush_failures.inc()
            raise
        self._file_bytes += len(data)
        if self._file_bytes > ROTATE_BYTES:
            self._file.close()
            self._open_file()

    # -- consumption ---------------------------------------------------

    def piece_row_count(self) -> int:
        return len(self._rows)

    def drain(self) -> list[dict]:
        """Hand all buffered piece+peer rows to the announcer and clear the
        ring (the file copy, if any, is untouched)."""
        rows, self._rows = self._rows, []
        peer_rows, self._peer_rows = self._peer_rows, []
        return rows + peer_rows

    def requeue(self, rows: list[dict]) -> None:
        """Return drained rows after a failed upload (oldest first; the
        ring bound still applies)."""
        piece = [r for r in rows if r.get("kind") == "piece"]
        # peer + decision
        peer = [r for r in rows if r.get("kind") != "piece"]
        over = (max(0, len(piece) + len(self._rows) - MAX_BUFFERED_ROWS)
                + max(0, len(peer) + len(self._peer_rows)
                      - MAX_BUFFERED_ROWS))
        if over:
            _dropped.inc(over)
        self._rows = (piece + self._rows)[-MAX_BUFFERED_ROWS:]
        self._peer_rows = (peer + self._peer_rows)[-MAX_BUFFERED_ROWS:]

    async def aclose(self) -> None:
        """Drain the in-flight flush chain, write the tail, close the file.
        The async variant is the correct one inside a running scheduler —
        ``close()`` alone can race a background ``to_thread`` write against
        the file close (rows lost or write-to-closed-file)."""
        if self._timer_task is not None:
            self._timer_task.cancel()
            self._timer_task = None
        task = self._flush_task
        if task is not None and not task.done():
            try:
                await task
            except Exception:                   # noqa: BLE001
                log.warning("final record flush failed", exc_info=True)
        self._flush_task = None
        self.close()

    def close(self) -> None:
        if self._timer_task is not None:
            self._timer_task.cancel()
            self._timer_task = None
        if self._pending:
            try:
                self._flush_sync(self._pending)
            except (OSError, ValueError):
                # counted ONCE at the raise site in _flush_sync; the tail
                # batch is lost from the file copy only. Swallowed here
                # because close() runs inside the scheduler's shutdown
                # sequence — a disk that died (or a file something closed
                # first) must not abort the rest of teardown behind us
                # (statestore save, handoff export, manager close)
                log.warning("tail record flush failed at close",
                            exc_info=True)
            self._pending = []
        if self._file is not None:
            self._file.close()
            self._file = None


# drift guard: schema changes must touch all parties (not an assert — that
# would be silently stripped under `python -O`)
if FEATURE_DIM != 7:
    raise RuntimeError(f"records schema expects FEATURE_DIM=7, trainer "
                       f"declares {FEATURE_DIM}; update on_piece/features.py "
                       f"together")
