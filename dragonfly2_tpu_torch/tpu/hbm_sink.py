"""The device sink: verified pieces land in device memory, overlapped with
the download.

Counterpart of ``dragonfly2_tpu/tpu/hbm_sink.py``. Design:

- Pieces are copied into a preallocated host staging tensor at their
  content offsets. When the sink's devices are CUDA devices the staging
  tensor is pinned (page-locked), so the host-to-device copies are DMA by
  the copy engines and run asynchronously to the host. In manifest mode
  the staging tensor holds only the named shards' byte ranges, packed
  back to back: pinned pages are committed up front (and the host
  allocator rounds each block up), so staging the whole content for a
  shard subset would pin the whole file. Bytes outside every named
  range are skipped.
- The content is split into byte shards. The moment every byte of a shard
  is present, that shard's index is enqueued to one worker thread that owns
  every host-to-device copy. ``write()`` never waits on a copy: the landing
  path only memcpys.
- The worker copies each shard as ``uint8`` into a device tensor of its own
  (offset 0) with ``copy_(non_blocking=True)`` on a per-sink
  ``torch.cuda.Stream``, records a ``torch.cuda.Event`` after it, and ends
  the shard's transfer span at ``event.synchronize()``. The device tensor is
  then viewed as the shard's dtype and shape on the device.
- ``result()`` drains the queue and hands the tensors out after making the
  caller's current stream wait on each shard's event and recording that
  stream on each tensor (a tensor allocated on the side stream is otherwise
  free for reuse there as soon as the caller drops it, even while the
  caller's stream still reads it).

Single-host by design: each daemon feeds its own host's devices; cross-host
distribution is the P2P fabric's job.
"""

from __future__ import annotations

import bisect
import logging
import queue
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from ..common import faultgate
from ..common.metrics import REGISTRY
from .mesh import cuda_devices

log = logging.getLogger("df.storage.hbm")

# sink telemetry in the process registry: the copy overlap picture must
# survive the task and be visible to an operator mid-download
_hbm_transfer_s = REGISTRY.histogram(
    "df_hbm_transfer_seconds", "device shard DMA duration",
    buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
             5.0, 10.0))
_hbm_transfers = REGISTRY.counter(
    "df_hbm_transfers_total", "device shard transfers", ("result",))
_hbm_bytes = REGISTRY.counter(
    "df_hbm_staged_bytes_total", "bytes staged into the host buffer")
_hbm_queue = REGISTRY.gauge(
    "df_hbm_transfer_queue_depth", "shard transfers enqueued, not yet done")
_hbm_done = REGISTRY.gauge(
    "df_hbm_done_fraction", "coverage fraction of the most recent sink")

# dtype strings a shard spec or sink may name. Kept here, not resolved
# through numpy: numpy knows "bfloat16" only once a third-party dtype
# package has registered it.
DTYPES = {
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int32": torch.int32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r} "
                         f"(known: {sorted(DTYPES)})") from None


class CoverageMap:
    """Tracks which byte ranges are present; answers 'is [a,b) complete?'.

    Piece arrivals are arbitrary-order; ranges are merged as they land.
    """

    def __init__(self) -> None:
        self._ranges: list[tuple[int, int]] = []  # merged, sorted [start,end)
        self._lock = threading.Lock()

    def add(self, start: int, end: int) -> None:
        with self._lock:
            lo, hi = start, end
            out = []
            inserted = False
            for s, e in self._ranges:
                if e < lo or s > hi:   # disjoint
                    if s > hi and not inserted:
                        out.append((lo, hi))
                        inserted = True
                    out.append((s, e))
                else:                   # overlap/adjacent: merge
                    lo, hi = min(lo, s), max(hi, e)
            if not inserted:
                out.append((lo, hi))
            out.sort()
            self._ranges = out

    def covers(self, start: int, end: int) -> bool:
        if start >= end:
            return True
        with self._lock:
            for s, e in self._ranges:
                if s <= start and end <= e:
                    return True
        return False

    def covered_bytes(self) -> int:
        with self._lock:
            return sum(e - s for s, e in self._ranges)


class DeviceIngest:
    """Streams a task's bytes into per-device shards as pieces arrive.

    All device copies run on one dedicated worker thread, so neither the
    asyncio event loop nor the piece-landing path ever waits on a copy.
    """

    def __init__(self, content_length: int, *, devices: Any = None,
                 sharding: Any = None, dtype: str = "uint8",
                 shards_per_device: int = 1,
                 shard_specs: list | None = None,
                 on_shard_ready: Callable[[str, float], None] | None = None,
                 device_put_fn: Callable[[torch.Tensor, torch.device],
                                         torch.Tensor] | None = None):
        """``devices``: explicit device list (contiguous shards per device;
        default every CUDA device, and an error when there is none), or
        ``sharding``: a ``tpu.mesh.NamedSharding`` whose mesh fixes the
        device order. ``shards_per_device`` > 1 pipelines the copies: each
        device's range is cut into that many transfer units so copying
        overlaps the download even on one device. Only 1 is supported with
        ``sharding``. ``device_put_fn(uint8_host_view, device) -> tensor``
        replaces the copy (tests inject slow or failing ones).

        ``shard_specs`` switches the sink to MANIFEST mode: each entry is
        ``(name, start, size[, dtype, shape])``, a named byte range that is
        copied the moment its bytes are covered (ranges may be uneven, need
        not cover the content, and gaps are neither staged nor copied:
        ``pinned_bytes`` is the specs' bytes, and writes outside every
        spec are skipped). ``result()`` then
        returns ``{name: tensor}``, each viewed as the spec's dtype (the
        sink default when "") and reshaped to the spec's shape when given.
        Devices are assigned round-robin per spec. Incompatible with
        ``sharding``. ``on_shard_ready(name, monotonic_done_time)`` is
        called ON THE WORKER THREAD after each named shard's copy completes;
        it must be cheap and thread-safe."""
        if content_length <= 0:
            raise ValueError("content_length must be known for device ingest")
        self.content_length = content_length
        self.dtype = torch_dtype(dtype)
        self._sharding = sharding
        if sharding is not None:
            if shards_per_device != 1:
                raise ValueError("shards_per_device must be 1 with sharding")
            if shard_specs is not None:
                raise ValueError("shard_specs incompatible with sharding")
            devices = list(sharding.mesh.devices.flat)
        elif devices is None:
            devices = cuda_devices()
        self.devices = [_indexed(torch.device(d)) for d in devices]
        self.shards_per_device = max(1, shards_per_device)
        self.on_shard_ready = on_shard_ready
        self._specs: list[tuple] | None = None
        if shard_specs is not None:
            if not shard_specs:
                raise ValueError("shard_specs must be non-empty")
            specs = []
            for sp in shard_specs:
                name, start, size = sp[0], int(sp[1]), int(sp[2])
                sdtype = torch_dtype(sp[3]) if len(sp) > 3 and sp[3] \
                    else self.dtype
                shape = tuple(sp[4]) if len(sp) > 4 and sp[4] else None
                if size <= 0 or start < 0 or start + size > content_length:
                    raise ValueError(f"shard {name}: bad range "
                                     f"[{start}, {start + size})")
                if size % sdtype.itemsize:
                    raise ValueError(f"shard {name}: size {size} not a "
                                     f"multiple of {sdtype} itemsize")
                specs.append((name, start, size, sdtype, shape))
            self._specs = specs
            n = len(specs)
            self.n_shards = n
            self.padded_length = content_length
            self.shard_bytes = 0            # uneven; see _shard_range
            # overlap scan order: (start, end, index) sorted by start
            self._spec_order = sorted(
                (sp[1], sp[1] + sp[2], i) for i, sp in enumerate(specs))
            # staged segments: the specs' ranges merged where they touch,
            # each (content start, content end, staging offset)
            segments: list[list[int]] = []
            for st, en, _i in self._spec_order:
                if segments and st <= segments[-1][1]:
                    segments[-1][1] = max(segments[-1][1], en)
                else:
                    segments.append([st, en])
            self._segments: list[tuple[int, int, int]] = []
            staged = 0
            for st, en in segments:
                self._segments.append((st, en, staged))
                staged += en - st
            self._seg_starts = [seg[0] for seg in self._segments]
            self.staged_length = staged
        else:
            n = len(self.devices) * self.shards_per_device
            self.n_shards = n
            # equal shards padded to dtype & shard-count alignment
            itemsize = self.dtype.itemsize
            padded = -(-content_length // (n * itemsize)) * (n * itemsize)
            self.padded_length = padded
            self.shard_bytes = padded // n
            self.staged_length = padded
        # pinned staging only for CUDA devices; a failed pin raises (a
        # pageable buffer would make every copy a synchronous bounce)
        pin = any(d.type == "cuda" for d in self.devices)
        # pinned bytes as the host allocator hands them out: it rounds each
        # block up, so the count is read from its own statistics, around
        # an allocation no other sink's overlaps (CUDA pins one buffer at
        # a time anyway). torch reports no statistics before its own CUDA
        # initialization, which a pinned allocation alone does not run
        if pin:
            torch.cuda.init()
        with _PIN_LOCK:
            handed0 = _pinned_handed_out() if pin else 0
            t0 = time.monotonic()
            self.host = torch.empty(self.staged_length, dtype=torch.uint8,
                                    pin_memory=pin)
            self.pin_seconds = time.monotonic() - t0 if pin else 0.0
            self.pinned_bytes = (_pinned_handed_out() - handed0
                                 if pin else 0)
        self._host_np = self.host.numpy()
        if self._specs is None:
            self._host_np[content_length:] = 0  # the pad tail is zeros
        self._coverage = CoverageMap()
        self._shard_arrays: list[Any | None] = [None] * n
        self._shard_events: list[Any | None] = [None] * n
        self._shard_sent = [False] * n       # transfer COMPLETED
        self._shard_queued = [False] * n     # enqueued to the worker
        # (monotonic start, end) of each completed device copy — lets
        # callers measure how much copying ran during the download
        self.transfer_spans: list[tuple[float, float]] = []
        self._lock = threading.Lock()
        self._device_put = device_put_fn
        self._streams: dict[torch.device, Any] = {}   # worker-owned
        self._queue: queue.SimpleQueue = queue.SimpleQueue()
        self._pending = 0                    # queued-but-unfinished transfers
        self._idle = threading.Event()
        self._idle.set()
        self._error: BaseException | None = None
        self._closed = False
        self._worker = threading.Thread(target=self._transfer_loop,
                                        name="hbm-sink", daemon=True)
        self._worker.start()
        if content_length < self.padded_length:  # pad tail trivially "present"
            self._coverage.add(content_length, self.padded_length)

    # ------------------------------------------------------------------
    # producer side (piece-landing path) — never waits on a copy
    # ------------------------------------------------------------------

    def write(self, offset: int, data: bytes | memoryview) -> None:
        """Land one verified piece; enqueues device copies for any shard
        the piece completes. Returns as soon as the memcpy is done.

        Buffer lifetime rule: this method NEVER retains a reference to
        ``data`` past its return. The assignment below copies into the
        sink's own staging tensor, so the landing path may reuse the piece
        buffer the moment this returns. Device copies read ONLY
        ``self.host``, never the caller's buffer."""
        if faultgate.ARMED:
            # a raising script here exercises the conductor's sink-failure
            # path: ingest disabled, download continues to disk
            faultgate.fire_sync("hbm.ingest")
        end = offset + len(data)
        if end > self.content_length:
            raise ValueError(f"write beyond content: {end} > {self.content_length}")
        if self._specs is not None:
            self._write_segments(offset, end, data)
            # manifest mode: enqueue every named range this span touches
            # (a piece straddling a shard boundary can complete two)
            for s, e, idx in self._spec_order:
                if e <= offset:
                    continue
                if s >= end:
                    break
                self._maybe_enqueue(idx)
            return
        self._host_np[offset:end] = np.frombuffer(data, dtype=np.uint8)
        self._coverage.add(offset, end)
        _hbm_bytes.inc(len(data))
        _hbm_done.set(self.done_fraction())
        first = offset // self.shard_bytes
        last = (end - 1) // self.shard_bytes
        for shard in range(first, min(last + 1, self.n_shards)):
            self._maybe_enqueue(shard)

    def _write_segments(self, offset: int, end: int, data) -> None:
        """Manifest mode: stage the parts of ``[offset, end)`` that fall
        inside a staged segment; the rest (manifest gaps, shards outside
        the sink's specs) is skipped."""
        src = np.frombuffer(data, dtype=np.uint8)
        staged = 0
        i = max(bisect.bisect_right(self._seg_starts, offset) - 1, 0)
        for seg_start, seg_end, base in self._segments[i:]:
            if seg_start >= end:
                break
            lo, hi = max(offset, seg_start), min(end, seg_end)
            if lo >= hi:
                continue
            self._host_np[base + lo - seg_start:base + hi - seg_start] = \
                src[lo - offset:hi - offset]
            self._coverage.add(lo, hi)
            staged += hi - lo
        if staged:
            _hbm_bytes.inc(staged)
            _hbm_done.set(self.done_fraction())

    def _host_view(self, shard: int) -> torch.Tensor:
        """The staging bytes of one shard (manifest mode: inside its
        segment)."""
        s, e = self._shard_range(shard)
        if self._specs is not None:
            i = bisect.bisect_right(self._seg_starts, s) - 1
            seg_start, _seg_end, base = self._segments[i]
            s, e = base + s - seg_start, base + e - seg_start
        return self.host[s:e]

    def _shard_range(self, shard: int) -> tuple[int, int]:
        if self._specs is not None:
            _name, s, size, _dt, _shape = self._specs[shard]
            return s, s + size
        return shard * self.shard_bytes, (shard + 1) * self.shard_bytes

    def _maybe_enqueue(self, shard: int) -> None:
        s, e = self._shard_range(shard)
        with self._lock:
            if self._shard_queued[shard] or self._closed:
                return
            if not self._coverage.covers(s, min(e, self.content_length)):
                return
            self._shard_queued[shard] = True
            self._pending += 1
            # delta, not set(): several sinks share the process gauge
            _hbm_queue.inc()
            self._idle.clear()
            # put stays under the lock: outside it, a concurrent close()
            # could slip its sentinel in first and strand this shard
            self._queue.put(shard)

    def flush(self) -> None:
        """Enqueue any fully-covered shard whose copy hasn't fired — in
        practice the padding-only tail shards no write ever touches.
        Non-blocking; shards with missing bytes are left unsent (result()
        names them)."""
        for shard in range(self.n_shards):
            self._maybe_enqueue(shard)

    # ------------------------------------------------------------------
    # worker thread — owns every host-to-device copy
    # ------------------------------------------------------------------

    def _copy(self, view: torch.Tensor, device: torch.device):
        """One shard's copy; returns (device tensor, completion event).
        The caller ends the span at the event, not at dispatch."""
        if device.type != "cuda":
            return view.clone(), None
        stream = self._streams.get(device)
        if stream is None:
            torch.cuda.set_device(device)
            stream = self._streams[device] = torch.cuda.Stream(device)
        with torch.cuda.stream(stream):
            dst = torch.empty(view.numel(), dtype=torch.uint8, device=device)
            dst.copy_(view, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return dst, event

    def _transfer_loop(self) -> None:
        while True:
            shard = self._queue.get()
            if shard is None:            # shutdown sentinel
                return
            try:
                if self._specs is not None:
                    name, _s, _size, sdtype, shape = self._specs[shard]
                    device = self.devices[shard % len(self.devices)]
                else:
                    name, sdtype, shape = None, self.dtype, None
                    device = self.devices[shard // self.shards_per_device]
                view = self._host_view(shard)
                t0 = time.monotonic()
                if self._device_put is not None:
                    raw, event = self._device_put(view, device), None
                else:
                    raw, event = self._copy(view, device)
                if event is not None:
                    # span ends at copy COMPLETION, not dispatch: the copy
                    # returned before the DMA landed
                    event.synchronize()
                t1 = time.monotonic()
                arr = raw.view(sdtype)
                if shape is not None:
                    arr = arr.reshape(shape)
                with self._lock:
                    self._shard_arrays[shard] = arr
                    self._shard_events[shard] = event
                    self._shard_sent[shard] = True
                    self.transfer_spans.append((t0, t1))
                _hbm_transfer_s.observe(t1 - t0)
                _hbm_transfers.labels("ok").inc()
                if name is not None and self.on_shard_ready is not None:
                    try:
                        self.on_shard_ready(name, t1)
                    except Exception:  # noqa: BLE001 - observer only
                        log.exception("on_shard_ready(%s) raised", name)
                log.debug("shard %d/%d -> %s", shard, self.n_shards, device)
            except BaseException as exc:  # noqa: BLE001 - surfaced by result()
                with self._lock:
                    if self._error is None:
                        self._error = exc
                _hbm_transfers.labels("fail").inc()
                log.exception("device transfer of shard %d failed", shard)
            finally:
                with self._lock:
                    self._pending -= 1
                    _hbm_queue.dec()
                    if self._pending == 0:
                        self._idle.set()
                    # self-terminate once every shard has shipped: a sink
                    # nobody collects must not leak this thread and the
                    # file-sized staging buffer
                    if all(self._shard_sent):
                        self._closed = True
                        return

    # ------------------------------------------------------------------
    # consumer side
    # ------------------------------------------------------------------

    def done_fraction(self) -> float:
        """Covered share of the staged bytes."""
        return self._coverage.covered_bytes() / self.staged_length

    def drain(self, timeout: float | None = None) -> None:
        """Block the CALLING thread (use ``asyncio.to_thread`` from async
        code) until every enqueued copy has completed. Raises the first
        copy error, if any."""
        if not self._idle.wait(timeout):
            raise TimeoutError("device transfers still in flight")
        with self._lock:
            if self._error is not None:
                raise RuntimeError("device transfer failed") from self._error

    def close(self) -> None:
        """Stop the worker thread. Idempotent; safe mid-stream (pending
        copies finish first — the sentinel queues behind them)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)

    def result(self, timeout: float | None = None):
        """Flush + drain, then return the device-resident data.

        Blocking — call via ``asyncio.to_thread`` from the event loop. With
        ``shard_specs``: a ``{name: tensor}`` dict in manifest order.
        Otherwise a list of per-device tensors; with a ``sharding`` the list
        is in mesh order, each tensor of ``padded_length // n_shards //
        itemsize`` elements (one torch process has no global array to
        assemble them into).
        """
        try:
            self.flush()
            self.drain(timeout)
            with self._lock:
                sent = list(self._shard_sent)
                arrays = list(self._shard_arrays)
                events = list(self._shard_events)
            if not all(sent):
                missing = [self._specs[i][0] if self._specs is not None
                           else i for i, s in enumerate(sent) if not s]
                raise RuntimeError(f"shards incomplete: {missing}")
        finally:
            # stop the worker on EVERY exit — a raising result() must not
            # leave the thread parked on queue.get holding the host buffer
            self.close()
        for a, event in zip(arrays, events):
            if event is not None:
                stream = torch.cuda.current_stream(a.device)
                stream.wait_event(event)
                a.record_stream(stream)
        if self._specs is not None:
            return {sp[0]: arrays[i] for i, sp in enumerate(self._specs)}
        return arrays


_PIN_LOCK = threading.Lock()


def _pinned_handed_out() -> int:
    """Bytes of pinned host blocks torch's host allocator has ever handed
    out. Unlike the bytes checked out now, this only grows: the same
    allocation call may take back blocks whose copies have finished (a
    1-byte ``Tensor.item()`` buffer, say), which would skew a difference
    of the current count, as it did by one byte on the H100 host."""
    return int(torch.cuda.host_memory_stats().get(
        "active_bytes.allocated", 0))


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``: streams and events need an index."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
