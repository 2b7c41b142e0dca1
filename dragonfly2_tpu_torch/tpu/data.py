"""Training-loop data prefetch: shard URLs -> device tensors, overlapped.

Counterpart of ``dragonfly2_tpu/tpu/data.py``, unchanged in logic but for
one option of the port's, ``disable_back_source``. The
training process EMBEDS the daemon (the device tensors must land in the
training process's CUDA context, so the last hop cannot cross a process
boundary). The daemon's asyncio loop runs in a background thread; the
(synchronous) training thread iterates::

    # background thread: asyncio.run(daemon_main()) started the Daemon
    # and published (daemon, loop)
    pf = ShardPrefetcher(daemon, shard_urls, depth=2, loop=daemon_loop)
    for arrays in pf:                       # training thread
        params = train_step(params, decode(arrays))

    # from async code co-located with the daemon, use the async form:
    async for arrays in ShardPrefetcher(daemon, urls).astream(): ...

While step i consumes shard i, shards i+1..i+depth download and copy
into device memory on the device sink's worker thread. Each yielded item
is the shard's raw bytes as per-device uint8 tensors (the device sink's
result); decoding stays with the caller (WebDataset/TFRecord framing is
format-specific and cheap next to the transfer).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Iterable, Iterator

from ..idl.messages import DeviceSink, DownloadRequest, UrlMeta

log = logging.getLogger("df.tpu.data")


class ShardPrefetcher:
    """Iterate device-resident shards with ``depth`` fetches in flight.

    Sync-iterable by design: training loops are synchronous Python.
    The daemon's asyncio loop must run in another thread (the normal
    embedded-daemon arrangement: ``asyncio.run(daemon_main())`` in a
    background thread, training in the main thread); pass that loop as
    ``loop``. Failed shards raise at the consuming step unless
    ``skip_failed`` (then they are logged and skipped — dataset loaders
    routinely tolerate a missing shard).
    """

    def __init__(self, daemon, urls: Iterable[str], *, depth: int = 2,
                 loop: asyncio.AbstractEventLoop | None = None,
                 url_meta: UrlMeta | None = None,
                 dtype: str = "uint8",
                 skip_failed: bool = False,
                 delete_after: bool = True,
                 disable_back_source: bool = False):
        self.daemon = daemon
        self.urls = list(urls)
        self.depth = max(1, depth)
        self.loop = loop
        self.url_meta = url_meta
        self.dtype = dtype
        self.skip_failed = skip_failed
        # training data is streamed-through, not cached: drop each shard's
        # pieces once its device array is handed over, or a long epoch
        # accumulates the whole dataset on local disk
        self.delete_after = delete_after
        # the port's own option: a consumer whose shards must come from
        # peers (an object gateway's swarm) fails a shard rather than
        # read its origin
        self.disable_back_source = disable_back_source

    # -- async core ----------------------------------------------------

    SHARD_TIMEOUT_S = 600.0

    async def _ingest_from_storage(self, task_id: str):
        """Device leg for content already on disk: the task fast path
        (completed-task reuse, e.g. epoch >= 2 with ``delete_after=False``)
        returns no conductor/sink, so feed the stored pieces through a
        fresh DeviceIngest."""
        store = self.daemon.ptm.storage_mgr.find_completed_task(task_id)
        if store is None:
            return None
        factory = self.daemon.device_sink_builder(
            DeviceSink(enabled=True, dtype=self.dtype))
        ingest = factory(store.md.content_length)

        def feed():
            for p in store.piece_infos():
                ingest.write(p.start, store.read_piece(p.num))
            return ingest.result(timeout=self.SHARD_TIMEOUT_S)

        return await asyncio.to_thread(feed)

    async def _fetch(self, url: str):
        """One shard through the real daemon path; returns the device
        tensor(s) (the device sink's result)."""
        sink = DeviceSink(enabled=True, dtype=self.dtype)
        task_id = None
        try:
            async for resp in self.daemon.ptm.start_file_task(
                    DownloadRequest(url=url, url_meta=self.url_meta,
                                    device_sink=sink,
                                    disable_back_source=(
                                        self.disable_back_source),
                                    timeout_s=self.SHARD_TIMEOUT_S)):
                task_id = resp.task_id or task_id
            conductor = self.daemon.ptm.conductor(task_id) if task_id \
                else None
            ingest = conductor.device_ingest if conductor is not None \
                else None
            if ingest is not None:
                arrays = await asyncio.to_thread(
                    ingest.result, self.SHARD_TIMEOUT_S)
                # the sink is consumed (tensors may be updated in place by
                # the train step): a later epoch's reuse must rebuild from
                # storage, never re-read this one
                conductor.device_ingest = None
            else:
                arrays = await self._ingest_from_storage(task_id) \
                    if task_id else None
                if arrays is None:
                    raise RuntimeError(
                        f"shard {url}: no device ingest (wedged runtime, "
                        "or content length unknown)")
            return arrays
        finally:
            # streamed-through on EVERY path: a failed shard's partial
            # pieces must not accumulate either
            if self.delete_after and task_id is not None:
                await self.daemon.ptm.delete_task(task_id)

    async def astream(self):
        """Async iterator over device tensors, ``depth`` shards in flight,
        strictly in input order. Duplicate URLs (sampling with
        replacement) are serialized: concurrent fetches of one URL would
        share a conductor and harvest the same consumed (donated) sink."""
        pending: list[asyncio.Task] = []
        last_for_url: dict[str, asyncio.Task] = {}
        idx = 0

        def spawn(url: str) -> asyncio.Task:
            prev = last_for_url.get(url)

            async def run():
                if prev is not None and not prev.done():
                    await asyncio.wait({prev})
                return await self._fetch(url)

            t = asyncio.create_task(run())
            last_for_url[url] = t
            return t

        try:
            while pending or idx < len(self.urls):
                while idx < len(self.urls) and len(pending) < self.depth:
                    pending.append(spawn(self.urls[idx]))
                    idx += 1
                head = pending.pop(0)
                try:
                    yield await head
                except Exception:
                    if not self.skip_failed:
                        raise
                    log.warning("skipping failed shard", exc_info=True)
        finally:
            for t in pending:
                t.cancel()
            await asyncio.gather(*pending, return_exceptions=True)

    # -- sync facade for training loops --------------------------------

    def __iter__(self) -> Iterator:
        loop = self.loop
        if loop is None:
            raise RuntimeError(
                "sync iteration needs the daemon's event loop (pass "
                "loop=...); from async code use astream()")
        done = object()
        q: asyncio.Queue | None = None

        async def _pump() -> None:
            try:
                async for arrays in self.astream():
                    await q.put(arrays)
                await q.put(done)
            except asyncio.CancelledError:
                raise          # early consumer exit: unwind astream's finally
            except BaseException as exc:  # noqa: BLE001 - relayed to consumer
                # never BLOCK delivering the error (the full-queue await
                # deadlocked a cancelled pump): displacing the undelivered
                # item is fine — the error ends the iteration anyway
                while True:
                    try:
                        q.put_nowait(exc)
                        return
                    except asyncio.QueueFull:
                        try:
                            q.get_nowait()
                        except asyncio.QueueEmpty:
                            pass

        async def _start() -> "asyncio.Task":
            nonlocal q
            # queue created BEFORE the pump task exists: the consumer's
            # first q.get() must never race a not-yet-created queue
            q = asyncio.Queue(maxsize=1)
            return asyncio.get_running_loop().create_task(_pump())

        import concurrent.futures
        fut = asyncio.run_coroutine_threadsafe(_start(), loop)
        pump_task = fut.result(timeout=30)
        try:
            while True:
                get_fut = asyncio.run_coroutine_threadsafe(q.get(), loop)
                while True:
                    try:
                        # bounded waits on ONE outstanding future (a
                        # cancel-on-timeout could race an already-popped
                        # item into the void): if the daemon loop dies
                        # mid-iteration the training thread must error,
                        # not hang forever
                        item = get_fut.result(timeout=5.0)
                        break
                    except concurrent.futures.TimeoutError:
                        if loop.is_closed() or not loop.is_running():
                            raise RuntimeError(
                                "daemon event loop stopped during shard "
                                "iteration") from None
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            if not loop.is_closed():
                loop.call_soon_threadsafe(pump_task.cancel)
