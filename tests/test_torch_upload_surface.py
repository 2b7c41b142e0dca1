"""The upload server's surface beside the piece GET.

- A serve is journaled only when its body went out whole. The port's
  server writes the body inside its own handler and journals the serve
  (flight edge row, content-store popularity) after the last write; a
  child that goes away mid-body leaves no journal row. The reference
  reaches the same rule through ``_Slot.ok`` and ``_Slot.on_release``,
  because aiohttp sends a body after the handler returns (ROADMAP known
  difference 75).
- ``GET /metrics`` serves the daemon's Prometheus exposition on the
  upload port, as the reference's does (ROADMAP Queue 3 entry 77).
"""

from __future__ import annotations

import asyncio
import socket
import struct
import urllib.request

import pytest

from dragonfly2_tpu_torch.daemon.upload_server import UploadServer
from dragonfly2_tpu_torch.storage.manager import StorageConfig, StorageManager
from dragonfly2_tpu_torch.storage.metadata import TaskMetadata

TASK = "j" * 64
SIZE = 32 << 20          # well over the socket buffers: the send blocks


def _server(tmp_path) -> tuple[UploadServer, list]:
    mgr = StorageManager(StorageConfig(data_dir=str(tmp_path / "data")))
    ts = mgr.register_task(TaskMetadata(
        task_id=TASK, url="http://o/j", content_length=SIZE,
        total_piece_count=1, piece_size=SIZE))
    ts.write_piece(0, 0, b"j" * SIZE)
    srv = UploadServer(mgr, host="127.0.0.1")
    journaled: list = []
    srv._journal = lambda task_id, *a, **k: journaled.append(task_id)
    return srv, journaled


def _request() -> bytes:
    return (f"GET /download/jjj/{TASK}?peerId=p HTTP/1.1\r\nHost: x\r\n"
            f"Range: bytes=0-{SIZE - 1}\r\nConnection: close\r\n\r\n"
            ).encode()


async def _idle(srv: UploadServer) -> None:
    for _ in range(500):
        if srv._active == 0:
            return
        await asyncio.sleep(0.01)
    raise AssertionError("the serve never released its slot")


@pytest.mark.parametrize("tls_chunks", [False, True],
                         ids=["sendfile", "read_branch"])
def test_an_aborted_transmit_never_journals(tmp_path, tls_chunks):
    async def go():
        srv, journaled = _server(tmp_path)
        if tls_chunks:
            # the read-and-write branch: a task of unknown length
            srv.storage_mgr.get(TASK).md.content_length = -1
        await srv.start()
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           srv.port)
            writer.write(_request())
            await writer.drain()
            assert (await reader.readline()).startswith(b"HTTP/1.1 206")
            # reset the connection mid-body (SO_LINGER 0 sends an RST)
            sock = writer.get_extra_info("socket")
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                            struct.pack("ii", 1, 0))
            writer.transport.abort()
            await _idle(srv)
            assert journaled == []
            # a whole body journals its serve once
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           srv.port)
            writer.write(_request())
            await writer.drain()
            raw = await reader.read()
            writer.close()
            assert raw.endswith(b"j" * 1024)
            assert len(raw.partition(b"\r\n\r\n")[2]) == SIZE
            await _idle(srv)
            assert journaled == [TASK]
        finally:
            await srv.stop()

    asyncio.run(go())


def _get(port: int, path: str) -> tuple[int, str, str]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.headers.get("Content-Type", ""), \
                r.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, "", ""


@pytest.mark.parametrize("impl", ["reference", "port"])
def test_metrics_are_served_on_the_upload_port(impl):
    if impl == "reference":
        from dragonfly2_tpu.common.metrics import REGISTRY
        from dragonfly2_tpu.daemon.upload_server import UploadServer as Srv
    else:
        from dragonfly2_tpu_torch.common.metrics import REGISTRY
        Srv = UploadServer
    REGISTRY.counter("df_upload_surface_probe_total", "test probe").inc()

    async def go():
        srv = Srv(None, host="127.0.0.1")
        await srv.start()
        try:
            return await asyncio.to_thread(_get, srv.port, "/metrics")
        finally:
            await srv.stop()

    status, ctype, body = asyncio.run(go())
    assert status == 200
    assert ctype.startswith("text/plain")
    assert "df_upload_surface_probe_total 1.0" in body
