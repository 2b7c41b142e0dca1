"""The download flight recorder through the port, against the reference.

* The reference's ``TestFlightRecorder`` cases
  (``tests/test_observability.py``): the summary's attribution, the
  compact summary's parent cap, the event ring bound, the recorder's task
  ring and its off switch.
* The reference's first two ``TestFlightHTTP`` cases: a real multi-piece
  back-source pull (from a standard-library HTTP origin) leaves a flight
  that ``GET /debug/flight`` and ``/debug/flight/<task_id>`` (a prefix
  resolves) serve from the port's upload server, and a disabled recorder
  records nothing. Their ``dfdiag`` renderings wait for the tool's port.
* Parity: one event sequence (every stage, serves, shards, placements,
  failures) gives ``summarize()`` and ``compact_summary()`` dicts equal to
  the reference's, the health plane's ``slo_*`` annotation included; a
  ``PeerResult`` carrying the compact summary has the reference's bytes.
* The sharded path journals as the reference does: three subset pulls of
  one file on one daemon give each flight the same ``shard_ready`` and
  ``placed`` events (stage, piece or source class, parent or shard name,
  bytes) in both packages.

Tolerances are exact. Every test runs under ``asyncio.wait_for``.
"""

import asyncio
import json

import numpy as np
import pytest

from dragonfly2_tpu import source as ref_source
from dragonfly2_tpu.daemon import config as ref_dconfig
from dragonfly2_tpu.daemon import flight_recorder as ref_fr
from dragonfly2_tpu.daemon.daemon import Daemon as RefDaemon
from dragonfly2_tpu.idl import base as ref_base
import dragonfly2_tpu.idl.messages as ref_msg
from dragonfly2_tpu.source.file_client import (
    FileSourceClient as RefFileSourceClient)
from dragonfly2_tpu_torch import source as port_source
from dragonfly2_tpu_torch.daemon import flight_recorder as fr
from dragonfly2_tpu_torch.daemon.config import (DaemonConfig, DownloadConfig,
                                               FlightConfig)
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.daemon.flight_recorder import (FlightRecorder,
                                                         TaskFlight)
from dragonfly2_tpu_torch.idl import base as port_base
import dragonfly2_tpu_torch.idl.messages as port_msg
from dragonfly2_tpu_torch.source.file_client import FileSourceClient
from test_torch_sharded import (SUBSET_MANIFEST, _counting, _subset_origin,
                                mk)
from torch_origin import Origin

LIMIT_S = 30.0
MiB = 1 << 20


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def synthetic_flight(mod, *, max_events: int = 4096):
    """The reference's deterministic flight: events injected straight into
    the ring. Piece 0: fast p2p; piece 1: slow wire from a straggler;
    piece 2: back-source."""
    f = mod.TaskFlight("t" * 64, "peer-x", max_events=max_events)
    rows = [
        (0.0, mod.REGISTERED, -1, "", 0, 0.0),
        (1.0, mod.SCHEDULED, 0, "parentA", 0, 0.0),
        (2.0, mod.DISPATCHED, 0, "parentA", 0, 0.0),
        (5.0, mod.FIRST_BYTE, 0, "parentA", 0, 0.0),
        (15.0, mod.WIRE_DONE, 0, "parentA", 4 << 20, 13.0),
        (16.0, mod.HBM_DONE, 0, "", 4 << 20, 0.0),
        (1.0, mod.SCHEDULED, 1, "parentB", 0, 0.0),
        (3.0, mod.DISPATCHED, 1, "parentB", 0, 0.0),
        (10.0, mod.FIRST_BYTE, 1, "parentB", 0, 0.0),
        (210.0, mod.WIRE_DONE, 1, "parentB", 4 << 20, 207.0),
        (212.0, mod.HBM_DONE, 1, "", 4 << 20, 0.0),
        (260.0, mod.WIRE_DONE, 2, "", 2 << 20, 40.0),
        (261.0, mod.HBM_SHARD, 0, "", 0, 6.0),
    ]
    for row in rows:
        f.events.append(row)
    f.state = "success"
    return f


class TestFlightRecorder:
    def test_summary_attribution(self):
        s = synthetic_flight(fr).summarize()
        assert s["pieces"] == 3
        assert s["bytes_p2p"] == 8 << 20
        assert s["bytes_source"] == 2 << 20
        rows = {r["piece"]: r for r in s["piece_rows"]}
        assert rows[0]["queue_ms"] == 1.0
        assert rows[0]["ttfb_ms"] == 3.0
        assert rows[0]["wire_ms"] == 10.0
        assert rows[0]["hbm_ms"] == 1.0
        slow = s["slowest_piece"]
        assert slow["piece"] == 1
        assert slow["dominant_stage"] == "wire"
        assert slow["parent"] == "parentB"
        assert rows[2]["wire_ms"] == 40.0
        assert rows[2]["source"] == "origin"
        assert s["back_to_source_ratio"] == pytest.approx(0.2)
        assert s["hbm_dma_ms"] == 6.0
        pp = s["per_parent"]
        assert pp["parentA"]["throughput_bps"] > \
            pp["parentB"]["throughput_bps"]

    def test_compact_summary_caps_parents(self):
        f = TaskFlight("t" * 64, "p")
        for i in range(20):
            f.events.append((float(i), fr.WIRE_DONE, i, f"par{i:02d}",
                             1024, 1.0))
        c = f.compact_summary(max_parents=8)
        assert len(c["per_parent"]) == 8
        assert "piece_rows" not in c

    def test_event_ring_bounded(self):
        f = TaskFlight("t" * 64, "p", max_events=16)
        for i in range(1000):
            f.event(fr.WIRE_DONE, i, "a", 1)
        assert len(f.events) == 16
        assert f.events[-1][2] == 999

    def test_recorder_task_ring_and_disable(self):
        rec = FlightRecorder(max_tasks=4)
        for i in range(10):
            rec.begin(f"task-{i}", "p")
        assert len(rec.index()) == 4
        assert rec.get("task-9") is not None
        assert rec.get("task-0") is None
        off = FlightRecorder(enabled=False)
        assert off.begin("t", "p") is None
        assert off.index() == []


async def get_json(port: int, path: str) -> tuple[int, dict]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
        head = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1")
        status = int(head.split(" ")[1])
        length = int(head.lower().split("content-length:")[1]
                     .split("\r\n")[0])
        return status, json.loads(await reader.readexactly(length))
    finally:
        writer.close()


def _daemon(tmp_path, name: str, **kw) -> Daemon:
    return Daemon(DaemonConfig(workdir=str(tmp_path / name), hostname=name,
                               listen_ip="127.0.0.1", host_ip="127.0.0.1",
                               device="cpu", **kw))


class TestFlightHTTP:
    def test_debug_flight_endpoint_on_upload_server(self, tmp_path):
        """A real multi-piece back-source pull leaves a queryable flight
        with a summary on /debug/flight/<task_id>."""
        data = np.random.default_rng(3).integers(
            0, 256, (10 << 20) + 777, dtype=np.uint8).tobytes()   # 3 pieces

        async def go(url: str):
            daemon = _daemon(tmp_path, "flt")
            await daemon.start()
            try:
                async for _ in daemon.ptm.start_file_task(
                        port_msg.DownloadRequest(url=url, timeout_s=LIMIT_S,
                                                 output=str(tmp_path / "o"))):
                    pass
                task_id = next(iter(daemon.ptm._conductors))
                port = daemon.upload_server.port
                status, idx = await get_json(port, "/debug/flight")
                assert status == 200 and idx["enabled"]
                assert any(t["task_id"] == task_id for t in idx["tasks"])
                # a task-id prefix resolves like a full id
                status, flight = await get_json(
                    port, f"/debug/flight/{task_id[:16]}")
                assert status == 200
                status, _ = await get_json(port, "/debug/flight/nope-nope")
                assert status == 404
                status, summary = await get_json(
                    port, f"/debug/flight/{task_id}?summary=1")
                assert status == 200 and summary == flight["summary"]
                assert flight["state"] == "success"
                summary = flight["summary"]
                assert summary["pieces"] == 3
                assert summary["bytes_source"] == len(data)
                assert summary["back_to_source_ratio"] == 1.0
                assert summary["rungs"] == ["back_source"]
            finally:
                await daemon.stop()

        with Origin({"f.bin": data}) as o:
            run(go(f"{o.base}/f.bin"))

    def test_disabled_recorder_records_nothing(self, tmp_path):
        data = np.random.default_rng(4).integers(
            0, 256, 300_000, dtype=np.uint8).tobytes()

        async def go(url: str):
            daemon = _daemon(tmp_path, "noflt",
                             flight=FlightConfig(enabled=False))
            await daemon.start()
            try:
                async for _ in daemon.ptm.start_file_task(
                        port_msg.DownloadRequest(url=url, timeout_s=LIMIT_S,
                                                 output=str(tmp_path / "o"))):
                    pass
                conductor = next(iter(daemon.ptm._conductors.values()))
                assert conductor.flight is None
                assert daemon.flight_recorder.index() == []
            finally:
                await daemon.stop()

        with Origin({"x.bin": data}) as o:
            run(go(f"{o.base}/x.bin"))


def _full_flight(mod):
    """Every kind of event and serve row, in one order, on a fixed
    clock."""
    f = synthetic_flight(mod)
    f.started_at = 1.7e9
    f.shards_total = 3
    f.report_drops = 2
    f.qos_class, f.tenant = "standard", "t1"
    rows = [
        (20.0, mod.CORRUPT, 1, "parentB", 4 << 20, 0.0),
        (21.0, mod.STALL, 1, "parentB", 0, 0.0),
        (22.0, mod.TIMEOUT, 0, "parentC", 0, 0.0),
        (23.0, mod.REFUSED, 0, "parentC", 0, 0.0),
        (24.0, mod.QUARANTINE, 1, "10.0.0.2:1", 0, 0.0),
        (30.0, mod.PLACED, 3, "cas", 1 << 20, 0.0),
        (31.0, mod.PLACED, 4, "cas", 1 << 20, 0.0),
        (40.0, mod.SHARD_READY, mod.SHARD_SRC_TREE, "embed", 5 << 20, 0.0),
        (41.0, mod.SHARD_READY, mod.SHARD_SRC_SWAP, "w1", 3 << 20, 0.0),
        (42.0, mod.SHARD_FALLBACK, 2, "seed", 0, 0.0),
        (50.0, mod.RUNG, -1, mod.RUNG_P2P, 0, 0.0),
        (51.0, mod.RUNG, -1, mod.RUNG_RESCHEDULE, 0, 0.0),
        (52.0, mod.RUNG, -1, mod.RUNG_RESCHEDULE, 0, 0.0),
        (53.0, mod.RUNG, -1, mod.RUNG_P2P, 0, 0.0),
        (300.0, mod.DONE, -1, "", 0, 0.0),
    ]
    for row in rows:
        f.events.append(row)
    for i in range(12):
        f.serves.append((float(i), f"child{i % 5}", f"10.0.0.{i % 5}", i,
                         (i + 1) * 1000, 2.5 * (i + 1), 0.5 * i,
                         1 + i % 2, bool(i % 3)))
    return f


def test_summaries_match_reference():
    ref, port = _full_flight(ref_fr), _full_flight(fr)
    want = ref.summarize()
    assert "slo_breaches" in want and want["slo_budgets_ms"]
    assert port.summarize() == want
    want_c = ref.compact_summary(max_parents=3)
    got_c = port.compact_summary(max_parents=3)
    assert got_c == want_c
    assert list(got_c) == list(want_c)     # key order: the wire bytes
    assert port.timeline() == ref.timeline()
    # the PeerResult that carries it: the reference's bytes
    fields = dict(task_id="t" * 64, peer_id="peer-x", url="http://o/x",
                  success=True, traffic=10 << 20, cost_ms=300, code=0,
                  total_piece_count=3, content_length=10 << 20)
    assert port_base.dumps(port_msg.PeerResult(
        **fields, flight_summary=got_c)) == ref_base.dumps(
        ref_msg.PeerResult(**fields, flight_summary=want_c))


def _journal(flight) -> list[tuple]:
    return [(stage, piece, parent, nbytes)
            for _t, stage, piece, parent, nbytes, _d in flight.events
            if stage in ("shard_ready", "placed")]


async def _flights(daemon, msg, url: str) -> list[list[tuple]]:
    manifest = msg.ShardManifest(
        shards=[mk(msg, *s) for s in SUBSET_MANIFEST])
    out = []
    for names in ("s1", "s2", "s0"):
        frames = [r async for r in daemon.ptm.start_file_task(
            msg.DownloadRequest(url=url, url_meta=msg.UrlMeta(shards=names),
                                shard_manifest=manifest, timeout_s=LIMIT_S))]
        c = daemon.ptm.conductor(frames[-1].task_id)
        assert c.flight.shards_total == len(names.split(","))
        out.append(_journal(c.flight))
    return out


def test_sharded_pulls_journal_like_the_reference(tmp_path):
    url, _data = _subset_origin(tmp_path)

    async def port_flights():
        previous = port_source.client_for("file://")
        port_source.register_client("file", _counting(FileSourceClient))
        d = Daemon(DaemonConfig(workdir=str(tmp_path / "port"),
                                hostname="port", device="cpu",
                                download=DownloadConfig(
                                    back_source_group_min_bytes=MiB)))
        await d.start()
        try:
            return await _flights(d, port_msg, url)
        finally:
            await d.stop()
            port_source.register_client("file", previous)

    async def ref_flights():
        previous = ref_source.client_for("file://")
        ref_source.register_client("file", _counting(RefFileSourceClient))
        d = RefDaemon(ref_dconfig.DaemonConfig(
            workdir=str(tmp_path / "ref"), host_ip="127.0.0.1",
            hostname="ref",
            storage=ref_dconfig.StorageSection(gc_interval_s=3600),
            download=ref_dconfig.DownloadConfig(
                back_source_group_min_bytes=MiB)))
        await d.start()
        try:
            return await _flights(d, ref_msg, url)
        finally:
            await d.stop()
            ref_source.register_client("file", previous)

    got = run(port_flights())
    want = run(ref_flights())
    assert got == want
    # s1 readies alone; s2 too; s0 places piece 1 from the warm partial
    assert got[0] == [("shard_ready", 0, "s1", 2 * MiB)]
    assert ("placed", 1, "cas", 4 * MiB) in got[2]
    assert ("shard_ready", 0, "s0", 5 * MiB) in got[2]
