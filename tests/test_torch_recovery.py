"""The reference's ``tests/test_recovery_chaos.py`` scenarios on the port:
a scheduler restarted over its state store keeps its quarantine verdicts,
rebuilds its holder view from the daemons' re-announces and serves a
fresh leecher with no origin; a snapshot torn while the scheduler is down
is refused whole and the restart boots cold and serves. Plus the
handoff through the manager: a stopped scheduler parks its quarantine
and affinity summary, and its successor imports it capped at
``suspect``, with a ``recovery`` row of source ``handoff``.
"""

import asyncio
import os

from dragonfly2_tpu_torch.daemon.config import DaemonConfig, StorageSection
from dragonfly2_tpu_torch.daemon.config import SchedulerConfig as DaemonSched
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.idl.messages import DownloadRequest
from dragonfly2_tpu_torch.manager.server import Manager, ManagerConfig
from dragonfly2_tpu_torch.scheduler.config import (SchedulerConfig,
                                                   SeedPeerAddr)
from dragonfly2_tpu_torch.scheduler.quarantine import (HEALTHY, QUARANTINED,
                                                       SUSPECT)
from dragonfly2_tpu_torch.scheduler.server import Scheduler

from torch_origin import Origin

LIMIT_S = 90.0


def _cfg(tmp_path, name, sched_addr=None, **kw) -> DaemonConfig:
    c = DaemonConfig(
        workdir=str(tmp_path / name), hostname=name, listen_ip="127.0.0.1",
        host_ip="127.0.0.1", device="cpu",
        storage=StorageSection(gc_interval_s=3600),
        scheduler=DaemonSched(addresses=[sched_addr] if sched_addr else []),
        **kw)
    c.probe_enabled = False
    return c


def _fast_leecher(tmp_path, name, sched_addr) -> DaemonConfig:
    """Sub-second announce and register-refresh cadence, so the
    epoch-change reconcile fires within test timescales."""
    cfg = _cfg(tmp_path, name, sched_addr)
    cfg.announce_interval_s = 0.2
    cfg.scheduler.refresh_interval_s = 0.2
    return cfg


def _sched_cfg(tmp_path, seed, *, port: int = 0) -> SchedulerConfig:
    return SchedulerConfig(
        listen_ip="127.0.0.1", port=port,
        seed_peers=[SeedPeerAddr(host_id=seed.host_info().id,
                                 ip="127.0.0.1", rpc_port=seed.rpc.port,
                                 download_port=seed.upload_server.port)],
        statestore_dir=str(tmp_path / "sched-state"),
        statestore_interval_s=0.1,
        statestore_handoff=False)


def _recovery_sources(sched) -> list[str]:
    return [row.get("source") for row in sched.ledger._ring
            if row.get("decision_kind") == "recovery"]


async def _pull(d: Daemon, url: str, out: str, *,
                disable_back_source: bool = True):
    result = None
    async for resp in d.ptm.start_file_task(DownloadRequest(
            url=url, output=out, disable_back_source=disable_back_source,
            timeout_s=60.0)):
        if resp.done:
            result = resp
    return result


def test_scheduler_crash_recovers_quarantine_and_serves_without_origin(
        tmp_path):
    data = os.urandom(10 * 1024 * 1024 + 777)

    async def go(origin):
        url = f"{origin.base}/m.bin"
        seed = Daemon(_cfg(tmp_path, "seed", is_seed=True))
        await seed.start()
        sched = Scheduler(_sched_cfg(tmp_path, seed))
        await sched.start()
        l1 = Daemon(_fast_leecher(tmp_path, "l1", sched.address))
        lp = Daemon(_fast_leecher(tmp_path, "lp", sched.address))
        await l1.start()
        await lp.start()
        sched2 = l2 = None
        try:
            r1 = await _pull(l1, url, str(tmp_path / "l1.out"))
            rp = await _pull(lp, url, str(tmp_path / "lp.out"))
            assert r1 is not None and rp is not None
            assert (tmp_path / "l1.out").read_bytes() == data
            assert (tmp_path / "lp.out").read_bytes() == data
            task_id = r1.task_id
            lp_host = lp.upload_server.host_id
            assert lp_host == "lp-127.0.0.1"

            # the poisoner earns pod-wide quarantine before the crash
            reg = sched.quarantine
            for rep in ("l1-127.0.0.1", "seed-127.0.0.1"):
                for _ in range(2):
                    reg.record_corrupt(lp_host, task_id=task_id,
                                       reporter=rep)
            assert reg.state(lp_host) == QUARANTINED

            port = sched.port
            await sched.stop()
            sched2 = Scheduler(_sched_cfg(tmp_path, seed, port=port))
            await sched2.start()

            prov = sched2.statestore.provenance
            assert prov["recovered"] is True
            assert prov["components"]["quarantine"]["restored"] >= 1
            assert "snapshot" in _recovery_sources(sched2)
            assert sched2.quarantine.state(lp_host) == QUARANTINED
            assert not sched2.quarantine.offerable(lp_host, "any-child")

            def holders() -> int:
                t = sched2.resource.tasks.get(task_id)
                if t is None:
                    return 0
                return sum(1 for p in t.peers.values()
                           if p.finished_pieces or p.is_done())

            loop = asyncio.get_running_loop()
            deadline = loop.time() + 10.0
            while loop.time() < deadline and holders() < 1:
                await asyncio.sleep(0.1)
            assert holders() >= 1, "no re-announced holder within 10s"
            assert "reannounce" in _recovery_sources(sched2)

            origin.__exit__(None, None, None)      # the origin dies
            l2 = Daemon(_fast_leecher(tmp_path, "l2", sched2.address))
            await l2.start()
            r2 = await _pull(l2, url, str(tmp_path / "l2.out"))
            assert r2 is not None
            assert (tmp_path / "l2.out").read_bytes() == data
            c = l2.ptm.conductor(task_id)
            assert c.state == c.SUCCESS
            assert c.traffic_source == 0
            assert c.traffic_p2p == len(data)
            for row in sched2.ledger._ring:
                for chosen in (row.get("chosen") or []):
                    assert lp_host not in str(chosen), row
        finally:
            if l2 is not None:
                await l2.stop()
            if sched2 is not None:
                await sched2.stop()
            await lp.stop()
            await l1.stop()
            await seed.stop()

    origin = Origin({"m.bin": data}).__enter__()
    try:
        asyncio.run(asyncio.wait_for(go(origin), LIMIT_S))
    finally:
        if origin._thread.is_alive():
            origin.__exit__(None, None, None)


def test_torn_snapshot_refused_wholesale_and_boot_degrades_to_cold(
        tmp_path):
    data = os.urandom(5 * 1024 * 1024 + 99)

    async def go(url):
        seed = Daemon(_cfg(tmp_path, "seed", is_seed=True))
        await seed.start()
        sched = Scheduler(_sched_cfg(tmp_path, seed))
        await sched.start()
        sched2 = l1 = None
        try:
            sched.quarantine.record_corrupt("ghost-host", task_id="t" * 64,
                                            reporter="rep-a")
            port = sched.port
            await sched.stop()
            path = tmp_path / "sched-state" / "scheduler_state.json"
            raw = path.read_bytes()
            assert len(raw) > 2
            path.write_bytes(raw[: len(raw) // 2])

            sched2 = Scheduler(_sched_cfg(tmp_path, seed, port=port))
            await sched2.start()
            assert sched2.statestore.provenance == {"recovered": False}
            assert sched2.quarantine.state("ghost-host") == HEALTHY
            assert "snapshot" not in _recovery_sources(sched2)

            l1 = Daemon(_fast_leecher(tmp_path, "l1", sched2.address))
            await l1.start()
            r = await _pull(l1, url, str(tmp_path / "l1.out"),
                            disable_back_source=False)
            assert r is not None
            assert (tmp_path / "l1.out").read_bytes() == data
            c = l1.ptm.conductor(r.task_id)
            assert c.state == c.SUCCESS
        finally:
            if l1 is not None:
                await l1.stop()
            if sched2 is not None:
                await sched2.stop()
            await seed.stop()

    with Origin({"m.bin": data}) as origin:
        asyncio.run(asyncio.wait_for(go(f"{origin.base}/m.bin"), LIMIT_S))


def test_a_stopped_schedulers_summary_warms_its_successor(tmp_path):
    """The manager relays the handoff: S1's stop parks its summary, S2's
    attach imports it; the anti-slander cap holds (suspect, never
    quarantined, from second-hand evidence)."""
    async def go():
        mgr = Manager(ManagerConfig(listen_ip="127.0.0.1",
                                    db_path=str(tmp_path / "m.db")))
        await mgr.start()
        addr = [mgr.address]
        s1 = s2 = None
        try:
            s1 = Scheduler(SchedulerConfig(
                listen_ip="127.0.0.1", manager_addresses=addr,
                statestore_dir=str(tmp_path / "s1")))
            await s1.start()
            for r in ("r1", "r2", "r3", "r4"):
                s1.quarantine.record_corrupt("poisoner", reporter=r)
            assert s1.quarantine.state("poisoner") == QUARANTINED
            await s1.stop()
            s1 = None
            row = mgr.store.latest_scheduler_state(cluster_id=1)
            assert row is not None and row["blob"] and row["signature"] == ""
            s2 = Scheduler(SchedulerConfig(
                listen_ip="127.0.0.1", manager_addresses=addr,
                statestore_dir=str(tmp_path / "s2")))
            await s2.start()
            assert s2.quarantine.state("poisoner") == SUSPECT
            rows = [r for r in s2.ledger._ring
                    if r.get("decision_kind") == "recovery"]
            assert [r["source"] for r in rows] == ["handoff"]
            assert rows[0]["entries_imported"] == 1
        finally:
            for s in (s1, s2):
                if s is not None:
                    await s.stop()
            await mgr.stop()
    asyncio.run(asyncio.wait_for(go(), LIMIT_S))
