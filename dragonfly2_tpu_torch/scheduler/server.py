"""Scheduler bootstrap: wire resource, scheduling, seed client, GC, RPC.

Counterpart of ``dragonfly2_tpu/scheduler/server.py`` (reference
``scheduler/scheduler.go`` ``New``/``Serve``) for a standalone scheduler
with a static seed-peer list: the decision ledger always observes the
rulings; download records are kept when ``records_dir`` or
``trainer_address`` is set, and the announcer uploads them to the trainer.
No manager, quarantine, federation, shard affinity, state store or fleet
pulse.
"""

from __future__ import annotations

import asyncio
import logging
import random

from ..rpc.server import RPCServer
from .announcer import SchedulerAnnouncer
from .config import PEER_GC_INTERVAL_S, SchedulerConfig
from .decision_ledger import DecisionLedger
from .evaluator import make_evaluator
from .records import DownloadRecords
from .resource import Resource
from .scheduling import Scheduling
from .seed_client import SeedPeerClient
from .service import SchedulerService, build_service
from .topology_store import TopologyStore

log = logging.getLogger("df.sched.server")


class Scheduler:
    def __init__(self, cfg: SchedulerConfig, *,
                 rng: random.Random | None = None, records=None):
        self.cfg = cfg
        self.resource = Resource()
        self.topo = TopologyStore()
        self.scheduling = Scheduling(make_evaluator(cfg.algorithm), rng=rng)
        self.seed_client = SeedPeerClient(self.resource, cfg.seed_peers)
        if records is None and (cfg.records_dir or cfg.trainer_address):
            records = DownloadRecords(cfg.records_dir)
        # decision ledger: every find/refresh ruling explained, with
        # kind=decision rows into records (when kept) for the outcome join
        self.ledger = DecisionLedger(records=records)
        self.scheduling.decision_sink = self.ledger.on_decision
        self.service = SchedulerService(self.resource, self.scheduling,
                                        self.seed_client, records=records)
        self.announcer = SchedulerAnnouncer(self)
        self.rpc: RPCServer | None = None
        self.port: int | None = None
        self._gc: asyncio.Task | None = None

    @property
    def address(self) -> str:
        return f"{self.cfg.advertise_ip}:{self.port}"

    async def start(self) -> None:
        self.rpc = RPCServer(f"{self.cfg.listen_ip}:{self.cfg.port}")
        self.rpc.register(build_service(self.service))
        await self.rpc.start()
        self.port = self.rpc.port
        self._gc = asyncio.get_running_loop().create_task(self._gc_loop())
        self.announcer.start()
        log.info("scheduler up on %s (algorithm=%s, seeds=%d)", self.address,
                 self.cfg.algorithm, len(self.seed_client.seed_peers))

    async def _gc_loop(self) -> None:
        while True:
            await asyncio.sleep(PEER_GC_INTERVAL_S)
            try:
                n = self.resource.gc()
            except Exception:  # noqa: BLE001 - the sweeper must survive
                log.exception("resource gc failed")
                continue
            if n:
                log.debug("resource gc evicted %d", n)

    async def stop(self) -> None:
        await self.announcer.stop()
        if self._gc is not None:
            self._gc.cancel()
            await asyncio.gather(self._gc, return_exceptions=True)
        for t in list(self.service._seed_tasks):
            t.cancel()
        await asyncio.gather(*self.service._seed_tasks,
                             return_exceptions=True)
        await self.seed_client.close()
        if self.rpc is not None:
            await self.rpc.stop(0.5)
        if self.service.records is not None:
            await self.service.records.aclose()
