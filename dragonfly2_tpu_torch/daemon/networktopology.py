"""Network-topology prober: measure RTTs to scheduler-chosen hosts.

Counterpart of ``dragonfly2_tpu/daemon/networktopology.py`` (reference
``client/daemon/networktopology/network_topology.go``): a ``SyncProbes``
bidi stream on which the scheduler hands out probe targets and the daemon
reports what it measured. The reference ICMP-pings; here, as in the JAX
package, the RTT is a TCP connect to the target's daemon port (no
raw-socket privilege needed, and it measures the path pieces take).
"""

from __future__ import annotations

import asyncio
import logging
import time

from ..idl.messages import Probe, SyncProbesRequest

log = logging.getLogger("df.flow.nettopo")

CONNECT_TIMEOUT_S = 2.0
# pause between stream dials, also after the scheduler closes cleanly
REDIAL_S = 20.0


async def tcp_rtt_us(ip: str, port: int) -> int | None:
    t0 = time.monotonic()
    try:
        _r, w = await asyncio.wait_for(
            asyncio.open_connection(ip, port), CONNECT_TIMEOUT_S)
    except (OSError, asyncio.TimeoutError):
        return None
    rtt = int((time.monotonic() - t0) * 1e6)
    w.close()
    try:
        await w.wait_closed()
    except OSError:
        pass
    return rtt


class NetworkTopologyProber:
    def __init__(self, daemon):
        self.daemon = daemon
        self.rounds = 0               # reports the scheduler took
        self._task: asyncio.Task | None = None

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._loop())

    async def _loop(self) -> None:
        while True:
            try:
                await self._probe_round()
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 - scheduler may be away
                log.debug("probe round failed: %s", exc)
            await asyncio.sleep(REDIAL_S)

    async def _probe_round(self) -> None:
        stream = await self.daemon.scheduler.sync_probes()
        try:
            interval_s = 20.0
            while True:
                # ask for targets
                await stream.write(SyncProbesRequest(
                    host=self.daemon.host_info()))
                resp = await stream.read()
                if resp is None:
                    return
                interval_s = resp.probe_interval_s or interval_s
                probes: list[Probe] = []
                failed: list[str] = []
                for target in resp.targets or []:
                    rtt = await tcp_rtt_us(target.ip, target.port)
                    if rtt is None:
                        failed.append(target.host_id)
                    else:
                        probes.append(Probe(
                            target_host_id=target.host_id, rtt_us=rtt,
                            created_at_ms=int(time.time() * 1000)))
                if probes or failed:
                    # report at once: the nt evaluator is as fresh as the
                    # last report; the pacing sleep bounds the load
                    await stream.write(SyncProbesRequest(
                        host=self.daemon.host_info(),
                        probes=probes or None,
                        failed_host_ids=failed or None))
                    if await stream.read() is None:
                        return
                    self.rounds += 1
                await asyncio.sleep(interval_s)
        finally:
            stream.cancel()

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
