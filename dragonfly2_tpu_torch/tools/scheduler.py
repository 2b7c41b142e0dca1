"""Scheduler launcher: ``python -m dragonfly2_tpu_torch.tools.scheduler``.

Counterpart of ``dragonfly2_tpu/tools/scheduler.py`` (reference
``cmd/scheduler``): config from YAML or JSON (``--config``), DF_* env
overrides and flags; SIGINT or SIGTERM shuts down cleanly.
``--debug-port`` serves ``/debug/{stacks,profile,health}``, ``/metrics``,
``/debug/cluster``, ``/debug/decisions``, ``/debug/ctrl`` and, with the
fleet pulse on (the default), ``/debug/fleet``;
``--tracing-jsonl`` / ``--tracing-otlp`` turn tracing on.
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import sys

from ..common import health, tracing
from ..common import logging as dflog
from ..common.debug_http import maybe_start_debug
from ..common.config import (ConfigError, env_overrides, load_config,
                             refuse_unported)
from ..scheduler.cluster_view import add_cluster_routes
from ..scheduler.config import KEY_CLASSES, SchedulerConfig
from ..scheduler.ctrl_debug import CtrlObservatory, add_ctrl_routes
from ..scheduler.decision_ledger import add_decision_routes
from ..scheduler.fleetpulse import add_fleet_routes
from ..scheduler.server import Scheduler
from . import add_debug_arg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="df-scheduler")
    p.add_argument("--config", default="", help="YAML/JSON config file")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--listen-ip", default="")
    p.add_argument("--advertise-ip", default="")
    p.add_argument("--manager", action="append", default=[],
                   help="manager address (repeatable)")
    p.add_argument("--trainer", default="", help="trainer address")
    p.add_argument("--algorithm", default="",
                   choices=["", "default", "nt", "ml"])
    p.add_argument("--records-dir", default="")
    p.add_argument("--tracing-jsonl", default="",
                   help="span export path (tracing off when empty)")
    p.add_argument("--tracing-otlp", default="",
                   help="OTLP/HTTP collector endpoint")
    add_debug_arg(p)
    p.add_argument("--verbose", "-v", action="store_true")
    return p


def add_scheduler_routes(router, sched: Scheduler) -> None:
    """The scheduler's own debug surfaces on the ``--debug-port`` router:
    ``/debug/cluster``, ``/debug/decisions``, ``/debug/fleet`` (with the
    fleet pulse on) and ``/debug/ctrl``."""
    add_cluster_routes(router, sched.service.cluster)
    add_decision_routes(router, sched.ledger)
    if sched.fleetpulse is not None:
        add_fleet_routes(router, sched.fleetpulse)
    add_ctrl_routes(router, CtrlObservatory(
        resource=sched.resource, ledger=sched.ledger,
        sharded=sched.sharded))


async def serve(cfg: SchedulerConfig, debug_port: int = 0) -> None:
    health.PLANE.acquire()   # loop watchdog + /debug/health
    sched = Scheduler(cfg)
    await sched.start()
    debug = await maybe_start_debug(
        debug_port,
        extra_routes=lambda router: add_scheduler_routes(router, sched))
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    # announced once a SIGTERM stops it cleanly
    print(f"scheduler up: {sched.address}", flush=True)
    await stop.wait()
    if debug is not None:
        await debug.stop()
    await sched.stop()
    health.PLANE.release()
    # the OTLP drain sleeps in bounded hops: off the loop
    await asyncio.to_thread(tracing.shutdown)


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    dflog.setup("DEBUG" if args.verbose else "INFO")
    overrides: dict = env_overrides()
    if args.port:
        overrides["port"] = args.port
    if args.listen_ip:
        overrides["listen_ip"] = args.listen_ip
    if args.advertise_ip:
        overrides["advertise_ip"] = args.advertise_ip
    if args.manager:
        overrides["manager_addresses"] = args.manager
    if args.trainer:
        overrides["trainer_address"] = args.trainer
    if args.algorithm:
        overrides["algorithm"] = args.algorithm
    if args.records_dir:
        overrides["records_dir"] = args.records_dir
    if args.tracing_jsonl:
        overrides["tracing_jsonl"] = args.tracing_jsonl
    if args.tracing_otlp:
        overrides["tracing_otlp"] = args.tracing_otlp
    cfg = load_config(SchedulerConfig, args.config or None, overrides)
    try:
        refuse_unported(cfg, KEY_CLASSES)
    except ConfigError as exc:
        parser.error(str(exc))
    asyncio.run(serve(cfg, debug_port=args.debug_port))
    return 0


if __name__ == "__main__":
    sys.exit(main())
