"""Scheduler launcher: ``python -m dragonfly2_tpu_torch.tools.scheduler``.

Counterpart of ``dragonfly2_tpu/tools/scheduler.py`` (reference
``cmd/scheduler``): config from YAML or JSON (``--config``), DF_* env
overrides and flags; SIGINT or SIGTERM shuts down cleanly.
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import sys

from ..common import logging as dflog
from ..common.config import env_overrides, load_config
from ..scheduler.config import SchedulerConfig
from ..scheduler.server import Scheduler
from . import add_debug_arg, refuse_unported


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


async def serve(cfg: SchedulerConfig) -> None:
    sched = Scheduler(cfg)
    await sched.start()
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    # announced once a SIGTERM stops it cleanly
    print(f"scheduler up: {sched.address}", flush=True)
    await stop.wait()
    await sched.stop()


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    refuse_unported(parser, {
        "--tracing-jsonl": (args.tracing_jsonl, "tracing"),
        "--tracing-otlp": (args.tracing_otlp, "tracing"),
        "--debug-port": (args.debug_port, "the debug HTTP surface")})
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
    cfg = load_config(SchedulerConfig, args.config or None, overrides)
    asyncio.run(serve(cfg))
    return 0


if __name__ == "__main__":
    sys.exit(main())
