"""Trainer launcher: ``python -m dragonfly2_tpu_torch.tools.trainer``.

Counterpart of ``dragonfly2_tpu/tools/trainer.py`` (reference
``cmd/trainer``): config from YAML or JSON (``--config``), DF_* env
overrides and flags; SIGINT or SIGTERM shuts down cleanly. Fits run on
every visible CUDA card (the mesh when there are several) unless the
config names one device, such as ``"device": "cpu"``; with no card the
launcher exits non-zero. ``--debug-port`` serves
``/debug/{stacks,profile,health}`` and ``/metrics``.
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import sys

from ..common import health, tracing
from ..common import logging as dflog
from ..common.debug_http import maybe_start_debug
from ..common.config import env_overrides, load_config
from ..trainer.server import Trainer, TrainerConfig
from . import add_debug_arg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="df-trainer")
    p.add_argument("--config", default="", help="YAML/JSON config file")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--listen-ip", default="")
    p.add_argument("--data-dir", default="")
    p.add_argument("--manager", action="append", default=[],
                   help="manager address (repeatable)")
    add_debug_arg(p)
    p.add_argument("--verbose", "-v", action="store_true")
    return p


async def serve(cfg: TrainerConfig, debug_port: int = 0) -> None:
    health.PLANE.acquire()   # loop watchdog + /debug/health
    trainer = Trainer(cfg)
    await trainer.start()
    debug = await maybe_start_debug(debug_port)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    # announced once a SIGTERM stops it cleanly
    print(f"trainer up: {trainer.address}", flush=True)
    await stop.wait()
    if debug is not None:
        await debug.stop()
    await trainer.stop()
    health.PLANE.release()
    # the OTLP drain sleeps in bounded hops: off the loop
    await asyncio.to_thread(tracing.shutdown)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    dflog.setup("DEBUG" if args.verbose else "INFO")
    overrides: dict = env_overrides()
    if args.port:
        overrides["port"] = args.port
    if args.listen_ip:
        overrides["listen_ip"] = args.listen_ip
    if args.data_dir:
        overrides["data_dir"] = args.data_dir
    if args.manager:
        overrides["manager_addresses"] = args.manager
    cfg = load_config(TrainerConfig, args.config or None, overrides)
    asyncio.run(serve(cfg, debug_port=args.debug_port))
    return 0


if __name__ == "__main__":
    sys.exit(main())
