"""Daemon launcher: ``python -m dragonfly2_tpu_torch.tools.daemon``.

Counterpart of ``dragonfly2_tpu/tools/daemon.py`` (reference
``cmd/dfget/cmd/daemon.go``): config from YAML or JSON (``--config``),
DF_* env overrides and flags; SIGINT or SIGTERM shuts down cleanly. The
device sink lands bytes on CUDA unless the config names
``"device": "cpu"``. ``--debug-endpoints`` serves ``/debug/stacks``,
``/debug/profile`` and ``/debug/faults`` on the upload port (``/debug/
health`` is always there); ``--tracing-jsonl`` / ``--tracing-otlp`` turn
tracing on.
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import sys

from ..common import logging as dflog
from ..common import tracing
from ..common.config import (ConfigError, env_overrides, load_config,
                             refuse_unported)
from ..daemon.config import KEY_CLASSES, DaemonConfig
from ..daemon.daemon import Daemon


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="df-daemon")
    p.add_argument("--config", default="", help="YAML/JSON config file")
    p.add_argument("--workdir", default="")
    p.add_argument("--unix-sock", default="")
    p.add_argument("--rpc-port", type=int, default=0)
    p.add_argument("--upload-port", type=int, default=0)
    p.add_argument("--seed", action="store_true", help="run as seed peer")
    p.add_argument("--scheduler", action="append", default=[],
                   help="scheduler address (repeatable)")
    p.add_argument("--debug-endpoints", action="store_true",
                   help="serve /debug/stacks and /debug/profile")
    p.add_argument("--tracing-jsonl", default="",
                   help="enable tracing; spans to this JSONL path")
    p.add_argument("--tracing-otlp", default="",
                   help="enable tracing; spans to this OTLP endpoint")
    p.add_argument("--verbose", "-v", action="store_true")
    return p


async def serve(cfg: DaemonConfig) -> None:
    daemon = Daemon(cfg)
    await daemon.start()
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    await daemon.stop()
    # the OTLP drain sleeps in bounded hops: off the loop
    await asyncio.to_thread(tracing.shutdown)


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    dflog.setup("DEBUG" if args.verbose else "INFO")
    overrides: dict = env_overrides()
    if args.workdir:
        overrides["workdir"] = args.workdir
    if args.unix_sock:
        overrides["unix_sock"] = args.unix_sock
    if args.rpc_port:
        overrides["rpc_port"] = args.rpc_port
    if args.upload_port:
        overrides.setdefault("upload", {})["port"] = args.upload_port
    if args.seed:
        overrides["is_seed"] = True
    if args.scheduler:
        overrides.setdefault("scheduler", {})["addresses"] = args.scheduler
    if args.debug_endpoints:
        overrides.setdefault("upload", {})["debug_endpoints"] = True
    if args.tracing_jsonl or args.tracing_otlp:
        tr = overrides.setdefault("tracing", {})
        tr["enabled"] = True
        # only the flags given: an empty value would clobber an exporter
        # the file or the environment configured
        if args.tracing_jsonl:
            tr["jsonl_path"] = args.tracing_jsonl
        if args.tracing_otlp:
            tr["otlp_endpoint"] = args.tracing_otlp
    cfg = load_config(DaemonConfig, args.config or None, overrides)
    try:
        refuse_unported(cfg, KEY_CLASSES)
    except ConfigError as exc:
        parser.error(str(exc))
    asyncio.run(serve(cfg))
    return 0


if __name__ == "__main__":
    sys.exit(main())
