"""Manager launcher: ``python -m dragonfly2_tpu_torch.tools.manager``.

Counterpart of ``dragonfly2_tpu/tools/manager.py`` (reference
``cmd/manager``): config from YAML or JSON (``--config``), DF_* env
overrides and flags; SIGINT or SIGTERM shuts down cleanly.
``--debug-port`` serves ``/debug/{stacks,profile,health}`` and
``/metrics``. ``--issue-certs`` makes the manager the fleet's certificate
issuer (its CA under ``<workdir>/manager-ca``, the issuance token at
``<workdir>/issuer.token``); ``--auth`` turns on REST auth and RBAC (the
first boot writes root's password to ``root.password`` in the workdir,
mode 0600).
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
from ..manager.server import Manager, ManagerConfig
from . import add_debug_arg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="df-manager")
    p.add_argument("--config", default="", help="YAML/JSON config file")
    p.add_argument("--grpc-port", type=int, default=0)
    p.add_argument("--rest-port", type=int, default=0)
    p.add_argument("--listen-ip", default="")
    p.add_argument("--db", default="", help="sqlite path ('' = in-memory)")
    p.add_argument("--workdir", default="")
    p.add_argument("--auth", action="store_true",
                   help="enable REST auth/RBAC (bootstraps a root user)")
    p.add_argument("--issue-certs", action="store_true",
                   help="enable fleet certificate issuance")
    add_debug_arg(p)
    p.add_argument("--verbose", "-v", action="store_true")
    return p


async def serve(cfg: ManagerConfig, debug_port: int = 0) -> None:
    health.PLANE.acquire()   # loop watchdog + /debug/health
    mgr = Manager(cfg)
    await mgr.start()
    debug = await maybe_start_debug(debug_port)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    # announced once a SIGTERM stops it cleanly
    print(f"manager up: grpc={mgr.address} rest=:{mgr.rest.port}", flush=True)
    await stop.wait()
    if debug is not None:
        await debug.stop()
    await mgr.stop()
    health.PLANE.release()
    # the OTLP drain sleeps in bounded hops: off the loop
    await asyncio.to_thread(tracing.shutdown)


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    dflog.setup("DEBUG" if args.verbose else "INFO")
    overrides: dict = env_overrides()
    if args.grpc_port:
        overrides["grpc_port"] = args.grpc_port
    if args.rest_port:
        overrides["rest_port"] = args.rest_port
    if args.listen_ip:
        overrides["listen_ip"] = args.listen_ip
    if args.db:
        overrides["db_path"] = args.db
    if args.workdir:
        overrides["workdir"] = args.workdir
    if args.auth:
        overrides["auth_enabled"] = True
    if args.issue_certs:
        overrides["issue_certs"] = True
    cfg = load_config(ManagerConfig, args.config or None, overrides)
    if cfg.unported():
        parser.error("not ported to this package yet: "
                     + ", ".join(cfg.unported()))
    asyncio.run(serve(cfg, debug_port=args.debug_port))
    return 0


if __name__ == "__main__":
    sys.exit(main())
