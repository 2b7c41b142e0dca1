"""dfcache: stat, import, export and delete files in the P2P cache.

Counterpart of ``dragonfly2_tpu/tools/dfcache.py`` (reference
``cmd/dfcache`` + ``client/dfcache/dfcache.go``), flag for flag: a cache
entry is a task keyed by the URL ``cache://local/<id>``, reached through
the daemon's local API (``StatTask``, ``ImportTask``, ``ExportTask``,
``DeleteTask``) on its unix socket.

Usage:
    python -m dragonfly2_tpu_torch.tools.dfcache stat ID
    python -m dragonfly2_tpu_torch.tools.dfcache import ID -I /path/in
    python -m dragonfly2_tpu_torch.tools.dfcache export ID -O /path/out
    python -m dragonfly2_tpu_torch.tools.dfcache delete ID
    (each with [--daemon-sock SOCK] [--tag T] [--timeout S] [--local-only])

Each prints one JSON line and exits 0; a failed operation prints
``dfcache: <CODE>: <message>`` on stderr and exits 1 (``stat`` of an
absent entry: ``NOT_FOUND``); a missing ``-I``/``-O`` exits 2.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from ..common.dfpath import DFPath
from ..common.errors import DFError
from ..idl.messages import (DeleteTaskRequest, ExportTaskRequest,
                            ImportTaskRequest, StatTaskDaemonRequest, UrlMeta)
from ..rpc.client import Channel, ServiceClient


def cache_url(cache_id: str) -> str:
    return f"cache://local/{cache_id}"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dfcache",
                                description="P2P cache operations")
    p.add_argument("op", choices=["stat", "import", "export", "delete"])
    p.add_argument("id", help="cache entry id")
    p.add_argument("-I", "--input", default="", help="file to import")
    p.add_argument("-O", "--output", default="", help="export destination")
    p.add_argument("--tag", default="")
    p.add_argument("--timeout", type=float, default=60.0)
    p.add_argument("--daemon-sock", default="")
    p.add_argument("--local-only", action="store_true",
                   help="stat/export only from this daemon's storage")
    return p


async def run(args: argparse.Namespace) -> int:
    sock = args.daemon_sock or DFPath().daemon_sock()
    ch = Channel(f"unix:{sock}")
    client = ServiceClient(ch, "df.daemon.Daemon")
    meta = UrlMeta(tag=args.tag)
    url = cache_url(args.id)
    try:
        if args.op == "stat":
            stat = await client.unary("StatTask", StatTaskDaemonRequest(
                url=url, url_meta=meta, local_only=args.local_only),
                timeout=args.timeout)
            print(json.dumps({"id": stat.id, "state": stat.state,
                              "content_length": stat.content_length,
                              "pieces": stat.total_piece_count}))
        elif args.op == "import":
            if not args.input:
                print("import requires -I", file=sys.stderr)
                return 2
            stat = await client.unary("ImportTask", ImportTaskRequest(
                path=args.input, url=url, url_meta=meta),
                timeout=args.timeout)
            print(json.dumps({"id": stat.id,
                              "content_length": stat.content_length}))
        elif args.op == "export":
            if not args.output:
                print("export requires -O", file=sys.stderr)
                return 2
            await client.unary("ExportTask", ExportTaskRequest(
                url=url, output=args.output, url_meta=meta,
                timeout_s=args.timeout, local_only=args.local_only),
                timeout=args.timeout + 5)
            print(json.dumps({"exported": args.output}))
        elif args.op == "delete":
            await client.unary("DeleteTask", DeleteTaskRequest(
                url=url, url_meta=meta), timeout=args.timeout)
            print(json.dumps({"deleted": args.id}))
        return 0
    except DFError as exc:
        print(f"dfcache: {exc.code.name}: {exc.message}", file=sys.stderr)
        return 1
    finally:
        await ch.close()


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return asyncio.run(run(args))


if __name__ == "__main__":
    raise SystemExit(main())
