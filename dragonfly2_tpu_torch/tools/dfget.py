"""dfget: download a URL through the P2P fabric.

Counterpart of ``dragonfly2_tpu/tools/dfget.py`` (reference ``cmd/dfget``
+ ``client/dfget/dfget.go``): ``Download`` through the daemon's local
socket, daemon spawn on demand, and the direct-from-source fallback with
digest check. ``--shard-manifest`` with ``--shards`` pulls only the
pieces covering the named shards and prints one ready line per shard,
marked ``(tree)`` or ``(swap)`` by its supply path. ``--tenant`` and
``--qos-class`` ride the request's ``UrlMeta`` to the daemon's governor
and shaper and to the scheduler's quotas. Origins are ``file://``,
``http://`` and ``https://``; recursive downloads are not ported yet and
their flag exits non-zero.

Usage:
    python -m dragonfly2_tpu_torch.tools.dfget URL -O /path/out [options]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import subprocess
import sys
import time

from ..common import digest as digestlib
from ..common.dfpath import DFPath
from ..common.errors import Code, DFError
from ..common.piece import parse_http_range
from ..common.unit import format_bytes
from ..idl.messages import (DownloadRequest, Empty, Priority, ShardInfo,
                            ShardManifest, UrlMeta)
from ..rpc.client import Channel, ServiceClient
from ..source import SourceRequest, client_for, close_clients
from . import refuse_unported


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dfget", description="P2P-accelerated download")
    p.add_argument("url", help="source URL (http/https/file/gs/memory)")
    p.add_argument("-O", "--output", required=True, help="output path")
    p.add_argument("--digest", default="", help="expected digest algo:hex")
    p.add_argument("--tag", default="", help="task isolation tag")
    p.add_argument("--application", default="")
    p.add_argument("--priority", type=int, default=0, choices=range(7),
                   help="download priority LEVEL0 (highest) .. LEVEL6; "
                   "0 also means 'resolve via the application table'")
    p.add_argument("--tenant", default="",
                   help="tenant this download is accounted to "
                   "(quotas, per-tenant QoS attribution)")
    p.add_argument("--qos-class", default="", dest="qos_class",
                   choices=("", "critical", "standard", "bulk"),
                   help="QoS service class: critical (latency-sensitive "
                   "foreground), standard (default), bulk (background — "
                   "throttled/queued/shed first under brownout)")
    p.add_argument("--shards", default="",
                   help="sharded tasks: comma-joined manifest shard names "
                   "THIS host needs (requires --shard-manifest); only the "
                   "pieces covering them are pulled and the output file is "
                   "sparse outside them")
    p.add_argument("--shard-manifest", default="", dest="shard_manifest",
                   help="path to a shard-manifest JSON file ({\"shards\": "
                   "[{name, range_start, range_size, dtype?, shape?, "
                   "digest?}, ...]}); per-shard ready timestamps are "
                   "printed as shards verify")
    p.add_argument("--header", action="append", default=[],
                   help="extra origin header K:V (repeatable)")
    p.add_argument("--filter", action="append", default=[],
                   help="query params excluded from the task id (repeatable)")
    p.add_argument("--range", dest="range_", default="", help="bytes=a-b sub-range")
    p.add_argument("--timeout", type=float, default=0.0)
    p.add_argument("--daemon-sock", default="", help="daemon unix socket path")
    p.add_argument("--no-daemon", action="store_true",
                   help="skip daemon; fetch straight from the source")
    p.add_argument("--spawn-daemon", action="store_true",
                   help="start a daemon if the socket is dead")
    p.add_argument("--recursive", "-r", action="store_true")
    p.add_argument("--quiet", "-q", action="store_true")
    return p


def _meta(args) -> UrlMeta:
    header = {}
    for h in args.header:
        k, _, v = h.partition(":")
        header[k.strip()] = v.strip()
    return UrlMeta(digest=args.digest, tag=args.tag, range=args.range_,
                   application=args.application, header=header or None,
                   filtered_query_params=args.filter or None,
                   priority=Priority(args.priority), tenant=args.tenant,
                   qos_class=args.qos_class, shards=args.shards)


def _load_shard_manifest(path: str) -> ShardManifest | None:
    """Parse a shard-manifest JSON file into the wire ShardManifest.
    Accepts ``{"shards": [...]}`` or a bare list of shard objects."""
    if not path:
        return None
    with open(path, encoding="utf-8") as f:
        raw = json.load(f)
    entries = raw.get("shards", raw) if isinstance(raw, dict) else raw
    shards = [ShardInfo(name=e["name"],
                        range_start=int(e["range_start"]),
                        range_size=int(e["range_size"]),
                        dtype=e.get("dtype", "uint8"),
                        shape=list(e["shape"]) if e.get("shape") else None,
                        digest=e.get("digest", ""))
              for e in entries]
    return ShardManifest(shards=shards)


async def _daemon_alive(sock: str) -> bool:
    if not os.path.exists(sock):
        return False
    ch = Channel(f"unix:{sock}")
    try:
        health = ServiceClient(ch, "df.health.Health", max_attempts=1)
        await asyncio.wait_for(health.unary("Check", Empty()), 2.0)
        return True
    except Exception:  # noqa: BLE001
        return False
    finally:
        await ch.close()


def _spawn_daemon(sock: str) -> None:
    """Start a detached daemon process bound to ``sock``."""
    subprocess.Popen(
        [sys.executable, "-m", "dragonfly2_tpu_torch.tools.daemon",
         "--unix-sock", sock],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        start_new_session=True)


async def download_via_daemon(sock: str, args, *, progress=None) -> None:
    t0 = time.monotonic()
    ch = Channel(f"unix:{sock}")
    try:
        client = ServiceClient(ch, "df.daemon.Daemon")
        req = DownloadRequest(url=args.url, output=os.path.abspath(args.output),
                              url_meta=_meta(args), timeout_s=args.timeout,
                              shard_manifest=_load_shard_manifest(
                                  args.shard_manifest))
        async for resp in client.unary_stream("Download", req):
            if resp.shard and not args.quiet:
                # per-shard ready line: the shard's bytes all verified
                print(f"\rdfget: shard {resp.shard} ready "
                      f"[{resp.shards_ready}/{resp.shards_total}] "
                      f"({resp.shard_src}) at "
                      f"{time.monotonic() - t0:.3f}s          ")
                continue
            if progress and not resp.done:
                progress(resp.completed_length, resp.content_length)
            if resp.done and progress:
                progress(resp.completed_length, resp.content_length, done=True)
    finally:
        await ch.close()


async def download_from_source(args, *, progress=None) -> None:
    """Direct origin fetch (no daemon): the reference's
    ``downloadFromSource`` fallback, with digest verification."""
    client = client_for(args.url)
    header = dict(_meta(args).header or {})
    req = SourceRequest(url=args.url, header=header, timeout_s=args.timeout)
    if args.range_:
        total = await client.content_length(SourceRequest(url=args.url,
                                                          header=header))
        req.range = parse_http_range(args.range_, total)
    resp = await client.download(req)
    tmp = args.output + ".dfget.tmp"
    os.makedirs(os.path.dirname(os.path.abspath(tmp)) or ".", exist_ok=True)
    hasher = None
    algo = want = ""
    if args.digest:
        algo, want = digestlib.parse(args.digest)
        hasher = digestlib.Hasher(algo)
    done = 0
    with open(tmp, "wb") as f:
        async for chunk in resp.chunks:
            f.write(chunk)
            done += len(chunk)
            if hasher is not None:
                hasher.update(chunk)
            if progress:
                progress(done, resp.content_length)
    if hasher is not None:
        got = hasher.hexdigest()
        if got != want:
            os.unlink(tmp)
            raise DFError(Code.CLIENT_DIGEST_MISMATCH,
                          f"digest mismatch from source: {algo}:{got[:12]}..")
    os.replace(tmp, args.output)
    if progress:
        progress(done, done, done=True)


async def run(args) -> int:
    t0 = time.monotonic()

    def progress(completed: int, total: int, done: bool = False) -> None:
        if args.quiet:
            return
        if done:
            dt = time.monotonic() - t0
            rate = completed / dt if dt > 0 else 0
            print(f"\rdfget: {format_bytes(completed)} in {dt:.2f}s "
                  f"({format_bytes(rate)}/s)          ")
        else:
            pct = f"{100 * completed / total:5.1f}%" if total > 0 else "   ?  "
            print(f"\rdfget: {pct} {format_bytes(completed)}", end="", flush=True)

    if args.no_daemon:
        await download_from_source(args, progress=progress)
        return 0
    sock = args.daemon_sock or DFPath().daemon_sock()
    if not await _daemon_alive(sock):
        if args.spawn_daemon:
            _spawn_daemon(sock)
            for _ in range(50):
                await asyncio.sleep(0.2)
                if await _daemon_alive(sock):
                    break
            else:
                print("dfget: daemon did not come up; falling back to source",
                      file=sys.stderr)
                await download_from_source(args, progress=progress)
                return 0
        else:
            await download_from_source(args, progress=progress)
            return 0
    await download_via_daemon(sock, args, progress=progress)
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.shards and not args.shard_manifest:
        # without the manifest the daemon cannot map names to byte ranges,
        # and downloading the whole checkpoint is what the flag avoids
        parser.error("--shards requires --shard-manifest (the daemon "
                     "needs the shard table to subset the download)")
    refuse_unported(parser, {
        "--recursive": (args.recursive, "recursive downloads")})
    async def run_and_close() -> int:
        try:
            return await run(args)
        finally:
            await close_clients()     # this loop's pooled origin connections

    try:
        return asyncio.run(run_and_close())
    except DFError as exc:
        print(f"dfget: error: {exc.code.name}: {exc.message}", file=sys.stderr)
        return 1
    except KeyboardInterrupt:
        return 130


if __name__ == "__main__":
    sys.exit(main())
