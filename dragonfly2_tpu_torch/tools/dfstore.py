"""dfstore: object gateway client and CLI.

Counterpart of ``dragonfly2_tpu/tools/dfstore.py`` (reference
``cmd/dfstore`` + ``client/dfstore/dfstore.go``: GetObject, PutObject,
CopyObject, DeleteObject and IsObjectExist against a daemon's object
gateway), with the same commands, flags and JSON lines. It speaks HTTP
through the port's own client (``source/http_client.py``), where the
reference uses aiohttp; a PUT streams the file from disk.

Usage:
    python -m dragonfly2_tpu_torch.tools.dfstore get  BUCKET KEY -O /path/out
    python -m dragonfly2_tpu_torch.tools.dfstore put  BUCKET KEY -I /path/in
    python -m dragonfly2_tpu_torch.tools.dfstore stat BUCKET KEY
    python -m dragonfly2_tpu_torch.tools.dfstore rm   BUCKET KEY
    python -m dragonfly2_tpu_torch.tools.dfstore ls   BUCKET
    python -m dragonfly2_tpu_torch.tools.dfstore cp   BUCKET SRC DST

Exit 0 on success; 1 on a failed operation (``stat`` of an absent
object included).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import tempfile
from urllib.parse import quote

from ..source.http_client import HTTPSourceClient

_CHUNK = 1 << 20


class Dfstore:
    """HTTP client for the daemon's object gateway."""

    def __init__(self, endpoint: str):
        self.endpoint = endpoint.rstrip("/")
        self._http = HTTPSourceClient()

    def _url(self, bucket: str, key: str = "") -> str:
        base = f"{self.endpoint}/buckets/{quote(bucket)}/objects"
        return f"{base}/{quote(key)}" if key else base

    async def close(self) -> None:
        await self._http.close()

    async def get_object(self, bucket: str, key: str, output: str) -> int:
        resp = await self._http.request("GET", self._url(bucket, key))
        if resp.status != 200:
            await resp.discard()
            raise RuntimeError(f"GET {key}: HTTP {resp.status}")
        n = 0
        f = await asyncio.to_thread(open, output, "wb")
        try:
            async for chunk in resp.chunks(_CHUNK):
                await asyncio.to_thread(f.write, chunk)
                n += len(chunk)
        finally:
            f.close()
        return n

    async def put_object(self, bucket: str, key: str, path: str) -> None:
        size = os.path.getsize(path)

        async def chunks():
            f = await asyncio.to_thread(open, path, "rb")
            try:
                while True:
                    block = await asyncio.to_thread(f.read, _CHUNK)
                    if not block:
                        return
                    yield block
            finally:
                f.close()

        resp = await self._http.request("PUT", self._url(bucket, key),
                                        body=chunks(), content_length=size)
        await resp.read()
        if resp.status not in (200, 201, 202):
            raise RuntimeError(f"PUT {key}: HTTP {resp.status}")

    async def is_object_exist(self, bucket: str, key: str) -> int | None:
        resp = await self._http.request("HEAD", self._url(bucket, key))
        await resp.read()
        if resp.status != 200:
            return None
        return int(resp.headers.get("Content-Length", -1))

    async def delete_object(self, bucket: str, key: str) -> None:
        resp = await self._http.request("DELETE", self._url(bucket, key))
        await resp.read()
        if resp.status not in (200, 204):
            raise RuntimeError(f"DELETE {key}: HTTP {resp.status}")

    async def list_objects(self, bucket: str) -> list[dict]:
        resp = await self._http.request("GET", self._url(bucket))
        body = await resp.read()
        if resp.status != 200:
            raise RuntimeError(f"LIST {bucket}: HTTP {resp.status}")
        return json.loads(body)

    async def copy_object(self, bucket: str, src: str, dst: str) -> None:
        with tempfile.NamedTemporaryFile() as tmp:
            await self.get_object(bucket, src, tmp.name)
            await self.put_object(bucket, dst, tmp.name)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dfstore",
                                description="object gateway operations")
    p.add_argument("op", choices=["get", "put", "stat", "rm", "ls", "cp"])
    p.add_argument("bucket")
    p.add_argument("key", nargs="?", default="")
    p.add_argument("dst_key", nargs="?", default="", help="cp destination key")
    p.add_argument("-I", "--input", default="")
    p.add_argument("-O", "--output", default="")
    p.add_argument("--endpoint", default="http://127.0.0.1:65004",
                   help="object gateway endpoint")
    return p


async def run(args: argparse.Namespace) -> int:
    store = Dfstore(args.endpoint)
    try:
        if args.op == "get":
            n = await store.get_object(args.bucket, args.key, args.output)
            print(json.dumps({"bytes": n, "output": args.output}))
        elif args.op == "put":
            await store.put_object(args.bucket, args.key, args.input)
            print(json.dumps({"stored": args.key}))
        elif args.op == "stat":
            size = await store.is_object_exist(args.bucket, args.key)
            if size is None:
                print(json.dumps({"exists": False}))
                return 1
            print(json.dumps({"exists": True, "size": size}))
        elif args.op == "rm":
            await store.delete_object(args.bucket, args.key)
            print(json.dumps({"deleted": args.key}))
        elif args.op == "ls":
            print(json.dumps(await store.list_objects(args.bucket)))
        elif args.op == "cp":
            await store.copy_object(args.bucket, args.key, args.dst_key)
            print(json.dumps({"copied": [args.key, args.dst_key]}))
        return 0
    except Exception as exc:  # noqa: BLE001 - CLI boundary
        print(f"dfstore: {exc}", file=sys.stderr)
        return 1
    finally:
        await store.close()


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return asyncio.run(run(args))


if __name__ == "__main__":
    raise SystemExit(main())
