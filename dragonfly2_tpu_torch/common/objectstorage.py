"""Object-storage backend clients behind one interface.

Counterpart of ``dragonfly2_tpu/common/objectstorage.py`` (reference
``pkg/objectstorage/{objectstorage,s3,oss,obs}.go``): one S3-compatible
client covers the real-world backends (AWS S3, GCS's XML API, MinIO, Ceph
RGW; OSS and OBS are S3-compatible too) with AWS Signature V4 signing on
the standard library; ``file://`` serves tests and single-host setups. The
daemon's object gateway writes through these (``daemon/objectstorage.py``),
and the ``s3://`` origin scheme (``source/s3_client.py``) shares the
signer. The reference's client is aiohttp; this one sends its requests
through the port's own HTTP/1.1 client (``source/http_client.py``
``HTTPSourceClient.request``), one connection pool per backend.
"""

from __future__ import annotations

import asyncio
import datetime
import hashlib
import hmac
import logging
import os
import urllib.parse
from dataclasses import dataclass
from typing import AsyncIterator

from .errors import Code, DFError

log = logging.getLogger("df.objstore")


# ------------------------------------------------------------------ sigv4

def _sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


@dataclass
class S3Credentials:
    access_key: str = ""
    secret_key: str = ""
    region: str = "us-east-1"
    session_token: str = ""

    @classmethod
    def from_env(cls) -> "S3Credentials":
        return cls(
            access_key=os.environ.get("AWS_ACCESS_KEY_ID", ""),
            secret_key=os.environ.get("AWS_SECRET_ACCESS_KEY", ""),
            region=os.environ.get("AWS_REGION",
                                  os.environ.get("AWS_DEFAULT_REGION",
                                                 "us-east-1")),
            session_token=os.environ.get("AWS_SESSION_TOKEN", ""))


def sign_v4(creds: S3Credentials, method: str, url: str,
            headers: dict[str, str], payload_hash: str,
            *, service: str = "s3",
            now: datetime.datetime | None = None) -> dict[str, str]:
    """AWS Signature Version 4 (stdlib-only). Returns the headers to send
    (input headers + x-amz-date/content-sha256/Authorization)."""
    parts = urllib.parse.urlsplit(url)
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    date = now.strftime("%Y%m%d")
    # lower-case ALL keys first: a caller-supplied "Host"/"Range" colliding
    # case-insensitively with the injected names would otherwise appear
    # twice in SignedHeaders — guaranteed SignatureDoesNotMatch
    out = {k.lower(): v for k, v in headers.items()}
    out["host"] = parts.netloc
    out["x-amz-date"] = amz_date
    out["x-amz-content-sha256"] = payload_hash
    if creds.session_token:
        out["x-amz-security-token"] = creds.session_token

    # the URL's path is already percent-encoded by the caller (_url /
    # quote); re-quoting would turn %20 into %2520 and real S3 answers
    # SignatureDoesNotMatch for any key that needed encoding
    canonical_uri = parts.path or "/"
    query_pairs = sorted(urllib.parse.parse_qsl(parts.query,
                                                keep_blank_values=True))
    canonical_query = "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}="
        f"{urllib.parse.quote(v, safe='-_.~')}" for k, v in query_pairs)
    signed_names = sorted(out)
    canonical_headers = "".join(
        f"{k}:{out[k].strip()}\n" for k in signed_names)
    signed_headers = ";".join(signed_names)
    canonical_request = "\n".join([
        method.upper(), canonical_uri, canonical_query, canonical_headers,
        signed_headers, payload_hash])
    scope = f"{date}/{creds.region}/{service}/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        _sha256_hex(canonical_request.encode())])
    k = _hmac(("AWS4" + creds.secret_key).encode(), date)
    k = _hmac(k, creds.region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    signature = hmac.new(k, string_to_sign.encode(),
                         hashlib.sha256).hexdigest()
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={creds.access_key}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={signature}")
    return out


# ------------------------------------------------------------------ clients

UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"


@dataclass
class ObjectMeta:
    key: str = ""
    size: int = -1
    etag: str = ""


class S3CompatClient:
    """Path-style S3-compatible backend (AWS, GCS XML, MinIO, OSS, OBS).

    ``endpoint``: e.g. https://s3.amazonaws.com or http://minio:9000.
    Streaming PUTs use UNSIGNED-PAYLOAD (TLS protects integrity in real
    deployments; signing a multi-GB body would require buffering it).
    """

    def __init__(self, endpoint: str,
                 creds: S3Credentials | None = None):
        self.endpoint = endpoint.rstrip("/")
        self.creds = creds or S3Credentials.from_env()
        # this backend's own connection pool (imported here: the source
        # package's s3 client imports this module)
        from ..source.http_client import HTTPSourceClient
        self._http = HTTPSourceClient()

    async def close(self) -> None:
        await self._http.close()

    def _url(self, bucket: str, key: str = "") -> str:
        path = f"/{urllib.parse.quote(bucket)}"
        if key:
            path += f"/{urllib.parse.quote(key, safe='/-_.~')}"
        return self.endpoint + path

    def _signed(self, method: str, url: str,
                headers: dict[str, str] | None = None,
                payload_hash: str = _sha256_hex(b"")) -> dict[str, str]:
        if not self.creds.access_key:
            return dict(headers or {})      # anonymous / public buckets
        return sign_v4(self.creds, method, url, headers or {}, payload_hash)

    async def put_object(self, bucket: str, key: str,
                         data: bytes | AsyncIterator[bytes],
                         *, content_length: int = -1) -> None:
        url = self._url(bucket, key)
        headers: dict[str, str] = {}
        if isinstance(data, (bytes, bytearray)):
            # sigv4 needs the whole-payload hash; hashing a multi-MiB
            # object on the loop would stall it, so hashlib takes the
            # buffer as it is on the default executor
            payload_hash = await asyncio.get_running_loop().run_in_executor(
                None, _sha256_hex, data)
            headers["content-length"] = str(len(data))
        else:
            payload_hash = UNSIGNED_PAYLOAD
            if content_length >= 0:
                headers["content-length"] = str(content_length)
        headers = self._signed("PUT", url, headers, payload_hash)
        resp = await self._http.request("PUT", url, headers, body=data,
                                        content_length=content_length)
        text = await resp.read()
        if resp.status >= 300:
            raise DFError(Code.SOURCE_ERROR,
                          f"s3 put {bucket}/{key}: HTTP {resp.status} "
                          f"{text[:200].decode(errors='replace')}")

    async def get_object(self, bucket: str, key: str, *,
                         range_header: str = "") -> tuple[bytes, int]:
        url = self._url(bucket, key)
        headers: dict[str, str] = {}
        if range_header:
            headers["range"] = range_header
        headers = self._signed("GET", url, headers)
        resp = await self._http.request("GET", url, headers)
        data = await resp.read()
        if resp.status == 404:
            raise DFError(Code.SOURCE_NOT_FOUND, f"{bucket}/{key}")
        if resp.status >= 300:
            raise DFError(Code.SOURCE_ERROR,
                          f"s3 get {bucket}/{key}: HTTP {resp.status}")
        return data, resp.status

    async def head_object(self, bucket: str, key: str) -> ObjectMeta:
        url = self._url(bucket, key)
        headers = self._signed("HEAD", url)
        resp = await self._http.request("HEAD", url, headers)
        await resp.read()
        if resp.status == 404:
            raise DFError(Code.SOURCE_NOT_FOUND, f"{bucket}/{key}")
        if resp.status >= 300:
            raise DFError(Code.SOURCE_ERROR,
                          f"s3 head {bucket}/{key}: HTTP {resp.status}")
        return ObjectMeta(
            key=key,
            size=int(resp.headers.get("Content-Length", "-1")),
            etag=resp.headers.get("ETag", "").strip('"'))

    async def delete_object(self, bucket: str, key: str) -> None:
        url = self._url(bucket, key)
        headers = self._signed("DELETE", url)
        resp = await self._http.request("DELETE", url, headers)
        await resp.read()
        if resp.status >= 300 and resp.status != 404:
            raise DFError(Code.SOURCE_ERROR,
                          f"s3 delete {bucket}/{key}: HTTP {resp.status}")


@dataclass
class BackendConfig:
    """One gateway bucket's backend (daemon config)."""

    kind: str = "file"              # file | s3
    base: str = ""                  # file: dir path; s3: endpoint URL
    bucket: str = ""                # backend-side bucket name (s3)
    access_key: str = ""
    secret_key: str = ""
    region: str = "us-east-1"


def make_backend(cfg: BackendConfig):
    if cfg.kind == "s3":
        creds = (S3Credentials(cfg.access_key, cfg.secret_key, cfg.region)
                 if cfg.access_key else S3Credentials.from_env())
        client = S3CompatClient(cfg.base, creds)
    elif cfg.kind == "file":
        # "." backend-bucket keeps the legacy flat file layout (base/key)
        client = FileBackend(cfg.base)
        cfg = BackendConfig(**{**cfg.__dict__, "bucket": cfg.bucket or "."})
    else:
        raise DFError(Code.INVALID_ARGUMENT,
                      f"unknown backend kind {cfg.kind!r}")
    client.bucket = cfg.bucket          # gateway passes this to put_object
    return client


class FileBackend:
    """file:// backend: same interface, local directory storage."""

    def __init__(self, base_dir: str):
        self.base_dir = base_dir

    def _path(self, bucket: str, key: str) -> str:
        path = os.path.realpath(os.path.join(self.base_dir, bucket, key))
        root = os.path.realpath(self.base_dir)
        if not path.startswith(root + os.sep):
            raise DFError(Code.INVALID_ARGUMENT, "path escapes backend root")
        return path

    async def put_object(self, bucket: str, key: str, data, *,
                         content_length: int = -1) -> None:
        import tempfile
        path = self._path(bucket, key)
        loop = asyncio.get_running_loop()
        # whole-object body writes hop through the default executor
        # so the loop never blocks on them; the surrounding
        # mkstemp/replace/unlink are µs-scale
        # metadata syscalls on a local fs
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        try:
            f = os.fdopen(fd, "wb")
            try:
                if isinstance(data, (bytes, bytearray)):
                    await loop.run_in_executor(None, f.write, data)
                else:
                    async for chunk in data:
                        await loop.run_in_executor(None, f.write, chunk)
            finally:
                f.close()
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    async def get_object(self, bucket: str, key: str, *,
                         range_header: str = "") -> tuple[bytes, int]:
        path = self._path(bucket, key)

        def _read() -> bytes | None:
            try:
                with open(path, "rb") as f:
                    return f.read()
            except FileNotFoundError:
                return None

        body = await asyncio.get_running_loop().run_in_executor(None, _read)
        if body is None:
            raise DFError(Code.SOURCE_NOT_FOUND, f"{bucket}/{key}")
        return body, 200

    async def head_object(self, bucket: str, key: str) -> ObjectMeta:
        path = self._path(bucket, key)
        if not os.path.exists(path):
            raise DFError(Code.SOURCE_NOT_FOUND, f"{bucket}/{key}")
        return ObjectMeta(key=key, size=os.path.getsize(path))

    async def delete_object(self, bucket: str, key: str) -> None:
        path = self._path(bucket, key)
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass

    async def close(self) -> None:
        pass
