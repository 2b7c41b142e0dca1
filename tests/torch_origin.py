"""A standard-library HTTP origin for the port's tests (no aiohttp).

``Origin(files, ...)`` serves ``files`` (name -> bytes) from a
``ThreadingHTTPServer`` on a thread of the test process, speaking HTTP/1.1
with keep-alive: ``GET`` and ``HEAD``, single ``Range`` requests (206 with
``Content-Range``), ``Accept-Ranges: bytes``. Options shape the
misbehaviours the HTTP client must handle: ``no_head`` (HEAD answers 405),
``no_length`` (bodies go out chunked, with no ``Content-Length``) and
``pace_bps`` (bodies trickle at that rate, in ``chunk``-byte writes). Fixed
paths: ``/redirect/<name>`` answers 302 to ``/<name>``, ``/busy`` 503 with
``Retry-After: 2``, ``/forbidden`` 403; anything else unknown is 404.
``body_bytes`` counts the body bytes sent, ``ranges`` the (start, end)
ranges served.
"""

from __future__ import annotations

import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_RANGE = re.compile(r"bytes=(\d+)-(\d*)$")


class Origin:
    def __init__(self, files: dict[str, bytes], *, no_head: bool = False,
                 no_length: bool = False, support_range: bool = True,
                 pace_bps: int = 0, chunk: int = 512 * 1024):
        self.files = files
        self.no_head = no_head
        self.no_length = no_length
        self.support_range = support_range
        self.pace_bps = pace_bps
        self.chunk = chunk
        self.body_bytes = 0
        self.ranges: list[tuple[int, int]] = []
        self.requests: list[tuple[str, str, str]] = []  # method, path, Range
        self._lock = threading.Lock()
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    @property
    def base(self) -> str:
        return f"http://127.0.0.1:{self._server.server_address[1]}"

    def __enter__(self) -> "Origin":
        origin = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args) -> None:
                pass

            def _plain(self, status: int, headers: dict | None = None) -> None:
                self.send_response(status)
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def _handle(self, head_only: bool) -> None:
                with origin._lock:
                    origin.requests.append((self.command, self.path,
                                            self.headers.get("Range", "")))
                path = self.path.split("?", 1)[0]
                if path.startswith("/redirect/"):
                    self._plain(302, {"Location": "/" + path[10:]})
                    return
                if path == "/busy":
                    self._plain(503, {"Retry-After": "2"})
                    return
                if path == "/forbidden":
                    self._plain(403)
                    return
                data = origin.files.get(path.lstrip("/"))
                if data is None:
                    self._plain(404)
                    return
                if head_only and origin.no_head:
                    self._plain(405)
                    return
                start, end, status = 0, len(data), 200
                rng = self.headers.get("Range")
                m = _RANGE.match(rng or "")
                if origin.support_range and m:
                    start = int(m.group(1))
                    end = min(len(data), int(m.group(2)) + 1
                              if m.group(2) else len(data))
                    status = 206
                self.send_response(status)
                if origin.support_range:
                    self.send_header("Accept-Ranges", "bytes")
                if status == 206:
                    self.send_header("Content-Range",
                                     f"bytes {start}-{end - 1}/{len(data)}")
                chunked = origin.no_length and not head_only
                if chunked:
                    self.send_header("Transfer-Encoding", "chunked")
                else:
                    self.send_header("Content-Length", str(end - start))
                self.end_headers()
                if head_only:
                    return
                with origin._lock:
                    origin.ranges.append((start, end))
                t0 = time.monotonic()
                sent = 0
                for lo in range(start, end, origin.chunk):
                    part = data[lo:min(end, lo + origin.chunk)]
                    if chunked:
                        self.wfile.write(b"%x\r\n" % len(part) + part
                                         + b"\r\n")
                    else:
                        self.wfile.write(part)
                    sent += len(part)
                    with origin._lock:
                        origin.body_bytes += len(part)
                    if origin.pace_bps:
                        ahead = sent / origin.pace_bps - (time.monotonic()
                                                          - t0)
                        if ahead > 0:
                            time.sleep(ahead)
                if chunked:
                    self.wfile.write(b"0\r\n\r\n")

            def do_GET(self) -> None:
                self._handle(head_only=False)

            def do_HEAD(self) -> None:
                self._handle(head_only=True)

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)
