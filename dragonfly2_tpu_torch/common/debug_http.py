"""The pprof-analog debug surface any service can serve.

Counterpart of ``dragonfly2_tpu/common/debug_http.py`` (reference
``cmd/dependency/dependency.go:95-117``):

- ``/debug/stacks``: every thread's stack and every asyncio task's await
  chain (``health.format_stacks``);
- ``/debug/profile?seconds=N``: cProfile of the event loop's thread for N
  seconds (default 5, clamped to 0-60), one at a time (409 while one
  runs);
- ``/metrics``: the process's registry.

The daemon mounts the first two on its upload server under
``upload.debug_endpoints``; the scheduler, manager and trainer launchers
serve all three with ``/debug/health`` on a dedicated ``--debug-port``
(``maybe_start_debug``), on ``common/httpd.py``'s server.
"""

from __future__ import annotations

import asyncio
import logging

from . import httpd
from .metrics import REGISTRY

log = logging.getLogger("df.debug")

_profiling = False


async def debug_stacks(_params, _query):
    from .health import format_stacks

    return 200, format_stacks()


async def debug_profile(_params, query):
    """cProfile the event-loop thread for ``?seconds=N``. Serialized: two
    profilers on one thread corrupt each other."""
    global _profiling
    import cProfile
    import io
    import pstats

    try:
        seconds = min(max(float(query.get("seconds", "5")), 0.0), 60.0)
    except ValueError:
        return 400, "seconds must be a number"
    if _profiling:
        return 409, "a profile is already running"
    _profiling = True
    try:
        prof = cProfile.Profile()
        try:
            prof.enable()
            # the sleep is the profiling window; the flag serializes it
            await asyncio.sleep(seconds)
        finally:
            prof.disable()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats(
            "cumulative").print_stats(60)
        return 200, out.getvalue()
    finally:
        _profiling = False


async def _metrics(_params, _query):
    return 200, REGISTRY.expose()


def add_debug_routes(router) -> None:
    router.add_get("/debug/stacks", debug_stacks)
    router.add_get("/debug/profile", debug_profile)


async def maybe_start_debug(debug_port: int, extra_routes=None):
    """Launcher wiring: start the debug server when ``--debug-port`` is
    set (-1: an ephemeral port) and print its port; the server (or None)
    for the launcher to stop at shutdown. ``extra_routes``:
    callable(router) adding a service's own surfaces."""
    if not debug_port:
        return None
    server = await start_debug_server("127.0.0.1", max(debug_port, 0),
                                      extra_routes=extra_routes)
    print(f"debug on :{server.port}", flush=True)
    return server


async def start_debug_server(host: str, port: int, extra_routes=None
                             ) -> httpd.RouteServer:
    """Serve ``/debug/{stacks,profile,health}`` and ``/metrics``; ``port``
    0 binds an ephemeral one. A bind failure raises: a requested debug
    surface that is silently missing wastes the investigation it is for."""
    from .health import add_health_routes

    router = httpd.Router()
    add_debug_routes(router)
    add_health_routes(router)
    router.add_get("/metrics", _metrics)
    if extra_routes is not None:
        extra_routes(router)
    server = httpd.RouteServer(router, host=host, port=port)
    await server.start()
    log.info("debug endpoints on %s:%d", host, server.port)
    return server
