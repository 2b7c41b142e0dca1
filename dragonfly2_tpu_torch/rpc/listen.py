"""Listener helpers: port-range and vsock listen.

Counterpart of ``dragonfly2_tpu/rpc/listen.py`` (reference
``pkg/rpc/server_listen.go`` ``ListenWithPortRange``: the first free port
in [start, end] wins, used where fleets pin service ports to
firewall-approved ranges; and ``pkg/rpc/vsock.go``: AF_VSOCK listeners for
VM-isolated deployments, such as firecracker guests talking to a host
daemon without a NIC).

asyncio serves an already-bound socket (``start_server(sock=...)``), so
the port's ``RPCServer`` binds a range here in both of its branches, the
mux front's and the plain listener's.
"""

from __future__ import annotations

import socket

VSOCK_CID_ANY = -1


def parse_port_spec(spec: str) -> tuple[int, int]:
    """"8000" -> (8000, 8000); "8000-8010" -> (8000, 8010); "0" -> (0, 0)."""
    start, _, end = spec.partition("-")
    lo = int(start)
    hi = int(end) if end else lo
    if hi < lo:
        raise ValueError(f"port range end < start: {spec!r}")
    return lo, hi


def bind_port_in_range(ip: str, start: int, end: int) -> socket.socket:
    """The first bindable TCP port in [start, end] (reference
    ``ListenWithPortRange``); start == 0 binds an ephemeral port. Returns
    the bound listening socket, so no other process can take the port
    between the probe and its use."""
    last_exc: OSError | None = None
    for port in range(start, end + 1):
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind((ip, port))
            s.listen(128)
            return s
        except OSError as exc:
            s.close()
            last_exc = exc
    raise OSError(f"no free port in {ip}:{start}-{end}") from last_exc


def vsock_listener(port: int, cid: int = VSOCK_CID_ANY) -> socket.socket:
    """A bound AF_VSOCK listening socket (reference ``pkg/rpc/vsock.go``).
    Raises OSError where the kernel lacks vsock support: callers report a
    configuration error, never fall back to TCP."""
    if not hasattr(socket, "AF_VSOCK"):
        raise OSError("AF_VSOCK not supported on this platform")
    cid = socket.VMADDR_CID_ANY if cid == VSOCK_CID_ANY else cid
    s = socket.socket(socket.AF_VSOCK, socket.SOCK_STREAM)
    s.bind((cid, port))
    s.listen(128)
    return s
