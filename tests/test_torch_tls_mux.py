"""The TLS/plaintext mux and port-range listeners, through both packages.

The port's counterpart of ``tests/test_tls_mux.py`` (reference
``pkg/rpc/mux.go`` and ``credential.go``: TLS and plaintext on one port,
with the default/prefer/force rollout policies) and of
``tests/test_rpc.py::test_port_range_listen``. Each case runs on the
port and on the reference (its grpc and aiohttp stack runs here), with
each package's own certificates, server and client; the HTTP data-plane
case drives both upload servers with one standard-library client. The
port's cases also check ``df_rpc_mux_conns_total`` by kind (``tls``,
``plain``, ``plain_refused``) and count.
"""

import asyncio
import http.client
import os
import socket
import ssl
import types

import pytest

from dragonfly2_tpu.common import cryptoshim as ref_shim

if not ref_shim.install():
    pytest.skip("no openssl binary", allow_module_level=True)

import dragonfly2_tpu.common.certs as ref_certs  # noqa: E402
import dragonfly2_tpu.idl.messages as ref_msg  # noqa: E402
import dragonfly2_tpu.rpc.client as ref_client  # noqa: E402
import dragonfly2_tpu.rpc.listen as ref_listen  # noqa: E402
import dragonfly2_tpu.rpc.mux as ref_mux  # noqa: E402
import dragonfly2_tpu.rpc.server as ref_server  # noqa: E402
import dragonfly2_tpu.storage.manager as ref_storage  # noqa: E402
import dragonfly2_tpu.storage.metadata as ref_meta  # noqa: E402
from dragonfly2_tpu.daemon.upload_server import \
    UploadServer as RefUploadServer  # noqa: E402
import dragonfly2_tpu_torch.common.certs as port_certs  # noqa: E402
import dragonfly2_tpu_torch.idl.messages as port_msg  # noqa: E402
import dragonfly2_tpu_torch.rpc.client as port_client  # noqa: E402
import dragonfly2_tpu_torch.rpc.listen as port_listen  # noqa: E402
import dragonfly2_tpu_torch.rpc.mux as port_mux  # noqa: E402
import dragonfly2_tpu_torch.rpc.server as port_server  # noqa: E402
import dragonfly2_tpu_torch.storage.manager as port_storage  # noqa: E402
import dragonfly2_tpu_torch.storage.metadata as port_meta  # noqa: E402
from dragonfly2_tpu_torch.daemon.upload_server import \
    UploadServer as PortUploadServer  # noqa: E402

PKG = {
    "reference": types.SimpleNamespace(
        certs=ref_certs, msg=ref_msg, client=ref_client, listen=ref_listen,
        mux=ref_mux, server=ref_server, storage=ref_storage, meta=ref_meta,
        UploadServer=RefUploadServer),
    "port": types.SimpleNamespace(
        certs=port_certs, msg=port_msg, client=port_client,
        listen=port_listen, mux=port_mux, server=port_server,
        storage=port_storage, meta=port_meta,
        UploadServer=PortUploadServer),
}
KINDS = ("tls", "plain", "plain_refused")
LIMIT_S = 60


@pytest.fixture(params=sorted(PKG))
def pkg(request):
    p = PKG[request.param]
    p.name = request.param
    return p


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def conns(p) -> dict:
    """``df_rpc_mux_conns_total`` by kind."""
    return {k: p.mux._conns.value(k) for k in KINDS}


def delta(p, before: dict) -> dict:
    now = conns(p)
    return {k: now[k] - before[k] for k in KINDS}


def material(p, tmp_path, name: str = "srv"):
    """(cert_path, key_path, ca_path): a fresh 127.0.0.1 leaf named
    ``name`` from the package's issuer rooted at tmp_path (one CA per
    tmp_path)."""
    issuer = p.certs.CertIssuer(str(tmp_path / f"ca-{p.name}"))
    cert_pem, key_pem, _exp = issuer._mint("127.0.0.1")
    cert_p = tmp_path / f"{p.name}-{name}.crt"
    key_p = tmp_path / f"{p.name}-{name}.key"
    cert_p.write_bytes(cert_pem)
    key_p.write_bytes(key_pem)
    return str(cert_p), str(key_p), issuer.ca_cert_path


def channel(p, addr: str, *, tls_ca: str = "", fresh: bool = False):
    """A channel of the package. ``fresh``: its own connections (a new
    fleet member is a new process; grpc's global subchannel pool would
    otherwise ride another channel's connection)."""
    if fresh and p.name == "reference":
        return p.client.Channel(addr, tls_ca=tls_ca, options=[
            ("grpc.use_local_subchannel_pool", 1)])
    return p.client.Channel(addr, tls_ca=tls_ca)


def ping_service(p):
    async def ping(req, ctx):
        return p.msg.Empty()

    svc = p.server.ServiceDef("df.test.Ping")
    svc.unary_unary("Ping", ping)
    return svc


async def ping(p, ch, *, attempts: int = 3, timeout: float = 10):
    client = p.client.ServiceClient(ch, "df.test.Ping", max_attempts=attempts)
    return await client.unary("Ping", p.msg.Empty(), timeout=timeout)


async def start_server(p, tmp_path, policy: str, address="127.0.0.1:0"):
    cert, key, ca = material(p, tmp_path)
    srv = p.server.RPCServer(address, tls=p.server.TLSOptions(cert, key),
                             tls_policy=policy)
    srv.register(ping_service(p))
    await srv.start()
    return srv, ca


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def test_plaintext_fleet_upgrades_to_tls_with_no_dropped_rpcs(pkg, tmp_path):
    p = pkg

    async def main():
        srv, ca = await start_server(p, tmp_path, "default")
        addr = f"127.0.0.1:{srv.port}"
        before = conns(p)
        try:
            # a live plaintext fleet member: its connection is made now
            plain_a = channel(p, addr)
            assert isinstance(await ping(p, plain_a), p.msg.Empty)
            # a TLS client on the same port, at the same time
            tls_c = channel(p, addr, tls_ca=ca)
            assert isinstance(await ping(p, tls_c), p.msg.Empty)
            counted = delta(p, before)
            # the rollout is complete: retire plaintext at runtime
            srv.mux.policy = "force"
            # the established plaintext connection keeps serving
            for _ in range(3):
                assert isinstance(await ping(p, plain_a), p.msg.Empty)
            # ... but a new plaintext connection is refused
            plain_b = channel(p, addr, fresh=True)
            with pytest.raises(Exception):
                await ping(p, plain_b, attempts=1, timeout=3)
            await plain_b.close()
            # TLS connects under force
            tls_d = channel(p, addr, tls_ca=ca)
            assert isinstance(await ping(p, tls_d), p.msg.Empty)
            await asyncio.gather(plain_a.close(), tls_c.close(),
                                 tls_d.close())
            return counted, delta(p, before)
        finally:
            await srv.stop()

    counted, after = run(main())
    assert counted == {"tls": 1, "plain": 1, "plain_refused": 0}
    assert after["tls"] == 2 and after["plain"] == 1
    if p.name == "port":
        assert after["plain_refused"] == 1
    else:
        # grpc may redial within the call's deadline
        assert after["plain_refused"] >= 1


def test_prefer_policy_serves_both(pkg, tmp_path):
    p = pkg

    async def main():
        srv, ca = await start_server(p, tmp_path, "prefer")
        addr = f"127.0.0.1:{srv.port}"
        before = conns(p)
        try:
            for ch in (channel(p, addr), channel(p, addr, tls_ca=ca)):
                assert isinstance(await ping(p, ch), p.msg.Empty)
                await ch.close()
            return delta(p, before), srv.mux._warned_plain
        finally:
            await srv.stop()

    counted, warned = run(main())
    assert counted == {"tls": 1, "plain": 1, "plain_refused": 0}
    assert warned


def test_force_policy_skips_mux_entirely(pkg, tmp_path):
    """force at construction: a plain TLS port, no front listener."""
    p = pkg

    async def main():
        srv, ca = await start_server(p, tmp_path, "force")
        before = conns(p)
        try:
            assert srv.mux is None
            ch = channel(p, f"127.0.0.1:{srv.port}", tls_ca=ca)
            assert isinstance(await ping(p, ch), p.msg.Empty)
            await ch.close()
            plain = channel(p, f"127.0.0.1:{srv.port}", fresh=True)
            with pytest.raises(Exception):
                await ping(p, plain, attempts=1, timeout=3)
            await plain.close()
            return delta(p, before)
        finally:
            await srv.stop()

    assert run(main()) == {"tls": 0, "plain": 0, "plain_refused": 0}


def test_mux_with_port_range_spec(pkg, tmp_path):
    """A port-range address composes with the mux: the front binds the
    first free port of the range (a pre-bound socket handed over)."""
    p = pkg

    async def main():
        base = free_port()
        srv, ca = await start_server(p, tmp_path, "default",
                                     address=f"127.0.0.1:{base}-{base + 10}")
        try:
            assert base <= srv.port <= base + 10
            for ch in (channel(p, f"127.0.0.1:{srv.port}"),
                       channel(p, f"127.0.0.1:{srv.port}", tls_ca=ca)):
                assert isinstance(await ping(p, ch), p.msg.Empty)
                await ch.close()
        finally:
            await srv.stop()

    run(main())


def test_port_range_listen(pkg):
    """Reference ``pkg/rpc/server_listen.go`` ListenWithPortRange: a
    plaintext server binds the first free port of its range."""
    p = pkg

    async def main():
        base = free_port()
        # hold the range's first port, so the server must move on
        blocker = socket.socket()
        blocker.bind(("127.0.0.1", base))
        blocker.listen(1)
        try:
            srv = p.server.RPCServer(f"127.0.0.1:{base}-{base + 20}")
            srv.register(ping_service(p))
            await srv.start()
            try:
                assert base < srv.port <= base + 20
                ch = channel(p, f"127.0.0.1:{srv.port}")
                assert isinstance(await ping(p, ch), p.msg.Empty)
                await ch.close()
            finally:
                await srv.stop()
        finally:
            blocker.close()

    run(main())


def test_port_spec_and_vsock_helpers_match(pkg):
    """``parse_port_spec`` reads singles and ranges as the reference's;
    ``vsock_listener`` binds AF_VSOCK or raises OSError, never TCP."""
    p = pkg
    for spec, want in (("8000", (8000, 8000)), ("8000-8010", (8000, 8010)),
                       ("0", (0, 0))):
        assert p.listen.parse_port_spec(spec) == want \
            == ref_listen.parse_port_spec(spec)
    with pytest.raises(ValueError):
        p.listen.parse_port_spec("9-8")
    try:
        s = p.listen.vsock_listener(free_port())
    except OSError:
        pass
    else:
        assert s.family == socket.AF_VSOCK
        s.close()
    # an occupied single-port range is an OSError naming the range
    with socket.socket() as held:
        held.bind(("127.0.0.1", 0))
        held.listen(1)
        port = held.getsockname()[1]
        with pytest.raises(OSError, match=f"127.0.0.1:{port}-{port}"):
            p.listen.bind_port_in_range("127.0.0.1", port, port)


def _get(port: int, path: str, ctx: ssl.SSLContext | None = None,
         *, timeout: float = 10) -> tuple[int, bytes]:
    """One GET with a standard-library client (https with ``ctx``)."""
    if ctx is None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    else:
        conn = http.client.HTTPSConnection("127.0.0.1", port, context=ctx,
                                           timeout=timeout)
    try:
        conn.request("GET", path, headers={"Range": f"bytes=0-{SIZE - 1}",
                                           "Connection": "close"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


SIZE = 256 * 1024


def test_upload_data_plane_muxes_plain_and_mtls(pkg, tmp_path):
    """The piece plane rolls out the same way: one upload port serves
    plaintext HTTP and mTLS HTTPS during the rollout; the flip to force
    refuses new plaintext while mTLS (client certificate required) keeps
    serving, and a TLS client without a fleet certificate is refused."""
    p = pkg
    payload = os.urandom(SIZE)
    task = "a" * 64

    async def main():
        mgr = p.storage.StorageManager(p.storage.StorageConfig(
            data_dir=str(tmp_path / f"s-{p.name}"), task_ttl_s=3600))
        ts = mgr.register_task(p.meta.TaskMetadata(
            task_id=task, url="http://o/x", content_length=SIZE,
            total_piece_count=1, piece_size=SIZE))
        ts.write_piece(0, 0, payload)
        ts.mark_done(success=True)
        cert, key, ca = material(p, tmp_path)
        # a distinct client leaf from the same CA: the server requires a
        # fleet-signed client certificate (mTLS is mutual)
        ccert, ckey, _ = material(p, tmp_path, name="client")
        srv = p.UploadServer(mgr, host="127.0.0.1")
        srv.tls = (cert, key, ca)
        srv.tls_policy = "default"
        await srv.start()
        path = f"/download/{task[:3]}/{task}?peerId=p"
        ctx = ssl.create_default_context(cafile=ca)
        ctx.check_hostname = False
        ctx.load_cert_chain(ccert, ckey)
        nocert = ssl.create_default_context(cafile=ca)
        nocert.check_hostname = False
        before = conns(p)
        try:
            got = [await asyncio.to_thread(_get, srv.port, path),
                   await asyncio.to_thread(_get, srv.port, path, ctx)]
            with pytest.raises((OSError, http.client.HTTPException)):
                await asyncio.to_thread(_get, srv.port, path, nocert)
            counted = delta(p, before)
            srv.mux.policy = "force"
            with pytest.raises((OSError, http.client.HTTPException)):
                await asyncio.to_thread(_get, srv.port, path, timeout=5)
            got.append(await asyncio.to_thread(_get, srv.port, path, ctx))
            return got, counted, delta(p, before)
        finally:
            await srv.stop()
            assert not os.path.exists(os.path.dirname(srv.mux.plain_sock))

    got, counted, after = run(main())
    assert got == [(206, payload)] * 3
    assert counted == {"tls": 2, "plain": 1, "plain_refused": 0}
    assert after == {"tls": 3, "plain": 1, "plain_refused": 1}


def test_unknown_policy_rejected(pkg, tmp_path):
    """A bad policy is refused when the server is built, before any
    socket or backend directory exists."""
    p = pkg
    made = set(os.listdir(tmp_path))

    async def main():
        with pytest.raises(ValueError):
            await start_server(p, tmp_path, "sometimes")

    run(main())
    with pytest.raises(ValueError):
        p.mux.MuxListener("127.0.0.1", 0, plain_sock="a", tls_sock="b",
                          policy="sometimes")
    assert not [f for f in set(os.listdir(tmp_path)) - made
                if f.startswith("dfmux-")]
