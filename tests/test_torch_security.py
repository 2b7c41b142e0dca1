"""Fleet mTLS: certificate issuance, enrollment and the mTLS peer planes.

The port's counterpart of ``tests/test_security.py``'s
``TestCertIssuanceAndTLSRPC`` and ``TestFleetMTLS`` (its auth and
OAuth classes are ported in ``tests/test_torch_auth.py``), plus what ties
the two packages together: the issuance messages' bytes, fleet leaves
from both packages' managers over one CA directory, the HTTP data plane
over mTLS across packages (the RPC planes cannot talk to each other:
known difference 2), the renewal loop, the state handoff's HMAC, the
key's file mode and the enrollment's error.
"""

import asyncio
import hashlib
import hmac
import os
import socket
import ssl
import stat

import numpy as np
import pytest

from dragonfly2_tpu.common import cryptoshim as ref_shim

if not ref_shim.install():
    pytest.skip("no openssl binary", allow_module_level=True)

import dragonfly2_tpu.daemon.pex as ref_pex  # noqa: E402
import dragonfly2_tpu.idl.messages as ref_msg  # noqa: E402
from dragonfly2_tpu.daemon.piece_downloader import \
    PieceDownloader as RefPieceDownloader  # noqa: E402
from dragonfly2_tpu.daemon.upload_server import \
    UploadServer as RefUploadServer  # noqa: E402
from dragonfly2_tpu.idl import dumps as ref_dumps  # noqa: E402
from dragonfly2_tpu.manager.server import Manager as RefManager  # noqa
from dragonfly2_tpu.manager.server import \
    ManagerConfig as RefManagerConfig  # noqa: E402
from dragonfly2_tpu.rpc.security import \
    obtain_certificate as ref_obtain  # noqa: E402
from dragonfly2_tpu.scheduler import Scheduler as RefScheduler  # noqa
from dragonfly2_tpu.scheduler import \
    SchedulerConfig as RefSchedulerConfig  # noqa: E402
from dragonfly2_tpu.storage.manager import \
    StorageConfig as RefStorageConfig  # noqa: E402
from dragonfly2_tpu.storage.manager import \
    StorageManager as RefStorageManager  # noqa: E402
from dragonfly2_tpu.storage.metadata import \
    TaskMetadata as RefTaskMetadata  # noqa: E402
import dragonfly2_tpu_torch.daemon.pex as port_pex  # noqa: E402
import dragonfly2_tpu_torch.idl.messages as port_msg  # noqa: E402
from dragonfly2_tpu_torch.common import cryptoshim  # noqa: E402
from dragonfly2_tpu_torch.common.certs import generate_ca  # noqa: E402
from dragonfly2_tpu_torch.common.errors import DFError  # noqa: E402
from dragonfly2_tpu_torch.daemon.config import (DaemonConfig,  # noqa: E402
                                                SecurityConfig,
                                                StorageSection)
from dragonfly2_tpu_torch.daemon.daemon import Daemon  # noqa: E402
from dragonfly2_tpu_torch.daemon.piece_downloader import \
    PieceDownloader  # noqa: E402
from dragonfly2_tpu_torch.daemon.upload_server import \
    UploadServer  # noqa: E402
from dragonfly2_tpu_torch.idl.base import dumps as port_dumps  # noqa: E402
from dragonfly2_tpu_torch.idl.messages import (  # noqa: E402
    CertificateRequest, DownloadRequest, Empty, GetSchedulerStateResponse)
from dragonfly2_tpu_torch.manager.server import (Manager,  # noqa: E402
                                                 ManagerConfig)
from dragonfly2_tpu_torch.manager.service import \
    MAX_CERT_VALIDITY_S  # noqa: E402
from dragonfly2_tpu_torch.rpc.client import (Channel,  # noqa: E402
                                             ServiceClient)
from dragonfly2_tpu_torch.rpc.security import \
    obtain_certificate  # noqa: E402
from dragonfly2_tpu_torch.rpc.server import (RPCServer,  # noqa: E402
                                             ServiceDef, TLSOptions)
from dragonfly2_tpu_torch.scheduler.config import \
    SchedulerConfig  # noqa: E402
from dragonfly2_tpu_torch.scheduler.server import Scheduler  # noqa: E402
from dragonfly2_tpu_torch.storage.manager import (  # noqa: E402
    StorageConfig, StorageManager)
from dragonfly2_tpu_torch.storage.metadata import TaskMetadata  # noqa
from test_torch_relay import scripted  # noqa: E402

LIMIT_S = 90


def run(coro, limit: float = LIMIT_S):
    return asyncio.run(asyncio.wait_for(coro, limit))


async def start_manager(workdir, **kw) -> Manager:
    m = Manager(ManagerConfig(listen_ip="127.0.0.1", workdir=str(workdir),
                              **kw))
    await m.start()
    return m


def new_key() -> tuple[bytes, bytes]:
    key = cryptoshim.generate_private_key()
    return key.pem, key.public_pem()


def handshake(cert: str, key: str, ca: str, host: str = "127.0.0.1",
              *, client: tuple[str, str] | None = None,
              require_client: bool = False) -> dict:
    """A TLS handshake in memory (``ssl.MemoryBIO``): a server with
    ``cert``/``key``, a client that trusts ``ca`` and checks ``host``.
    Returns the client's view of the server certificate; a refused
    handshake raises ``ssl.SSLError``."""
    sctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    sctx.load_cert_chain(cert, key)
    if require_client:
        sctx.load_verify_locations(cafile=ca)
        sctx.verify_mode = ssl.CERT_REQUIRED
    cctx = ssl.create_default_context(cafile=ca)
    if client is not None:
        cctx.load_cert_chain(*client)
    bios = [ssl.MemoryBIO() for _ in range(4)]
    srv = sctx.wrap_bio(bios[0], bios[1], server_side=True)
    cli = cctx.wrap_bio(bios[2], bios[3], server_hostname=host)
    done = [False, False]
    for _ in range(20):
        for i, side in enumerate((cli, srv)):
            if not done[i]:
                try:
                    side.do_handshake()
                    done[i] = True
                except ssl.SSLWantReadError:
                    pass
        # client out -> server in, server out -> client in
        bios[0].write(bios[3].read())
        bios[2].write(bios[1].read())
        if all(done):
            # TLS 1.3: the server's verdict on the client's certificate
            # reaches the client with the first application record
            cli.write(b"x")
            bios[0].write(bios[3].read())
            srv.read(1)
            return cli.getpeercert()
    raise AssertionError("handshake did not finish")


def sans(cert_pem: bytes, tmp_path) -> set:
    """The certificate's subjectAltName values, as ``ssl`` reads them."""
    path = tmp_path / "san-probe.crt"
    path.write_bytes(cert_pem)
    return {v for _, v in ssl._ssl._test_decode_cert(str(path))
            ["subjectAltName"]}


# ------------------------------------------- messages and the manager


def test_issuance_messages_dump_the_references_bytes():
    fields = dict(public_key_pem=b"-----BEGIN PUBLIC KEY-----\nx\n",
                  hosts=["10.0.0.9", "peer.test"], validity_s=3600,
                  token="tok")
    for kw in ({}, fields):
        assert port_dumps(port_msg.CertificateRequest(**kw)) == \
            ref_dumps(ref_msg.CertificateRequest(**kw))
    for kw in ({}, {"cert_pem": b"c" * 40, "ca_cert_pem": b"a" * 40}):
        assert port_dumps(port_msg.CertificateResponse(**kw)) == \
            ref_dumps(ref_msg.CertificateResponse(**kw))


class TestCertIssuanceAndTLSRPC:
    def test_issue_certificate_and_tls_roundtrip(self, tmp_path):
        """The fleet-security loop: a peer makes a key pair, the manager
        signs the public half, and an RPC server and client talk over
        TLS with the issued certificate."""
        async def main():
            m = await start_manager(tmp_path, issue_certs=True)
            try:
                key_pem, pub_pem = await asyncio.to_thread(new_key)
                ch = Channel(f"127.0.0.1:{m.port}")
                mc = ServiceClient(ch, "df.manager.Manager")
                # without the issuance token: refused
                with pytest.raises(DFError):
                    await mc.unary("IssueCertificate", CertificateRequest(
                        public_key_pem=pub_pem, hosts=["127.0.0.1"]))
                resp = await mc.unary("IssueCertificate", CertificateRequest(
                    public_key_pem=pub_pem, hosts=["127.0.0.1", "peer.test"],
                    token=m.issue_token))
                # no hosts: INVALID_ARGUMENT
                with pytest.raises(DFError) as err:
                    await mc.unary("IssueCertificate", CertificateRequest(
                        public_key_pem=pub_pem, token=m.issue_token))
                await ch.close()
                assert "public_key_pem and hosts required" in str(err.value)
                assert b"BEGIN CERTIFICATE" in resp.cert_pem
                cert_p, key_p = tmp_path / "peer.crt", tmp_path / "peer.key"
                ca_p = tmp_path / "fleet-ca.crt"
                cert_p.write_bytes(resp.cert_pem)
                ca_p.write_bytes(resp.ca_cert_pem)
                key_p.write_bytes(key_pem)
                srv = RPCServer("127.0.0.1:0",
                                tls=TLSOptions(str(cert_p), str(key_p)))

                async def ping(req, ctx):
                    return Empty()

                svc = ServiceDef("df.test.Ping")
                svc.unary_unary("Ping", ping)
                srv.register(svc)
                await srv.start()
                try:
                    tls_ch = Channel(f"127.0.0.1:{srv.port}",
                                     tls_ca=str(ca_p))
                    out = await ServiceClient(tls_ch, "df.test.Ping").unary(
                        "Ping", Empty())
                    assert isinstance(out, Empty)
                    await tls_ch.close()
                    # a client trusting a different CA is refused
                    other_ca, _ = generate_ca("other CA")
                    other_p = tmp_path / "other-ca.crt"
                    other_p.write_bytes(other_ca)
                    bad_ch = Channel(f"127.0.0.1:{srv.port}",
                                     tls_ca=str(other_p))
                    with pytest.raises(Exception):
                        await asyncio.wait_for(ServiceClient(
                            bad_ch, "df.test.Ping").unary("Ping", Empty()),
                            10)
                    await bad_ch.close()
                    # the name override: the leaf names peer.test
                    named = Channel(f"127.0.0.1:{srv.port}",
                                    tls_ca=str(ca_p),
                                    tls_server_name="peer.test")
                    assert isinstance(await ServiceClient(
                        named, "df.test.Ping").unary("Ping", Empty()), Empty)
                    await named.close()
                    wrong = Channel(f"127.0.0.1:{srv.port}",
                                    tls_ca=str(ca_p),
                                    tls_server_name="other.test")
                    with pytest.raises(DFError):
                        await ServiceClient(wrong, "df.test.Ping",
                                            max_attempts=1).unary(
                            "Ping", Empty(), timeout=10)
                    await wrong.close()
                finally:
                    await srv.stop(0.2)
                return resp.cert_pem
            finally:
                await m.stop()

        cert_pem = run(main())
        assert sans(cert_pem, tmp_path) == {"127.0.0.1", "peer.test"}

    def test_validity_is_capped_and_the_token_persists(self, tmp_path):
        """A request for more than ``MAX_CERT_VALIDITY_S`` gets the cap;
        the token is made once, kept 0600, and read back by a restarted
        manager; no ``issue_certs``: issuance is refused."""
        async def main():
            m = await start_manager(tmp_path, issue_certs=True)
            try:
                _, pub = await asyncio.to_thread(new_key)
                resp = await m.service.issue_certificate(CertificateRequest(
                    public_key_pem=pub, hosts=["127.0.0.1"],
                    token=m.issue_token, validity_s=10 * MAX_CERT_VALIDITY_S),
                    None)
                token = m.issue_token
            finally:
                await m.stop()
            m2 = await start_manager(tmp_path, issue_certs=True)
            token2 = m2.issue_token
            await m2.stop()
            plain = await start_manager(tmp_path / "plain")
            try:
                with pytest.raises(DFError, match="not enabled"):
                    await plain.service.issue_certificate(
                        CertificateRequest(public_key_pem=pub,
                                           hosts=["h"], token=token), None)
            finally:
                await plain.stop()
            return resp.cert_pem, token, token2

        cert_pem, token, token2 = run(main())
        assert token == token2 and token
        mode = stat.S_IMODE(os.stat(tmp_path / "issuer.token").st_mode)
        assert mode == 0o600
        path = tmp_path / "capped.crt"
        path.write_bytes(cert_pem)
        dec = ssl._ssl._test_decode_cert(str(path))
        days = (ssl.cert_time_to_seconds(dec["notAfter"])
                - ssl.cert_time_to_seconds(dec["notBefore"])) / 86400
        # backdated an hour, as the reference's
        assert abs(days - (MAX_CERT_VALIDITY_S + 3600) / 86400) < 1e-3


def test_fleet_leaves_of_both_managers_verify_against_one_ca(tmp_path):
    """A reference manager and a port manager share one workdir: the port
    loads the reference's ``manager-ca`` and ``issuer.token``, and each
    manager's fleet leaf verifies under ``ssl`` against that CA, as a
    server and as a client certificate."""
    async def main():
        ref = RefManager(RefManagerConfig(listen_ip="127.0.0.1",
                                          workdir=str(tmp_path),
                                          issue_certs=True))
        await ref.start()
        try:
            port = await start_manager(tmp_path, issue_certs=True)
            try:
                assert port.issue_token == ref.issue_token
                ref_paths = await ref_obtain(
                    [f"127.0.0.1:{ref.port}"], hosts=["127.0.0.1", "r.test"],
                    token=ref.issue_token, out_dir=str(tmp_path / "r"))
                port_paths = await obtain_certificate(
                    [f"127.0.0.1:{port.port}"],
                    hosts=["127.0.0.1", "p.test"], token=port.issue_token,
                    out_dir=str(tmp_path / "p"))
                return ref_paths, port_paths, port.ca_cert_path
            finally:
                await port.stop()
        finally:
            await ref.stop()

    ref_paths, port_paths, ca_path = run(main())
    ca = (tmp_path / "manager-ca" / "proxy-ca.crt").read_bytes()
    assert ca_path == str(tmp_path / "manager-ca" / "proxy-ca.crt")
    for cert, key, got_ca in (ref_paths, port_paths):
        assert open(got_ca, "rb").read().strip() == ca.strip()
        for host in ("127.0.0.1",):
            assert handshake(cert, key, ca_path, host)["subject"]
        # each leaf as the other's client certificate
    handshake(ref_paths[0], ref_paths[1], ca_path,
              client=port_paths[:2], require_client=True)
    handshake(port_paths[0], port_paths[1], ca_path,
              client=ref_paths[:2], require_client=True)
    with pytest.raises(ssl.SSLError):
        handshake(port_paths[0], port_paths[1], ca_path, "other.test")


def test_enrollment_writes_the_key_0600_and_names_the_last_error(tmp_path):
    async def main():
        m = await start_manager(tmp_path, issue_certs=True)
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                dead = f"127.0.0.1:{s.getsockname()[1]}"
            paths = await obtain_certificate(
                [dead, f"127.0.0.1:{m.port}"], hosts=["127.0.0.1"],
                token=m.issue_token, out_dir=str(tmp_path / "ok"))
            with pytest.raises(RuntimeError) as err:
                await obtain_certificate(
                    [dead, f"127.0.0.1:{m.port}"], hosts=["127.0.0.1"],
                    token="wrong", out_dir=str(tmp_path / "bad"))
            return paths, str(err.value)
        finally:
            await m.stop()

    (cert, key, ca), err = run(main())
    assert [os.path.basename(p) for p in (cert, key, ca)] == \
        ["peer.crt", "peer.key", "fleet-ca.crt"]
    assert stat.S_IMODE(os.stat(key).st_mode) == 0o600
    assert b"PRIVATE KEY" in open(key, "rb").read()
    assert err.startswith("certificate enrollment failed:")
    assert "bad issuance token" in err
    assert not os.path.exists(tmp_path / "bad")


# --------------------------------------------------- the daemon's planes


def security_daemon(tmp_path, name: str, m: Manager, **sec) -> Daemon:
    return Daemon(DaemonConfig(
        workdir=str(tmp_path / name), host_ip="127.0.0.1",
        listen_ip="127.0.0.1", hostname=name, device="cpu",
        manager_addresses=[f"127.0.0.1:{m.port}"],
        security=SecurityConfig(enabled=True, issue_token=m.issue_token,
                                **sec),
        storage=StorageSection(gc_interval_s=3600)))


class TestFleetMTLS:
    def test_daemon_peer_plane_over_issued_certs(self, tmp_path):
        """Two daemons enroll with the manager, serve their peer planes
        over the issued leaves, and complete a P2P transfer whose sync
        stream and piece GETs ride mTLS; plaintext and certless clients
        are refused on both planes."""
        data = np.random.default_rng(5).integers(
            0, 256, 5 << 20, dtype=np.uint8).tobytes()
        src = tmp_path / "f.bin"
        src.write_bytes(data)

        async def main():
            m = await start_manager(tmp_path / "mgr", issue_certs=True)
            a = security_daemon(tmp_path, "tls-a", m)
            b = security_daemon(tmp_path, "tls-b", m)
            await a.start()
            await b.start()
            try:
                async for _ in a.ptm.start_file_task(DownloadRequest(
                        url=src.as_uri(), output=str(tmp_path / "a.out"),
                        timeout_s=60.0)):
                    pass
                task_id = next(iter(a.ptm._conductors))
                apeer = a.ptm.conductor(task_id).peer_id
                b.ptm.scheduler = scripted(lambda: [(a, apeer, False)])
                async for _ in b.ptm.start_file_task(DownloadRequest(
                        url=src.as_uri(), output=str(tmp_path / "b.out"),
                        disable_back_source=True, timeout_s=60.0)):
                    pass
                b_out = (tmp_path / "b.out").read_bytes()
                # a plaintext client cannot speak to A's TLS RPC port
                ch = Channel(f"127.0.0.1:{a.rpc.port}")
                with pytest.raises(Exception):
                    await ServiceClient(ch, "df.health.Health",
                                        max_attempts=1).unary(
                        "Check", Empty(), timeout=10)
                await ch.close()
                # a TLS client without a fleet client certificate is
                # refused too: mutual authentication
                ca = a._peer_tls_ca
                ch2 = Channel(f"127.0.0.1:{a.rpc.port}", tls_ca=ca)
                with pytest.raises(Exception):
                    await ServiceClient(ch2, "df.health.Health",
                                        max_attempts=1).unary(
                        "Check", Empty(), timeout=10)
                await ch2.close()
                # with the fleet client certificate it answers
                ch3 = Channel(f"127.0.0.1:{a.rpc.port}", tls_ca=ca,
                              tls_cert=b._peer_tls_cert,
                              tls_key=b._peer_tls_key)
                assert isinstance(await ServiceClient(
                    ch3, "df.health.Health").unary("Check", Empty(),
                                                   timeout=10), Empty)
                await ch3.close()
                # the data plane is HTTPS and refuses certless clients
                cctx = ssl.create_default_context(cafile=ca)
                cctx.check_hostname = False
                with pytest.raises(OSError):
                    reader, writer = await asyncio.open_connection(
                        "127.0.0.1", a.upload_server.port, ssl=cctx)
                    writer.write(b"GET /healthy HTTP/1.1\r\nHost: a\r\n\r\n")
                    got = await asyncio.wait_for(reader.read(), 10)
                    writer.close()
                    if not got:
                        raise ConnectionResetError("closed")
                # and plaintext
                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", a.upload_server.port)
                writer.write(b"GET /healthy HTTP/1.1\r\nHost: a\r\n\r\n")
                plain = await asyncio.wait_for(reader.read(), 10)
                writer.close()
                return (b_out, plain, a.upload_server.mux, a.rpc.mux,
                        b._downloader.scheme, b.pex.tls,
                        b.flight_recorder.get(task_id).summarize())
            finally:
                await b.stop()
                await a.stop()
                await m.stop()

        b_out, plain, up_mux, rpc_mux, scheme, pex_tls, flight = run(main())
        assert b_out == data
        assert not plain.startswith(b"HTTP/1.1 200")
        assert up_mux is None and rpc_mux is None       # force: no mux
        assert scheme == "https" and pex_tls is not None
        assert (flight["bytes_p2p"], flight["bytes_source"]) == (len(data), 0)

    def test_renewal_rewrites_the_files_and_stop_cancels_it(self, tmp_path,
                                                            monkeypatch):
        """The renewal loop re-enrolls at 2/3 of the validity (at least a
        minute; the sleep is patched): ``peer.crt`` and ``peer.key`` are
        rewritten in place, the listeners keep the leaf they bound, and
        ``stop`` cancels the task."""
        real_sleep = asyncio.sleep

        async def fast(delay, *args, **kw):
            return await real_sleep(0.05 if delay == 60 else delay,
                                    *args, **kw)

        async def main():
            m = await start_manager(tmp_path / "mgr", issue_certs=True)
            d = security_daemon(tmp_path, "renew", m, cert_validity_s=90)
            # the renewal task's first sleep starts inside start()
            monkeypatch.setattr(asyncio, "sleep", fast)
            first = None
            try:
                await d.start()
                cert = d._peer_tls_cert
                first = open(cert, "rb").read(), open(d._peer_tls_key,
                                                      "rb").read()
                for _ in range(200):
                    now = open(cert, "rb").read(), open(d._peer_tls_key,
                                                        "rb").read()
                    if now[0] != first[0] and now[1] != first[1]:
                        break
                    await real_sleep(0.05)
                monkeypatch.setattr(asyncio, "sleep", real_sleep)
                task = d._cert_renewal
                # the RPC port still serves the leaf it bound
                ch = Channel(f"127.0.0.1:{d.rpc.port}", tls_ca=d.fleet_ca,
                             tls_cert=cert, tls_key=d._peer_tls_key)
                ok = await ServiceClient(ch, "df.health.Health").unary(
                    "Check", Empty(), timeout=10)
                await ch.close()
            finally:
                monkeypatch.setattr(asyncio, "sleep", real_sleep)
                await d.stop()
                await m.stop()
            return first, now, task, d._cert_renewal, ok

        first, now, task, after, ok = run(main())
        assert now[0] != first[0] and now[1] != first[1]
        assert task.cancelled() and after is None
        assert isinstance(ok, Empty)

    def test_rollout_policy_fronts_both_planes_with_a_mux(self, tmp_path):
        """``security.tls_policy: default`` puts both peer planes behind
        the mux; the daemon's own downloader and channels speak TLS
        through it, and a plaintext health check passes until the flip."""
        async def main():
            m = await start_manager(tmp_path / "mgr", issue_certs=True)
            d = security_daemon(tmp_path, "roll", m, tls_policy="default")
            await d.start()
            try:
                mux = (d.rpc.mux, d.upload_server.mux)
                ch = Channel(f"127.0.0.1:{d.rpc.port}")
                plain = await ServiceClient(ch, "df.health.Health").unary(
                    "Check", Empty(), timeout=10)
                d.rpc.mux.policy = d.upload_server.mux.policy = "force"
                # the established connection lives on
                again = await ServiceClient(ch, "df.health.Health").unary(
                    "Check", Empty(), timeout=10)
                await ch.close()
                fresh = Channel(f"127.0.0.1:{d.rpc.port}")
                with pytest.raises(DFError):
                    await ServiceClient(fresh, "df.health.Health",
                                        max_attempts=1).unary(
                        "Check", Empty(), timeout=10)
                await fresh.close()
                return mux, plain, again
            finally:
                await d.stop()
                await m.stop()

        (rpc_mux, up_mux), plain, again = run(main())
        assert rpc_mux is not None and up_mux is not None
        assert isinstance(plain, Empty) and isinstance(again, Empty)
        assert not os.path.exists(os.path.dirname(rpc_mux.plain_sock))


def test_pex_gossip_rides_mtls(tmp_path):
    """PEX digests travel over https with the daemon's leaf: an mTLS
    daemon's round exchanges with its mTLS peer, and the same round
    without the fleet client certificate exchanges nothing."""
    async def main():
        m = await start_manager(tmp_path / "mgr", issue_certs=True)
        a = security_daemon(tmp_path, "pex-a", m)
        b = security_daemon(tmp_path, "pex-b", m)
        for d in (a, b):
            d.pex.interval_s = 3600.0        # rounds are driven here
        await a.start()
        b.pex._bootstrap = [f"127.0.0.1:{a.upload_server.port}"]
        await b.start()
        try:
            secure = await b.pex.round()
            scheme = b.pex._scheme
            # the same plane without the leaf: plaintext to an mTLS port
            await b.pex._http.close()
            b.pex._http, b.pex.tls = None, None
            b.pex.peers.clear()
            plain = await b.pex.round()
            return secure, scheme, plain
        finally:
            await b.stop()
            await a.stop()
            await m.stop()

    secure, scheme, plain = run(main())
    assert (secure, scheme, plain) == (1, "https", 0)


# ------------------------------------------ the data plane, both packages

PIECE = 1 << 20
TASK = "d" * 64


def _stored(mgr, md_cls, data: bytes) -> None:
    ts = mgr.register_task(md_cls(
        task_id=TASK, url="file:///x", content_length=len(data),
        total_piece_count=2, piece_size=PIECE))
    for n in range(2):
        ts.write_piece(n, n * PIECE, data[n * PIECE:(n + 1) * PIECE])
    ts.mark_done(success=True)


def test_mtls_piece_fetch_across_packages(tmp_path, monkeypatch):
    """With fleet material from one CA: the reference's downloader
    fetches pieces from the port's mTLS upload server, and the port's
    from the reference's. The bytes are equal both ways (the port's
    server sends the 2 MiB span over TLS in eight 256 KiB reads), and a
    downloader without a client certificate is refused."""
    data = np.random.default_rng(9).integers(
        0, 256, 2 * PIECE, dtype=np.uint8).tobytes()
    monkeypatch.setattr(UploadServer, "TLS_CHUNK", 256 * 1024)

    async def main():
        m = await start_manager(tmp_path / "mgr", issue_certs=True)
        try:
            triples = [await obtain_certificate(
                [f"127.0.0.1:{m.port}"], hosts=["127.0.0.1", name],
                token=m.issue_token, out_dir=str(tmp_path / name))
                for name in ("port-srv", "ref-srv")]
        finally:
            await m.stop()
        port_mgr = StorageManager(StorageConfig(
            data_dir=str(tmp_path / "port")))
        ref_mgr = RefStorageManager(RefStorageConfig(
            data_dir=str(tmp_path / "ref"), gc_interval_s=3600))
        _stored(port_mgr, TaskMetadata, data)
        _stored(ref_mgr, RefTaskMetadata, data)
        port_srv = UploadServer(port_mgr, host="127.0.0.1")
        ref_srv = RefUploadServer(ref_mgr, host="127.0.0.1")
        port_srv.tls, ref_srv.tls = triples
        await port_srv.start()
        await ref_srv.start()
        # each side's client presents the other side's leaf
        port_dl = PieceDownloader(timeout_s=10, tls=triples[1])
        ref_dl = RefPieceDownloader(timeout_s=10, tls=triples[0])
        got = []
        try:
            for dl, srv, msg in ((ref_dl, port_srv, ref_msg),
                                 (port_dl, ref_srv, port_msg)):
                pieces = [msg.PieceInfo(piece_num=n, range_start=n * PIECE,
                                        range_size=PIECE) for n in range(2)]
                buf, _ = await dl.download_span(
                    dst_addr=f"127.0.0.1:{srv.port}", task_id=TASK,
                    src_peer_id="peer-x", pieces=pieces)
                got.append(bytes(buf))
            certless = PieceDownloader(timeout_s=10)
            with pytest.raises(DFError) as err:
                await certless.download_span(
                    dst_addr=f"127.0.0.1:{port_srv.port}", task_id=TASK,
                    src_peer_id="peer-x", pieces=[port_msg.PieceInfo(
                        piece_num=0, range_start=0, range_size=PIECE)])
            await certless.close()
            return got, err.value.fail_code
        finally:
            await port_dl.close()
            await ref_dl.close()
            await port_srv.stop()
            await ref_srv.stop()

    got, fail_code = run(main())
    assert got == [data, data]
    assert fail_code in ("stall", "refused")


# ------------------------------------------------- the scheduler's half


def test_handoff_signature_equals_the_references_and_gates_the_import(
        tmp_path, monkeypatch):
    """The handoff blob's HMAC with the issuance token is the reference's
    in both packages; an import with a tampered signature is refused
    before the blob is read, an unsigned one is read when no token is
    set, as in the reference."""
    blob = port_pex.seal({"v": port_pex.DIGEST_VERSION})
    token = "fleet-token"
    port = Scheduler(SchedulerConfig(listen_ip="127.0.0.1",
                                     security_issue_token=token))
    ref = RefScheduler(RefSchedulerConfig(security_issue_token=token))
    want = hmac.new(token.encode(), blob, hashlib.sha256).hexdigest()
    assert port._handoff_signature(blob) == ref._handoff_signature(blob) \
        == want
    assert Scheduler(SchedulerConfig())._handoff_signature(blob) == ""

    class Stub:
        def __init__(self, signature):
            self.signature = signature

        async def get_scheduler_state(self, req):
            return GetSchedulerStateResponse(
                scheduler_id="other:1", blob=blob,
                signature=self.signature)

    def imports(sched, module, signature) -> int:
        read = []
        real = module.unseal
        monkeypatch.setattr(module, "unseal",
                            lambda b: read.append(b) or real(b))
        sched.manager = Stub(signature)
        run(sched._import_handoff(), 30)
        monkeypatch.setattr(module, "unseal", real)
        return len(read)

    for sched, module in ((port, port_pex), (ref, ref_pex)):
        assert imports(sched, module, want) == 1
        assert imports(sched, module, want[:-1] + "0") == 0
        assert imports(sched, module, "") == 0
    unsigned = Scheduler(SchedulerConfig(listen_ip="127.0.0.1"))
    assert imports(unsigned, port_pex, "") == 1


def test_scheduler_enrolls_and_triggers_seeds_over_mtls(tmp_path):
    """With ``security_issue_token`` and a manager, the scheduler's
    certificate lands under ``<workdir>/scheduler-tls`` and its seed
    client dials with the fleet material; a failed enrollment leaves the
    plaintext client, as in the reference."""
    async def main():
        m = await start_manager(tmp_path / "mgr", issue_certs=True)
        try:
            out = {}
            for name, token in (("good", m.issue_token), ("bad", "wrong")):
                s = Scheduler(SchedulerConfig(
                    listen_ip="127.0.0.1", advertise_ip="127.0.0.1",
                    manager_addresses=[f"127.0.0.1:{m.port}"],
                    security_issue_token=token,
                    workdir=str(tmp_path / name), statestore_handoff=False))
                await s.start()
                try:
                    pool = s.seed_client._channels
                    out[name] = (pool.tls_cert, pool.tls_ca)
                finally:
                    await s.stop()
            return out
        finally:
            await m.stop()

    out = run(main())
    cert, ca = out["good"]
    assert cert == str(tmp_path / "good" / "scheduler-tls" / "peer.crt")
    assert open(ca, "rb").read() == \
        (tmp_path / "mgr" / "manager-ca" / "proxy-ca.crt").read_bytes()
    assert out["bad"] == ("", "")
    assert not (tmp_path / "bad" / "scheduler-tls").exists()


def test_phase_21_rehearsal_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.phase_fleet`` at a 16 MB file with CPU sinks: the
    enrollment checks, L1 and L2 over mTLS from S, the refusals on S's
    planes, P and T through S2's muxes, the flip, the refused plaintext
    leecher and the mTLS leecher after it, with every check of the
    phase."""
    import subprocess

    import torch

    import chip_smoke

    real_run = subprocess.run

    def fake_run(args, *a, **kw):
        if args and args[0] == "nvidia-smi":
            return subprocess.CompletedProcess(args, 0,
                                               "CPU rehearsal, 0 W\n", "")
        return real_run(args, *a, **kw)

    real_cfg = chip_smoke.fleet_daemon_cfg
    monkeypatch.setattr(chip_smoke.subprocess, "run", fake_run)
    monkeypatch.setitem(chip_smoke.LLAMA3_8B, "vocab", 2000)
    # the leechers here land on the CPU; the child's daemons name it
    monkeypatch.setattr(chip_smoke, "fleet_daemon_cfg",
                        lambda *a, **kw: real_cfg(*a, **{"device": "cpu",
                                                         **kw}))
    os.makedirs(tmp_path / "deploy")
    header, nbytes = chip_smoke.safetensors_header(chip_smoke.deploy_layout())
    with open(tmp_path / "deploy" / "model-00004-of-00004.safetensors",
              "wb") as f:
        f.write(header)
        f.write(memoryview(chip_smoke.seeded_bytes(
            np.random.default_rng(0), nbytes)))
    lines = []
    monkeypatch.setattr(chip_smoke, "emit",
                        lambda phase, rec: lines.append((phase, rec)))
    chip_smoke.phase_fleet(str(tmp_path), torch.device("cpu"))
    (phase, rec), = lines
    assert phase == "phase 21 fleet"
    assert set(rec["pulls"]) == {"l1", "l2", "p", "t", "u"}
    assert rec["mux_before_flip"]["plain"] >= 2
    assert rec["mux_after_refused"]["plain_refused"] > \
        rec["mux_at_flip"]["plain_refused"]
    assert {"fleet-l1", "fleet-l2", "fleet-s", "fleet-s2",
            "scheduler:sched-fleet-s"} <= set(rec["enroll_s"])
