"""Fleet certificate enrollment: obtain a manager-signed certificate.

Counterpart of ``dragonfly2_tpu/rpc/security.py`` (reference
``pkg/issuer`` and the certify integration,
``client/daemon/daemon.go:367-458``): the caller generates an EC P-256
key pair locally, submits only its public half to the manager's
``IssueCertificate`` (gated by the issuance token), and serves its own
listeners with the leaf it gets back. Private keys never cross the wire.
The key is made by ``common/cryptoshim.py`` (``openssl`` processes) on a
worker thread, never on the event loop.
"""

from __future__ import annotations

import asyncio
import logging
import os

from ..common import cryptoshim
from ..idl.messages import CertificateRequest
from .client import Channel, ServiceClient

log = logging.getLogger("df.rpc.security")


def _new_key() -> tuple[bytes, bytes]:
    """(private PKCS#8 PEM, public SubjectPublicKeyInfo PEM)."""
    key = cryptoshim.generate_private_key()
    return key.pem, key.public_pem()


def _write(out_dir: str, cert_pem: bytes, key_pem: bytes,
           ca_pem: bytes) -> tuple[str, str, str]:
    os.makedirs(out_dir, exist_ok=True)
    cert_path = os.path.join(out_dir, "peer.crt")
    key_path = os.path.join(out_dir, "peer.key")
    ca_path = os.path.join(out_dir, "fleet-ca.crt")
    with open(cert_path, "wb") as f:
        f.write(cert_pem)
    fd = os.open(key_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "wb") as f:
        f.write(key_pem)
    with open(ca_path, "wb") as f:
        f.write(ca_pem)
    return cert_path, key_path, ca_path


async def obtain_certificate(manager_addresses: list[str], *,
                             hosts: list[str], token: str,
                             out_dir: str, validity_s: int = 24 * 3600,
                             tls_ca: str = "") -> tuple[str, str, str]:
    """Enroll with the first reachable manager; returns (cert_path,
    key_path, ca_path) written under ``out_dir`` (the key at mode 0600).
    Every manager failing is a RuntimeError naming the last error."""
    key_pem, pub_pem = await asyncio.to_thread(_new_key)
    last_exc: Exception | None = None
    for addr in manager_addresses:
        ch = Channel(addr, tls_ca=tls_ca)
        try:
            mc = ServiceClient(ch, "df.manager.Manager")
            resp = await mc.unary("IssueCertificate", CertificateRequest(
                public_key_pem=pub_pem, hosts=hosts, token=token,
                validity_s=validity_s), timeout=30.0)
            paths = await asyncio.to_thread(
                _write, out_dir, resp.cert_pem, key_pem, resp.ca_cert_pem)
            log.info("fleet certificate issued by %s for %s", addr, hosts)
            return paths
        except Exception as exc:  # noqa: BLE001 - try the next manager
            last_exc = exc
        finally:
            await ch.close()
    raise RuntimeError(f"certificate enrollment failed: {last_exc}")
