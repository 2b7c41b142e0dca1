"""Certificate authority and per-host leaf issuance for HTTPS interception.

Counterpart of ``dragonfly2_tpu/common/certs.py`` (reference
``client/daemon/proxy/cert.go:37 genLeafCert``): the proxy MITMs CONNECT
and SNI traffic by minting a short-lived leaf certificate for the
requested host, signed by a CA the fleet's clients trust (containerd is
pointed at the CA file). As in the reference: EC P-256 leaves, a CA
generated into the daemon's workdir on first use (``proxy-ca.crt`` and
``proxy-ca.key``, the key at mode 0600), leaves that live 24 h, cached per
host with expiry and LRU eviction at ``CACHE_MAX``, and a per-host
single-flight mint, and the validity backdated an hour so that a client
whose clock is behind still accepts a fresh certificate. The port's keys
and certificates always go through ``cryptoshim`` (the ``openssl``
binary), never through the ``cryptography`` wheel, and nothing is
registered in ``sys.modules``. Unlike the reference, a name that is not
an IP literal or a DNS name is refused before anything is minted: CONNECT
targets and SNI names come from clients.
"""

from __future__ import annotations

import datetime
import ipaddress
import logging
import os
import re
import ssl
import threading

from . import cryptoshim

log = logging.getLogger("df.proxy.certs")

LEAF_TTL = datetime.timedelta(hours=24)
CA_TTL = datetime.timedelta(days=3650)
BACKDATE = datetime.timedelta(hours=1)

# letters, digits, '-' and '.', with an optional leading '*.'
_DNS_NAME = re.compile(r"(\*\.)?[A-Za-z0-9.-]+")


def valid_host(host: str) -> bool:
    """Whether ``host`` may be named in a certificate: an IP literal, or a
    DNS name of at most 253 characters."""
    try:
        ipaddress.ip_address(host)
        return True
    except ValueError:
        return len(host) <= 253 and _DNS_NAME.fullmatch(host) is not None


def generate_ca(common_name: str = "dragonfly2-tpu proxy CA"
                ) -> tuple[bytes, bytes]:
    """Self-signed CA; returns (cert_pem, key_pem)."""
    key = cryptoshim.generate_private_key()
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = cryptoshim.sign_certificate(
        common_name, key.public_pem(), key, None, now - BACKDATE,
        now + CA_TTL,
        [cryptoshim.ca_constraints(0),
         cryptoshim.key_usage("digitalSignature", "keyCertSign",
                              "cRLSign")])
    return cert.pem, key.pem


class CertIssuer:
    """CA-backed leaf minting with a per-host cache.

    ``ca_cert_path``/``ca_key_path`` empty: the CA is generated under
    ``workdir`` (``proxy-ca.crt`` / ``proxy-ca.key``) so operators can
    point clients at the .crt.
    """

    def __init__(self, workdir: str, *, ca_cert_path: str = "",
                 ca_key_path: str = ""):
        self.workdir = workdir
        if not ca_cert_path:
            ca_cert_path = os.path.join(workdir, "proxy-ca.crt")
            ca_key_path = os.path.join(workdir, "proxy-ca.key")
            if not os.path.exists(ca_cert_path):
                os.makedirs(workdir, exist_ok=True)
                cert_pem, key_pem = generate_ca()
                with open(ca_cert_path, "wb") as f:
                    f.write(cert_pem)
                with open(ca_key_path, "wb") as f:
                    f.write(key_pem)
                os.chmod(ca_key_path, 0o600)
                log.info("generated proxy CA at %s", ca_cert_path)
        self.ca_cert_path = ca_cert_path
        self.ca_key_path = ca_key_path or ca_cert_path
        with open(ca_cert_path, "rb") as f:
            self.ca_cert = cryptoshim.load_certificate(f.read())
        with open(self.ca_key_path, "rb") as f:
            self.ca_key = cryptoshim.load_private_key(f.read())
        self._lock = threading.Lock()
        # host -> (ssl_ctx, not_after); insertion-ordered for LRU eviction
        self._cache: dict[str, tuple[ssl.SSLContext, datetime.datetime]] = {}
        # per-host single-flight: minting host B must not block a cache hit
        # for host A (the SNI callback runs server_context synchronously on
        # the event loop; a global mint lock would head-of-line block it)
        self._mint_locks: dict[str, threading.Lock] = {}

    # client-controlled names (CONNECT targets, raw SNI bytes) feed the
    # cache: bound it, or a client looping random names grows memory and
    # CPU without limit
    CACHE_MAX = 512

    def sign_public_key(self, public_pem: bytes, hosts: list[str],
                        *, ttl: datetime.timedelta = LEAF_TTL) -> bytes:
        """Sign a leaf for a key whose private half the caller keeps (the
        manager's fleet certificates, ROADMAP item 6c, also sign here).
        A host that ``valid_host`` refuses is a ValueError."""
        bad = [h for h in hosts if not valid_host(h)]
        if bad:
            raise ValueError(f"not a host name: {bad[0]!r}")
        now = datetime.datetime.now(datetime.timezone.utc)
        return cryptoshim.sign_certificate(
            hosts[0] if hosts else "peer", public_pem, self.ca_key,
            self.ca_cert, now - BACKDATE, now + ttl,
            [cryptoshim.subject_alt_names(hosts),
             cryptoshim.key_usage("digitalSignature", "keyEncipherment",
                                  "dataEncipherment", "keyAgreement")]).pem

    def _mint(self, host: str) -> tuple[bytes, bytes, datetime.datetime]:
        key = cryptoshim.generate_private_key()
        not_after = datetime.datetime.now(datetime.timezone.utc) + LEAF_TTL
        return (self.sign_public_key(key.public_pem(), [host]), key.pem,
                not_after)

    def server_context(self, host: str) -> ssl.SSLContext:
        """TLS server context presenting a CA-signed leaf for ``host``.

        Single-flight: mint, file write and load all happen under the
        host's lock; concurrent cache misses for one host (containerd
        opening parallel layer pulls) would otherwise interleave their
        writes to shared paths and load mismatched cert/key pairs. A host
        that ``valid_host`` refuses is a ValueError, before any lock or
        cache entry is made for it.
        """
        if not valid_host(host):
            raise ValueError(f"not a host name: {host!r}")
        now = datetime.datetime.now(datetime.timezone.utc)
        with self._lock:
            hit = self._cache.get(host)
            if hit is not None and now < hit[1]:
                self._cache[host] = self._cache.pop(host)   # LRU touch
                return hit[0]
            mint_lock = self._mint_locks.setdefault(host, threading.Lock())
        with mint_lock:
            # double-check: the racer that held the mint lock first filled it
            with self._lock:
                hit = self._cache.get(host)
                if hit is not None and now < hit[1]:
                    return hit[0]
            cert_pem, key_pem, not_after = self._mint(host)
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            # load_cert_chain wants files; they are transient (deleted the
            # moment the chain is loaded) so client-controlled names cost
            # no disk. The file name is sanitized (a name like
            # '../proxy-ca' must never escape the leaves directory) and
            # unique per thread so same-sanitization hosts cannot
            # interleave writes.
            leaf_dir = os.path.join(self.workdir, "leaves")
            os.makedirs(leaf_dir, exist_ok=True)
            safe = re.sub(r"[^A-Za-z0-9._-]", "_", host).strip(".")[:64]
            base = os.path.join(
                leaf_dir, f"leaf-{safe or 'host'}-{os.getpid()}-"
                          f"{threading.get_ident()}")
            try:
                with open(base + ".crt", "wb") as f:
                    f.write(cert_pem + self.ca_cert.pem)
                fd = os.open(base + ".key",
                             os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
                with os.fdopen(fd, "wb") as f:
                    f.write(key_pem)
                ctx.load_cert_chain(base + ".crt", base + ".key")
            finally:
                for suffix in (".crt", ".key"):
                    try:
                        os.unlink(base + suffix)
                    except OSError:
                        pass
            with self._lock:
                # expired and LRU eviction keep the cache bounded
                for key in [k for k, v in self._cache.items()
                            if now >= v[1]]:
                    del self._cache[key]
                    self._mint_locks.pop(key, None)
                while len(self._cache) >= self.CACHE_MAX:
                    evicted = next(iter(self._cache))
                    del self._cache[evicted]
                    self._mint_locks.pop(evicted, None)
                self._cache[host] = (ctx, not_after)
        log.debug("minted leaf cert for %s", host)
        return ctx
