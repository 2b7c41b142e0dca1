"""The ``openssl`` CLI as the port's X.509 and EC P-256 toolkit.

Counterpart of ``dragonfly2_tpu/common/cryptoshim.py``. The reference's
shim stands in for the ``cryptography`` wheel: its ``install()``
registers a subset of the wheel's API under the wheel's module names in
``sys.modules``, and does nothing when the wheel imports. The port
imports torch, numpy and the standard library only, so its keys and
certificates always go through this module and the ``openssl`` binary,
wheel or no wheel, and nothing is registered in ``sys.modules``. It
keeps what ``common/certs.py`` needs, as plain functions: EC P-256 keys
in PKCS#8 PEM, a certificate signed by its own key or by a CA, and the
subject and issuer of a PEM certificate.

A certificate is built as the wheel builds it: its to-be-signed DER is
assembled here (validity to the second, from ``not_before`` to
``not_after``; a CN subject; the extensions given) and only its ECDSA
signature comes from ``openssl dgst``. No ``openssl`` config file is
written, so no name reaches OpenSSL's config parser (which would expand
``$ENV::NAME`` in it). Every call runs ``openssl`` processes: a key takes
two, a leaf (key, public half, signature) four, tens of milliseconds in
all.
"""

from __future__ import annotations

import base64
import datetime
import ipaddress
import os
import secrets
import subprocess
import tempfile

OPENSSL = "openssl"


def _run(args: list[str], data: bytes | None = None) -> bytes:
    proc = subprocess.run([OPENSSL] + args, input=data,
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    if proc.returncode != 0:
        raise RuntimeError(
            f"openssl {' '.join(args[:3])}... failed: "
            f"{proc.stderr.decode(errors='replace').strip()}")
    return proc.stdout


class PrivateKey:
    """An EC P-256 private key as PKCS#8 PEM."""

    def __init__(self, pem: bytes):
        self.pem = pem

    def public_pem(self) -> bytes:
        """The public half, SubjectPublicKeyInfo PEM."""
        with tempfile.TemporaryDirectory(prefix="dfshim-") as d:
            path = os.path.join(d, "k.pem")
            with open(path, "wb") as f:
                f.write(self.pem)
            return _run(["pkey", "-in", path, "-pubout"])


def generate_private_key() -> PrivateKey:
    raw = _run(["ecparam", "-name", "prime256v1", "-genkey", "-noout"])
    return PrivateKey(_run(["pkcs8", "-topk8", "-nocrypt"], raw))


def load_public_key(pem: bytes) -> bytes:
    """A public key PEM from a peer, normalized to SubjectPublicKeyInfo
    PEM: a malformed one fails here, before it is signed into a
    certificate."""
    return _run(["pkey", "-pubin", "-pubout"], pem)


def load_private_key(pem: bytes) -> PrivateKey:
    """Any unencrypted private key PEM (PKCS#8 or traditional), normalized
    to PKCS#8: a malformed one fails here, not at signing."""
    return PrivateKey(_run(["pkcs8", "-topk8", "-nocrypt"], pem))


class Certificate:
    """A PEM certificate; ``subject`` and ``issuer`` are RFC 2253 strings,
    so a parsed issuer equals its CA's parsed subject exactly."""

    def __init__(self, pem: bytes):
        self.pem = pem
        self._names: tuple[str, str] | None = None

    def _parse_names(self) -> tuple[str, str]:
        if self._names is None:
            out = _run(["x509", "-noout", "-subject", "-issuer",
                        "-nameopt", "RFC2253"], self.pem).decode()
            names = dict(line.split("=", 1) for line in out.splitlines()
                         if "=" in line)
            self._names = (names.get("subject", "").strip(),
                           names.get("issuer", "").strip())
        return self._names

    @property
    def subject(self) -> str:
        return self._parse_names()[0]

    @property
    def issuer(self) -> str:
        return self._parse_names()[1]


def load_certificate(pem: bytes) -> Certificate:
    """Round-trip through openssl: the PEM must parse, and trailing
    garbage is dropped."""
    return Certificate(_run(["x509"], pem))


def random_serial_number() -> int:
    """Positive and below 2^159, as X.509 serials must be."""
    return secrets.randbits(158) | 1


# -- DER, as much of it as a certificate needs ---------------------------

def _der(tag: int, body: bytes) -> bytes:
    n = len(body)
    if n < 0x80:
        return bytes([tag, n]) + body
    size = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([tag, 0x80 | len(size)]) + size + body


def _seq(*parts: bytes) -> bytes:
    return _der(0x30, b"".join(parts))


def _int(n: int) -> bytes:
    """A non-negative INTEGER (a leading zero byte keeps it positive)."""
    return _der(0x02, n.to_bytes(n.bit_length() // 8 + 1, "big"))


def _oid(dotted: str) -> bytes:
    arcs = [int(a) for a in dotted.split(".")]
    body = bytearray([40 * arcs[0] + arcs[1]])
    for arc in arcs[2:]:
        septets = [arc & 0x7F]
        arc >>= 7
        while arc:
            septets.append(0x80 | (arc & 0x7F))
            arc >>= 7
        body += bytes(reversed(septets))
    return _der(0x06, bytes(body))


def _time(dt: datetime.datetime) -> bytes:
    """UTCTime through 2049, GeneralizedTime after (RFC 5280 4.1.2.5)."""
    dt = dt.astimezone(datetime.timezone.utc)
    if dt.year < 2050:
        return _der(0x17, dt.strftime("%y%m%d%H%M%SZ").encode())
    return _der(0x18, dt.strftime("%Y%m%d%H%M%SZ").encode())


_TRUE = b"\x01\x01\xff"
_ECDSA_SHA256 = _seq(_oid("1.2.840.10045.4.3.2"))
_KEY_USAGE_BITS = ("digitalSignature", "nonRepudiation", "keyEncipherment",
                   "dataEncipherment", "keyAgreement", "keyCertSign",
                   "cRLSign", "encipherOnly", "decipherOnly")


def _name(common_name: str) -> bytes:
    """A Name holding one CN, as a UTF8String (what the wheel writes)."""
    return _seq(_der(0x31, _seq(_oid("2.5.4.3"),
                                _der(0x0C, common_name.encode()))))


def _extension(oid: str, critical: bool, value: bytes) -> bytes:
    return _seq(_oid(oid), _TRUE if critical else b"", _der(0x04, value))


def ca_constraints(path_length: int) -> bytes:
    """basicConstraints CA:TRUE with ``path_length``, critical."""
    return _extension("2.5.29.19", True, _seq(_TRUE, _int(path_length)))


def key_usage(*usages: str) -> bytes:
    """keyUsage with the named bits (``digitalSignature``, ...), critical."""
    bits = sorted(_KEY_USAGE_BITS.index(u) for u in usages)
    value = 0
    for b in bits:
        value |= 1 << (15 - b)
    nbytes = bits[-1] // 8 + 1
    unused = 8 * nbytes - 1 - bits[-1]
    body = bytes([unused]) + (value >> (8 * (2 - nbytes))).to_bytes(
        nbytes, "big")
    return _extension("2.5.29.15", True, _der(0x03, body))


def subject_alt_names(hosts: list[str]) -> bytes:
    """subjectAltName, not critical: an IP literal as an iPAddress, any
    other host as a dNSName (ASCII, as given)."""
    names = []
    for h in hosts:
        try:
            names.append(_der(0x87, ipaddress.ip_address(h).packed))
        except ValueError:
            names.append(_der(0x82, h.encode("ascii")))
    return _extension("2.5.29.17", False, _seq(*names))


def _read(der: bytes, i: int) -> tuple[int, int]:
    """The element at ``i``: (start of its body, end of it)."""
    n, i = der[i + 1], i + 2
    if n & 0x80:
        k = n & 0x7F
        n, i = int.from_bytes(der[i:i + k], "big"), i + k
    return i, i + n


def _pem_body(pem: bytes) -> bytes:
    return base64.b64decode(b"".join(
        line for line in pem.strip().splitlines()
        if not line.startswith(b"-----")))


def _subject_der(cert_pem: bytes) -> bytes:
    """The subject Name of a certificate, as its DER: a leaf's issuer must
    be these bytes exactly."""
    der = _pem_body(cert_pem)
    i, _ = _read(der, 0)             # Certificate
    i, _ = _read(der, i)             # TBSCertificate
    if der[i] == 0xA0:               # [0] version
        i = _read(der, i)[1]
    for _field in ("serial", "signature", "issuer", "validity"):
        i = _read(der, i)[1]
    return der[i:_read(der, i)[1]]


def sign_certificate(common_name: str, public_pem: bytes,
                     signing_key: PrivateKey, issuer: Certificate | None,
                     not_before: datetime.datetime,
                     not_after: datetime.datetime,
                     extensions: list[bytes]) -> Certificate:
    """A v3 certificate for ``public_pem`` named ``common_name``, valid
    from ``not_before`` to ``not_after``, with ``extensions`` (from
    ``ca_constraints``, ``key_usage``, ``subject_alt_names``), signed
    ECDSA-SHA256. Self-signed when ``issuer`` is None (``public_pem`` must
    then be the signing key's), else signed by ``signing_key`` as the CA
    ``issuer``."""
    if issuer is None:
        if signing_key.public_pem() != public_pem:
            raise ValueError("a self-signed certificate must carry "
                             "the signing key's public half")
        issuer_name = _name(common_name)
    else:
        issuer_name = _subject_der(issuer.pem)
    tbs = _seq(_der(0xA0, _int(2)), _int(random_serial_number()),
               _ECDSA_SHA256, issuer_name,
               _seq(_time(not_before), _time(not_after)),
               _name(common_name), _pem_body(public_pem),
               _der(0xA3, _seq(*extensions)))
    with tempfile.TemporaryDirectory(prefix="dfshim-") as d:
        key_p = os.path.join(d, "sign.key")
        with open(key_p, "wb") as f:
            f.write(signing_key.pem)
        signature = _run(["dgst", "-sha256", "-sign", key_p], tbs)
    der = _seq(tbs, _ECDSA_SHA256, _der(0x03, b"\x00" + signature))
    b64 = base64.b64encode(der).decode()
    return Certificate((
        "-----BEGIN CERTIFICATE-----\n"
        + "".join(b64[i:i + 64] + "\n" for i in range(0, len(b64), 64))
        + "-----END CERTIFICATE-----\n").encode())
