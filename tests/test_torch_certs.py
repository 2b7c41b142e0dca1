"""The port's certificate issuer against the reference's.

* The reference's ``TestCerts`` (``tests/test_proxy_tls.py``) through both
  packages: a leaf chains to its CA and verifies with the standard
  library's ``ssl`` in a real handshake, a concurrent first mint for one
  host loads no mismatched pair, and ``generate_ca`` round-trips into an
  issuer that mints an IP-address leaf.
* The port's own: the auto-generated CA and its 0600 key, the leaf cache
  bounded at ``CACHE_MAX`` (512, the reference's) with LRU and expiry
  eviction, a hostile name kept inside the leaves directory, a name that
  is no host name refused before anything is minted (the reference mints
  it as given), validity windows equal to the reference's (backdated an
  hour), a CA made by either package's ``generate_ca`` loading in the
  other's ``CertIssuer`` with leaves that verify against it, and the
  port's shim never putting a ``cryptography`` module into
  ``sys.modules``.

The reference mints with the ``cryptography`` wheel where it imports (its
shim otherwise); the port always runs the ``openssl`` binary. Tolerances
are exact.
"""

import concurrent.futures
import datetime
import os
import shutil
import ssl
import subprocess
import sys

import pytest

from dragonfly2_tpu.common import certs as ref_certs
from dragonfly2_tpu.common import cryptoshim as ref_shim
from dragonfly2_tpu_torch.common import certs as port_certs
from dragonfly2_tpu_torch.common import cryptoshim

if not ref_shim.install() or not shutil.which("openssl"):
    pytest.skip("no openssl binary", allow_module_level=True)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"reference": ref_certs, "port": port_certs}


def handshake(server_ctx: ssl.SSLContext, ca_path: str, name: str, *,
              check_name: bool = True) -> dict:
    """A TLS handshake in memory between ``server_ctx`` and a client that
    trusts only ``ca_path``, sends ``name`` and checks it unless
    ``check_name`` is false; the leaf the client verified."""
    client_ctx = ssl.create_default_context(cafile=ca_path)
    client_ctx.check_hostname = check_name
    c_in, c_out, s_in, s_out = (ssl.MemoryBIO() for _ in range(4))
    client = client_ctx.wrap_bio(c_in, c_out, server_hostname=name)
    server = server_ctx.wrap_bio(s_in, s_out, server_side=True)
    done = set()
    for _ in range(20):
        for side, obj in (("client", client), ("server", server)):
            if side in done:
                continue
            try:
                obj.do_handshake()
                done.add(side)
            except ssl.SSLWantReadError:
                pass
        s_in.write(c_out.read())
        c_in.write(s_out.read())
        if done == {"client", "server"}:
            return client.getpeercert()
    raise AssertionError("handshake did not finish")


def sans(cert: dict) -> set:
    return {v for _, v in cert.get("subjectAltName", ())}


# ------------------------------------------------ the reference's TestCerts

@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_ca_and_leaf_chain_verify(tmp_path, pkg):
    certs = PKGS[pkg]
    issuer = certs.CertIssuer(str(tmp_path))
    ctx = issuer.server_context("example.test")
    assert ctx is issuer.server_context("example.test")     # cached
    # the leaf files are transient: client-controlled names cost no disk
    assert not os.listdir(tmp_path / "leaves")
    assert "example.test" in sans(handshake(ctx, issuer.ca_cert_path,
                                            "example.test"))
    cert_pem, _key, not_after = issuer._mint("example.test")
    leaf = cryptoshim.load_certificate(cert_pem)
    ca = cryptoshim.load_certificate(open(issuer.ca_cert_path, "rb").read())
    assert leaf.issuer == ca.subject == "CN=dragonfly2-tpu proxy CA"
    assert leaf.subject == "CN=example.test"
    life = not_after - datetime.datetime.now(datetime.timezone.utc)
    assert datetime.timedelta(hours=23, minutes=59) < life \
        <= datetime.timedelta(hours=24)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_concurrent_mint_no_race(tmp_path, pkg, monkeypatch):
    """Parallel first connections for one host mint once and never load
    a mismatched cert/key pair (single-flight under the host's lock)."""
    issuer = PKGS[pkg].CertIssuer(str(tmp_path))
    mints = []
    real = issuer._mint
    monkeypatch.setattr(issuer, "_mint",
                        lambda host: mints.append(host) or real(host))
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        ctxs = list(pool.map(lambda i: issuer.server_context("race.test"),
                             range(200)))
    assert mints == ["race.test"]
    assert len({id(c) for c in ctxs}) == 1
    assert "race.test" in sans(handshake(ctxs[0], issuer.ca_cert_path,
                                         "race.test"))


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_generate_ca_roundtrip(tmp_path, pkg):
    certs = PKGS[pkg]
    cert_pem, key_pem = certs.generate_ca()
    p, k = tmp_path / "ca.crt", tmp_path / "ca.key"
    p.write_bytes(cert_pem)
    k.write_bytes(key_pem)
    issuer = certs.CertIssuer(str(tmp_path), ca_cert_path=str(p),
                              ca_key_path=str(k))
    ctx = issuer.server_context("10.0.0.1")              # IP SAN path
    assert sans(handshake(ctx, str(p), "10.0.0.1")) == {"10.0.0.1"}
    assert not (tmp_path / "proxy-ca.crt").exists()


# ------------------------------------------------------------ the port's

@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_the_auto_ca_lands_in_the_workdir_with_its_key_at_0600(tmp_path,
                                                               pkg):
    issuer = PKGS[pkg].CertIssuer(str(tmp_path / "w"))
    assert issuer.ca_cert_path == str(tmp_path / "w" / "proxy-ca.crt")
    assert issuer.ca_key_path == str(tmp_path / "w" / "proxy-ca.key")
    assert os.stat(issuer.ca_key_path).st_mode & 0o777 == 0o600
    ca = cryptoshim.load_certificate(open(issuer.ca_cert_path, "rb").read())
    assert ca.subject == ca.issuer
    # a second issuer on the workdir keeps the CA
    before = open(issuer.ca_cert_path, "rb").read()
    PKGS[pkg].CertIssuer(str(tmp_path / "w"))
    assert open(issuer.ca_cert_path, "rb").read() == before


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_the_leaf_cache_is_bounded_with_lru_and_expiry(tmp_path, pkg,
                                                       monkeypatch):
    """At ``CACHE_MAX`` (512, the reference's) the least recently used
    host goes first; an expired leaf is minted again. One leaf's
    material stands in for every host's, so 520 hosts load fast."""
    certs = PKGS[pkg]
    assert certs.CertIssuer.CACHE_MAX == ref_certs.CertIssuer.CACHE_MAX \
        == 512
    issuer = certs.CertIssuer(str(tmp_path))
    material = issuer._mint("any.test")
    mints = []
    monkeypatch.setattr(issuer, "_mint",
                        lambda host: mints.append(host) or material)
    hosts = [f"h{i}.test" for i in range(512)]
    for h in hosts:
        issuer.server_context(h)
    issuer.server_context("h0.test")             # a hit: h0 is now newest
    issuer.server_context("new.test")            # evicts h1, the oldest
    assert len(issuer._cache) == 512
    assert "h0.test" in issuer._cache and "h1.test" not in issuer._cache
    assert len(issuer._mint_locks) == 512
    assert mints == hosts + ["new.test"]
    ctx, _ = issuer._cache["h2.test"]
    issuer._cache["h2.test"] = (ctx, datetime.datetime.now(
        datetime.timezone.utc) - datetime.timedelta(seconds=1))
    assert issuer.server_context("h2.test") is not ctx
    assert mints[-1] == "h2.test"
    assert len(issuer._cache) == 512


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("host", ["../proxy-ca", "../../etc/x",
                                  "a/b\\c..", ".."])
def test_a_hostile_name_stays_inside_the_leaves_directory(tmp_path, pkg,
                                                          host, monkeypatch):
    issuer = PKGS[pkg].CertIssuer(str(tmp_path / "w"))
    ca = [open(p, "rb").read() for p in (issuer.ca_cert_path,
                                         issuer.ca_key_path)]
    material = issuer._mint("any.test")
    monkeypatch.setattr(issuer, "_mint", lambda host: material)
    written = []            # the leaf key's path (the cert shares its base)
    real_open = os.open

    def spy(path, *a, **kw):
        written.append(os.path.realpath(path))
        return real_open(path, *a, **kw)

    monkeypatch.setattr(os, "open", spy)
    # the port refuses a name with '/' or '\\' outright
    refused = pkg == "port" and not port_certs.valid_host(host)
    if refused:
        with pytest.raises(ValueError):
            issuer.server_context(host)
        assert written == [] and host not in issuer._mint_locks
        assert sorted(os.listdir(tmp_path / "w")) == ["proxy-ca.crt",
                                                       "proxy-ca.key"]
    else:
        issuer.server_context(host)
        leaves = os.path.realpath(tmp_path / "w" / "leaves")
        assert len(written) == 1 and os.path.dirname(written[0]) == leaves
        assert sorted(os.listdir(tmp_path / "w")) == [
            "leaves", "proxy-ca.crt", "proxy-ca.key"]
        assert os.listdir(tmp_path / "w" / "leaves") == []
    assert [open(p, "rb").read() for p in (issuer.ca_cert_path,
                                           issuer.ca_key_path)] == ca


@pytest.mark.parametrize("host,ok", [
    ("registry.test", True), ("*.registry.test", True), ("10.0.0.1", True),
    ("::1", True), ("a-b.c-d", True), ("a" * 253, True), ("a" * 254, False),
    ("$ENV::HOME", False), ("${ENV::HOME}", False),
    ("a.test,DNS:evil.test", False), ("a.test\nb", False), ("", False),
    ("a.*.test", False), ("reg istry", False), ("reg_istry", False)])
def test_only_ip_literals_and_dns_names_are_host_names(host, ok):
    assert port_certs.valid_host(host) is ok


@pytest.mark.parametrize("name", ["$ENV::HOME", "${ENV::HOME}",
                                  "a.test,DNS:evil.test"])
def test_a_name_that_is_no_host_is_refused_before_minting(tmp_path, name,
                                                          monkeypatch):
    """OpenSSL's config parser expands ``$ENV::NAME``, and a comma adds a
    SAN: the port refuses such a name in ``server_context`` and in
    ``sign_public_key`` before any key, lock or file is made. The
    reference mints it as given; neither leaf carries an environment
    variable's value."""
    monkeypatch.setenv("DF_CERT_SECRET", "s3cr3t-value")
    name = name.replace("HOME", "DF_CERT_SECRET")
    issuer = port_certs.CertIssuer(str(tmp_path / "port"))
    mints = []
    monkeypatch.setattr(issuer, "_mint", lambda host: mints.append(host))
    with pytest.raises(ValueError):
        issuer.server_context(name)
    key = cryptoshim.generate_private_key()
    with pytest.raises(ValueError):
        issuer.sign_public_key(key.public_pem(), ["ok.test", name])
    assert mints == [] and issuer._mint_locks == {}
    ref = ref_certs.CertIssuer(str(tmp_path / "ref"))
    got = sans(handshake(ref.server_context(name), ref.ca_cert_path, name,
                         check_name=False))
    assert got == {name} and not any("s3cr3t" in v for v in got)


def _dates(pem: bytes) -> tuple[float, float]:
    out = subprocess.run(["openssl", "x509", "-noout", "-startdate",
                          "-enddate"], input=pem, capture_output=True,
                         check=True).stdout.decode()
    d = dict(line.split("=", 1) for line in out.splitlines())
    return (ssl.cert_time_to_seconds(d["notBefore"]),
            ssl.cert_time_to_seconds(d["notAfter"]))


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_validity_windows_equal_the_references(tmp_path, pkg):
    """The CA and a leaf start an hour before they were minted (a client
    whose clock is behind still accepts them) and end ``CA_TTL`` and
    ``LEAF_TTL`` after, to the second, as the reference's wheel path
    makes them."""
    certs = PKGS[pkg]
    t0 = datetime.datetime.now(datetime.timezone.utc).timestamp()
    issuer = certs.CertIssuer(str(tmp_path))
    leaf_pem = issuer._mint("registry.test")[0]
    t1 = datetime.datetime.now(datetime.timezone.utc).timestamp()
    hour = 3600
    for pem, ttl in ((open(issuer.ca_cert_path, "rb").read(), certs.CA_TTL),
                     (leaf_pem, certs.LEAF_TTL)):
        before, after = _dates(pem)
        assert int(t0) - hour - 1 <= before <= t1 - hour
        assert after - before == ttl.total_seconds() + hour
    assert (certs.CA_TTL, certs.LEAF_TTL) == (ref_certs.CA_TTL,
                                              ref_certs.LEAF_TTL)


@pytest.mark.parametrize("maker,loader", [("reference", "port"),
                                          ("port", "reference")])
def test_a_ca_from_either_package_loads_in_the_others_issuer(tmp_path,
                                                             maker, loader):
    cert_pem, key_pem = PKGS[maker].generate_ca()
    p, k = tmp_path / "ca.crt", tmp_path / "ca.key"
    p.write_bytes(cert_pem)
    k.write_bytes(key_pem)
    issuer = PKGS[loader].CertIssuer(str(tmp_path), ca_cert_path=str(p),
                                     ca_key_path=str(k))
    for name in ("registry.test", "127.0.0.1"):
        assert name in sans(handshake(issuer.server_context(name), str(p),
                                      name))


def test_the_ports_shim_puts_no_cryptography_module_in_sys_modules(
        tmp_path):
    """In a fresh interpreter, the port's issuer mints and verifies with
    no ``cryptography`` module imported or registered."""
    code = (
        "import sys, ssl\n"
        "from dragonfly2_tpu_torch.common.certs import CertIssuer\n"
        f"i = CertIssuer({str(tmp_path)!r})\n"
        "i.server_context('registry.test')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('cryptography', 'dragonfly2_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
