"""The manager's REST auth, against the reference's.

* Ports of ``tests/test_security.py``'s ``TestManagerAuth`` (four
  tests), ``TestOAuthState`` and ``TestOAuthSignin``, and of
  ``tests/test_qos.py::test_rest_quota_429``, with the reference's
  assertions, on the port's manager. The OAuth provider is
  ``chip_smoke.OAuthStandIn`` (standard library, phase 24's stand-in),
  one for both packages; the sign-in is also run with the provider's
  token JSON sent as ``text/plain``, which the callback takes.
* Store: a user, PATs (live, revoked, expired), an OAuth user, a nonce
  and a provider written by either package's ``Store`` into one sqlite
  file read back and verify in the other's; the password hash and the
  token hash are the same functions.
* Authenticator: a session and an OAuth state minted by either package
  over one ``session.secret`` and database verify in the other's (a state
  once only); the identity the callback names a user after is picked as
  the reference picks it.
* REST: one table of requests gets the same status, JSON (timestamps
  and token bodies aside), text and ``Location`` query keys from both
  packages' managers: no credentials, bad tokens, a guest's write, a
  root's write, an unknown path and a 405 without credentials, users,
  PATs and providers, the OAuth 302; with auth off, the sign-in's 404.
  Malformed bodies on the new routes answer 400 in the port and 500 in
  the reference (ROADMAP known difference 8). The quota's 429 with
  ``Retry-After`` is the reference's over REST too.
* Bootstrap: ``root.password`` and ``session.secret`` are mode 0600; a
  second start, of either package, keeps both and bootstraps nothing.
* ``chip_smoke.py`` phase 24 rehearsed on the CPU at a 16 MB file.

Every test that starts servers runs under ``asyncio.wait_for``.
"""

import asyncio
import http.client
import json
import os
import subprocess
import sys
import time
from urllib.parse import parse_qs, urlsplit

import aiohttp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.manager.auth import Authenticator as RefAuthenticator
from dragonfly2_tpu.manager.rest import RestAPI as RefRestAPI
from dragonfly2_tpu.manager.server import Manager as RefManager
from dragonfly2_tpu.manager.server import ManagerConfig as RefManagerConfig
from dragonfly2_tpu.manager.store import Store as RefStore
from dragonfly2_tpu_torch.common.errors import DFError
from dragonfly2_tpu_torch.manager import Manager, ManagerConfig
from dragonfly2_tpu_torch.manager.auth import Authenticator
from dragonfly2_tpu_torch.manager.rest import RestAPI
from dragonfly2_tpu_torch.manager.store import Store

import chip_smoke
from chip_smoke import OAUTH_CODE, OAuthStandIn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 60.0
MANAGERS = {"reference": (RefManager, RefManagerConfig),
            "port": (Manager, ManagerConfig)}
STORES = {"reference": RefStore, "port": Store}
AUTHS = {"reference": RefAuthenticator, "port": Authenticator}


def _limited(coro, limit: float = LIMIT_S):
    return asyncio.run(asyncio.wait_for(coro, limit))


async def _mgr(tmp_path, pkg: str = "port", **kw):
    mgr_cls, cfg_cls = MANAGERS[pkg]
    m = mgr_cls(cfg_cls(listen_ip="127.0.0.1", workdir=str(tmp_path), **kw))
    await m.start()
    return m


def _root_password(tmp_path) -> str:
    with open(os.path.join(str(tmp_path), "root.password")) as f:
        return f.read().strip()


class _Provider:
    """``OAuthStandIn`` on a thread for the length of a ``with``."""

    def __init__(self, **kw):
        self.standin = OAuthStandIn(**kw)

    def __enter__(self) -> str:
        return f"http://127.0.0.1:{self.standin.start()}"

    def __exit__(self, *exc) -> None:
        self.standin.stop()


def _provider_body(pbase: str, name: str = "fakehub") -> dict:
    return {"name": name, "client_id": "cid", "client_secret": "csecret",
            "auth_url": f"{pbase}/authorize", "token_url": f"{pbase}/token",
            "userinfo_url": f"{pbase}/userinfo", "scopes": "read:user"}


# ------------------------------------------------- TestManagerAuth, ported

def test_unauthenticated_crud_rejected(tmp_path):
    async def main():
        m = await _mgr(tmp_path, auth_enabled=True)
        try:
            base = f"http://127.0.0.1:{m.rest.port}"
            async with aiohttp.ClientSession() as s:
                # health stays public
                async with s.get(f"{base}/healthy") as r:
                    assert r.status == 200
                # CRUD without credentials: 401
                async with s.get(f"{base}/api/v1/schedulers") as r:
                    assert r.status == 401
                async with s.post(f"{base}/api/v1/applications",
                                  json={"name": "x"}) as r:
                    assert r.status == 401
        finally:
            await m.stop()
    _limited(main())


def test_signin_session_and_rbac(tmp_path):
    async def main():
        m = await _mgr(tmp_path, auth_enabled=True)
        try:
            base = f"http://127.0.0.1:{m.rest.port}"
            password = _root_password(tmp_path)
            async with aiohttp.ClientSession() as s:
                async with s.post(f"{base}/api/v1/users/signin",
                                  json={"name": "root",
                                        "password": password}) as r:
                    assert r.status == 200
                    token = (await r.json())["token"]
                hdr = {"Authorization": f"Bearer {token}"}
                # root: read and write
                async with s.get(f"{base}/api/v1/schedulers",
                                 headers=hdr) as r:
                    assert r.status == 200
                async with s.post(f"{base}/api/v1/users",
                                  json={"name": "bob", "password": "pw",
                                        "role": "guest"},
                                  headers=hdr) as r:
                    assert r.status == 201
                # guest: read ok, write forbidden (RBAC)
                async with s.post(f"{base}/api/v1/users/signin",
                                  json={"name": "bob",
                                        "password": "pw"}) as r:
                    guest = (await r.json())["token"]
                ghdr = {"Authorization": f"Bearer {guest}"}
                async with s.get(f"{base}/api/v1/schedulers",
                                 headers=ghdr) as r:
                    assert r.status == 200
                async with s.post(f"{base}/api/v1/applications",
                                  json={"name": "app"}, headers=ghdr) as r:
                    assert r.status == 403
                # bad password: 401
                async with s.post(f"{base}/api/v1/users/signin",
                                  json={"name": "root",
                                        "password": "nope"}) as r:
                    assert r.status == 401
        finally:
            await m.stop()
    _limited(main())


def test_personal_access_tokens(tmp_path):
    async def main():
        m = await _mgr(tmp_path, auth_enabled=True)
        try:
            base = f"http://127.0.0.1:{m.rest.port}"
            password = _root_password(tmp_path)
            async with aiohttp.ClientSession() as s:
                async with s.post(f"{base}/api/v1/users/signin",
                                  json={"name": "root",
                                        "password": password}) as r:
                    hdr = {"Authorization":
                           f"Bearer {(await r.json())['token']}"}
                async with s.post(f"{base}/api/v1/personal-access-tokens",
                                  json={"label": "ci"}, headers=hdr) as r:
                    assert r.status == 201
                    pat = (await r.json())["token"]
                assert pat.startswith("dfp_")
                phdr = {"Authorization": f"Bearer {pat}"}
                async with s.get(f"{base}/api/v1/schedulers",
                                 headers=phdr) as r:
                    assert r.status == 200
                # revoke -> 401
                async with s.get(f"{base}/api/v1/personal-access-tokens",
                                 headers=hdr) as r:
                    pats = await r.json()
                async with s.delete(f"{base}/api/v1/personal-access-tokens/"
                                    f"{pats[0]['id']}", headers=hdr) as r:
                    assert r.status == 200
                async with s.get(f"{base}/api/v1/schedulers",
                                 headers=phdr) as r:
                    assert r.status == 401
        finally:
            await m.stop()
    _limited(main())


def test_pat_only_hash_stored():
    store = Store()
    uid = store.create_user("u", "pw")
    token = store.create_pat(uid)
    rows = store._rows("SELECT token_hash FROM personal_access_tokens")
    assert token not in rows[0]["token_hash"]   # a DB leak != a token leak
    assert store.pat_user(token)["name"] == "u"


# ------------------------------------------ TestOAuthState and the quota

def test_states_are_single_use(tmp_path):
    """A signed state is consumable once: a replay within its TTL is
    refused, and a callback for another provider does not burn it."""
    auth = Authenticator(Store(":memory:"))
    state = auth.mint_state("fakehub")
    assert auth.verify_state(state, "fakehub")
    assert not auth.verify_state(state, "fakehub")     # replay refused
    other = auth.mint_state("fakehub")
    assert not auth.verify_state(other, "evilhub")
    assert auth.verify_state(other, "fakehub")


def test_a_full_state_table_refuses_to_mint(monkeypatch):
    store = Store()
    monkeypatch.setattr(Store, "OAUTH_STATE_CAP", 2)
    auth = Authenticator(store)
    auth.mint_state("p")
    auth.mint_state("p")
    with pytest.raises(DFError) as exc:
        auth.mint_state("p")
    assert exc.value.code.name == "RESOURCE_EXHAUSTED"


def test_rest_quota_429(tmp_path):
    store = Store(str(tmp_path / "m.db"))
    auth = Authenticator(store, rest_quota_rps=2.0, rest_quota_burst=2.0)
    user = {"id": 1, "name": "noisy", "role": "root"}
    assert auth.check_quota(user) == 0.0
    assert auth.check_quota(user) == 0.0
    retry = auth.check_quota(user)
    assert retry >= 1.0
    # per identity: another tenant is unaffected
    assert auth.check_quota({"id": 2, "name": "calm", "role": "root"}) == 0.0
    # off by default
    assert Authenticator(store).check_quota(user) == 0.0


def test_quota_answers_over_rest_as_the_reference(tmp_path):
    """A burst of three by one identity and one by another, through each
    package's REST with the same quota: 200, 200, then 429 with
    ``Retry-After: 1``, and 200 for the other identity."""
    async def answers(pkg: str) -> list:
        store = STORES[pkg](str(tmp_path / f"{pkg}.db"))
        auth = AUTHS[pkg](store, rest_quota_rps=2.0, rest_quota_burst=2.0)
        api = (RefRestAPI(store, None, host="127.0.0.1", auth=auth)
               if pkg == "reference"
               else RestAPI(store, host="127.0.0.1", auth=auth))
        await api.start()
        try:
            pats = [store.create_pat(store.create_user(n, "pw", role="root"))
                    for n in ("noisy", "calm")]

            def burst():
                return [chip_smoke.auth_call(api.port, "GET",
                                             "/api/v1/schedulers", t)
                        for t in (pats[0], pats[0], pats[0], pats[1])]
            return [(s, h.get("retry-after"), b)
                    for s, h, b in await asyncio.to_thread(burst)]
        finally:
            await api.stop()
            store.close()

    got = {pkg: _limited(answers(pkg)) for pkg in STORES}
    assert got["port"] == got["reference"]
    assert got["port"] == [(200, None, []), (200, None, []),
                           (429, "1", {"error": "quota exceeded"}),
                           (200, None, [])]


# --------------------------------------------------- TestOAuthSignin, ported

@pytest.mark.parametrize("token_ctype", ["application/json; charset=utf-8",
                                         "text/plain"])
def test_full_flow_and_state_rejection(tmp_path, token_ctype):
    """The reference's flow against the stand-in: the provider
    registered, its secret never listed, the 302 with a signed state, the
    callback's session (a guest), a forged state and a bad code refused,
    an unknown provider 404; the token's JSON is taken whatever its
    ``Content-Type``."""
    async def main(pbase: str, standin: OAuthStandIn):
        m = await _mgr(tmp_path, auth_enabled=True)
        try:
            base = f"http://127.0.0.1:{m.rest.port}"
            password = _root_password(tmp_path)
            async with aiohttp.ClientSession() as s:
                async with s.post(f"{base}/api/v1/users/signin",
                                  json={"name": "root",
                                        "password": password}) as r:
                    hdr = {"Authorization":
                           f"Bearer {(await r.json())['token']}"}
                async with s.post(f"{base}/api/v1/oauth",
                                  json=_provider_body(pbase),
                                  headers=hdr) as r:
                    assert r.status == 201
                async with s.get(f"{base}/api/v1/oauth", headers=hdr) as r:
                    rows = await r.json()
                    assert rows and "client_secret" not in rows[0]
                async with s.get(f"{base}/oauth/signin/fakehub",
                                 allow_redirects=False) as r:
                    assert r.status == 302
                    loc = r.headers["Location"]
                    assert loc.startswith(f"{pbase}/authorize?")
                    assert "client_id=cid" in loc
                    state = parse_qs(urlsplit(loc).query)["state"][0]
                async with s.get(f"{base}/oauth/callback/fakehub",
                                 params={"code": OAUTH_CODE,
                                         "state": state}) as r:
                    assert r.status == 200
                    out = await r.json()
                    assert out["user"]["name"] == "fakehub:octocat"
                    otoken = out["token"]
                (treq,) = standin.stats()["token_requests"]
                assert treq["form"]["client_secret"] == "csecret"
                assert treq["content_type"] == \
                    "application/x-www-form-urlencoded"
                assert treq["accept"] == "application/json"
                # the session authenticates (a guest: read ok)
                async with s.get(f"{base}/api/v1/schedulers",
                                 headers={"Authorization":
                                          f"Bearer {otoken}"}) as r:
                    assert r.status == 200
                async with s.get(f"{base}/oauth/callback/fakehub",
                                 params={"code": OAUTH_CODE,
                                         "state": "bogus.sig"}) as r:
                    assert r.status == 401
                # a bad code: the provider refuses -> 401
                async with s.get(f"{base}/oauth/signin/fakehub",
                                 allow_redirects=False) as r:
                    loc = r.headers["Location"]
                    state2 = parse_qs(urlsplit(loc).query)["state"][0]
                async with s.get(f"{base}/oauth/callback/fakehub",
                                 params={"code": "evil",
                                         "state": state2}) as r:
                    assert r.status == 401
                async with s.get(f"{base}/oauth/signin/nope",
                                 allow_redirects=False) as r:
                    assert r.status == 404
        finally:
            await m.stop()

    provider = _Provider(token_ctype=token_ctype)
    with provider as pbase:
        _limited(main(pbase, provider.standin))


@pytest.mark.parametrize("identity,login", [
    ({"sub": "s-1", "id": 7, "login": "octo", "email": "o@x"}, "s-1"),
    ({"id": 42, "login": "octo", "email": "o@x"}, "42"),
    ({"login": "octo", "email": "o@x"}, "octo"),
    ({"email": "o@x"}, "o@x"),
    ({"name": "no stable id"}, None),
])
def test_callback_names_the_user_as_the_reference(tmp_path, identity, login):
    """The identity the callback signs in: ``sub``, then ``id``,
    ``login``, ``email``, in both packages; none of them is a 401."""
    async def signin(pkg: str, pbase: str):
        store = STORES[pkg](str(tmp_path / f"{pkg}.db"))
        auth = AUTHS[pkg](store)
        api = (RefRestAPI(store, None, host="127.0.0.1", auth=auth)
               if pkg == "reference"
               else RestAPI(store, host="127.0.0.1", auth=auth))
        store.create_oauth(**_provider_body(pbase))
        await api.start()
        try:
            def flow():
                _s, hdrs, _b = chip_smoke.auth_call(
                    api.port, "GET", "/oauth/signin/fakehub")
                state = parse_qs(urlsplit(hdrs["location"]).query)["state"]
                status, _h, body = chip_smoke.auth_call(
                    api.port, "GET", "/oauth/callback/fakehub?code="
                    f"{OAUTH_CODE}&state={state[0]}")
                return status, (body["user"]["name"], body["user"]["role"]) \
                    if status == 200 else body
            return await asyncio.to_thread(flow)
        finally:
            await api.stop()
            store.close()

    with _Provider(identity=identity) as pbase:
        got = {pkg: _limited(signin(pkg, pbase)) for pkg in STORES}
    assert got["port"] == got["reference"]
    if login is None:
        assert got["port"] == (401, {"error": "oauth signin rejected"})
    else:
        assert got["port"] == (200, (f"fakehub:{login}", "guest"))


# ------------------------------------------------------------ across packages

@pytest.mark.parametrize("writer", ["reference", "port"])
def test_users_and_tokens_verify_in_the_other_package(tmp_path, writer):
    path = str(tmp_path / "m.db")
    reader = "port" if writer == "reference" else "reference"
    w = STORES[writer](path)
    uid = w.create_user("alice", "s3cret", role="root")
    pat = w.create_pat(uid, label="ci")
    revoked = w.create_pat(uid, label="gone")
    w.revoke_pat(w.pats(uid)[-1]["id"])
    expired = w.create_pat(uid, label="old", ttl_s=0.001)
    oauth_user = w.get_or_create_oauth_user("fakehub", "octocat")
    assert w.save_oauth_nonce("n-1", time.time() + 600)
    w.create_oauth("fakehub", client_id="cid", client_secret="cs",
                   auth_url="a", token_url="t", userinfo_url="u")
    listing = (w.users(), w.pats(), w.oauths(), w.oauth("fakehub"))
    w.close()
    time.sleep(0.01)
    r = STORES[reader](path)
    try:
        assert (r.users(), r.pats(), r.oauths(), r.oauth("fakehub")) \
            == listing
        user = r.verify_user("alice", "s3cret")
        assert {k: user[k] for k in ("id", "name", "role")} == \
            {"id": uid, "name": "alice", "role": "root"}
        assert r.verify_user("alice", "wrong") is None
        assert r.verify_user("nobody", "s3cret") is None
        assert r.pat_user(pat) == {"id": uid, "name": "alice",
                                   "role": "root"}
        assert r.pat_user(revoked) is None and r.pat_user(expired) is None
        assert r.get_or_create_oauth_user("fakehub", "octocat") == oauth_user
        assert oauth_user["name"] == "fakehub:octocat"
        assert oauth_user["role"] == "guest"
        assert r.consume_oauth_nonce("n-1")
        assert not r.consume_oauth_nonce("n-1")
        assert r.delete_oauth(r.oauth("fakehub")["id"])
        assert r.oauths() == []
    finally:
        r.close()


def test_password_and_token_hashes_are_the_references():
    salt = bytes(range(16))
    for pw in ("", "pw", "pässwörd", "x" * 100):
        got = Store._hash_password(pw, salt)
        assert got == RefStore._hash_password(pw, salt)
        assert got.startswith(salt.hex() + "$") and len(got) == 32 + 1 + 128
    for token in ("dfp_abc", "dfs_x.y", ""):
        assert Store._token_hash(token) == RefStore._token_hash(token)


@pytest.mark.parametrize("minter", ["reference", "port"])
def test_sessions_and_states_verify_in_the_other_package(tmp_path, minter):
    secret, db = str(tmp_path / "session.secret"), str(tmp_path / "m.db")
    verifier = "port" if minter == "reference" else "reference"
    m_store, v_store = STORES[minter](db), STORES[verifier](db)
    m = AUTHS[minter](m_store, secret_path=secret)      # writes the secret
    v = AUTHS[verifier](v_store, secret_path=secret)    # reads it
    try:
        assert os.stat(secret).st_mode & 0o777 == 0o600
        user = {"id": 3, "name": "alice", "role": "guest"}
        token = m.mint_session(user)
        assert token.startswith("dfs_")
        assert v.verify_session(token) == user
        assert v.verify_session(token[:-2] + ("A" if token[-1] != "A"
                                              else "B") + "A") is None
        assert AUTHS[verifier](v_store).verify_session(token) is None
        state = m.mint_state("fakehub")
        assert not v.verify_state(state, "evilhub")   # not burnt
        assert v.verify_state(state, "fakehub")
        assert not m.verify_state(state, "fakehub")   # used once
    finally:
        m_store.close()
        v_store.close()


def test_gate_answers_before_routing():
    """The hook the REST calls with every request: public paths and the
    ``/oauth/`` prefix pass with no user, ``/api/v1/oauth`` does not; a
    guest may read only; a bad token is 401 whatever the path."""
    store = Store()
    auth = Authenticator(store)
    root = auth.mint_session({"id": 1, "name": "root", "role": "root"})
    guest = auth.mint_session({"id": 2, "name": "g", "role": "guest"})

    def gate(method, path, token=None, scheme="Bearer"):
        headers = {"authorization": f"{scheme} {token}"} if token else {}
        user, refused = auth.gate(method, path, headers)
        return (user or {}).get("name"), refused and refused[:2]

    assert gate("GET", "/healthy") == (None, None)
    assert gate("GET", "/metrics") == (None, None)
    assert gate("POST", "/api/v1/users/signin") == (None, None)
    assert gate("GET", "/oauth/anything") == (None, None)
    assert gate("GET", "/api/v1/oauth") == \
        (None, (401, {"error": "unauthorized"}))
    assert gate("GET", "/api/v1/nope") == \
        (None, (401, {"error": "unauthorized"}))
    assert gate("GET", "/api/v1/nope", root, "Basic") == \
        (None, (401, {"error": "unauthorized"}))
    assert gate("DELETE", "/api/v1/models", "dfp_forged") == \
        (None, (401, {"error": "unauthorized"}))
    assert gate("HEAD", "/api/v1/models", guest) == ("g", None)
    assert gate("PATCH", "/api/v1/x", guest) == \
        (None, (403, {"error": "forbidden"}))
    assert gate("DELETE", "/api/v1/x", root) == ("root", None)


# ---------------------------------------------------------- the REST table

def _call(port: int, method: str, route: str, token: str = "",
          body=None, raw: bytes | None = None, scheme: str = "Bearer"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        headers = {"Authorization": f"{scheme} {token}"} if token else {}
        data = raw
        if body is not None:
            data = json.dumps(body).encode()
        if data is not None:
            headers["Content-Type"] = "application/json"
        conn.request(method, route, body=data, headers=headers)
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, \
            resp.read()
    finally:
        conn.close()


def _norm(value, port: int):
    """JSON with timestamps dropped, tokens cut to their prefix and the
    manager's port written as PORT."""
    if isinstance(value, dict):
        return {k: _norm(v, port) for k, v in value.items()
                if k != "created_at"}
    if isinstance(value, list):
        return [_norm(v, port) for v in value]
    if isinstance(value, str):
        if value.startswith(("dfs_", "dfp_")):
            return value[:4]
        return value.replace(str(port), "PORT")
    return value


def _answer(port: int, status: int, headers: dict, body: bytes):
    ctype = headers.get("content-type", "")
    out = {"status": status,
           "body": _norm(json.loads(body), port)
           if ctype.startswith("application/json") else body.decode()}
    if "location" in headers:
        loc = urlsplit(headers["location"])
        query = parse_qs(loc.query)
        query["state"] = ["STATE"] if query.get("state") else []
        out["location"] = (loc.scheme, loc.netloc, loc.path,
                           _norm(dict(sorted(query.items())), port))
    if "retry-after" in headers:
        out["retry_after"] = headers["retry-after"]
    return out


def _table(pbase: str) -> list[tuple]:
    """(what, method, route, who, JSON body): ``who`` names a credential
    the run holds, or a literal token."""
    return [
        ("healthy", "GET", "/healthy", None, None),
        ("metrics, no credentials", "GET", "/metrics", None, None),
        ("no credentials", "GET", "/api/v1/schedulers", None, None),
        ("no credentials, a write", "POST", "/api/v1/applications", None,
         {"name": "x"}),
        ("a forged PAT", "GET", "/api/v1/schedulers", "dfp_forged", None),
        ("a forged session", "GET", "/api/v1/schedulers", "dfs_e30.bad",
         None),
        ("not a bearer", "GET", "/api/v1/schedulers", "basic", None),
        ("an unknown path, no credentials", "GET", "/api/v1/nope", None,
         None),
        ("a 405, no credentials", "DELETE", "/api/v1/models", None, None),
        ("an unknown path as root", "GET", "/api/v1/nope", "root", None),
        ("a 405 as root", "DELETE", "/api/v1/models", "root", None),
        ("a guest reads", "GET", "/api/v1/schedulers", "guest", None),
        ("a guest writes", "POST", "/api/v1/applications", "guest",
         {"name": "app-g"}),
        ("root writes", "POST", "/api/v1/applications", "root",
         {"name": "app-r"}),
        ("users as a guest", "GET", "/api/v1/users", "guest", None),
        ("users as root", "GET", "/api/v1/users", "root", None),
        ("a wrong password", "POST", "/api/v1/users/signin", None,
         {"name": "root", "password": "nope"}),
        ("an unknown user", "POST", "/api/v1/users/signin", None,
         {"name": "nobody", "password": "pw"}),
        ("a guest signs in", "POST", "/api/v1/users/signin", None,
         {"name": "bob", "password": "bob-pw"}),
        ("a duplicate user", "POST", "/api/v1/users", "root",
         {"name": "bob", "password": "x"}),
        ("a bad role", "POST", "/api/v1/users", "root",
         {"name": "eve", "password": "x", "role": "admin"}),
        ("no password", "POST", "/api/v1/users", "root", {"name": "eve"}),
        ("root mints a PAT", "POST", "/api/v1/personal-access-tokens",
         "root", {"label": "ci"}),
        ("a guest mints a PAT", "POST", "/api/v1/personal-access-tokens",
         "guest", {"label": "g"}),
        ("PATs as root", "GET", "/api/v1/personal-access-tokens", "root",
         None),
        ("PATs as a guest", "GET", "/api/v1/personal-access-tokens",
         "guest", None),
        ("the PAT reads", "GET", "/api/v1/schedulers", "pat", None),
        ("revoke the PAT", "DELETE", "/api/v1/personal-access-tokens/1",
         "root", None),
        ("the revoked PAT", "GET", "/api/v1/schedulers", "pat", None),
        ("a provider", "POST", "/api/v1/oauth", "root",
         _provider_body(pbase)),
        ("a provider without client_id", "POST", "/api/v1/oauth", "root",
         {"name": "x"}),
        ("a duplicate provider", "POST", "/api/v1/oauth", "root",
         _provider_body(pbase)),
        ("providers", "GET", "/api/v1/oauth", "guest", None),
        ("the OAuth 302", "GET", "/oauth/signin/fakehub", None, None),
        ("an unknown provider's sign-in", "GET", "/oauth/signin/nope",
         None, None),
        ("a forged state", "GET",
         f"/oauth/callback/fakehub?code={OAUTH_CODE}&state=bogus.sig",
         None, None),
        ("delete an unknown provider", "DELETE", "/api/v1/oauth/99",
         "root", None),
        ("delete the provider", "DELETE", "/api/v1/oauth/1", "root", None),
    ]


async def _run_table(pkg: str, tmp_path, pbase: str) -> list[dict]:
    m = await _mgr(tmp_path / pkg, pkg, auth_enabled=True)
    try:
        port = m.rest.port
        password = _root_password(tmp_path / pkg)

        def run() -> list[dict]:
            creds = {}
            _s, _h, b = _call(port, "POST", "/api/v1/users/signin",
                              body={"name": "root", "password": password})
            creds["root"] = json.loads(b)["token"]
            _call(port, "POST", "/api/v1/users", creds["root"],
                  {"name": "bob", "password": "bob-pw", "role": "guest"})
            _s, _h, b = _call(port, "POST", "/api/v1/users/signin",
                              body={"name": "bob", "password": "bob-pw"})
            creds["guest"] = json.loads(b)["token"]
            out = []
            for what, method, route, who, body in _table(pbase):
                scheme = "Bearer"
                if who == "basic":
                    who, scheme = "root", "Basic"
                token = creds.get(who, who) or ""
                status, headers, raw = _call(port, method, route, token,
                                             body, scheme=scheme)
                answer = _answer(port, status, headers, raw)
                if what == "root mints a PAT":
                    creds["pat"] = json.loads(raw)["token"]
                if what == "metrics, no credentials":
                    answer["body"] = "# TYPE df_" in answer["body"]
                out.append((what, answer))
            return out
        return await asyncio.to_thread(run)
    finally:
        await m.stop()


def test_rest_returns_the_reference_answers(tmp_path):
    with _Provider() as pbase:
        got = {pkg: _limited(_run_table(pkg, tmp_path, pbase))
               for pkg in MANAGERS}
    for (what, ref), (_w, port) in zip(got["reference"], got["port"]):
        assert port == ref, what
    answers = dict(got["port"])
    assert [answers[w]["status"] for w in (
        "no credentials", "an unknown path, no credentials",
        "a 405, no credentials", "a forged PAT", "the revoked PAT")] \
        == [401] * 5
    assert answers["a guest writes"] == {"status": 403,
                                         "body": {"error": "forbidden"}}
    assert answers["an unknown path as root"]["status"] == 404
    assert answers["a 405 as root"]["status"] == 405
    assert answers["users as root"]["body"] == [
        {"id": 1, "name": "root", "role": "root"},
        {"id": 2, "name": "bob", "role": "guest"}]
    signin = answers["the OAuth 302"]
    assert signin["status"] == 302 and signin["body"] == "302: Found"
    assert sorted(signin["location"][3]) == [
        "client_id", "redirect_uri", "response_type", "scope", "state"]
    assert signin["location"][3]["redirect_uri"] == \
        ["http://127.0.0.1:PORT/oauth/callback/fakehub"]


def test_auth_off_answers_as_the_reference(tmp_path):
    """With auth off the users' routes are open, the sign-in route is 404
    ``auth disabled`` and the OAuth routes do not exist, in both
    packages."""
    async def run(pkg: str) -> list:
        m = await _mgr(tmp_path / pkg, pkg)
        try:
            def calls():
                return [_answer(m.rest.port, *_call(m.rest.port, *c)) for c in (
                    ("POST", "/api/v1/users/signin", "",
                     {"name": "root", "password": "x"}),
                    ("GET", "/oauth/signin/fakehub"),
                    ("POST", "/api/v1/users", "", {"name": "a",
                                                   "password": "pw"}),
                    ("GET", "/api/v1/users"),
                    ("POST", "/api/v1/personal-access-tokens", "",
                     {"user_id": 1, "label": "open"}),
                    ("GET", "/api/v1/personal-access-tokens"))]
            return await asyncio.to_thread(calls)
        finally:
            await m.stop()

    got = {pkg: _limited(run(pkg)) for pkg in MANAGERS}
    assert got["port"] == got["reference"]
    assert got["port"][0] == {"status": 404,
                              "body": {"error": "auth disabled"}}
    assert got["port"][1] == {"status": 404, "body": "404: Not Found"}
    assert [a["status"] for a in got["port"][2:]] == [201, 200, 201, 200]


@pytest.mark.parametrize("method,route,raw", [
    ("POST", "/api/v1/users/signin", b"not json"),
    ("POST", "/api/v1/users", b"not json"),
    ("POST", "/api/v1/personal-access-tokens", b"{"),
    ("POST", "/api/v1/oauth", b"{"),
    ("DELETE", "/api/v1/personal-access-tokens/abc", None),
    ("DELETE", "/api/v1/oauth/abc", None),
])
def test_malformed_requests_are_400_where_the_reference_500s(tmp_path,
                                                             method, route,
                                                             raw):
    """ROADMAP known difference 8 on the new routes: a body that is no
    JSON, or an id that is no integer, is 400 in the port and 500 in the
    reference."""
    async def run(pkg: str) -> int:
        m = await _mgr(tmp_path / pkg, pkg, auth_enabled=True)
        try:
            password = _root_password(tmp_path / pkg)

            def call():
                _s, _h, b = _call(m.rest.port, "POST",
                                  "/api/v1/users/signin",
                                  body={"name": "root", "password": password})
                token = json.loads(b)["token"]
                return _call(m.rest.port, method, route, token,
                             raw=raw)[0]
            return await asyncio.to_thread(call)
        finally:
            await m.stop()

    got = {pkg: _limited(run(pkg)) for pkg in MANAGERS}
    assert got == {"reference": 500, "port": 400}


@pytest.mark.parametrize("route", ["/api/v1/users", "/api/v1/oauth"])
def test_a_body_that_is_no_object_is_400_in_both(tmp_path, route):
    """A JSON body that is no object: 400 in both packages, the port's
    message its own where the reference's is its ``TypeError``'s
    (ROADMAP known difference 8)."""
    async def run(pkg: str):
        m = await _mgr(tmp_path / pkg, pkg, auth_enabled=True)
        try:
            password = _root_password(tmp_path / pkg)

            def call():
                _s, _h, b = _call(m.rest.port, "POST",
                                  "/api/v1/users/signin",
                                  body={"name": "root", "password": password})
                status, _h, raw = _call(m.rest.port, "POST", route,
                                        json.loads(b)["token"], [1, 2])
                return status, json.loads(raw)
            return await asyncio.to_thread(call)
        finally:
            await m.stop()

    got = {pkg: _limited(run(pkg)) for pkg in MANAGERS}
    assert got["port"] == (400, {"error": "body must be a JSON object"})
    assert got["reference"][0] == 400
    assert "list indices must be integers" in got["reference"][1]["error"]


# ------------------------------------------------------------- bootstrap

def test_bootstrap_files_are_0600_and_a_restart_keeps_them(tmp_path):
    """The first start writes ``root.password`` and ``session.secret`` at
    mode 0600; a second start of the port, then of the reference, on the
    same workdir and database bootstraps nothing, and root's session
    still authenticates in both."""
    work, db = tmp_path / "w", str(tmp_path / "m.db")

    async def main():
        m = await _mgr(work, db_path=db, auth_enabled=True)
        try:
            pw = work / "root.password"
            modes = {f: os.stat(work / f).st_mode & 0o777
                     for f in ("root.password", "session.secret")}
            assert modes == {"root.password": 0o600,
                             "session.secret": 0o600}
            before = (pw.read_text(), os.stat(pw).st_mtime_ns,
                      (work / "session.secret").read_bytes())
            user = await asyncio.to_thread(m.store.verify_user, "root",
                                           before[0].strip())
            session = m.auth.mint_session(user)
        finally:
            await m.stop()
        for pkg in ("port", "reference"):
            m = await _mgr(work, pkg, db_path=db, auth_enabled=True)
            try:
                assert (pw.read_text(), os.stat(pw).st_mtime_ns,
                        (work / "session.secret").read_bytes()) == before
                assert [u["name"] for u in m.store.users()] == ["root"]
                assert m.auth.verify_session(session)["name"] == "root"
            finally:
                await m.stop()

    _limited(main())


def test_a_python_without_scrypt_fails_the_manager(tmp_path, monkeypatch):
    """The password hash has no other form: with auth on, a ``hashlib``
    without scrypt fails the manager's construction, naming it, and
    leaves no root user behind; with auth off the manager is built."""
    import hashlib
    monkeypatch.delattr(hashlib, "scrypt")
    with pytest.raises(RuntimeError, match="hashlib.scrypt"):
        Manager(ManagerConfig(listen_ip="127.0.0.1", workdir=str(tmp_path),
                              auth_enabled=True))
    assert not (tmp_path / "root.password").exists()
    Manager(ManagerConfig(listen_ip="127.0.0.1")).store.close()


# ------------------------------------------------------ phase 24 on the CPU

def test_phase_24_rehearsal_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.phase_auth`` at a 16 MB weights file with a CPU sink:
    the manager from its launcher with ``--auth``, the seed and the
    scheduler in a child, the PAT's preheat, L's pull with the origin
    gone, the revoke, OAuth against the stand-in (text/plain token), the
    SIGTERM restart and the in-process quota, with every check of the
    phase."""
    real_run = subprocess.run

    def fake_run(args, *a, **kw):
        if args and args[0] == "nvidia-smi":
            return subprocess.CompletedProcess(args, 0,
                                               "CPU rehearsal, 0 W\n", "")
        return real_run(args, *a, **kw)

    monkeypatch.setattr(chip_smoke.subprocess, "run", fake_run)
    monkeypatch.setitem(chip_smoke.LLAMA3_8B, "vocab", 2000)
    monkeypatch.setattr(chip_smoke, "CHAIN_PACE_BPS", 8_000_000)
    monkeypatch.setattr(sys, "path", [ROOT, *sys.path])
    os.makedirs(tmp_path / "deploy")
    header, nbytes = chip_smoke.safetensors_header(chip_smoke.deploy_layout())
    with open(tmp_path / "deploy" / chip_smoke.TREE_WEIGHTS, "wb") as f:
        f.write(header)
        f.write(memoryview(chip_smoke.seeded_bytes(
            np.random.default_rng(0), nbytes)))
    lines = []
    monkeypatch.setattr(chip_smoke, "emit",
                        lambda phase, rec: lines.append((phase, rec)))
    chip_smoke.phase_auth(str(tmp_path), torch.device("cpu"))
    (phase, rec), = lines
    assert phase == "phase 24 auth"
    assert rec["origin_bytes"] == rec["file_bytes"] == len(header) + nbytes
    assert rec["return_codes"] == {"manager": 0, "manager-restarted": 0}
    assert set(rec["get_median_s"]) == {"session", "pat", "public"}
    assert rec["card"] == "CPU rehearsal, 0 W"
    assert not os.path.exists(tmp_path / "auth")
