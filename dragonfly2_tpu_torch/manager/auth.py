"""Manager REST authentication, RBAC and the per-identity quota.

Counterpart of ``dragonfly2_tpu/manager/auth.py`` (reference
``manager/middlewares/{jwt,personal_access_token,rbac}.go``,
``manager/permission/rbac`` and ``manager/auth``), in the same formats,
so either package's manager verifies what the other minted over one
``session.secret`` and database:

- **Session tokens**: ``POST /api/v1/users/signin`` checks a password
  (scrypt, in the store) and mints ``dfs_<b64 payload>.<b64 HMAC-SHA256>``
  with a 7-day expiry.
- **Personal access tokens**: any other bearer token, checked against
  its sha256 in the store.
- **RBAC**: GET and HEAD read, every other method writes; ``root`` may do
  everything, ``guest`` only read.
- **The quota**: a token bucket per identity, answered 429 with
  ``Retry-After`` (off unless ``rest_quota_rps`` is set; no config key
  sets it, as in the reference).

The reference gates its aiohttp routes with a middleware. The port's
REST (``rest.py``) calls ``Authenticator.gate`` with the method, path and
headers of every request before it routes it, as aiohttp runs the
middleware around its 404 and 405 answers too. ``OAuthFlow`` is the
OAuth2 authorization-code sign-in on the port's HTTP client, and
``bootstrap_root`` makes the first root user. The HMAC secret lives
beside the database, mode 0600 from creation, so a restart keeps every
session.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import hmac
import json
import logging
import os
import secrets
import time
from urllib.parse import urlencode

from ..common.errors import Code, DFError
from ..common.rate import TokenBucket
from ..source.http_client import HTTPSourceClient

log = logging.getLogger("df.mgr.auth")

SESSION_TTL_S = 7 * 24 * 3600.0
OAUTH_STATE_TTL_S = 600.0
OAUTH_TIMEOUT_S = 300.0           # aiohttp's default total for a session
QUOTA_BUCKETS_CAP = 4096
# served without credentials: health, metrics and the sign-in itself;
# /oauth/ (the sign-in redirect and the provider's callback) by prefix
PUBLIC_PATHS = {"/healthy", "/metrics", "/api/v1/users/signin"}
PUBLIC_PREFIXES = ("/oauth/",)


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(data: str) -> bytes:
    pad = -len(data) % 4
    return base64.urlsafe_b64decode(data + "=" * pad)


def _write_0600(path: str, data: bytes) -> None:
    """``data`` at ``path``, mode 0600 from the file's creation: an open
    then chmod leaves a window in which it is readable by all."""
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "wb") as f:
        f.write(data)


class Authenticator:
    def __init__(self, store, *, secret_path: str = "",
                 rest_quota_rps: float = 0.0,
                 rest_quota_burst: float = 0.0):
        """``rest_quota_rps``: requests a second per authenticated
        identity (0: no quota). Over it a request gets 429 with
        ``Retry-After``, so one tenant's poller cannot hold the manager's
        sqlite thread."""
        self.store = store
        self.rest_quota_rps = float(rest_quota_rps)
        self.rest_quota_burst = float(rest_quota_burst) \
            or max(self.rest_quota_rps * 2, 1.0)
        self._quota_buckets: dict[str, TokenBucket] = {}
        if secret_path and os.path.exists(secret_path):
            with open(secret_path, "rb") as f:
                self._secret = f.read()
        else:
            self._secret = secrets.token_bytes(32)
            if secret_path:
                os.makedirs(os.path.dirname(secret_path) or ".",
                            exist_ok=True)
                _write_0600(secret_path, self._secret)

    # -- session tokens ------------------------------------------------

    def _sign(self, prefix: bytes, body: str) -> str:
        return _b64(hmac.new(self._secret, prefix + body.encode(),
                             hashlib.sha256).digest())

    def mint_session(self, user: dict) -> str:
        payload = json.dumps({"uid": user["id"], "name": user["name"],
                              "role": user["role"],
                              "exp": time.time() + SESSION_TTL_S})
        body = _b64(payload.encode())
        return f"dfs_{body}.{self._sign(b'', body)}"

    def verify_session(self, token: str) -> dict | None:
        if not token.startswith("dfs_"):
            return None
        body, _, sig = token[4:].partition(".")
        if not hmac.compare_digest(sig, self._sign(b"", body)):
            return None
        try:
            payload = json.loads(_unb64(body))
        except ValueError:
            return None
        if time.time() > payload.get("exp", 0):
            return None
        return {"id": payload["uid"], "name": payload["name"],
                "role": payload["role"]}

    # -- request authentication ----------------------------------------

    def authenticate(self, headers: dict) -> dict | None:
        """The user behind ``Authorization: Bearer <token>`` in
        ``headers`` (names in lower case), or None."""
        fields = headers.get("authorization", "").split()
        if len(fields) != 2 or fields[0] != "Bearer":
            return None
        token = fields[1]
        if token.startswith("dfs_"):
            return self.verify_session(token)
        return self.store.pat_user(token)

    @staticmethod
    def allowed(user: dict, method: str) -> bool:
        if user["role"] == "root":
            return True
        return method in ("GET", "HEAD")       # guest: read only

    # -- OAuth sign-in state (the CSRF guard of the authorize round trip) --

    def mint_state(self, provider: str) -> str:
        """A signed state whose nonce is saved in the database: a state is
        used once (a signed state alone could be replayed for its whole
        TTL by anyone who saw it, and minting one costs an attacker
        nothing on the public route). ``RESOURCE_EXHAUSTED`` when the
        table is full."""
        nonce = _b64(secrets.token_bytes(8))
        exp = time.time() + OAUTH_STATE_TTL_S
        payload = json.dumps({"p": provider, "n": nonce, "exp": exp})
        if not self.store.save_oauth_nonce(nonce, exp):
            raise DFError(Code.RESOURCE_EXHAUSTED,
                          "too many pending oauth sign-ins")
        body = _b64(payload.encode())
        return f"{body}.{self._sign(b'state:', body)}"

    def verify_state(self, state: str, provider: str) -> bool:
        body, _, sig = state.partition(".")
        if not hmac.compare_digest(sig, self._sign(b"state:", body)):
            return False
        try:
            payload = json.loads(_unb64(body))
        except ValueError:
            return False
        if (payload.get("p") != provider
                or time.time() > payload.get("exp", 0)):
            # checked before the nonce is used up: a callback for another
            # provider must not burn a state still valid
            return False
        return self.store.consume_oauth_nonce(payload.get("n", ""))

    def check_quota(self, user: dict) -> float:
        """0.0: admitted; above 0: over the identity's quota, the
        ``Retry-After`` seconds. Never waits, so a throttled tenant queues
        no request behind it."""
        if self.rest_quota_rps <= 0:
            return 0.0
        bucket = self._quota_buckets.get(user["name"])
        if bucket is None:
            if len(self._quota_buckets) > QUOTA_BUCKETS_CAP:
                # a flood of names (forged tokens): resetting every bucket
                # is safer than growing without bound
                self._quota_buckets.clear()
            bucket = TokenBucket(self.rest_quota_rps, self.rest_quota_burst)
            self._quota_buckets[user["name"]] = bucket
        if bucket.try_acquire(1.0):
            return 0.0
        return max(1.0 / self.rest_quota_rps, 1.0)

    def gate(self, method: str, path: str, headers: dict
             ) -> tuple[dict | None, tuple[int, dict, dict] | None]:
        """The reference's middleware: ``(user, None)`` lets the request
        on with its user (None on a public path); ``(None, (status,
        body, headers))`` answers it with 401, 403 or 429."""
        if path in PUBLIC_PATHS or path.startswith(PUBLIC_PREFIXES):
            return None, None
        user = self.authenticate(headers)
        if user is None:
            return None, (401, {"error": "unauthorized"}, {})
        if not self.allowed(user, method):
            return None, (403, {"error": "forbidden"}, {})
        retry_s = self.check_quota(user)
        if retry_s > 0:
            # the 429 contract: Retry-After, so a client backs off
            return None, (429, {"error": "quota exceeded"},
                          {"Retry-After": str(int(retry_s))})
        return user, None


class OAuthFlow:
    """OAuth2 authorization-code sign-in (reference
    ``manager/models/oauth.go``, ``manager/handlers/oauth.go``). The
    providers are rows of the store; the callback trades the code for a
    token, reads the identity and signs it in as a local user named after
    the provider."""

    def __init__(self, store, authenticator: Authenticator):
        self.store = store
        self.auth = authenticator
        self._http = HTTPSourceClient()

    async def close(self) -> None:
        await self._http.close()

    async def signin_url(self, name: str, redirect_uri: str) -> str | None:
        p = await asyncio.to_thread(self.store.oauth, name)
        if p is None:
            return None
        q = {"response_type": "code", "client_id": p["client_id"],
             "redirect_uri": redirect_uri,
             "state": self.auth.mint_state(name)}
        if p["scopes"]:
            q["scope"] = p["scopes"]
        sep = "&" if "?" in p["auth_url"] else "?"
        return p["auth_url"] + sep + urlencode(q)

    async def _json(self, method: str, url: str, headers: dict,
                    body: bytes = b"") -> tuple[int, object]:
        """The provider's status, and its body parsed whatever its
        ``Content-Type`` when the status is 200, as the reference's
        ``resp.json(content_type=None)`` (a blank body is None)."""
        resp = await self._http.request(method, url, headers, body=body,
                                        timeout_s=OAUTH_TIMEOUT_S)
        data = (await resp.read()).strip()
        if resp.status != 200:
            return resp.status, None
        return 200, json.loads(data) if data else None

    async def callback(self, name: str, code: str, state: str,
                       redirect_uri: str) -> dict | None:
        """code -> token -> identity -> a local session; None: refused."""
        p = await asyncio.to_thread(self.store.oauth, name)
        if p is None or not self.auth.verify_state(state, name):
            return None
        try:
            form = urlencode({
                "grant_type": "authorization_code", "code": code,
                "client_id": p["client_id"],
                "client_secret": p["client_secret"],
                "redirect_uri": redirect_uri}).encode()
            status, tok = await self._json("POST", p["token_url"], {
                "Accept": "application/json",
                "Content-Type": "application/x-www-form-urlencoded"}, form)
            if status != 200:
                return None
            access = tok.get("access_token")
            if not access:
                return None
            status, info = await self._json("GET", p["userinfo_url"], {
                "Authorization": f"Bearer {access}",
                "Accept": "application/json"})
            if status != 200:
                return None
        except Exception as exc:  # noqa: BLE001 - the provider is external
            log.warning("oauth %s exchange failed: %s", name, exc)
            return None
        # stable identifiers first (sub, id): a display name as the key
        # would let a user rename into another's local account
        login = str(info.get("sub") or info.get("id") or info.get("login")
                    or info.get("email") or "")
        if not login:
            return None
        user = await asyncio.to_thread(self.store.get_or_create_oauth_user,
                                       name, login)
        return {"token": self.auth.mint_session(user), "user": user}


def bootstrap_root(store, *, password_path: str = "") -> None:
    """The first boot's root user: a generated password written to
    ``password_path``, mode 0600 from creation (the reference seeds root
    through its database migrations instead). A later boot finds root
    and writes nothing."""
    if store._rows("SELECT id FROM users WHERE name='root'"):
        return
    password = secrets.token_urlsafe(16)
    store.create_user("root", password, role="root")
    if password_path:
        _write_0600(password_path, (password + "\n").encode())
        log.info("bootstrapped root user; password at %s", password_path)
    else:
        log.warning("bootstrapped root user with ephemeral password "
                    "(no password_path given): %s", password)
