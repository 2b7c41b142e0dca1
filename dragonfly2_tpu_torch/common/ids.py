"""Content-addressed task ids and per-process peer ids.

Counterpart of ``dragonfly2_tpu/common/ids.py`` (``task_id``/``peer_id``):
a task id is sha256 over the normalized URL plus the download-relevant
metadata, so the same bytes map to the same task in both packages.
"""

from __future__ import annotations

import hashlib
import uuid
from urllib.parse import parse_qsl, urlencode, urlsplit, urlunsplit


def _filtered_url(url: str, filtered_query_params: list[str] | None) -> str:
    """Normalize a URL, dropping query params that don't change the content
    (e.g. signatures, expiry timestamps on presigned URLs)."""
    parts = urlsplit(url)
    query = parse_qsl(parts.query, keep_blank_values=True)
    if filtered_query_params:
        drop = {p.lower() for p in filtered_query_params}
        query = [(k, v) for k, v in query if k.lower() not in drop]
    query.sort()
    return urlunsplit((parts.scheme.lower(), parts.netloc, parts.path,
                       urlencode(query), ""))


def task_id(url: str, *, tag: str = "", application: str = "",
            digest: str = "", piece_range: str = "",
            filtered_query_params: list[str] | None = None) -> str:
    """Content-addressed task id (hex sha256)."""
    h = hashlib.sha256()
    # dflint: disable=DF001 — id hashing covers URL-scale strings (≤KB); an executor hop per task_id would cost more than the digest
    h.update(_filtered_url(url, filtered_query_params).encode())
    for part in (tag, application, digest, piece_range):
        # dflint: disable=DF001 — see above: URL-scale id strings
        h.update(b"\x00")
        # dflint: disable=DF001 — see above: URL-scale id strings
        h.update(part.encode())
    return h.hexdigest()


def parent_task_id(url: str, *, tag: str = "", application: str = "",
                   digest: str = "",
                   filtered_query_params: list[str] | None = None) -> str:
    """Task id of a ranged request's whole-file parent: the same id with
    the range dropped, the key a ranged request looks the finished
    parent up by."""
    return task_id(url, tag=tag, application=application, digest=digest,
                   filtered_query_params=filtered_query_params)


def peer_id(hostname: str, ip: str, *, seed: bool = False) -> str:
    """Unique-per-process peer id: host identity + random suffix."""
    kind = "seed" if seed else "peer"
    return f"{ip}-{hostname}-{uuid.uuid4().hex[:16]}-{kind}"
