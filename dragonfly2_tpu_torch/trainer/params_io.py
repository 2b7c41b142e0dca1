"""Model-blob serialization: numpy-only, importable by the scheduler.

Counterpart of ``dragonfly2_tpu/trainer/params_io.py``, copied whole: the
npz archive of the flattened param tree (no pickle), with the same key
tree (``layers/<i>/w|b``; ``encode/...``, ``msg/<i>/...``, ``upd/<i>/...``,
``head/...``) and the ``__meta__`` JSON, so a blob written by either
package binds in the other's serving side.
"""

from __future__ import annotations

import hashlib
import io
import json

import numpy as np


def _flatten(tree, prefix="") -> dict:
    out: dict = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for key, arr in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def serialize_params(params, meta: dict) -> bytes:
    buf = io.BytesIO()
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    flat["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(buf, **flat)
    return buf.getvalue()


def deserialize_params(data: bytes) -> tuple[dict, dict]:
    with np.load(io.BytesIO(data)) as z:
        flat = {k: z[k] for k in z.files if k != "__meta__"}
        meta = json.loads(bytes(z["__meta__"]).decode()) \
            if "__meta__" in z.files else {}
    return _unflatten(flat), meta


def version_of(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]
