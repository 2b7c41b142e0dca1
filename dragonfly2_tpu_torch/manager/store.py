"""Entity store: sqlite-backed tables for the manager's records.

Counterpart of ``dragonfly2_tpu/manager/store.py`` (reference
``manager/models/*.go`` + ``manager/database``). The DDL is the
reference's, whole, so one database file opens in either package; this
slice reads and writes the scheduler clusters, schedulers, seed-peer
clusters, seed peers, applications, the model registry and the
schedulers' parked handoff state. The tenant, job, user and OAuth tables
are created and left to the slices that port their services.
"""

from __future__ import annotations

import dataclasses
import json
import sqlite3
import threading
import time
from typing import Any, Iterable

from ..idl.messages import (ClusterConfig, SchedulerEntity, SeedPeerEntity,
                            TopologyInfo)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS scheduler_clusters (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT UNIQUE NOT NULL,
  config TEXT NOT NULL DEFAULT '{}',
  scopes TEXT NOT NULL DEFAULT '{}',
  is_default INTEGER NOT NULL DEFAULT 0,
  created_at REAL, updated_at REAL
);
CREATE TABLE IF NOT EXISTS schedulers (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  hostname TEXT NOT NULL, ip TEXT NOT NULL, port INTEGER NOT NULL,
  state TEXT NOT NULL DEFAULT 'inactive',
  scheduler_cluster_id INTEGER NOT NULL,
  features TEXT NOT NULL DEFAULT '[]',
  topology TEXT NOT NULL DEFAULT '{}',
  last_keepalive REAL NOT NULL DEFAULT 0,
  created_at REAL, updated_at REAL,
  UNIQUE(hostname, ip, port)
);
CREATE TABLE IF NOT EXISTS seed_peer_clusters (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT UNIQUE NOT NULL,
  config TEXT NOT NULL DEFAULT '{}',
  created_at REAL, updated_at REAL
);
CREATE TABLE IF NOT EXISTS seed_peers (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  hostname TEXT NOT NULL, ip TEXT NOT NULL,
  port INTEGER NOT NULL, download_port INTEGER NOT NULL,
  object_storage_port INTEGER NOT NULL DEFAULT 0,
  type TEXT NOT NULL DEFAULT 'super',
  state TEXT NOT NULL DEFAULT 'inactive',
  seed_peer_cluster_id INTEGER NOT NULL,
  topology TEXT NOT NULL DEFAULT '{}',
  last_keepalive REAL NOT NULL DEFAULT 0,
  created_at REAL, updated_at REAL,
  UNIQUE(hostname, ip, port)
);
CREATE TABLE IF NOT EXISTS applications (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT UNIQUE NOT NULL,
  url TEXT NOT NULL DEFAULT '',
  priority TEXT NOT NULL DEFAULT '{}',
  created_at REAL, updated_at REAL
);
CREATE TABLE IF NOT EXISTS tenants (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT UNIQUE NOT NULL,
  qos_class TEXT NOT NULL DEFAULT '',
  max_running INTEGER NOT NULL DEFAULT 0,
  shed_retry_after_ms INTEGER NOT NULL DEFAULT 0,
  created_at REAL, updated_at REAL
);
CREATE TABLE IF NOT EXISTS scheduler_states (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  cluster_id INTEGER NOT NULL,
  scheduler_id TEXT NOT NULL,
  blob BLOB NOT NULL,
  signature TEXT NOT NULL DEFAULT '',
  updated_at REAL,
  UNIQUE(cluster_id, scheduler_id)
);
CREATE TABLE IF NOT EXISTS jobs (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  type TEXT NOT NULL,
  state TEXT NOT NULL DEFAULT 'pending',
  args TEXT NOT NULL DEFAULT '{}',
  result TEXT NOT NULL DEFAULT '{}',
  created_at REAL, updated_at REAL
);
CREATE TABLE IF NOT EXISTS models (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT NOT NULL,
  version TEXT NOT NULL,
  state TEXT NOT NULL DEFAULT 'active',
  scheduler_cluster_id INTEGER NOT NULL DEFAULT 0,
  metrics TEXT NOT NULL DEFAULT '{}',
  data BLOB NOT NULL,
  created_at REAL,
  UNIQUE(name, version, scheduler_cluster_id)
);
CREATE TABLE IF NOT EXISTS users (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT NOT NULL UNIQUE,
  password_hash TEXT NOT NULL,
  role TEXT NOT NULL DEFAULT 'guest',
  created_at REAL
);
CREATE TABLE IF NOT EXISTS oauth_states (
  nonce TEXT PRIMARY KEY,
  expires_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS personal_access_tokens (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  token_hash TEXT NOT NULL UNIQUE,
  label TEXT NOT NULL DEFAULT '',
  user_id INTEGER NOT NULL,
  revoked INTEGER NOT NULL DEFAULT 0,
  expires_at REAL NOT NULL DEFAULT 0,
  created_at REAL
);
CREATE TABLE IF NOT EXISTS oauth_providers (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT NOT NULL UNIQUE,
  client_id TEXT NOT NULL,
  client_secret TEXT NOT NULL,
  auth_url TEXT NOT NULL,
  token_url TEXT NOT NULL,
  userinfo_url TEXT NOT NULL,
  scopes TEXT NOT NULL DEFAULT '',
  created_at REAL
);
"""


def _now() -> float:
    return time.time()


class Store:
    """Thread-safe sqlite store (the manager's handlers call it through
    ``asyncio.to_thread``)."""

    def __init__(self, path: str = ":memory:"):
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.row_factory = sqlite3.Row
        self._lock = threading.Lock()
        with self._lock:
            self._db.executescript(_SCHEMA)
            self._db.commit()

    def close(self) -> None:
        self._db.close()

    def _exec(self, sql: str, args: Iterable[Any] = ()) -> sqlite3.Cursor:
        with self._lock:
            cur = self._db.execute(sql, tuple(args))
            self._db.commit()
            return cur

    def _rows(self, sql: str, args: Iterable[Any] = ()) -> list[sqlite3.Row]:
        with self._lock:
            return self._db.execute(sql, tuple(args)).fetchall()

    # -- clusters ------------------------------------------------------

    def create_scheduler_cluster(self, name: str, *,
                                 config: ClusterConfig | None = None,
                                 scopes: dict | None = None,
                                 is_default: bool = False) -> int:
        cfg = json.dumps(dataclasses.asdict(config or ClusterConfig()))
        cur = self._exec(
            "INSERT INTO scheduler_clusters(name, config, scopes, is_default,"
            " created_at, updated_at) VALUES (?,?,?,?,?,?)",
            (name, cfg, json.dumps(scopes or {}), int(is_default),
             _now(), _now()))
        return int(cur.lastrowid)

    def scheduler_clusters(self) -> list[dict]:
        return [dict(r) for r in self._rows(
            "SELECT * FROM scheduler_clusters ORDER BY id")]

    def cluster_config(self, cluster_id: int) -> ClusterConfig:
        rows = self._rows("SELECT config FROM scheduler_clusters WHERE id=?",
                          (cluster_id,))
        if not rows:
            return ClusterConfig()
        return ClusterConfig(**json.loads(rows[0]["config"]))

    def default_scheduler_cluster(self) -> int:
        rows = self._rows("SELECT id FROM scheduler_clusters WHERE is_default=1"
                          " ORDER BY id LIMIT 1")
        if rows:
            return int(rows[0]["id"])
        return self.create_scheduler_cluster(f"cluster-{_now():.0f}",
                                             is_default=True)

    def create_seed_peer_cluster(self, name: str) -> int:
        cur = self._exec(
            "INSERT INTO seed_peer_clusters(name, created_at, updated_at)"
            " VALUES (?,?,?)", (name, _now(), _now()))
        return int(cur.lastrowid)

    def seed_peer_clusters(self) -> list[dict]:
        return [dict(r) for r in self._rows(
            "SELECT * FROM seed_peer_clusters ORDER BY id")]

    # -- scheduler instances ------------------------------------------

    def upsert_scheduler(self, *, hostname: str, ip: str, port: int,
                         cluster_id: int,
                         topology: TopologyInfo | None = None,
                         features: list[str] | None = None) -> int:
        topo = json.dumps(dataclasses.asdict(topology) if topology else {},
                          default=list)
        cur = self._exec(
            "INSERT INTO schedulers(hostname, ip, port, state,"
            " scheduler_cluster_id, features, topology, last_keepalive,"
            " created_at, updated_at)"
            " VALUES (?,?,?,'active',?,?,?,?,?,?)"
            " ON CONFLICT(hostname, ip, port) DO UPDATE SET"
            " state='active', scheduler_cluster_id=excluded.scheduler_cluster_id,"
            " topology=excluded.topology, last_keepalive=excluded.last_keepalive,"
            " updated_at=excluded.updated_at",
            (hostname, ip, port, cluster_id,
             json.dumps(features or []), topo, _now(), _now(), _now()))
        rows = self._rows(
            "SELECT id FROM schedulers WHERE hostname=? AND ip=? AND port=?",
            (hostname, ip, port))
        return int(rows[0]["id"])

    def schedulers(self, *, cluster_id: int | None = None,
                   only_active: bool = False) -> list[SchedulerEntity]:
        sql = "SELECT * FROM schedulers"
        args: list = []
        conds = []
        if cluster_id is not None:
            conds.append("scheduler_cluster_id=?")
            args.append(cluster_id)
        if only_active:
            conds.append("state='active'")
        if conds:
            sql += " WHERE " + " AND ".join(conds)
        out = []
        for r in self._rows(sql + " ORDER BY id", args):
            topo = json.loads(r["topology"])
            out.append(SchedulerEntity(
                id=r["id"], hostname=r["hostname"], ip=r["ip"],
                port=r["port"], state=r["state"],
                scheduler_cluster_id=r["scheduler_cluster_id"],
                features=json.loads(r["features"]),
                topology=TopologyInfo(**topo) if topo else None))
        return out

    # -- seed peer instances ------------------------------------------

    def upsert_seed_peer(self, *, hostname: str, ip: str, port: int,
                         download_port: int, cluster_id: int,
                         object_storage_port: int = 0, type_: str = "super",
                         topology: TopologyInfo | None = None) -> int:
        topo = json.dumps(dataclasses.asdict(topology) if topology else {},
                          default=list)
        self._exec(
            "INSERT INTO seed_peers(hostname, ip, port, download_port,"
            " object_storage_port, type, state, seed_peer_cluster_id,"
            " topology, last_keepalive, created_at, updated_at)"
            " VALUES (?,?,?,?,?,?,'active',?,?,?,?,?)"
            " ON CONFLICT(hostname, ip, port) DO UPDATE SET"
            " state='active', download_port=excluded.download_port,"
            " topology=excluded.topology, last_keepalive=excluded.last_keepalive,"
            " updated_at=excluded.updated_at",
            (hostname, ip, port, download_port, object_storage_port, type_,
             cluster_id, topo, _now(), _now(), _now()))
        rows = self._rows(
            "SELECT id FROM seed_peers WHERE hostname=? AND ip=? AND port=?",
            (hostname, ip, port))
        return int(rows[0]["id"])

    def seed_peers(self, *, cluster_id: int | None = None,
                   only_active: bool = False) -> list[SeedPeerEntity]:
        sql = "SELECT * FROM seed_peers"
        args: list = []
        conds = []
        if cluster_id is not None:
            conds.append("seed_peer_cluster_id=?")
            args.append(cluster_id)
        if only_active:
            conds.append("state='active'")
        if conds:
            sql += " WHERE " + " AND ".join(conds)
        out = []
        for r in self._rows(sql + " ORDER BY id", args):
            topo = json.loads(r["topology"])
            out.append(SeedPeerEntity(
                id=r["id"], hostname=r["hostname"], ip=r["ip"],
                port=r["port"], download_port=r["download_port"],
                object_storage_port=r["object_storage_port"],
                type=r["type"], state=r["state"],
                seed_peer_cluster_id=r["seed_peer_cluster_id"],
                topology=TopologyInfo(**topo) if topo else None))
        return out

    # -- keepalive -----------------------------------------------------

    def keepalive(self, source_type: str, hostname: str, ip: str,
                  port: int = 0) -> bool:
        """port=0 is a legacy wildcard; identity is (hostname, ip, port) —
        without the port one live instance would keep a dead same-host
        sibling marked active forever."""
        table = "schedulers" if source_type == "scheduler" else "seed_peers"
        sql = (f"UPDATE {table} SET last_keepalive=?, state='active',"
               " updated_at=? WHERE hostname=? AND ip=?")
        args: list = [_now(), _now(), hostname, ip]
        if port:
            sql += " AND port=?"
            args.append(port)
        cur = self._exec(sql, args)
        return cur.rowcount > 0

    def expire_stale(self, *, ttl_s: float) -> int:
        """Instances silent past the TTL flip to inactive (reference
        manager marks keepalive-lost instances the same way)."""
        cutoff = _now() - ttl_s
        n = 0
        for table in ("schedulers", "seed_peers"):
            cur = self._exec(
                f"UPDATE {table} SET state='inactive', updated_at=?"
                " WHERE state='active' AND last_keepalive < ?",
                (_now(), cutoff))
            n += cur.rowcount
        return n

    # -- applications --------------------------------------------------

    def upsert_application(self, name: str, *, url: str = "",
                           priority: dict | None = None) -> int:
        self._exec(
            "INSERT INTO applications(name, url, priority, created_at,"
            " updated_at) VALUES (?,?,?,?,?)"
            " ON CONFLICT(name) DO UPDATE SET url=excluded.url,"
            " priority=excluded.priority, updated_at=excluded.updated_at",
            (name, url, json.dumps(priority or {}), _now(), _now()))
        return int(self._rows("SELECT id FROM applications WHERE name=?",
                              (name,))[0]["id"])

    def applications(self) -> list[dict]:
        return [dict(r) for r in self._rows(
            "SELECT * FROM applications ORDER BY id")]

    # -- model registry (reference manager/models/model.go:36) ---------

    def create_model(self, *, name: str, version: str, data: bytes,
                     metrics: dict | None = None,
                     scheduler_cluster_id: int = 0) -> int:
        """Insert one model version; the newest active version per name is
        the one ``get_model`` serves by default. Idempotent per version."""
        self._exec(
            "INSERT INTO models(name, version, state, scheduler_cluster_id,"
            " metrics, data, created_at) VALUES (?,?,'active',?,?,?,?)"
            " ON CONFLICT(name, version, scheduler_cluster_id) DO UPDATE SET"
            " metrics=excluded.metrics, state='active'",
            (name, version, scheduler_cluster_id,
             json.dumps(metrics or {}), data, _now()))
        rows = self._rows(
            "SELECT id FROM models WHERE name=? AND version=?"
            " AND scheduler_cluster_id=?",
            (name, version, scheduler_cluster_id))
        return int(rows[0]["id"])

    def get_model(self, name: str, *, version: str = "",
                  scheduler_cluster_id: int = 0) -> dict | None:
        sql = ("SELECT * FROM models WHERE name=? AND state='active'"
               " AND scheduler_cluster_id IN (0, ?)")
        args: list = [name, scheduler_cluster_id]
        if version:
            sql += " AND version=?"
            args.append(version)
        sql += " ORDER BY created_at DESC, id DESC LIMIT 1"
        rows = self._rows(sql, args)
        if not rows:
            return None
        r = dict(rows[0])
        r["metrics"] = json.loads(r["metrics"])
        return r

    # -- scheduler handoff blobs (control-plane failover) --------------

    def park_scheduler_state(self, *, cluster_id: int, scheduler_id: str,
                             blob: bytes, signature: str = "") -> None:
        """Park a stopping scheduler's exported quarantine/affinity
        summary for its ring successor. One row per (cluster, scheduler);
        the blob is relayed opaquely and its signature travels with it,
        so the importer, not the relay, verifies provenance."""
        self._exec(
            "INSERT INTO scheduler_states(cluster_id, scheduler_id, blob,"
            " signature, updated_at) VALUES (?,?,?,?,?)"
            " ON CONFLICT(cluster_id, scheduler_id) DO UPDATE SET"
            " blob=excluded.blob, signature=excluded.signature,"
            " updated_at=excluded.updated_at",
            (int(cluster_id), scheduler_id, blob, signature, _now()))

    def latest_scheduler_state(self, *, cluster_id: int,
                               exclude: str = "") -> dict | None:
        """Freshest parked blob in the cluster, skipping the asker's own
        export."""
        rows = self._rows(
            "SELECT * FROM scheduler_states WHERE cluster_id=? AND"
            " scheduler_id != ? ORDER BY updated_at DESC LIMIT 1",
            (int(cluster_id), exclude))
        return dict(rows[0]) if rows else None

    def models(self, *, name: str | None = None) -> list[dict]:
        """Listing without blobs (REST index view)."""
        sql = ("SELECT id, name, version, state, scheduler_cluster_id,"
               " metrics, length(data) AS size, created_at FROM models")
        args: list = []
        if name:
            sql += " WHERE name=?"
            args.append(name)
        out = []
        for r in self._rows(sql + " ORDER BY id", args):
            d = dict(r)
            d["metrics"] = json.loads(d["metrics"])
            out.append(d)
        return out
