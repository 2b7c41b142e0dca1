"""Peer-exchange (PEX) gossip plane: scheduler-less piece discovery.

Counterpart of ``dragonfly2_tpu/daemon/pex.py``. Every daemon
periodically POSTs a compact availability digest ({task_id -> piece
set, host address triple, topology} for the tasks in its storage) to a
small fanout of known peers, ICI neighbours first, over its upload port
(``POST /pex/digest``); the reply is the target's own digest (push-pull
anti-entropy). Received digests land in a TTL'd ``SwarmIndex``
(``swarm_index.py``). Membership is seeded from ``pex.bootstrap`` and
from every parent the scheduler assigns (the engine's ``peer_observer``)
and grows through the peer sample each digest carries. A digest from a
peer is first-hand liveness; a mention by someone else (a sample, a
bootstrap re-seed, a parent this plane minted) may create an entry but
never refreshes one, and an evicted address sits out a cooldown.

The conductor's ladder gains a ``pex`` rung between ``ring_failover``
and ``back_source``: when every scheduler is unreachable, ``try_pull``
serves the task from index holders with a fresh engine and a synthetic,
non-rescuable session, provided a holder is complete or the holders'
pieces plus fresh watermarks cover every piece still needed
(``_covers_task``). ``prime`` puts swarm-known holders on a live
scheduler session as an advisory packet. The ticker also TCP-probes
demoted schedulers (``SchedulerConnector.probe_demoted``).

The envelope is ``sha256hex\\n<canonical JSON>`` (``seal`` /
``unseal``); a torn, unparseable, re-versioned or ill-typed body is
refused and counted under ``df_pex_rejected_total{reason}``. The
``pex.gossip`` faultgate site drops or corrupts outbound digests.

The reference rides aiohttp; the card's machine has none, so exchanges
go through the port's standard-library HTTP/1.1 client
(``source/http_client.py``) with the reference's 5 s total deadline and
16-connection limit, and the routes mount on the port's upload server
(``add_pex_routes``). The verdict ledger (``verdicts``: shunned holders,
suspects in digests, self-quarantine) is Queue 1 item 5's and stays
``None`` here; fleet mTLS (item 6) is not ported, so gossip is plain
HTTP.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import random
import time
from typing import Any, Callable

from ..common import faultgate
from ..common.errors import Code
from ..common.metrics import REGISTRY
from ..idl.messages import (PeerAddr, PeerPacket, RegisterResult, SizeScope,
                            TopologyInfo)
from ..source.http_client import HTTPSourceClient
from ..tpu.topology import ici_hops, link_type, pod_id
from . import flight_recorder as fr
from .swarm_index import SwarmEntry, SwarmIndex

log = logging.getLogger("df.flow.pex")

DIGEST_VERSION = 1
# origins whose partial summary claims are retained for /debug/pex,
# and how long a claim outlives the last summary that refreshed it (a
# dead pod seed's stale progress must age out like every other PEX
# structure, and stale corpses must not crowd live seeds out of the cap)
MAX_FED_PARTIALS = 32
FED_PARTIALS_TTL_S = 120.0
# peers dropped from membership after this many consecutive failed rounds
PEER_FAIL_LIMIT = 3
# membership sample size carried per digest (transitive discovery)
PEER_SAMPLE = 16

_digests_sent = REGISTRY.counter(
    "df_pex_digests_sent_total",
    "PEX availability digests pushed to peers", ("result",))
_digests_received = REGISTRY.counter(
    "df_pex_digests_received_total",
    "PEX digests ingested, by transport direction", ("transport",))
_rejected = REGISTRY.counter(
    "df_pex_rejected_total",
    "PEX digests rejected before ingest", ("reason",))
_parent_hits = REGISTRY.counter(
    "df_pex_parent_hits_total",
    "pieces served by parents discovered via PEX gossip")
_primes = REGISTRY.counter(
    "df_pex_prime_total",
    "advisory parent packets pre-populated from the swarm index")
_peers_gauge = REGISTRY.gauge(
    "df_pex_peers", "peers currently in the PEX membership view")
_sched_revived = REGISTRY.counter(
    "df_pex_sched_revived_total",
    "demoted schedulers revived by the PEX ticker's lazy probe")
_fed_summaries = REGISTRY.counter(
    "df_federation_summaries_total",
    "compact inter-pod completeness summaries exchanged between elected "
    "pod seeds (task -> done/have counts, never piece sets), by "
    "direction", ("transport",))


class PeerInfo:
    """One known gossip peer (keyed by upload address)."""

    __slots__ = ("host_id", "ip", "rpc_port", "download_port", "is_seed",
                 "topology", "last_seen", "fails")

    def __init__(self, *, host_id: str, ip: str, rpc_port: int = 0,
                 download_port: int = 0, is_seed: bool = False,
                 topology: TopologyInfo | None = None):
        self.host_id = host_id
        self.ip = ip
        self.rpc_port = rpc_port
        self.download_port = download_port
        self.is_seed = is_seed
        self.topology = topology
        self.last_seen = time.monotonic()
        self.fails = 0

    @property
    def addr(self) -> str:
        return f"{self.ip}:{self.download_port}"

    def describe(self) -> dict:
        return {"host_id": self.host_id, "addr": self.addr,
                "rpc_port": self.rpc_port, "is_seed": self.is_seed,
                "fails": self.fails,
                "age_s": round(time.monotonic() - self.last_seen, 1)}


def _topo_to_wire(t: TopologyInfo | None) -> dict | None:
    if t is None:
        return None
    return {"slice": t.slice_name, "ici": list(t.ici_coords or []) or None,
            "zone": t.zone, "pod": t.pod}


def _topo_from_wire(d: dict | None) -> TopologyInfo | None:
    if not d:
        return None
    ici = d.get("ici")
    return TopologyInfo(slice_name=d.get("slice", ""),
                        ici_coords=tuple(ici) if ici else None,
                        zone=d.get("zone", ""),
                        pod=str(d.get("pod") or ""))


def seal(body: dict) -> bytes:
    """Envelope a digest body: ``sha256hex\\n<canonical JSON>``."""
    payload = json.dumps(body, sort_keys=True,
                         separators=(",", ":")).encode()
    return hashlib.sha256(payload).hexdigest().encode() + b"\n" + payload


def unseal(raw: bytes) -> dict | None:
    """Verify + parse an envelope; None (and a counted rejection) when the
    checksum, JSON, or version is bad."""
    head, sep, payload = raw.partition(b"\n")
    if not sep or hashlib.sha256(payload).hexdigest().encode() != head:
        _rejected.labels("checksum").inc()
        return None
    try:
        body = json.loads(payload)
    except (ValueError, UnicodeDecodeError):
        _rejected.labels("parse").inc()
        return None
    if not isinstance(body, dict) or body.get("v") != DIGEST_VERSION:
        _rejected.labels("version").inc()
        return None
    return body


class _GossipClient:
    """The gossip plane's HTTP client: the source client's keep-alive
    HTTP/1.1 with a request body, a 5 s total deadline per exchange and
    at most 16 exchanges in flight (the reference's aiohttp
    ``ClientTimeout(total=5.0)`` and ``TCPConnector(limit=16)``)."""

    TIMEOUT_S = 5.0
    LIMIT = 16

    def __init__(self) -> None:
        self._http = HTTPSourceClient()
        self._sem: asyncio.Semaphore | None = None

    async def post(self, url: str, payload: bytes) -> tuple[int, bytes]:
        """POST ``payload``; returns (status, whole response body)."""
        if self._sem is None:
            self._sem = asyncio.Semaphore(self.LIMIT)
        async with self._sem:
            return await asyncio.wait_for(self._exchange(url, payload),
                                          self.TIMEOUT_S)

    async def _exchange(self, url: str, payload: bytes) -> tuple[int, bytes]:
        resp = await self._http._request(
            "POST", url, {"Content-Type": "application/octet-stream"},
            self.TIMEOUT_S, body=payload)
        body = bytearray()
        async for chunk in resp.chunks():
            body += chunk
        return resp.status, bytes(body)

    async def close(self) -> None:
        await self._http.close()


class PexGossiper:
    """The daemon's PEX plane: membership + ticker + digest codec +
    the conductor-facing ``prime``/``try_pull`` ladder hooks."""

    def __init__(self, *, storage_mgr: Any, host_info: Callable[[], Any],
                 index: SwarmIndex | None = None, interval_s: float = 5.0,
                 fanout: int = 3, max_digest_tasks: int = 256,
                 bootstrap: list[str] | None = None,
                 scheduler: Any = None,
                 engine_factory: Callable[[], Any] | None = None,
                 relay: Any = None,
                 verdicts: Any = None,
                 pod_scope: bool = True,
                 pod_seed: bool = False,
                 federation_peers: list[str] | None = None,
                 rng: random.Random | None = None):
        self.storage_mgr = storage_mgr
        # cross-pod federation: full piece-set digests
        # stay POD-SCOPED (gossip bandwidth must not grow with total
        # fleet size) — when this host has a pod identity, full digests
        # only target same-pod (or pod-less) peers. A daemon configured
        # as a pod seed additionally exchanges the COMPACT inter-pod
        # summary (build_summary: task -> completeness, never piece
        # sets) with the other pods' seeds named in federation_peers.
        self.pod_scope = pod_scope
        self.pod_seed = pod_seed
        self.federation_peers = list(federation_peers or [])
        # receiver-side view of other pods' PARTIAL progress claims from
        # inter-pod summaries (task -> have/total per origin host): never
        # indexed as coverage (a count is not a piece set), but surfaced
        # on /debug/pex so "how far along is pod B's seed" is answerable
        # without asking pod B; bounded per MAX_FED_PARTIALS
        self.fed_partials: dict[str, dict] = {}
        # per-federation-peer failure cooldown: federation_peers is
        # STATIC config, so a decommissioned seed would otherwise add a
        # full HTTP timeout to every round forever — a failed addr sits
        # out like an evicted gossip peer does (_dead_until semantics)
        self._fed_backoff: dict[str, float] = {}
        self.relay = relay               # RelayHub: watermark in digests
        # per-parent verdict ledger (daemon/verdicts.py): shunned holders
        # are dropped from the swarm index and the pex rung's candidates;
        # digests carry our LOCAL corrupt suspects as hints (receivers
        # deprioritize only — the anti-slander rule) and, when this
        # daemon self-quarantines, advertise NO tasks at all
        self.verdicts = verdicts
        self.host_info = host_info       # lazy: ports resolve after bind
        self.index = index if index is not None else SwarmIndex()
        self.interval_s = interval_s
        self.fanout = max(1, fanout)
        self.max_digest_tasks = max_digest_tasks
        self.scheduler = scheduler       # SchedulerConnector (probe revival)
        self.engine_factory = engine_factory
        self.rng = rng or random.Random()
        self.peers: dict[str, PeerInfo] = {}    # addr -> PeerInfo
        self._dead_until: dict[str, float] = {}  # evicted addr -> cooldown
        self._self_keys_memo: tuple[str, str] | None = None
        self._bootstrap = list(bootstrap or [])
        self._task: asyncio.Task | None = None
        self._http: _GossipClient | None = None    # lazy
        self.rounds = 0

    # -- membership ----------------------------------------------------

    def _self_keys(self) -> tuple[str, str]:
        # cached once the upload port is bound: host_info() rebuilds the
        # full Host message (os.uname x2) and this runs per observed peer
        cached = self._self_keys_memo
        if cached is not None:
            return cached
        host = self.host_info()
        keys = (host.id, f"{host.ip}:{host.download_port}")
        if host.download_port:
            self._self_keys_memo = keys
        return keys

    def observe_peer(self, *, host_id: str, ip: str, rpc_port: int = 0,
                     download_port: int = 0, is_seed: bool = False,
                     topology: TopologyInfo | None = None,
                     direct: bool = False) -> None:
        """``direct``: first-hand liveness evidence (a digest FROM the peer
        itself, or a parent the scheduler just assigned). Indirect mentions
        — bootstrap re-seeds and other peers' gossip samples — may CREATE
        an entry but never refresh fails/last_seen: otherwise a dead peer
        that lives on in everyone's peer sample is re-blessed faster than
        PEER_FAIL_LIMIT can evict it, membership fills with immortal
        ghosts, and each ghost burns a fanout slot + an HTTP timeout per
        round. Evicted addresses sit out a cooldown before an indirect
        mention may re-create them (direct evidence re-admits at once)."""
        if not ip or not download_port:
            return
        self_id, self_addr = self._self_keys()
        addr = f"{ip}:{download_port}"
        if addr == self_addr or (host_id and host_id == self_id):
            return
        info = self.peers.get(addr)
        if info is None:
            if not direct and self._dead_until.get(addr, 0.0) \
                    > time.monotonic():
                return
            info = self.peers[addr] = PeerInfo(
                host_id=host_id or addr, ip=ip, rpc_port=rpc_port,
                download_port=download_port, is_seed=is_seed,
                topology=topology)
            self._dead_until.pop(addr, None)
        else:
            if direct:
                info.last_seen = time.monotonic()
                info.fails = 0
            if host_id:
                # bootstrap entries start keyed-by-address; the first
                # digest from the peer upgrades them to its real identity
                info.host_id = host_id
            if rpc_port:
                info.rpc_port = rpc_port
            if topology is not None:
                info.topology = topology
            info.is_seed = info.is_seed or is_seed
        _peers_gauge.set(len(self.peers))

    def observe_parent(self, parent: PeerAddr) -> None:
        """piece_engine hook: every scheduler-assigned parent joins the
        gossip membership — the mesh the scheduler built keeps working as
        the discovery substrate after the scheduler goes away. A live
        assignment is first-hand evidence (the scheduler is actively
        steering traffic at it) — but parents WE minted from the swarm
        index (prime/try_pull packets, peer_id "pex-...") are this plane's
        own hearsay and must not loop back as first-hand liveness, or a
        dead host's 60s-TTL index entries would keep re-blessing its
        membership entry past the fail-limit eviction."""
        if parent.peer_id.startswith("pex-"):
            return
        self.observe_peer(host_id="", ip=parent.ip,
                          rpc_port=parent.rpc_port,
                          download_port=parent.download_port,
                          is_seed=parent.is_seed, direct=True)

    def _targets(self) -> list[PeerInfo]:
        """Gossip fanout for this round: ICI neighbors first (cheapest
        links carry the chattiest traffic), then by freshness, with one
        random pick appended so distant membership still converges.
        Pod-scoped (``pod_scope``): when this host knows its pod, FULL
        piece-set digests go only to same-pod (or pod-less) peers —
        cross-pod availability travels as the seeds' compact summaries
        instead, so per-round gossip bytes scale with the POD, not the
        fleet."""
        host = self.host_info()
        mine = getattr(host, "topology", None)
        peers = list(self.peers.values())
        my_pod = pod_id(mine)
        if self.pod_scope and my_pod:
            local = [p for p in peers
                     if pod_id(p.topology) in ("", my_pod)]
            # lone-daemon fallback: a fresh pod's first daemon often
            # knows ONLY another pod's seed (its bootstrap) — gossiping
            # cross-pod beats being isolated entirely; the scope bounds
            # the steady state, it must never silence the boot
            peers = local or peers
        if not peers:
            return []
        peers.sort(key=lambda p: (int(link_type(mine, p.topology)),
                                  ici_hops(mine, p.topology)
                                  if mine is not None and
                                  p.topology is not None else 1 << 16,
                                  -p.last_seen, p.addr))
        picked = peers[:self.fanout]
        rest = peers[self.fanout:]
        if rest:
            picked.append(self.rng.choice(rest))
        return picked

    # -- digest codec --------------------------------------------------

    def build_digest(self) -> dict:
        host = self.host_info()
        tasks = []
        selfq = self.verdicts is not None and self.verdicts.self_quarantined
        for ts in () if selfq else self.storage_mgr.tasks():
            md = ts.md
            if not md.pieces and not (md.done and md.success):
                continue
            done = bool(md.done and md.success)
            entry = {"task_id": md.task_id,
                     "total": md.total_piece_count,
                     "content_length": md.content_length,
                     "piece_size": md.piece_size,
                     "done": done}
            if not done:
                entry["pieces"] = sorted(md.pieces)
                if self.relay is not None:
                    # the advertised landing watermark: pieces arriving
                    # on this daemon NOW — cut-through-servable, counted
                    # toward coverage only while the watermark stays
                    # fresh (SwarmEntry.progress_fresh)
                    wm = sorted({i.piece_num for i in
                                 self.relay.inflight_infos(md.task_id)}
                                - set(md.pieces))
                    if wm:
                        entry["relay"] = wm
            tasks.append(entry)
            if len(tasks) >= self.max_digest_tasks:
                break
        sample = list(self.peers.values())
        if len(sample) > PEER_SAMPLE:
            sample = self.rng.sample(sample, PEER_SAMPLE)
        digest = {
            "v": DIGEST_VERSION,
            "origin": {"host_id": host.id, "ip": host.ip,
                       "rpc_port": host.port,
                       "download_port": host.download_port,
                       "is_seed": int(host.type) != 0,
                       "selfq": selfq,
                       "topology": _topo_to_wire(
                           getattr(host, "topology", None))},
            "peers": [{"host_id": p.host_id, "ip": p.ip,
                       "rpc_port": p.rpc_port,
                       "download_port": p.download_port,
                       "is_seed": p.is_seed,
                       "topology": _topo_to_wire(p.topology)}
                      for p in sample],
            "tasks": tasks,
        }
        if self.verdicts is not None:
            # LOCAL corrupt-shun verdicts only, bounded: receivers treat
            # these as hearsay hints (deprioritize, never shun) — see the
            # anti-slander contract in daemon/verdicts.py
            suspects = self.verdicts.shunned_addrs()[:8]
            if suspects:
                digest["suspects"] = suspects
        return digest

    def envelope(self) -> bytes:
        return seal(self.build_digest())

    def build_summary(self) -> dict:
        """The compact inter-pod digest: per task one COMPLETENESS row —
        done flag, landed count, geometry — and no piece sets, no peer
        sample. This is what elected pod seeds exchange across the DCN:
        a complete cross-pod holder is indexable (a seed can pull whole
        tasks through it), a partial one is a counter for observability
        only (``ingest`` skips pieceless partial rows, so a summary can
        never plant phantom partial coverage the pex rung would park
        on). Size is O(tasks), independent of pod or fleet size."""
        host = self.host_info()
        tasks = []
        selfq = self.verdicts is not None and self.verdicts.self_quarantined
        for ts in () if selfq else self.storage_mgr.tasks():
            md = ts.md
            if not md.pieces and not (md.done and md.success):
                continue
            tasks.append({"task_id": md.task_id,
                          "total": md.total_piece_count,
                          "content_length": md.content_length,
                          "piece_size": md.piece_size,
                          "done": bool(md.done and md.success),
                          "have": len(md.pieces)})
            if len(tasks) >= self.max_digest_tasks:
                break
        return {
            "v": DIGEST_VERSION,
            "kind": "summary",
            "origin": {"host_id": host.id, "ip": host.ip,
                       "rpc_port": host.port,
                       "download_port": host.download_port,
                       "is_seed": int(host.type) != 0,
                       "selfq": selfq,
                       "topology": _topo_to_wire(
                           getattr(host, "topology", None))},
            "peers": [],
            "tasks": tasks,
        }

    def summary_envelope(self) -> bytes:
        return seal(self.build_summary())

    def ingest(self, raw: bytes, *, transport: str = "push") -> bool:
        """Verify + merge a received envelope. False = rejected (checksum,
        JSON, version, or field types — the seal only proves the sender
        sealed these bytes, not that the fields are well-typed, so the
        whole body is coerced BEFORE anything mutates membership: a
        version-skewed peer must produce a counted rejection, not a 500
        and a half-merged view)."""
        body = unseal(raw)
        if body is None:
            return False
        try:
            body_kind = str(body.get("kind") or "digest")
            partials: dict[str, dict] = {}
            origin = body.get("origin") or {}
            topo = _topo_from_wire(origin.get("topology"))
            host_id = str(origin.get("host_id") or "")
            ip = str(origin.get("ip") or "")
            rpc_port = int(origin.get("rpc_port") or 0)
            download_port = int(origin.get("download_port") or 0)
            is_seed = bool(origin.get("is_seed"))
            origin_selfq = bool(origin.get("selfq"))
            suspects = [str(a) for a in body.get("suspects") or []][:16]
            sampled = [dict(host_id=str(p.get("host_id") or ""),
                            ip=str(p.get("ip") or ""),
                            rpc_port=int(p.get("rpc_port") or 0),
                            download_port=int(p.get("download_port") or 0),
                            is_seed=bool(p.get("is_seed")),
                            topology=_topo_from_wire(p.get("topology")))
                       for p in body.get("peers") or []]
            entries = []
            for t in body.get("tasks") or []:
                task_id = str(t.get("task_id") or "")
                if not task_id:
                    continue
                done = bool(t.get("done"))
                pieces = (None if done
                          else {int(n) for n in t.get("pieces") or []})
                relay_pieces = (None if done
                                else {int(n) for n in t.get("relay") or []}
                                or None)
                if not done and not pieces and not relay_pieces:
                    if body_kind == "summary":
                        # partial cross-pod claims are NEVER coverage (a
                        # count is not a piece set) but they ARE progress
                        # observability — retained for /debug/pex
                        partials[task_id] = {
                            "have": int(t.get("have") or 0),
                            "total": int(t.get("total", -1))}
                    continue
                entries.append((task_id, SwarmEntry(
                    host_id=host_id or f"{ip}:{download_port}", ip=ip,
                    rpc_port=rpc_port, download_port=download_port,
                    is_seed=is_seed, topology=topo, pieces=pieces,
                    relay_pieces=relay_pieces,
                    total_pieces=int(t.get("total", -1)),
                    content_length=int(t.get("content_length", -1)),
                    piece_size=int(t.get("piece_size", 0)), done=done)))
        except (ValueError, TypeError, AttributeError):
            _rejected.labels("parse").inc()
            return False
        self_id, self_addr = self._self_keys()
        if host_id == self_id or f"{ip}:{download_port}" == self_addr:
            return True      # our own digest reflected back: nothing to do
        # the digest came FROM its origin: first-hand liveness; the peer
        # sample is hearsay and may only create entries, never refresh
        self.observe_peer(host_id=host_id, ip=ip, rpc_port=rpc_port,
                          download_port=download_port, is_seed=is_seed,
                          topology=topo, direct=True)
        for p in sampled:
            self.observe_peer(**p)
        origin_addr = f"{ip}:{download_port}"
        if self.verdicts is not None:
            # third-party accusations are hearsay: HINT only (the
            # accused host is deprioritized in parent ordering, never
            # shunned — one forged digest must not evict an honest host)
            for a in suspects:
                if a != self_addr and a != origin_addr:
                    self.verdicts.hint(a)
        locally_shunned = (self.verdicts is not None
                           and self.verdicts.shunned(origin_addr))
        if origin_selfq or locally_shunned:
            # a self-quarantined origin asked to be excluded; a locally-
            # shunned one served US corruption first-hand — either way its
            # availability claims stop being indexed (and prior claims go)
            self.index.forget_host(host_id or origin_addr)
        elif ip and download_port:
            for task_id, entry in entries:
                self.index.update(task_id, entry)
        if body_kind == "summary" and not origin_selfq:
            key = host_id or origin_addr
            self.fed_partials.pop(key, None)
            self._purge_fed_partials()
            if partials and len(self.fed_partials) < MAX_FED_PARTIALS:
                self.fed_partials[key] = {"at": time.monotonic(),
                                          "tasks": partials}
        _digests_received.labels(transport).inc()
        return True

    def _purge_fed_partials(self, *, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        for key in [k for k, v in self.fed_partials.items()
                    if now - v["at"] > FED_PARTIALS_TTL_S]:
            del self.fed_partials[key]

    # -- gossip rounds -------------------------------------------------

    def _client(self) -> _GossipClient:
        if self._http is None:
            self._http = _GossipClient()
        return self._http

    async def _push_pull(self, url: str, payload: bytes) -> bytes:
        """One push-pull exchange; the reply body (the peer's own
        envelope) or OSError for a non-200 answer."""
        status, reply = await self._client().post(url, payload)
        if status != 200:
            raise OSError(f"HTTP {status}")
        return reply

    async def round(self) -> int:
        """One gossip round: purge, push-pull with the fanout targets,
        probe demoted schedulers. Returns digests successfully exchanged.
        Public so tests and operators can drive it deterministically."""
        self.rounds += 1
        self.index.purge()
        self._purge_fed_partials()
        if self.verdicts is not None:
            # verdicts may have flipped since the entries landed: a
            # holder shunned mid-interval stops being offerable NOW, not
            # at its next digest
            for p in list(self.peers.values()):
                if self.verdicts.shunned(p.addr):
                    self.index.forget_host(p.host_id)
        for addr in self._bootstrap:
            ip, _, port = addr.rpartition(":")
            if ip and port.isdigit():
                self.observe_peer(host_id="", ip=ip,
                                  download_port=int(port))
        exchanged = 0
        for peer in self._targets():
            try:
                if faultgate.ARMED:
                    # fail/delay/hang drop or stall THIS edge's exchange —
                    # the round moves on to the next target (fail) or rides
                    # its own HTTP timeout (hang), exactly like a wedged
                    # peer; 'corrupt' flips an envelope byte so the
                    # receiver's checksum rejects it
                    await faultgate.fire("pex.gossip", key=peer.addr)
                payload = self.envelope()
                if faultgate.ARMED:
                    payload = faultgate.corrupt("pex.gossip", payload,
                                                key=peer.addr)
                url = f"http://{peer.addr}/pex/digest"
                reply = await self._push_pull(url, payload)
                # anti-entropy pull: the reply is the peer's digest
                self.ingest(reply, transport="pull")
                peer.last_seen = time.monotonic()
                peer.fails = 0
                exchanged += 1
                _digests_sent.labels("ok").inc()
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 - peer churn is normal
                _digests_sent.labels("error").inc()
                peer.fails += 1
                log.debug("pex exchange with %s failed (%d/%d): %s",
                          peer.addr, peer.fails, PEER_FAIL_LIMIT, exc)
                if peer.fails >= PEER_FAIL_LIMIT:
                    self.peers.pop(peer.addr, None)
                    self.index.forget_host(peer.host_id)
                    # cooldown before hearsay (bootstrap re-seeds, other
                    # peers' samples) may re-create the entry — a dead
                    # address must not ride re-creation back to fails=0
                    # every round; a digest FROM the address re-admits it
                    # immediately
                    self._dead_until[peer.addr] = (
                        time.monotonic() + 10 * self.interval_s)
                    _peers_gauge.set(len(self.peers))
        exchanged += await self._federation_round()
        await self._probe_demoted_schedulers()
        return exchanged

    async def _federation_round(self) -> int:
        """The inter-pod half: an elected pod seed push-pulls the COMPACT
        completeness summary with the other pods' seeds
        (``federation_peers``). Rides the same ``pex.gossip`` faultgate
        site as in-pod digests, with its own failure cooldown (the peer
        list is static config, so a dead seed backs off instead of being
        evicted), and never grows with pod size — cross-pod gossip is
        O(seeds x tasks), which is how the PEX plane scales to a fleet
        without every daemon gossiping with every other pod."""
        if not self.pod_seed or not self.federation_peers:
            return 0
        exchanged = 0
        now = time.monotonic()
        window = [a for a in self.federation_peers
                  if self._fed_backoff.get(a, 0.0) <= now]
        if len(window) > self.fanout + 1:
            # rotate the window by round so every configured seed pair
            # eventually exchanges — a fixed prefix would leave pods
            # beyond it permanently blind to each other (summaries carry
            # no transitive re-gossip by design)
            start = self.rounds % len(window)
            window = [window[(start + k) % len(window)]
                      for k in range(self.fanout + 1)]
        for addr in window:
            ip, _, port = addr.rpartition(":")
            if not ip or not port.isdigit():
                continue
            try:
                if faultgate.ARMED:
                    await faultgate.fire("pex.gossip", key=addr)
                payload = self.summary_envelope()
                if faultgate.ARMED:
                    payload = faultgate.corrupt("pex.gossip", payload,
                                                key=addr)
                url = f"http://{addr}/pex/summary"
                self.ingest(await self._push_pull(url, payload),
                            transport="summary")
                exchanged += 1
                self._fed_backoff.pop(addr, None)
                _fed_summaries.labels("sent").inc()
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 - seed churn is normal
                _fed_summaries.labels("error").inc()
                self._fed_backoff[addr] = (time.monotonic()
                                           + 10 * self.interval_s)
                log.debug("inter-pod summary with %s failed: %s", addr, exc)
        return exchanged

    async def _probe_demoted_schedulers(self) -> None:
        """Lazy revival ride-along: without this, a demoted scheduler is
        only ever re-probed when some task's register happens to hash near
        it — a quiet daemon would sit on the pex/back_source rungs long
        after the control plane healed."""
        sched = self.scheduler
        probe = getattr(sched, "probe_demoted", None)
        if probe is None or not getattr(sched, "demoted", lambda: ())():
            return
        try:
            revived = await probe()
            if revived:
                _sched_revived.inc(len(revived))
                log.info("pex ticker revived schedulers: %s", revived)
        except Exception as exc:  # noqa: BLE001 - probe is best-effort
            log.debug("scheduler probe failed: %s", exc)

    async def _loop(self, *, initial_round: bool = False) -> None:
        if initial_round:
            # warm-restart re-seed: push the reloaded-from-disk digest to
            # the bootstrap/known peers immediately so the swarm re-learns
            # this holder within one round, not one jittered interval
            try:
                await self.round()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - keep the ticker alive
                log.exception("pex initial round failed")
        while True:
            # jittered so a pod's daemons never gossip in phase
            await asyncio.sleep(self.interval_s *
                                self.rng.uniform(0.6, 1.4))
            try:
                await self.round()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - keep the ticker alive
                log.exception("pex round failed")

    async def start(self, *, initial_round: bool = False) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(
                self._loop(initial_round=initial_round))

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self._http is not None:
            await self._http.close()
            self._http = None

    # -- degradation-ladder hooks (conductor) --------------------------

    def _candidates(self, conductor) -> list:
        host = self.host_info()
        mine = getattr(host, "topology", None)
        entries = self.index.parents_for(
            conductor.task_id,
            self_topology=mine,
            exclude_host=host.id)
        if self.verdicts is not None:
            # the pex rung has no scheduler to rescue it from a poisoner:
            # locally-shunned holders are OUT — and they are dropped
            # BEFORE the pod-first gate below, or a shunned in-pod
            # holder would both satisfy coverage and discard the clean
            # cross-pod fallback, pushing the pull all the way to origin
            entries = [e for e in entries
                       if not self.verdicts.shunned(e.addr)]
        my_pod = pod_id(mine)
        if my_pod and entries:
            # pod-first rung: when pod-local holders (incl. pod-less
            # plain peers) cover everything this conductor still needs,
            # never cross the DCN — cross-pod entries (the seeds'
            # summary-advertised holders) are the fallback for content
            # the pod does not hold, not a parallel source that would
            # turn every cache miss into N DCN streams
            local = [e for e in entries
                     if pod_id(e.topology) in ("", my_pod)]
            if local and self._covers_task(local, conductor):
                entries = local
        if self.verdicts is not None:
            # hinted/suspect holders sort last (deprioritized, still
            # usable — the anti-slander rule's ceiling for hearsay)
            entries.sort(key=lambda e: 1 if self.verdicts.deprioritized(
                e.addr) else 0)
        return entries

    def _packet(self, conductor, entries, *, advisory: bool) -> PeerPacket:
        mine = getattr(self.host_info(), "topology", None)
        return PeerPacket(
            task_id=conductor.task_id, src_peer_id=conductor.peer_id,
            advisory=advisory,
            candidate_peers=[
                PeerAddr(peer_id=f"pex-{e.host_id}", ip=e.ip,
                         rpc_port=e.rpc_port,
                         download_port=e.download_port,
                         link=link_type(mine, e.topology),
                         is_seed=e.is_seed)
                for e in entries if e.rpc_port and e.download_port])

    def prime(self, conductor, session) -> None:
        """Hot-task pre-population: enqueue swarm-known holders as an
        ADVISORY packet on a live scheduler session, so the engine has
        parents to pull from before (or while) the scheduler's own
        assignment lands. Advisory packets never prune the scheduler's
        assignment (piece_engine honors the flag) — the scheduler stays
        the authority whenever it is reachable."""
        entries = self._candidates(conductor)
        if not entries:
            return
        packet = self._packet(conductor, entries[:self.fanout + 1],
                              advisory=True)
        if not packet.candidate_peers:
            return
        session.packets.put_nowait(packet)
        _primes.inc()

    def _covers_task(self, entries, conductor) -> bool:
        """Coverage gate for the pex rung: there is no scheduler behind a
        pex pull, so nobody rescues it if the gossip-known holders turn
        out not to have the whole task — the engine would land the covered
        pieces and then park forever waiting for announcements that can
        never come (a seed riding this rung while its leechers wait on IT
        is a distributed deadlock).
        Proceed only when some holder is complete, or the partial holders'
        piece sets collectively cover every piece this conductor still
        needs; otherwise decline and let the ladder continue to
        back_source.

        In-flight watermark claims (``relay_pieces``) count toward
        coverage ONLY while the holder's watermark is fresh
        (``progress_fresh`` within the index's progress TTL): a stale
        watermark is a download that died mid-flight — counting its
        abandoned pieces would re-open the parked-forever hole this gate
        closes."""
        if any(e.done or e.pieces is None for e in entries):
            return True
        total = max((e.total_pieces for e in entries), default=-1)
        if total < 0:
            # nobody is complete and nobody knows the geometry: the pull
            # could not even tell how much is missing
            return False
        now = time.monotonic()
        ttl = self.index.progress_ttl_s
        union: set[int] = set()
        for e in entries:
            union |= e.pieces or set()
            if e.relay_pieces and e.progress_fresh(now, ttl):
                union |= e.relay_pieces
        need = set(range(total)) - set(conductor.ready)
        return need <= union

    async def try_pull(self, conductor) -> bool:
        """The ``pex`` rung: serve the task from SwarmIndex holders with a
        fresh P2P engine and a synthetic session — no scheduler anywhere
        in the loop. False = rung declined (no holders / no engine) and
        the ladder continues to back_source."""
        if self.engine_factory is None:
            return False
        entries = self._candidates(conductor)
        if not entries:
            return False
        if not self._covers_task(entries, conductor):
            return False
        geo = next((e for e in entries if e.content_length >= 0), None)
        packet = self._packet(conductor, entries, advisory=False)
        if not packet.candidate_peers:
            return False
        if conductor.flight is not None:
            conductor.flight.rung(fr.RUNG_PEX)
        conductor.log.info("pex rung: pulling from %d gossip-discovered "
                           "holder(s)", len(packet.candidate_peers))
        session = _PexSession(RegisterResult(
            task_id=conductor.task_id, size_scope=SizeScope.NORMAL,
            content_length=geo.content_length if geo is not None else -1,
            piece_size=geo.piece_size if geo is not None else 0), [packet])
        engine = self.engine_factory()
        return await engine.pull(conductor, session)

    # -- debug surface -------------------------------------------------

    def _fed_partials_view(self) -> dict:
        self._purge_fed_partials()
        now = time.monotonic()
        return {key: {"age_s": round(now - v["at"], 1), "tasks": v["tasks"]}
                for key, v in self.fed_partials.items()}

    def debug_snapshot(self) -> dict:
        host = self.host_info()
        topo = getattr(host, "topology", None)
        return {
            "interval_s": self.interval_s,
            "fanout": self.fanout,
            "rounds": self.rounds,
            # this daemon's own fabric position (pod, slice, zone)
            "host": {"pod": pod_id(topo),
                     "slice": getattr(topo, "slice_name", ""),
                     "zone": getattr(topo, "zone", ""),
                     "pod_seed": self.pod_seed},
            "federation_peers": list(self.federation_peers),
            "federation_partials": self._fed_partials_view(),
            "peers": [p.describe() for p in self.peers.values()],
            "swarm": self.index.snapshot(),
        }


class _PexSession:
    """Synthetic scheduler session for the pex rung: the engine consumes
    ``result``/``packets`` exactly as from a real PeerSession; piece
    reports have no scheduler to go to, so they only feed the
    ``df_pex_parent_hits_total`` counter."""

    # no scheduler behind this session: the engine must self-abort on a
    # stall instead of waiting for a control plane that will never act
    rescuable = False

    def __init__(self, result: RegisterResult, packets: list[PeerPacket]):
        self.result = result
        self.packets: asyncio.Queue = asyncio.Queue()
        for p in packets:
            self.packets.put_nowait(p)

    async def report_piece(self, result) -> None:
        if result.success and result.dst_peer_id \
                and int(result.code or 0) == int(Code.OK):
            _parent_hits.inc()

    async def close(self, *, success: bool) -> None:
        return None


def add_pex_routes(router, gossiper: PexGossiper) -> None:
    """Upload-port routes (``common.httpd.Router``): ``GET /pex/digest``
    (pull), ``POST /pex/digest`` (push; the 200 body is our digest, the
    pull half of push-pull), the inter-pod ``/pex/summary`` pair, and
    ``GET /debug/pex`` (membership and swarm snapshot). A body that fails
    ingest is answered 400. Mesh-internal and bounded like
    ``/debug/flight``, so not behind a debug flag."""

    async def get_digest(_params: dict, _query: dict) -> tuple[int, bytes]:
        return 200, gossiper.envelope()

    async def post_digest(_params: dict, _query: dict,
                          raw: bytes) -> tuple[int, bytes | str]:
        if not gossiper.ingest(raw, transport="push"):
            return 400, "digest verification failed"
        return 200, gossiper.envelope()

    async def get_summary(_params: dict, _query: dict) -> tuple[int, bytes]:
        return 200, gossiper.summary_envelope()

    async def post_summary(_params: dict, _query: dict,
                           raw: bytes) -> tuple[int, bytes | str]:
        # the inter-pod half: another pod's seed pushes its completeness
        # summary; the 200 body is OUR summary (push-pull, like digests)
        if not gossiper.ingest(raw, transport="summary"):
            return 400, "summary verification failed"
        _fed_summaries.labels("received").inc()
        return 200, gossiper.summary_envelope()

    async def debug_pex(_params: dict, _query: dict) -> tuple[int, dict]:
        return 200, gossiper.debug_snapshot()

    router.add_get("/pex/digest", get_digest)
    router.add_post("/pex/digest", post_digest)
    router.add_get("/pex/summary", get_summary)
    router.add_post("/pex/summary", post_summary)
    router.add_get("/debug/pex", debug_pex)
