"""Podscope: pod-wide distribution-tree aggregation over daemon snapshots.

Counterpart of ``dragonfly2_tpu/common/podscope.py``. Every per-daemon
surface (``/debug/flight``, ``/debug/health``) sees one end of each
transfer, and the scheduler's ``/debug/cluster`` is blind to the
scheduler-less ``pex`` rung. Podscope reads the debug snapshots of a
daemon SET and rebuilds, per task, the distribution tree the pod used:

  * **edges**: who served whom, with bytes, wire ms and estimated
    bandwidth, seen from the child's piece rows and, where the parent
    journaled the serve (``TaskFlight.serve``), confirmed from the
    parent's side with its serve and limiter timings;
  * **tree and depth**: each daemon hangs off the peer that delivered
    most of its bytes; the origin is depth 0, a back-sourcing or
    pre-seeded root holder depth 1;
  * **pod makespan**: first download activity to the last daemon
    complete, on the daemons' wall clocks;
  * **origin amplification**: origin bytes / content size (1.0 when the
    mesh fetched the content across the origin uplink once; content
    seeded before the observation window reports 1.0 with a note);
  * **seed uplink**: the heaviest-serving node, its share of the mesh's
    bytes and its estimated serve bandwidth;
  * **a bottleneck-edge verdict**: the slowest substantial edge, a
    *breach* only when it runs under 1 / ``BOTTLENECK_FACTOR`` of the
    median edge bandwidth.

Everything below ``collect_pod`` is a pure function over dict snapshots,
so dfbench feeds it simulated flights and the tests synthetic ones;
``collect_pod`` is the HTTP half (``urllib``, one thread per daemon) that
``dfdiag --pod`` uses. ``edges_from_summary`` is the ``kind=edge`` row
source of ``scheduler/records.py``. ``_pctl`` is the package's one
percentile rule; the flight recorder imports it from here.

A daemon's snapshot carries its ``/debug/verdicts``; one without the
route (an older daemon) gives ``None``.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

ORIGIN = "origin"                # node label for back-source fetches
BOTTLENECK_FACTOR = 3.0          # edge slower than median/3 = breach
SUBSTANTIAL_EDGE_SHARE = 0.05    # edges carrying <5% of content are noise
AMPLIFICATION_BREACH = 1.5       # origin pulled >1.5x the content = breach


def _pctl(vals: list[float], q: float) -> float:
    if not vals:
        return 0.0
    s = sorted(vals)
    return round(s[min(len(s) - 1, int(q * len(s)))], 3)


# ---------------------------------------------------------------- collect

def _get_json(url: str, timeout_s: float) -> dict:
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return json.loads(resp.read())


def collect_daemon(addr: str, *, timeout_s: float = 10.0,
                   max_flights: int = 16) -> dict:
    """One daemon's podscope snapshot over HTTP: the flight index + the
    ``max_flights`` most recent full flights, plus /debug/health and
    /debug/pex (each optional — absence is recorded, never raised)."""
    base = f"http://{addr}"
    snap: dict = {"addr": addr, "flights": {}, "health": None, "pex": None}
    index = _get_json(f"{base}/debug/flight", timeout_s)   # raises: caller
    snap["flight_index"] = {k: index.get(k) for k in
                            ("enabled", "max_tasks", "occupancy",
                             "evicted_total")}
    tasks = index.get("tasks") or []
    for row in tasks[-max_flights:]:
        tid = row.get("task_id", "")
        try:
            snap["flights"][tid] = _get_json(
                f"{base}/debug/flight/{tid}", timeout_s)
        except (OSError, ValueError):
            continue            # flight evicted between index and fetch
    for key, path in (("health", "/debug/health"), ("pex", "/debug/pex"),
                      ("verdicts", "/debug/verdicts")):
        try:
            snap[key] = _get_json(f"{base}{path}", timeout_s)
        except (OSError, ValueError):
            snap[key] = None    # older daemon / surface disabled
    return snap


def collect_pod(addrs: list[str], *, timeout_s: float = 10.0,
                max_flights: int = 16) -> list[dict]:
    """Snapshot every daemon; an unreachable one yields
    ``{"addr": ..., "error": ...}`` instead of failing the sweep — a pod
    diagnosis that dies on the first wedged daemon diagnoses nothing.
    Daemons are fetched CONCURRENTLY: one half-stalled daemon answering
    at the timeout edge (the exact condition this tool exists to catch)
    must cost the sweep one daemon's worth of wall time, not the pod's."""
    from concurrent.futures import ThreadPoolExecutor

    def one(addr: str) -> dict:
        try:
            return collect_daemon(addr, timeout_s=timeout_s,
                                  max_flights=max_flights)
        except (OSError, ValueError) as exc:
            return {"addr": addr, "error": str(exc) or type(exc).__name__}

    if not addrs:
        return []
    with ThreadPoolExecutor(max_workers=min(16, len(addrs))) as pool:
        return list(pool.map(one, addrs))


# -------------------------------------------------------------- aggregate

def _flight_summary(flight: dict) -> dict:
    return flight.get("summary") or flight


def _flight_times(flight: dict, summary: dict) -> tuple[float, float]:
    """(abs_start_s, abs_end_s) of a flight on its daemon's wall clock."""
    start = float(flight.get("started_at") or 0.0)
    events = flight.get("events") or []
    if events:
        end_ms = max(e.get("t_ms", 0.0) for e in events)
    else:
        end_ms = max((r.get("start_ms", 0.0) + r.get("total_ms", 0.0)
                      for r in summary.get("piece_rows") or []),
                     default=0.0)
    return start, start + end_ms / 1000.0


def _aggregate_task(task_id: str, holders: list[tuple[str, dict]],
                    pods: dict[str, str] | None = None) -> dict:
    """One task's tree/edge/makespan report from [(addr, flight), ...].
    ``pods`` (addr -> pod id, from each daemon's /debug/pex host block or
    a bench snapshot's ``pod`` label) marks pod-CROSSING edges: the DCN
    tier the federation plane rations, rendered as ``[dcn]`` by
    render_pod and summed into ``cross_pod_bytes``."""
    pods = pods or {}
    peer_to_addr: dict[str, str] = {}
    for addr, flight in holders:
        pid = flight.get("peer_id") or ""
        if pid:
            peer_to_addr[pid] = addr

    def label(peer_id: str) -> str:
        if peer_id == "":
            return ORIGIN
        return peer_to_addr.get(peer_id, peer_id)

    # child-side edges from piece rows; key on resolved (src, dst) labels
    edges: dict[tuple[str, str], dict] = {}
    serve_by_peers: dict[tuple[str, str], dict] = {}
    content = 0
    origin_bytes = 0
    placed_bytes = 0
    starts: list[float] = []
    ends: list[float] = []
    complete = 0
    downloaders = 0
    slo: dict[str, int] = {}
    rungs: dict[str, int] = {}
    # sharded-task readiness across the pod: (host, shard) ready/total
    # tallies + tree-vs-swap byte split from the summaries' shards block
    shards_ready = shards_total = 0
    shard_tree_bytes = shard_swap_bytes = shard_fallbacks = 0
    for addr, flight in holders:
        summary = _flight_summary(flight)
        sh = summary.get("shards")
        if sh:
            shards_ready += sh.get("ready", 0)
            shards_total += sh.get("total", 0)
            shard_tree_bytes += sh.get("tree_bytes", 0)
            shard_swap_bytes += sh.get("swap_bytes", 0)
            shard_fallbacks += sh.get("fallbacks", 0)
        rows = summary.get("piece_rows") or []
        dl_bytes = (summary.get("bytes_p2p", 0)
                    + summary.get("bytes_source", 0)
                    + summary.get("bytes_placed", 0))
        content = max(content, dl_bytes)
        origin_bytes += summary.get("bytes_source", 0)
        placed_bytes += summary.get("bytes_placed", 0)
        for stage, n in (summary.get("slo_breaches") or {}).items():
            slo[stage] = slo.get(stage, 0) + n
        served_rung = summary.get("served_rung") or ""
        if served_rung:
            rungs[served_rung] = rungs.get(served_rung, 0) + 1
        if rows or summary.get("placed_pieces"):
            # placement-only flights (whole-content adoption, full warm
            # restart) have no wire rows but ARE download activity — not
            # counting them would read the healthiest pod as incomplete
            downloaders += 1
            t0, t1 = _flight_times(flight, summary)
            starts.append(t0)
            if flight.get("state") == "success":
                complete += 1
                ends.append(t1)
        for r in rows:
            key = (label(r.get("parent") or ""), addr)
            e = edges.setdefault(key, {
                "src": key[0], "dst": key[1],
                "src_peer": r.get("parent") or "",
                "dst_peer": flight.get("peer_id") or "",
                "bytes": 0, "pieces": 0, "wire_ms": 0.0,
                "ttfb_ms": 0.0, "confirmed": False})
            e["bytes"] += r.get("bytes", 0)
            e["pieces"] += 1
            e["wire_ms"] += r.get("wire_ms", 0.0)
            e["ttfb_ms"] += r.get("ttfb_ms", 0.0)
        # parent-side serve rows (the upload journal): keyed by peer ids —
        # resolved against the child edges below
        my_peer = flight.get("peer_id") or ""
        for srv in flight.get("serves") or []:
            skey = (my_peer, srv.get("peer") or srv.get("addr") or "")
            s = serve_by_peers.setdefault(skey, {
                "bytes": 0, "pieces": 0, "serve_ms": 0.0, "wait_ms": 0.0,
                "relayed_pieces": 0, "src": addr})
            s["bytes"] += srv.get("bytes", 0)
            s["pieces"] += srv.get("pieces", 1)
            s["serve_ms"] += srv.get("serve_ms", 0.0)
            s["wait_ms"] += srv.get("wait_ms", 0.0)
            if srv.get("relayed"):
                s["relayed_pieces"] += srv.get("pieces", 1)

    # stitch: a child edge (src_peer -> dst_peer) confirmed by the
    # parent's serve journal carries the parent-side timings too
    def _attach(e: dict, s: dict) -> None:
        e["confirmed"] = True
        e["serve_ms"] = round(s["serve_ms"], 3)
        e["wait_ms"] = round(s["wait_ms"], 3)
        e["serve_bps"] = (round(s["bytes"] / (s["serve_ms"] / 1e3))
                          if s["serve_ms"] > 0 else 0)
        if s.get("relayed_pieces"):
            # the parent streamed (part of) this edge against its landing
            # watermark: a cut-through edge of the distribution tree
            e["relayed"] = True
            e["relayed_pieces"] = s["relayed_pieces"]

    used_serves: set[tuple[str, str]] = set()
    for e in edges.values():
        # origin edges (src_peer "") must never match an ANONYMOUS serve
        # key ("" is also the peer id of a serve-only flight) — origin
        # bytes by definition did not come off a daemon's upload port
        s = (serve_by_peers.get((e["src_peer"], e["dst_peer"]))
             if e["src_peer"] else None)
        if s is not None:
            used_serves.add((e["src_peer"], e["dst_peer"]))
            _attach(e, s)
        e["wire_ms"] = round(e["wire_ms"], 3)
        e["ttfb_ms"] = round(e["ttfb_ms"], 3)
        e["bandwidth_bps"] = (round(e["bytes"] / (e["wire_ms"] / 1e3))
                              if e["wire_ms"] > 0 else 0)
        # pod-tier mark: both endpoints' pods known and different = a
        # DCN-crossing edge of the two-level federation tree
        sp, dp = pods.get(e["src"], ""), pods.get(e["dst"], "")
        if sp and dp and sp != dp:
            e["cross_pod"] = True
    # fallback stitch: a parent that never downloaded the task here (a
    # restarted seed re-seeded from disk) journals serves on a flight
    # with NO peer id, so the exact key can't match. When a child edge's
    # src peer resolved to no known daemon and exactly ONE daemon holds
    # otherwise-unmatched serve rows for that child, that daemon is the
    # parent: confirm the edge and relabel it to the daemon's address.
    for e in edges.values():
        if e["confirmed"] or not e["src_peer"] or e["src"] == ORIGIN:
            continue               # origin edges never stitch to a daemon
        if e["src"] != e["src_peer"]:
            continue               # src resolved to a daemon; exact only
        cands = [(key, s) for key, s in serve_by_peers.items()
                 if key not in used_serves and key[1] == e["dst_peer"]]
        if len({s["src"] for _k, s in cands}) == 1:
            key, s = cands[0]
            used_serves.add(key)
            e["src"] = s["src"]
            _attach(e, s)

    # the distribution TREE: each node hangs off the src that delivered
    # most of its bytes (the DAG stays in `edges`; the tree is the story)
    nodes = ({e["src"] for e in edges.values()}
             | {e["dst"] for e in edges.values()})
    tree: dict[str, str] = {}
    for dst in {e["dst"] for e in edges.values()}:
        best = max((e for e in edges.values() if e["dst"] == dst),
                   key=lambda e: e["bytes"])
        tree[dst] = best["src"]

    depth_memo: dict[str, int] = {ORIGIN: 0}

    def depth_of(node: str, seen: frozenset = frozenset()) -> int:
        if node in depth_memo:
            return depth_memo[node]
        if node in seen:        # swarm cross-serve cycle: cut here
            return 1
        parent = tree.get(node)
        # a node that only serves (pre-seeded / restarted seed) is a
        # root holder: depth 1, same as a back-sourcing daemon
        d = 1 if parent is None else depth_of(parent, seen | {node}) + 1
        depth_memo[node] = d
        return d

    depth = max((depth_of(n) for n in nodes), default=0)

    # relay view: the cut-through sub-tree — how deep the pipelined
    # chains ran and what each hop added in first-byte latency (the
    # per-hop tax a relay chain pays instead of a full store-and-forward
    # piece time)
    relay = None
    relay_edges = [e for e in edges.values() if e.get("relayed")]
    if relay_edges:
        ekey = {(e["src"], e["dst"]): e for e in edges.values()}
        rdepth_memo: dict[str, int] = {}

        def relay_depth_of(node: str, seen: frozenset = frozenset()) -> int:
            """Consecutive relayed tree edges above ``node``."""
            if node in rdepth_memo:
                return rdepth_memo[node]
            if node in seen:
                return 0
            parent = tree.get(node)
            e = ekey.get((parent, node)) if parent is not None else None
            d = (relay_depth_of(parent, seen | {node}) + 1
                 if e is not None and e.get("relayed") else 0)
            rdepth_memo[node] = d
            return d

        relay = {
            "edges": len(relay_edges),
            "pieces": sum(e.get("relayed_pieces", 0) for e in relay_edges),
            "depth": max((relay_depth_of(n) for n in nodes), default=0),
            "per_hop_added_ms": _pctl(
                [e["ttfb_ms"] / max(e["pieces"], 1)
                 for e in relay_edges], 0.5),
        }

    # seed uplink: the heaviest server and what it sustained. The serve
    # journal's rate is preferred, but only over the bytes it actually
    # covered — a node with one confirmed and one unconfirmed edge must
    # not have ALL its bytes divided by the confirmed edge's serve time
    served: dict[str, dict] = {}
    for e in edges.values():
        if e["src"] == ORIGIN:
            continue
        sv = served.setdefault(e["src"], {"bytes": 0, "wire_ms": 0.0,
                                          "serve_ms": 0.0,
                                          "serve_bytes": 0})
        sv["bytes"] += e["bytes"]
        sv["wire_ms"] += e["wire_ms"]
        if e.get("serve_ms"):
            sv["serve_ms"] += e["serve_ms"]
            sv["serve_bytes"] += e["bytes"]
    p2p_bytes = sum(sv["bytes"] for sv in served.values())
    seed_uplink = None
    if served:
        top = max(served, key=lambda n: served[n]["bytes"])
        sv = served[top]
        if sv["serve_ms"] > 0:
            rate = sv["serve_bytes"] / (sv["serve_ms"] / 1e3)
        elif sv["wire_ms"] > 0:
            rate = sv["bytes"] / (sv["wire_ms"] / 1e3)
        else:
            rate = 0.0
        seed_uplink = {
            "node": top, "bytes": sv["bytes"],
            "share": round(sv["bytes"] / p2p_bytes, 4) if p2p_bytes else 0.0,
            "est_bandwidth_bps": round(rate)}

    # bottleneck: slowest edge that carried a substantial share
    bottleneck = None
    floor = max(1, int(content * SUBSTANTIAL_EDGE_SHARE))
    substantial = [e for e in edges.values()
                   if e["bytes"] >= floor and e["bandwidth_bps"] > 0]
    if substantial:
        worst = min(substantial, key=lambda e: e["bandwidth_bps"])
        med = _pctl([e["bandwidth_bps"] for e in substantial], 0.5)
        bottleneck = {
            "src": worst["src"], "dst": worst["dst"],
            "bytes": worst["bytes"],
            "bandwidth_bps": worst["bandwidth_bps"],
            "median_bps": med,
            "straggler": (len(substantial) >= 3 and med > 0
                          and worst["bandwidth_bps"]
                          * BOTTLENECK_FACTOR < med)}

    if origin_bytes == 0 and placed_bytes > 0:
        # dedupe-served: the pod moved nothing across the origin uplink
        # because the bytes were already held (content store placements /
        # warm restart) — 0.0 with this note is the HEALTHY reading, not
        # a blind observation window
        amplification, amp_note = 0.0, "healthy-warm: dedupe-served " \
            "from the content store"
    elif origin_bytes == 0 and content > 0:
        amplification, amp_note = 1.0, "seeded before observation"
    else:
        amplification = (round(origin_bytes / content, 4) if content
                         else 0.0)
        amp_note = ""
    makespan_ms = (round((max(ends) - min(starts)) * 1000.0, 3)
                   if starts and ends else 0.0)
    cross_pod_bytes = sum(e["bytes"] for e in edges.values()
                          if e.get("cross_pod"))
    return {
        "task_id": task_id,
        "content_length": content,
        "daemons": downloaders,
        "complete": complete,
        "makespan_ms": makespan_ms,
        "depth": depth,
        "origin_bytes": origin_bytes,
        "placed_bytes": placed_bytes,
        "cross_pod_bytes": cross_pod_bytes,
        "amplification": amplification,
        "amplification_note": amp_note,
        "edges": sorted(edges.values(),
                        key=lambda e: (e["src"], e["dst"])),
        "tree": tree,
        "relay": relay,
        "bottleneck": bottleneck,
        "seed_uplink": seed_uplink,
        "slo_breaches": slo,
        "rungs": rungs,
        "shards": ({"ready": shards_ready, "total": shards_total,
                    "tree_bytes": shard_tree_bytes,
                    "swap_bytes": shard_swap_bytes,
                    "fallbacks": shard_fallbacks}
                   if shards_total else None),
    }


def aggregate(snapshots: list[dict]) -> dict:
    """The pod report: per-task tree/edge/makespan aggregation plus a
    pod-level breach list (the CI-gate surface — `dfdiag --pod` exits
    non-zero when it is non-empty) and a one-paragraph verdict."""
    unreachable = {s["addr"]: s["error"] for s in snapshots if "error" in s}
    by_task: dict[str, list[tuple[str, dict]]] = {}
    daemons_detail: dict[str, dict] = {}
    # addr -> pod id: from a bench snapshot's own label, else the
    # daemon's /debug/pex host block — the per-tier edge marks' source
    pods: dict[str, str] = {}
    for s in snapshots:
        pod = (s.get("pod")
               or ((s.get("pex") or {}).get("host") or {}).get("pod") or "")
        if pod:
            pods[s["addr"]] = pod
        for tid, flight in (s.get("flights") or {}).items():
            by_task.setdefault(tid, []).append((s["addr"], flight))
        if "error" in s:
            continue
        # the per-daemon health/pex/verdict halves of the snapshot,
        # compacted: a stalled loop, empty gossip view, or shunned
        # parent explains a bad tree
        health = s.get("health") or {}
        pex = s.get("pex") or {}
        verdicts = s.get("verdicts") or {}
        vparents = verdicts.get("parents") or {}
        daemons_detail[s["addr"]] = {
            "pod": pods.get(s["addr"], ""),
            "health_status": health.get("status", ""),
            "loop_max_lag_s": (health.get("loop") or {}).get(
                "max_lag_s", 0.0),
            "pex_peers": len(pex.get("peers") or []),
            "flight_index": s.get("flight_index") or {},
            "self_quarantined": bool(verdicts.get("self_quarantined")),
            "shunned": sorted(a for a, row in vparents.items()
                              if row.get("shunned")),
        }
    tasks = {tid: _aggregate_task(tid, holders, pods=pods)
             for tid, holders in sorted(by_task.items())}

    # quarantine view: who the pod's local verdicts condemn, and whether
    # a condemned address is STILL being offered (present as a holder in
    # some daemon's swarm index — the exact re-poisoning loop the immune
    # system exists to break)
    shunned_by: dict[str, list[str]] = {}
    selfq: list[str] = []
    for addr, d in daemons_detail.items():
        if d["self_quarantined"]:
            selfq.append(addr)
        for bad in d["shunned"]:
            shunned_by.setdefault(bad, []).append(addr)
    still_offered: dict[str, list[str]] = {}
    for s in snapshots:
        if "error" in s:
            continue
        swarm = ((s.get("pex") or {}).get("swarm") or {}).get("tasks") or {}
        holder_addrs = {e.get("addr", "") for entries in swarm.values()
                        for e in entries}
        for bad in shunned_by:
            if bad in holder_addrs:
                still_offered.setdefault(bad, []).append(s["addr"])
    quarantine = {
        "self_quarantined": sorted(selfq),
        "shunned": {bad: sorted(who) for bad, who in
                    sorted(shunned_by.items())},
        "still_offered": {bad: sorted(who) for bad, who in
                          sorted(still_offered.items())},
    }

    breaches: list[str] = []
    for bad, where in sorted(still_offered.items()):
        breaches.append(
            f"poisoner_offered: {bad} is shunned by "
            f"{'/'.join(shunned_by[bad])} on local corrupt verdicts but "
            f"still indexed as a holder on {'/'.join(sorted(where))} — "
            "the pod can be steered back at it")
    for addr, err in sorted(unreachable.items()):
        breaches.append(f"unreachable: {addr} ({err})")
    for addr, d in sorted(daemons_detail.items()):
        if d["health_status"] == "stalled":
            breaches.append(
                f"health: {addr} reports a stalled event loop "
                f"(max lag {d['loop_max_lag_s']:.3f}s)")
    for tid, t in tasks.items():
        short = tid[:12]
        if t["slo_breaches"]:
            blown = ", ".join(f"{stage}x{n}" for stage, n in
                              sorted(t["slo_breaches"].items()))
            breaches.append(f"slo: task {short} blew budgets ({blown})")
        if (t["amplification"] > AMPLIFICATION_BREACH
                and t["origin_bytes"] > 0):
            breaches.append(
                f"amplification: task {short} pulled "
                f"{t['amplification']:.2f}x its content from origin — "
                "the mesh is not carrying the bytes")
        b = t["bottleneck"]
        if b and b.get("straggler"):
            breaches.append(
                f"bottleneck: task {short} edge {b['src']} -> {b['dst']} "
                f"ran at {_fmt_bps(b['bandwidth_bps'])} vs median "
                f"{_fmt_bps(b['median_bps'])} — a straggler edge")
        if t["daemons"] and t["complete"] < t["daemons"]:
            breaches.append(
                f"incomplete: task {short} finished on {t['complete']}/"
                f"{t['daemons']} daemons")

    report = {
        "daemons": [s["addr"] for s in snapshots],
        "daemons_detail": daemons_detail,
        "unreachable": unreachable,
        "tasks": tasks,
        "quarantine": quarantine,
        "breaches": breaches,
    }
    report["verdict"] = pod_verdict(report)
    return report


def bench_summary(task_report: dict) -> dict:
    """The compact per-scenario form dfbench stamps into BENCH_pr6.json:
    the headline pod numbers + per-edge distribution percentiles."""
    bws = [e["bandwidth_bps"] for e in task_report["edges"]
           if e["src"] != ORIGIN and e["bandwidth_bps"] > 0]
    wires = [e["wire_ms"] for e in task_report["edges"]
             if e["src"] != ORIGIN]
    return {
        "makespan_ms": task_report["makespan_ms"],
        "depth": task_report["depth"],
        "amplification": task_report["amplification"],
        "origin_bytes": task_report["origin_bytes"],
        "placed_bytes": task_report.get("placed_bytes", 0),
        "cross_pod_bytes": task_report.get("cross_pod_bytes", 0),
        "edges": len(task_report["edges"]),
        "edge_bandwidth_bps": {"p5": _pctl(bws, 0.05),
                               "p50": _pctl(bws, 0.50),
                               "p95": _pctl(bws, 0.95)},
        "edge_wire_ms": {"p50": _pctl(wires, 0.50),
                         "p95": _pctl(wires, 0.95)},
        "seed_uplink": task_report["seed_uplink"],
        "bottleneck": task_report["bottleneck"],
        "relay": task_report.get("relay"),
    }


# ------------------------------------------------------- records (edges)

def edges_from_summary(task_id: str, dst_peer_id: str, dst_host_id: str,
                       summary: dict) -> list[dict]:
    """``kind=edge`` rows for the trainer's record stream: one per parent
    that served this flight, carrying the observed per-edge bandwidth —
    the label source for a learned parent-quality model (ROADMAP item 1).
    Pure; ``scheduler/records.py`` stamps ``created_at``."""
    rows = []
    for parent, pp in (summary.get("per_parent") or {}).items():
        rows.append({
            "kind": "edge",
            "task_id": task_id,
            "src_peer_id": parent or ORIGIN,
            "dst_peer_id": dst_peer_id,
            "dst_host_id": dst_host_id,
            "bytes": pp.get("bytes", 0),
            "pieces": pp.get("pieces", 0),
            "wire_ms": pp.get("wire_ms", 0.0),
            "bandwidth_bps": pp.get("throughput_bps", 0),
        })
    return rows


# ----------------------------------------------------------------- render

def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}GiB"


def _fmt_bps(n: float) -> str:
    return f"{_fmt_bytes(n)}/s"


def render_pod(report: dict, *, max_edges_per_node: int = 8) -> str:
    """ASCII distribution tree per task, one line per NODE under its
    tree parent with the delivering edge's bytes / estimated bandwidth /
    both-ends confirmation, bottleneck flagged. The walk follows
    ``tree`` (each node rendered exactly once), not the full edge DAG —
    a dense pex swarm where every daemon serves every later joiner has
    combinatorially many DAG paths, and rendering each one would flood
    the terminal at exactly the pod sizes the tool exists for. Cross
    edges beyond the tree are counted per task; ``--json`` carries the
    full DAG. Pure function over an aggregate() report (or a saved
    copy)."""
    out: list[str] = []
    for addr, err in sorted((report.get("unreachable") or {}).items()):
        out.append(f"UNREACHABLE {addr}: {err}")
    for tid, t in (report.get("tasks") or {}).items():
        note = t["amplification_note"]
        amp = (f"{t['amplification']:.2f}"
               + (" (warm)" if note.startswith("healthy-warm")
                  else " (seeded)" if note else ""))
        out.append(
            f"task {tid[:24]}  content={_fmt_bytes(t['content_length'])}  "
            f"daemons={t['complete']}/{t['daemons']} complete  "
            f"makespan={t['makespan_ms']:.0f}ms  depth={t['depth']}  "
            f"amplification={amp}")
        tree = t.get("tree") or {}
        edge_by_key = {(e["src"], e["dst"]): e for e in t["edges"]}
        kids_of: dict[str, list[str]] = {}
        for child, parent in tree.items():
            kids_of.setdefault(parent, []).append(child)
        b = t.get("bottleneck") or {}
        rendered: set[str] = set()

        def walk(node: str, prefix: str) -> None:
            kids = sorted(kids_of.get(node, []),
                          key=lambda d: -edge_by_key[(node, d)]["bytes"])
            shown = kids[:max_edges_per_node]
            for i, dst in enumerate(shown):
                e = edge_by_key[(node, dst)]
                last = i == len(shown) - 1
                tick = "└─ " if last else "├─ "
                mark = ""
                if e.get("cross_pod"):
                    # a pod-crossing (DCN-tier) edge of the two-level
                    # federation tree — healthy only on seed edges
                    mark += "  [dcn]"
                if e.get("relayed"):
                    mark += "  [relay]"
                if e.get("confirmed"):
                    mark += "  [confirmed]"
                if (b and e["src"] == b.get("src")
                        and e["dst"] == b.get("dst")):
                    mark += "  <- bottleneck"
                bw = (f"  {_fmt_bps(e['bandwidth_bps'])}"
                      if e["bandwidth_bps"] else "")
                out.append(
                    f"{prefix}{tick}{dst}  "
                    f"{_fmt_bytes(e['bytes'])}/{e['pieces']}pc{bw}{mark}")
                if dst not in rendered:     # tree-parent cycle guard
                    rendered.add(dst)
                    walk(dst, prefix + ("   " if last else "│  "))
            if len(kids) > len(shown):
                out.append(f"{prefix}└… +{len(kids) - len(shown)} more")
                # the "+N more" line accounts for the truncated children
                # AND their subtrees — without this they would fall into
                # the rootless sweep below and print as phantom cycles
                stack = list(kids[len(shown):])
                while stack:
                    n = stack.pop()
                    if n in rendered:
                        continue
                    rendered.add(n)
                    stack.extend(kids_of.get(n, []))

        all_nodes = set(tree) | set(tree.values())
        roots = [n for n in all_nodes if n not in tree]
        for root in sorted(roots, key=lambda n: (n != ORIGIN, n)):
            out.append(f"  {root}")
            rendered.add(root)
            walk(root, "  ")
        for n in sorted(all_nodes - rendered):
            # a mutual-heaviest-source pair forms a rootless tree cycle:
            # surface the node flat rather than dropping it silently
            out.append(f"  {n}  (in a cross-serve cycle; see --json)")
        cross = len(t["edges"]) - len(tree)
        if cross > 0:
            out.append(f"  (+{cross} cross edge(s) beyond the tree — "
                       "full DAG in --json)")
        rl = t.get("relay")
        if rl:
            out.append(
                f"  relay: {rl['edges']} cut-through edge(s), "
                f"{rl['pieces']}pc streamed mid-landing, chain depth "
                f"{rl['depth']}, ~{rl['per_hop_added_ms']:.1f}ms added "
                "per hop")
        if t.get("cross_pod_bytes"):
            out.append(
                f"  federation: {_fmt_bytes(t['cross_pod_bytes'])} "
                "crossed a pod boundary ([dcn] edges) — healthy when "
                "only pod-seed edges carry it")
        shd = t.get("shards")
        if shd:
            fb = (f", {shd['fallbacks']} tree fallback(s)"
                  if shd.get("fallbacks") else "")
            out.append(
                f"  shards: {shd['ready']}/{shd['total']} ready "
                f"pod-wide ({_fmt_bytes(shd['tree_bytes'])} tree, "
                f"{_fmt_bytes(shd['swap_bytes'])} swapped over ICI{fb})")
        su = t.get("seed_uplink")
        if su:
            out.append(
                f"  seed uplink: {su['node']} served "
                f"{_fmt_bytes(su['bytes'])} at "
                f"~{_fmt_bps(su['est_bandwidth_bps'])} "
                f"({100 * su['share']:.0f}% of p2p bytes)")
    out.append(report.get("verdict") or pod_verdict(report))
    return "\n".join(out)


def pod_verdict(report: dict) -> str:
    """One-paragraph pod attribution: what limited this pod, or 'healthy'."""
    parts: list[str] = []
    tasks = report.get("tasks") or {}
    for tid, t in tasks.items():
        b = t.get("bottleneck")
        if b:
            parts.append(
                f"task {tid[:12]}: bottleneck edge {b['src']} -> "
                f"{b['dst']} at {_fmt_bps(b['bandwidth_bps'])}"
                + (" — a straggler vs the "
                   f"{_fmt_bps(b['median_bps'])} median"
                   if b.get("straggler") else
                   f" (median {_fmt_bps(b['median_bps'])})"))
        if t.get("rungs"):
            trail = ", ".join(f"{r}x{n}" for r, n in
                              sorted(t["rungs"].items()))
            parts.append(f"task {tid[:12]}: served by rungs {trail}")
        if t.get("placed_bytes"):
            # name the dedupe explicitly so "no origin bytes at all"
            # reads as a warm content store, not a blind window
            parts.append(
                f"task {tid[:12]}: {_fmt_bytes(t['placed_bytes'])} "
                "dedupe-served from the content store (healthy-warm)")
    q = report.get("quarantine") or {}
    for addr in q.get("self_quarantined") or []:
        parts.append(f"{addr} has SELF-QUARANTINED (its own storage "
                     "failed re-verification): not advertising, flagged "
                     "to the scheduler")
    for bad, who in (q.get("shunned") or {}).items():
        parts.append(f"{bad} is locally quarantined by {'/'.join(who)} "
                     "on verified corrupt pieces"
                     + (" — AND STILL OFFERED (see breaches)"
                        if bad in (q.get("still_offered") or {}) else ""))
    breaches = report.get("breaches") or []
    if breaches:
        parts.append("BREACH " + "; BREACH ".join(breaches))
    if not parts:
        return "pod verdict: healthy — nothing to attribute."
    return "pod verdict: " + ";\n  ".join(parts) + "."
