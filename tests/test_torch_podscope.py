"""Podscope on the port, against the reference.

* ``aggregate``, ``render_pod``, ``pod_verdict`` and ``bench_summary``
  give the reference's dicts and text on the synthetic snapshots of the
  reference's ``tests/test_podscope.py`` (a chain with a straggler and a
  dead daemon, a pre-seeded pod, a restarted seed, a mixed origin edge, a
  dense cross-serve mesh, an incomplete and a stalled daemon, a partly
  confirmed uplink, a healthy pod) and on shapes that exercise the
  report's other blocks (relay edges, pod-crossing edges, shards, content
  store placements, verdicts and the swarm index).
* ``_pctl`` is the reference's rule and the flight recorder's only copy.
* ``edges_from_summary`` and ``DownloadRecords.on_flight`` write the
  reference's ``kind=edge`` rows, ``stitch_outcomes`` joins them as the
  reference does, and the trainer's row folding skips them.
* ``dfbench --pr6`` equals ``BENCH_pr6.json``.
* ``collect_pod`` reads two port daemons on the CPU (each pulled a file
  from an HTTP origin) and an unreachable address, as the reference's
  ``collect_pod`` reads them.

Tolerances are exact.
"""

import argparse
import asyncio
import json
import os
import socket

import numpy as np
import pytest

from dragonfly2_tpu.common import podscope as ref_podscope
from dragonfly2_tpu.idl import messages as ref_msg
from dragonfly2_tpu.scheduler import decision_ledger as ref_ledger
from dragonfly2_tpu.scheduler import records as ref_records
from dragonfly2_tpu.scheduler import resource as ref_resource
from dragonfly2_tpu.trainer import features as ref_features
from dragonfly2_tpu.trainer import pipeline as ref_pipeline
from dragonfly2_tpu_torch.common import podscope
from dragonfly2_tpu_torch.daemon import flight_recorder
from dragonfly2_tpu_torch.daemon.config import DaemonConfig
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.idl import messages as port_msg
from dragonfly2_tpu_torch.scheduler import decision_ledger
from dragonfly2_tpu_torch.scheduler import records
from dragonfly2_tpu_torch.scheduler import resource
from dragonfly2_tpu_torch.tools import dfbench
from dragonfly2_tpu_torch.trainer import features
from dragonfly2_tpu_torch.trainer import pipeline
from torch_origin import Origin

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MB = 1 << 20
LIMIT_S = 30.0


def _as_json(obj):
    return json.loads(json.dumps(obj))


# ------------------------------------------ the reference's synthetic pods

def _rows(parent, *, n=3, wire=10.0, size=4 * MB, start=0):
    src = "origin" if parent == "" else "p2p"
    return [{"piece": start + i, "parent": parent, "source": src,
             "bytes": size, "start_ms": 5.0 * i, "total_ms": wire + 2.0,
             "queue_ms": 0.5, "ttfb_ms": 1.5, "wire_ms": wire,
             "hbm_ms": 0.0}
            for i in range(n)]


def _serves(child, *, n=3, serve=8.0, size=4 * MB, relayed=False):
    out = [{"t_ms": 10.0 * i, "peer": child, "addr": "127.0.0.1",
            "piece": i, "bytes": size, "serve_ms": serve, "wait_ms": 0.5}
           for i in range(n)]
    if relayed:
        for s in out:
            s["relayed"] = True
    return out


def _flight(peer, parent, started, *, wire=10.0, serves=None,
            state="success", rung="p2p", **summary):
    p2p = 0 if parent == "" else 12 * MB
    return {"peer_id": peer, "started_at": started, "state": state,
            "serves": serves or [],
            "summary": {"piece_rows": _rows(parent, wire=wire),
                        "bytes_p2p": p2p, "bytes_source": 12 * MB - p2p,
                        "slo_breaches": {}, "served_rung": rung,
                        **summary}}


def _chain():
    """origin -> seed -> l1 -> l2, l1 -> l2 slow, one daemon dead."""
    tid = "T" * 64
    return [
        {"addr": "seed:1", "flights": {tid: _flight(
            "seed-peer", "", 100.0, serves=_serves("l1-peer"))}},
        {"addr": "l1:1", "flights": {tid: _flight(
            "l1-peer", "seed-peer", 100.1, serves=_serves("l2-peer"))}},
        {"addr": "l2:1", "flights": {tid: _flight(
            "l2-peer", "l1-peer", 100.2, wire=120.0)}},
        {"addr": "dead:1", "error": "connection refused"},
    ]


def _preseeded():
    return [{"addr": "l1:1", "flights": {"S" * 64: _flight(
        "l1-peer", "seed-peer", 100.0)}}]


def _serving_seed(tid):
    return {"peer_id": "", "started_at": 99.0, "state": "serving",
            "serves": _serves("l1-peer"),
            "summary": {"piece_rows": [], "bytes_p2p": 0,
                        "bytes_source": 0}}


def _restarted_seed():
    tid = "R" * 64
    return [{"addr": "seed:1", "flights": {tid: _serving_seed(tid)}},
            {"addr": "l1:1", "flights": {tid: _flight(
                "l1-peer", "old-seed-peer-id", 100.0)}}]


def _mixed_origin():
    tid = "O" * 64
    rows = _rows("", n=2) + _rows("old-seed-peer", n=2, start=2)
    return [
        {"addr": "seed:1", "flights": {tid: _serving_seed(tid)}},
        {"addr": "l1:1", "flights": {tid: {
            "peer_id": "l1-peer", "started_at": 100.0, "state": "success",
            "serves": [],
            "summary": {"piece_rows": rows, "bytes_p2p": 8 * MB,
                        "bytes_source": 8 * MB, "slo_breaches": {},
                        "served_rung": "p2p"}}}},
    ]


def _dense(n=24):
    tid = "D" * 64
    snaps = []
    for i in range(n):
        parents = [f"d{j}-peer" for j in range(i)] or [""]
        rows = [{"piece": k, "parent": par,
                 "source": "origin" if par == "" else "p2p",
                 "bytes": 4 * MB, "start_ms": 1.0 * k, "total_ms": 12.0,
                 "queue_ms": 0.5, "ttfb_ms": 1.5, "wire_ms": 10.0 + k,
                 "hbm_ms": 0.0}
                for k, par in enumerate(parents)]
        snaps.append({"addr": f"d{i}:1", "flights": {tid: {
            "peer_id": f"d{i}-peer", "started_at": 100.0 + i,
            "state": "success", "serves": [],
            "summary": {"piece_rows": rows,
                        "bytes_p2p": sum(r["bytes"] for r in rows
                                         if r["parent"]),
                        "bytes_source": sum(r["bytes"] for r in rows
                                            if not r["parent"]),
                        "slo_breaches": {}, "served_rung": "p2p"}}}})
    return snaps


def _incomplete():
    tid = "I" * 64
    return [{"addr": "a:1", "flights": {tid: _flight("a-peer", "", 1.0)}},
            {"addr": "b:1", "flights": {tid: _flight(
                "b-peer", "a-peer", 1.1, state="running")}}]


def _stalled():
    snaps = _chain()
    snaps[1]["health"] = {"status": "stalled", "loop": {"max_lag_s": 2.5}}
    snaps[1]["pex"] = {"peers": [{"addr": "x"}]}
    return snaps


def _partly_confirmed():
    tid = "U" * 64
    return [
        {"addr": "seed:1", "flights": {tid: _flight(
            "seed-peer", "", 100.0,
            serves=_serves("l1-peer", serve=100.0))}},
        {"addr": "l1:1", "flights": {tid: _flight(
            "l1-peer", "seed-peer", 100.1)}},
        {"addr": "l2:1", "flights": {tid: _flight(
            "l2-peer", "seed-peer", 100.2)}},
    ]


def _healthy():
    tid = "H" * 64
    return [{"addr": "a:1", "flights": {tid: _flight(
                "a-peer", "", 1.0, serves=_serves("b-peer"))}},
            {"addr": "b:1", "flights": {tid: _flight(
                "b-peer", "a-peer", 1.1)}}]


def _relay_chain():
    """Cut-through serves on both hops, so the relay block and the
    ``[relay]`` marks show; events set each flight's end."""
    snaps = _chain()[:3]
    for s, child in ((snaps[0], "l1-peer"), (snaps[1], "l2-peer")):
        (flight,) = s["flights"].values()
        flight["serves"] = _serves(child, relayed=True)
    (last,) = snaps[2]["flights"].values()
    last["events"] = [{"t_ms": 5.0}, {"t_ms": 450.0}]
    return snaps


def _two_pods():
    """A pod-crossing seed edge (``pod`` labels from the snapshots and
    from ``/debug/pex``'s host block), two tasks, one with an SLO
    breach and over-amplification."""
    snaps = _chain()[:3]
    snaps[0]["pod"] = "pod-a"
    snaps[1]["pex"] = {"host": {"pod": "pod-b"}, "peers": []}
    snaps[2]["pod"] = "pod-b"
    tid = "A" * 64
    for i, s in enumerate(snaps):
        s["flights"][tid] = _flight(f"x{i}-peer", "", 200.0 + i,
                                    slo_breaches={"wire": 2 + i})
    return snaps


def _sharded_warm():
    """Sharded summaries and content-store placements (healthy-warm
    amplification), plus a placement-only flight."""
    tid = "W" * 64
    shards = {"ready": 2, "total": 4, "tree_bytes": 8 * MB,
              "swap_bytes": 4 * MB, "fallbacks": 1}
    a = _flight("a-peer", "b-peer", 10.0, shards=shards,
                bytes_placed=4 * MB)
    a["summary"]["bytes_source"] = 0
    placed = {"peer_id": "b-peer", "started_at": 9.0, "state": "success",
              "serves": _serves("a-peer"),
              "summary": {"piece_rows": [], "placed_pieces": 3,
                          "bytes_placed": 12 * MB, "bytes_p2p": 0,
                          "bytes_source": 0, "shards": shards}}
    return [{"addr": "a:1", "flights": {tid: a}},
            {"addr": "b:1", "flights": {tid: placed}}]


def _quarantine_view():
    """Local verdicts that shun a parent still indexed as a holder, a
    self-quarantined daemon, and the swarm index naming the poisoner."""
    snaps = _healthy()
    snaps[0]["verdicts"] = {"self_quarantined": True, "parents": {
        "bad:1": {"shunned": True}, "ok:1": {"shunned": False}}}
    snaps[1]["pex"] = {"peers": [], "swarm": {"tasks": {
        "H" * 64: [{"addr": "bad:1"}, {"addr": "a:1"}]}}}
    return snaps


SNAPSHOTS = {
    "chain": _chain, "preseeded": _preseeded,
    "restarted_seed": _restarted_seed, "mixed_origin": _mixed_origin,
    "dense": _dense, "incomplete": _incomplete, "stalled": _stalled,
    "partly_confirmed": _partly_confirmed, "healthy": _healthy,
    "relay_chain": _relay_chain, "two_pods": _two_pods,
    "sharded_warm": _sharded_warm, "quarantine_view": _quarantine_view,
    "empty": lambda: [], "all_unreachable": lambda: [
        {"addr": "a:1", "error": "timed out"}],
}


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_aggregate_render_and_verdict_equal_reference(name):
    snaps = SNAPSHOTS[name]()
    got = podscope.aggregate(json.loads(json.dumps(snaps)))
    want = ref_podscope.aggregate(json.loads(json.dumps(snaps)))
    assert _as_json(got) == _as_json(want)
    assert podscope.pod_verdict(got) == ref_podscope.pod_verdict(want)
    for cap in (8, 2):
        assert podscope.render_pod(got, max_edges_per_node=cap) == \
            ref_podscope.render_pod(want, max_edges_per_node=cap)
    for tid, task in got["tasks"].items():
        assert _as_json(podscope.bench_summary(task)) == \
            _as_json(ref_podscope.bench_summary(want["tasks"][tid]))


def test_the_chain_reads_as_the_reference_tests_pin_it():
    rep = podscope.aggregate(_chain())
    t = rep["tasks"]["T" * 64]
    assert t["depth"] == 3 and t["amplification"] == 1.0
    assert t["tree"] == {"seed:1": "origin", "l1:1": "seed:1",
                         "l2:1": "l1:1"}
    assert t["makespan_ms"] == pytest.approx(332.0, abs=0.5)
    b = t["bottleneck"]
    assert (b["src"], b["dst"], b["straggler"]) == ("l1:1", "l2:1", True)
    assert any(x.startswith("unreachable: dead:1") for x in rep["breaches"])
    text = podscope.render_pod(rep)
    assert "<- bottleneck" in text and "[confirmed]" in text


@pytest.mark.parametrize("vals,q", [
    ([], 0.5), ([3.0], 0.99), ([5.0, 1.0, 4.0, 2.0, 3.0], 0.05),
    ([5.0, 1.0, 4.0, 2.0, 3.0], 0.5), ([0.1234567] * 7 + [9.9], 0.95)])
def test_pctl_is_the_reference_rule_and_the_only_copy(vals, q):
    assert podscope._pctl(vals, q) == ref_podscope._pctl(vals, q)
    assert flight_recorder._pctl is podscope._pctl
    assert dfbench._pctl is podscope._pctl


# --------------------------------------------------------- kind=edge rows

SUMMARY = {"per_parent": {
    "parentA": {"bytes": 8 * MB, "pieces": 2, "wire_ms": 80.0,
                "throughput_bps": 100 * MB},
    "": {"bytes": 4 * MB, "pieces": 1, "wire_ms": 40.0,
         "throughput_bps": 100 * MB},
    "parentB": {"bytes": 1, "pieces": 1}}}


def test_edges_from_summary_equals_reference():
    for summary in (SUMMARY, {}, {"per_parent": None}):
        args = ("t" * 64, "child", "h-child", summary)
        assert podscope.edges_from_summary(*args) == \
            ref_podscope.edges_from_summary(*args)


def _on_flight_rows(res_mod, rec_mod, msg):
    res = res_mod.Resource()
    task = res_mod.Task("t" * 64, "u")
    host = res.store_host(msg.Host(id="h-child", ip="127.0.0.1", port=1,
                                   download_port=2))
    peer = res.get_or_create_peer("child", task, host)
    rec = rec_mod.DownloadRecords()
    rec.on_flight(peer, SUMMARY)
    rows = rec.drain()
    assert all(r["created_at"] > 0 for r in rows)
    return [{k: v for k, v in r.items() if k != "created_at"} for r in rows]


def test_on_flight_writes_the_reference_rows():
    got = _on_flight_rows(resource, records, port_msg)
    assert got == _on_flight_rows(ref_resource, ref_records, ref_msg)
    assert [r["kind"] for r in got] == ["flight", "edge", "edge", "edge"]
    edges = {r["src_peer_id"]: r for r in got[1:]}
    assert set(edges) == {"parentA", "origin", "parentB"}
    assert edges["parentA"]["bandwidth_bps"] == 100 * MB
    assert edges["origin"]["bytes"] == 4 * MB


def _decision(did, cands=("pa", "pb")):
    return {"kind": "decision", "decision_id": did,
            "decision_kind": "find", "evaluator": "default",
            "task_id": "t1", "peer_id": "c1", "host_id": "h1",
            "candidates": [{"peer_id": p, "rank": i + 1, "total": 0.5,
                            "host_id": f"h-{p}",
                            "features": [0.1 * (i + 1)] * 7,
                            "terms": {"piece": 0.5, "upload_success": 1.0,
                                      "free_upload": 0.5, "host_type": 0.5,
                                      "locality": 0.9 - 0.5 * i}}
                           for i, p in enumerate(cands)],
            "excluded": [], "chosen": list(cands)}


def _ledger_rows():
    rows = [_decision("d1"), _decision("d2", ("pb",))]
    for did, parent, cost in (("d1", "pa", 10.0), ("d1", "pb", 4.0),
                              ("d2", "pb", 5.0), ("", "pz", 1.0)):
        rows.append({"kind": "piece", "task_id": "t1", "peer_id": "c1",
                     "decision_id": did, "parent_peer_id": parent,
                     "piece_length": 4 << 20, "cost_ms": cost,
                     "label": 0.5, "features": [0.2] * 7})
    res = resource.Resource()
    task = resource.Task("t1", "u")
    host = res.store_host(port_msg.Host(id="h1", ip="127.0.0.1", port=1,
                                        download_port=2))
    rec = records.DownloadRecords()
    rec.on_flight(res.get_or_create_peer("c1", task, host), {
        "per_parent": {"pb": {"bytes": 8 << 20, "pieces": 2,
                              "wire_ms": 9.0, "throughput_bps": 930_000},
                       "": {"bytes": 4 << 20, "pieces": 1}}})
    return rows + rec.drain()


def test_stitch_outcomes_joins_edge_rows_as_the_reference_does():
    rows = _ledger_rows()
    got = decision_ledger.stitch_outcomes(json.loads(json.dumps(rows)))
    want = ref_ledger.stitch_outcomes(json.loads(json.dumps(rows)))
    assert _as_json(got) == _as_json(want)
    by_id = {d["decision_id"]: d for d in got["decisions"]}
    assert by_id["d2"]["edges"]["pb"]["bandwidth_bps"] == 930_000
    assert got["coverage"] == {"piece_rows": 4, "joined": 3, "ratio": 0.75}


def test_the_trainer_skips_edge_rows_as_the_reference_does():
    rows = _ledger_rows()
    bare = [r for r in rows if r["kind"] != "edge"]
    got = features.decision_outcome_rows(rows)
    assert got == features.decision_outcome_rows(bare)
    assert got == ref_features.decision_outcome_rows(rows)
    assert pipeline.training_rows(rows) == ref_pipeline.training_rows(rows)
    assert pipeline.training_rows(rows) == pipeline.training_rows(bare)


# ------------------------------------------------------------ dfbench --pr6

def test_pr6_equals_the_committed_file():
    """``BENCH_pr6.json`` predates three keys the reference later added
    to ``bench_summary`` (``relay``, ``placed_bytes``,
    ``cross_pod_bytes``); a fan-out without relaying, placements or pods
    gives them null, 0 and 0. Every other key equals the file."""
    args = argparse.Namespace(seed=7, daemons=8, pieces=64,
                              piece_size=4 << 20, parallelism=4)
    got = _as_json(dfbench._run_pr6(args))
    with open(os.path.join(ROOT, "BENCH_pr6.json")) as f:
        want = json.load(f)
    for sc in dfbench.SCENARIOS:
        ps = got["scenarios"][sc]["podscope"]
        assert (ps.pop("relay"), ps.pop("placed_bytes"),
                ps.pop("cross_pod_bytes")) == (None, 0, 0)
    assert got == want
    assert got["tree_depth"] == {"baseline": 4, "scheds_down_no_pex": 1,
                                 "scheds_down_pex": 2}


# ------------------------------------------------ collect_pod, live daemons

def _daemon(tmp_path, name: str) -> Daemon:
    return Daemon(DaemonConfig(workdir=str(tmp_path / name), hostname=name,
                               listen_ip="127.0.0.1", host_ip="127.0.0.1",
                               device="cpu"))


def _closed_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _steady(snap: dict) -> dict:
    """A snapshot without its live readings (the loop-lag sampler moves
    between two sweeps)."""
    snap = dict(snap)
    snap.pop("health", None)
    return snap


def test_collect_pod_reads_port_daemons_as_the_reference_does(tmp_path):
    data = np.random.default_rng(6).integers(
        0, 256, (9 << 20) + 321, dtype=np.uint8).tobytes()
    dead = f"127.0.0.1:{_closed_port()}"

    async def go(url: str):
        daemons = [_daemon(tmp_path, n) for n in ("pa", "pb")]
        for d in daemons:
            await d.start()
        try:
            for d in daemons:
                async for _ in d.ptm.start_file_task(port_msg.DownloadRequest(
                        url=url, timeout_s=LIMIT_S,
                        output=str(tmp_path / f"{d.hostname}.out"))):
                    pass
            addrs = [f"127.0.0.1:{d.upload_server.port}" for d in daemons]
            # collect_pod blocks in urllib: off the daemons' loop
            got = await asyncio.to_thread(
                podscope.collect_pod, addrs + [dead], timeout_s=5.0)
            want = await asyncio.to_thread(
                ref_podscope.collect_pod, addrs + [dead], timeout_s=5.0)
            return addrs, got, want
        finally:
            for d in daemons:
                await d.stop()

    with Origin({"f.bin": data}) as o:
        addrs, got, want = asyncio.run(asyncio.wait_for(
            go(f"{o.base}/f.bin"), LIMIT_S))
    assert [_steady(s) for s in got] == [_steady(s) for s in want]
    assert [s["addr"] for s in got] == addrs + [dead]
    assert "error" in got[2] and "error" not in got[0]
    for snap in got[:2]:
        assert snap["verdicts"] is None            # no route until item 5a
        assert snap["health"]["status"] and snap["pex"] is not None
        (flight,) = snap["flights"].values()
        assert flight["state"] == "success"
    rep = podscope.aggregate(got)
    assert _as_json(rep) == _as_json(ref_podscope.aggregate(got))
    (task,) = rep["tasks"].values()
    assert task["content_length"] == len(data)
    assert (task["daemons"], task["complete"], task["depth"]) == (2, 2, 1)
    assert task["amplification"] == 2.0
    assert task["origin_bytes"] == 2 * len(data)
    assert set(rep["unreachable"]) == {dead}
    assert any(b.startswith(f"unreachable: {dead}") for b in rep["breaches"])
