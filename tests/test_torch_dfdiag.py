"""dfdiag and dfsched on the port, against the reference's.

* Each render (``render_waterfall`` with ``verdict``, ``render_cluster``,
  ``render_ctrl``, ``render_fleet``, ``render_pod_report``) gives the
  reference's text on the same JSON, and ``main`` the same output and
  exit code on saved files and on usage errors. ``--qos`` is no longer
  refused: it reads a daemon's ``/debug/qos`` (``tests/test_torch_qos.py``
  holds its verdict and render against the reference's).
* A pod on the CPU (a scheduler with records and its debug routes
  mounted as the launcher mounts them, a seed, a leecher, announcing
  every 0.2 s): ``dfdiag --pod --json`` gives podscope's report of the
  pull, ``--fleet`` exits as the snapshot's active episodes say, and the
  other scheduler and daemon views render as the reference renders the
  same JSON. The scheduler's records hold the leecher's ``kind=edge``
  rows; dfsched over that records file, and over the live ring, prints
  what the reference's dfsched prints.
* ``dfsched --replay learned``: with a blob the port fitted, both
  packages print the same flips; without one the port fits on
  ``--device``.

Tolerances are exact.
"""

import asyncio
import io
import json
import socket
import time
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

from dragonfly2_tpu.common import podscope as ref_podscope
from dragonfly2_tpu.tools import dfdiag as ref_dfdiag
from dragonfly2_tpu.tools import dfsched as ref_dfsched
from dragonfly2_tpu_torch.common import podscope
from dragonfly2_tpu_torch.common.debug_http import start_debug_server
from dragonfly2_tpu_torch.daemon.config import (DaemonConfig, StorageSection)
from dragonfly2_tpu_torch.daemon.config import SchedulerConfig as DaemonSched
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.idl.messages import DownloadRequest
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig, SeedPeerAddr
from dragonfly2_tpu_torch.scheduler.fleetpulse import FleetPulse
from dragonfly2_tpu_torch.scheduler.resource import TaskState
from dragonfly2_tpu_torch.scheduler.server import Scheduler
from dragonfly2_tpu_torch.tools import dfdiag, dfsched
from dragonfly2_tpu_torch.tools.scheduler import add_scheduler_routes
from dragonfly2_tpu_torch.trainer.pipeline import train_decision_model

LIMIT_S = 45.0
MB = 1 << 20


def _call(main, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as exc:
            rc = exc.code
    return rc, out.getvalue(), err.getvalue()


def _both(argv) -> tuple:
    got = _call(dfdiag.main, argv)
    assert got == _call(ref_dfdiag.main, argv)
    return got


# ------------------------------------------------------------ renders

def _row(i, parent, **kw):
    r = {"piece": i, "parent": parent, "bytes": 4 * MB,
         "start_ms": 7.0 * i, "total_ms": 30.0 + i, "queue_ms": 1.0,
         "ttfb_ms": 3.0, "wire_ms": 20.0 + i, "hbm_ms": 6.0}
    r.update(kw)
    return r


def _summary(**kw):
    s = {"task_id": "t" * 64, "pieces": 6, "bytes_p2p": 16 * MB,
         "bytes_source": 8 * MB,
         "piece_rows": [_row(i, "" if i < 2 else f"peer-{i % 2}")
                        for i in range(6)],
         "slowest_piece": {"piece": 5, "parent": "peer-1", "total_ms": 35.0,
                           "dominant_stage": "wire", "dominant_ms": 25.0},
         "back_to_source_ratio": 0.33,
         "per_parent": {"": {"throughput_bps": 300 * MB},
                        "peer-0": {"throughput_bps": 50 * MB},
                        "peer-1": {"throughput_bps": 250 * MB}},
         "tail_ms": {"p50": 32.0, "p90": 35.0, "p99": 35.0}}
    s.update(kw)
    return s


SUMMARIES = {
    "plain": _summary(),
    "empty": {"task_id": "e" * 64, "pieces": 0},
    "empty_with_rungs": {"piece_rows": [], "rungs": ["p2p", "pex"],
                         "served_rung": "pex"},
    "mostly_origin": _summary(back_to_source_ratio=0.8),
    "slo_pex_shards": _summary(
        slo_breaches={"wire": 2, "hbm": 1},
        slo_budgets_ms={"wire": 500.0},
        rungs=["p2p", "pex"], served_rung="pex",
        shards={"ready": 3, "total": 4, "tree_bytes": 8 * MB,
                "swap_bytes": 4 * MB, "fallbacks": 2,
                "slowest": {"name": "layers.7", "t_ms": 812.0,
                            "src": "swap"}}),
    "corrupt_and_fails": _summary(
        corrupt_pieces={"peer-0": 2, "": 1},
        fail_codes={"corrupt": 3, "stall": 2, "timeout": 1},
        quarantined_parents=["10.0.0.9:65002"], report_drops=4,
        rungs=["p2p"], served_rung="p2p",
        shards={"ready": 1, "total": 1, "tree_bytes": 4 * MB,
                "swap_bytes": 0,
                "slowest": {"name": "s0", "t_ms": 5.0, "src": "tree"}}),
}


@pytest.mark.parametrize("name", sorted(SUMMARIES))
def test_waterfall_and_verdict_equal_reference(name):
    s = SUMMARIES[name]
    for width in (64, 20):
        assert dfdiag.render_waterfall(s, width=width) == \
            ref_dfdiag.render_waterfall(s, width=width)
    assert dfdiag.verdict(s) == ref_dfdiag.verdict(s)


CLUSTER = {"bytes_p2p": 40 * MB, "bytes_source": 8 * MB,
           "back_to_source_ratio": 0.1667,
           "hosts": {"leech-a-127.0.0.1": {
               "pieces_down": 10, "pieces_served": 0, "mean_serve_ms": 0.0,
               "fails": 1, "flights": 1},
               "seed-127.0.0.1": {"pieces_down": 0, "pieces_served": 10,
                                  "mean_serve_ms": 12.345, "fails": 0,
                                  "flights": 0}},
           "stragglers": [{"host_id": "slow-127.0.0.1",
                           "mean_serve_ms": 420.0, "slowdown": 5.1,
                           "pieces_served": 7}]}

_PHASE = {"count": 3, "self_ms": 1.5, "mean_ms": 0.5, "p50_ms": 0.4,
          "p99_ms": 0.9, "max_ms": 0.9}
CTRLS = {
    "idle": {"armed": False, "rulings": {"total": 0}},
    "armed": {"armed": True, "compute_ms": 4.5, "unattributed_ms": 0.2,
              "rulings": {"total": 3, "per_sec_busy": 120.0,
                          "per_sec_60s": 0.05,
                          "by_kind": {"find": _PHASE}},
              "phases": {"filter": _PHASE, "score": _PHASE},
              "queue_wait_ms": {"count": 2, "mean_ms": 1.0, "p50_ms": 1.0,
                                "p99_ms": 1.5, "max_ms": 1.5},
              "state_bytes": {"total": 123456, "peers": 3, "per_peer": 41152,
                              "components": {"resource": 100000,
                                             "ledger": 23456}},
              "state_staleness_s": 0.4, "state_ttl_s": 5.0,
              "recovery": {"recovered": True, "gap_s": 2.5, "components": {
                  "shard_affinity": {"restored": 4},
                  "fleetpulse": {"restored": 0, "present": False}}},
              "model": {"model": "bandwidth_mlp", "evaluator": {
                  "version": "v7", "scored": 10, "fallbacks": 2,
                  "degraded": True, "last_fallback_reason": "nan"},
                  "refused": {"v6": "feature dim 5"}}},
    "cold_unversioned": {"rulings": {}, "recovery": {"recovered": False},
                         "model": {"model": "m", "evaluator": {
                             "bound": True, "scored": 1}}},
    "no_model": {"rulings": {}, "model": {"model": "m", "evaluator": {}}},
}


@pytest.mark.parametrize("name", sorted(CTRLS))
def test_ctrl_render_equals_reference(name):
    assert dfdiag.render_ctrl(CTRLS[name]) == \
        ref_dfdiag.render_ctrl(CTRLS[name])


def _fleet_snapshot() -> dict:
    now = [0.0]
    fp = FleetPulse(clock=lambda: now[0])
    for t in range(14):
        now[0] += 30.0
        for h in ("d0", "d1"):
            lag = 900.0 if (h == "d0" and t == 13) else 5.0
            fp.ingest(h, {"v": 1, "seq": t, "loop_lag_max_ms": lag,
                          "served_rungs": {"p2p": t, "seed": t // 2}},
                      interval_s=30.0)
    return fp.snapshot()


def test_cluster_and_fleet_renders_equal_reference():
    assert dfdiag.render_cluster(CLUSTER) == ref_dfdiag.render_cluster(CLUSTER)
    assert dfdiag.render_cluster({}) == ref_dfdiag.render_cluster({})
    snap = json.loads(json.dumps(_fleet_snapshot()))
    assert snap["active"] and snap["incident_bundles"]
    for s in (snap, {}, dict(snap, recovery={"recovered": False}),
              dict(snap, recovery={"recovered": True, "gap_s": 1.5,
                                   "components": {"fleetpulse": {
                                       "restored": 3}}})):
        assert dfdiag.render_fleet(s) == ref_dfdiag.render_fleet(s)


# ----------------------------------------------------------------- the CLI

@pytest.mark.parametrize("name", ["plain", "slo_pex_shards", "empty"])
@pytest.mark.parametrize("wrap", [False, True])
def test_file_mode_prints_and_exits_as_the_reference(tmp_path, name, wrap):
    s = SUMMARIES[name]
    path = tmp_path / "flight.json"
    path.write_text(json.dumps({"summary": s} if wrap else s))
    rc, out, _ = _both(["--file", str(path)])
    assert rc == (3 if s.get("slo_breaches") else 0)
    assert "legend:" in out or "no completed pieces" in out
    assert _both(["--file", str(path), "--json"])[0] == rc


@pytest.mark.parametrize("argv", [
    [], ["--fleet"], ["--ctrl"], ["--cluster"], ["--decisions"],
    ["--pod", " , "], ["--file", "/nonexistent/flight.json"]])
def test_usage_and_io_errors_exit_as_the_reference(argv):
    rc, out, err = _both(argv)
    assert rc in (1, 2) and out == "" and err.startswith("dfdiag:")


def _closed_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_pod_that_never_answers_is_an_io_exit():
    addrs = ",".join(f"127.0.0.1:{_closed_port()}" for _ in range(2))
    rc, out, _ = _call(dfdiag.main, ["--pod", addrs, "--timeout", "2"])
    assert rc == 1 and "UNREACHABLE" in out


def test_qos_is_refused_by_name():
    """``--qos`` was refused by name until the QoS plane was ported; now
    it reads the daemon, and a daemon that does not answer is an IO
    exit, as for the other daemon views."""
    rc, out, err = _call(dfdiag.main, ["--qos", "--daemon",
                                       f"127.0.0.1:{_closed_port()}",
                                       "--timeout", "2"])
    assert rc == 1 and out == ""
    assert "not ported" not in err and err.startswith("dfdiag: ")


# ------------------------------------------------------------ a CPU pod

def _seeded(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    """Pull a 9 MiB file through a seed into a leecher, then read every
    surface the readers read while the pod is up."""
    tmp = tmp_path_factory.mktemp("pod")
    data = _seeded((9 << 20) + 4321, 21)
    origin = tmp / "origin.bin"
    origin.write_bytes(data)
    records_dir = tmp / "records"

    def cfg(name: str, sched_addr: str, **kw) -> DaemonConfig:
        c = DaemonConfig(
            workdir=str(tmp / name), hostname=name, listen_ip="127.0.0.1",
            host_ip="127.0.0.1", device="cpu",
            storage=StorageSection(gc_interval_s=3600),
            scheduler=DaemonSched(addresses=[sched_addr]), **kw)
        c.announce_interval_s = 0.2
        c.probe_enabled = False
        return c

    async def thread(main, argv):
        return await asyncio.to_thread(_call, main, argv)

    async def go() -> dict:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        addr = f"127.0.0.1:{port}"
        seed = Daemon(cfg("seed", addr, is_seed=True))
        await seed.start()
        sched = Scheduler(SchedulerConfig(
            listen_ip="127.0.0.1", port=port, records_dir=str(records_dir),
            seed_peers=[SeedPeerAddr(
                host_id=seed.host_info().id, ip="127.0.0.1",
                rpc_port=seed.rpc.port,
                download_port=seed.upload_server.port)]))
        await sched.start()
        debug = await start_debug_server(
            "127.0.0.1", 0,
            extra_routes=lambda router: add_scheduler_routes(router, sched))
        # the seed's first announce replays its holdings: let it land
        # before the pull starts, or the scheduler adopts a second peer
        # on the seed's host for the partial pull
        deadline = time.monotonic() + 10.0
        while seed.host_info().id not in sched.fleetpulse._series:
            assert time.monotonic() < deadline, "no announce from the seed"
            await asyncio.sleep(0.02)
        leech = Daemon(cfg("leech", addr))
        await leech.start()
        obs: dict = {}
        try:
            task_id = None
            async for resp in leech.ptm.start_file_task(DownloadRequest(
                    url=f"file://{origin}", output=str(tmp / "out"),
                    disable_back_source=True, timeout_s=30.0)):
                task_id = resp.task_id or task_id
            assert (tmp / "out").read_bytes() == data
            task = sched.resource.tasks[task_id]
            deadline = time.monotonic() + 10.0
            # the PeerResult (flight and edge rows) trails the pull, and
            # a few announces carry pulses
            while time.monotonic() < deadline and not (
                    task.state == TaskState.SUCCEEDED
                    and sched.fleetpulse.ingested >= 6):
                await asyncio.sleep(0.05)
            c = leech.ptm.conductor(task_id)
            obs.update(task_id=task_id, content=len(data),
                       traffic_p2p=c.traffic_p2p,
                       seed_addr=f"127.0.0.1:{seed.upload_server.port}",
                       leech_addr=f"127.0.0.1:{leech.upload_server.port}",
                       seed_host=seed.host_info().id,
                       leech_host=leech.host_info().id,
                       leech_peer=c.peer_id,
                       leech_summary=c.flight.compact_summary())
            addrs = f"{obs['seed_addr']},{obs['leech_addr']}"
            sch = f"127.0.0.1:{debug.port}"
            obs["pod"] = await thread(dfdiag.main,
                                      ["--pod", addrs, "--json"])
            obs["fleet"] = await thread(dfdiag.main,
                                        ["--fleet", "--scheduler", sch,
                                         "--json"])
            obs["fleet_text"] = await thread(dfdiag.main,
                                             ["--fleet", "--scheduler", sch])
            for view in ("--cluster", "--ctrl", "--decisions"):
                obs[view] = await thread(
                    dfdiag.main, [view, "--scheduler", sch, "--json"])
            obs["flight"] = await thread(
                dfdiag.main, [task_id[:16], "--daemon", obs["leech_addr"],
                              "--json"])
            obs["list"] = await thread(
                dfdiag.main, ["--list", "--daemon", obs["leech_addr"]])
            obs["sched_live"] = [
                (await thread(dfsched.main, argv),
                 await thread(ref_dfsched.main, argv))
                for argv in (["--scheduler", sch],
                             ["--scheduler", sch, "--stats"])]
            obs["pulse_seqs"] = {
                hid: [smp["seq"] for smp in s.ring]
                for hid, s in sched.fleetpulse._series.items()}
        finally:
            await leech.stop()
            await debug.stop()
            await sched.stop()          # flushes the records file
            await seed.stop()
        obs["records"] = str(records_dir)
        return obs

    return asyncio.run(asyncio.wait_for(go(), LIMIT_S))


def test_pod_report_is_the_pull(pod):
    rc, out, _ = pod["pod"]
    report = json.loads(out)
    assert rc == (3 if report["breaches"] else 0)
    (task,) = report["tasks"].values()
    assert task["task_id"] == pod["task_id"]
    assert task["content_length"] == pod["content"]
    assert task["daemons"] == task["complete"] == 2
    assert task["depth"] == 2 and task["amplification"] == 1.0
    assert task["tree"] == {pod["seed_addr"]: "origin",
                            pod["leech_addr"]: pod["seed_addr"]}
    into_leech = sum(e["bytes"] for e in task["edges"]
                     if e["dst"] == pod["leech_addr"])
    assert into_leech == pod["traffic_p2p"] == pod["content"]
    assert task["seed_uplink"]["node"] == pod["seed_addr"]
    assert task["seed_uplink"]["bytes"] == pod["content"]
    assert all(e["confirmed"] for e in task["edges"] if e["src"] != "origin")
    # the reference reads the same snapshots' report the same way
    assert dfdiag.render_pod_report(report) == \
        ref_dfdiag.render_pod_report(report)
    assert podscope.pod_verdict(report) == ref_podscope.pod_verdict(report)


def test_fleet_exit_code_follows_the_active_episodes(pod):
    rc, out, _ = pod["fleet"]
    snap = json.loads(out)
    assert rc == (3 if snap["active"] else 0)
    assert pod["fleet_text"][0] == rc
    assert snap["daemons"] == 2 and snap["ingested"] >= 6
    assert set(pod["pulse_seqs"]) == {pod["seed_host"], pod["leech_host"]}
    for seqs in pod["pulse_seqs"].values():
        assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
    assert dfdiag.render_fleet(snap) == ref_dfdiag.render_fleet(snap)
    assert pod["fleet_text"][1].startswith("fleet: daemons=2")


def test_scheduler_and_daemon_views_render_as_the_reference(pod):
    for view, render in (("--cluster", "render_cluster"),
                         ("--ctrl", "render_ctrl")):
        rc, out, _ = pod[view]
        snap = json.loads(out)
        assert rc == 0
        assert getattr(dfdiag, render)(snap) == \
            getattr(ref_dfdiag, render)(snap)
    rc, out, _ = pod["--decisions"]
    decisions = json.loads(out)["decisions"]
    assert rc == 0 and decisions
    assert [dfsched.render_decision(d) for d in decisions] == \
        [ref_dfsched.render_decision(d) for d in decisions]
    rc, out, _ = pod["flight"]
    summary = json.loads(out)
    assert rc == 0 and summary["task_id"] == pod["task_id"]
    assert dfdiag.render_waterfall(summary) == \
        ref_dfdiag.render_waterfall(summary)
    assert dfdiag.verdict(summary) == ref_dfdiag.verdict(summary)
    rc, out, _ = pod["list"]
    assert rc == 0 and json.loads(out)["tasks"][0]["task_id"] == \
        pod["task_id"]
    for got, want in pod["sched_live"]:
        assert got == want and got[0] == 0


def test_records_hold_the_edge_rows_and_dfsched_reads_them(pod):
    rows = dfsched.load_rows(pod["records"])
    assert rows == ref_dfsched.load_rows(pod["records"])
    edges = [r for r in rows if r["kind"] == "edge"]
    per_parent = pod["leech_summary"]["per_parent"]
    assert {(r["src_peer_id"], r["bytes"]) for r in edges} == \
        {(p or "origin", v["bytes"]) for p, v in per_parent.items()}
    assert all(r["dst_host_id"] == pod["leech_host"] for r in edges)
    assert sum(r["bytes"] for r in edges) == pod["content"]
    stitched = dfsched.stitch_outcomes(rows)
    assert stitched["coverage"]["piece_rows"] > 0
    assert stitched["coverage"]["ratio"] >= 0.95
    assert any(d["edges"] for d in stitched["decisions"])
    child = pod["leech_peer"][-6:]
    for extra in ([], ["--stats"], ["--json"], ["--limit", "2"],
                  ["--child", child], [pod["task_id"][:10]]):
        argv = ["--records", pod["records"], *extra]
        got = _call(dfsched.main, argv)
        assert got == _call(ref_dfsched.main, argv)
        assert got[0] == 0


# --------------------------------------------------------- dfsched replay

def _replay_records(tmp_path):
    """The reference's replay fixture: parent pa ranks first on the
    heuristic but is slow; pb ranks second and is fast."""
    rows = []
    for i in range(8):
        did = f"d{i}"
        rows.append({
            "kind": "decision", "decision_id": did, "decision_kind": "find",
            "evaluator": "default", "task_id": "t1", "peer_id": "c1",
            "host_id": "h1", "excluded": [], "chosen": ["pa", "pb"],
            "candidates": [
                {"peer_id": p, "rank": r, "total": 0.5, "host_id": f"h-{p}",
                 "features": [0.5, 1.0, 0.5, 0.5, loc, 0.0, 0.0],
                 "terms": {"piece": 0.5, "upload_success": 1.0,
                           "free_upload": 0.5, "host_type": 0.5,
                           "locality": loc}}
                for p, r, loc in (("pa", 1, 0.9), ("pb", 2, 0.4))]})
        for parent, cost, label in (("pa", 500.0, 0.3), ("pb", 5.0, 0.93)):
            rows.append({"kind": "piece", "task_id": "t1", "peer_id": "c1",
                         "decision_id": did, "parent_peer_id": parent,
                         "piece_length": 4 << 20, "cost_ms": cost,
                         "label": label})
    path = tmp_path / "r.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows))
    return path, rows


def test_replay_with_a_port_blob_prints_the_reference_flips(tmp_path):
    path, rows = _replay_records(tmp_path)
    fitted = train_decision_model(rows, seed=0, use_mesh=False,
                                  device="cpu", epochs=200)
    assert fitted is not None
    blob = tmp_path / "mlp.npz"
    blob.write_bytes(fitted[0])
    for extra in ([], ["--json"]):
        argv = ["--records", str(path), "--replay", "learned",
                "--model", str(blob), *extra]
        got = _call(dfsched.main, argv)
        assert got == _call(ref_dfsched.main, argv)
        assert got[0] == 0
    assert "replay: heuristic vs learned" in got[1] or \
        json.loads(got[1])["regret"]["decisions_judged"] == 8


def test_replay_fits_on_the_named_device(tmp_path):
    path, _ = _replay_records(tmp_path)
    rc, out, _ = _call(dfsched.main, ["--records", str(path), "--replay",
                                      "learned", "--device", "cpu"])
    assert rc == 0
    assert "fit from these records, seed 0" in out
    assert "observed-bandwidth regret over 8 judged" in out


@pytest.mark.parametrize("argv", [
    [], ["--replay", "learned"], ["--records", "/nonexistent/x.jsonl"]])
def test_dfsched_errors_exit_as_the_reference(argv):
    got = _call(dfsched.main, argv)
    assert got == _call(ref_dfsched.main, argv)
    assert got[0] in (1, 2)
