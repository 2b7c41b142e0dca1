"""The fleet pulse and the daemon pulse on the port, against the reference.

* One seeded pulse script (six daemons on a virtual clock: warm-up, a
  loop stall, an SLO storm, a byzantine burst with a self-quarantine, a
  counter reset, a daemon that goes silent and returns, one that goes
  silent for good and is evicted, junk and version-skewed pulses, message
  objects and dicts) runs through both ``FleetPulse`` classes: the
  ingest results, the anomaly rows, ``snapshot()`` (full and compact)
  along the way, and ``export_state`` -> ``restore`` (each package's
  state into both) are equal.
* ``build_pulse`` against a stand-in daemon with set counters gives the
  reference's ``dumps`` bytes, with and without the verdict and QoS
  planes (each package's own ``VerdictLedger`` fed the same verdicts; a
  stand-in QoS governor, item 5b).
* The announcer numbers its pulses and sends one on both announces; the
  scheduler's ``announce_host`` and ``announce_content`` hand them to
  ``ingest`` as the reference's do, with the self-quarantine flag and the
  pod reaching the quarantine registry and the federation view alike, and
  ``fleetpulse_enabled: false`` turns the plane off. With a state store
  the plane's rings are registered there and an incident bundle carries
  the host's quarantine standing and pod, as in the reference.
* ``/debug/fleet`` on the port's router, and the scheduler's GC runner
  ticking the plane.
* dfbench's fleet-pulse legs at 128 daemons, ``pulse_digest``,
  ``bytes_per_announce`` and every gate key equal ``BENCH_pr18.json``
  (the 1,000- and 10,000-daemon legs run in ``chip_smoke.py`` phase 13).

Tolerances are exact.
"""

import argparse
import asyncio
import json
import os
import random
import types

import pytest

from dragonfly2_tpu.common import health as ref_health
from dragonfly2_tpu.daemon import flight_recorder as ref_fr
from dragonfly2_tpu.daemon import pulse as ref_pulse
from dragonfly2_tpu.daemon import pex as ref_pex
from dragonfly2_tpu.daemon import verdicts as ref_verdicts
from dragonfly2_tpu.idl import base as ref_base
from dragonfly2_tpu.idl import messages as ref_msg
from dragonfly2_tpu.scheduler import Scheduler as RefScheduler
from dragonfly2_tpu.scheduler import SchedulerConfig as RefSchedulerConfig
from dragonfly2_tpu.scheduler import fleetpulse as ref_fp
from dragonfly2_tpu.tools import dfbench as ref_dfbench
from dragonfly2_tpu_torch.common import health
from dragonfly2_tpu_torch.common import httpd
from dragonfly2_tpu_torch.daemon import announcer
from dragonfly2_tpu_torch.daemon import flight_recorder as fr
from dragonfly2_tpu_torch.daemon import pex
from dragonfly2_tpu_torch.daemon import pulse
from dragonfly2_tpu_torch.daemon import verdicts
from dragonfly2_tpu_torch.idl import base
from dragonfly2_tpu_torch.idl import messages as msg
from dragonfly2_tpu_torch.scheduler import fleetpulse
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig
from dragonfly2_tpu_torch.scheduler.server import Scheduler
from dragonfly2_tpu_torch.tools import dfbench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INTERVAL = 30.0
HOSTS = [f"d{i}" for i in range(6)]


def _as_json(obj):
    return json.loads(json.dumps(obj))


# ------------------------------------------------------------ pulse script

def _script(seed: int = 11) -> list:
    """Steps of ``("pulse", host, pulse dict or junk, interval_s)``,
    ``("tick",)``, ``("advance", seconds)`` and ``("snap",)``."""
    rng = random.Random(seed)
    cum = {h: {"slo": 0, "rung": 0, "p2p": 0, "shed": 0, "corrupt": 0,
               "shun": 0} for h in HOSTS}
    steps: list = []
    for t in range(44):
        steps.append(("advance", INTERVAL))
        for i, h in enumerate(HOSTS):
            if h == "d3" and 22 <= t < 30:
                continue                 # silent, then back
            if h == "d5" and t >= 10:
                continue                 # silent for good: evicted
            c = cum[h]
            if h == "d4" and t == 18:    # a restart resets its counters
                c.update(slo=0, rung=0, p2p=0, shed=0)
            c["slo"] += rng.randrange(2)
            c["shed"] += rng.randrange(2)
            c["p2p"] += 4 + rng.randrange(4)
            c["rung"] += rng.randrange(2)
            lag = 4.0 + 8.0 * rng.random()
            quar = False
            if h == "d0" and 15 <= t < 18:
                lag = 600.0 + 100.0 * rng.random()
            if h == "d1" and t in (20, 21):
                c["slo"] += 12 + rng.randrange(3)
            if h == "d2" and 25 <= t < 31:
                c["corrupt"] += 5 + rng.randrange(3)
                c["shun"] += 1
                c["rung"] += 7
                c["shed"] += 11
                quar = 27 <= t < 30
            p = {"v": 1, "seq": t, "flight_tasks": 1 + i % 3,
                 "flight_evicted": t // 7,
                 "loop_lag_max_ms": round(lag, 3), "loop_stalls": t // 9,
                 "slo_breaches": c["slo"],
                 "served_rungs": {"p2p": c["p2p"], "seed": c["rung"]},
                 "qos_shed": c["shed"], "corrupt_verdicts": c["corrupt"],
                 "shunned_parents": c["shun"], "self_quarantined": quar,
                 "qos_state": "shed" if quar else "normal",
                 "storage_tasks": 2}
            steps.append(("pulse", h, p, 1.0 if h == "d4" else INTERVAL))
        if t == 5:
            steps += [("pulse", "d0", {"v": 2, "seq": 99}, INTERVAL),
                      ("pulse", "d1", "not a pulse", INTERVAL),
                      ("pulse", "", {"v": 1}, INTERVAL),
                      ("pulse", "d2", {"v": 1, "seq": "x",
                                       "loop_lag_max_ms": "junk"},
                       INTERVAL)]
        steps.append(("tick",))
        if t in (16, 21, 27, 43):
            steps.append(("snap",))
    return steps


def _drive(mod, msgs, steps, as_message: bool) -> dict:
    now = [0.0]
    rows: list = []
    plane = mod.FleetPulse(sink=rows.append, clock=lambda: now[0])
    results, snaps = [], []
    for step in steps:
        if step[0] == "advance":
            now[0] += step[1]
        elif step[0] == "tick":
            results.append(("tick", plane.tick()))
        elif step[0] == "snap":
            snaps.append((plane.snapshot(), plane.snapshot(compact=True)))
        else:
            _, host, p, interval = step
            if as_message and isinstance(p, dict) and p.get("v") == 1 \
                    and isinstance(p.get("seq"), int):
                p = msgs.PulseDigest(**{k: v for k, v in p.items()
                                        if k != "v"})
            results.append(plane.ingest(host, p, interval_s=interval))
    return {"plane": plane, "rows": rows, "results": results,
            "snaps": snaps, "now": now}


@pytest.mark.parametrize("as_message", [False, True])
def test_pulse_script_equals_the_reference(as_message):
    steps = _script()
    got = _drive(fleetpulse, msg, steps, as_message)
    want = _drive(ref_fp, ref_msg, steps, as_message)
    assert got["results"] == want["results"]
    assert _as_json(got["rows"]) == _as_json(want["rows"])
    assert _as_json(got["snaps"]) == _as_json(want["snaps"])
    plane = got["plane"]
    assert (plane.ingested, plane.ignored) == \
        (want["plane"].ingested, want["plane"].ignored)
    assert _as_json(plane.export_state()) == \
        _as_json(want["plane"].export_state())
    # the script fires every kind its signals carry, silent included
    kinds = {r["anomaly"] for r in got["rows"]}
    assert kinds == {"loop-stall", "slo-storm", "rung-escalation",
                     "shed-wave", "corrupt-burst", "silent-daemon"}
    assert all(r["decision_kind"] == "anomaly" for r in got["rows"])
    assert "d5" not in plane._series            # evicted
    assert plane.ignored == 4


def test_export_and_restore_cross_both_packages():
    steps = _script(seed=5)
    got = _drive(fleetpulse, msg, steps, False)["plane"]
    want = _drive(ref_fp, ref_msg, steps, False)["plane"]
    for state in (got.export_state(), want.export_state()):
        blob = json.loads(json.dumps(state))
        fresh = fleetpulse.FleetPulse(clock=lambda: 5000.0)
        ref_fresh = ref_fp.FleetPulse(clock=lambda: 5000.0)
        assert fresh.restore(blob, gap_s=3.0) == \
            ref_fresh.restore(blob, gap_s=3.0)
        assert _as_json(fresh.snapshot()) == _as_json(ref_fresh.snapshot())
        assert _as_json(fresh.export_state()) == \
            _as_json(ref_fresh.export_state())
        assert fresh.seq == got.seq and len(fresh.incidents) > 0
    junk = {"seq": "x", "incidents": [1, {"id": "a"}], "rings": {"h": 3}}
    with pytest.raises(ValueError):
        fleetpulse.FleetPulse().restore(junk)
    with pytest.raises(ValueError):
        ref_fp.FleetPulse().restore(junk)
    junk["seq"] = 2
    assert fleetpulse.FleetPulse().restore(junk) == \
        ref_fp.FleetPulse().restore(junk) == 1


def test_the_vocabulary_and_constants_are_the_reference_s():
    assert fleetpulse.ANOMALY_KINDS == ref_fp.ANOMALY_KINDS
    for name in ("PULSE_RING", "INCIDENT_RING", "ANOMALY_LOG", "EWMA_ALPHA",
                 "Z_THRESHOLD", "Z_CLEAR", "WARMUP_SAMPLES",
                 "SILENT_AFTER_INTERVALS", "EVICT_AFTER_INTERVALS",
                 "PRIMARY_RUNG", "_SIGNALS"):
        assert getattr(fleetpulse, name) == getattr(ref_fp, name), name


# ------------------------------------------------------------ daemon pulse

def _standin(fr_mod, verdicts_mod, *, planes: bool):
    rec = fr_mod.FlightRecorder(max_tasks=2)
    for i in range(3):
        flight = rec.begin(f"t{i}" * 32, f"p{i}")
        flight.rung("p2p")
        flight.rung("back_source" if i else "pex")
    d = types.SimpleNamespace(
        flight_recorder=rec,
        storage_mgr=types.SimpleNamespace(tasks=lambda: [1, 2, 3, 4]))
    if planes:
        d.verdicts = verdicts_mod.VerdictLedger(clock=lambda: 0.0)
        for addr, code in (("a", "corrupt"), ("a", "corrupt"),
                           ("a", "corrupt"), ("b", "stall"),
                           ("b", "corrupt")):
            d.verdicts.record(addr, code)
        d.verdicts.self_quarantine("boot re-verify")
        d.qos = types.SimpleNamespace(state="brownout",
                                      counters={"shed": {"bulk": 4,
                                                         "standard": 1}})
    return d


def _set_health_planes(monkeypatch, lag_s: float, stalls: int,
                       counts: dict) -> None:
    """The same readings in both packages' process-wide health planes
    (their samplers run live in a test process)."""
    for mod in (health, ref_health):
        plane = mod.PLANE
        monkeypatch.setattr(plane, "max_lag_s", lag_s)
        monkeypatch.setattr(plane, "stalls", stalls)
        monkeypatch.setattr(plane.slo, "_counts", dict(counts))


@pytest.mark.parametrize("planes", [False, True])
def test_build_pulse_gives_the_reference_bytes(planes, monkeypatch):
    _set_health_planes(monkeypatch, 0.25, 3,
                       {("wire", "p"): 4, ("hbm", "q"): 2})
    got = pulse.build_pulse(_standin(fr, verdicts, planes=planes), 7)
    want = ref_pulse.build_pulse(_standin(ref_fr, ref_verdicts,
                                          planes=planes), 7)
    assert base.dumps(got) == ref_base.dumps(want)
    assert (got.seq, got.flight_tasks, got.flight_evicted) == (7, 2, 1)
    assert got.served_rungs == {"p2p": 3, "pex": 1, "back_source": 2}
    assert (got.loop_lag_max_ms, got.loop_stalls, got.slo_breaches,
            got.storage_tasks) == (250.0, 3, 6, 4)
    if not planes:       # no verdict ledger, no QoS plane: the defaults
        assert (got.corrupt_verdicts, got.shunned_parents,
                got.self_quarantined, got.qos_state, got.qos_shed) == \
            (0, 0, False, "normal", 0)
    else:
        assert (got.corrupt_verdicts, got.shunned_parents,
                got.self_quarantined) == (4, 1, True)


def test_a_bare_daemon_pulses_the_reference_defaults(monkeypatch):
    _set_health_planes(monkeypatch, 0.0, 0, {})
    bare = types.SimpleNamespace()
    assert base.dumps(pulse.build_pulse(bare, 1)) == \
        ref_base.dumps(ref_pulse.build_pulse(bare, 1))


def test_announce_messages_with_a_pulse_have_the_reference_bytes():
    assert dfbench._pulse_overhead_bytes() == \
        ref_dfbench._pulse_overhead_bytes() == 297
    reqs = [(m.AnnounceHostRequest(host=_host(m), interval_s=1.0,
                                   pulse=m.PulseDigest(seq=3, served_rungs={
                                       "p2p": 4})),
             m.AnnounceContentRequest(host=_host(m), digest=b"x",
                                      pulse=m.PulseDigest(seq=4)))
            for m in (msg, ref_msg)]
    for got, want in zip(*reqs):
        assert base.dumps(got) == ref_base.dumps(want)
        assert base.decode(base.loads(base.dumps(got)),
                           type(got)).pulse.seq == got.pulse.seq


# -------------------------------------------------- announcer and service

def test_the_announcer_numbers_its_pulses_on_both_announces():
    sent = []

    async def go():
        conn = types.SimpleNamespace(reconcile_event=None)

        async def announce_host(req):
            sent.append(req)

        async def announce_content(req):
            sent.append(req)
            return msg.AnnounceContentResponse(tasks_adopted=1)

        conn.announce_host = announce_host
        conn.announce_content = announce_content
        md = types.SimpleNamespace(task_id="d" * 64, url="u", pieces={0: 1},
                                   done=True, success=True,
                                   total_piece_count=1, content_length=4,
                                   piece_size=4)
        daemon = types.SimpleNamespace(
            cfg=types.SimpleNamespace(announce_interval_s=0.01),
            scheduler=conn, host_info=lambda: msg.Host(id="h"),
            paths=types.SimpleNamespace(data_dir="/"),
            flight_recorder=fr.FlightRecorder(),
            storage_mgr=types.SimpleNamespace(
                tasks=lambda: [types.SimpleNamespace(md=md)]))
        ann = announcer.Announcer(daemon)
        await ann.start()
        try:
            while len(sent) < 4:
                await asyncio.sleep(0.01)
        finally:
            await ann.stop()

    asyncio.run(asyncio.wait_for(go(), 10.0))
    assert isinstance(sent[0], msg.AnnounceHostRequest)
    assert isinstance(sent[1], msg.AnnounceContentRequest)
    assert [r.pulse.seq for r in sent[:4]] == [1, 2, 3, 4]
    assert sent[0].pulse.storage_tasks == 1


def _host(m, name="leech"):
    # the content re-announcer flags its own bit rot; the leecher has a pod
    return m.Host(id=f"{name}-127.0.0.1", ip="127.0.0.1", hostname=name,
                  port=7001, download_port=7002, quarantined=name == "c",
                  topology=(m.TopologyInfo(pod="pod-l") if name == "leech"
                            else None))


def _digest(seal):
    return seal({"v": 1, "tasks": [{"task_id": "d" * 64, "url": "u",
                                    "total": 1, "content_length": 4,
                                    "piece_size": 4, "done": True}]})


def _announce_all(sched, m, seal):
    sched.fleetpulse.clock = lambda: 1000.0
    svc = sched.service
    out = []
    for seq in range(1, 4):
        out.append(asyncio.run(svc.announce_host(m.AnnounceHostRequest(
            host=_host(m), interval_s=1.0,
            pulse=m.PulseDigest(seq=seq, loop_lag_max_ms=2.0 * seq)),
            None)).scheduler_epoch > 0)
    # no pulse, and a host without one: nothing to ingest
    asyncio.run(svc.announce_host(m.AnnounceHostRequest(host=_host(m, "b")),
                                  None))
    for digest in (_digest(seal), b"torn"):
        resp = asyncio.run(svc.announce_content(m.AnnounceContentRequest(
            host=_host(m, "c"), digest=digest,
            pulse=m.PulseDigest(seq=9)), None))
        out.append(resp.tasks_adopted)
    return out, sched.fleetpulse.snapshot()


def test_announces_reach_ingest_as_in_the_reference():
    port = Scheduler(SchedulerConfig(listen_ip="127.0.0.1",
                                     federation_enabled=True))
    ref = RefScheduler(RefSchedulerConfig(federation_enabled=True))
    got = _announce_all(port, msg, pex.seal)
    want = _announce_all(ref, ref_msg, ref_pex.seal)
    assert _as_json(got) == _as_json(want)
    # the flag and the pod reach both schedulers' planes alike
    assert port.quarantine.snapshot()["hosts"].keys() \
        == ref.quarantine.snapshot()["hosts"].keys() == {"c-127.0.0.1"}
    assert port.quarantine.state("c-127.0.0.1") == "quarantined"
    assert port.federation.describe() == ref.federation.describe()
    assert port.federation.pod_of_host("leech-127.0.0.1") == "pod-l"
    snap = got[1]
    assert (snap["daemons"], snap["ingested"]) == (2, 4)
    series = port.fleetpulse._series
    assert series["leech-127.0.0.1"].interval_s == 1.0
    assert [s["seq"] for s in series["leech-127.0.0.1"].ring] == [1, 2, 3]
    # the content re-announce carries no interval: the reference's 30 s
    assert series["c-127.0.0.1"].interval_s == 30.0
    assert got[0] == [True, True, True, 1, 0]


def test_rings_register_with_the_state_store_and_bundles_carry_standing(
        tmp_path):
    sched = Scheduler(SchedulerConfig(
        listen_ip="127.0.0.1", federation_enabled=True,
        statestore_dir=str(tmp_path / "state")))
    ref = RefScheduler(RefSchedulerConfig(
        federation_enabled=True, statestore_dir=str(tmp_path / "ref")))
    assert sched.fleetpulse.statestore is sched.statestore
    assert list(sched.statestore._exports) == list(ref.statestore._exports)
    rows = []
    for s, m in ((sched, msg), (ref, ref_msg)):
        s.fleetpulse.clock = lambda: 0.0
        s.federation.observe_host("h1", m.TopologyInfo(pod="pod-q"))
        s.quarantine.record_self("h1", True, reason="rot")
        s.fleetpulse.ingest("h1", {"v": 1, "seq": 1}, interval_s=1.0)
        rows.append(s.fleetpulse._bundle(
            {"host_id": "h1", "anomaly": "x", "signal": "s", "value": 1.0,
             "decision_id": "a00000001.x",
             "zscore": 0.0, "at": 0.0}, s.fleetpulse._series["h1"]))
    assert rows[0]["quarantine"] == rows[1]["quarantine"] == "quarantined"
    assert rows[0]["pod"] == rows[1]["pod"] == "pod-q"


def test_fleetpulse_enabled_false_turns_the_plane_off():
    sched = Scheduler(SchedulerConfig(listen_ip="127.0.0.1",
                                      fleetpulse_enabled=False))
    assert sched.fleetpulse is None and sched.service.fleetpulse is None
    assert "fleetpulse" not in sched.gc._tasks
    resp = asyncio.run(sched.service.announce_host(msg.AnnounceHostRequest(
        host=_host(msg), pulse=msg.PulseDigest(seq=1)), None))
    assert resp.scheduler_epoch == sched.service.epoch
    from dragonfly2_tpu_torch.tools.scheduler import add_scheduler_routes
    router = httpd.Router()
    add_scheduler_routes(router, sched)
    assert router.match("GET", "/debug/fleet") is None
    assert router.match("GET", "/debug/decisions") is not None


def test_debug_fleet_route_and_the_gc_tick():
    sched = Scheduler(SchedulerConfig(listen_ip="127.0.0.1"))
    now = [0.0]
    sched.fleetpulse.clock = lambda: now[0]
    sched.fleetpulse.ingest("h1", {"v": 1, "seq": 1}, interval_s=1.0)
    from dragonfly2_tpu_torch.tools.scheduler import add_scheduler_routes
    router = httpd.Router()
    add_scheduler_routes(router, sched)
    handler, params = router.match("GET", "/debug/fleet")

    async def go():
        full = await handler(params, {})
        compact = await handler(params, {"compact": "1"})
        now[0] = 10.0       # past 2.5 intervals of 1 s: silent
        n = await sched.gc.run_one("fleetpulse")
        after = await handler(params, {"compact": "true"})
        return full, compact, n, after

    full, compact, n, after = asyncio.run(go())
    assert full[0] == compact[0] == 200
    assert "incident_bundles" in full[1] and "incident_ids" in compact[1]
    assert full[1]["daemons"] == 1 and full[1]["ingested"] == 1
    assert n == 1
    assert after[1]["active"] == [{"host_id": "h1",
                                   "anomaly": "silent-daemon",
                                   "since_s": 0.0}]
    assert after[1]["incident_ids"] == ["a00000001.silent-daemon"]
    assert sched.ledger._ring[-1]["decision_kind"] == "anomaly"


# ---------------------------------------------------------------- dfbench

@pytest.mark.parametrize("inject", dfbench.PULSE_INJECTIONS)
def test_fleetpulse_leg_equals_the_reference(inject):
    got = dfbench.run_fleetpulse_bench(daemons=dfbench.PULSE_SMOKE_FLEET,
                                       inject=inject)
    want = ref_dfbench.run_fleetpulse_bench(
        daemons=ref_dfbench.PULSE_SMOKE_FLEET, inject=inject)
    for leg in (got, want):
        assert leg.pop("ingest_per_sec") > 0     # this host's wall rate
    assert got == want


def test_smoke_legs_and_gates_equal_the_committed_file():
    """``BENCH_pr18.json`` holds the 128-, 1,000- and 10,000-daemon legs;
    at 128 daemons every leg and ``pulse_digest`` (over the 128-daemon
    legs) equal it, and so do the gates the 128-daemon legs decide."""
    args = argparse.Namespace(seed=7, daemons=8, pieces=64,
                              piece_size=4 << 20, parallelism=4, smoke=True)
    got = dfbench.fleetpulse_legs(args)
    with open(os.path.join(ROOT, "BENCH_pr18.json")) as f:
        want = json.load(f)
    assert set(want) - set(got) == {"fleetpulse_pure"}
    for name, leg in got["legs"].items():
        leg = dict(leg)
        ref_leg = dict(want["legs"][name])
        leg.pop("ingest_per_sec")
        ref_leg.pop("ingest_per_sec")
        assert leg == ref_leg, name
    for key in ("bench", "seed", "intervals", "inject_at", "schedule_digest",
                "pulse_digest", "bytes_per_announce", "pulse_overhead_ok",
                "detection_bounded", "zero_false_positives",
                "detected_kinds", "detection_latency_intervals"):
        assert got[key] == want[key], key
    assert got["fleets"] == [128] and want["fleets"] == [128, 1000, 10000]
