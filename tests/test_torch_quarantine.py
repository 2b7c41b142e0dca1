"""The swarm's immune system on the port and against the reference: the
daemon's verdict ledger (``daemon/verdicts.py``) and the scheduler's
quarantine registry (``scheduler/quarantine.py``).

* The reference's ``tests/test_quarantine.py`` cases: the ledger's and the
  ladder's run through both packages (``pkg`` parameter); the filter's
  ``quarantined`` exclusion, the seed election, the PEX anti-slander
  rules, podscope's quarantine view and the engine's shun run on the port.
* Parity: a seeded verdict stream on a fake clock goes through both
  packages' ``VerdictLedger`` and ``QuarantineRegistry`` and gives equal
  states, snapshots, decision rows and ``export_state``; seed elections
  over seeded host sets and quarantine states are equal; with a host
  quarantined, both packages' ``Scheduling`` exclude it in equal rows.
* The reference's byzantine swarm e2e on the port (a 26 MiB file, six
  leechers with device sinks on the CPU, a poisoner serving corrupt
  bytes), and the daemon's verdict
  surfaces: ``GET /debug/verdicts``, the self-quarantine flag on
  ``Host`` and the announcer's empty replay.
"""

import asyncio
import json
import os
import random
import urllib.request

import pytest
import torch

import dragonfly2_tpu.daemon.verdicts as ref_verdicts
import dragonfly2_tpu.idl.base as ref_base
import dragonfly2_tpu.idl.messages as ref_msg
import dragonfly2_tpu.scheduler.quarantine as ref_quarantine
from dragonfly2_tpu.scheduler.config import SchedulerConfig as RefSchedCfg
from dragonfly2_tpu.scheduler.config import SeedPeerAddr as RefSeedAddr
from dragonfly2_tpu.scheduler.evaluator import Evaluator as RefEvaluator
from dragonfly2_tpu.scheduler.resource import PeerState as RefPeerState
from dragonfly2_tpu.scheduler.resource import Resource as RefResource
from dragonfly2_tpu.scheduler.resource import Task as RefTask
from dragonfly2_tpu.scheduler.scheduling import Scheduling as RefScheduling
from dragonfly2_tpu.scheduler.seed_client import \
    SeedPeerClient as RefSeedClient
import dragonfly2_tpu_torch.daemon.verdicts as port_verdicts
import dragonfly2_tpu_torch.idl.base as port_base
import dragonfly2_tpu_torch.scheduler.quarantine as port_quarantine
from dragonfly2_tpu_torch.common import faultgate, podscope
from dragonfly2_tpu_torch.daemon import flight_recorder as fr
from dragonfly2_tpu_torch.daemon.announcer import Announcer
from dragonfly2_tpu_torch.daemon.config import DaemonConfig, StorageSection
from dragonfly2_tpu_torch.daemon.config import SchedulerConfig as DaemonSched
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.daemon.flight_recorder import TaskFlight
from dragonfly2_tpu_torch.daemon.pex import PexGossiper
from dragonfly2_tpu_torch.daemon.piece_engine import PieceEngine
from dragonfly2_tpu_torch.idl.messages import (DeviceSink, DownloadRequest,
                                               Host, HostType, PieceInfo)
from dragonfly2_tpu_torch.scheduler.config import (SchedulerConfig,
                                                   SeedPeerAddr)
from dragonfly2_tpu_torch.scheduler.evaluator import Evaluator
from dragonfly2_tpu_torch.scheduler.resource import (PeerState, Resource,
                                                     Task)
from dragonfly2_tpu_torch.scheduler.scheduling import (EXCLUSION_REASONS,
                                                       Scheduling)
from dragonfly2_tpu_torch.scheduler.seed_client import SeedPeerClient
from dragonfly2_tpu_torch.scheduler.server import Scheduler

from torch_origin import Origin

E2E_LIMIT_S = 90.0
PKGS = {"reference": (ref_verdicts, ref_quarantine),
        "port": (port_verdicts, port_quarantine)}


@pytest.fixture(autouse=True)
def _disarm():
    faultgate.reset()
    yield
    faultgate.reset()


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    """(verdicts module, quarantine module) of one package."""
    return PKGS[request.param]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


# ---------------------------------------------------------------------
# the verdict ledger (both packages)
# ---------------------------------------------------------------------

def test_corrupt_verdicts_flip_to_shunned_once(pkg):
    v = pkg[0].VerdictLedger(clock=FakeClock())
    assert not v.record("10.0.0.5:8000", "corrupt")
    assert not v.shunned("10.0.0.5:8000")
    assert v.deprioritized("10.0.0.5:8000")
    assert v.record("10.0.0.5:8000", "corrupt")
    assert v.shunned("10.0.0.5:8000")
    assert not v.record("10.0.0.5:8000", "corrupt")
    assert v.shunned_addrs() == ["10.0.0.5:8000"]


def test_soft_codes_never_shun(pkg):
    v = pkg[0].VerdictLedger(clock=FakeClock())
    for code in ("stall", "timeout", "refused"):
        for _ in range(20):
            assert not v.record("10.0.0.6:8000", code)
    assert not v.shunned("10.0.0.6:8000")


def test_evidence_decays_back_to_clean(pkg):
    clk = FakeClock()
    v = pkg[0].VerdictLedger(halflife_s=10.0, clock=clk)
    v.record("a:1", "corrupt")
    v.record("a:1", "corrupt")
    assert v.shunned("a:1")
    clk.t += 120.0
    assert not v.shunned("a:1")
    assert not v.deprioritized("a:1")


def test_relayed_corruption_never_shuns_only_deprioritizes(pkg):
    v = pkg[0].VerdictLedger(clock=FakeClock())
    for _ in range(50):
        v.record("relay:1", "corrupt", relayed=True)
    assert not v.shunned("relay:1")
    assert v.deprioritized("relay:1")
    v.record("direct:1", "corrupt")
    v.record("direct:1", "corrupt")
    assert v.shunned("direct:1")


def test_anti_slander_hints_only_deprioritize(pkg):
    clk = FakeClock()
    v = pkg[0].VerdictLedger(clock=clk)
    for _ in range(100):
        v.hint("victim:9000")
    assert v.deprioritized("victim:9000")
    assert not v.shunned("victim:9000")
    clk.t += 1000.0
    assert not v.deprioritized("victim:9000")


def test_hint_plus_local_verdict_still_requires_local_threshold(pkg):
    v = pkg[0].VerdictLedger(clock=FakeClock())
    v.hint("x:1")
    assert not v.record("x:1", "corrupt")
    assert not v.shunned("x:1")
    assert v.record("x:1", "corrupt")
    assert v.shunned("x:1")


def test_self_quarantine_is_sticky_and_snapshotted(pkg):
    v = pkg[0].VerdictLedger(clock=FakeClock())
    assert not v.self_quarantined
    v.self_quarantine("boot re-verify dropped 3 pieces")
    assert v.self_quarantined
    snap = v.snapshot()
    assert snap["self_quarantined"] is True
    assert "re-verify" in snap["self_reason"]


def test_reoffense_after_decay_flips_again(pkg):
    clk = FakeClock()
    v = pkg[0].VerdictLedger(halflife_s=10.0, clock=clk)
    assert not v.record("p:1", "corrupt")
    assert v.record("p:1", "corrupt")
    assert not v.record("p:1", "corrupt")
    clk.t += 120.0
    assert not v.shunned("p:1")
    assert not v.record("p:1", "corrupt")
    assert v.record("p:1", "corrupt")
    assert v.shunned("p:1")


def test_hint_ledger_growth_is_bounded(pkg):
    clk = FakeClock()
    v = pkg[0].VerdictLedger(clock=clk)
    v.record("real:1", "corrupt")
    for i in range(2 * v.MAX_PARENTS):
        clk.t += 0.01
        v.hint(f"fake{i}:1")
    assert len(v._parents) <= v.MAX_PARENTS
    assert "real:1" in v._parents


# ---------------------------------------------------------------------
# the quarantine ladder (both packages)
# ---------------------------------------------------------------------

def _registry(pkg, clk, **kw):
    rows = []
    reg = pkg[1].QuarantineRegistry(
        corrupt_threshold=3.0, halflife_s=600.0, probation_delay_s=5.0,
        probe_successes=2, probe_children=1, sink=rows.append, clock=clk,
        **kw)
    return reg, rows


def test_ladder_walks_healthy_suspect_quarantined(pkg):
    clk = FakeClock()
    reg, rows = _registry(pkg, clk)
    assert reg.state("h1") == "healthy"
    reg.record_corrupt("h1", task_id="t1", reporter="r1")
    assert reg.state("h1") == "suspect"
    assert reg.offerable("h1", "c1")
    reg.record_corrupt("h1", task_id="t1", reporter="r2")
    reg.record_corrupt("h1", task_id="t2", reporter="r1")
    assert reg.state("h1") == "quarantined"
    assert not reg.offerable("h1", "c1")
    assert [r["to_state"] for r in rows] == ["suspect", "quarantined"]
    assert rows[-1]["tasks"] == 2
    assert sorted(rows[-1]["reporters"]) == ["r1", "r2"]


def test_probation_probe_budget_and_reprieve(pkg):
    clk = FakeClock()
    reg, rows = _registry(pkg, clk)
    for i in range(3):
        reg.record_corrupt("h1", task_id="t", reporter=f"r{i}")
    assert not reg.offerable("h1", "c1")
    clk.t += 5.1
    assert reg.state("h1") == "probation"
    assert reg.offerable("h1", "c1")
    assert not reg.offerable("h1", "c2")
    assert reg.offerable("h1", "c1")
    reg.record_ok("h1")
    assert reg.state("h1") == "probation"
    reg.record_ok("h1")
    assert reg.state("h1") == "healthy"
    assert rows[-1]["to_state"] == "healthy"
    assert reg.offerable("h1", "c2")


def test_corrupt_during_probation_goes_straight_back(pkg):
    clk = FakeClock()
    reg, _rows = _registry(pkg, clk)
    for i in range(3):
        reg.record_corrupt("h1", reporter=f"r{i}")
    clk.t += 5.1
    assert reg.state("h1") == "probation"
    reg.record_corrupt("h1", reporter="probe-child")
    assert reg.state("h1") == "quarantined"
    clk.t += 4.9
    assert reg.state("h1") == "quarantined"
    clk.t += 0.2
    assert reg.state("h1") == "probation"


def test_self_flag_quarantines_and_clearing_gives_probation(pkg):
    clk = FakeClock()
    reg, rows = _registry(pkg, clk)
    reg.record_self("h2", True, reason="announce flag")
    assert reg.state("h2") == "quarantined"
    clk.t += 100.0
    assert reg.state("h2") == "quarantined"
    reg.record_self("h2", False)
    assert reg.state("h2") == "probation"
    assert [r["to_state"] for r in rows] == ["quarantined", "probation"]


def test_snapshot_names_states(pkg):
    reg, _rows = _registry(pkg, FakeClock())
    for i in range(3):
        reg.record_corrupt("bad-host", reporter=f"r{i}")
    snap = reg.snapshot()
    assert snap["hosts"]["bad-host"]["state"] == "quarantined"
    assert snap["hosts"]["bad-host"]["corrupt_evidence"] >= 3.0


def test_single_reporter_cannot_quarantine(pkg):
    reg, _rows = _registry(pkg, FakeClock())
    for _ in range(20):
        reg.record_corrupt("victim", reporter="liar")
    assert reg.state("victim") == "suspect"
    assert reg.offerable("victim", "c1")
    reg.record_corrupt("victim", reporter="corroborator")
    assert reg.state("victim") == "quarantined"


def test_relayed_evidence_suspects_but_never_quarantines(pkg):
    reg, _rows = _registry(pkg, FakeClock())
    for i in range(50):
        reg.record_corrupt("relay-host", relayed=True, reporter=f"r{i}")
    assert reg.state("relay-host") == "suspect"
    assert reg.offerable("relay-host", "c1")
    snap = reg.snapshot()["hosts"]["relay-host"]
    assert snap["relayed_evidence"] >= 49.0
    assert snap["corrupt_evidence"] == 0.0
    for _ in range(3):
        reg.record_corrupt("relay-host")
    assert reg.state("relay-host") == "quarantined"


# ---------------------------------------------------------------------
# seeded verdict streams through both packages
# ---------------------------------------------------------------------

def _ledger_stream(mod, seed: int) -> list:
    """A seeded op stream on one package's ledger; every op's answer and
    a snapshot after each step."""
    rng = random.Random(seed)
    clk = FakeClock()
    v = mod.VerdictLedger(halflife_s=30.0, hint_ttl_s=20.0, clock=clk)
    addrs = [f"10.0.0.{i}:80" for i in range(6)]
    out = []
    for _ in range(400):
        clk.t += rng.choice((0.0, 0.5, 3.0, 25.0))
        op = rng.random()
        a = rng.choice(addrs)
        if op < 0.35:
            code = rng.choice(("corrupt", "corrupt", "stall", "timeout",
                               "refused", "bogus"))
            out.append(["record", v.record(a, code, peer_id=f"p{rng.randrange(3)}",
                                           relayed=rng.random() < 0.2)])
        elif op < 0.55:
            v.record_ok(a)
            out.append(["ok", a])
        elif op < 0.7:
            v.hint(a)
            out.append(["hint", a])
        elif op < 0.72:
            v.self_quarantine(f"rot {rng.randrange(9)}")
            out.append(["selfq"])
        else:
            out.append(["query", v.shunned(a), v.deprioritized(a),
                        round(v.corrupt_score(a), 9)])
        out.append(v.snapshot())
    out.append(v.shunned_addrs())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_a_seeded_verdict_stream_gives_equal_ledgers(seed):
    assert _ledger_stream(port_verdicts, seed) \
        == _ledger_stream(ref_verdicts, seed)


def _registry_stream(mod, seed: int) -> tuple[list, list]:
    rng = random.Random(seed)
    clk = FakeClock()
    rows: list = []
    reg = mod.QuarantineRegistry(
        corrupt_threshold=3.0, halflife_s=60.0, probation_delay_s=10.0,
        probe_successes=2, probe_children=1, min_reporters=2,
        sink=rows.append, clock=clk)
    hosts = [f"host-{i}" for i in range(5)]
    out = []
    for _ in range(500):
        clk.t += rng.choice((0.0, 0.2, 2.0, 11.0))
        op = rng.random()
        h = rng.choice(hosts)
        if op < 0.4:
            reg.record_corrupt(h, task_id=f"t{rng.randrange(3)}",
                               reporter=f"r{rng.randrange(4)}",
                               relayed=rng.random() < 0.15)
        elif op < 0.6:
            reg.record_ok(h)
        elif op < 0.66:
            reg.record_self(h, rng.random() < 0.5, reason="flag")
        elif op < 0.85:
            out.append(["offerable", h,
                        reg.offerable(h, f"c{rng.randrange(3)}")])
        else:
            out.append(["state", h, reg.state(h)])
        out.append(reg.snapshot())
        out.append(reg.export_state())
    out.append(reg.quarantined_hosts())
    return out, rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_a_seeded_verdict_stream_gives_equal_registries(seed):
    got, got_rows = _registry_stream(port_quarantine, seed)
    want, want_rows = _registry_stream(ref_quarantine, seed)
    assert got == want
    assert got_rows == want_rows
    assert any(r["to_state"] == "quarantined" for r in got_rows)
    assert any(r["to_state"] == "probation" for r in got_rows)


@pytest.mark.parametrize("src,dst", [(ref_quarantine, port_quarantine),
                                     (port_quarantine, ref_quarantine)])
def test_export_state_restores_in_the_other_package(src, dst):
    clk = FakeClock()
    a = src.QuarantineRegistry(probation_delay_s=10.0, clock=clk)
    for i in range(3):
        a.record_corrupt("bad", task_id="t", reporter=f"r{i}")
    a.record_corrupt("meh", reporter="r0")
    a.record_self("rot", True, reason="boot re-verify")
    blob = json.loads(json.dumps(a.export_state()))
    b = dst.QuarantineRegistry(probation_delay_s=10.0, clock=clk)
    c = src.QuarantineRegistry(probation_delay_s=10.0, clock=clk)
    assert b.restore(blob, gap_s=5.0) == c.restore(blob, gap_s=5.0) == 3
    assert b.snapshot() == c.snapshot()
    assert b.export_state() == c.export_state()
    assert b.state("bad") == "quarantined"
    clk.t += 10.5
    assert b.state("bad") == c.state("bad") == "probation"
    assert b.state("rot") == "quarantined"
    # the handoff import tops out at suspect in both
    d = dst.QuarantineRegistry(clock=clk)
    e = src.QuarantineRegistry(clock=clk)
    assert d.import_summary(blob, source="s1") \
        == e.import_summary(blob, source="s1")
    assert d.snapshot() == e.snapshot()
    assert {h: d.state(h) for h in ("bad", "meh", "rot")} \
        == {"bad": "suspect", "meh": "suspect", "rot": "suspect"}


# ---------------------------------------------------------------------
# the scheduling filter and the seed election
# ---------------------------------------------------------------------

def _cluster(pkg_res, pkg_task, pkg_state, host_cls, htype=None):
    res = pkg_res()
    task = pkg_task("t" + "0" * 63, "u://x")
    task.set_content_info(100 * 4, 4, 100)

    def peer(name):
        host = res.store_host(host_cls(id=f"{name}-host", ip="1.2.3.4",
                                       port=1, download_port=2))
        p = res.get_or_create_peer(f"{name}-peer", task, host)
        p.transit(pkg_state.RUNNING)
        return p
    return res, task, peer


def test_quarantined_parent_excluded_with_reason():
    assert "quarantined" in EXCLUSION_REASONS
    _res, _task, peer = _cluster(Resource, Task, PeerState, Host)
    good = peer("good")
    good.finished_pieces = set(range(100))
    bad = peer("bad")
    bad.finished_pieces = set(range(100))
    child = peer("child")
    reg = port_quarantine.QuarantineRegistry(corrupt_threshold=1.0,
                                             min_reporters=1)
    sched = Scheduling(Evaluator(), rng=random.Random(0), quarantine=reg)
    rows = []
    sched.decision_sink = rows.append
    assert {p.id for p in sched.find_parents(child)} \
        == {"good-peer", "bad-peer"}
    reg.record_corrupt("bad-host")
    child.last_offer_ids = set()
    assert {p.id for p in sched.find_parents(child)} == {"good-peer"}
    excluded = [e for r in rows for e in r.get("excluded") or []]
    assert any(e["reason"] == "quarantined" and e["host_id"] == "bad-host"
               for e in excluded)


def _seeded_rulings(port: bool, seed: int, quarantined: int) -> list:
    """Find rulings over a seeded 12-holder cluster with the first
    ``quarantined`` hosts quarantined; the reference's pool shuffle is the
    module rng, the port's a seeded stream."""
    if port:
        res, task, peer = _cluster(Resource, Task, PeerState, Host)
        reg = port_quarantine.QuarantineRegistry(corrupt_threshold=1.0,
                                                 min_reporters=1)
        sched = Scheduling(Evaluator(), rng=random.Random(seed),
                           quarantine=reg)
    else:
        res, task, peer = _cluster(RefResource, RefTask, RefPeerState,
                                   ref_msg.Host)
        reg = ref_quarantine.QuarantineRegistry(corrupt_threshold=1.0,
                                                min_reporters=1)
        sched = RefScheduling(RefSchedCfg(), RefEvaluator(), quarantine=reg)
        random.seed(seed)
    rng = random.Random(seed + 100)
    holders = [peer(f"h{i:02d}") for i in range(12)]
    for h in holders:
        h.finished_pieces = set(rng.sample(range(100), rng.randrange(10, 90)))
    for h in holders[:quarantined]:
        reg.record_corrupt(h.host.id)
    rows: list = []
    sched.decision_sink = rows.append
    out = []
    for i in range(6):
        child = peer(f"c{i}")
        out.append([p.id for p in sched.find_parents(child)])
    for r in rows:
        r.pop("created_at", None)
    return out + [[(e["peer_id"], e["reason"]) for e in r["excluded"]]
                  for r in rows]


@pytest.mark.parametrize("seed,quarantined", [(3, 0), (4, 2), (5, 5)])
def test_rulings_with_quarantined_hosts_equal_the_reference(seed,
                                                            quarantined):
    assert _seeded_rulings(True, seed, quarantined) \
        == _seeded_rulings(False, seed, quarantined)


def test_armed_empty_registry_and_no_federation_change_nothing():
    def rulings(**kw):
        _res, _task, peer = _cluster(Resource, Task, PeerState, Host)
        rng = random.Random(9)
        for i in range(10):
            p = peer(f"h{i}")
            p.finished_pieces = set(rng.sample(range(100), 50))
        sched = Scheduling(Evaluator(), rng=random.Random(9), **kw)
        rows: list = []
        sched.decision_sink = rows.append
        out = [[p.id for p in sched.find_parents(peer(f"c{i}"))]
               for i in range(5)]
        for r in rows:
            r.pop("created_at", None)
        return out, rows
    bare = rulings()
    assert rulings(quarantine=port_quarantine.QuarantineRegistry()) == bare
    assert rulings(quarantine=port_quarantine.QuarantineRegistry(),
                   federation=None) == bare


def test_seed_election_skips_quarantined():
    reg = port_quarantine.QuarantineRegistry(corrupt_threshold=1.0,
                                             min_reporters=1)
    seeds = [SeedPeerAddr(host_id=f"s{i}", ip="127.0.0.1", rpc_port=i)
             for i in range(1, 4)]
    sc = SeedPeerClient(Resource(), seeds, quarantine=reg)
    first = sc._elect("task-x")
    reg.record_corrupt(first)
    second = sc._elect("task-x")
    assert second != first
    for s in seeds:
        reg.record_corrupt(s.host_id)
    assert sc._elect("task-x") in {s.host_id for s in seeds}


@pytest.mark.parametrize("seed", [0, 1])
def test_seed_elections_equal_the_reference(seed):
    rng = random.Random(seed)
    ids = [f"seed-{rng.randrange(10**6)}" for _ in range(7)]
    bad = rng.sample(ids, 3)
    port_reg = port_quarantine.QuarantineRegistry(corrupt_threshold=1.0,
                                                  min_reporters=1)
    ref_reg = ref_quarantine.QuarantineRegistry(corrupt_threshold=1.0,
                                                min_reporters=1)
    port_sc = SeedPeerClient(Resource(), [SeedPeerAddr(host_id=h)
                                          for h in ids], quarantine=port_reg)
    ref_sc = RefSeedClient(RefResource(), [RefSeedAddr(host_id=h)
                                           for h in ids], quarantine=ref_reg)
    tasks = [f"task-{rng.randrange(10**9)}" for _ in range(40)]
    before = [port_sc._elect(t) for t in tasks]
    assert before == [ref_sc._elect(t) for t in tasks]
    for h in bad:
        port_reg.record_corrupt(h)
        ref_reg.record_corrupt(h)
    after = [port_sc._elect(t) for t in tasks]
    assert after == [ref_sc._elect(t) for t in tasks]
    assert not set(after) & set(bad)


# ---------------------------------------------------------------------
# PEX anti-slander, podscope, the engine's shun
# ---------------------------------------------------------------------

def _gossiper(verdicts, host_id="g1", port=1111, tasks=()):
    class _Storage:
        def tasks(self):
            return list(tasks)

    return PexGossiper(
        storage_mgr=_Storage(),
        host_info=lambda: Host(id=host_id, ip="127.0.0.1", port=port,
                               download_port=port),
        verdicts=verdicts)


def test_digest_carries_local_suspects_and_receiver_only_hints():
    va = port_verdicts.VerdictLedger(clock=FakeClock())
    va.record("10.9.9.9:7000", "corrupt")
    va.record("10.9.9.9:7000", "corrupt")
    ga = _gossiper(va, "a", 1111)
    assert ga.build_digest()["suspects"] == ["10.9.9.9:7000"]
    vb = port_verdicts.VerdictLedger(clock=FakeClock())
    gb = _gossiper(vb, "b", 2222)
    assert gb.ingest(ga.envelope())
    assert vb.deprioritized("10.9.9.9:7000")
    assert not vb.shunned("10.9.9.9:7000")


def test_repeated_slander_rounds_never_escalate():
    va = port_verdicts.VerdictLedger(clock=FakeClock())
    va.record("10.9.9.9:7000", "corrupt")
    va.record("10.9.9.9:7000", "corrupt")
    ga = _gossiper(va, "a", 1111)
    vb = port_verdicts.VerdictLedger(clock=FakeClock())
    gb = _gossiper(vb, "b", 2222)
    for _ in range(25):
        assert gb.ingest(ga.envelope())
    assert not vb.shunned("10.9.9.9:7000")
    assert vb.deprioritized("10.9.9.9:7000")


class _Md:
    def __init__(self, task_id, done):
        self.task_id = task_id
        self.pieces = {0: object()}
        self.total_piece_count = 1 if done else 2
        self.content_length = 4 if done else 8
        self.piece_size = 4
        self.done = done
        self.success = done


class _Ts:
    def __init__(self, md):
        self.md = md


def test_shunned_origin_claims_dropped_from_swarm_index():
    poisoner = PexGossiper(
        storage_mgr=type("S", (), {"tasks": lambda self: [
            _Ts(_Md("t" + "1" * 63, False))]})(),
        host_info=lambda: Host(id="poison", ip="10.0.0.9", port=9,
                               download_port=9999))
    vb = port_verdicts.VerdictLedger(clock=FakeClock())
    gb = _gossiper(vb, "b", 2222)
    assert gb.ingest(poisoner.envelope())
    assert gb.index.tasks()
    vb.record("10.0.0.9:9999", "corrupt")
    vb.record("10.0.0.9:9999", "corrupt")
    assert gb.ingest(poisoner.envelope())
    assert not gb.index.tasks()


def test_self_quarantined_daemon_advertises_no_tasks():
    v = port_verdicts.VerdictLedger(clock=FakeClock())
    g = _gossiper(v, "s", 1234, tasks=[_Ts(_Md("t" + "2" * 63, True))])
    assert g.build_digest()["tasks"]
    v.self_quarantine("rot")
    digest = g.build_digest()
    assert digest["tasks"] == []
    assert digest["origin"]["selfq"] is True


def _snap(addr, *, shunned=(), swarm_holders=(), selfq=False):
    return {
        "addr": addr, "flights": {}, "flight_index": {}, "health": None,
        "pex": {"swarm": {"tasks": {
            "t1": [{"addr": a} for a in swarm_holders]}}},
        "verdicts": {
            "self_quarantined": selfq,
            "parents": {a: {"shunned": True, "codes": {"corrupt": 2}}
                        for a in shunned}},
    }


def test_poisoner_still_offered_is_a_breach():
    report = podscope.aggregate([
        _snap("d1:1", shunned=["10.0.0.9:9999"]),
        _snap("d2:1", swarm_holders=["10.0.0.9:9999"])])
    assert report["quarantine"]["shunned"] == {"10.0.0.9:9999": ["d1:1"]}
    assert report["quarantine"]["still_offered"] == {
        "10.0.0.9:9999": ["d2:1"]}
    assert any(b.startswith("poisoner_offered") for b in report["breaches"])


def test_shunned_everywhere_is_no_breach_and_selfq_is_named():
    report = podscope.aggregate([_snap("d1:1", shunned=["10.0.0.9:9999"]),
                                 _snap("d2:1")])
    assert not any(b.startswith("poisoner_offered")
                   for b in report["breaches"])
    report = podscope.aggregate([_snap("d1:1", selfq=True)])
    assert report["quarantine"]["self_quarantined"] == ["d1:1"]
    assert "SELF-QUARANTINED" in report["verdict"]


def test_note_corrupt_flip_journals_and_gates_admission():
    class _Conductor:
        flight = TaskFlight("t" * 64, "p" * 16)

    v = port_verdicts.VerdictLedger(clock=FakeClock())
    eng = PieceEngine(verdicts=v)
    c = _Conductor()
    info = PieceInfo(piece_num=0, range_size=4096)
    assert not eng._note_corrupt(c, info, "bad-peer", addr="9.9.9.9:1")
    assert eng._note_corrupt(c, info, "bad-peer", addr="9.9.9.9:1")
    kinds = [e[1] for e in c.flight.events]
    assert kinds.count(fr.CORRUPT) == 2
    assert kinds.count(fr.QUARANTINE) == 1
    summary = c.flight.summarize()
    assert summary["quarantined_parents"] == ["9.9.9.9:1"]
    assert summary["fail_codes"]["corrupt"] == 2
    assert not eng._admissible("bad-peer", "9.9.9.9:1")
    assert eng._admissible("good-peer", "8.8.8.8:1")
    eng._note_fail(c, info, "slow-peer", "8.8.8.8:1", "stall")
    assert v.snapshot()["parents"]["8.8.8.8:1"]["codes"] == {"stall": 1.0}


def test_relayed_corruption_never_flips_the_engine_gate():
    class _Conductor:
        flight = None

    v = port_verdicts.VerdictLedger(clock=FakeClock())
    eng = PieceEngine(verdicts=v)
    info = PieceInfo(piece_num=0, range_size=4096)
    for _ in range(20):
        assert not eng._note_corrupt(_Conductor(), info, "relay-peer",
                                     addr="7.7.7.7:1", relayed=True)
    assert not v.shunned("7.7.7.7:1")
    assert eng._admissible("relay-peer", "7.7.7.7:1")


# ---------------------------------------------------------------------
# a daemon's verdict surfaces
# ---------------------------------------------------------------------

def _cfg(tmp_path, name, sched_addr=None, **kw) -> DaemonConfig:
    c = DaemonConfig(
        workdir=str(tmp_path / name), hostname=name, listen_ip="127.0.0.1",
        host_ip="127.0.0.1", device="cpu",
        storage=StorageSection(gc_interval_s=3600),
        scheduler=DaemonSched(addresses=[sched_addr] if sched_addr else []),
        **kw)
    c.probe_enabled = False
    return c


def test_daemon_serves_verdicts_and_flags_its_self_quarantine(tmp_path):
    async def go():
        d = Daemon(_cfg(tmp_path, "v1"))
        await d.start()
        try:
            port = d.upload_server.port
            for _ in range(3):        # decay on the real clock: 3 > 2
                d.verdicts.record("10.1.1.1:80", "corrupt")
            body = await asyncio.to_thread(lambda: json.loads(
                urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/debug/verdicts",
                    timeout=10).read()))
            assert body == json.loads(json.dumps(d.verdicts.snapshot()))
            assert body["parents"]["10.1.1.1:80"]["shunned"] is True
            assert d.host_info().quarantined is False
            # the castore's rot hook self-quarantines, as the reference's
            d.storage_mgr.castore.on_rot("f" * 64)
            assert d.verdicts.self_quarantined
            assert d.host_info().quarantined is True
            assert Announcer(d)._held_content() == []
        finally:
            await d.stop()
    asyncio.run(asyncio.wait_for(go(), 30.0))


# ---------------------------------------------------------------------
# the reference's byzantine swarm e2e, on the port
# ---------------------------------------------------------------------

async def _pull(d: Daemon, url: str, out: str, data: bytes | None = None):
    """A pull to ``out``; with ``data``, also into a device sink on the
    CPU, whose bytes must be ``data``."""
    result = None
    async for resp in d.ptm.start_file_task(DownloadRequest(
            url=url, output=out, disable_back_source=True, timeout_s=60.0,
            device_sink=DeviceSink(enabled=data is not None))):
        if resp.done:
            result = resp
    if data is not None and result is not None:
        ingest = d.ptm.conductor(result.task_id).device_ingest
        tensors = await asyncio.to_thread(ingest.result, 30.0)
        assert all(t.device.type == "cpu" for t in tensors)
        got = b"".join(t.reshape(-1).view(torch.uint8).numpy().tobytes()
                       for t in tensors)
        assert got[:len(data)] == data
    return result


def test_poisoned_swarm_quarantines_completes_and_reprieves(tmp_path):
    from dragonfly2_tpu_torch.scheduler.quarantine import (HEALTHY,
                                                           PROBATION,
                                                           QUARANTINED)
    data = os.urandom(26 * 1024 * 1024 + 321)

    async def go(url):
        seed = Daemon(_cfg(tmp_path, "seed", is_seed=True))
        await seed.start()
        sched = Scheduler(SchedulerConfig(
            listen_ip="127.0.0.1",
            quarantine_corrupt_threshold=3.0,
            quarantine_probation_delay_s=1.0,
            quarantine_probe_successes=1,
            seed_peers=[SeedPeerAddr(
                host_id=seed.host_info().id, ip="127.0.0.1",
                rpc_port=seed.rpc.port,
                download_port=seed.upload_server.port)]))
        await sched.start()
        poison = Daemon(_cfg(tmp_path, "poison", sched.address))
        await poison.start()
        leechers = []
        seed_stopped = False
        try:
            r = await _pull(poison, url, str(tmp_path / "poison.out"))
            assert r is not None
            assert (tmp_path / "poison.out").read_bytes() == data
            poison_host = "poison-127.0.0.1"
            assert poison.upload_server.host_id == poison_host
            # every range this one daemon serves gets a flipped byte (the
            # port's syntax has no pct: n=-1 fires on every serve)
            faultgate.arm_script(f"upload.serve@{poison_host}=corrupt:n=-1")
            for i in range(1, 7):
                d = Daemon(_cfg(tmp_path, f"l{i}", sched.address))
                await d.start()
                leechers.append(d)
            outs = [str(tmp_path / f"l{i}.out") for i in range(1, 7)]
            results = await asyncio.gather(
                *(_pull(d, url, out, data) for d, out in zip(leechers, outs)))
            assert all(r is not None for r in results)
            for out in outs:
                assert open(out, "rb").read() == data

            reg = sched.quarantine
            assert reg.state(poison_host) in (QUARANTINED, PROBATION)
            snap = reg.snapshot()["hosts"][poison_host]
            assert snap["corrupt_evidence"] <= 6 * 6.0, snap
            tid = results[0].task_id
            fail_codes = []
            for d in leechers:
                flight = d.flight_recorder.get(tid)
                if flight is None:
                    continue
                s = flight.summarize()
                assert sum((s.get("corrupt_pieces") or {}).values()) <= 12
                fail_codes.append((s.get("fail_codes") or {}).get("corrupt"))
            assert any(fail_codes)
            paddr = f"127.0.0.1:{poison.upload_server.port}"
            for d in leechers:
                if d.verdicts.shunned(paddr):
                    assert paddr in (d.flight_recorder.get(tid).summarize()
                                     .get("quarantined_parents") or [])
            honest = {f"127.0.0.1:{d.upload_server.port}"
                      for d in leechers + [seed]}
            for d in leechers:
                for a in honest:
                    assert not d.verdicts.shunned(a), (d.hostname, a)
            rows = [r for r in sched.ledger.snapshot(limit=512)["decisions"]
                    if r.get("decision_kind") == "quarantine"]
            assert any(r["to_state"] == "quarantined" for r in rows)
            assert all(r["host_id"] == poison_host for r in rows
                       if r["to_state"] == "quarantined"), rows
            for d in [seed] + leechers:
                assert reg.state(f"{d.hostname}-127.0.0.1") in (
                    "healthy", "suspect")

            # disarm, ride out probation, and let a fresh child's clean
            # probe pieces reprieve the host
            faultgate.reset()
            await asyncio.sleep(1.1)
            assert reg.state(poison_host) == PROBATION
            for d in leechers:
                await d.stop()
            leechers.clear()
            await seed.stop()
            seed_stopped = True
            l7 = Daemon(_cfg(tmp_path, "l7", sched.address))
            await l7.start()
            leechers.append(l7)
            r7 = await _pull(l7, url, str(tmp_path / "l7.out"))
            assert r7 is not None
            assert (tmp_path / "l7.out").read_bytes() == data
            for _ in range(100):
                if reg.state(poison_host) == HEALTHY:
                    break
                await asyncio.sleep(0.05)
            assert reg.state(poison_host) == HEALTHY, reg.snapshot()
            rows = [r for r in sched.ledger.snapshot(limit=512)["decisions"]
                    if r.get("decision_kind") == "quarantine"]
            assert [r["to_state"] for r in rows][-2:] \
                == ["probation", "healthy"]
        finally:
            for d in leechers:
                await d.stop()
            await poison.stop()
            await sched.stop()
            if not seed_stopped:
                await seed.stop()

    with Origin({"m.bin": data}) as origin:
        asyncio.run(asyncio.wait_for(go(f"{origin.base}/m.bin"),
                                     E2E_LIMIT_S))


def test_host_messages_carry_the_self_flag_as_the_reference():
    for flag in (False, True):
        h = Host(id="x", ip="1.2.3.4", type=HostType.NORMAL,
                 quarantined=flag)
        r = ref_msg.Host(id="x", ip="1.2.3.4", type=ref_msg.HostType.NORMAL,
                         quarantined=flag)
        raw = ref_base.dumps(r)
        assert port_base.dumps(h) == raw
        assert port_base.loads(raw).quarantined is flag
