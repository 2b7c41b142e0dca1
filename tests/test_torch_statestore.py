"""The scheduler's durable state on the port and against the reference
(``scheduler/statestore.py``).

* The reference's ``tests/test_statestore.py`` cases run through both
  packages (``pkg`` parameter): the persist idiom, torn snapshots refused
  whole for every component, quarantine decay across an outage, the
  ``sched.snapshot.io`` faultgate and the records' close ordering.
* Cross-package: a snapshot written by either package's store, with every
  component the scheduler registers, restores in the other, and the
  restored components equal the ones the writer's package restores.
* The port's scheduler: a snapshot is restored before its RPC server
  starts, with a ``recovery`` decision row and a strictly larger epoch;
  the GC runner's ticker persists a quarantine transition; a stop leaves
  the final snapshot; a snapshot of the reference's scheduler restores in
  the port's.
"""

import asyncio
import json
import os

import pytest

import dragonfly2_tpu.common.faultgate as ref_faultgate
import dragonfly2_tpu.idl.messages as ref_msg
import dragonfly2_tpu.scheduler.federation as ref_federation
import dragonfly2_tpu.scheduler.quarantine as ref_quarantine
import dragonfly2_tpu.scheduler.records as ref_records
import dragonfly2_tpu.scheduler.shard_affinity as ref_affinity
import dragonfly2_tpu.scheduler.statestore as ref_statestore
from dragonfly2_tpu.scheduler.config import SchedulerConfig as RefSchedCfg
from dragonfly2_tpu.scheduler.server import Scheduler as RefScheduler
import dragonfly2_tpu_torch.common.faultgate as port_faultgate
import dragonfly2_tpu_torch.idl.messages as port_msg
import dragonfly2_tpu_torch.scheduler.federation as port_federation
import dragonfly2_tpu_torch.scheduler.quarantine as port_quarantine
import dragonfly2_tpu_torch.scheduler.records as port_records
import dragonfly2_tpu_torch.scheduler.shard_affinity as port_affinity
import dragonfly2_tpu_torch.scheduler.statestore as port_statestore
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig
from dragonfly2_tpu_torch.scheduler.server import Scheduler


class Pkg:
    def __init__(self, store, quarantine, federation, affinity, msg,
                 faultgate, records):
        self.store, self.q, self.fed, self.aff = (store, quarantine,
                                                  federation, affinity)
        self.msg, self.fg, self.rec = msg, faultgate, records


PKGS = {
    "reference": Pkg(ref_statestore, ref_quarantine, ref_federation,
                     ref_affinity, ref_msg, ref_faultgate, ref_records),
    "port": Pkg(port_statestore, port_quarantine, port_federation,
                port_affinity, port_msg, port_faultgate, port_records),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    p = PKGS[request.param]
    p.fg.reset()
    yield p
    p.fg.reset()


class VClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def make_store(pkg, tmp_path, clock, **kw):
    return pkg.store.SchedulerStateStore(str(tmp_path / "state"),
                                         clock=clock, wall=clock, **kw)


def decision_row(i: int = 0) -> dict:
    return {"kind": "decision", "decision_kind": "find",
            "decision_id": f"d{i:08d}.x", "task_id": "t", "peer_id": "p",
            "candidates": [], "excluded": [], "chosen": []}


# ---------------------------------------------------------------------
# the persist idiom
# ---------------------------------------------------------------------

def test_save_load_round_trip(pkg, tmp_path):
    clock = VClock()
    store = make_store(pkg, tmp_path, clock)
    store.register("unit", lambda: {"n": 7}, lambda sub: sub["n"])
    assert store.save()
    reborn = make_store(pkg, tmp_path, clock)
    restored = {}
    reborn.register("unit", dict,
                    lambda sub: restored.update(sub) or len(sub))
    prov = reborn.restore()
    assert prov["recovered"] is True
    assert restored == {"n": 7}
    assert prov["components"]["unit"]["restored"] == 1


def test_dirty_and_periodic_cadence(pkg, tmp_path):
    clock = VClock()
    store = make_store(pkg, tmp_path, clock, interval_s=30.0)
    store.register("unit", lambda: {}, lambda sub: 0)
    store.save()
    assert not store.maybe_save()
    store.mark_dirty()
    assert store.maybe_save()
    clock.t += 31.0
    assert store.maybe_save()
    assert not store.maybe_save()


def test_wrap_sink_marks_dirty_and_forwards(pkg, tmp_path):
    store = make_store(pkg, tmp_path, VClock())
    seen = []
    store.wrap_sink(seen.append)({"kind": "decision"})
    assert seen and store.maybe_save()
    store.wrap_sink(None)({"kind": "decision"})


def test_version_skew_refused_wholesale(pkg, tmp_path):
    clock = VClock()
    store = make_store(pkg, tmp_path, clock)
    store.register("unit", lambda: {"n": 1}, lambda sub: 1)
    assert store.save()
    with open(store.path, "r+", encoding="utf-8") as f:
        body = json.load(f)
        body["v"] = pkg.store.SCHEMA_VERSION + 1
        f.seek(0)
        f.truncate()
        json.dump(body, f)
    reborn = make_store(pkg, tmp_path, clock)
    called = []
    reborn.register("unit", dict, lambda sub: called.append(sub) or 0)
    assert reborn.restore() == {"recovered": False}
    assert not called


def test_missing_component_and_failing_restore_skip_independently(
        pkg, tmp_path):
    clock = VClock()
    store = make_store(pkg, tmp_path, clock)
    store.register("good", lambda: {"n": 1}, lambda sub: 1)
    store.register("bad", lambda: {"n": 1}, lambda sub: 1)
    assert store.save()
    reborn = make_store(pkg, tmp_path, clock)
    reborn.register("good", dict, lambda sub: 1)

    def explode(sub):
        raise RuntimeError("component rot")

    reborn.register("bad", dict, explode)
    reborn.register("newer", dict, lambda sub: 1)
    prov = reborn.restore()
    comps = prov["components"]
    assert prov["recovered"] is True
    assert comps["good"]["restored"] == 1
    assert comps["bad"]["error"] and comps["bad"]["restored"] == 0
    assert comps["newer"] == {"restored": 0, "present": False}


COMPONENTS = ("quarantine", "federation", "shard_affinity", "tenants",
              "meta")


def full_snapshot(pkg, tmp_path, clock):
    """A store journaling every component the scheduler registers."""
    store = make_store(pkg, tmp_path, clock)
    quarantine = pkg.q.QuarantineRegistry(clock=clock, sink=None)
    quarantine.record_corrupt("badhost", task_id="t1", reporter="r1")
    for r in ("r1", "r2", "r3"):
        quarantine.record_corrupt("poisoner", task_id="t2", reporter=r)
    federation = pkg.fed.PodFederation()
    federation.observe_host("h1", pkg.msg.TopologyInfo(pod="podA"))
    federation.seeds_for("t1", "podA")
    sharded = pkg.aff.ShardAffinity()
    sharded.assign(task_id="t1", peer_id="p1", host_id="h1",
                   topology=None, requested=["s0", "s1"])
    tenants = {"tenants": {}, "applications": {"app": 3}}
    meta = {"epoch": 1700000000}
    store.register("quarantine", quarantine.export_state, quarantine.restore)
    store.register("federation", federation.export_state, federation.restore)
    store.register("shard_affinity", sharded.export_state, sharded.restore)
    store.register("tenants", lambda: tenants, lambda sub: len(sub))
    store.register("meta", lambda: meta, lambda sub: 1)
    assert store.save()
    return store


@pytest.mark.parametrize("keep", [0.25, 0.5, 0.9])
def test_truncated_snapshot_restores_nothing(pkg, tmp_path, keep):
    clock = VClock()
    store = full_snapshot(pkg, tmp_path, clock)
    raw = open(store.path, "rb").read()
    body = json.loads(raw)
    for name in COMPONENTS:
        assert name in body["components"]
    with open(store.path, "wb") as f:
        f.write(raw[:int(len(raw) * keep)])
    reborn = make_store(pkg, tmp_path, clock)
    applied = []
    for name in COMPONENTS:
        reborn.register(name, dict,
                        lambda sub, _n=name: applied.append(_n) or 0)
    assert reborn.load() is None
    assert reborn.restore() == {"recovered": False}
    assert applied == []


def _restore_all(pkg, tmp_path, clock) -> tuple[dict, dict]:
    """A fresh set of one package's components restored from the store's
    file; (provenance, the components' state)."""
    reborn = make_store(pkg, tmp_path, clock)
    quarantine = pkg.q.QuarantineRegistry(clock=clock)
    federation = pkg.fed.PodFederation()
    sharded = pkg.aff.ShardAffinity()
    tenants_in, meta_in = {}, {}
    reborn.register("quarantine", quarantine.export_state,
                    quarantine.restore)
    reborn.register("federation", federation.export_state,
                    federation.restore)
    reborn.register("shard_affinity", sharded.export_state,
                    sharded.restore)
    reborn.register("tenants", dict,
                    lambda sub: tenants_in.update(sub) or len(sub))
    reborn.register("meta", dict, lambda sub: meta_in.update(sub) or 1)
    prov = reborn.restore()
    state = {"quarantine": quarantine.snapshot(),
             "states": {h: quarantine.state(h)
                        for h in ("badhost", "poisoner")},
             "q_export": quarantine.export_state(),
             "federation": federation.describe(),
             "f_export": federation.export_state(),
             "affinity": sharded.export_state(),
             "tenants": tenants_in, "meta": meta_in}
    return prov, json.loads(json.dumps(state))


def test_intact_snapshot_reaches_every_component(pkg, tmp_path):
    clock = VClock()
    full_snapshot(pkg, tmp_path, clock)
    prov, state = _restore_all(pkg, tmp_path, clock)
    assert prov["recovered"] is True
    assert state["states"] == {"badhost": "suspect",
                               "poisoner": "quarantined"}
    assert state["federation"]["pods"] == {"podA": ["h1"]}
    assert prov["components"]["shard_affinity"]["restored"] == 1
    assert state["tenants"]["applications"] == {"app": 3}
    assert state["meta"]["epoch"] == 1700000000


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_a_snapshot_restores_in_the_other_package(tmp_path, writer,
                                                  reader):
    clock = VClock()
    full_snapshot(PKGS[writer], tmp_path, clock)
    clock.t += 42.0
    got = _restore_all(PKGS[reader], tmp_path, clock)
    want = _restore_all(PKGS[writer], tmp_path, clock)
    assert got == want
    assert got[0]["gap_s"] == 42.0


def test_both_packages_write_the_same_snapshot(tmp_path):
    clock = VClock()
    blobs = []
    for name in ("reference", "port"):
        store = full_snapshot(PKGS[name], tmp_path / name, clock)
        blobs.append(open(store.path, "rb").read())
    assert blobs[0] == blobs[1]


def test_store_survives_missing_file(pkg, tmp_path):
    reborn = make_store(pkg, tmp_path, VClock())
    reborn.register("unit", dict, lambda sub: 0)
    assert reborn.load() is None
    assert reborn.restore() == {"recovered": False}


# ---------------------------------------------------------------------
# quarantine decay across an outage
# ---------------------------------------------------------------------

def _ladder(pkg, tmp_path, clock):
    store = make_store(pkg, tmp_path, clock)
    reg = pkg.q.QuarantineRegistry(clock=clock, halflife_s=600.0)
    reg.record_corrupt("badhost", task_id="t1", reporter="r1")
    assert reg.state("badhost") == "suspect"
    store.register("quarantine", reg.export_state, reg.restore)
    assert store.save()


def _reload(pkg, tmp_path, clock):
    reborn = make_store(pkg, tmp_path, clock)
    reg = pkg.q.QuarantineRegistry(clock=clock, halflife_s=600.0)
    reborn.register("quarantine", reg.export_state, reg.restore)
    return reg, reborn.restore()


def test_reload_after_decay_horizon_is_healthy(pkg, tmp_path):
    clock = VClock()
    _ladder(pkg, tmp_path, clock)
    clock.t += 6000.0
    reg, prov = _reload(pkg, tmp_path, clock)
    assert reg.state("badhost") == "healthy"
    assert prov["components"]["quarantine"]["restored"] == 0
    assert prov["gap_s"] == pytest.approx(6000.0)


def test_reload_within_horizon_preserves_position(pkg, tmp_path):
    clock = VClock()
    _ladder(pkg, tmp_path, clock)
    clock.t += 300.0
    reg, prov = _reload(pkg, tmp_path, clock)
    assert reg.state("badhost") == "suspect"
    assert prov["components"]["quarantine"]["restored"] == 1
    h = reg._hosts["badhost"]
    assert h.corrupt == pytest.approx(0.5 ** 0.5, rel=1e-3)
    assert h.reporters == {"r1"}


def test_quarantined_probation_timer_restarts_at_recovery(pkg, tmp_path):
    clock = VClock()
    store = make_store(pkg, tmp_path, clock)
    kw = dict(clock=clock, halflife_s=3600.0, corrupt_threshold=2.0,
              min_reporters=2, probation_delay_s=30.0)
    reg = pkg.q.QuarantineRegistry(**kw)
    reg.record_corrupt("poisoner", reporter="r1")
    reg.record_corrupt("poisoner", reporter="r2")
    assert reg.state("poisoner") == "quarantined"
    store.register("quarantine", reg.export_state, reg.restore)
    assert store.save()
    clock.t += 120.0
    reborn = make_store(pkg, tmp_path, clock)
    reg2 = pkg.q.QuarantineRegistry(**kw)
    reborn.register("quarantine", reg2.export_state, reg2.restore)
    reborn.restore()
    assert reg2.state("poisoner") == "quarantined"
    assert not reg2.offerable("poisoner", "child")


# ---------------------------------------------------------------------
# the sched.snapshot.io faultgate
# ---------------------------------------------------------------------

def test_enospc_shaped_failure_never_raises_then_recovers(pkg, tmp_path):
    store = make_store(pkg, tmp_path, VClock())
    store.register("unit", lambda: {"n": 1}, lambda sub: 1)
    pkg.fg.arm_script("sched.snapshot.io=error:n=1")
    assert store.save() is False
    assert not os.path.exists(store.path)
    assert store.save() is True
    assert json.load(open(store.path))["components"]["unit"] == {"n": 1}


def test_failed_save_keeps_dirty_for_retry(pkg, tmp_path):
    store = make_store(pkg, tmp_path, VClock(), interval_s=3600.0)
    store.register("unit", lambda: {}, lambda sub: 0)
    store.mark_dirty()
    pkg.fg.arm_script("sched.snapshot.io=error:n=1")
    assert store.maybe_save() is False
    assert store.maybe_save() is True


def test_torn_write_is_refused_at_next_load(pkg, tmp_path):
    clock = VClock()
    store = make_store(pkg, tmp_path, clock)
    store.register("unit", lambda: {"n": 1}, lambda sub: 1)
    pkg.fg.arm_script("sched.snapshot.io=corrupt:n=1")
    assert store.save() is True
    reborn = make_store(pkg, tmp_path, clock)
    reborn.register("unit", dict, lambda sub: 1)
    assert reborn.load() is None
    assert reborn.restore() == {"recovered": False}


def test_old_snapshot_survives_failed_overwrite(pkg, tmp_path):
    clock = VClock()
    store = make_store(pkg, tmp_path, clock)
    value = {"n": 1}
    store.register("unit", lambda: dict(value), lambda sub: 1)
    assert store.save()
    value["n"] = 2
    pkg.fg.arm_script("sched.snapshot.io=error:n=1")
    assert store.save() is False
    body = make_store(pkg, tmp_path, clock).load()
    assert body["components"]["unit"] == {"n": 1}


# ---------------------------------------------------------------------
# the records' close ordering
# ---------------------------------------------------------------------

def test_close_with_dead_file_counts_once_and_returns(pkg, tmp_path):
    rec = pkg.rec.DownloadRecords(records_dir=str(tmp_path / "records"))
    rec.on_decision(decision_row())
    assert rec._pending
    before = pkg.rec._flush_failures.value()
    rec._file.close()
    rec.close()
    assert pkg.rec._flush_failures.value() == before + 1
    assert rec._pending == []
    assert rec._file is None


def test_clean_close_flushes_tail(pkg, tmp_path):
    rec = pkg.rec.DownloadRecords(records_dir=str(tmp_path / "records"))
    rec.on_decision(decision_row())
    before = pkg.rec._flush_failures.value()
    rec.close()
    assert pkg.rec._flush_failures.value() == before
    path = os.path.join(str(tmp_path / "records"), "download.jsonl")
    rows = [json.loads(line) for line in open(path, encoding="utf-8")]
    assert rows and rows[-1]["decision_kind"] == "find"


# ---------------------------------------------------------------------
# the port's scheduler with a state store
# ---------------------------------------------------------------------

def _sched_cfg(tmp_path, **kw) -> SchedulerConfig:
    return SchedulerConfig(listen_ip="127.0.0.1",
                           statestore_dir=str(tmp_path / "state"),
                           statestore_interval_s=0.1,
                           statestore_handoff=False, **kw)


def test_restart_restores_before_serving_with_a_recovery_row(tmp_path):
    async def go():
        s1 = Scheduler(_sched_cfg(tmp_path, federation_enabled=True))
        await s1.start()
        assert s1.statestore.provenance == {"recovered": False}
        # four verdicts: the real clock decays three below the threshold
        for r in ("r1", "r2", "r3", "r4"):
            s1.quarantine.record_corrupt("poisoner", reporter=r)
        s1.federation.observe_host("h1", port_msg.TopologyInfo(pod="pa"))
        s1.service.applications = {"app": 2}
        # the dirty mark rides the registry's sink: the ticker persists
        for _ in range(100):
            if os.path.exists(s1.statestore.path):
                break
            await asyncio.sleep(0.05)
        body = json.load(open(s1.statestore.path))
        assert body["components"]["quarantine"]["hosts"]["poisoner"][
            "state"] == "quarantined"
        epoch1 = s1.service.epoch
        await s1.stop()
        s2 = Scheduler(_sched_cfg(tmp_path, federation_enabled=True))
        await s2.start()
        try:
            prov = s2.statestore.provenance
            assert prov["recovered"] is True
            assert set(prov["components"]) == {
                "quarantine", "federation", "shard_affinity", "fleetpulse",
                "tenants", "meta"}
            assert s2.quarantine.state("poisoner") == "quarantined"
            assert s2.federation.pod_of_host("h1") == "pa"
            assert s2.service.applications == {"app": 2}
            assert s2.service.epoch > epoch1
            rows = [r for r in s2.ledger.snapshot(limit=64)["decisions"]
                    if r.get("decision_kind") == "recovery"]
            assert len(rows) == 1 and rows[0]["source"] == "snapshot"
            assert rows[0]["components"]["quarantine"] == 1
            assert rows[0]["scheduler_epoch"] == s2.service.epoch
        finally:
            await s2.stop()
    asyncio.run(asyncio.wait_for(go(), 30.0))


def test_a_reference_schedulers_snapshot_restores_in_the_port(tmp_path):
    async def go():
        ref = RefScheduler(RefSchedCfg(
            statestore_dir=str(tmp_path / "state"),
            statestore_handoff=False))
        for r in ("r1", "r2", "r3", "r4"):
            ref.quarantine.record_corrupt("poisoner", reporter=r)
        assert ref.statestore.save()
        port = Scheduler(_sched_cfg(tmp_path))
        await port.start()
        try:
            assert port.statestore.provenance["recovered"] is True
            assert port.quarantine.state("poisoner") == "quarantined"
            assert port.quarantine.export_state()["hosts"]["poisoner"][
                "reporters"] == ["r1", "r2", "r3", "r4"]
        finally:
            await port.stop()
    asyncio.run(asyncio.wait_for(go(), 30.0))
