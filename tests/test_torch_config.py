"""Reference config files load in the port, and every key has a class.

Each service config (daemon, scheduler, trainer) takes every key of the
reference's, with the reference's default, and its module's
``KEY_CLASSES`` table puts each key in one class:

* ``wired``: the key loads and reaches its subsystem. Each key set to a
  non-default value loads with that value, and the port reads the field
  outside its config module. The keys this slice wired are driven here:
  the daemon's upload throttles, piece knobs, back-source rate and
  prefetch switch; the scheduler's cluster id (into the manager
  registration, the trainer upload and the model lookup), parent and
  back-source limits, TTLs and GC cadence; the trainer's ``min_rows``.
* ``inert``: the reference declares the key and reads it nowhere (no
  reader in ``dragonfly2_tpu/`` outside its config module); the port reads
  it nowhere either. It loads.
* ``unported``: the key loads; a non-default value is named by
  ``unported()`` and refused when the daemon or scheduler is built and by
  the launchers, naming the ROADMAP item.

Also pinned here: entry 40, a fit's ``devices`` meta counts the visible
cards, whatever the mesh.
"""

import asyncio
import dataclasses
import os
import re
import time
import typing

import pytest
import torch

from dragonfly2_tpu.common import config as ref_config
from dragonfly2_tpu.daemon.config import DaemonConfig as RefDaemonConfig
from dragonfly2_tpu.scheduler.config import SchedulerConfig as RefSchedConfig
from dragonfly2_tpu.trainer.server import TrainerConfig as RefTrainerConfig
import dragonfly2_tpu_torch
from dragonfly2_tpu_torch.common.config import (ConfigError, from_dict,
                                                key_value, load_config)
from dragonfly2_tpu_torch.daemon import config as daemon_config
from dragonfly2_tpu_torch.daemon.config import DaemonConfig
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.manager.server import Manager, ManagerConfig
from dragonfly2_tpu_torch.scheduler import config as sched_config
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig
from dragonfly2_tpu_torch.scheduler.server import Scheduler
from dragonfly2_tpu_torch.tools import daemon as daemon_tool
from dragonfly2_tpu_torch.tools import scheduler as sched_tool
from dragonfly2_tpu_torch.trainer import ranks, training
from dragonfly2_tpu_torch.trainer import server as trainer_server
from dragonfly2_tpu_torch.trainer.server import Trainer, TrainerConfig
from test_torch_mesh_fit import FITS
from test_torch_ml_loop import _simulate_fanout

REF_ROOT = os.path.dirname(ref_config.__file__).rsplit(os.sep, 1)[0]
PORT_ROOT = os.path.dirname(dragonfly2_tpu_torch.__file__)
CLASSES = {
    "daemon": (DaemonConfig, RefDaemonConfig, daemon_config.KEY_CLASSES,
               "daemon/config.py"),
    "scheduler": (SchedulerConfig, RefSchedConfig, sched_config.KEY_CLASSES,
                  "scheduler/config.py"),
    "trainer": (TrainerConfig, RefTrainerConfig,
                trainer_server.KEY_CLASSES, "trainer/server.py"),
}
# values that must be one of a few words
CHOICES = {"security.tls_policy": "prefer",
           "download.traffic_shaper_kind": "plain",
           "algorithm": "nt", "device": "cpu"}


def key_paths(cls: type, prefix: str = "") -> list[str]:
    """Every leaf key of a config dataclass, as dotted paths."""
    out: list[str] = []
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        ftype = hints.get(f.name, f.type)
        if dataclasses.is_dataclass(ftype):
            out += key_paths(ftype, f"{prefix}{f.name}.")
        else:
            out.append(prefix + f.name)
    return out


def _keys():
    for svc, (_, ref_cls, table, _) in CLASSES.items():
        for key in key_paths(ref_cls):
            yield svc, key, table[key]


KEYS = list(_keys())


def _nested(key: str, value) -> dict:
    out: dict = value
    for part in reversed(key.split(".")):
        out = {part: out}
    return out


def _other(key: str, default):
    """A value of the key's type other than its default."""
    if key in CHOICES:
        return CHOICES[key]
    if key == "seed_peers":
        return [{"host_id": "s-10.0.0.9", "ip": "10.0.0.9", "rpc_port": 1}]
    if isinstance(default, bool):
        return not default
    if isinstance(default, int):
        return default + 7
    if isinstance(default, float):
        return default + 1.5
    if isinstance(default, str):
        return default + "x"
    if isinstance(default, list):
        return ["10.0.0.9:65001"]
    if isinstance(default, dict):
        return {"bulk": 1} if key == "class_fanout_caps" else \
            {"b": {"kind": "file"}} if key.endswith("backends") else {"b": "x"}
    raise AssertionError(f"no other value for {key}: {default!r}")


def _readers(root: str, name: str, skip: tuple) -> list[str]:
    """Files under ``root`` that read ``.name`` (or pass ``name=``),
    config modules apart."""
    pat = re.compile(rf"\.{name}\b|\b{name}=")
    out = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, root)
            if not f.endswith(".py") or rel in skip:
                continue
            with open(path, encoding="utf-8") as fh:
                if pat.search(fh.read()):
                    out.append(rel)
    return out


# ---------------------------------------------------------------- tables

@pytest.mark.parametrize("svc", sorted(CLASSES))
def test_every_reference_key_is_in_exactly_one_class(svc):
    port_cls, ref_cls, table, _ = CLASSES[svc]
    assert list(table) == key_paths(port_cls)
    assert set(key_paths(ref_cls)) <= set(table)
    # the port's own: where the daemon's sink lands, where fits run
    assert set(table) - set(key_paths(ref_cls)) == (
        set() if svc == "scheduler" else {"device"})
    for key, cls in table.items():
        assert cls in ("wired", "inert") or re.fullmatch(
            r"unported:(4b|5a|5b|5c|5d|6)", cls), (key, cls)


@pytest.mark.parametrize("svc", sorted(CLASSES))
def test_every_shared_key_keeps_the_reference_default(svc):
    port_cls, ref_cls, _, _ = CLASSES[svc]
    port, ref = port_cls(), ref_cls()
    for key in key_paths(ref_cls):
        got = key_value(port, key)
        want = key_value(ref, key)
        if dataclasses.is_dataclass(want):
            want = dataclasses.asdict(want)
        assert got == want, key


@pytest.mark.parametrize("svc,key,cls", KEYS,
                         ids=[f"{s}:{k}" for s, k, _ in KEYS])
def test_a_non_default_value_loads_and_is_classed(svc, key, cls):
    port_cls, ref_cls, _, cfg_file = CLASSES[svc]
    value = _other(key, key_value(ref_cls(), key))
    data = _nested(key, value)
    ref_config.from_dict(ref_cls, data)          # the reference loads it
    cfg = from_dict(port_cls, data)              # so does the port
    got = key_value(cfg, key)
    if key == "seed_peers":
        got = [dataclasses.asdict(p) for p in got]
        value = [dict(value[0], download_port=0)]
    assert got == value
    name = key.rsplit(".", 1)[-1]
    unported = getattr(cfg, "unported", lambda: [])()
    if cls == "wired":
        assert unported == []
        assert _readers(PORT_ROOT, name, (cfg_file,)), \
            f"{key}: no reader in the port"
    elif cls == "inert":
        assert unported == []
        assert _readers(REF_ROOT, name, (cfg_file,)) == []
        assert _readers(PORT_ROOT, name, (cfg_file,)) == []
    else:
        assert unported == [key]


UNPORTED = [(s, k, c.split(":")[1]) for s, k, c in KEYS
            if c.startswith("unported:")]


@pytest.mark.parametrize("svc,key,item", UNPORTED,
                         ids=[f"{s}:{k}" for s, k, _ in UNPORTED])
def test_an_unported_key_is_refused_at_start_by_name(tmp_path, svc, key,
                                                     item):
    port_cls, ref_cls, _, _ = CLASSES[svc]
    data = _nested(key, _other(key, key_value(ref_cls(), key)))
    if svc == "daemon":
        data.update(workdir=str(tmp_path), device="cpu")
        build = Daemon
    else:
        build = Scheduler
    cfg = from_dict(port_cls, data)
    with pytest.raises(ConfigError) as err:
        build(cfg)
    assert f"{key} (ROADMAP Queue 1 item {item})" in str(err.value)
    assert not os.listdir(tmp_path) or svc != "daemon"


FIVE_AC = [k for k in sched_config.KEY_CLASSES
           if k.startswith(("quarantine_", "federation_", "statestore_"))]


@pytest.mark.parametrize("key", FIVE_AC)
def test_quarantine_federation_and_state_store_keys_are_wired(tmp_path,
                                                              key):
    """Items 5a and 5c: each key is wired, keeps the reference's default,
    and a non-default value builds a scheduler that carries it."""
    assert sched_config.KEY_CLASSES[key] == "wired"
    assert getattr(SchedulerConfig(), key) == getattr(RefSchedConfig(), key)
    value = _other(key, key_value(RefSchedConfig(), key))
    if key == "statestore_dir":
        value = str(tmp_path / "state")
    data = {key: value}
    if key.startswith("federation_"):
        data["federation_enabled"] = True
    if key.startswith("statestore_") and key != "statestore_dir":
        data["statestore_dir"] = str(tmp_path / "state")
    cfg = from_dict(SchedulerConfig, data)
    assert cfg.unported() == []
    sched = Scheduler(cfg)
    got = {
        "quarantine_enabled": sched.quarantine is not None,
        "quarantine_corrupt_threshold": getattr(
            sched.quarantine, "corrupt_threshold", None),
        "quarantine_halflife_s": getattr(sched.quarantine, "halflife_s",
                                         None),
        "quarantine_probation_delay_s": getattr(
            sched.quarantine, "probation_delay_s", None),
        "quarantine_probe_successes": getattr(
            sched.quarantine, "probe_successes", None),
        "quarantine_probe_children": getattr(
            sched.quarantine, "probe_children", None),
        "quarantine_min_reporters": getattr(sched.quarantine,
                                            "min_reporters", None),
        "federation_enabled": sched.federation is not None,
        "federation_seeds_per_pod": getattr(sched.federation,
                                            "seeds_per_pod", None),
        "statestore_dir": getattr(sched.statestore, "dir", None),
        "statestore_interval_s": getattr(sched.statestore, "interval_s",
                                         None),
        "statestore_handoff": sched.cfg.statestore_handoff,
    }[key]
    assert got == value


FIVE_B = ([("daemon", k) for k in daemon_config.KEY_CLASSES
           if k.startswith("qos.") or k in ("download.traffic_shaper_kind",
                                            "upload.bulk_concurrent_limit")]
          + [("scheduler", k) for k in ("class_fanout_caps",
                                        "qos_preemption")])


@pytest.mark.parametrize("svc,key", FIVE_B,
                         ids=[f"{s}:{k}" for s, k in FIVE_B])
def test_qos_keys_are_wired(tmp_path, svc, key):
    """Item 5b: each QoS key is wired, keeps the reference's default, and
    a non-default value builds a daemon or scheduler that carries it to
    its subsystem."""
    port_cls, ref_cls, table, _ = CLASSES[svc]
    assert table[key] == "wired"
    assert key_value(port_cls(), key) == key_value(ref_cls(), key)
    value = _other(key, key_value(ref_cls(), key))
    data = _nested(key, value)
    if svc == "scheduler":
        cfg = from_dict(SchedulerConfig, data)
        assert cfg.unported() == []
        sched = Scheduler(cfg)
        got = {"class_fanout_caps": sched.scheduling.class_fanout_caps,
               "qos_preemption": sched.scheduling.qos_preemption}[key]
        assert got == value
        return
    data.update(workdir=str(tmp_path), device="cpu")
    cfg = from_dict(DaemonConfig, data)
    assert cfg.unported() == []
    d = Daemon(cfg)
    if key == "download.traffic_shaper_kind":
        got = d.shaper.kind
    elif key == "upload.bulk_concurrent_limit":
        got = d.upload_server.bulk_limit
    else:
        got = getattr(d.qos.cfg, key.split(".", 1)[1])
    assert got == value
    assert d.qos.shaper is d.shaper


def test_default_scheduler_arms_the_quarantine_registry_as_the_reference():
    from dragonfly2_tpu.scheduler.server import Scheduler as RefScheduler
    port, ref = Scheduler(SchedulerConfig()), RefScheduler(RefSchedConfig())
    assert port.quarantine is not None and ref.quarantine is not None
    for attr in ("corrupt_threshold", "halflife_s", "probation_delay_s",
                 "probe_successes", "probe_children", "min_reporters"):
        assert getattr(port.quarantine, attr) == getattr(ref.quarantine,
                                                         attr), attr
    assert port.scheduling.quarantine is port.quarantine
    assert port.seed_client.quarantine is port.quarantine
    assert port.service.quarantine is port.quarantine
    assert port.fleetpulse.quarantine is port.quarantine
    assert port.service.cluster.quarantine is port.quarantine
    assert (port.federation, port.statestore) == (None, None)
    assert (ref.federation, ref.statestore) == (None, None)


def test_reference_yaml_files_load(tmp_path):
    d = tmp_path / "daemon.yaml"
    d.write_text("upload:\n  rate_limit_bps: 1000000\n"
                 "download:\n  piece_parallelism: 8\n"
                 "  first_piece_timeout_s: 10\n"
                 "scheduler:\n  max_reschedule: 3\n"
                 "metrics_port: 9100\n")
    cfg = load_config(DaemonConfig, str(d))
    assert cfg.upload.rate_limit_bps == 1_000_000
    assert cfg.download.piece_parallelism == 8 and cfg.unported() == []
    s = tmp_path / "scheduler.yaml"
    s.write_text("peer_ttl_s: 600\ncluster_id: 2\nretry_limit: 9\n")
    cfg = load_config(SchedulerConfig, str(s))
    assert (cfg.peer_ttl_s, cfg.cluster_id) == (600.0, 2)
    assert cfg.unported() == []
    t = tmp_path / "trainer.yaml"
    t.write_text("min_rows: 64\n")
    assert load_config(TrainerConfig, str(t)).min_rows == 64


@pytest.mark.parametrize("tool,text,name", [
    # the qos keys (item 5b) are wired: only the proxy key is refused
    (daemon_tool, "proxy:\n  enabled: true\nqos:\n  queue_limit: 3\n",
     ["proxy.enabled (ROADMAP Queue 1 item 6)"]),
    # fleetpulse_enabled (item 4b) and the quarantine, federation and
    # state store keys (items 5a, 5c) are wired: only the plugin key is
    # refused
    (sched_tool, "quarantine_enabled: false\nfleetpulse_enabled: false\n"
     "federation_enabled: true\nstatestore_interval_s: 5\n"
     "plugin_dir: df-plugins\n",
     ["plugin_dir (ROADMAP Queue 1 item 5d)"])])
def test_launchers_refuse_unported_keys(tmp_path, capsys, tool, text, name):
    path = tmp_path / "c.yaml"
    path.write_text(text)
    with pytest.raises(SystemExit) as err:
        tool.main(["--config", str(path)])
    assert err.value.code == 2
    msg = capsys.readouterr().err
    for n in name:
        assert n in msg
    for wired in ("fleetpulse_enabled", "quarantine_enabled",
                  "federation_enabled", "statestore_interval_s",
                  "qos.queue_limit"):
        assert wired not in msg


# ---------------------------------------------------------------- daemon

def test_daemon_throttles_and_piece_knobs_reach_their_subsystems(tmp_path):
    cfg = from_dict(DaemonConfig, {
        "workdir": str(tmp_path), "device": "cpu",
        "upload": {"rate_limit_bps": 3_000_000, "concurrent_limit": 2},
        "download": {"piece_parallelism": 7, "piece_timeout_s": 12.5,
                     "total_rate_limit_bps": 5_000_000,
                     "prefetch_whole_file": True}})
    d = Daemon(cfg)

    async def main():
        await d.start()
        try:
            engine = d._engine()
            return (d.upload_server.limiter.rate,
                    d.upload_server.concurrent_limit,
                    d.host_info().concurrent_upload_limit,
                    engine.parallelism, engine.piece_timeout_s,
                    engine.downloader is d._downloader,
                    d._downloader.timeout_s,
                    d.piece_mgr.total_limiter.rate,
                    d.ptm.prefetch_whole_file)
        finally:
            await d.stop()
    assert asyncio.run(asyncio.wait_for(main(), 20)) == (
        3_000_000, 2, 2, 7, 12.5, True, 12.5, 5_000_000, True)


def test_engine_runs_its_configured_workers(monkeypatch):
    """``download.piece_parallelism`` is the number of piece workers a
    pull starts."""
    import types
    from dragonfly2_tpu_torch.daemon import piece_engine
    started = []

    async def worker(self, conductor, session):
        started.append(self)

    async def no_packets(self, conductor, session):
        return None

    monkeypatch.setattr(piece_engine.PieceEngine, "_worker", worker)
    monkeypatch.setattr(piece_engine.PieceEngine, "_consume_packets",
                        no_packets)
    conductor = types.SimpleNamespace(storage=None, shard_tracker=None,
                                      piece_size=0)
    session = types.SimpleNamespace(
        result=types.SimpleNamespace(content_length=-1))

    async def main(n):
        engine = piece_engine.PieceEngine(parallelism=n,
                                          schedule_timeout_s=0.05)
        # no parent shows up: the pull gives up after the schedule timeout
        return await engine._pull_normal(conductor, session)
    for n in (1, 3, 9):
        started.clear()
        assert asyncio.run(asyncio.wait_for(main(n), 5)) is False
        assert len(started) == n


def test_total_rate_limit_paces_the_back_source(tmp_path):
    """A 1.5 MB back-source pull at 0.5 MB/s (the bucket holds one second)
    takes about 2 s; unlimited it takes milliseconds."""
    data = os.urandom(1_500_000)
    src = tmp_path / "origin.bin"
    src.write_bytes(data)

    async def pull(rate: int) -> float:
        d = Daemon(from_dict(DaemonConfig, {
            "workdir": str(tmp_path / f"d{rate}"), "device": "cpu",
            "download": {"total_rate_limit_bps": rate}}))
        await d.start()
        from dragonfly2_tpu_torch.idl.messages import DownloadRequest
        try:
            t0 = time.monotonic()
            async for _ in d.ptm.start_file_task(DownloadRequest(
                    url=f"file://{src}", output=str(tmp_path / f"o{rate}"))):
                pass
            took = time.monotonic() - t0
        finally:
            await d.stop()
        assert (tmp_path / f"o{rate}").read_bytes() == data
        return took

    slow = asyncio.run(asyncio.wait_for(pull(500_000), 30))
    fast = asyncio.run(asyncio.wait_for(pull(0), 30))
    assert 1.8 <= slow < 10 and fast < 1.0


# ---------------------------------------------------------------- scheduler

def test_scheduler_limits_ttls_and_gc_cadence_are_wired():
    cfg = SchedulerConfig(listen_ip="127.0.0.1", candidate_parent_limit=3,
                          filter_parent_limit=6, back_source_concurrent=9,
                          back_source_total=11, retry_back_source_limit=2,
                          peer_ttl_s=1.0, task_ttl_s=2.0, host_ttl_s=0.01,
                          gc_interval_s=0.05)
    sched = Scheduler(cfg)
    assert (sched.scheduling.candidate_parent_limit,
            sched.scheduling.filter_parent_limit) == (3, 6)
    assert sched.service.cfg is cfg
    assert (sched.resource.peer_ttl_s, sched.resource.task_ttl_s,
            sched.resource.host_ttl_s) == (1.0, 2.0, 0.01)

    async def main():
        from dragonfly2_tpu_torch.idl.messages import Host
        await sched.start()
        try:
            sched.resource.store_host(Host(id="h1", ip="10.0.0.1",
                                           hostname="h1"))
            assert "h1" in sched.resource.hosts
            await asyncio.sleep(0.5)       # several 0.05 s GC ticks
            return "h1" in sched.resource.hosts
        finally:
            await sched.stop()
    assert asyncio.run(asyncio.wait_for(main(), 10)) is False


def test_cluster_id_reaches_registration_upload_and_model_lookup(tmp_path):
    """A scheduler of cluster 2 registers and keeps alive in cluster 2,
    its records upload carries cluster 2, so the trainer publishes the
    fitted model to cluster 2, where the scheduler's lookup finds it."""
    async def main():
        mgr = Manager(ManagerConfig(listen_ip="127.0.0.1",
                                    db_path=str(tmp_path / "m.db")))
        await mgr.start()
        trainer = Trainer(TrainerConfig(
            listen_ip="127.0.0.1", data_dir=str(tmp_path / "spool"),
            device="cpu", manager_addresses=[mgr.address]))
        await trainer.start()
        sched = Scheduler(from_dict(SchedulerConfig, {
            "listen_ip": "127.0.0.1", "cluster_id": 2, "algorithm": "ml",
            "manager_addresses": [mgr.address],
            "trainer_address": f"127.0.0.1:{trainer.port}",
            "records_dir": str(tmp_path / "records")}))
        await sched.start()
        try:
            registered = [(s.port, s.scheduler_cluster_id)
                          for s in mgr.store.schedulers()]
            _simulate_fanout(sched)
            assert await sched.announcer.upload_once()
            models = [(m["name"], m["scheduler_cluster_id"])
                      for m in mgr.store.models()]
            found = await sched.announcer.refresh_model_once()
            return registered, sched.port, models, found
        finally:
            await sched.stop()
            await trainer.stop()
            await mgr.stop()
    registered, port, models, found = asyncio.run(
        asyncio.wait_for(main(), 120))
    assert registered == [(port, 2)]
    assert models and {c for _, c in models} == {2}
    assert found


@pytest.mark.parametrize("min_rows,fitted", [(32, False), (8, True)])
def test_trainer_min_rows_is_the_fit_floor(tmp_path, min_rows, fitted):
    from test_torch_mesh_fit import _mlp_rows, _upload
    cfg = from_dict(TrainerConfig, {"data_dir": str(tmp_path),
                                    "listen_ip": "127.0.0.1",
                                    "device": "cpu", "min_rows": min_rows})
    trainer = Trainer(cfg)

    async def main():
        await trainer.start()
        try:
            async def uploads():
                yield _upload("download", _mlp_rows(4, 20))
            return await trainer.service.train(uploads(), None)
        finally:
            await trainer.stop()
    resp = asyncio.run(asyncio.wait_for(main(), 60))
    assert trainer.service.min_rows == min_rows
    assert bool(resp.model_version) is fitted


# ---------------------------------------------------------------- entry 40

def _fit_visible(monkeypatch, cards: int) -> list:
    """``cards`` visible cards; fits resolve to the CPU and a mesh fit
    runs the single-device loop there, its world recorded."""
    worlds = []

    def on_cpu(kind, world, device_type, data, **kw):
        worlds.append(world)
        fit = training._fit_mlp if kind == "mlp" else training._fit_gnn
        data = data if kind == "mlp" else training.graph_batch(
            data, torch.device("cpu"))
        with training.fit_numerics():
            model, first, last = fit(data, dev=torch.device("cpu"), **kw)
        return training.models.params_to_numpy(model), first, last

    monkeypatch.setattr(ranks, "visible_cards", lambda: cards)
    monkeypatch.setattr(training, "resolve_device",
                        lambda device: torch.device("cpu"))
    monkeypatch.setattr(training, "fit_on_mesh", on_cpu)
    return worlds


@pytest.mark.parametrize("name", ["mlp", "gnn"])
@pytest.mark.parametrize("cards,use_mesh,world", [(5, True, 4),
                                                  (2, False, None)])
def test_fit_devices_meta_counts_the_visible_cards(monkeypatch, name, cards,
                                                   use_mesh, world):
    from dragonfly2_tpu_torch.trainer import params_io
    worlds = _fit_visible(monkeypatch, cards)
    fit, rows, kw = FITS[name]
    blob, metrics = fit(rows(), use_mesh=use_mesh, **kw)
    assert worlds == ([world] if world else [])
    assert metrics["devices"] == cards
    assert params_io.deserialize_params(blob)[1]["devices"] == cards


@pytest.mark.parametrize("name", ["mlp", "gnn"])
def test_a_one_card_fit_keeps_its_blob(monkeypatch, name):
    """One visible card: ``devices`` stays 1 and the blob is the
    single-device fit's, byte for byte."""
    fit, rows, kw = FITS[name]
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want, _ = fit(rows(), device="cpu", **kw)
        _fit_visible(monkeypatch, 1)
        got, metrics = fit(rows(), **kw)
    finally:
        torch.set_num_threads(before)
    assert metrics["devices"] == 1 and got == want
