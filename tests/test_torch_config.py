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
                                                key_value, load_config,
                                                unported)
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


# no daemon or scheduler key is unported since the fleet TLS keys were
# wired (item 6c); the refusal stays for keys a later reference change
# adds, and is driven here with a patched class
REFUSED = [("daemon", "security.enabled", "6"),
           ("scheduler", "security_ca_cert", "6")]


@pytest.mark.parametrize("svc,key,item", REFUSED,
                         ids=[f"{s}:{k}" for s, k, _ in REFUSED])
def test_an_unported_key_is_refused_at_start_by_name(tmp_path, monkeypatch,
                                                     svc, key, item):
    port_cls, ref_cls, table, _ = CLASSES[svc]
    assert not [k for k, c in table.items() if c.startswith("unported:")]
    monkeypatch.setitem(table, key, unported(item))
    data = _nested(key, _other(key, key_value(ref_cls(), key)))
    if svc == "daemon":
        data.update(workdir=str(tmp_path), device="cpu")
        build = Daemon
    else:
        build = Scheduler
    cfg = from_dict(port_cls, data)
    assert cfg.unported() == [key]
    with pytest.raises(ConfigError) as err:
        build(cfg)
    assert f"{key} (ROADMAP Queue 1 item {item})" in str(err.value)
    assert not os.listdir(tmp_path) or svc != "daemon"


SECURITY_KEYS = [("daemon", k) for k in daemon_config.KEY_CLASSES
                 if k.startswith("security.")] + \
    [("scheduler", k) for k in ("security_issue_token", "security_ca_cert",
                                "workdir")]


@pytest.mark.parametrize("svc,key", SECURITY_KEYS,
                         ids=[f"{s}:{k}" for s, k in SECURITY_KEYS])
def test_security_keys_are_wired(tmp_path, svc, key):
    """Item 6c: each fleet mTLS key is wired, keeps the reference's
    default, and a non-default value reaches its reader: the daemon's or
    the scheduler's enrollment with a manager that issues certificates,
    and what they serve and dial with."""
    port_cls, ref_cls, table, _ = CLASSES[svc]
    assert table[key] == "wired"
    assert key_value(port_cls(), key) == key_value(ref_cls(), key)
    assert len(SECURITY_KEYS) == 9

    async def main():
        # a pinned CA enrolls over the manager's TLS port, as in the
        # reference
        mgr = Manager(ManagerConfig(
            listen_ip="127.0.0.1", workdir=str(tmp_path / "mgr"),
            issue_certs=True,
            grpc_tls=key in ("security.ca_cert", "security_ca_cert")))
        await mgr.start()
        try:
            token_file = tmp_path / "token"
            token_file.write_text(mgr.issue_token + "\n")
            addr = f"127.0.0.1:{mgr.port}"
            if svc == "daemon":
                sec = {"enabled": True, "issue_token": mgr.issue_token}
                sub = key.split(".", 1)[1]
                value = {"enabled": True, "issue_token": mgr.issue_token,
                         "issue_token_path": str(token_file),
                         "ca_cert": mgr.ca_cert_path,
                         "cert_validity_s": 3 * 3600,
                         "tls_policy": "prefer"}[sub]
                sec[sub] = value
                if sub == "issue_token_path":
                    sec.pop("issue_token")
                cfg = from_dict(DaemonConfig, {
                    "security": sec, "workdir": str(tmp_path / "d"),
                    "device": "cpu", "listen_ip": "127.0.0.1",
                    "host_ip": "127.0.0.1", "hostname": "wired",
                    "manager_addresses": [addr]})
                assert cfg.unported() == []
                d = Daemon(cfg)
                await d.start()
                try:
                    leaf = open(d._peer_tls_cert, "rb").read()
                    return {
                        "enabled": lambda: (d.rpc.tls is not None,
                                            d.upload_server.tls is not None),
                        "issue_token": lambda: bool(leaf),
                        "issue_token_path": lambda: bool(leaf),
                        "ca_cert": lambda: d.fleet_ca,
                        "cert_validity_s": lambda: _validity_s(
                            d._peer_tls_cert),
                        "tls_policy": lambda: (d.rpc.mux.policy,
                                               d.upload_server.mux.policy),
                    }[sub](), value
                finally:
                    await d.stop()
            data = {"listen_ip": "127.0.0.1", "advertise_ip": "127.0.0.1",
                    "manager_addresses": [addr],
                    "security_issue_token": mgr.issue_token,
                    "workdir": str(tmp_path / "s"),
                    "statestore_handoff": False}
            value = {"security_issue_token": mgr.issue_token,
                     "security_ca_cert": mgr.ca_cert_path,
                     "workdir": str(tmp_path / "s")}[key]
            data[key] = value
            cfg = from_dict(SchedulerConfig, data)
            assert cfg.unported() == []
            sched = Scheduler(cfg)
            await sched.start()
            try:
                pool = sched.seed_client._channels
                return {
                    "security_issue_token": lambda: bool(pool.tls_cert),
                    "security_ca_cert": lambda: pool.tls_ca,
                    "workdir": lambda: os.path.dirname(
                        os.path.dirname(pool.tls_cert)),
                }[key](), value
            finally:
                await sched.stop()
        finally:
            await mgr.stop()

    got, value = asyncio.run(asyncio.wait_for(main(), 60))
    assert value != key_value(port_cls(), key)
    want = {"security.enabled": lambda: (True, True),
            "security.issue_token": lambda: True,
            "security.issue_token_path": lambda: True,
            "security.ca_cert": lambda: value,
            # backdated an hour, as the reference's
            "security.cert_validity_s": lambda: value + 3600,
            "security.tls_policy": lambda: (value, value),
            "security_issue_token": lambda: True,
            "security_ca_cert": lambda: value, "workdir": lambda: value}[key]
    assert got == want()


def _validity_s(cert_path: str) -> int:
    import ssl
    dec = ssl._ssl._test_decode_cert(cert_path)
    return int(ssl.cert_time_to_seconds(dec["notAfter"])
               - ssl.cert_time_to_seconds(dec["notBefore"]))


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


PLUGIN_AND_GATEWAY = ([("daemon", k) for k in daemon_config.KEY_CLASSES
                       if k.startswith("object_storage.")]
                      + [("daemon", "plugin_dir"),
                         ("scheduler", "plugin_dir")])


@pytest.mark.parametrize("svc,key", PLUGIN_AND_GATEWAY,
                         ids=[f"{s}:{k}" for s, k in PLUGIN_AND_GATEWAY])
def test_plugin_and_object_storage_keys_are_wired(tmp_path, svc, key):
    """Items 5d and 6a: each plugin and gateway key is wired, keeps the
    reference's default, and a non-default value builds a daemon or
    scheduler that carries it to its subsystem."""
    from dragonfly2_tpu_torch import source
    from dragonfly2_tpu_torch.common.objectstorage import (FileBackend,
                                                           S3CompatClient)
    from dragonfly2_tpu_torch.scheduler.evaluator import _PluginEvaluator

    port_cls, ref_cls, table, _ = CLASSES[svc]
    assert table[key] == "wired"
    assert key_value(port_cls(), key) == key_value(ref_cls(), key)
    plugins = tmp_path / "plugins"
    plugins.mkdir()
    if svc == "scheduler":
        (plugins / "df_plugin_evaluator_flat.py").write_text(
            "class Flat:\n"
            "    def evaluate(self, child, parent, *, total_piece_count):\n"
            "        return 0.5\n\n"
            "def dragonfly_plugin_init(option):\n"
            "    return Flat(), {'type': 'evaluator', 'name': 'flat'}\n")
        cfg = from_dict(SchedulerConfig, {"plugin_dir": str(plugins),
                                          "algorithm": "plugin:flat"})
        assert cfg.unported() == []
        ev = Scheduler(cfg).scheduling.evaluator
        assert type(ev) is _PluginEvaluator and type(ev.impl).__name__ == \
            "Flat"
        return
    gw = {"enabled": True, "port": 0,
          "buckets": {"files": f"file://{tmp_path / 'bucket'}"}}
    value = {"object_storage.enabled": True,
             "object_storage.port": _free_port(),
             "object_storage.buckets": {
                 "files": f"file://{tmp_path / 'bucket'}",
                 "web": "http://127.0.0.1:1/objects"},
             "object_storage.backends": {"web": {
                 "kind": "s3", "base": "http://127.0.0.1:1",
                 "bucket": "backend-web"}},
             "plugin_dir": str(plugins)}[key]
    if key == "plugin_dir":
        (plugins / "df_plugin_source_wiredkey.py").write_text(
            "class Src:\n"
            "    pass\n\n"
            "def dragonfly_plugin_init(option):\n"
            "    return Src(), {'type': 'source', 'name': 'wiredkey',\n"
            "                   'schemes': ['wiredkey']}\n")
        data = {"plugin_dir": value}
    else:
        sub = key.split(".", 1)[1]
        data = {"object_storage": {**gw, sub: value}}
    data.update(workdir=str(tmp_path / "d"), device="cpu",
                listen_ip="127.0.0.1", host_ip="127.0.0.1")
    cfg = from_dict(DaemonConfig, data)
    assert cfg.unported() == []
    d = Daemon(cfg)

    async def main():
        await d.start()
        try:
            if key == "plugin_dir":
                return type(source.client_for("wiredkey://x/y")).__name__
            g = d.object_gateway
            if key == "object_storage.enabled":
                return g is not None
            if key == "object_storage.port":
                return g.port
            if key == "object_storage.buckets":
                return (sorted(g.cfg.buckets),
                        type(g._backends["files"]) is FileBackend,
                        "web" not in g._backends)
            web = g._backends["web"]
            return type(web) is S3CompatClient and web.bucket == "backend-web"
        finally:
            await d.stop()
            source.client._REGISTRY.pop("wiredkey", None)

    want = {"object_storage.enabled": True,
            "object_storage.port": value,
            "object_storage.buckets": (["files", "web"], True, True),
            "object_storage.backends": True,
            "plugin_dir": "Src"}[key]
    assert asyncio.run(asyncio.wait_for(main(), 30)) == want


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


PROXY_KEYS = [k for k in daemon_config.KEY_CLASSES if k.startswith("proxy.")]


@pytest.mark.parametrize("key", PROXY_KEYS)
def test_proxy_keys_are_wired(tmp_path, key):
    """Item 6b: each proxy key is wired, keeps the reference's default,
    and a non-default value builds a daemon that carries it to its
    ``ProxyServer``."""
    import ssl

    from dragonfly2_tpu_torch.common.certs import generate_ca

    assert len(PROXY_KEYS) == 11
    assert daemon_config.KEY_CLASSES[key] == "wired"
    assert key_value(DaemonConfig(), key) == \
        key_value(RefDaemonConfig(), key)
    sub = key.split(".", 1)[1]
    ca_pem, ca_key = generate_ca("wired-key CA")
    (tmp_path / "ca.crt").write_bytes(ca_pem)
    (tmp_path / "ca.key").write_bytes(ca_key)
    (tmp_path / "ca-and-key.pem").write_bytes(ca_pem + ca_key)
    value = {"enabled": True, "port": _free_port(),
             "registry_mirror": "https://registry.example",
             "rules": [r"\.safetensors$"], "direct_rules": [r"/a/blobs/"],
             "hijack": True, "hijack_hosts": [r"^registry\.example$"],
             "ca_cert": str(tmp_path / "ca-and-key.pem"),
             "ca_key": str(tmp_path / "ca.key"), "sni_port": -1,
             "verify_upstream": False}[sub]
    assert value != key_value(RefDaemonConfig(), key)
    proxy = {"enabled": True, sub: value}
    if sub == "ca_key":
        proxy["ca_cert"] = str(tmp_path / "ca.crt")
    if sub in ("ca_cert", "ca_key"):
        proxy["hijack"] = True
    cfg = from_dict(DaemonConfig, {
        "proxy": proxy, "workdir": str(tmp_path / "d"), "device": "cpu",
        "listen_ip": "127.0.0.1", "host_ip": "127.0.0.1"})
    assert cfg.unported() == []
    d = Daemon(cfg)

    async def main():
        await d.start()
        try:
            ps = d.proxy_server
            return {
                "enabled": lambda: ps is not None and ps.port > 0,
                "port": lambda: ps.port,
                "registry_mirror": lambda: ps._resolve_url("/v2/", {}),
                "rules": lambda: ps.use_p2p("http://h/m/w.safetensors"),
                "direct_rules": lambda: ps.use_p2p(
                    "http://h/v2/a/blobs/sha256:" + "0" * 64),
                "hijack": lambda: ps.ca_cert_path,
                "hijack_hosts": lambda: (
                    ps._hijack_match("registry.example"),
                    ps._hijack_match("other.example")),
                "ca_cert": lambda: (ps.ca_cert_path,
                                    ps._issuer.ca_key_path),
                "ca_key": lambda: ps._issuer.ca_key_path,
                "sni_port": lambda: ps.sni_port > 0,
                "verify_upstream": lambda: ps._client._ssl.verify_mode,
            }[sub]()
        finally:
            await d.stop()

    want = {"enabled": True, "port": value,
            "registry_mirror": "https://registry.example/v2/",
            "rules": True,
            # a blob digest path, but a direct rule matches first
            "direct_rules": False,
            "hijack": str(tmp_path / "d" / "proxy-ca.crt"),
            "hijack_hosts": (True, False),
            "ca_cert": (value, value), "ca_key": value, "sni_port": True,
            "verify_upstream": ssl.CERT_NONE}[sub]
    assert asyncio.run(asyncio.wait_for(main(), 30)) == want


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
        got = {"class_fanout_caps": sched.scheduling.cfg.class_fanout_caps,
               "qos_preemption": sched.scheduling.cfg.qos_preemption}[key]
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


LAUNCHER_CASES = [
    # the qos keys (item 5b), the proxy keys (item 6b) and the fleet TLS
    # key (item 6c) are wired; the case keeps the id it had when it
    # refused the proxy key
    pytest.param(
        daemon_tool, "proxy:\n  enabled: true\nqos:\n  queue_limit: 3\n"
        "security:\n  enabled: true\n",
        ["security.enabled (ROADMAP Queue 1 item 6)"],
        id="dragonfly2_tpu_torch.tools.daemon-proxy:\n  enabled: true"
           "\nqos:\n  queue_limit: 3\n-name0"),
    # fleetpulse_enabled (item 4b), the quarantine, federation and state
    # store keys (items 5a, 5c), plugin_dir (item 5d) and the fleet TLS
    # keys (item 6c) are wired
    (sched_tool, "quarantine_enabled: false\nfleetpulse_enabled: false\n"
     "federation_enabled: true\nstatestore_interval_s: 5\n"
     "plugin_dir: df-plugins\nsecurity_ca_cert: ca.pem\n",
     ["security_ca_cert (ROADMAP Queue 1 item 6)"])]
WIRED_KEYS = ("fleetpulse_enabled", "quarantine_enabled",
              "federation_enabled", "statestore_interval_s",
              "qos.queue_limit", "plugin_dir", "proxy.enabled")


@pytest.mark.parametrize("tool,text,name", LAUNCHER_CASES)
def test_launchers_refuse_unported_keys(tmp_path, capsys, monkeypatch, tool,
                                        text, name):
    """The launchers' exit 2 naming the key and its item, driven with the
    fleet TLS key's class patched back to unported (no key is unported
    now): the refusal stays for keys a later reference change adds."""
    table = (daemon_config if tool is daemon_tool else sched_config
             ).KEY_CLASSES
    key = name[0].split(" ", 1)[0]
    monkeypatch.setitem(table, key, "unported:6")
    path = tmp_path / "c.yaml"
    path.write_text(text)
    with pytest.raises(SystemExit) as err:
        tool.main(["--config", str(path)])
    assert err.value.code == 2
    msg = capsys.readouterr().err
    for n in name:
        assert n in msg
    for wired in WIRED_KEYS:
        assert wired not in msg


@pytest.mark.parametrize("tool,text,name", LAUNCHER_CASES)
def test_launchers_accept_the_security_keys(tmp_path, capsys, monkeypatch,
                                            tool, text, name):
    """The same files start their service now: the launcher hands the
    loaded config, fleet TLS key included, to ``serve``."""
    served = []

    async def serve(cfg, **kw):
        served.append(cfg)

    monkeypatch.setattr(tool, "serve", serve)
    path = tmp_path / "c.yaml"
    path.write_text(text)
    assert tool.main(["--config", str(path)]) == 0
    assert "not ported" not in capsys.readouterr().err
    (cfg,) = served
    key = name[0].split(" ", 1)[0]
    assert key_value(cfg, key) == {"security.enabled": True,
                                   "security_ca_cert": "ca.pem"}[key]
    assert cfg.unported() == []


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
    assert (sched.scheduling.cfg.candidate_parent_limit,
            sched.scheduling.cfg.filter_parent_limit) == (3, 6)
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
