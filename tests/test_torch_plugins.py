"""Plugins and the TTL cache, against the reference.

* ``common/plugins.py``: the reference's ``TestPluginLoading`` and
  ``TestSearcherPlugin`` (``tests/test_plugins_jobs.py``) run through both
  packages. A plugin file names its own package, so each case writes the
  plugin once per package with that package's name; the contract is
  otherwise the same file. Source schemes registered here are removed
  after each case (the registries are process-wide).
* ``common/cache.py``: the ``TTLCache`` cases of ``tests/test_common.py``
  through both classes.
* The plugin evaluator: on seeded cluster states, both packages'
  ``Scheduling`` with the same evaluator plugin give the same parents and
  the same decision rows (``base_total``, ``substituted: {"total":
  "plugin"}``); a live scheduler started with ``algorithm:
  plugin:<name>`` rules a leecher's task with it.
* A daemon pulls through a source plugin's scheme, and the reference's
  daemon pulling the same object writes the same piece metas.
* A manager started with ``plugin_dir`` answers ``GetSchedulers`` through
  the searcher plugin; a broken plugin fails its start.

Tolerances are exact.
"""

import asyncio
import random
import textwrap
import time

import numpy as np
import pytest

import dragonfly2_tpu.common.cache as ref_cache
import dragonfly2_tpu.common.plugins as ref_plugins
import dragonfly2_tpu.idl.messages as ref_msg
import dragonfly2_tpu.manager.searcher as ref_searcher
import dragonfly2_tpu.source.client as ref_source_client
from dragonfly2_tpu.scheduler import config as ref_config
from dragonfly2_tpu.scheduler.evaluator import \
    make_evaluator as ref_make_evaluator
from dragonfly2_tpu.scheduler.scheduling import Scheduling as RefScheduling
import dragonfly2_tpu_torch.common.cache as port_cache
import dragonfly2_tpu_torch.common.plugins as port_plugins
import dragonfly2_tpu_torch.idl.messages as port_msg
import dragonfly2_tpu_torch.manager.searcher as port_searcher
import dragonfly2_tpu_torch.source.client as port_source_client
from dragonfly2_tpu_torch.daemon.config import DaemonConfig
from dragonfly2_tpu_torch.daemon.config import SchedulerConfig as DaemonSched
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.idl.messages import DownloadRequest
from dragonfly2_tpu_torch.manager.server import Manager, ManagerConfig
from dragonfly2_tpu_torch.rpc import Channel, ServiceClient
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig, SeedPeerAddr
from dragonfly2_tpu_torch.scheduler.evaluator import (_PluginEvaluator,
                                                      make_evaluator)
from dragonfly2_tpu_torch.scheduler.scheduling import Scheduling
from dragonfly2_tpu_torch.scheduler.server import Scheduler
from test_torch_native import ref_native_lib  # noqa: F401 - fixture
from test_torch_scheduler import _build_states

PKGS = {"reference": "dragonfly2_tpu", "port": "dragonfly2_tpu_torch"}
PLUGINS = {"reference": ref_plugins, "port": port_plugins}
REGISTRIES = {"reference": ref_source_client, "port": port_source_client}

EVALUATOR_PLUGIN = textwrap.dedent('''
    class TopFirstEvaluator:
        """Toy scorer: peers whose id sorts first win."""
        def __init__(self, option):
            self.bias = float(option.get("bias", 0))
        def evaluate(self, child, parent, *, total_piece_count):
            return self.bias - ord(parent.id[0])

    def dragonfly_plugin_init(option):
        return TopFirstEvaluator(option), {"type": "evaluator",
                                           "name": "topfirst"}
''')

# distinct totals on the seeded states' peers ("peer-<n>"): the pieces a
# parent holds, less its number
RANK_PLUGIN = textwrap.dedent('''
    class Rank:
        def evaluate(self, child, parent, *, total_piece_count):
            return (len(parent.finished_pieces) / max(total_piece_count, 1)
                    - int(parent.id.rsplit("-", 1)[1]) / 100.0)

    def dragonfly_plugin_init(option):
        return Rank(), {"type": "evaluator", "name": "rank"}
''')


def source_plugin(pkg: str, scheme: str, payload: bytes) -> str:
    """The reference's ``NullSource`` test plugin, naming ``pkg``, on
    ``scheme``, serving ``payload``."""
    return textwrap.dedent(f'''
        class NullSource:
            async def content_length(self, req):
                return {len(payload)}
            async def supports_range(self, req):
                return False
            async def last_modified(self, req):
                return ""
            async def download(self, req):
                from {pkg}.source.client import SourceResponse
                async def chunks():
                    data = {payload!r}
                    for off in range(0, len(data), 1 << 20):
                        yield data[off:off + (1 << 20)]
                return SourceResponse(status=200,
                                      content_length={len(payload)},
                                      total_length={len(payload)},
                                      chunks=chunks())
            async def list(self, req):
                return []
            async def close(self):
                pass

        def dragonfly_plugin_init(option):
            return NullSource(), {{"type": "source", "name": "nullsrc",
                                  "schemes": [{scheme!r}]}}
    ''')


SEARCHER_PLUGIN = textwrap.dedent("""
    class AlwaysSecond:
        def find_scheduler_cluster(self, clusters, req):
            return clusters[1]["id"] if len(clusters) > 1 else None

    def dragonfly_plugin_init(option):
        return AlwaysSecond(), {"type": "searcher", "name": "default"}
""")


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return request.param


@pytest.fixture
def schemes():
    """Schemes a case registers, removed from both registries after it."""
    added: list[str] = []
    yield added
    for name in added:
        for reg in REGISTRIES.values():
            reg._REGISTRY.pop(name, None)


# ------------------------------------------------------------ loading

class TestPluginLoading:
    def test_load_with_contract_checks(self, tmp_path, pkg):
        (tmp_path / "df_plugin_evaluator_topfirst.py").write_text(
            EVALUATOR_PLUGIN)
        impl, meta = PLUGINS[pkg].load(str(tmp_path), "evaluator",
                                       "topfirst", {"bias": 1000})
        assert meta == {"type": "evaluator", "name": "topfirst"}
        assert impl.bias == 1000

    def test_contract_violations(self, tmp_path, pkg):
        plugins = PLUGINS[pkg]
        with pytest.raises(plugins.PluginError, match="plugin not found"):
            plugins.load(str(tmp_path), "evaluator", "missing")
        (tmp_path / "df_plugin_evaluator_nosym.py").write_text("x = 1\n")
        with pytest.raises(plugins.PluginError, match="missing"):
            plugins.load(str(tmp_path), "evaluator", "nosym")
        (tmp_path / "df_plugin_evaluator_liar.py").write_text(
            "def dragonfly_plugin_init(option):\n"
            "    return object(), {'type': 'manager', 'name': 'liar'}\n")
        with pytest.raises(plugins.PluginError, match="plugin type"):
            plugins.load(str(tmp_path), "evaluator", "liar")
        (tmp_path / "df_plugin_evaluator_alias.py").write_text(
            "def dragonfly_plugin_init(option):\n"
            "    return object(), {'type': 'evaluator', 'name': 'other'}\n")
        with pytest.raises(plugins.PluginError, match="plugin name"):
            plugins.load(str(tmp_path), "evaluator", "alias")
        (tmp_path / "df_plugin_evaluator_empty.py").write_text(
            "def dragonfly_plugin_init(option):\n"
            "    return object(), {}\n")
        with pytest.raises(plugins.PluginError, match="empty"):
            plugins.load(str(tmp_path), "evaluator", "empty")

    def test_both_packages_load_one_name_and_leave_no_module(self,
                                                              tmp_path):
        """The loader executes ``df_plugin_<type>_<name>`` without entering
        it in ``sys.modules``, so the two packages' plugins of one name
        stay apart."""
        import sys
        for pkg in sorted(PKGS):
            d = tmp_path / pkg
            d.mkdir()
            (d / "df_plugin_evaluator_same.py").write_text(
                f"WHO = {pkg!r}\n"
                "class E:\n"
                "    def evaluate(self, c, p, *, total_piece_count):\n"
                "        return 0.0\n"
                "def dragonfly_plugin_init(option):\n"
                "    return E(), {'type': 'evaluator', 'name': 'same'}\n")
        ref_impl, _ = ref_plugins.load(str(tmp_path / "reference"),
                                       "evaluator", "same")
        port_impl, _ = port_plugins.load(str(tmp_path / "port"),
                                         "evaluator", "same")
        assert "df_plugin_evaluator_same" not in sys.modules
        assert type(ref_impl) is not type(port_impl)

    def test_discover_lists_one_type(self, tmp_path, pkg):
        for name in ("df_plugin_source_b.py", "df_plugin_source_a.py",
                     "df_plugin_evaluator_c.py", "df_plugin_source_x.txt"):
            (tmp_path / name).write_text("")
        assert PLUGINS[pkg].discover(str(tmp_path), "source") == ["a", "b"]
        assert PLUGINS[pkg].discover(str(tmp_path / "none"), "source") == []

    def test_scheduler_uses_plugin_evaluator(self, tmp_path, pkg):
        (tmp_path / "df_plugin_evaluator_topfirst.py").write_text(
            EVALUATOR_PLUGIN)
        build = {"reference": ref_make_evaluator,
                 "port": make_evaluator}[pkg]
        ev = build("plugin:topfirst", plugin_dir=str(tmp_path))

        class P:
            def __init__(self, pid):
                self.id = pid

        assert ev.evaluate(P("c"), P("a"), total_piece_count=1) \
            > ev.evaluate(P("c"), P("b"), total_piece_count=1)

    def test_source_plugin_registers_scheme(self, tmp_path, pkg, schemes):
        (tmp_path / "df_plugin_source_nullsrc.py").write_text(
            source_plugin(PKGS[pkg], "nullsixteen", b"xyzw"))
        schemes.append("nullsixteen")
        assert PLUGINS[pkg].load_source_plugins(str(tmp_path)) == 1
        client = REGISTRIES[pkg].client_for("nullsixteen://whatever/x")

        async def main():
            resp = await client.download(REGISTRIES[pkg].SourceRequest(
                url="nullsixteen://w/x"))
            return await resp.read_all()
        assert asyncio.run(main()) == b"xyzw"

    @pytest.mark.parametrize("scheme", ["file", "http", "https"])
    def test_a_plugin_cannot_take_a_registered_scheme(self, tmp_path, pkg,
                                                      scheme):
        (tmp_path / "df_plugin_source_nullsrc.py").write_text(
            source_plugin(PKGS[pkg], scheme, b"evil"))
        before = REGISTRIES[pkg].client_for(f"{scheme}://h/x")
        assert PLUGINS[pkg].load_source_plugins(str(tmp_path)) == 0
        assert REGISTRIES[pkg].client_for(f"{scheme}://h/x") is before


# ------------------------------------------------------------ searcher

class TestSearcherPlugin:
    @pytest.mark.parametrize("side", sorted(PKGS))
    def test_plugin_overrides_cluster_choice(self, tmp_path, side):
        """A searcher-type plugin replaces the affinity scorer (reference
        manager/searcher plugin slot)."""
        s = {"reference": ref_searcher, "port": port_searcher}[side]
        msg = {"reference": ref_msg, "port": port_msg}[side]
        plug_dir = tmp_path / "plugins"
        plug_dir.mkdir()
        (plug_dir / "df_plugin_searcher_default.py").write_text(
            SEARCHER_PLUGIN)
        clusters = [{"id": 1, "scopes": {}, "is_default": True},
                    {"id": 2, "scopes": {}}]
        req = msg.GetSchedulersRequest(ip="10.0.0.1", hostname="h")
        # the built-in scorer prefers the default cluster
        assert s.find_scheduler_cluster(clusters, req) == 1
        s.load_searcher_plugin(str(plug_dir))
        try:
            assert s.find_scheduler_cluster(clusters, req) == 2
        finally:
            s._plugin_searcher = None

    def test_a_plugin_without_the_method_is_refused(self, tmp_path):
        (tmp_path / "df_plugin_searcher_default.py").write_text(
            "def dragonfly_plugin_init(option):\n"
            "    return object(), {'type': 'searcher', 'name': 'default'}\n")
        with pytest.raises(port_plugins.PluginError,
                           match="find_scheduler_cluster"):
            port_searcher.load_searcher_plugin(str(tmp_path))
        assert port_searcher._plugin_searcher is None


def test_manager_with_plugin_dir_answers_through_the_searcher(tmp_path):
    """``ManagerConfig.plugin_dir`` loads the searcher at start: a
    ``GetSchedulers`` over the RPC lands on the cluster the plugin picks
    (the second, where the built-in scorer picks the default). A broken
    plugin fails the start, as in the reference."""
    from dragonfly2_tpu_torch.manager.service import MANAGER_SERVICE

    plug_dir = tmp_path / "plugins"
    plug_dir.mkdir()
    (plug_dir / "df_plugin_searcher_default.py").write_text(SEARCHER_PLUGIN)

    async def main():
        mgr = Manager(ManagerConfig(listen_ip="127.0.0.1",
                                    plugin_dir=str(plug_dir),
                                    workdir=str(tmp_path)))
        assert mgr.cfg.unported() == []
        await mgr.start()
        try:
            assert type(port_searcher._plugin_searcher).__name__ == \
                "AlwaysSecond"
            first = mgr.store.default_scheduler_cluster()
            second = mgr.store.create_scheduler_cluster("second")
            for cluster, host in ((first, "s-first"), (second, "s-second")):
                mgr.store.upsert_scheduler(hostname=host, ip="127.0.0.1",
                                           port=9000, cluster_id=cluster)
            ch = Channel(mgr.address)
            try:
                resp = await ServiceClient(ch, MANAGER_SERVICE).unary(
                    "GetSchedulers", port_msg.GetSchedulersRequest(
                        hostname="h", ip="10.0.0.1"))
            finally:
                await ch.close()
            return [s.hostname for s in resp.schedulers]
        finally:
            await mgr.stop()
            port_searcher._plugin_searcher = None

    assert asyncio.run(asyncio.wait_for(main(), 30)) == ["s-second"]

    (plug_dir / "df_plugin_searcher_default.py").write_text("x = 1\n")

    async def broken():
        mgr = Manager(ManagerConfig(listen_ip="127.0.0.1",
                                    plugin_dir=str(plug_dir)))
        try:
            await mgr.start()
        finally:
            await mgr.stop()

    with pytest.raises(port_plugins.PluginError, match="missing"):
        asyncio.run(broken())
    assert port_searcher._plugin_searcher is None


# ------------------------------------------------------------ TTL cache

class TestCache:
    @pytest.mark.parametrize("side", sorted(PKGS))
    def test_ttl_expiry(self, side):
        c = {"reference": ref_cache, "port": port_cache}[side].TTLCache(
            default_ttl=0.05)
        c.set("k", 1)
        assert c.get("k") == 1
        time.sleep(0.08)
        assert c.get("k") is None

    @pytest.mark.parametrize("side", sorted(PKGS))
    def test_no_expire(self, side):
        c = {"reference": ref_cache, "port": port_cache}[side].TTLCache()
        c.set("k", 2, ttl=0)
        time.sleep(0.01)
        assert c.get("k") == 2

    def test_a_scripted_sequence_matches_the_reference(self, monkeypatch):
        """One seeded script of sets, gets, deletes, purges and lengths on
        a frozen monotonic clock gives both classes the same answers."""
        now = [1000.0]
        monkeypatch.setattr(time, "monotonic", lambda: now[0])
        ref, port = ref_cache.TTLCache(5.0), port_cache.TTLCache(5.0)
        rng = random.Random(16)
        for step in range(400):
            op = rng.choice(["set", "get", "delete", "purge", "len",
                             "tick"])
            key = rng.randrange(12)
            if op == "set":
                ttl = rng.choice([None, 0, 0.5, 3.0, 9.0])
                ref.set(key, step, ttl)
                port.set(key, step, ttl)
            elif op == "get":
                assert port.get(key, "none") == ref.get(key, "none")
            elif op == "delete":
                ref.delete(key)
                port.delete(key)
            elif op == "purge":
                assert port.purge_expired() == ref.purge_expired()
            elif op == "len":
                assert len(port) == len(ref)
            else:
                now[0] += rng.choice([0.1, 1.0, 4.0])
        assert port._data == ref._data


# ------------------------------------------------------------ evaluator

@pytest.mark.parametrize("seed", range(4))
def test_plugin_rulings_and_decision_rows_match_reference(tmp_path, seed):
    """The same evaluator plugin in both packages' ``Scheduling`` on
    seeded states: the same parents, and the reference's decision rows,
    each candidate carrying the heuristic's ``base_total`` and
    ``substituted: {"total": "plugin"}``."""
    (tmp_path / "df_plugin_evaluator_rank.py").write_text(RANK_PLUGIN)
    ref_task, port_task, ids = _build_states(seed)
    ref_ev = ref_make_evaluator("plugin:rank", plugin_dir=str(tmp_path))
    port_ev = make_evaluator("plugin:rank", plugin_dir=str(tmp_path))
    assert type(port_ev) is _PluginEvaluator
    rows_seen = 0
    for i, cid in enumerate(ids):
        for kind in ("find_parents", "refresh_parents"):
            ref_rows, port_rows = [], []
            random.seed(seed * 100 + i)
            ref_sched = RefScheduling(ref_config.SchedulerConfig(), ref_ev)
            ref_sched.decision_sink = ref_rows.append
            ref_parents = getattr(ref_sched, kind)(ref_task.peers[cid])
            port_sched = Scheduling(port_ev,
                                    rng=random.Random(seed * 100 + i))
            port_sched.decision_sink = port_rows.append
            port_parents = getattr(port_sched, kind)(port_task.peers[cid])
            assert [p.id for p in port_parents] == \
                [p.id for p in ref_parents]
            assert port_rows == ref_rows
            for row in port_rows:
                assert row["evaluator"] == "_PluginEvaluator"
                for cand in row["candidates"]:
                    rows_seen += 1
                    assert cand["substituted"] == {"total": "plugin"}
                    assert "base_total" in cand
    assert rows_seen > 0


def test_a_live_scheduler_rules_with_its_plugin(tmp_path):
    """A scheduler started with ``algorithm: plugin:rank`` and
    ``plugin_dir`` rules a leecher's task with the plugin: the seed, its
    only candidate, carries the plugin's total and the substitution."""
    (tmp_path / "df_plugin_evaluator_flat.py").write_text(textwrap.dedent('''
        class Flat:
            def evaluate(self, child, parent, *, total_piece_count):
                return 0.25

        def dragonfly_plugin_init(option):
            return Flat(), {"type": "evaluator", "name": "flat"}
    '''))
    payload = np.random.default_rng(16).integers(
        0, 256, 5 << 20, dtype=np.uint8).tobytes()
    origin = tmp_path / "origin.bin"
    origin.write_bytes(payload)

    async def main():
        seed = Daemon(DaemonConfig(
            workdir=str(tmp_path / "seed"), hostname="seed", is_seed=True,
            listen_ip="127.0.0.1", host_ip="127.0.0.1", device="cpu"))
        await seed.start()
        sched = Scheduler(SchedulerConfig(
            listen_ip="127.0.0.1", algorithm="plugin:flat",
            plugin_dir=str(tmp_path), seed_peers=[SeedPeerAddr(
                host_id=seed.host_info().id, ip="127.0.0.1",
                rpc_port=seed.rpc.port,
                download_port=seed.upload_server.port)]))
        await sched.start()
        leecher = Daemon(DaemonConfig(
            workdir=str(tmp_path / "l"), hostname="l", device="cpu",
            listen_ip="127.0.0.1", host_ip="127.0.0.1",
            scheduler=DaemonSched(addresses=[sched.address])))
        await leecher.start()
        try:
            out = str(tmp_path / "out.bin")
            async for _ in leecher.ptm.start_file_task(DownloadRequest(
                    url=f"file://{origin}", output=out,
                    disable_back_source=True, timeout_s=60)):
                pass
            rows = sched.ledger.snapshot(limit=256)["decisions"]
            return open(out, "rb").read(), rows, seed.host_info().id
        finally:
            await leecher.stop()
            await sched.stop()
            await seed.stop()

    got, rows, seed_id = asyncio.run(asyncio.wait_for(main(), 60))
    assert got == payload
    cands = [c for r in rows for c in r["candidates"]]
    assert cands and all(r["evaluator"] == "_PluginEvaluator" for r in rows)
    for c in cands:
        assert c["host_id"] == seed_id and c["total"] == 0.25
        assert c["substituted"] == {"total": "plugin"}


# ------------------------------------------------------------ source

def test_daemon_pulls_through_a_source_plugin_as_the_reference(
        tmp_path, schemes, ref_native_lib):
    """Each package's daemon loads its ``plugin_dir`` at start and pulls
    a plugin scheme's object back to source: the bytes are the plugin's,
    and with both native libraries built the task's piece metas (numbers,
    offsets, sizes, crc32c digests) are the reference's."""
    from dragonfly2_tpu.daemon.config import DaemonConfig as RefDaemonConfig
    from dragonfly2_tpu.daemon.config import StorageSection as RefStorage
    from dragonfly2_tpu.daemon.daemon import Daemon as RefDaemon
    from dragonfly2_tpu.idl.messages import DownloadRequest as RefRequest

    payload = np.random.default_rng(61).integers(
        0, 256, (9 << 20) + 123, dtype=np.uint8).tobytes()
    schemes.append("plugsixteen")
    results = {}
    for side in sorted(PKGS):
        plugs = tmp_path / f"plugins-{side}"
        plugs.mkdir()
        (plugs / "df_plugin_source_nullsrc.py").write_text(
            source_plugin(PKGS[side], "plugsixteen", payload))
        out = str(tmp_path / f"out-{side}.bin")
        url = "plugsixteen://objects/model.bin"
        if side == "port":
            daemon = Daemon(DaemonConfig(
                workdir=str(tmp_path / side), hostname=side, device="cpu",
                host_ip="127.0.0.1", plugin_dir=str(plugs)))
            req = DownloadRequest(url=url, output=out, timeout_s=60)
        else:
            daemon = RefDaemon(RefDaemonConfig(
                workdir=str(tmp_path / side), hostname=side,
                host_ip="127.0.0.1", plugin_dir=str(plugs),
                storage=RefStorage(gc_interval_s=3600)))
            req = RefRequest(url=url, output=out, timeout_s=60)

        async def main(daemon=daemon, req=req):
            await daemon.start()
            try:
                task_id = None
                async for r in daemon.ptm.start_file_task(req):
                    task_id = r.task_id or task_id
                md = daemon.storage_mgr.get(task_id).md
                return task_id, {n: (p.start, p.size, p.digest)
                                 for n, p in md.pieces.items()}
            finally:
                await daemon.stop()

        results[side] = asyncio.run(asyncio.wait_for(main(), 60))
        assert open(out, "rb").read() == payload
    assert results["port"] == results["reference"]
    assert all(d.startswith("crc32c:")
               for *_, d in results["port"][1].values())
