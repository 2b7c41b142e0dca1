"""Phase 9 of ``chip_smoke.py`` alone, repeated, with a per-piece trace.

    python3 tests/sharded_trace.py [--runs 3] [--trace-from 0]
                                   [--health-plane on|off|alternate]
    python3 tests/sharded_trace.py --cpu-pod ref|port

Needs one CUDA card, except with ``--cpu-pod`` (below). Builds phase 2's reference tensor and phase 6's
9-layer Llama-3-8B-layout file, then runs ``chip_smoke.phase_sharded``
``--runs`` times in one process (later runs find earlier sinks' pinned
blocks still held). Besides the phase's own lines it prints, with seconds
since the start:

- ``ANNOUNCE <dispatcher> from <parent> [nums]``: a parent announced
  pieces to a replica's dispatcher;
- ``DISPATCH <peer> piece <n> from <parent> age <s> swap <bool> holders``:
  a replica's worker took a piece (age since the dispatcher first saw it);
- ``LANDED <peer> [nums] from <parent> in <s>`` and ``DONE <peer> [nums]
  from <parent> in <s>``: the landing, and the whole fetch;
- ``SYNC <parent> -> <child> [nums]``: a parent's piece-sync stream sent
  pieces to a child, and ``RECV <child> from <parent> [nums]``: the
  child's synchronizer took them off the wire;
- ``PARENTS <parent>:inflight=..,announced=..,removed=..,ejected=..``
  after each swap piece the seed is asked for;
- ``REMOVE <dispatcher> parent <parent>``: a replica stopped pulling from
  a parent (``by _consume_packets``: the scheduler's newest offer left it
  out; ``by _run``: its sync stream died, printed as ``sync with <parent>
  ended: <error>``), which drops the parent from every piece's holders;
- the conductor's ``swap piece N falls back to the tree`` lines.

On the seed's side (the spawned child that runs the scheduler and the
seed daemon) it prints, on the same clock:

- ``SEED LANDED [n]`` when a piece's write finished and ``SEED PUBLISH
  [n]`` when the conductor published it to its subscribers;
- ``SEED DRAIN <child> [nums]``: a piece-sync stream took published
  events off its queue, and the ``SYNC`` line when it sent them;
- ``SEED FINISH start``, ``SEED VERIFY start/end``, ``SEED MARK_DONE
  start/end`` and ``SEED FINISH end`` around the seed's finalize.

Only pieces numbered ``--trace-from`` and up are traced, and every swap
piece the seed serves. ``--health-plane off`` builds the four replicas
(this process's daemons) with ``health.enabled`` false, so no loop-lag
sampler, watchdog section or SLO counting runs on their loop; the seed's
child keeps the default. ``alternate`` runs on, off, off, on, ... to
compare the two within one call. A check that fails is printed and the next run
goes on; the exit code is 1 when any run failed.

``--cpu-pod ref|port`` runs the same question on the CPU through either
package's daemons (``ref`` imports the JAX package, so not on the card):
a scheduler, a seed and one swap pair of replicas in one event loop, a
192 MiB file in 8 shards from a ``file://`` origin slowed to about
64 MB/s, the seed's uploads limited to 48 MB/s so that the replicas fall
behind its pull as phase 9's do. It prints one JSON line: for each of the
file's last 8 pieces (in the seed's landing order) the seconds from the
seed's landing to each replica's first announcement of it and to its
landing there, and the pod's tail (the last replica landing after the
seed's last piece).
"""

import argparse
import asyncio
import logging
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from dragonfly2_tpu_torch.daemon import conductor as cmod  # noqa: E402
from dragonfly2_tpu_torch.daemon import piece_dispatcher as pd  # noqa: E402
from dragonfly2_tpu_torch.daemon import piece_engine as pe  # noqa: E402
from dragonfly2_tpu_torch.daemon import rpcserver  # noqa: E402

# CLOCK_MONOTONIC is one clock for every process of the host: the child
# inherits the parent's origin, so both sides' lines share one time axis
T0 = float(os.environ.setdefault("SHARDED_TRACE_T0", str(time.monotonic())))
TAIL_ENV = "SHARDED_TRACE_FROM"


def say(line: str) -> None:
    print(f"{time.monotonic() - T0:.3f} {line}", flush=True)


def trace_seed(tail: int) -> None:
    """The seed's landing, publishing, piece-sync draining and finalize."""
    land = cmod.PeerTaskConductor.on_piece_from_source
    publish = cmod.PeerTaskConductor._publish
    drain = rpcserver.DaemonService._drain
    finish = cmod.PeerTaskConductor._finish_success
    verify = cmod.PeerTaskConductor._verify_digest
    storage = cmod.TaskStorage.mark_done

    async def traced_land(self, num, offset, data, cost_ms):
        out = await land(self, num, offset, data, cost_ms)
        if num >= tail:
            say(f"SEED LANDED [{num}]")
        return out

    def traced_publish(self, event):
        if event["type"] == "piece" and event["num"] >= tail:
            say(f"SEED PUBLISH [{event['num']}] to "
                f"{len(self._subscribers)} subscribers")
        elif event["type"] == "done":
            say("SEED PUBLISH done")
        return publish(self, event)

    def traced_drain(q, first):
        events = drain(q, first)
        nums = [e["num"] for e in events
                if e["type"] == "piece" and e["num"] >= tail]
        if nums:
            say(f"SEED DRAIN {id(q) % 997} {nums}")
        return events

    async def traced_finish(self):
        say("SEED FINISH start")
        try:
            return await finish(self)
        finally:
            say("SEED FINISH end")

    async def traced_verify(self):
        say("SEED VERIFY start")
        try:
            return await verify(self)
        finally:
            say("SEED VERIFY end")

    def traced_mark_done(self, **kw):
        say("SEED MARK_DONE start")
        try:
            return storage(self, **kw)
        finally:
            say("SEED MARK_DONE end")

    cmod.PeerTaskConductor.on_piece_from_source = traced_land
    cmod.PeerTaskConductor._publish = traced_publish
    rpcserver.DaemonService._drain = staticmethod(traced_drain)
    cmod.PeerTaskConductor._finish_success = traced_finish
    cmod.PeerTaskConductor._verify_digest = traced_verify
    cmod.TaskStorage.mark_done = traced_mark_done


def traced_child(workdir: str, conn) -> None:
    """Phase 9's child (scheduler and seed) with the seed's side traced
    and the piece sync's ``SYNC`` lines printed from the seed."""
    tail = int(os.environ[TAIL_ENV])
    trace_seed(tail)
    packet = rpcserver.DaemonService._packet

    def traced_packet(self, request, ts, infos, *rest):
        nums = [i.piece_num for i in infos if i.piece_num >= tail]
        if nums:
            say(f"SYNC {request.dst_peer_id[-6:]} -> "
                f"{request.src_peer_id[-6:]} {nums}")
        return packet(self, request, ts, infos, *rest)
    rpcserver.DaemonService._packet = traced_packet
    cs.p2p_child(workdir, conn)


def trace(tail: int) -> None:
    """Wrap the engine's fetch, the dispatcher's announce and parent
    removal, the conductor's span landing and both ends of the piece
    sync with printing."""
    fetch, announce = pe.PieceEngine._download_one, pd.PieceDispatcher.announce
    land = cmod.PeerTaskConductor.on_span_from_peer
    remove = pd.PieceDispatcher.remove_parent
    packet, receive = rpcserver.DaemonService._packet, \
        pe._Synchronizer._on_packet

    async def traced_fetch(self, conductor, session, d, *, track=True):
        for info in d.pieces:
            n = info.piece_num
            swap = n in conductor.swap_piece_nums
            if n >= tail or (swap and d.parent.is_seed):
                ps = self.dispatcher._pieces.get(n)
                age = time.monotonic() - ps.first_seen if ps else -1.0
                holders = sorted(h[-6:] for h in ps.holders) if ps else None
                say(f"DISPATCH {conductor.peer_id[-6:]} piece {n} from "
                    f"{d.parent.peer_id[-6:]} age {age:.3f} swap {swap} "
                    f"holders {holders}")
                if swap and d.parent.is_seed:
                    # what the replica knew of each parent at the fallback
                    say("PARENTS " + " ".join(
                        f"{pid[-6:]}:inflight={st.inflight},"
                        f"announced={st.announced},removed={st.removed},"
                        f"ejected={st.ejected}"
                        for pid, st in self.dispatcher.parents.items()))
        t = time.monotonic()
        out = await fetch(self, conductor, session, d, track=track)
        say(f"DONE {conductor.peer_id[-6:]} "
            f"{[i.piece_num for i in d.pieces]} from "
            f"{d.parent.peer_id[-6:]} in {time.monotonic() - t:.3f}")
        return out

    async def traced_announce(self, parent_id, infos):
        nums = [i.piece_num for i in infos if i.piece_num >= tail]
        if nums:
            say(f"ANNOUNCE {id(self) % 997} from {parent_id[-6:]} {nums}")
        return await announce(self, parent_id, infos)

    async def traced_land(self, parent_id, pieces, data, cost):
        t = time.monotonic()
        out = await land(self, parent_id, pieces, data, cost)
        nums = [n for n in out[0] if n >= tail]
        if nums:
            say(f"LANDED {self.peer_id[-6:]} {nums} from {parent_id[-6:]} "
                f"in {time.monotonic() - t:.3f}")
        return out

    async def traced_remove(self, peer_id):
        say(f"REMOVE {id(self) % 997} parent {peer_id[-6:]} by "
            f"{sys._getframe(1).f_code.co_name}")
        return await remove(self, peer_id)

    def traced_packet(self, request, ts, infos, *rest):
        nums = [i.piece_num for i in infos if i.piece_num >= tail]
        if nums:
            say(f"SYNC {request.dst_peer_id[-6:]} -> "
                f"{request.src_peer_id[-6:]} {nums}")
        return packet(self, request, ts, infos, *rest)

    async def traced_receive(self, pkt):
        nums = [i.piece_num for i in pkt.piece_infos or []
                if i.piece_num >= tail]
        if nums:
            say(f"RECV {self.conductor.peer_id[-6:]} from "
                f"{self.parent.peer_id[-6:]} {nums}")
        return await receive(self, pkt)

    pe.PieceEngine._download_one = traced_fetch
    pd.PieceDispatcher.announce = traced_announce
    pd.PieceDispatcher.remove_parent = traced_remove
    cmod.PeerTaskConductor.on_span_from_peer = traced_land
    rpcserver.DaemonService._packet = traced_packet
    pe._Synchronizer._on_packet = traced_receive

    class Fallbacks(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if "falls back" in msg or msg.startswith("sync with"):
                say(msg)
    log = logging.getLogger("df.core.conductor")
    log.setLevel(logging.INFO)
    log.addHandler(Fallbacks())
    engine_log = logging.getLogger("df.flow.engine")
    engine_log.setLevel(logging.DEBUG)
    engine_log.addHandler(Fallbacks())


CPU_PIECE = 4 << 20
CPU_PIECES = 48
CPU_SHARDS = 8
CPU_ORIGIN_BPS = 16e6          # a stream; the seed pulls on 4
CPU_UPLOAD_BPS = 48e6
CPU_TAIL = 8


def cpu_pod(pkg: str, workdir: str) -> dict:
    """One swap pair behind a rate-limited seed, through ``pkg``'s
    daemons; the per-piece trace of the file's last pieces."""
    import dataclasses
    import importlib
    import json

    root = "dragonfly2_tpu" if pkg == "ref" else "dragonfly2_tpu_torch"
    mod = {n: importlib.import_module(f"{root}.{n}") for n in (
        "idl.messages", "daemon.config", "daemon.daemon", "daemon.conductor",
        "daemon.piece_dispatcher", "scheduler.server", "scheduler.config",
        "common.rate", "source", "source.file_client")}
    msg = mod["idl.messages"]
    dcfg = mod["daemon.config"]
    scfg = mod["scheduler.config"]
    data = np.random.default_rng(5).integers(
        0, 256, CPU_PIECE * CPU_PIECES, dtype=np.uint8).tobytes()
    path = os.path.join(workdir, "origin.bin")
    with open(path, "wb") as f:
        f.write(data)
    size = len(data) // CPU_SHARDS
    manifest = msg.ShardManifest(shards=[msg.ShardInfo(
        name=f"s{i}", range_start=i * size, range_size=size, dtype="uint8")
        for i in range(CPU_SHARDS)])
    names = ",".join(s.name for s in manifest.shards)
    t: dict = {"seed": {}, "announce": {}, "landed": {}}
    conductor = mod["daemon.conductor"].PeerTaskConductor
    dispatcher = mod["daemon.piece_dispatcher"].PieceDispatcher
    land_src, land_peer = (conductor.on_piece_from_source,
                           conductor.on_span_from_peer)
    announce = dispatcher.announce

    async def traced_src(self, num, *a, **kw):
        out = await land_src(self, num, *a, **kw)
        t["seed"].setdefault(num, time.monotonic())
        return out

    async def traced_peer(self, parent_id, pieces, data, cost):
        out = await land_peer(self, parent_id, pieces, data, cost)
        for n in out[0]:
            t["landed"].setdefault(self.peer_id, {}).setdefault(
                n, time.monotonic())
        return out

    async def traced_announce(self, parent_id, infos):
        for i in infos:
            t["announce"].setdefault(id(self), {}).setdefault(
                i.piece_num, time.monotonic())
        return await announce(self, parent_id, infos)

    class SlowOrigin(mod["source.file_client"].FileSourceClient):
        async def download(self, req):
            resp = await super().download(req)
            inner = resp.chunks

            async def slow():
                async for chunk in inner:
                    await asyncio.sleep(len(chunk) / CPU_ORIGIN_BPS)
                    yield chunk
            resp.chunks = slow()
            return resp

    def daemon_cfg(name, **kw):
        cfg = dcfg.DaemonConfig(workdir=os.path.join(workdir, name),
                                hostname=name, host_ip="127.0.0.1",
                                listen_ip="127.0.0.1", **kw)
        if pkg == "ref":
            cfg.storage = dcfg.StorageSection(gc_interval_s=3600)
        else:
            cfg.device = "cpu"
        return cfg

    async def main() -> None:
        seed = mod["daemon.daemon"].Daemon(daemon_cfg("seed", is_seed=True))
        await seed.start()
        seed.upload_server.limiter = mod["common.rate"].TokenBucket(
            CPU_UPLOAD_BPS, burst=2 * CPU_PIECE)
        addr = scfg.SeedPeerAddr(host_id=seed.host_info().id,
                                 ip="127.0.0.1", rpc_port=seed.rpc.port,
                                 download_port=seed.upload_server.port)
        sched_cfg = scfg.SchedulerConfig(seed_peers=[addr])
        sched_cfg.listen_ip = "127.0.0.1"
        sched = mod["scheduler.server"].Scheduler(sched_cfg)
        await sched.start()
        replicas = []
        for n in ("r0", "r1"):
            d = mod["daemon.daemon"].Daemon(daemon_cfg(
                n, scheduler=dcfg.SchedulerConfig(addresses=[sched.address])))
            d.topology = dataclasses.replace(d.topology, pod="trace-pod")
            await d.start()
            replicas.append(d)
        try:
            await asyncio.gather(*(
                _drain(d.ptm.start_file_task(msg.DownloadRequest(
                    url="file://" + path, timeout_s=120.0,
                    url_meta=msg.UrlMeta(shards=names),
                    shard_manifest=manifest, disable_back_source=True)))
                for d in replicas))
        finally:
            for d in replicas:
                await d.stop()
            await sched.stop()
            await seed.stop()

    source = mod["source"]
    previous = source.client_for("file://")
    source.register_client("file", SlowOrigin())
    conductor.on_piece_from_source = traced_src
    conductor.on_span_from_peer = traced_peer
    dispatcher.announce = traced_announce
    try:
        asyncio.run(asyncio.wait_for(main(), 120.0))
    finally:
        source.register_client("file", previous)
        conductor.on_piece_from_source = land_src
        conductor.on_span_from_peer = land_peer
        dispatcher.announce = announce
    order = sorted(t["seed"], key=t["seed"].get)
    tail = order[-CPU_TAIL:]
    last = t["seed"][order[-1]]
    out = {"package": pkg, "pieces": CPU_PIECES,
           "seed_pull_s": last - t["seed"][order[0]],
           "tail_after_seed_s": max(max(v.values())
                                    for v in t["landed"].values()) - last,
           "pieces_tail": tail, "announce_s": [], "landed_s": []}
    for book, key in ((t["announce"], "announce_s"),
                      (t["landed"], "landed_s")):
        out[key] = [[round(book[r][n] - t["seed"][n], 4)
                     if n in book[r] else None for n in tail]
                    for r in sorted(book)]
    print(json.dumps(out), flush=True)
    return out


async def _drain(frames) -> None:
    async for _ in frames:
        pass


def _without_health(daemon_config):
    def make(*a, **kw):
        cfg = daemon_config(*a, **kw)
        cfg.health.enabled = False
        return cfg
    return make


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--trace-from", type=int, default=1 << 30,
                    help="trace pieces numbered this and up (default none)")
    ap.add_argument("--cpu-pod", choices=("ref", "port"), default="",
                    help="run the CPU pod through this package instead")
    ap.add_argument("--health-plane", choices=("on", "off", "alternate"),
                    default="on",
                    help="the replicas' health plane, per run")
    args = ap.parse_args()
    if args.cpu_pod:
        workdir = tempfile.mkdtemp(prefix="sharded-trace-cpu-")
        try:
            cpu_pod(args.cpu_pod, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        return 0
    cs.phase_device()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    trace(args.trace_from)
    if args.trace_from < (1 << 30):
        os.environ[TAIL_ENV] = str(args.trace_from)
        cs.p2p_child = traced_child   # phase 9 spawns this as its child
    layout = cs.llama_layout(9)
    header, nbytes = cs.safetensors_header(layout)
    workdir = tempfile.mkdtemp(prefix="sharded-trace-")
    failed = 0
    try:
        buf = cs.seeded_bytes(np.random.default_rng(0), nbytes)
        ref = cs.phase_sink(buf, 0, device)
        path = os.path.join(workdir, "model-00001-of-00004.safetensors")
        with open(path, "wb") as f:
            f.write(header)
            f.write(memoryview(buf))
            os.fsync(f.fileno())
        del buf
        daemon_config = cs.DaemonConfig
        for i in range(args.runs):
            plane = args.health_plane
            if plane == "alternate":
                plane = "on" if i % 4 in (0, 3) else "off"
            cs.DaemonConfig = (daemon_config if plane == "on"
                               else _without_health(daemon_config))
            say(f"run {i} (health plane {plane})")
            try:
                cs.phase_sharded(workdir, path, header, ref, layout, device)
                say(f"run {i}: ok")
            except cs.CheckFailed as exc:
                failed += 1
                say(f"run {i}: check failed: {exc}")
            shutil.rmtree(os.path.join(workdir, "sharded"),
                          ignore_errors=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
