"""Phase 9 of ``chip_smoke.py`` alone, repeated, with a per-piece trace.

    python3 tests/sharded_trace.py [--runs 3] [--trace-from 0]

Needs one CUDA card. Builds phase 2's reference tensor and phase 6's
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

Only pieces numbered ``--trace-from`` and up are traced, and every swap
piece the seed serves. A check that fails is printed and the next run
goes on; the exit code is 1 when any run failed.
"""

import argparse
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

T0 = time.monotonic()


def say(line: str) -> None:
    print(f"{time.monotonic() - T0:.3f} {line}", flush=True)


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

    def traced_packet(self, request, ts, infos):
        nums = [i.piece_num for i in infos if i.piece_num >= tail]
        if nums:
            say(f"SYNC {request.dst_peer_id[-6:]} -> "
                f"{request.src_peer_id[-6:]} {nums}")
        return packet(self, request, ts, infos)

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--trace-from", type=int, default=1 << 30,
                    help="trace pieces numbered this and up (default none)")
    args = ap.parse_args()
    cs.phase_device()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    trace(args.trace_from)
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
        for i in range(args.runs):
            say(f"run {i}")
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
