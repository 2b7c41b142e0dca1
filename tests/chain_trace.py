"""Phase 11 of ``chip_smoke.py`` alone, repeated: where a chain's tail goes.

    python3 tests/chain_trace.py [--runs 3] [--pace 250000000] [--rulings]

Writes phase 8's origin (the Llama-3-8B layout's ``lm_head`` and final
norm, 1,050,681,344 tensor bytes, seeded) into a temporary directory,
serves it from the smoke's standard-library HTTP origin, and pulls it
through the chain origin -> seed -> L1 -> L2 -> L3 with the relay on and
off in turns (on, off, off, on, ...), ``--runs`` of each, on the first
CUDA card. Each run prints one line: phase 11's line (the makespan and,
per daemon, its first and last landing, its flight's ``done`` and, for
leechers, ``result()``, in seconds from the origin's first body byte;
each leecher's parents and relayed serves), or the check that failed. A
failed check does not stop the trace; the script exits 1 when any run
had one. With ``--rulings``, each line also carries the scheduler's
offers (seconds into the run, peer, kind, parents), its back-source
rulings and the failed piece reports (peer, parent, fail code, code), by
hostname. A run that outlasts ``--run-limit`` seconds dumps every
thread's stack and ends the script.
"""

import argparse
import faulthandler
import json
import multiprocessing
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
from dragonfly2_tpu_torch.scheduler import service  # noqa: E402


def trace_rulings(rulings: list) -> None:
    """Record the scheduler's offers, back-source rulings and failed
    piece reports into ``rulings`` as they happen."""
    def host_of(peer) -> str:
        return peer.host.msg.hostname

    offer = service.SchedulerService._offer
    piece = service.SchedulerService._handle_piece_result
    back = service.SchedulerService._rule_back_source

    def traced_offer(self, peer, parents, kind):
        rulings.append((time.monotonic(), host_of(peer), kind,
                        [host_of(p) for p in parents]))
        return offer(self, peer, parents, kind)

    def traced_back(self, peer):
        rulings.append((time.monotonic(), host_of(peer), "back_source",
                        [peer.report_fail_count]))
        return back(self, peer)

    async def traced_piece(self, peer, result):
        if not result.success:
            up = peer.task.peers.get(result.dst_peer_id)
            rulings.append((time.monotonic(), host_of(peer), "fail",
                            [host_of(up) if up else result.dst_peer_id,
                             result.fail_code, result.code]))
        return await piece(self, peer, result)

    service.SchedulerService._offer = traced_offer
    service.SchedulerService._rule_back_source = traced_back
    service.SchedulerService._handle_piece_result = traced_piece


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--pace", type=int, default=cs.CHAIN_PACE_BPS)
    ap.add_argument("--rulings", action="store_true")
    ap.add_argument("--run-limit", type=float, default=120.0)
    args = ap.parse_args()
    rulings: list = []
    if args.rulings:
        trace_rulings(rulings)
    any_failed = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    work = tempfile.mkdtemp(prefix="chain-trace-")
    try:
        layout = cs.deploy_layout()
        header, nbytes = cs.safetensors_header(layout)
        buf = cs.seeded_bytes(np.random.default_rng(0), nbytes)
        fname = "model-00004-of-00004.safetensors"
        path = os.path.join(work, fname)
        with open(path, "wb") as f:
            f.write(header)
            f.write(memoryview(buf))
        ref = torch.frombuffer(buf, dtype=torch.uint8).to(device)
        manifest = cs.manifest_from_file(path)
        size = os.path.getsize(path)
        ctx = multiprocessing.get_context("spawn")
        conn, child_conn = ctx.Pipe()
        origin = ctx.Process(target=cs.http_origin_child,
                             args=(path, args.pace, child_conn))
        origin.start()
        try:
            base = f"http://127.0.0.1:{conn.recv()['port']}"
            order = [True, False, False, True] * ((args.runs + 1) // 2)
            for i, relay in enumerate(order[:2 * args.runs]):
                d = os.path.join(work, f"run{i}")
                t_first = time.monotonic()
                faulthandler.dump_traceback_later(args.run_limit, exit=True)
                try:
                    line = cs.chain_run(d, f"{base}/{fname}", manifest,
                                        relay, conn, size, ref, len(header),
                                        dict(layout), device)
                except cs.CheckFailed as exc:
                    any_failed = True
                    conn.send("report")      # restart the origin's tally
                    conn.recv()
                    line = {"mode": "relay" if relay
                            else "store-and-forward",
                            "failed_check": str(exc)}
                finally:
                    faulthandler.cancel_dump_traceback_later()
                    shutil.rmtree(d, ignore_errors=True)
                print(json.dumps({"run": i, **line, "rulings": [
                    (round(t - t_first, 4), *r) for t, *r in rulings]}),
                    flush=True)
                rulings.clear()
            conn.send("stop")
        finally:
            origin.join(timeout=30)
            if origin.is_alive():
                origin.terminate()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if any_failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
