"""Stress tool: concurrent download load with a latency histogram.

Counterpart of ``dragonfly2_tpu/tools/stress.py`` (reference
``test/tools/stress/main.go``): N workers hammer a URL (directly or
through a daemon's proxy) for a duration, then report request, error and
shed counts, throughput and latency percentiles, overall and per QoS
class. One JSON line on stdout so harnesses can parse it.

Usage:
    python -m dragonfly2_tpu_torch.tools.stress --url http://origin/blob \\
        [--proxy http://127.0.0.1:65001] [-c 16] [-d 10] \\
        [--priority critical:2 --priority bulk:6] [--tenant T] \\
        [--chaos 'piece.wire=delay:0.2:n=-1' | --byzantine [PCT]] \\
        [--chaos-target http://127.0.0.1:UPLOAD_PORT] \\
        [--pod-report h:p,h:p] [--ctrl-report h:p] [--fleet-report h:p] \\
        [--pex-dump http://h:UPLOAD_PORT]

``--chaos`` arms a faultgate script (``common/faultgate.py`` syntax) for
the run and disarms it after, on the ``--chaos-target`` daemon's
``/debug/faults`` (which needs ``upload.debug_endpoints: true``) or, with
no target, in this process only. ``--byzantine PCT`` adds
``upload.serve=corrupt:pct=PCT:n=-1``: the target serves corrupt bytes in
a deterministic PCT % of its ranges, and the report gains the per-parent
corrupt verdicts swept from the ``--pod-report`` daemons. The other
attachments are the podscope pod summary, the scheduler's ``/debug/ctrl``
and compact ``/debug/fleet``, and a daemon's ``/debug/pex``.
``--rollout N --shard-manifest M`` runs one sharded-rollout wave instead:
N clients each pull a disjoint subset of the manifest's shards as ranged
GETs.

The load runs on the port's HTTP client (``source/http_client.py``), a
fresh one for each event loop the tool runs, closed at its end, where
the reference opens an aiohttp session.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time

from ..source.http_client import HTTPSourceClient, json_body


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile on a pre-sorted list (the reference's
    histogram reports the same P50/P90/P95/P99 cut points)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def parse_class_mix(specs: list[str], concurrency: int) -> list[tuple]:
    """``--priority`` specs -> per-class worker allocation.

    Each spec is ``class`` or ``class:workers`` (class from the pinned
    PRIORITY_CLASSES vocabulary). With no spec every worker runs
    classless. Workers left unallocated by explicit counts run as
    ``standard``."""
    from ..idl.messages import PRIORITY_CLASSES
    if not specs:
        return [("", concurrency)]
    out: list[tuple] = []
    used = 0
    for spec in specs:
        cls, _, n = spec.partition(":")
        if cls not in PRIORITY_CLASSES:
            raise SystemExit(
                f"stress: unknown class {cls!r} in --priority "
                f"(known: {list(PRIORITY_CLASSES)})")
        workers = int(n) if n else 1
        out.append((cls, workers))
        used += workers
    if used < concurrency:
        out.append(("standard", concurrency - used))
    return out


def _class_stats() -> dict:
    return {"requests": 0, "errors": 0, "shed": 0, "bytes": 0,
            "latencies": []}


async def run_stress(url: str, *, proxy: str = "", concurrency: int = 8,
                     duration_s: float = 10.0,
                     connect_timeout_s: float = 10.0,
                     tenant: str = "",
                     class_mix: list[tuple] | None = None) -> dict:
    deadline = time.monotonic() + duration_s
    mix = class_mix or [("", concurrency)]
    per_class: dict[str, dict] = {}
    # a server that stalls mid-body (what a stress tool exists to expose)
    # must count as an error, not hang the run past its deadline
    read_s = max(duration_s, 10.0)

    async def worker(client: HTTPSourceClient, cls: str) -> None:
        stats = per_class.setdefault(cls or "", _class_stats())
        headers = {}
        if cls:
            headers["X-Dragonfly-Class"] = cls
        if tenant:
            headers["X-Dragonfly-Tenant"] = tenant
        while time.monotonic() < deadline:
            t0 = time.monotonic()
            try:
                resp = await client.request(
                    "GET", url, headers, proxy=proxy,
                    connect_s=connect_timeout_s, read_s=read_s)
                got = 0
                try:
                    async for chunk in resp.chunks(1 << 20):
                        got += len(chunk)
                finally:
                    resp.close()
                if resp.status == 429:
                    # the QoS shed path (brownout / tenant quota): counted
                    # apart from errors, and Retry-After honored
                    stats["shed"] += 1
                    retry = resp.headers.get("Retry-After", "")
                    pause = (float(retry) if retry.strip().isdigit()
                             else 0.5)
                    await asyncio.sleep(min(pause, max(
                        deadline - time.monotonic(), 0.0)))
                elif resp.status not in (200, 206):
                    stats["errors"] += 1
                else:
                    stats["bytes"] += got
                    stats["latencies"].append(time.monotonic() - t0)
            except Exception:  # noqa: BLE001 - counted, load goes on
                stats["errors"] += 1
            stats["requests"] += 1

    client = HTTPSourceClient()
    try:
        t0 = time.monotonic()
        workers = [worker(client, cls) for cls, n in mix for _ in range(n)]
        await asyncio.gather(*workers)
        elapsed = time.monotonic() - t0
    finally:
        await client.close()

    latencies = sorted(lat for s in per_class.values()
                       for lat in s["latencies"])
    classes = {}
    for cls, s in per_class.items():
        lats = sorted(s.pop("latencies"))
        classes[cls or "unclassed"] = {
            **s,
            "latency_ms": {
                "p50": round(_percentile(lats, 0.50) * 1000, 1),
                "p99": round(_percentile(lats, 0.99) * 1000, 1),
            },
        }
    result = {
        "url": url,
        "concurrency": concurrency,
        "duration_s": round(elapsed, 2),
        "requests": sum(s["requests"] for s in classes.values()),
        "errors": sum(s["errors"] for s in classes.values()),
        "shed": sum(s["shed"] for s in classes.values()),
        "bytes": sum(s["bytes"] for s in classes.values()),
        "throughput_gbps": round(
            sum(s["bytes"] for s in classes.values()) / 1e9
            / max(elapsed, 1e-9), 4),
        "latency_ms": {
            "p50": round(_percentile(latencies, 0.50) * 1000, 1),
            "p90": round(_percentile(latencies, 0.90) * 1000, 1),
            "p95": round(_percentile(latencies, 0.95) * 1000, 1),
            "p99": round(_percentile(latencies, 0.99) * 1000, 1),
        },
    }
    if tenant:
        result["tenant"] = tenant
    if len(classes) > 1 or "" not in per_class:
        # per-class breakdown only when the run was actually classed
        result["classes"] = classes
    return result


async def run_rollout(url: str, *, proxy: str = "", workers: int = 4,
                      manifest_path: str = "",
                      connect_timeout_s: float = 10.0) -> dict:
    """One sharded-checkpoint rollout wave: ``workers`` clients each pull
    a disjoint subset of the manifest's shards (round-robin split) as
    ranged GETs through the proxy, recording per-shard ready times. The
    report carries per-shard fetch p50/p99 and the wave's
    time-to-all-shards makespan."""
    # dflint: disable=DF001 — one KB-scale manifest read on stress's CLI-private loop
    with open(manifest_path, encoding="utf-8") as f:
        raw = json.load(f)
    entries = raw.get("shards", raw) if isinstance(raw, dict) else raw
    if not entries:
        raise SystemExit("stress: empty shard manifest")
    subsets = {i: entries[i::workers] for i in range(workers)}
    shard_lat: dict[str, float] = {}
    ready_at: dict[str, float] = {}
    errors = 0
    total_bytes = 0

    t_start = time.monotonic()

    async def worker(client: HTTPSourceClient, i: int) -> None:
        nonlocal errors, total_bytes
        for e in subsets[i]:
            start = int(e["range_start"])
            end = start + int(e["range_size"]) - 1
            t0 = time.monotonic()
            try:
                resp = await client.request(
                    "GET", url, {"Range": f"bytes={start}-{end}"},
                    proxy=proxy, connect_s=connect_timeout_s)
                got = 0
                try:
                    async for chunk in resp.chunks(1 << 20):
                        got += len(chunk)
                finally:
                    resp.close()
                if resp.status != 206 or got != int(e["range_size"]):
                    # a 200 full-body answer means the server ignored the
                    # Range: every "shard" would be the whole checkpoint,
                    # so it counts as an error
                    errors += 1
                    continue
                total_bytes += got
                shard_lat[e["name"]] = time.monotonic() - t0
                ready_at[e["name"]] = time.monotonic() - t_start
            except Exception:  # noqa: BLE001 - counted, wave goes on
                errors += 1

    client = HTTPSourceClient()
    try:
        await asyncio.gather(*(worker(client, i) for i in range(workers)))
    finally:
        await client.close()
    elapsed = time.monotonic() - t_start
    lats = sorted(shard_lat.values())
    return {
        "url": url,
        "rollout_workers": workers,
        "shards": len(entries),
        "shards_ready": len(ready_at),
        "errors": errors,
        "bytes": total_bytes,
        "makespan_s": round(max(ready_at.values(), default=0.0), 3),
        "duration_s": round(elapsed, 2),
        "shard_fetch_ms": {
            "p50": round(_percentile(lats, 0.50) * 1000, 1),
            "p99": round(_percentile(lats, 0.99) * 1000, 1),
        },
        "per_worker_shards": {i: [e["name"] for e in subsets[i]]
                              for i in range(workers)},
    }


async def _run_with_chaos(args) -> dict:
    """Arm the chaos script (remote daemon or in-process), run the load,
    always disarm: a stress run must not leave a live daemon wedged."""
    from ..common import faultgate

    if getattr(args, "byzantine", None):
        # --byzantine PCT: the target daemon becomes a poisoner, flipping
        # bytes in PCT % of the ranges it serves (site upload.serve,
        # deterministic striding), so the pod's verdict and quarantine
        # plane meet a live poisoner
        clause = f"upload.serve=corrupt:pct={int(args.byzantine)}:n=-1"
        args.chaos = f"{args.chaos};{clause}" if args.chaos else clause
        if not args.chaos_target:
            raise SystemExit("stress: --byzantine needs --chaos-target "
                             "http://daemon:upload_port (the daemon that "
                             "will serve corrupt bytes)")
    target = args.chaos_target.rstrip("/")
    session = None
    try:
        if args.chaos and target:
            session = HTTPSourceClient()
            resp = await session.request("POST", f"{target}/debug/faults",
                                         body=args.chaos.encode())
            text = (await resp.read()).decode("utf-8", "replace")
            if resp.status != 200:
                raise SystemExit(
                    f"chaos arm failed: HTTP {resp.status} {text} (is "
                    f"upload.debug_endpoints on?)")
        elif args.chaos:
            # in-process arming only matters when fabric code runs in THIS
            # process (run_stress issues plain HTTP GETs, which cross no
            # faultgate site): without a target the script is almost
            # certainly meant for a daemon, so say so loudly
            print("warning: --chaos without --chaos-target arms faults in "
                  "this process only; a separate daemon is NOT affected "
                  "(pass --chaos-target http://daemon:upload_port)",
                  file=sys.stderr)
            faultgate.arm_script(args.chaos)
        return await run_stress(
            args.url, proxy=args.proxy, concurrency=args.concurrency,
            duration_s=args.duration, tenant=args.tenant,
            class_mix=parse_class_mix(args.priority, args.concurrency))
    finally:
        if session is not None:
            try:
                resp = await session.request("DELETE",
                                             f"{target}/debug/faults")
                await resp.read()
            finally:
                await session.close()
        elif args.chaos:
            faultgate.reset()


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="dfstress", description="concurrent download load generator")
    p.add_argument("--url", required=True)
    p.add_argument("--proxy", default="",
                   help="http proxy (the daemon's mirror), e.g. "
                        "http://127.0.0.1:65001")
    p.add_argument("-c", "--concurrency", type=int, default=8)
    p.add_argument("-d", "--duration", type=float, default=10.0)
    p.add_argument("--tenant", default="",
                   help="tenant the load is accounted to "
                   "(X-Dragonfly-Tenant on every request)")
    p.add_argument("--priority", action="append", default=[],
                   metavar="CLASS[:WORKERS]",
                   help="mixed-class load: allocate workers to a QoS "
                   "class (critical/standard/bulk), repeatable — e.g. "
                   "'--priority critical:2 --priority bulk:6'. The "
                   "report then breaks out per-class p50/p99 latency "
                   "and 429-shed counts. Unallocated workers run as "
                   "standard; with no --priority the run is classless.")
    p.add_argument("--rollout", type=int, default=0, metavar="WORKERS",
                   help="sharded-rollout scenario: WORKERS clients each "
                   "pull a disjoint subset of --shard-manifest's shards "
                   "as ranged GETs (one wave, not duration-based); the "
                   "report carries per-shard fetch p50/p99 and the "
                   "wave's time-to-all-shards makespan")
    p.add_argument("--shard-manifest", default="", dest="shard_manifest",
                   help="shard-manifest JSON path for --rollout "
                   "(same schema as dfget --shard-manifest)")
    p.add_argument("--chaos", default="",
                   help="faultgate script to arm for the run, e.g. "
                        "'piece.wire=delay:0.2:n=-1' (docs/RESILIENCE.md)")
    p.add_argument("--byzantine", nargs="?", const=30, type=int,
                   default=None, metavar="PCT",
                   help="arm the --chaos-target daemon as a byzantine "
                        "poisoner: corrupt PCT%% (default 30) of the "
                        "ranges it serves (site upload.serve), disarmed "
                        "after the run. The report gains per-parent "
                        "corrupt-verdict counts swept from the "
                        "--pod-report daemons' /debug/verdicts — the "
                        "live proof the quarantine plane engaged")
    p.add_argument("--chaos-target", default="",
                   help="daemon debug base URL (http://host:upload_port); "
                        "the script is POSTed to /debug/faults there and "
                        "disarmed after the run")
    p.add_argument("--pex-dump", default="",
                   help="daemon upload base URL (http://host:upload_port); "
                        "after the run, attach its /debug/pex snapshot "
                        "(gossip membership + swarm index) to the report — "
                        "pairs with --chaos 'pex.gossip=...' runs")
    p.add_argument("--ctrl-report", default="",
                   help="scheduler debug host:port (the --debug-port); "
                        "after the run, attach its /debug/ctrl snapshot "
                        "(rulings/sec, worst ruling phase, bytes of "
                        "scheduler state) so the report says what the "
                        "control plane spent, not just what this "
                        "client saw")
    p.add_argument("--fleet-report", default="",
                   help="scheduler debug host:port (the --debug-port); "
                        "after the run, attach its compact /debug/fleet "
                        "snapshot (pulse rollups, anomaly counts, active "
                        "episodes, incident ids) so a stress/chaos report "
                        "says what the FLEET's telemetry plane saw, not "
                        "just what this client measured")
    p.add_argument("--pod-report", default="",
                   help="comma-separated daemon upload host:port set; "
                        "after the run, attach the podscope pod summary "
                        "(distribution-tree depth, makespan, origin "
                        "amplification, bottleneck edge, breaches) so a "
                        "stress/chaos report says what the POD did, not "
                        "just what this client saw")
    args = p.parse_args(argv)
    if args.rollout:
        if not args.shard_manifest:
            raise SystemExit("stress: --rollout needs --shard-manifest")
        result = asyncio.run(run_rollout(
            args.url, proxy=args.proxy, workers=args.rollout,
            manifest_path=args.shard_manifest))
        if args.pod_report:
            result["podscope"] = _pod_report(args.pod_report)
        if args.ctrl_report:
            result["ctrl"] = _ctrl_report(args.ctrl_report)
        if args.fleet_report:
            result["fleet"] = _fleet_report(args.fleet_report)
        print(json.dumps(result))
        return 1 if result["shards_ready"] == 0 else 0
    result = asyncio.run(_run_with_chaos(args))
    if args.chaos:
        result["chaos"] = args.chaos
    if args.pex_dump:
        result["pex"] = asyncio.run(_fetch_pex(args.pex_dump.rstrip("/")))
    if args.pod_report:
        result["podscope"] = _pod_report(args.pod_report)
    if args.ctrl_report:
        result["ctrl"] = _ctrl_report(args.ctrl_report)
    if args.fleet_report:
        result["fleet"] = _fleet_report(args.fleet_report)
    if args.byzantine:
        result["byzantine"] = {
            "pct": int(args.byzantine),
            "target": args.chaos_target,
            # per-parent corrupt counts as the downloaders saw them: who
            # recorded verdicts against whom, and who got shunned
            "verdicts": _verdict_report(args.pod_report),
        }
    print(json.dumps(result))
    return 1 if result["requests"] == result["errors"] else 0


def _verdict_report(pod: str) -> dict:
    """Per-parent corrupt-verdict counts swept from each daemon's
    ``/debug/verdicts`` (the ``--byzantine`` report body). Diagnostics
    must not fail a run; no pod set means nothing to sweep. A direct
    sweep: podscope's compaction drops the per-parent counts this report
    exists to show."""
    if not pod:
        return {"note": "pass --pod-report to sweep /debug/verdicts"}
    import urllib.error
    import urllib.request

    out: dict = {}
    for addr in (a.strip() for a in pod.split(",") if a.strip()):
        try:
            with urllib.request.urlopen(
                    f"http://{addr}/debug/verdicts", timeout=5.0) as resp:
                snap = json.loads(resp.read())
        except (OSError, ValueError) as exc:
            out[addr] = {"error": str(exc) or type(exc).__name__}
            continue
        parents = snap.get("parents") or {}
        out[addr] = {
            "self_quarantined": snap.get("self_quarantined", False),
            "corrupt": {p: row.get("codes", {}).get("corrupt", 0)
                        for p, row in parents.items()
                        if row.get("codes", {}).get("corrupt")},
            "shunned": [p for p, row in parents.items()
                        if row.get("shunned")],
        }
    return out


def _fleet_report(scheduler: str) -> dict:
    """Compact fleet-pulse snapshot for the stress report (``dfdiag
    --fleet``'s ``/debug/fleet?compact=1``, further compacted): pulse
    rollups, anomaly counts, active episodes and incident ids.
    Diagnostics must not fail a run."""
    try:
        from .dfdiag import _get
        snap = _get(f"http://{scheduler}/debug/fleet?compact=1",
                    timeout_s=5.0)
        return {
            "daemons": snap.get("daemons", 0),
            "ingested": snap.get("ingested", 0),
            "ignored": snap.get("ignored", 0),
            "fleet": snap.get("fleet"),
            "anomaly_counts": snap.get("anomaly_counts"),
            "active": snap.get("active"),
            "incidents": snap.get("incidents", 0),
            "incident_ids": snap.get("incident_ids"),
        }
    except Exception as exc:  # noqa: BLE001 - diagnostics must not fail a run
        return {"error": str(exc)}


def _ctrl_report(scheduler: str) -> dict:
    """Control-plane snapshot for the stress report (``dfdiag --ctrl``'s
    ``/debug/ctrl``, compacted): rulings/sec, the worst phase by total
    self time, and state bytes. Diagnostics must not fail a run."""
    try:
        from .dfdiag import fetch_ctrl
        snap = fetch_ctrl(scheduler, timeout_s=5.0)
        phases = snap.get("phases") or {}
        worst = (max(phases, key=lambda n: phases[n]["self_ms"])
                 if phases else "")
        rul = snap.get("rulings") or {}
        return {
            "armed": snap.get("armed"),
            "rulings": rul.get("total", 0),
            "rulings_per_sec_busy": rul.get("per_sec_busy", 0.0),
            "rulings_per_sec_60s": rul.get("per_sec_60s", 0.0),
            "worst_phase": worst,
            "worst_phase_ms": (phases[worst]["self_ms"] if worst else 0.0),
            "queue_wait_ms": snap.get("queue_wait_ms"),
            "state_bytes": snap.get("state_bytes"),
        }
    except Exception as exc:  # noqa: BLE001 - diagnostics must not fail a run
        return {"error": str(exc)}


def _pod_report(pod: str) -> dict:
    """Podscope summary for the stress report: compact per-task numbers,
    the breach list and the verdict (diagnostics must not fail a run)."""
    from ..common import podscope
    try:
        addrs = [a.strip() for a in pod.split(",") if a.strip()]
        report = podscope.aggregate(podscope.collect_pod(addrs))
        return {
            "tasks": {tid: podscope.bench_summary(t)
                      for tid, t in report["tasks"].items()},
            "unreachable": report["unreachable"],
            "breaches": report["breaches"],
            "verdict": report["verdict"],
        }
    except Exception as exc:  # noqa: BLE001 - diagnostics must not fail a run
        return {"error": str(exc)}


async def _fetch_pex(base: str) -> dict:
    """A daemon's ``/debug/pex``, parsed as aiohttp's ``resp.json()``
    parses it (``json_body``: a body not typed as JSON is an error)."""
    url = f"{base}/debug/pex"
    client = HTTPSourceClient()
    try:
        resp = await client.request("GET", url, timeout_s=5.0)
        body = await resp.read()
        return json_body(resp.status, resp.headers, body, url)
    except Exception as exc:  # noqa: BLE001 - diagnostics must not fail a run
        return {"error": str(exc)}
    finally:
        await client.close()


if __name__ == "__main__":
    sys.exit(main())
