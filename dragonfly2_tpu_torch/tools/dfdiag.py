"""dfdiag: fetch a download's flight timeline and explain where time went.

Counterpart of ``dragonfly2_tpu/tools/dfdiag.py``. Reads the flight
recorder's debug surface (``daemon/flight_recorder.py``) and renders an
ASCII waterfall per piece plus a "why was this download slow" verdict.
``--cluster``, ``--ctrl``, ``--decisions`` and ``--fleet`` read a
scheduler's debug port; ``--pod`` sweeps a daemon SET and renders the
podscope distribution tree (``common/podscope.py``): per-edge bytes and
bandwidth, pod makespan, tree depth, origin amplification and a
bottleneck-edge verdict.

Usage:
    python -m dragonfly2_tpu_torch.tools.dfdiag --daemon 10.0.0.4:65002 <task_id>
    python -m dragonfly2_tpu_torch.tools.dfdiag --daemon 10.0.0.4:65002 --list
    python -m dragonfly2_tpu_torch.tools.dfdiag --file flight.json
    python -m dragonfly2_tpu_torch.tools.dfdiag --cluster --scheduler host:port
    python -m dragonfly2_tpu_torch.tools.dfdiag --fleet --scheduler host:port
    python -m dragonfly2_tpu_torch.tools.dfdiag --pod h1:65002,h2:65002 --json
    python -m dragonfly2_tpu_torch.tools.dfdiag --daemon 10.0.0.4:65002 --qos

Exit codes: 0 healthy, 1 fetch or IO failure, 2 usage, 3 the verdict
names an SLO breach, a straggler bottleneck, a pod-level breach or (with
``--fleet``) an active anomaly episode, or (with ``--qos``, which reads a
daemon's ``/debug/qos``) a starved ``standard`` or ``critical`` class.

Waterfall legend: ``.`` queue (rate-limiter wait), ``-`` ttfb (request +
parent-side queueing), ``=`` wire transfer, ``#`` HBM staging.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..common.podscope import _fmt_bytes, _get_json

EXIT_OK = 0
EXIT_IO = 1          # a daemon/scheduler could not be reached or parsed
EXIT_USAGE = 2
EXIT_BREACH = 3      # the verdict names an SLO breach or bottleneck

# (stage duration key, bar glyph, human name) — waterfall + verdict order
STAGES = (
    ("queue_ms", ".", "local queueing"),
    ("ttfb_ms", "-", "parent queueing (time to first byte)"),
    ("wire_ms", "=", "wire transfer"),
    ("hbm_ms", "#", "HBM staging"),
)


def _get(url: str, timeout_s: float = 10.0) -> dict:
    return _get_json(url, timeout_s)


def fetch_flight(daemon: str, task_id: str,
                 timeout_s: float = 10.0) -> dict:
    return _get(f"http://{daemon}/debug/flight/{task_id}", timeout_s)


def fetch_index(daemon: str, timeout_s: float = 10.0) -> dict:
    return _get(f"http://{daemon}/debug/flight", timeout_s)


def fetch_cluster(scheduler: str, timeout_s: float = 10.0) -> dict:
    return _get(f"http://{scheduler}/debug/cluster", timeout_s)


def fetch_ctrl(scheduler: str, timeout_s: float = 10.0,
               arm: str = "") -> dict:
    q = f"?arm={arm}" if arm else ""
    return _get(f"http://{scheduler}/debug/ctrl{q}", timeout_s)


def fetch_fleet(scheduler: str, timeout_s: float = 10.0) -> dict:
    return _get(f"http://{scheduler}/debug/fleet", timeout_s)


def render_waterfall(summary: dict, *, width: int = 64) -> str:
    """ASCII waterfall: one row per piece, bars proportional to wall time,
    segmented by stage. Pure function over the /debug/flight summary (or a
    saved copy) so it is testable offline."""
    rows = summary.get("piece_rows") or []
    if not rows:
        return "(no completed pieces recorded)"
    t_lo = min(r["start_ms"] for r in rows)
    t_hi = max(r["start_ms"] + r["total_ms"] for r in rows)
    span = max(t_hi - t_lo, 1e-9)
    scale = width / span
    out = [f"task {summary.get('task_id', '?')[:24]}  "
           f"pieces={summary.get('pieces')}  "
           f"p2p={_fmt_bytes(summary.get('bytes_p2p', 0))}  "
           f"origin={_fmt_bytes(summary.get('bytes_source', 0))}  "
           f"wall={span:.0f}ms",
           f"{'piece':>6} {'parent':>10} |{'':<{width}}| total"]
    for r in rows:
        pad = int((r["start_ms"] - t_lo) * scale)
        bar = ""
        for key, glyph, _ in STAGES:
            bar += glyph * int(round(r.get(key, 0.0) * scale))
        # a piece too fast for one cell still deserves a mark
        bar = (bar or "=")[:max(width - pad, 1)]
        parent = r.get("parent") or "origin"
        out.append(f"{r['piece']:>6} {parent[-10:]:>10} "
                   f"|{' ' * pad}{bar:<{max(width - pad, 1)}}| "
                   f"{r['total_ms']:.0f}ms")
    legend = "  ".join(f"{glyph}={name.split(' (')[0]}"
                       for _, glyph, name in STAGES)
    out.append(f"legend: {legend}")
    return "\n".join(out)


def verdict(summary: dict) -> str:
    """One-paragraph 'why was this download slow' attribution."""
    rows = summary.get("piece_rows") or []
    if not rows:
        rungs = summary.get("rungs") or []
        if rungs:
            return ("verdict: no completed pieces — ladder ran "
                    f"{' -> '.join(rungs)} and ended on "
                    f"'{summary.get('served_rung', '')}'.")
        return "verdict: no completed pieces — nothing to attribute."
    stage_totals = {key: sum(r.get(key, 0.0) for r in rows)
                    for key, _, _ in STAGES}
    grand = sum(stage_totals.values()) or 1e-9
    key = max(stage_totals, key=stage_totals.get)
    name = next(n for k, _, n in STAGES if k == key)
    parts = [f"verdict: {100 * stage_totals[key] / grand:.0f}% of piece "
             f"time went to {name}"]
    slow = summary.get("slowest_piece")
    if slow:
        who = slow.get("parent") or "origin"
        parts.append(f"slowest piece {slow['piece']} took "
                     f"{slow['total_ms']:.0f}ms, dominated by "
                     f"{slow['dominant_stage']} "
                     f"({slow['dominant_ms']:.0f}ms) from {who[-12:]}")
    ratio = summary.get("back_to_source_ratio", 0.0)
    if ratio > 0.5:
        parts.append(f"{100 * ratio:.0f}% of bytes came from origin — the "
                     "mesh barely helped (no parents, or parents too slow)")
    elif ratio > 0:
        parts.append(f"back-to-source ratio {ratio:.2f}")
    per_parent = summary.get("per_parent") or {}
    rates = {p: v.get("throughput_bps", 0)
             for p, v in per_parent.items() if v.get("throughput_bps")}
    if len(rates) > 1:
        worst = min(rates, key=rates.get)
        best = max(rates, key=rates.get)
        if rates[best] > 3 * rates[worst]:
            parts.append(
                f"parent {worst[-12:] or 'origin'} ran at "
                f"{_fmt_bytes(rates[worst])}/s vs {_fmt_bytes(rates[best])}/s"
                f" from {best[-12:] or 'origin'} — a straggler parent")
    tail = summary.get("tail_ms") or {}
    if tail:
        parts.append(f"piece latency p50/p90/p99 = {tail.get('p50')}/"
                     f"{tail.get('p90')}/{tail.get('p99')}ms")
    slo = summary.get("slo_breaches") or {}
    if slo:
        # the health plane's per-stage budget verdict: which configured
        # budget this download blew
        budgets = summary.get("slo_budgets_ms") or {}
        blown = ", ".join(
            f"{n} piece(s) over the {stage} budget"
            + (f" ({budgets[stage]:.0f}ms)" if stage in budgets else "")
            for stage, n in sorted(slo.items()))
        parts.append(f"SLO breach: {blown}")
    rungs = summary.get("rungs") or []
    if rungs:
        # which degradation-ladder rung served this task, and the trail it
        # took to get there
        trail = (f" (ladder: {' -> '.join(rungs)})" if len(rungs) > 1 else "")
        served = summary.get("served_rung", "")
        parts.append(f"served by rung '{served}'" + trail)
        if served == "pex":
            parts.append("every scheduler was unreachable; parents came "
                         "from PEX gossip (the swarm index) instead of "
                         "the origin")
    sh = summary.get("shards")
    if sh:
        # sharded task: per-shard readiness + the tail that set
        # time-to-serving, with its supply path named
        parts.append(f"shards: {sh.get('ready', 0)}/{sh.get('total', 0)} "
                     f"ready ({_fmt_bytes(sh.get('tree_bytes', 0))} "
                     f"tree-fetched, {_fmt_bytes(sh.get('swap_bytes', 0))} "
                     "ICI-swapped)")
        slow_sh = sh.get("slowest")
        if slow_sh:
            how = ("ICI-swapped from co-located replicas"
                   if slow_sh.get("src") == "swap"
                   else "tree-fetched (this host's assigned subset)")
            parts.append(f"slowest shard {slow_sh['name']} became ready "
                         f"at {slow_sh['t_ms']:.0f}ms — {how}")
        fb = sh.get("fallbacks", 0)
        if fb:
            parts.append(
                f"{fb} swap-class piece(s) fell back to the tree after "
                "the swap hold — the ICI swap partner died or stalled "
                "(bounded degradation, not a wedge)")
    corrupt = summary.get("corrupt_pieces") or {}
    if corrupt:
        total = sum(corrupt.values())
        worst = max(corrupt, key=corrupt.get)
        parts.append(
            f"{total} transfer(s) failed digest verification and were "
            f"refetched — worst sender {worst[-12:] or 'origin'} "
            f"({corrupt[worst]}); a repeat offender here is a corrupting "
            "parent (bad NIC/disk), not congestion")
    fails = summary.get("fail_codes") or {}
    noncorrupt = {c: n for c, n in fails.items() if c != "corrupt"}
    if noncorrupt:
        parts.append("failed fetches by kind: " + ", ".join(
            f"{c}x{n}" for c, n in sorted(noncorrupt.items())))
    for addr in summary.get("quarantined_parents") or []:
        parts.append(
            f"parent {addr} was locally QUARANTINED mid-task on corrupt "
            "verdicts (the verdict ledger shuns it for every task on "
            "this daemon; the scheduler's registry handles the pod)")
    drops = summary.get("report_drops", 0)
    if drops:
        parts.append(f"{drops} piece reports dropped on a dead scheduler "
                     "stream — the scheduler undercounts this peer")
    return ";\n  ".join(parts) + "."


def render_cluster(snapshot: dict) -> str:
    """Tabular view of the scheduler's pod-wide health snapshot."""
    out = [f"cluster: p2p={_fmt_bytes(snapshot.get('bytes_p2p', 0))}  "
           f"origin={_fmt_bytes(snapshot.get('bytes_source', 0))}  "
           f"back-to-source={snapshot.get('back_to_source_ratio', 0.0):.2%}"]
    hosts = snapshot.get("hosts") or {}
    if hosts:
        out.append(f"{'host':<28} {'pieces':>7} {'served':>7} "
                   f"{'serve-ms':>9} {'fails':>6} {'flights':>8}")
        for hid, h in sorted(hosts.items()):
            out.append(f"{hid[-28:]:<28} {h['pieces_down']:>7} "
                       f"{h['pieces_served']:>7} {h['mean_serve_ms']:>9.1f} "
                       f"{h['fails']:>6} {h['flights']:>8}")
    stragglers = snapshot.get("stragglers") or []
    for s in stragglers:
        out.append(f"STRAGGLER {s['host_id'][-28:]}: mean serve "
                   f"{s['mean_serve_ms']:.0f}ms — {s['slowdown']}x the "
                   f"cluster median over {s['pieces_served']} pieces")
    if not stragglers:
        out.append("no straggler parents")
    return "\n".join(out)


def render_ctrl(snap: dict) -> str:
    """Tabular view of the scheduler's control-plane observatory
    (/debug/ctrl): rulings/sec, per-kind and per-phase latency, the
    queue-wait vs compute split, and bytes-of-state per component. Pure
    function over the snapshot so it is testable offline."""
    rul = snap.get("rulings") or {}
    out = [f"ctrl: armed={snap.get('armed')}  "
           f"rulings={rul.get('total', 0)}  "
           f"{rul.get('per_sec_busy', 0.0)}/s busy  "
           f"{rul.get('per_sec_60s', 0.0)}/s last-60s  "
           f"compute={snap.get('compute_ms', 0.0)}ms  "
           f"unattributed={snap.get('unattributed_ms', 0.0)}ms"]
    qw = snap.get("queue_wait_ms")
    if qw:
        out.append(f"queue-wait: n={qw['count']} mean={qw['mean_ms']}ms "
                   f"p50={qw['p50_ms']}ms p99={qw['p99_ms']}ms "
                   f"max={qw['max_ms']}ms")
    def _hdr(col: str) -> str:
        return (f"{col:<12} {'count':>8} {'self-ms':>10} {'mean-ms':>9} "
                f"{'p50-ms':>9} {'p99-ms':>9} {'max-ms':>9}")

    kinds = rul.get("by_kind") or {}
    if kinds:
        out.append(_hdr("ruling"))
        for kind, r in sorted(kinds.items()):
            out.append(f"{kind:<12} {r['count']:>8} {r['self_ms']:>10} "
                       f"{r['mean_ms']:>9} {r['p50_ms']:>9} "
                       f"{r['p99_ms']:>9} {r['max_ms']:>9}")
    phases = snap.get("phases") or {}
    if phases:
        out.append(_hdr("phase"))
        for name, r in sorted(phases.items()):
            out.append(f"{name:<12} {r['count']:>8} {r['self_ms']:>10} "
                       f"{r['mean_ms']:>9} {r['p50_ms']:>9} "
                       f"{r['p99_ms']:>9} {r['max_ms']:>9}")
    if not kinds and not phases:
        out.append("(no rulings profiled — arm with "
                   "GET /debug/ctrl?arm=1 or dfdiag --ctrl --arm on)")
    state = snap.get("state_bytes") or {}
    if state:
        out.append(
            f"state: {_fmt_bytes(state.get('total', 0))} across "
            f"{state.get('peers', 0)} peers "
            f"({_fmt_bytes(state.get('per_peer', 0))}/peer; "
            f"staleness {snap.get('state_staleness_s', 0.0)}s of "
            f"{snap.get('state_ttl_s', 0.0)}s ttl)")
        comps = state.get("components") or {}
        out.append("  " + "  ".join(
            f"{name}={_fmt_bytes(b)}"
            for name, b in sorted(comps.items())))
    recov = snap.get("recovery")
    if recov is not None:
        if recov.get("recovered"):
            parts = [f"recovery: warm (gap {recov.get('gap_s', 0.0)}s)"]
            rcomps = recov.get("components") or {}
            if rcomps:
                parts.append("  " + "  ".join(
                    f"{name}={sub.get('restored', 0)} restored"
                    + ("" if sub.get("present", True) else " [absent]")
                    for name, sub in sorted(rcomps.items())))
            out.extend(parts)
        else:
            out.append("recovery: cold boot (no usable snapshot)")
    model = snap.get("model")
    if model is not None:
        ev = model.get("evaluator") or {}
        served = ev.get("version") or ""
        if served:
            line = (f"model: serving {model.get('model', '?')}@{served}"
                    f"  scored={ev.get('scored', 0)}"
                    f"  fallbacks={ev.get('fallbacks', 0)}")
        elif ev.get("bound"):
            line = (f"model: {model.get('model', '?')} bound (unversioned)"
                    f"  scored={ev.get('scored', 0)}"
                    f"  fallbacks={ev.get('fallbacks', 0)}")
        else:
            line = (f"model: none served — {model.get('model', '?')} "
                    f"ruling on the heuristic floor")
        out.append(line)
        if ev.get("degraded"):
            # the operator-facing name for a bad model in production: the
            # floor is doing the ruling, and here is why
            out.append(f"  DEGRADED evaluator: "
                       f"{ev.get('fallbacks', 0)} fallback(s), last: "
                       f"{ev.get('last_fallback_reason', '?')}")
        refused = model.get("refused") or {}
        for version, reason in sorted(refused.items()):
            out.append(f"  refused {version}: {reason}")
    return "\n".join(out)


def render_fleet(snap: dict) -> str:
    """Tabular view of the scheduler's fleet-pulse plane (/debug/fleet):
    rollups over every daemon's latest pulse, active anomaly episodes,
    recent firings, and the incident ring. Pure function over the
    snapshot so it is testable offline."""
    fleet = snap.get("fleet") or {}
    qos = fleet.get("qos_states") or {}
    out = [f"fleet: daemons={snap.get('daemons', 0)}  "
           f"samples={snap.get('samples', 0)}  "
           f"ingested={snap.get('ingested', 0)}  "
           f"ignored={snap.get('ignored', 0)}  "
           f"incidents={snap.get('incidents', 0)}",
           f"pulse: flights={fleet.get('flight_tasks', 0)}  "
           f"lag-max={fleet.get('loop_lag_max_ms', 0.0)}ms  "
           f"slo={fleet.get('slo_breaches', 0)}  "
           f"escalated={fleet.get('escalated_serves', 0)}  "
           f"shed={fleet.get('qos_shed', 0)}  "
           f"corrupt={fleet.get('corrupt_verdicts', 0)}  "
           f"self-quar={fleet.get('self_quarantined', 0)}  "
           f"qos={json.dumps(qos, sort_keys=True)}"]
    counts = snap.get("anomaly_counts") or {}
    if counts:
        out.append("anomalies: " + "  ".join(
            f"{kind}={n}" for kind, n in sorted(counts.items())))
    active = snap.get("active") or []
    if active:
        out.append(f"{'active episode':<18} {'daemon':<24} {'for-s':>8}")
        for a in active:
            out.append(f"{a.get('anomaly', ''):<18} "
                       f"{a.get('host_id', ''):<24} "
                       f"{a.get('since_s', 0.0):>8}")
    recent = snap.get("recent_anomalies") or []
    if recent:
        out.append(f"{'recent firing':<18} {'daemon':<24} "
                   f"{'signal':<16} {'value':>10} {'z':>6}")
        for r in recent[-8:]:
            out.append(f"{r.get('anomaly', ''):<18} "
                       f"{r.get('host_id', ''):<24} "
                       f"{r.get('signal', ''):<16} "
                       f"{r.get('value', 0.0):>10} {r.get('zscore', 0.0):>6}")
    if not active and not recent:
        out.append("(no anomalies — a quiet fleet, or daemons not "
                   "announcing pulses yet)")
    bundles = snap.get("incident_bundles")
    if bundles:
        out.append("incident ring (latest "
                   f"{len(bundles)} of {snap.get('incidents', 0)}):")
        for b in bundles[-5:]:
            out.append(f"  {b.get('id', '')}  {b.get('anomaly', ''):<16} "
                       f"{b.get('host_id', '')}  "
                       f"pod={b.get('pod', '') or '-'}  "
                       f"quar={b.get('quarantine') or '-'}  "
                       f"pulses={len(b.get('pulses') or [])}")
    recov = snap.get("recovery")
    if recov is not None:
        sub = (recov.get("components") or {}).get("fleetpulse") or {}
        out.append(f"recovery: warm (gap {recov.get('gap_s', 0.0)}s, "
                   f"{sub.get('restored', 0)} restored)"
                   if recov.get("recovered")
                   else "recovery: cold boot (no usable snapshot)")
    return "\n".join(out)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dfdiag", description="flight-recorder waterfall + verdict")
    p.add_argument("task_id", nargs="?", default="",
                   help="task id (prefix ok) to diagnose")
    p.add_argument("--daemon", default="127.0.0.1:65002",
                   help="daemon upload host:port serving /debug/flight")
    p.add_argument("--scheduler", default="",
                   help="scheduler debug host:port serving /debug/cluster")
    p.add_argument("--file", default="",
                   help="read a saved /debug/flight JSON instead of HTTP")
    p.add_argument("--list", action="store_true",
                   help="list recorded flights on the daemon")
    p.add_argument("--cluster", action="store_true",
                   help="show the scheduler's cluster health view")
    p.add_argument("--ctrl", action="store_true",
                   help="show the scheduler's control-plane observatory "
                   "(/debug/ctrl on --scheduler): rulings/sec, per-phase "
                   "ruling latency (p50/p99), queue-wait vs compute "
                   "split, and bytes of scheduler state per component")
    p.add_argument("--fleet", action="store_true",
                   help="show the scheduler's fleet-pulse plane "
                   "(/debug/fleet on --scheduler): per-daemon pulse "
                   "rollups, active anomaly episodes, recent firings "
                   "with z-scores, and the incident-bundle ring; exits "
                   "3 while any anomaly episode is active so chaos "
                   "pipelines can gate on a quiet fleet")
    p.add_argument("--arm", default="", choices=["", "on", "off"],
                   help="with --ctrl: arm/disarm the ruling profiler "
                   "live before reading the snapshot")
    p.add_argument("--decisions", action="store_true",
                   help="show the scheduler's live decision ledger "
                   "(/debug/decisions on --scheduler): recent rulings "
                   "with per-term score decomposition and exclusions — "
                   "tools/dfsched.py is the full inspector with outcome "
                   "joins over a records file")
    p.add_argument("--qos", action="store_true",
                   help="show the daemon's QoS plane (/debug/qos on "
                   "--daemon): degradation state, per-class "
                   "throttle/queue/shed counters, per-tenant "
                   "attribution, and a verdict naming any starved "
                   "class and the offending tenant")
    p.add_argument("--pod", default="",
                   help="comma-separated daemon upload host:port set — "
                   "render the podscope distribution tree (per-edge "
                   "bytes/bandwidth, makespan, depth, amplification, "
                   "bottleneck verdict) across the whole pod; spanning "
                   "several pods, pod-crossing edges carry a [dcn] tier "
                   "mark and the per-task federation line sums the "
                   "bytes that crossed a pod boundary")
    p.add_argument("--json", action="store_true",
                   help="machine-readable JSON instead of rendered text "
                   "(with --pod: the full aggregate report for CI gates)")
    p.add_argument("--timeout", type=float, default=10.0,
                   help="per-request HTTP timeout in seconds")
    p.add_argument("--width", type=int, default=64, help="waterfall width")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.pod:
            from ..common import podscope
            addrs = [a.strip() for a in args.pod.split(",") if a.strip()]
            if not addrs:
                print("dfdiag: --pod needs at least one host:port",
                      file=sys.stderr)
                return EXIT_USAGE
            # collect_pod never raises: unreachable daemons land in the
            # report (and the breach list) instead of a traceback — a pod
            # diagnosis must survive the exact failures it exists to see
            snaps = podscope.collect_pod(addrs, timeout_s=args.timeout)
            report = podscope.aggregate(snaps)
            print(json.dumps(report, indent=2) if args.json
                  else render_pod_report(report))
            if len(report["unreachable"]) == len(addrs):
                return EXIT_IO          # nothing answered: not a verdict
            return EXIT_BREACH if report["breaches"] else EXIT_OK
        if args.qos:
            snap = _get(f"http://{args.daemon}/debug/qos", args.timeout)
            print(json.dumps(snap, indent=2) if args.json
                  else render_qos(snap))
            # gate contract: a starving QoS plane exits like an SLO
            # breach, so chaos pipelines can assert on it
            return EXIT_BREACH if qos_verdict(snap)[1] else EXIT_OK
        if args.decisions:
            if not args.scheduler:
                print("dfdiag: --decisions needs --scheduler host:port "
                      "(the scheduler's --debug-port)", file=sys.stderr)
                return EXIT_USAGE
            from .dfsched import render_decision
            q = f"?task={args.task_id}" if args.task_id else ""
            snap = _get(
                f"http://{args.scheduler}/debug/decisions{q}", args.timeout)
            if args.json:
                print(json.dumps(snap, indent=2))
                return EXIT_OK
            rows = snap.get("decisions") or []
            for d in rows[-8:]:
                print(render_decision(d))
                print()
            print(f"ledger: {json.dumps(snap.get('stats') or {})}")
            return EXIT_OK
        if args.fleet:
            if not args.scheduler:
                print("dfdiag: --fleet needs --scheduler host:port "
                      "(the scheduler's --debug-port)", file=sys.stderr)
                return EXIT_USAGE
            snap = fetch_fleet(args.scheduler, args.timeout)
            print(json.dumps(snap, indent=2) if args.json
                  else render_fleet(snap))
            # gate contract: an active anomaly episode exits non-zero so
            # chaos pipelines can assert the fleet went quiet again
            return EXIT_BREACH if snap.get("active") else EXIT_OK
        if args.ctrl:
            if not args.scheduler:
                print("dfdiag: --ctrl needs --scheduler host:port "
                      "(the scheduler's --debug-port)", file=sys.stderr)
                return EXIT_USAGE
            arm = {"on": "1", "off": "0"}.get(args.arm, "")
            snap = fetch_ctrl(args.scheduler, args.timeout, arm=arm)
            print(json.dumps(snap, indent=2) if args.json
                  else render_ctrl(snap))
            return EXIT_OK
        if args.cluster:
            if not args.scheduler:
                # the daemon upload port serves /debug/flight, never
                # /debug/cluster — a silent fallback would just 404
                print("dfdiag: --cluster needs --scheduler host:port "
                      "(the scheduler's --debug-port)", file=sys.stderr)
                return EXIT_USAGE
            snap = fetch_cluster(args.scheduler, args.timeout)
            print(json.dumps(snap, indent=2) if args.json
                  else render_cluster(snap))
            return EXIT_OK
        if args.list:
            idx = fetch_index(args.daemon, args.timeout)
            print(json.dumps(idx, indent=2))
            return EXIT_OK
        if args.file:
            with open(args.file, encoding="utf-8") as f:
                flight = json.load(f)
        elif args.task_id:
            flight = fetch_flight(args.daemon, args.task_id, args.timeout)
        else:
            print("dfdiag: need a task_id, --file, --list, --cluster, "
                  "or --pod", file=sys.stderr)
            return EXIT_USAGE
        summary = flight.get("summary") or flight
        if args.json:
            print(json.dumps(summary, indent=2))
        else:
            print(render_waterfall(summary, width=args.width))
            print(verdict(summary))
        # gate contract: a flight that blew an SLO budget exits non-zero
        # even when rendered, so chaos pipelines can assert on it
        return EXIT_BREACH if summary.get("slo_breaches") else EXIT_OK
    except (OSError, ValueError) as exc:
        # URLError/HTTPError/timeout/bad JSON: one line, no traceback —
        # an unreachable daemon is a finding, not a crash
        print(f"dfdiag: {type(exc).__name__}: {exc}", file=sys.stderr)
        return EXIT_IO


def render_pod_report(report: dict) -> str:
    from ..common.podscope import render_pod
    return render_pod(report)


def qos_verdict(snap: dict) -> tuple[str, bool]:
    """(verdict text, is_breach) over a ``/debug/qos`` snapshot. A class
    is starved when its work is queued or shed while another class holds
    active capacity; the verdict names that other class's heaviest
    consuming tenant as the offender."""
    state = snap.get("state", "normal")
    active = snap.get("active") or {}
    shed = snap.get("shed") or {}
    queued_now = snap.get("queued_now", 0)
    classes = snap.get("classes") or {}
    parts = [f"verdict: qos state '{state}'"]
    starved = ""
    # starvation is judged only while the plane is OUT of `normal`:
    # shed counters are cumulative process-lifetime totals, and reading
    # them unconditionally would latch "class X is starved" forever
    # after one historic shed
    if state != "normal":
        for cls in ("bulk", "standard", "critical"):
            pressure = shed.get(cls, 0) > 0 or (cls == "bulk"
                                                and queued_now > 0)
            if pressure and any(active.get(c, 0) > 0
                                for c in active if c != cls):
                starved = cls
                break
    breach = False
    if starved:
        others = [c for c in active if c != starved and active.get(c, 0)]
        # the offending tenant: heaviest consumer across the classes
        # holding the capacity the starved class is queued behind
        offender, offender_cls, consumed = "", "", -1
        for c in others:
            for tenant, row in (classes.get(c, {})
                                .get("tenants") or {}).items():
                if row.get("consumed_bytes", 0) > consumed:
                    offender, offender_cls = tenant, c
                    consumed = row.get("consumed_bytes", 0)
        parts.append(
            f"class '{starved}' is being "
            f"{'shed' if shed.get(starved) else 'queued'} "
            f"({shed.get(starved, 0)} shed, {queued_now} queued now) "
            f"while {'/'.join(others)} hold "
            f"{sum(active.get(c, 0) for c in others)} active slots")
        if offender:
            parts.append(f"offending tenant: '{offender}' "
                         f"(class '{offender_cls}', "
                         f"{consumed} bytes consumed)")
        # bulk being browned out is the plane WORKING (no breach);
        # standard/critical starving is a breach
        breach = starved in ("standard", "critical")
        if starved == "bulk":
            parts.append("bulk degradation under foreground pressure is "
                         "the brownout contract, not a fault")
    else:
        parts.append("no class is starved")
    return ";\n  ".join(parts) + ".", breach


def render_qos(snap: dict) -> str:
    """Tabular per-class throttle/queue readout + verdict."""
    out = [f"qos: state={snap.get('state', '?')} "
           f"(for {snap.get('state_since_s', 0):.0f}s)  "
           f"enabled={snap.get('enabled', '?')}  "
           f"queued_now={snap.get('queued_now', 0)}"]
    classes = snap.get("classes") or {}
    active = snap.get("active") or {}
    admitted = snap.get("admitted") or {}
    shed = snap.get("shed") or {}
    out.append(f"{'class':<10} {'active':>7} {'admitted':>9} "
               f"{'shed':>6} {'rate':>12} {'consumed':>12} {'tasks':>6}")
    for cls in ("critical", "standard", "bulk"):
        row = classes.get(cls) or {}
        out.append(
            f"{cls:<10} {active.get(cls, 0):>7} "
            f"{admitted.get(cls, 0):>9} {shed.get(cls, 0):>6} "
            f"{_fmt_bytes(row.get('rate_bps', 0)):>10}/s "
            f"{_fmt_bytes(row.get('consumed_bytes', 0)):>12} "
            f"{row.get('tasks', 0):>6}")
    tenants = snap.get("tenants") or {}
    for name, row in sorted(tenants.items()):
        out.append(f"tenant {name}: admitted={row.get('admitted', 0)} "
                   f"queued={row.get('queued', 0)} "
                   f"shed={row.get('shed', 0)}")
    out.append(qos_verdict(snap)[0])
    return "\n".join(out)



if __name__ == "__main__":
    sys.exit(main())
