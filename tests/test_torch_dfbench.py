"""The port's dfbench against the reference's, point by point.

Each point runs through both packages on the same seed at the reference's
``--smoke`` sizes (pods of 8 and 16 for ``--pr9``; 2x2 and 4x4 hosts with
8 shards of 16 pieces of 64 KiB for ``--pr14``) and the result dicts must
be equal, except:

- ``--pr5``'s ``landing.span_write``: it names the storage library that
  loaded, the port's always builds, the reference's only after ``make -C
  native`` (known difference 3); the full-size run holds it against
  ``BENCH_pr5.json``;
- ``--pr19``'s ``fit`` (the device and the fits' wall seconds).

``--pr19``'s fit is not bitwise across packages or thread counts (known
difference 4), so its parity case hands the port the reference's fitted
blob: the replay, the regret and the learned legs must then equal the
reference's. The port's own fits are held to the committed gates instead:
their schedule digests, their determinism and the purity checks.

At the full default sizes the baseline and ``--pr4/5/8/10`` equal the
committed ``BENCH_*.json`` files, and ``--pr19`` (fitted on the CPU) their
digests and booleans. ``--pr12`` equals ``BENCH_pr12.json`` whole, and
``--pr17`` ruled with the reference's filter equals ``BENCH_pr17.json``
but for ``time_to_first_ruling_ms``, the one wall-clock key (milliseconds
from a restart to its first ruling on this host), which is left out of
the comparison; with the port's filter (known difference 13) its gates
hold. ``--pr11`` equals ``BENCH_pr11.json`` whole. The control-plane
storm (``--ctrl``) at 64 and 1,000 daemons gives ``BENCH_pr16.json``'s
``ruling_digests`` and ``schedule_digest`` with both purity gates true,
with the port's filter and with the reference's (known difference 13
moves no ruling of the storm); ``--pr18`` gives ``fleetpulse_pure`` true
and, at its 128-daemon legs, the committed legs and gates.
``--pr13`` runs here at its ``--smoke`` sizes against the reference
run live at the same sizes; at its full sizes (64-daemon pods, 4-16 pods),
and ``--pr9`` at 64-256 daemons, ``--pr14`` at 16x16, the storm at
5,000 and 10,000 daemons and ``--pr18``'s 1,000- and 10,000-daemon legs,
it runs in ``chip_smoke.py`` phase 13, not here. Tolerances are exact.
"""

import argparse
import json
import os
import subprocess
import sys

import pytest
import torch

from dragonfly2_tpu.common import digest as ref_digest
from dragonfly2_tpu.tools import dfbench as ref
from dragonfly2_tpu.trainer import pipeline as ref_pipeline
from dragonfly2_tpu_torch.common import digest
from dragonfly2_tpu_torch.common import phasetimer
from dragonfly2_tpu_torch.tools import dfbench
from dragonfly2_tpu_torch.trainer import pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "pr19_datagen_rows.jsonl")
SMOKE = dict(seed=7, daemons=4, pieces=8, piece_size=4 << 20,
             parallelism=4, smoke=True, device="cpu")
FULL = dict(SMOKE, daemons=8, pieces=64, smoke=False)
# the one wall-clock key of --pr17 (per leg, and the legs' rollup)
RECOVERY_WALL_CLOCK = "time_to_first_ruling_ms"


@pytest.fixture(autouse=True)
def one_thread():
    """The CPU fits' bytes depend on torch's thread count; one thread
    makes them the same on every host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _args(**kw) -> argparse.Namespace:
    return argparse.Namespace(**kw)


def _bench(name: str) -> dict:
    with open(os.path.join(ROOT, f"BENCH_{name}.json")) as f:
        return json.load(f)


def _as_json(obj):
    """``obj`` through JSON, so tuples compare as the committed lists;
    the flight summaries' ``slo_breaches`` included (both health planes
    annotate them)."""
    return json.loads(json.dumps(obj))


# ---------------------------------------------------------------- parity

@pytest.mark.parametrize("scenario", dfbench.SCENARIOS
                         + dfbench.COLD_SCENARIOS)
def test_run_bench_matches_reference(scenario):
    kw = dict(seed=7, daemons=6, pieces=24, scenario=scenario,
              collect_timeline=True)
    got = dfbench.run_bench(**kw)
    want = ref.run_bench(**kw)
    assert _as_json(got) == _as_json(want)


@pytest.mark.parametrize("point", ["pr4", "pr6", "pr8", "pr9", "pr10",
                                   "pr11", "pr12", "pr13", "pr14"])
def test_smoke_point_matches_reference(point):
    got = getattr(dfbench, f"_run_{point}")(_args(**SMOKE))
    want = getattr(ref, f"_run_{point}")(_args(**SMOKE))
    assert _as_json(got) == _as_json(want)


def test_pr5_smoke_matches_reference():
    got = dfbench._run_pr5(_args(**SMOKE))
    want = ref._run_pr5(_args(**SMOKE))
    assert got["landing"]["per_piece_fallback"] is False
    for r in (got, want):
        del r["landing"]["span_write"]
    assert _as_json(got) == _as_json(want)


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_pr19_matches_reference_given_the_reference_fit(size, monkeypatch):
    shape = SMOKE if size == "smoke" else FULL
    want = ref._run_pr19(_args(**shape))
    ref_rows = ref.run_bench(collect_decisions=True, collect_outcomes=True,
                             **{k: shape[k] for k in ("seed", "daemons",
                                                      "pieces", "piece_size",
                                                      "parallelism")})
    ref_rows = json.loads(json.dumps(ref_rows["decisions"]
                                     + ref_rows["outcomes"]))
    ref_fit = ref_pipeline.train_decision_model(ref_rows, seed=7,
                                                use_mesh=False)
    fits = []

    def reference_fit(rows, *, seed, device):
        assert json.loads(json.dumps(rows)) == ref_rows and seed == 7
        fits.append(device)
        return ref_fit[0], dict(ref_fit[1])

    monkeypatch.setattr(pipeline, "train_decision_model", reference_fit)
    got = dfbench._run_pr19(_args(**shape))
    assert fits == [torch.device("cpu")] * 2
    assert got.pop("fit")["device"] == "cpu"
    assert got == want


def test_pod_tree_reads_the_cold_runs_as_podscope_does():
    """``--pr9`` reads each cold run's tree through ``podscope.aggregate``:
    the port's snapshots and podscope give the reference's task report."""
    from dragonfly2_tpu.common import podscope as ref_podscope
    from dragonfly2_tpu_torch.common import podscope
    for scenario in dfbench.COLD_SCENARIOS:
        kw = dict(daemons=16, pieces=8, scenario=scenario,
                  collect_podscope=True)
        got = podscope.aggregate(
            dfbench.run_bench(**kw)["podscope_snapshots"])
        want = ref_podscope.aggregate(
            ref.run_bench(**kw)["podscope_snapshots"])
        assert _as_json(got) == _as_json(want)
        (report,) = got["tasks"].values()
        assert report["depth"] > 1 and report["makespan_ms"] > 0


@pytest.mark.parametrize("algo", ["crc32", "crc32c"])
def test_churn_digest_is_blind_to_the_piece_algorithm(algo, monkeypatch):
    """The churn digest covers the content's sha256 and the byte counts,
    not the piece digests: the reference writes crc32 without its native
    library and the port crc32c, and both give the same result with
    either algorithm forced."""
    monkeypatch.setattr(digest, "preferred_piece_algo", lambda: algo)
    monkeypatch.setattr(ref_digest, "preferred_piece_algo", lambda: algo)
    shape = dict(seed=7, daemons=3, epochs=3, pieces=4, piece_size=16 << 10)
    for dedupe in (True, False):
        got = dfbench.run_churn_bench(**shape, dedupe=dedupe)
        assert got == ref.run_churn_bench(**shape, dedupe=dedupe)


# ------------------------------------------------- committed trajectory

@pytest.mark.parametrize("point,bench", [
    (None, "pr3"), ("pr4", "pr4"), ("pr5", "pr5"), ("pr8", "pr8"),
    ("pr10", "pr10"), ("pr11", "pr11"), ("pr12", "pr12")])
def test_full_size_point_equals_the_committed_file(point, bench):
    args = _args(**FULL)
    if point is None:
        got = dfbench.run_bench(**dfbench._bench_kw(args))
    else:
        got = dfbench.POINTS[point](args)
    want = _bench(bench)
    if bench == "pr3":
        # BENCH_pr3.json predates the reference's scenario knob and its
        # mesh/origin byte split
        assert set(got) - set(want) == {"scenario", "p2p_served_ratio"}
        got = {k: got[k] for k in want}
    assert _as_json(got) == _as_json(want)
    assert got.get("schedule_digest", "") == want.get("schedule_digest", "")


def test_pr19_on_the_cpu_meets_the_committed_gates():
    got = dfbench._run_pr19(_args(**FULL))
    want = _bench("pr19")
    for key in ("schedule_digest", "learned_schedule_digest",
                "learned_decision_digest", "decision_rows", "outcome_rows",
                "decisions_judged"):
        assert got[key] == want[key], key
    for key in ("ml_disarmed_pure", "outcomes_pure", "trained_deterministic",
                "learned_deterministic"):
        assert got[key] is True, key
    assert got["regret"]["heuristic"] == want["regret"]["heuristic"]
    assert got["logged_choice_agreement"]["default"] == 1.0
    for key in ("rows", "supervision", "feature_dim", "schema_version"):
        assert got["model"][key] == want["model"][key], key
    assert got["fit"]["device"] == "cpu"


def test_datagen_rows_equal_the_fixture():
    rows = dfbench.datagen_rows(_args(**FULL))
    with open(FIXTURE) as f:
        fixture = [json.loads(line) for line in f]
    assert len(rows) == len(fixture) == 64 + 512
    assert json.loads(json.dumps(rows)) == fixture


def test_rollout_partner_exemption_is_the_ruling_that_moves_the_digest():
    """At 4x4 and 8x8 hosts the port's sharded schedules differ from
    BENCH_pr14.json's because the port's filter lets swap partners past
    the cycle and bad-node rules (ROADMAP known difference 13,
    ``Scheduling._swap_partners``); with the reference's filter they are
    the committed schedules. Phase 13 of ``chip_smoke.py`` holds the whole
    ``rollout_digest`` both ways at the full sizes."""
    want = _bench("pr14")["scenarios"]["roll_sharded"]
    for positions, replicas in ((4, 4), (8, 8)):
        key = f"{positions}x{replicas}"
        kw = dict(seed=7, positions=positions, replicas=replicas)
        port = dfbench.run_rollout_bench(**kw)
        reference_filter = dfbench.run_rollout_bench(
            **kw, partner_exemption=False)
        assert reference_filter == want[key]
        assert port["schedule_digest"] != want[key]["schedule_digest"]
        assert port["complete"] == port["alive"] == positions * replicas
        assert port["dcn_bytes"] <= 1.5 * port["content_bytes"]


def test_armed_profiler_keeps_the_baseline_schedule_digest():
    """``--ctrl``'s ``profiler_pure`` leg (reference ``dfbench.py:3066-
    3076``): the full-size baseline with the ruling profiler armed keeps
    BENCH_pr3's ``schedule_digest``, and the profiler saw its rulings."""
    args = _args(**FULL)
    phasetimer.reset()
    phasetimer.arm()
    try:
        got = dfbench.run_bench(**dfbench._bench_kw(args))
        snap = phasetimer.snapshot()
    finally:
        phasetimer.reset()
    assert got["schedule_digest"] == _bench("pr3")["schedule_digest"]
    assert got["schedule_digest"].startswith("cd0105ca")
    assert snap["rulings"]["by_kind"]["find"]["count"] > 0
    assert {"filter", "dag-walk", "score"} <= set(snap["phases"])


# ------------------------------------------- the control-plane storm

def _storm_counts(result: dict) -> dict:
    """A storm's deterministic outputs: the digest, the rulings and, by
    kind and phase, how many the profiler saw (never a latency)."""
    prof = result.get("profile") or {}
    return {"ruling_digest": result["ruling_digest"],
            "rulings": result["rulings"], "pods": result["pods"],
            "by_kind": {k: v["count"] for k, v in
                        prof.get("rulings", {}).get("by_kind", {}).items()},
            "phases": {k: v["count"] for k, v in
                       prof.get("phases", {}).items()},
            "peers": result["state_bytes"]["peers"]}


def test_ctrl_smoke_matches_reference():
    got = dfbench._run_pr16(_args(**SMOKE))
    want = ref._run_pr16(_args(**SMOKE))
    for key in ("bench", "seed", "fleets", "pieces", "schedule_digest",
                "profiler_pure", "ctrl_profiler_pure", "ruling_digests"):
        assert got[key] == want[key], key
    assert set(got) == set(want)
    for k in want["scenarios"]:
        assert _storm_counts(got["scenarios"][k]) \
            == _storm_counts(want["scenarios"][k])
    assert set(got["overhead"]) == set(want["overhead"])


@pytest.mark.parametrize("daemons", [dfbench.CTRL_SMOKE_FLEET, 1000])
@pytest.mark.parametrize("filt", ["port", "reference"])
def test_storm_rulings_equal_the_committed_file(daemons, filt, monkeypatch):
    """The storm at 64 and 1,000 daemons gives ``BENCH_pr16.json``'s
    ``ruling_digests`` with the port's filter, and with the reference's:
    the shard rulings come after every find and refresh, so the port's
    swap-partner exemption (known difference 13) moves nothing here."""
    if filt == "reference":
        monkeypatch.setattr(dfbench, "Scheduling", dfbench._ReferenceFilter)
    got = dfbench.run_ctrl_bench(seed=7, daemons=daemons,
                                 pieces=dfbench.CTRL_PIECES, armed=True)
    want = _bench("pr16")
    assert got["ruling_digest"] == want["ruling_digests"][str(daemons)]
    assert _storm_counts(got) == _storm_counts(
        want["scenarios"][str(daemons)])


def test_ctrl_point_keeps_the_gates_and_the_baseline_digest():
    """``--ctrl`` over the full-size baseline (the storm at 64 daemons):
    the armed baseline keeps BENCH_pr3's ``schedule_digest`` (BENCH_pr16
    records the same), both purity gates hold, the keys are the file's."""
    got = dfbench._run_pr16(_args(**dict(FULL, smoke=True)))
    want = _bench("pr16")
    assert got["profiler_pure"] is True and got["ctrl_profiler_pure"] is True
    assert got["ruling_digests"]["64"] == want["ruling_digests"]["64"]
    assert got["schedule_digest"] == want["schedule_digest"]
    assert set(want) == set(got)
    assert got["overhead"]["disarmed_ns_per_call"] > 0


def test_pr18_is_pure_and_its_legs_equal_the_committed_file():
    """``--pr18`` at its 128-daemon legs: ``fleetpulse_pure`` (the storm's
    rulings with pulses ingested mid-storm equal those without), and the
    legs, digest and gates of ``BENCH_pr18.json``; the full point runs in
    ``chip_smoke.py`` phase 13."""
    got = _as_json(dfbench._run_pr18(_args(**dict(FULL, smoke=True))))
    want = _bench("pr18")
    assert got["fleetpulse_pure"] is True
    assert set(got) == set(want)
    for name, leg in got["legs"].items():
        want["legs"][name].pop("ingest_per_sec")
        leg.pop("ingest_per_sec")
        assert leg == want["legs"][name], name
    for key in ("bench", "seed", "intervals", "inject_at", "schedule_digest",
                "pulse_digest", "bytes_per_announce", "pulse_overhead_ok",
                "detection_bounded", "zero_false_positives",
                "detected_kinds", "fleetpulse_pure"):
        assert got[key] == want[key], key


def test_pr18_smoke_matches_reference():
    got = _as_json(dfbench._run_pr18(_args(**SMOKE)))
    want = _as_json(ref._run_pr18(_args(**SMOKE)))
    for d in (got, want):
        for leg in d["legs"].values():
            leg.pop("ingest_per_sec")
    assert got == want


# ---------------------------------------------------------------- the CLI

# the points once refused, and the key each result carries
ONCE_REFUSED = {"--ctrl": "ruling_digests", "--pr11": "qos_digest",
                "--pr18": "fleetpulse_pure"}


@pytest.mark.parametrize("flag", sorted(ONCE_REFUSED))
def test_unported_points_are_refused(flag, capsys):
    """``--pr11``, ``--ctrl`` and ``--pr18`` were refused until the QoS
    plane and the storm were ported; each now runs and prints its
    result."""
    assert dfbench.main([flag, "--smoke"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert ONCE_REFUSED[flag] in out


def _without_wall_clock(result: dict) -> dict:
    result = _as_json(result)
    result.pop(RECOVERY_WALL_CLOCK)
    for leg in result["legs"].values():
        leg.pop(RECOVERY_WALL_CLOCK)
    return result


def test_pr17_smoke_with_the_reference_filter_matches_reference():
    got = dfbench._run_pr17(_args(**SMOKE), partner_exemption=False)
    want = ref._run_pr17(_args(**SMOKE))
    assert _without_wall_clock(got) == _without_wall_clock(want)


def test_full_size_pr17_equals_the_committed_file_but_its_wall_clock():
    """``--pr17`` at its full size (legs of 64 and 512 daemons), ruled
    with the reference's filter: ``BENCH_pr17.json`` but for the wall-clock
    ``time_to_first_ruling_ms``, which is left out of the comparison."""
    got = dfbench._run_pr17(_args(**FULL), partner_exemption=False)
    want = _bench("pr17")
    assert set(got[RECOVERY_WALL_CLOCK]) == set(want[RECOVERY_WALL_CLOCK])
    assert _without_wall_clock(got) == _without_wall_clock(want)
    assert got["recovery_digest"].startswith(want["recovery_digest"][:12])


def test_pr17_with_the_ports_filter_keeps_the_gates():
    """The port's filter exempts swap partners (known difference 13), and
    the recovery storm arms shard affinity: its ruling digests move, its
    gates hold."""
    got = dfbench._run_pr17(_args(**SMOKE))
    want = ref._run_pr17(_args(**SMOKE))
    for key in ("snapshot_fault_survived", "origin_amplification_bounded",
                "poisoner_quarantined_across_restart", "affinity_sticky"):
        assert got[key] is True, key
    assert got["schedule_digest"] == want["schedule_digest"]
    assert got["origin_hits_after_restart"] \
        == want["origin_hits_after_restart"]
    assert got["legs"]["durable"]["poisoner_reoffers"] == 0
    assert got["legs"]["durable"]["provenance"] \
        == want["legs"]["durable"]["provenance"]


def test_run_bench_with_an_armed_empty_registry_keeps_the_digest():
    from dragonfly2_tpu_torch.scheduler.quarantine import QuarantineRegistry
    args = _args(**FULL)
    got = dfbench.run_bench(**dfbench._bench_kw(args),
                            quarantine=QuarantineRegistry())
    assert got["schedule_digest"] == _bench("pr3")["schedule_digest"]


def test_pr19_needs_a_card_unless_the_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dfbench.main(["--pr19", "--smoke"])


def test_cli_prints_by_default_and_writes_only_out(tmp_path):
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "dragonfly2_tpu_torch.tools.dfbench"]
    out = subprocess.run(cmd + ["--pr19", "--device", "cpu", "--smoke"],
                         capture_output=True, text=True, cwd=tmp_path,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout)
    assert r["bench"] == "dfbench-learned" and r["trained_deterministic"]
    assert list(tmp_path.iterdir()) == []
    dest = tmp_path / "sub" / "r.json"
    dest.parent.mkdir()
    out = subprocess.run(cmd + ["--pr8", "--out", str(dest)],
                         capture_output=True, text=True, cwd=tmp_path,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith(f"dfbench: wrote {dest} ")
    assert json.loads(dest.read_text())["decision_digest"] \
        == _bench("pr8")["decision_digest"]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["sub"]
