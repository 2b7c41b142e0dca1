"""benchtrend in the port: the reference's ``tests/test_benchtrend.py``
cases on ``dragonfly2_tpu_torch.tools.benchtrend``, and ``collect``,
``render`` and ``main``'s exit codes equal to the reference's on the
repo root and on directories holding a drifted digest, a torn file, no
artifact and a schema-drifted headline."""

import json
import os
import subprocess
import sys

import pytest

from dragonfly2_tpu.tools import benchtrend as ref_benchtrend
from dragonfly2_tpu_torch.tools import benchtrend
from dragonfly2_tpu_torch.tools.benchtrend import collect, main, render

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": REPO}


class TestCommittedTrajectory:
    def test_every_committed_artifact_parses(self):
        rows = collect(REPO)
        assert len(rows) >= 13
        assert [r["pr"] for r in rows] == sorted(r["pr"] for r in rows)
        assert rows[0]["pr"] == 3           # the digest spine exists
        assert rows[0]["schedule_digest"]

    def test_all_digest_gates_reference_pr3(self):
        rows = collect(REPO)
        drifted = [r["file"] for r in rows if r["digest_vs_pr3"] is False]
        assert drifted == []
        gated = [r for r in rows if r["digest_vs_pr3"] is True]
        assert len(gated) >= 10

    def test_pr19_headline_carries_learned_gate(self):
        rows = collect(REPO)
        r19 = next(r for r in rows if r["pr"] == 19)
        assert r19["bench"] == "dfbench-learned"
        assert r19["digest_vs_pr3"] is True
        assert "beats=True" in r19["headline"]
        assert "regret" in r19["headline"]

    def test_headlines_resolved_not_question_marks(self):
        rows = collect(REPO)
        assert all(r["headline"] != "?" for r in rows), \
            [r["file"] for r in rows if r["headline"] == "?"]


class TestMechanics:
    def _write(self, tmp_path, pr, doc):
        (tmp_path / f"BENCH_pr{pr}.json").write_text(json.dumps(doc))

    def test_drift_detected_and_rendered(self, tmp_path):
        self._write(tmp_path, 3, {"bench": "dfbench",
                                  "schedule_digest": "aaa"})
        self._write(tmp_path, 9, {"bench": "dfbench-coldstart",
                                  "schedule_digest": "bbb"})
        rows = collect(str(tmp_path))
        assert rows[0]["digest_vs_pr3"] is True
        assert rows[1]["digest_vs_pr3"] is False
        assert "DIGEST DRIFT: BENCH_pr9.json" in render(rows)

    def test_digestless_artifact_is_ungated_not_drifted(self, tmp_path):
        self._write(tmp_path, 3, {"bench": "dfbench",
                                  "schedule_digest": "aaa"})
        self._write(tmp_path, 4, {"bench": "dfbench-pex"})
        rows = collect(str(tmp_path))
        assert rows[1]["digest_vs_pr3"] is None
        assert "all digest gates reference pr3" in render(rows)

    def test_unknown_pr_degrades_to_question_mark(self, tmp_path):
        self._write(tmp_path, 99, {"bench": "dfbench-future",
                                   "some_future_key": 1})
        rows = collect(str(tmp_path))
        assert rows[0]["headline"] == "?"
        render(rows)                        # never raises

    def test_torn_artifact_raises(self, tmp_path):
        (tmp_path / "BENCH_pr3.json").write_text("{nope")
        with pytest.raises(ValueError):
            collect(str(tmp_path))


class TestCLI:
    def test_table_over_repo_exits_zero(self, tmp_path):
        out = subprocess.run(
            [sys.executable, "-m", "dragonfly2_tpu_torch.tools.benchtrend",
             "--dir", REPO],
            capture_output=True, text=True, cwd=tmp_path, timeout=120,
            env=ENV)
        assert out.returncode == 0, out.stderr[-1500:]
        assert "all digest gates reference pr3" in out.stdout
        assert not list(tmp_path.iterdir())  # read-only tool

    def test_json_mode_and_drift_exit_code(self, tmp_path):
        (tmp_path / "BENCH_pr3.json").write_text(
            '{"bench": "dfbench", "schedule_digest": "aaa"}')
        (tmp_path / "BENCH_pr9.json").write_text(
            '{"bench": "x", "schedule_digest": "bbb"}')
        assert main(["--dir", str(tmp_path), "--json"]) == 2

    def test_empty_dir_is_io_error(self, tmp_path):
        assert main(["--dir", str(tmp_path)]) == 1


# ------------------------------------------------ parity with the reference

def _scenario(tmp_path, name: str) -> str:
    """A directory for one case: the repo root itself, or a temporary one
    holding the case's artifacts."""
    if name == "repo":
        return REPO
    files = {
        "drifted": {3: {"bench": "dfbench-fakepod", "daemons": 8,
                        "pieces": 64, "schedule_digest": "aaa"},
                    12: {"bench": "dfbench-byzantine",
                         "schedule_digest": "bbb",
                         "wasted_ratio": {"on": 0.1, "off": 0.2}}},
        "torn": {3: {"bench": "dfbench", "schedule_digest": "aaa"},
                 5: "{\"bench\": \"dfbench-dataplane\", \"impr"},
        "empty": {},
        # every extractor's keys moved: the headline degrades, or reads
        # the wrong types, and must never crash
        "schema_drift": {3: {"bench": "dfbench", "schedule_digest": "aaa",
                             "daemons": [1], "wall_ms": {}},
                         4: {"p2p_served_ratio": [["x", 1]]},
                         9: {"growth_factor": 7},
                         11: {"fg_p99_ratio_qos": None},
                         13: {"origin_copies": {"fed_hier": {"4": 1.5}}},
                         16: {"rulings_per_sec": {"100": 5.0},
                              "fleets": []},
                         18: {"detection_latency_intervals": {},
                              "false_positives": {"a": 1, "b": 2}},
                         19: {"regret": "broken"}},
    }[name]
    d = tmp_path / name
    d.mkdir()
    for pr, doc in files.items():
        text = doc if isinstance(doc, str) else json.dumps(doc)
        (d / f"BENCH_pr{pr}.json").write_text(text)
    return str(d)


def _outcome(mod, path: str, capsys) -> dict:
    try:
        rows = mod.collect(path)
        table = mod.render(rows)
    except (OSError, ValueError) as exc:
        rows, table = type(exc).__name__, None
    codes = (mod.main(["--dir", path]), mod.main(["--dir", path, "--json"]))
    out = capsys.readouterr()
    return {"rows": rows, "table": table, "codes": codes,
            "stdout": out.out, "stderr": out.err}


@pytest.mark.parametrize("name", ["repo", "drifted", "torn", "empty",
                                  "schema_drift"])
def test_collect_render_and_exit_codes_equal_the_references(
        tmp_path, capsys, name):
    path = _scenario(tmp_path, name)
    got = _outcome(benchtrend, path, capsys)
    want = _outcome(ref_benchtrend, path, capsys)
    assert got == want
    assert got["codes"][0] == {"repo": 0, "drifted": 2, "torn": 1,
                               "empty": 1, "schema_drift": 0}[name]
