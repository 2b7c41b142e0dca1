"""The reference's ``tests/test_launchers.py`` run against the port
(``tests/_refcases.py``)."""

from _refcases import load

_TRAINER_CPU = (
    "the port's trainer launcher fits on CUDA unless its config names "
    "the CPU, and exits non-zero without CUDA (ROADMAP ground rules); "
    "each trainer here gets a config naming it")

SUBSTITUTIONS = (
    ("PY = sys.executable\n",
     "PY = sys.executable\n\n\n"
     "def _cpu_trainer_config(tmp_path) -> str:\n"
     "    path = tmp_path / \"trainer-cpu.json\"\n"
     "    path.write_text('{\"device\": \"cpu\"}')\n"
     "    return str(path)\n", _TRAINER_CPU),
    ('trainer = spawn("trainer", "--manager", mgr_addr,',
     'trainer = spawn("trainer", "--config", _cpu_trainer_config(tmp_path),\n'
     '                        "--manager", mgr_addr,', _TRAINER_CPU),
    ('("trainer", ["--data-dir", str(tmp_path / "records")])',
     '("trainer", ["--data-dir", str(tmp_path / "records"),\n'
     '                             "--config", _cpu_trainer_config(tmp_path)])',
     _TRAINER_CPU),
)

EXCLUDED = {}

globals().update(load("launchers", SUBSTITUTIONS, EXCLUDED))
