"""The reference's ``tests/test_fakepod_ici.py`` run against the port
(``tests/_refcases.py``)."""

from _refcases import load

_TRAINER_CPU = (
    "the port's trainer launcher fits on CUDA unless its config names "
    "the CPU, and exits non-zero without CUDA (ROADMAP ground rules)")

SUBSTITUTIONS = (
    ("from refport_launchers import free_port, spawn, wait_line",
     "from refport_launchers import (_cpu_trainer_config, free_port, "
     "spawn,\n                               wait_line)", _TRAINER_CPU),
    ('trainer = spawn("trainer", "--manager", mgr_addr,',
     'trainer = spawn("trainer", "--config", _cpu_trainer_config(tmp_path),\n'
     '                        "--manager", mgr_addr,', _TRAINER_CPU),
)

EXCLUDED = {}

globals().update(load("fakepod_ici", SUBSTITUTIONS, EXCLUDED))
