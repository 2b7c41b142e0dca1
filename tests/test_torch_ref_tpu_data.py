"""The reference's ``tests/test_tpu_data.py`` run against the port
(``tests/_refcases.py``)."""

from _refcases import load

SUBSTITUTIONS = (
    ("storage=StorageSection(gc_interval_s=3600)))",
     "storage=StorageSection(gc_interval_s=3600), device=\"cpu\"))",
     "the port's daemons land device sinks on CUDA unless the CPU is "
     "named, and raise without CUDA (ROADMAP ground rules)"),
)

EXCLUDED = {}

globals().update(load("tpu_data", SUBSTITUTIONS, EXCLUDED))
