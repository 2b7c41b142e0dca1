"""The reference's ``tests/test_daemon_e2e.py`` run against the port
(``tests/_refcases.py``)."""

from _refcases import load

SUBSTITUTIONS = (
    ("storage=StorageSection(gc_interval_s=3600))",
     "storage=StorageSection(gc_interval_s=3600), device=\"cpu\")",
     "the port's daemons land device sinks on CUDA unless the CPU is "
     "named, and raise without CUDA (ROADMAP ground rules); every "
     "daemon_config daemon names it"),
    ("                total, piece_size, n_pieces)",
     "                total, piece_size, list(range(n_pieces)))",
     "the reference's _download_piece_groups also takes a piece count "
     "for missing, which only this case passes; the port's takes the "
     "list of missing pieces its own caller passes, here every piece"),
)

EXCLUDED = {}

globals().update(load("daemon_e2e", SUBSTITUTIONS, EXCLUDED))
