"""The reference's ``tests/test_aux.py`` run against the port
(``tests/_refcases.py``)."""

from _refcases import load

SUBSTITUTIONS = (
    ("from dragonfly2_tpu_torch.common.aiohttp_util import resolve_port",
     "def resolve_port(runner):\n"
     "                return runner.addresses[0][1]",
     "the port has no aiohttp and so no common/aiohttp_util.py (the one "
     "reference module without a counterpart, ROADMAP Queue 1); the "
     "case's aiohttp origin reads its bound port from its runner"),
)

EXCLUDED = {}

globals().update(load("aux", SUBSTITUTIONS, EXCLUDED))
