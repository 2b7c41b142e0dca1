"""The reference's ``tests/test_swarm_machinery.py`` run against the port
(``tests/_refcases.py``)."""

from _refcases import load

SUBSTITUTIONS = ()

EXCLUDED = {}

globals().update(load("swarm_machinery", SUBSTITUTIONS, EXCLUDED))
