"""The reference's ``tests/test_health.py`` run against the port
(``tests/_refcases.py``)."""

from _refcases import load

SUBSTITUTIONS = ()

EXCLUDED = {}

globals().update(load("health", SUBSTITUTIONS, EXCLUDED))
