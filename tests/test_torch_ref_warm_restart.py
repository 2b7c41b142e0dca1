"""The reference's ``tests/test_warm_restart.py`` run against the port
(``tests/_refcases.py``)."""

from _refcases import load

SUBSTITUTIONS = ()

EXCLUDED = {}

globals().update(load("warm_restart", SUBSTITUTIONS, EXCLUDED))
