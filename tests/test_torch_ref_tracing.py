"""The reference's ``tests/test_tracing.py`` run against the port
(``tests/_refcases.py``)."""

from _refcases import load

SUBSTITUTIONS = ()

EXCLUDED = {}

globals().update(load("tracing", SUBSTITUTIONS, EXCLUDED))
