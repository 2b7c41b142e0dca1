"""The reference's ``tests/test_observability.py`` run against the port
(``tests/_refcases.py``)."""

from _refcases import load

SUBSTITUTIONS = ()

EXCLUDED = {}

globals().update(load("observability", SUBSTITUTIONS, EXCLUDED))
