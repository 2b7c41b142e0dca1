"""The reference's ``tests/test_p2p.py`` run against the port
(``tests/_refcases.py``)."""

from _refcases import load

SUBSTITUTIONS = ()

EXCLUDED = {}

globals().update(load("p2p", SUBSTITUTIONS, EXCLUDED))
