"""The reference's ``tests/test_rpc.py`` run against the port
(``tests/_refcases.py``)."""

from _refcases import load

SUBSTITUTIONS = (
    ("Channel, ConsistentHashPool, HashRing", "Channel, HashRing",
     "known difference 2: the port has no ConsistentHashPool (its one "
     "case is excluded below)"),
)

EXCLUDED = {
    "TestHashRing::test_pool_update": (
        "known difference 2: the reference's ConsistentHashPool keeps one "
        "grpc channel per ring node and nothing in either package calls "
        "it; the port's daemon picks its scheduler from the HashRing "
        "itself, pinned by "
        "tests/test_torch_rpc.py::test_hash_ring_matches_reference"),
}

globals().update(load("rpc", SUBSTITUTIONS, EXCLUDED))
