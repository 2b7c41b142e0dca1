"""The reference's ``tests/test_decisions.py`` run against the port
(``tests/_refcases.py``)."""

from _refcases import load

_DEVICE = ("known difference 51: the port's `dfsched --replay learned` "
           "fits on `--device`, which must name the CPU without CUDA")

SUBSTITUTIONS = (
    ("train_from_records(str(p), seed=0, use_mesh=False)",
     'train_from_records(str(p), seed=0, use_mesh=False, device="cpu")',
     "the port's fits run on CUDA unless the CPU is named, and raise "
     "without CUDA (ROADMAP ground rules)"),
    ('"--replay", "learned"]) == 0',
     '"--replay", "learned", "--device", "cpu"]) == 0', _DEVICE),
    ('"--model", str(mp), "--json"]) == 0',
     '"--model", str(mp), "--json", "--device", "cpu"]) == 0', _DEVICE),
)

EXCLUDED = {
    "TestDecisionLedger::test_debug_routes_live": (
        "known difference 74: the port's start_debug_server returns its "
        "RouteServer, where the reference returns (runner, port); pinned "
        "by tests/test_torch_observability.py::"
        "test_debug_decisions_json_equals_the_reference"),
}

globals().update(load("decisions", SUBSTITUTIONS, EXCLUDED))
