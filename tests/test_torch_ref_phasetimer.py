"""The reference's ``tests/test_phasetimer.py`` run against the port
(``tests/_refcases.py``)."""

from _refcases import load

SUBSTITUTIONS = ()

EXCLUDED = {
    "TestCtrlObservatory::test_debug_ctrl_route_live_arm_switch": (
        "known difference 74: the port's start_debug_server returns its "
        "RouteServer, where the reference returns (runner, port); pinned "
        "by tests/test_torch_observability.py::test_debug_server_routes"),
}

globals().update(load("phasetimer", SUBSTITUTIONS, EXCLUDED))
