"""The reference's ``tests/test_graft_entry.py`` run against the port
(``tests/_refcases.py``)."""

from _refcases import load

SUBSTITUTIONS = (
    ("import __graft_entry__ as graft",
     "from dragonfly2_tpu_torch import graft_entry as graft",
     "the port's entry points live in dragonfly2_tpu_torch/graft_entry.py; "
     "the reference's are the JAX package's __graft_entry__.py"),
    ("graft.dryrun_multichip(8)", 'graft.dryrun_multichip(8, device="cpu")',
     "the port's mesh runs on CUDA unless the CPU is named, and raises "
     "without CUDA (ROADMAP ground rules)"),
)

_WEDGE = ("JAX only: `topology.probe_jax_devices`, and the CPU child the "
          "reference re-execs with jax.config.update('jax_platforms', "
          "'cpu') and XLA_FLAGS when the JAX runtime is wedged; the port's "
          "dry run spawns one torch process per rank")

EXCLUDED = {
    "TestDryrunWedgeProof::test_probe_timeout_goes_straight_to_cpu_child":
        _WEDGE,
    "TestDryrunWedgeProof::test_probe_error_goes_to_cpu_child": _WEDGE,
    "TestDryrunWedgeProof::test_device_shortfall_goes_to_cpu_child": _WEDGE,
    "TestDryrunWedgeProof::test_child_failure_propagates": _WEDGE,
    "TestEntry::test_entry_forward_compiles": (
        "JAX only: `jax.jit` of the entry's forward; the port compiles "
        "nothing and runs the eager forward (ROADMAP Queue 2)"),
}

globals().update(load("graft_entry", SUBSTITUTIONS, EXCLUDED))
