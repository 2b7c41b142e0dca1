"""The reference's ``tests/test_ml_loop.py`` run against the port
(``tests/_refcases.py``)."""

from _refcases import load

_FIT_CPU = ("the port's fits run on CUDA unless the CPU is named, and "
            "raise without CUDA (ROADMAP ground rules)")

SUBSTITUTIONS = (
    ("use_mesh=False)", 'use_mesh=False, device="cpu")', _FIT_CPU),
    ('manager_addresses=[f"127.0.0.1:{mgr.port}"], min_rows=32))',
     'manager_addresses=[f"127.0.0.1:{mgr.port}"], min_rows=32,\n'
     '            device="cpu"))', _FIT_CPU),
    ('"--epochs", "10", "--json"])',
     '"--epochs", "10", "--json", "--device", "cpu"])', _FIT_CPU),
)

EXCLUDED = {
    "TestParamsIO::test_numpy_serving_matches_jax_forward": (
        "JAX only: `jax.random.PRNGKey` and the reference's jax "
        "models.mlp_forward, held against numpy serving; the port's torch "
        "forward is held against the same serving code in "
        "tests/test_torch_ml_loop.py"),
}

globals().update(load("ml_loop", SUBSTITUTIONS, EXCLUDED))
