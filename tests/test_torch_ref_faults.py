"""The reference's ``tests/test_faults.py`` run against the port
(``tests/_refcases.py``)."""

from _refcases import load

_TORCH_MLP = (
    "the port's MLP is a torch module drawn from a torch.Generator "
    "(trainer/models.py); params_to_numpy gives the host tree that the "
    "reference builds with jax.random.PRNGKey and jax.tree_util.tree_map")

SUBSTITUTIONS = (
    ("""training.train_mlp(rows, epochs=5,
                                                   use_mesh=False)""",
     """training.train_mlp(rows, epochs=5,
                                                   use_mesh=False,
                                                   device="cpu")""",
     "the port's fits run on CUDA unless the CPU is named, and raise "
     "without CUDA (ROADMAP ground rules)"),
    ("""            import jax
            from dragonfly2_tpu_torch.trainer import models
            host = jax.tree_util.tree_map(
                np.asarray, models.init_mlp(jax.random.PRNGKey(0)))""",
     """            import torch
            from dragonfly2_tpu_torch.trainer import models
            host = models.params_to_numpy(
                models.init_mlp(torch.Generator().manual_seed(0)))""",
     _TORCH_MLP),
)

EXCLUDED = {}

globals().update(load("faults", SUBSTITUTIONS, EXCLUDED))
