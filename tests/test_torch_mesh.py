"""The port's multi-device step on the CPU, against the JAX package's.

One 8-rank Gloo group (dp=4, tp=2, ``MULTICHIP_r05.json``'s mesh) runs
``graft_entry.dryrun_multichip(8, device="cpu")``: one sharded step of
each model from seed-0 params and the seeded-numpy synthetic batches. The
same numpy params and batches go through the port's single-device step
and the reference's ``sharded_train_step`` on the 8-device CPU mesh of
``tests/conftest.py``. The group is spawned once for the module, its
ranks pinned to one torch thread each, with a 120 s limit.

Tolerances. Against the port's single-device step the loss is held to
1e-6 relative: only the dp sum's order differs. Gradients flow back
through ``_dense``'s bf16 casts, and on the mesh each rank's partial
weight gradient is rounded to bf16 before the dp sum (the single device
rounds the whole sum once), so a gradient is held to 2**-7 of its leaf's
largest entry. For the same reason an element whose gradient is below
the partials' rounding scale may take the other sign, and AdamW's first
step moves it by 2 x lr the other way: updated parameters are compared
(to 1e-6) only where the single-device gradient exceeds 2**-6 of its
leaf's largest, and every other element is held to 2 x lr. Against the
reference, whose forward differs per element at bf16 rounding boundaries
(ROADMAP known difference 4), the loss is held to 1e-3 relative.
"""

import contextlib
import functools
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.trainer import models as ref_models
from dragonfly2_tpu_torch import graft_entry
from dragonfly2_tpu_torch.trainer import models, ranks, training

LR = 1e-3
LOSSES = {"mlp": (models.mlp_loss, ref_models.mlp_loss),
          "gnn": (models.gnn_loss, ref_models.gnn_loss)}


@pytest.fixture(scope="module")
def dryrun():
    """(rank 0's results, the printed line) of one 8-rank CPU group."""
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(out):
        mp.setattr(ranks, "run_ranks",
                   functools.partial(ranks.run_ranks, timeout_s=120))
        res = graft_entry.dryrun_multichip(8, device="cpu")
    return res, out.getvalue()


@pytest.fixture(scope="module")
def single():
    """Each model's single-device port step on the dryrun's inputs: the
    loss, the gradients and the updated params."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for name, (tree, batch) in graft_entry.dryrun_inputs().items():
            with training.fit_numerics():
                model = models.params_from_numpy(tree)
                step = models.make_train_step(
                    LOSSES[name][0], models.make_optimizer(model, LR))
                loss = float(step(model, models.batch_to_device(batch,
                                                                "cpu")))
            grads = models.params_to_numpy(model, leaf=lambda d: {
                "b": d.b.grad.numpy(), "w": d.w.grad.numpy()})
            out[name] = {"loss": loss, "grads": grads,
                         "params": models.params_to_numpy(model)}
    finally:
        torch.set_num_threads(before)
    return out


def _leaves(tree) -> list[np.ndarray]:
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _ref_sharded_loss(name: str) -> float:
    tree, batch = graft_entry.dryrun_inputs()[name]
    mesh = ref_models.make_mesh(8)
    params = ref_models.shard_params(
        jax.tree_util.tree_map(jnp.asarray, tree), mesh)
    opt = ref_models.make_optimizer(LR)
    opt_state = opt.init(params)
    sharded = ref_models.shard_batch(
        {k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    step = ref_models.sharded_train_step(LOSSES[name][1], opt, mesh)
    _, _, loss = step(params, opt_state, sharded)
    return float(loss)


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("name", ["mlp", "gnn"])
def test_param_spec_places_every_leaf_as_the_reference(name, tp):
    tree = graft_entry.dryrun_inputs()[name][0]
    for leaf in _leaves(tree):
        assert models._param_spec(leaf.shape, tp) == \
            tuple(ref_models._param_spec(jnp.asarray(leaf), tp))


def test_dryrun_prints_the_reference_mesh_line(dryrun):
    res, printed = dryrun
    assert res["mesh"] == {"dp": 4, "tp": 2}
    assert re.fullmatch(
        r"dryrun_multichip\(8\): mesh=\{'dp': 4, 'tp': 2\} "
        r"mlp_loss=\d+\.\d{4} gnn_loss=\d+\.\d{4}\n", printed), printed


@pytest.mark.parametrize("name", ["mlp", "gnn"])
def test_sharded_loss_equals_the_single_device_step(dryrun, single, name):
    mesh_loss, one_loss = dryrun[0][name]["loss"], single[name]["loss"]
    assert mesh_loss == pytest.approx(one_loss, rel=1e-6)


@pytest.mark.parametrize("name", ["mlp", "gnn"])
def test_sharded_loss_equals_the_reference_sharded_step(dryrun, name):
    assert dryrun[0][name]["loss"] == pytest.approx(_ref_sharded_loss(name),
                                                    rel=1e-3)


@pytest.mark.parametrize("name", ["mlp", "gnn"])
def test_sharded_gradients_and_update_equal_the_single_device_step(
        dryrun, single, name):
    mesh, one = dryrun[0][name], single[name]
    for g_mesh, g_one, p_mesh, p_one in zip(
            _leaves(mesh["grads"]), _leaves(one["grads"]),
            _leaves(mesh["params"]), _leaves(one["params"])):
        scale = float(np.abs(g_one).max())
        np.testing.assert_allclose(g_mesh, g_one, rtol=0,
                                   atol=2.0 ** -7 * scale + 1e-12)
        stable = np.abs(g_one) > 2.0 ** -6 * scale
        np.testing.assert_allclose(p_mesh[stable], p_one[stable], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(p_mesh, p_one, rtol=0, atol=2 * LR + 1e-6)


@pytest.mark.parametrize("name,seed", [("mlp", 0), ("mlp", 3), ("gnn", 0),
                                       ("gnn", 5)])
def test_synthetic_batches_have_the_reference_shapes_and_dtypes(name, seed):
    if name == "mlp":
        port = models.synthetic_mlp_batch(seed, 64)
        ref = ref_models.synthetic_mlp_batch(jax.random.PRNGKey(seed), 64)
    else:
        port = models.synthetic_gnn_batch(seed, 16, 48)
        ref = ref_models.synthetic_gnn_batch(jax.random.PRNGKey(seed), 16, 48)
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert port[k].shape == ref[k].shape, k
        assert port[k].dtype == np.dtype(ref[k].dtype), k
    if name == "mlp":
        w = np.linspace(1.0, 0.2, models.MLP_FEATURES, dtype=np.float32)
        assert np.abs(port["y"] - port["x"] @ w).max() < 0.05 * 6
    else:
        np.testing.assert_allclose(
            port["y"], 1 / (1 + port["edge_feat"][:, 0]), rtol=1e-6)
        assert port["edge_src"].max() < 16 and port["edge_mask"].min() == 1


def test_entry_forward_on_the_cpu_and_cuda_by_default():
    fn, (model, x) = graft_entry.entry(device="cpu")
    out = fn(model, x)
    ref_fn, ref_args = __import__("__graft_entry__").entry()
    assert out.shape == ref_fn(*ref_args).shape == (256,)
    assert torch.isfinite(out).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            graft_entry.entry()


def test_dryrun_on_cards_never_shrinks_n():
    """n NCCL ranks need n visible cards: it raises, it does not run
    fewer ranks or fall back to the CPU."""
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match="CUDA cards"):
        graft_entry.dryrun_multichip(n)
    with pytest.raises(ValueError):
        graft_entry.dryrun_multichip(1, device="cuda:0")
