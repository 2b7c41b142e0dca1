"""Entry points: the MLP forward, and one sharded train step on a mesh.

Counterpart of ``__graft_entry__.py``. ``entry()`` returns the flagship
model's forward (the MLP the scheduler's ``ml`` evaluator serves) with
example args. ``dryrun_multichip(n)`` runs one full sharded train step
(loss, gradients, AdamW update) of both models on an ``n``-rank ``("dp",
"tp")`` mesh and prints the reference's line.

``device="cpu"`` runs ``n`` Gloo ranks on the CPU; ``None`` or ``"cuda"``
runs ``n`` NCCL ranks, one per card, and raises when fewer than ``n``
cards are visible: ``n`` is never shrunk and nothing falls back. The
reference's probe-and-re-exec of a wedged JAX platform has no torch
counterpart.

    python -c "from dragonfly2_tpu_torch.graft_entry import dryrun_multichip; dryrun_multichip(8, device='cpu')"
"""

from __future__ import annotations

import torch

from .trainer import models, ranks
from .trainer.training import _generator, fit_numerics, resolve_device


def entry(device=None):
    """(forward, (model, x)): the MLP's forward and a 256-row batch, on
    ``device`` (default: the first CUDA card)."""
    dev = resolve_device(device)
    model = models.init_mlp(_generator(0)).to(dev)
    x = torch.from_numpy(models.synthetic_mlp_batch(0, 256)["x"]).to(dev)

    def forward(model, x):
        return model(x)

    return forward, (model, x)


def dryrun_inputs() -> dict:
    """The dryrun's params and batches as numpy: each model's init from
    seed 0 and its synthetic batch from seed 0 (32 nodes, 128 edges)."""
    mlp = models.params_to_numpy(models.init_mlp(_generator(0)))
    gnn = models.params_to_numpy(models.init_gnn(_generator(0)))
    return {"mlp": (mlp, models.synthetic_mlp_batch(0, 256)),
            "gnn": (gnn, models.synthetic_gnn_batch(0, 32, 128))}


def sharded_step_rank(mesh, device: torch.device, inputs: dict) -> dict:
    """One sharded step of each model from its numpy params and batch;
    per model the loss, the whole gradients and the updated params
    (``ranks.run_ranks`` target)."""
    losses = {"mlp": models.mlp_loss, "gnn": models.gnn_loss}
    out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
    with fit_numerics():
        for name, (tree, batch) in inputs.items():
            model = models.params_from_numpy(tree).to(device)
            models.shard_params(model, mesh)
            step = models.sharded_train_step(
                losses[name], models.make_optimizer(model), mesh)
            t0 = torch.cuda.Event(enable_timing=True) \
                if device.type == "cuda" else None
            if t0 is not None:
                torch.cuda.synchronize(device)
                t0.record()
            loss = step(model, models.batch_to_device(batch, device))
            step_ms = None
            if t0 is not None:
                t1 = torch.cuda.Event(enable_timing=True)
                t1.record()
                torch.cuda.synchronize(device)
                step_ms = t0.elapsed_time(t1)
            out[name] = {"loss": float(loss), "step_ms": step_ms,
                         "grads": models.gather_params(model, grads=True),
                         "params": models.gather_params(model)}
    return out


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One full sharded train step of both models on the mesh over
    ``n_devices`` (``models.mesh_shape``'s dp * tp ranks); prints the
    reference's line and returns rank 0's results."""
    device_type = "cpu" if str(device) == "cpu" else "cuda"
    if device is not None and device_type == "cuda" and str(device) != "cuda":
        raise ValueError(f"device {device!r}: None, 'cuda' or 'cpu'")
    dp, tp = models.mesh_shape(n_devices)
    out = ranks.run_ranks(dp * tp, device_type, sharded_step_rank,
                          dryrun_inputs())
    for name in ("mlp", "gnn"):
        loss = out[name]["loss"]
        if loss != loss:
            raise AssertionError(f"{name} loss is NaN")
    print(f"dryrun_multichip({n_devices}): mesh={out['mesh']} "
          f"mlp_loss={out['mlp']['loss']:.4f} "
          f"gnn_loss={out['gnn']['loss']:.4f}", flush=True)
    return out


if __name__ == "__main__":
    fn, args = entry()
    print(f"entry(): forward ok, out shape={tuple(fn(*args).shape)}")
    dryrun_multichip(ranks.visible_cards())
