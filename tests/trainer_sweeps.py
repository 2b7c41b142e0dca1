"""Seed sweeps behind the trainer's tolerances and the learned-regret claim.

Not a test module: a measurement script that imports both packages, run
on the CPU from the repository root::

    JAX_PLATFORMS=cpu python tests/trainer_sweeps.py regret --package port
    JAX_PLATFORMS=cpu python tests/trainer_sweeps.py regret --package reference
    JAX_PLATFORMS=cpu python tests/trainer_sweeps.py perturb
    JAX_PLATFORMS=cpu python tests/trainer_sweeps.py parity

``regret``: ``train_decision_model`` on BENCH_pr19's datagen rows at seeds
0-15 and each fit's replay regret against the heuristic's 0.1379.
``perturb``: the port's seed-7 fit with its initial weights moved by one
or two ulps (a sign-random relative change of 2**-22), ten runs.
``parity``: the largest and median forward difference between the
packages on the reference's ``init_mlp`` / ``init_gnn`` params over
seeds, at the sizes ``tests/test_torch_trainer.py`` uses.
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FIXTURE = os.path.join(ROOT, "tests", "data", "pr19_datagen_rows.jsonl")
HEURISTIC_REGRET = 0.1379


def _rows() -> list[dict]:
    with open(FIXTURE) as f:
        return [json.loads(line) for line in f]


def _regret(rows, blob) -> float:
    from dragonfly2_tpu_torch.scheduler.decision_ledger import replay_regret
    from dragonfly2_tpu_torch.trainer.serving import make_mlp_infer
    return replay_regret(rows, ("default", "ml"), make_mlp_infer(blob))[
        "evaluators"]["ml"]["mean_regret"]


def _summary(regrets: list[float]) -> None:
    beats = sum(r < HEURISTIC_REGRET for r in regrets)
    print(f"mean {sum(regrets) / len(regrets):.4f}; beats the heuristic's "
          f"{HEURISTIC_REGRET} at {beats} of {len(regrets)}")


def regret(package: str) -> None:
    rows = _rows()
    out = []
    for seed in range(16):
        if package == "port":
            from dragonfly2_tpu_torch.trainer import pipeline
            blob, m = pipeline.train_decision_model(rows, seed=seed,
                                                    device="cpu")
        else:
            from dragonfly2_tpu.trainer import pipeline
            blob, m = pipeline.train_decision_model(rows, seed=seed,
                                                    use_mesh=False)
        out.append(_regret(rows, blob))
        print(f"{package} seed {seed}: regret {out[-1]} final_loss "
              f"{m['final_loss']:.6f}", flush=True)
    _summary(out)


def perturb() -> None:
    import torch

    from dragonfly2_tpu_torch.trainer import models, pipeline

    rows = _rows()
    init = models.init_mlp
    out = []
    for k in range(10):
        def moved(gen, k=k, **dims):
            model = init(gen, **dims)
            if k:
                g = torch.Generator().manual_seed(1000 + k)
                with torch.no_grad():
                    for p in model.parameters():
                        p.mul_(1 + 2.0 ** -22 * torch.randn(
                            p.shape, generator=g).sign())
            return model
        models.init_mlp = moved
        try:
            blob, m = pipeline.train_decision_model(rows, seed=7,
                                                    device="cpu")
        finally:
            models.init_mlp = init
        out.append(_regret(rows, blob))
        print(f"seed 7, run {k} ({'as drawn' if not k else 'moved'}): "
              f"regret {out[-1]} final_loss {m['final_loss']:.6f}",
              flush=True)
    _summary(out)


def parity() -> None:
    import jax
    import torch

    from dragonfly2_tpu.trainer import models as ref_models
    from dragonfly2_tpu_torch.trainer import models, training

    def host(params):
        return jax.tree_util.tree_map(np.asarray, params)

    for seed in range(12):
        rng = np.random.default_rng(seed)
        params = host(ref_models.init_mlp(jax.random.PRNGKey(seed)))
        x = rng.uniform(size=(512, 7)).astype(np.float32)
        want = np.asarray(ref_models.mlp_forward(params, x))
        got = models.params_from_numpy(params)(
            torch.from_numpy(x)).detach().numpy()
        d = np.abs(got - want)
        print(f"mlp 512x7 seed {seed}: max {d.max():.2e} median "
              f"{np.median(d):.2e} scale {np.abs(want).max():.2f}")
    for n, e in ((32, 128), (1024, 8192)):
        for seed in range(1, 4):
            rng = np.random.default_rng(n)
            graph = {
                "nodes": rng.uniform(size=(n, 7)).astype(np.float32),
                "edge_src": rng.integers(0, n, e).astype(np.int32),
                "edge_dst": rng.integers(0, n, e).astype(np.int32),
                "edge_feat": rng.uniform(size=(e, 2)).astype(np.float32),
                "edge_mask": (rng.uniform(size=e) < 0.9).astype(np.float32)}
            params = host(ref_models.init_gnn(jax.random.PRNGKey(seed)))
            want = np.asarray(ref_models.gnn_forward(
                params, graph["nodes"], graph["edge_src"],
                graph["edge_dst"], graph["edge_feat"], graph["edge_mask"]))
            b = training.graph_batch(graph, torch.device("cpu"))
            got = models.params_from_numpy(params)(
                b["nodes"], b["edge_src"], b["edge_dst"], b["edge_feat"],
                b["edge_mask"]).detach().numpy()
            d = np.abs(got - want)
            print(f"gnn {n}/{e} key {seed}: max {d.max():.2e} median "
                  f"{np.median(d):.2e} scale {np.abs(want).max():.2f}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("regret")
    r.add_argument("--package", choices=("port", "reference"),
                   default="port")
    sub.add_parser("perturb")
    sub.add_parser("parity")
    args = ap.parse_args()
    if args.cmd == "regret":
        regret(args.package)
    elif args.cmd == "perturb":
        perturb()
    else:
        parity()


if __name__ == "__main__":
    main()
