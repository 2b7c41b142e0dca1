"""Offline training pipeline: scheduler records JSONL -> parent-quality MLP.

Counterpart of ``dragonfly2_tpu/trainer/pipeline.py``. The live loop
(announcer upload -> ``trainer/service.py`` spool -> fit) needs a running
trainer; this module is the same fit reachable from a file. It reads the
scheduler's own ``records_dir`` artifacts (``download.jsonl`` + its
rotated ``.1`` half, the exact files ``scheduler/records.py`` writes),
folds the ``kind=decision`` candidate rows with their joined
``kind=piece`` outcomes into trainer rows
(``features.decision_outcome_rows``, v1 and v2 schemas both parse), and
runs the seeded deterministic fit from ``trainer/training.py`` on a CUDA
card (``--device cpu`` names the CPU). Same (rows, seed) -> same blob
bytes -> same ``version_of`` hash.

Usage:
    python -m dragonfly2_tpu_torch.trainer.pipeline --records records/ \
        --out bandwidth_mlp.npz [--seed 7] [--device cpu] [--json]

``train_from_records`` is also the supervision policy the live trainer
service applies to its spool: decision-outcome folds when the records
carry joined decisions, raw piece rows as the cold-start fallback.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from . import features, training

log = logging.getLogger("df.trainer.pipeline")

MIN_TRAIN_ROWS = 8       # matches train_mlp's usable-row floor

# a pod's decision-fold snapshot is hundreds of rows, far under one
# batch — an "epoch" is a single optimizer step, so train_mlp's default
# 40 never converges on folds whose labels span barely 0.1; 600 steps
# flips the replay-regret comparison in the learned model's favour
DEFAULT_EPOCHS = 600


def load_records_jsonl(path: str) -> list[dict]:
    """Rows from a records JSONL file, or a records dir holding
    ``download.jsonl`` (the rotated ``.1`` half first, so decisions
    precede their outcomes in replay order). Torn tail lines of a live
    file are skipped, never fatal — the scheduler may still be writing.
    """
    if os.path.isdir(path):
        base = os.path.join(path, "download.jsonl")
        paths = [p for p in (base + ".1", base) if os.path.exists(p)]
        if not paths:
            raise FileNotFoundError(f"no download.jsonl under {path}")
    else:
        paths = [path]
    rows: list[dict] = []
    for p in paths:
        with open(p, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rows.append(json.loads(line))
                except ValueError:
                    continue       # torn tail line of a live file
    return rows


def training_rows(rows: list[dict]) -> tuple[list[dict], str]:
    """The supervision policy: prefer decision-outcome folds (one row per
    (ruling, parent) pair that actually served, labelled by observed
    bandwidth), fall back to raw piece rows when the records carry no
    joinable decisions (cold fleet, decision sink disarmed). Returns
    (rows, source) with source in {"decision_outcomes", "piece_rows"}.
    """
    folded = features.decision_outcome_rows(rows)
    if folded:
        return folded, "decision_outcomes"
    return rows, "piece_rows"


def train_decision_model(rows: list[dict], *, seed: int = 0,
                         epochs: int = DEFAULT_EPOCHS, batch_size: int = 512,
                         use_mesh: bool = True, device=None
                         ) -> tuple[bytes, dict] | None:
    """Seeded deterministic fit of the parent-quality MLP over raw
    scheduler record rows (decisions + outcomes mixed, any schema
    version). Returns (blob, metrics) or None when the rows hold too few
    usable feature/label pairs; metrics carry the supervision source and
    fold count on top of ``train_mlp``'s own."""
    fit_rows, source = training_rows(rows)
    fitted = training.train_mlp(fit_rows, epochs=epochs,
                                batch_size=batch_size, seed=seed,
                                use_mesh=use_mesh, device=device)
    if fitted is None and source == "decision_outcomes":
        # a handful of joined decisions (fleet mid-upgrade, decision sink
        # freshly armed) must not starve the fit when raw piece rows are
        # plentiful — degrade to the piece-row supervision
        fitted = training.train_mlp(rows, epochs=epochs,
                                    batch_size=batch_size, seed=seed,
                                    use_mesh=use_mesh, device=device)
        source = "piece_rows"
    if fitted is None:
        log.info("pipeline: %d record rows folded to %d %s rows — below "
                 "the trainable floor", len(rows), len(fit_rows), source)
        return None
    blob, metrics = fitted
    metrics["supervision"] = source
    metrics["record_rows"] = len(rows)
    return blob, metrics


def train_from_records(path: str, *, seed: int = 0,
                       epochs: int = DEFAULT_EPOCHS, batch_size: int = 512,
                       use_mesh: bool = True, device=None
                       ) -> tuple[bytes, dict] | None:
    """File-to-model: everything above in one call."""
    return train_decision_model(load_records_jsonl(path), seed=seed,
                                epochs=epochs, batch_size=batch_size,
                                use_mesh=use_mesh, device=device)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="df-trainer-pipeline",
        description="offline fit: scheduler records JSONL -> versioned "
                    "parent-quality MLP blob")
    p.add_argument("--records", required=True,
                   help="records JSONL file, or the scheduler records dir "
                   "holding download.jsonl")
    p.add_argument("--out", default="",
                   help="blob output path (omit to fit without writing)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=DEFAULT_EPOCHS)
    p.add_argument("--device", default=None,
                   help="torch device of the fit (default: the first CUDA "
                   "card; 'cpu' names the CPU)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable fit metrics on stdout")
    args = p.parse_args(argv)
    try:
        fitted = train_from_records(args.records, seed=args.seed,
                                    epochs=args.epochs, device=args.device)
    except (OSError, ValueError, RuntimeError) as exc:
        print(f"pipeline: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    if fitted is None:
        print("pipeline: too few usable rows to fit", file=sys.stderr)
        return 1
    blob, metrics = fitted
    if args.out:
        with open(args.out, "wb") as f:
            f.write(blob)
    if args.json:
        print(json.dumps(metrics, indent=2, sort_keys=True))
    else:
        print(f"pipeline: fit {metrics['model']}@{metrics['version']} on "
              f"{metrics['rows']} rows ({metrics['supervision']}), loss "
              f"{metrics['first_epoch_loss']:.4f} -> "
              f"{metrics['final_loss']:.4f}"
              + (f", wrote {args.out}" if args.out else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
