"""``ml`` evaluator: scores parents with the trained bandwidth predictor.

Counterpart of ``dragonfly2_tpu/scheduler/evaluator_ml.py`` (the slot the
reference left as a TODO, ``scheduler/scheduling/evaluator/
evaluator.go:84-86``): records written by ``scheduler/records.py`` flow to
the trainer (``trainer/service.py``), the MLP fits on the card
(``trainer/training.py``), and the scheduler serves the blob here via
``trainer/serving.py`` (numpy, on the scheduler's CPU).

``parent_feature_row`` is the single feature extractor used BOTH at record
time and at scoring time (layout: ``trainer/features.PARENT_FEATURES``).

Falls back to the rule-based score whenever inference is unavailable, the
feature row cannot be built, or the model emits a non-finite score — the
heuristic floor is the worst case, never a crashed or NaN ranking. Every
fallback while a model is bound increments ``df_ml_fallback_total`` and is
remembered in ``health()``. ``infer`` may be (re)bound at runtime as new
model versions land.
"""

from __future__ import annotations

import logging
import math

from ..common.metrics import REGISTRY
from .evaluator import Evaluator
from .resource import Peer

log = logging.getLogger("df.sched.eval_ml")

_BASE = Evaluator()

_scored_total = REGISTRY.counter(
    "df_ml_scored_total",
    "candidate scorings answered by the served model (not the fallback)")
_fallback_total = REGISTRY.counter(
    "df_ml_fallback_total",
    "candidate scorings that fell back to the heuristic floor while a "
    "model was bound", ("reason",))


def parent_feature_row(child: Peer, parent: Peer, *,
                       total_piece_count: int) -> list[float]:
    """Feature layout per ``trainer/features.PARENT_FEATURES`` — keep in sync."""
    return [
        _BASE._piece_score(parent, total_piece_count),
        parent.host.upload_success_ratio(),
        _BASE._free_upload_score(parent),
        _BASE._host_type_score(parent),
        _BASE._locality_score(child, parent),
        float(len(parent.finished_pieces)),
        float(parent.host.concurrent_upload_count),
    ]


class MLEvaluator(Evaluator):
    def __init__(self, infer=None):
        """``infer(features: list[list[float]]) -> list[float]`` returns a
        predicted goodness per row (higher = better parent). ``None`` until
        a model is served; the base score covers the cold start."""
        self.infer = infer
        self.scored = 0              # rulings the model actually answered
        self.fallbacks = 0           # rulings pushed back to the floor
        self.last_fallback_reason = ""

    def _predict(self, child: Peer, parent: Peer, *,
                 total_piece_count: int) -> float | None:
        """One model score, or None → caller uses the heuristic floor.
        The floor is guaranteed: any exception AND any non-finite output
        degrade to base — a garbage model can slow nothing down and rank
        nothing below what the heuristic would have ruled."""
        try:
            row = self.feature_row(child, parent,
                                   total_piece_count=total_piece_count)
            out = self.infer([row])
            if not out:
                return None
            score = float(out[0])
            if not math.isfinite(score):
                raise ValueError(f"non-finite model score {score!r}")
        except Exception as exc:  # noqa: BLE001 - model serving is optional
            reason = ("non_finite" if "non-finite" in str(exc) else "error")
            self.fallbacks += 1
            self.last_fallback_reason = f"{reason}: {exc}"
            _fallback_total.labels(reason).inc()
            log.debug("ml inference failed (%s); using base score", exc)
            return None
        self.scored += 1
        _scored_total.inc()
        return score

    def health(self) -> dict:
        """Serving provenance for ``/debug/ctrl``: which model version is
        answering, how often it answered vs fell back, and why the last
        fallback happened. ``degraded`` means a model is bound but the
        floor is doing (some of) the ruling."""
        return {
            "version": getattr(self.infer, "version", "") or "",
            "bound": self.infer is not None,
            "scored": self.scored,
            "fallbacks": self.fallbacks,
            "last_fallback_reason": self.last_fallback_reason,
            "degraded": self.infer is not None and self.fallbacks > 0,
        }

    def evaluate(self, child: Peer, parent: Peer, *,
                 total_piece_count: int) -> float:
        if self.infer is not None:
            score = self._predict(child, parent,
                                  total_piece_count=total_piece_count)
            if score is not None:
                return score
        return super().evaluate(child, parent,
                                total_piece_count=total_piece_count)

    def explain(self, child: Peer, parent: Peer, *,
                total_piece_count: int) -> dict:
        """Decision-ledger decomposition: base terms stay for context;
        when the served model answered, the total is the model's and the
        row says so (``substituted: {"total": "ml"}``, heuristic total
        preserved as ``base_total``). Mirrors ``evaluate``'s control flow
        exactly — including the fallback — so the logged total is always
        the score the ranking actually used."""
        out = super().explain(child, parent,
                              total_piece_count=total_piece_count)
        if self.infer is not None:
            score = self._predict(child, parent,
                                  total_piece_count=total_piece_count)
            if score is not None:
                out["base_total"] = out["total"]
                out["total"] = score
                out["substituted"] = {"total": "ml"}
        return out

    def feature_row(self, child: Peer, parent: Peer, *,
                    total_piece_count: int) -> list[float]:
        return parent_feature_row(child, parent,
                                  total_piece_count=total_piece_count)
