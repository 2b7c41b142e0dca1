"""RTT graph between hosts, fed by daemon probe reports.

Counterpart of ``dragonfly2_tpu/scheduler/topology_store.py`` (reference
``scheduler/networktopology/``): per-(src,dst) probe stats with an EWMA
avgRTT (alpha 0.1), ``snapshot_rows`` (the trainer's GNN dataset) and
``avg_rtt_us``: the measured RTT of a probed pair, else the bound
``topology_gnn`` imputer's estimate; ``pick_targets`` (least-probed
first) answers the daemons' probers, whose reports ``record`` and
``fail`` fold in.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

_EWMA_ALPHA = 0.1
IMPUTE_TTL_S = 60.0


@dataclass
class ProbeStat:
    avg_rtt_us: float
    count: int
    updated_at: float


class TopologyStore:
    def __init__(self, *, probe_targets: int = 5):
        self.probe_targets = probe_targets
        self._stats: dict[tuple[str, str], ProbeStat] = {}
        # GNN-imputed RTTs for unprobed pairs (the announcer binds the
        # model): pair -> (rtt_us, imputed at)
        self._imputer = None
        self._imputed: dict[tuple[str, str], tuple[float, float]] = {}

    def record(self, src: str, dst: str, rtt_us: int) -> None:
        key = (src, dst)
        st = self._stats.get(key)
        now = time.time()
        if st is None:
            self._stats[key] = ProbeStat(float(rtt_us), 1, now)
        else:
            st.avg_rtt_us += _EWMA_ALPHA * (rtt_us - st.avg_rtt_us)
            st.count += 1
            st.updated_at = now

    def fail(self, src: str, dst: str) -> None:
        self._stats.pop((src, dst), None)

    def bind_imputer(self, impute) -> None:
        """Attach a ``topology_gnn`` imputer (trainer/serving
        make_gnn_impute); clears stale imputations from any prior model."""
        self._imputer = impute
        self._imputed.clear()

    def avg_rtt_us(self, src: str, dst: str) -> float | None:
        """Measured RTT when probed; GNN-imputed otherwise (the ``nt``/
        ``ml`` evaluators then score unprobed pairs instead of treating
        them as unknowable). None when neither is available."""
        st = self._stats.get((src, dst)) or self._stats.get((dst, src))
        if st is not None:
            return st.avg_rtt_us
        return self._impute(src, dst)

    def _impute(self, src: str, dst: str) -> float | None:
        """Runs on the evaluator hot path: one cache miss imputes ALL
        currently-unprobed pairs among seen hosts in a single forward
        (the imputer's batch API) instead of one graph build per pair."""
        if self._imputer is None or src == dst:
            return None
        now = time.time()
        hit = self._imputed.get((src, dst)) or self._imputed.get((dst, src))
        if hit is not None and now - hit[1] < IMPUTE_TTL_S:
            return hit[0] if hit[0] > 0 else None
        rows = self.snapshot_rows()
        hosts = sorted({h for (s, d) in self._stats for h in (s, d)}
                       | {src, dst})
        pairs = [(a, b) for i, a in enumerate(hosts) for b in hosts[i + 1:]
                 if (a, b) not in self._stats and (b, a) not in self._stats]
        out = self._imputer(rows, pairs)
        self._imputed = {p: (out.get(p, -1.0), now) for p in pairs}
        got = (self._imputed.get((src, dst))
               or self._imputed.get((dst, src)) or (-1.0, now))
        return got[0] if got[0] > 0 else None

    def snapshot_rows(self) -> list[dict]:
        """Feature rows for the trainer dataset."""
        return [{"src": s, "dst": d, "avg_rtt_us": st.avg_rtt_us,
                 "count": st.count, "updated_at": st.updated_at}
                for (s, d), st in self._stats.items()]

    def probed_count(self, src: str) -> int:
        return sum(1 for (s, _d) in self._stats if s == src)

    def pick_targets(self, src: str, all_hosts: list[str]) -> list[str]:
        """Least-probed-first target selection for a prober."""
        others = [h for h in all_hosts if h != src]
        others.sort(key=lambda h: (self._stats.get((src, h)) is not None,
                                   (self._stats.get((src, h)) or
                                    ProbeStat(0, 0, 0)).updated_at))
        return others[:self.probe_targets]
