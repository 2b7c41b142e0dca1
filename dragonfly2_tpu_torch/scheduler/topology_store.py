"""RTT graph between hosts, fed by daemon probe reports.

Counterpart of ``dragonfly2_tpu/scheduler/topology_store.py`` (reference
``scheduler/networktopology/``): per-(src,dst) probe stats with an EWMA
avgRTT (alpha 0.1) and ``snapshot_rows``, the trainer's GNN dataset. The
probes that feed it, the ``nt`` evaluator's RTT lookups and the GNN
imputer for unprobed pairs wait for the control-plane slice; until then
callers ``record`` links directly.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

_EWMA_ALPHA = 0.1


@dataclass
class ProbeStat:
    avg_rtt_us: float
    count: int
    updated_at: float


class TopologyStore:
    def __init__(self):
        self._stats: dict[tuple[str, str], ProbeStat] = {}

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

    def snapshot_rows(self) -> list[dict]:
        """Feature rows for the trainer dataset."""
        return [{"src": s, "dst": d, "avg_rtt_us": st.avg_rtt_us,
                 "count": st.count, "updated_at": st.updated_at}
                for (s, d), st in self._stats.items()]
