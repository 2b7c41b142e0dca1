"""Phase 18 of chip_smoke.py alone on the card, N times, with the manager
store's calls timed: the longest calls (a commit's fsync under the herd's
write-back) and whether a call was still running when the store closed.
It writes phase 8's origin afresh.

    python3 tests/store_trace.py N
"""
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from dragonfly2_tpu_torch.manager import store as st  # noqa: E402

CALLS = []
CLOSES = []
_exec, _rows, _close = st.Store._exec, st.Store._rows, st.Store.close


def timed(fn, kind):
    def wrap(self, sql, args=()):
        t = time.monotonic()
        try:
            return fn(self, sql, args)
        finally:
            CALLS.append((kind, sql.split()[0], time.monotonic() - t,
                          threading.current_thread().name))
    return wrap


def close(self):
    t = time.monotonic()
    busy = self._lock.locked()
    _close(self)
    CLOSES.append({"busy": busy, "waited_s": time.monotonic() - t})


st.Store._exec, st.Store._rows, st.Store.close = (
    timed(_exec, "exec"), timed(_rows, "rows"), close)

if __name__ == "__main__":
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    work = tempfile.mkdtemp(prefix="p18-")
    os.makedirs(os.path.join(work, "deploy"))
    header, nbytes = cs.safetensors_header(cs.deploy_layout())
    with open(os.path.join(work, "deploy",
                           "model-00004-of-00004.safetensors"), "wb") as f:
        f.write(header)
        f.write(memoryview(cs.seeded_bytes(np.random.default_rng(0), nbytes)))
        os.fsync(f.fileno())
    for i in range(int(sys.argv[1])):
        CALLS.clear()
        CLOSES.clear()
        t0 = time.monotonic()
        cs.phase_qos(work, device)
        top = sorted(CALLS, key=lambda c: -c[2])[:5]
        print("STORE", json.dumps({
            "run": i, "phase_s": time.monotonic() - t0, "calls": len(CALLS),
            "commits": sum(c[0] == "exec" for c in CALLS),
            "over_0.1s": sum(c[2] > 0.1 for c in CALLS),
            "over_0.5s": sum(c[2] > 0.5 for c in CALLS),
            "longest": top, "closes": CLOSES}), flush=True)
