"""Phases 16, 17, 18, 19 and 20 of chip_smoke.py alone on the card;
16-18 and 20 (``mirror``) on a freshly written phase-8 origin (the
Llama-3-8B layout's last tensors), phase 19 (``objstore``) on its own
dataset.

    python3 tests/poison_pods.py [poison] [federation] [qos] [objstore]
                                 [mirror]
"""
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    names = sys.argv[1:] or ["poison", "federation", "qos", "objstore",
                             "mirror"]
    work = tempfile.mkdtemp(prefix="p1617-")
    if names == ["objstore"]:
        t0 = time.monotonic()
        cs.phase_objstore(work, 0, device)
        print("done", time.monotonic() - t0, flush=True)
        sys.exit(0)
    os.makedirs(os.path.join(work, "deploy"))
    layout = cs.deploy_layout()
    header, nbytes = cs.safetensors_header(layout)
    buf = cs.seeded_bytes(np.random.default_rng(0), nbytes)
    with open(os.path.join(work, "deploy",
                           "model-00004-of-00004.safetensors"), "wb") as f:
        f.write(header)
        f.write(memoryview(buf))
        os.fsync(f.fileno())
    del buf
    t0 = time.monotonic()
    for name in names:
        if name in ("objstore", "mirror"):
            getattr(cs, f"phase_{name}")(work, 0, device)
        else:
            getattr(cs, f"phase_{name}")(work, device)
    print("done", time.monotonic() - t0, flush=True)
