"""Phases 16 and 17 of chip_smoke.py alone on the card, on a freshly
written phase-8 origin (the Llama-3-8B layout's last tensors).

    python3 tests/poison_pods.py [poison] [federation]
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
    work = tempfile.mkdtemp(prefix="p1617-")
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
    for name in sys.argv[1:] or ["poison", "federation"]:
        getattr(cs, f"phase_{name}")(work, device)
    print("done", time.monotonic() - t0, flush=True)
