"""Phases 3-4 and 6 of ``chip_smoke.py`` alone: the back-source pulls into
the card and the P2P pull, repeated.

    python3 tests/pull_phases.py [--runs 1] [--layers 9]

Needs one CUDA card. Imports ``chip_smoke`` from the checkout this file
sits in, so a copy of it placed in another checkout's ``tests/`` measures
that checkout: that is how two commits are compared on one card, in one
call (parent, change, change, parent). It builds phase 2's reference
tensor and phase 6's Llama-3-8B-layout file, then runs ``phase_daemon``
(phases 3-4) and ``phase_p2p`` (phase 6) ``--runs`` times, printing their
lines, and ends with one JSON line of the figures compared:
``{"runs": [{"manifest_s", "file_s", "file_nosink_s", "a_s", "b_s",
"seed_landed_s", "overlap_min", "pin_s_max"}, ...]}``.
"""

import argparse
import asyncio
import contextlib
import hashlib
import io
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def _lines(text: str) -> dict:
    """``name: {json}`` lines of the phases, by name."""
    out = {}
    for line in text.splitlines():
        name, sep, rest = line.partition(": {")
        if sep:
            try:
                out[name] = json.loads("{" + rest)
            except ValueError:
                pass
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--layers", type=int, default=9)
    args = ap.parse_args()
    cs.phase_device()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    layout = cs.llama_layout(args.layers)
    header, nbytes = cs.safetensors_header(layout)
    workdir = tempfile.mkdtemp(prefix="pull-phases-")
    runs = []
    try:
        buf = cs.seeded_bytes(np.random.default_rng(0), nbytes)
        ref = cs.phase_sink(buf, 0, device)
        path = os.path.join(workdir, "model-00001-of-00004.safetensors")
        sha = hashlib.sha256(header)
        sha.update(buf)
        with open(path, "wb") as f:
            f.write(header)
            f.write(memoryview(buf))
            os.fsync(f.fileno())
        del buf
        digest = "sha256:" + sha.hexdigest()
        for _ in range(args.runs):
            seen = io.StringIO()
            with contextlib.redirect_stdout(seen):
                asyncio.run(cs.phase_daemon(workdir, path, digest, header,
                                            ref, layout, device))
                cs.phase_p2p(workdir, path, digest, header, ref, layout,
                             device)
            print(seen.getvalue(), end="", flush=True)
            shutil.rmtree(os.path.join(workdir, "p2p"), ignore_errors=True)
            got = _lines(seen.getvalue())
            sinks = [v for k, v in got.items()
                     if "ingest_overlap_efficiency" in v]
            runs.append({
                "manifest_s": got["phase 3 manifest"]["wall_s"],
                "file_s": got["phase 4 file"]["wall_s"],
                "file_nosink_s": got["phase 4 file, no sink"]["wall_s"],
                "a_s": got["phase 6 p2p, leecher A"]["time_to_ready_s"],
                "b_s": got["phase 6 p2p, leecher B"]["time_to_ready_s"],
                "seed_landed_s":
                    got["phase 6 p2p, seed and scheduler"]["seed_landed_s"],
                "overlap_min": min(v["ingest_overlap_efficiency"]
                                   for v in sinks),
                "pin_s_max": max(v.get("pin_s", 0.0) for v in sinks)})
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
