"""The CUDA runtime probe: is the accelerator answering, and how many cards.

Counterpart of the probe half of ``dragonfly2_tpu/tpu/topology.py``
(``probe_jax_devices``, ``runtime_wedged``, ``ensure_runtime_alive``). A
distribution daemon must come up and serve from disk even while the
accelerator runtime is sick, so the probe runs on a daemon thread under a
time bound, a timed-out probe is remembered host-wide for a while, and the
device-sink factory asks a non-blocking question before it touches CUDA.
"""

from __future__ import annotations

import hashlib
import logging
import os
import tempfile
import threading
import time

log = logging.getLogger("df.tpu.topology")

WEDGE_CACHE_TTL_S = 60.0


def _wedge_cache_path() -> str:
    """Host-global marker keyed by the env that steers which cards CUDA
    sees (processes pinned differently can see different runtimes) and by
    uid."""
    key = hashlib.sha256(
        os.environ.get("CUDA_VISIBLE_DEVICES", "").encode()).hexdigest()[:16]
    return os.path.join(tempfile.gettempdir(),
                        f"df-cuda-wedged-{os.getuid()}-{key}")


_local_probe_hung = False      # THIS process parked a thread in CUDA init
_runtime_ok = False            # a probe in THIS process saw CUDA answer
_reprobe_inflight = False      # background re-verification running


def probe_cuda_devices(timeout_s: float | None = None
                       ) -> tuple[str, object]:
    """TIME-BOUNDED CUDA device probe from a daemon thread.

    A TIMED-OUT probe is cached host-globally for ``WEDGE_CACHE_TTL_S``
    (``DF_TOPOLOGY_WEDGE_CACHE=0`` disables), so a fleet of processes on a
    sick host does not each re-pay the full probe timeout. A successful
    probe deletes the marker.

    Returns (status, payload):
      ("ok", (cuda_device_count, first_cuda_device | None, device_count))
      ("error", exception)   — torch absent or CUDA init raised
      ("timeout", None)      — runtime never answered
    """
    if timeout_s is None:
        timeout_s = float(os.environ.get("DF_TOPOLOGY_PROBE_TIMEOUT_S", "15"))
    cache_on = os.environ.get("DF_TOPOLOGY_WEDGE_CACHE", "1") != "0"
    cache = _wedge_cache_path()
    if cache_on:
        try:
            if time.time() - os.stat(cache).st_mtime < WEDGE_CACHE_TTL_S:
                log.info("accelerator runtime marked wedged by a recent "
                         "probe on this host; skipping (%s)", cache)
                return ("timeout", None)
        except OSError:
            pass
    box: list = []

    def _probe() -> None:
        try:
            import torch
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            box.append(("ok", (n, torch.device("cuda", 0) if n else None, n)))
        except BaseException as exc:  # noqa: BLE001 - reported to caller
            box.append(("error", exc))

    t = threading.Thread(target=_probe, name="df-topo-probe", daemon=True)
    t.start()
    t.join(timeout=timeout_s)
    result = box[0] if box else ("timeout", None)
    global _local_probe_hung, _runtime_ok
    if result[0] == "timeout":
        # a thread of this process is now parked in CUDA init for good
        _local_probe_hung = True
        if cache_on:
            try:
                with open(cache, "w"):
                    pass
            except OSError:
                pass   # cache is best-effort
    elif result[0] == "ok":
        _runtime_ok = True
        try:
            os.unlink(cache)
        except OSError:
            pass
    return result


def runtime_wedged() -> bool:
    """True when touching CUDA now could hang: this process's own probe
    thread is parked in CUDA init (permanent), or another process's probe
    timed out within the TTL (soft; not consulted when
    ``DF_TOPOLOGY_WEDGE_CACHE=0``)."""
    if _local_probe_hung:
        return True
    if _runtime_ok:
        return False
    if os.environ.get("DF_TOPOLOGY_WEDGE_CACHE", "1") == "0":
        return False
    try:
        return (time.time() - os.stat(_wedge_cache_path()).st_mtime
                < WEDGE_CACHE_TTL_S)
    except OSError:
        return False


def ensure_runtime_alive() -> bool:
    """NON-BLOCKING safe-to-touch-CUDA check for event-loop entry points.
    True only when a probe in THIS process has seen the runtime answer.
    When the verdict is unknown and no wedge marker is fresh, a background
    probe is started and False returned: the current request degrades to
    disk only, the next one after a successful probe gets the sink."""
    global _reprobe_inflight
    if _local_probe_hung:
        return False
    if _runtime_ok:
        return True
    if runtime_wedged():
        return False
    if not _reprobe_inflight:
        _reprobe_inflight = True

        def _reprobe() -> None:
            global _reprobe_inflight
            try:
                probe_cuda_devices()
            finally:
                _reprobe_inflight = False

        threading.Thread(target=_reprobe, name="df-topo-reprobe",
                         daemon=True).start()
    return False
