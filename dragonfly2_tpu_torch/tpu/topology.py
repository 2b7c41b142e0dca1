"""Host topology: the CUDA runtime probe, where this host sits, and link
classification.

Counterpart of ``dragonfly2_tpu/tpu/topology.py``. The probe half
(``probe_cuda_devices``, ``runtime_wedged``, ``ensure_runtime_alive``): a
distribution daemon must come up and serve from disk even while the
accelerator runtime is sick, so the probe runs on a daemon thread under a
time bound, a timed-out probe is remembered host-wide for a while, and the
device-sink factory asks a non-blocking question before it touches CUDA.
The link half (``detect``, ``link_type``, ``classify`` and the score
tables) is the reference's: hosts carry a slice name, chip coordinates
and a zone, and the scheduler derives a ``LinkType`` (LOCAL > ICI > DCN >
WAN) from them. On a GPU host ``detect`` fills the card count and a slice
name from the CUDA probe; the link tiers are the reference's, unchanged.
"""

from __future__ import annotations

import functools
import hashlib
import logging
import os
import tempfile
import threading
import time

from ..idl.messages import LinkType, TopologyInfo

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


@functools.lru_cache(maxsize=1)
def detect() -> TopologyInfo:
    """Best-effort detection of this host's position.

    Environment injection wins, with the reference's precedence:
    ``TPU_SLICE_NAME``, ``DF_POD_ID``, ``DF_ZONE`` (else ``CLOUD_ZONE``,
    else ``DF_DEFAULT_ZONE``, else "local"), ``TPU_WORKER_ID`` and
    ``DF_ICI_COORDS`` ("0,1,2"; malformed values degrade to None). The
    CUDA probe fills the card count and, when no slice is named, a slice
    name of "<card name>-<count>"; a host with no card stays slice-less.
    """
    slice_name = os.environ.get("TPU_SLICE_NAME", "")
    pod = os.environ.get("DF_POD_ID", "")
    zone = os.environ.get("DF_ZONE", os.environ.get("CLOUD_ZONE", ""))
    try:
        worker = int(os.environ.get("TPU_WORKER_ID", "-1"))
    except ValueError:
        worker = -1
    coords = None
    coords_env = os.environ.get("DF_ICI_COORDS", "")
    if coords_env:
        try:
            coords = tuple(int(x) for x in coords_env.split(","))
        except ValueError:
            coords = None
    num_chips = 0
    status, payload = probe_cuda_devices()
    if status == "timeout":
        log.warning("accelerator runtime did not answer the topology probe;"
                    " running topology-less (device sink unavailable)")
    elif status == "ok":
        num_chips, first, total = payload
        if first is not None:
            if not slice_name:
                import torch
                slice_name = f"{torch.cuda.get_device_name(first)}-{total}"
            if worker < 0:
                worker = 0
    # status == "error": torch absent or CUDA init raised — silent
    if not zone:
        zone = os.environ.get("DF_DEFAULT_ZONE", "local")
    return TopologyInfo(slice_name=slice_name, worker_index=worker,
                        ici_coords=coords, num_chips=num_chips, zone=zone,
                        pod=pod)


def pod_id(t: TopologyInfo | None) -> str:
    """The host's pod identity: an explicit ``pod`` wins, else the slice
    (one slice == one pod); "" = no pod."""
    if t is None:
        return ""
    return t.pod or t.slice_name


def same_pod(a: TopologyInfo | None, b: TopologyInfo | None) -> bool:
    pa, pb = pod_id(a), pod_id(b)
    return bool(pa) and pa == pb


def link_type(a: TopologyInfo | None, b: TopologyInfo | None,
              *, same_host: bool = False) -> LinkType:
    """Classify the best link between two hosts' positions."""
    if same_host:
        return LinkType.LOCAL
    if a is None or b is None:
        return LinkType.WAN
    if a.slice_name and a.slice_name == b.slice_name:
        return LinkType.ICI
    if a.zone and a.zone == b.zone:
        return LinkType.DCN
    return LinkType.WAN


class LinkClass:
    """One classified (child, parent) pair: the link tier, whether the
    bytes stay in one pod, the DCN distance between the pods (0 same pod,
    1 pod-crossing in one zone, 2 cross-zone or unknown) and the chip-mesh
    distance (meaningful only for ICI)."""

    __slots__ = ("link", "same_pod", "dcn_hops", "ici")

    def __init__(self, link: LinkType, same_pod_: bool, dcn_hops: int,
                 ici: int):
        self.link = link
        self.same_pod = same_pod_
        self.dcn_hops = dcn_hops
        self.ici = ici


def classify(a: TopologyInfo | None, b: TopologyInfo | None,
             *, same_host: bool = False) -> LinkClass:
    """``link_type`` plus the pod tier."""
    lt = link_type(a, b, same_host=same_host)
    sp = same_host or same_pod(a, b)
    if sp:
        dcn = 0
    elif lt in (LinkType.LOCAL, LinkType.ICI, LinkType.DCN):
        dcn = 1
    else:
        dcn = 2
    hops = ici_hops(a, b) if a is not None and b is not None else 1 << 16
    return LinkClass(lt, sp, dcn, hops)


def ici_hops(a: TopologyInfo, b: TopologyInfo) -> int:
    """Manhattan distance in the chip mesh; large when unknown."""
    if (not a.ici_coords or not b.ici_coords
            or len(a.ici_coords) != len(b.ici_coords)):
        return 1 << 16
    return int(sum(abs(int(x) - int(y))
                   for x, y in zip(a.ici_coords, b.ici_coords)))


# relative bandwidth expectations per link class, used by evaluator scoring
LINK_BANDWIDTH_SCORE = {
    LinkType.LOCAL: 1.0,
    LinkType.ICI: 0.9,
    LinkType.DCN: 0.4,
    LinkType.WAN: 0.1,
}

# the pinned link-tier names, best to worst
LINK_TIER_NAMES = {
    LinkType.LOCAL: "local",
    LinkType.ICI: "ici",
    LinkType.DCN: "dcn",
    LinkType.WAN: "wan",
}
