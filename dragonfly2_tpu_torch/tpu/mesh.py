"""Device meshes: a named reshape of a list of ``torch.device``s.

Counterpart of ``dragonfly2_tpu/tpu/mesh.py``. One torch process has no
global array, so a mesh here only fixes device ORDER and axis names: the
device sink uses it to decide which contiguous byte shard lands on which
device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Mesh:
    devices: np.ndarray            # object array of torch.device, axis shape
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


@dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: tuple[str | None, ...]


def cuda_devices() -> list[torch.device]:
    """Every visible CUDA device; raises when there is none (the port never
    falls back to the CPU unless the caller names it)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device found (torch.cuda.is_available() "
                           "is False); name the CPU explicitly to use it")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(axis_sizes: dict[str, int] | None = None, *,
              devices=None) -> Mesh:
    """A ``Mesh`` with named axes over ``devices`` (default: every CUDA
    device). Without ``axis_sizes``, all devices go on one ``data`` axis.
    Sizes must multiply to the device count (use -1 for one inferred axis).
    """
    if devices is None:
        devices = cuda_devices()
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if not axis_sizes:
        axis_sizes = {"data": n}
    names = list(axis_sizes.keys())
    sizes = list(axis_sizes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if known <= 0 or n % known:
            raise ValueError(f"cannot infer axis size: {n} devices over {sizes}")
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"axis sizes {dict(zip(names, sizes))} != {n} devices")
    flat = np.empty(n, dtype=object)
    flat[:] = devices
    return Mesh(flat.reshape(sizes), tuple(names))


def named_sharding(mesh: Mesh, *axes: str | None) -> NamedSharding:
    """``NamedSharding`` over ``mesh`` with a partition spec of ``axes``."""
    return NamedSharding(mesh, tuple(axes))
