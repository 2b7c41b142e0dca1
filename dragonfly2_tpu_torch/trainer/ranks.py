"""One process per rank: the trainer's mesh runs in spawned ranks.

The reference's sharded step is one jitted program over a device mesh in
one process. Torch's idiom is a process per device: ``run_ranks`` spawns
``world`` ranks with ``torch.multiprocessing``, each joins a process group
through a ``FileStore`` in a fresh temporary directory (so concurrent
callers never race for a TCP port), builds the ``("dp", "tp")`` mesh
(``models.make_mesh``) and calls ``fn(mesh, device, *args)``. The backend
is NCCL on CUDA (rank r on card r) and Gloo on the CPU, one torch thread
per CPU rank. Rank 0's return value comes back to the caller; an error in
any rank raises, and so does a group that outlives ``timeout_s`` when the
caller gives one (the tests bind one, so a hung rendezvous fails its
test; a fit has none, since its time grows with its rows and epochs).

``fn`` must be a module-level function of this package: a spawned rank
imports its module to find it, and this package imports torch, numpy and
the standard library only.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

def visible_cards() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _rank_main(rank: int, world: int, device_type: str, tmp: str,
               fn) -> None:
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
        backend = "gloo"
    # every rank is on this host: bootstrap over loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    from . import models
    # the arguments travel as a file: a spawn's pickled arguments of a
    # few hundred KB took seconds per rank to arrive
    args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    try:
        mesh = models.make_mesh(world, device_type=device_type)
        result = fn(mesh, device, *args)
        if rank == 0:
            torch.save(result, os.path.join(tmp, "rank0.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, device_type: str, fn, *args,
              timeout_s: float | None = None):
    """Run ``fn(mesh, device, *args)`` on ``world`` spawned ranks; rank
    0's result. CUDA needs ``world`` visible cards: it raises rather than
    run fewer ranks. ``timeout_s``: None waits for the ranks however
    long they take."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device type {device_type!r}: cuda or cpu")
    if device_type == "cuda" and world > visible_cards():
        raise RuntimeError(f"{world} ranks need {world} CUDA cards; "
                           f"{visible_cards()} visible")
    tmp = tempfile.mkdtemp(prefix="df-ranks-")
    torch.save(args, os.path.join(tmp, "args.pt"))
    ctx = mp.start_processes(_rank_main, args=(world, device_type, tmp, fn),
                             nprocs=world, join=False, start_method="spawn")
    try:
        deadline = None if timeout_s is None \
            else time.monotonic() + timeout_s
        while not ctx.join(timeout=None if deadline is None
                           else max(deadline - time.monotonic(), 0.1)):
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout_s:.0f} s")
        return torch.load(os.path.join(tmp, "rank0.pt"), weights_only=False)
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
