"""PyTorch/CUDA port of the dragonfly2_tpu data plane.

The port so far carries a daemon pulling a task back to source
(``file://``) into device memory through ``tpu.hbm_sink.DeviceIngest``, in
whole-file and manifest mode, with ``tpu.data.ShardPrefetcher`` on top; and
the P2P piece path: a scheduler places leecher daemons on parents (a seed
it triggers, or other leechers), and pieces from the parents' upload
servers land in the leechers' device sinks; the learned loop, a trainer
that fits the scheduler's parent-quality model on the card; and the
manager with its model registry, through which a deployment started from
the launchers in ``tools`` registers, discovers and closes that loop; the
trainer's fit on every visible card (``trainer/ranks.py``,
``graft_entry.py``); and the observability plane (``common/tracing.py``,
``health.py``, ``phasetimer.py``, ``debug_http.py``).
Module paths mirror ``dragonfly2_tpu`` so each counterpart is found by
path; the package imports torch, numpy and the standard library only.
"""
