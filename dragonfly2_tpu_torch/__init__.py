"""PyTorch/CUDA port of the dragonfly2_tpu data plane.

This slice carries one daemon pulling a task back to source (``file://``)
into device memory through ``tpu.hbm_sink.DeviceIngest``, in whole-file and
manifest mode, with ``tpu.data.ShardPrefetcher`` on top. Module paths mirror
``dragonfly2_tpu`` so each counterpart is found by path; the package imports
torch, numpy and the standard library only.
"""
