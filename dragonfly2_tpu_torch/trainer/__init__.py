"""Trainer: fits the bandwidth-prediction models on a CUDA card and serves
them back into scheduler decisions.

Counterpart of ``dragonfly2_tpu/trainer``: the parent-quality MLP and the
host-graph GNN as torch modules, the seeded fits, the records pipeline, the
numpy serving side the scheduler binds, and the ``Train`` / ``ModelInfer``
service.
"""
