"""Tensor and data parallelism over torch.distributed (counterpart of
magicdec_tpu/parallel): ``sharding`` (the mesh and the split rules),
``collectives`` and ``multihost`` (the bootstrap and the launcher)."""
