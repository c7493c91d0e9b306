"""Parallelism across ranks (``audio8_tpu/parallel/``): data parallelism
in :mod:`audio8_tpu_torch.parallel.sharding`."""
