"""Parallelism extensions of the port (counterpart of
``horovod_tpu/parallel``): so far the flash-attention kernels."""
