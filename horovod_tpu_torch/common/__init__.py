"""Framework-neutral pieces of the port: identity and compression
(counterpart of ``horovod_tpu/common``)."""
