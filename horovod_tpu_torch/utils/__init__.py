"""Utilities (counterpart of ``horovod_tpu/utils``)."""
