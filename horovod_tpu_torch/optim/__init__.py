"""The autotuner's optimizer: a Gaussian-process surrogate and Bayesian
optimization over the tuning box (``common/parameter_manager.py``).

Counterpart of ``horovod_tpu/optim/``. Host arithmetic on a few dozen
points: numpy, with scipy's L-BFGS-B where scipy imports, and no torch.
"""
