"""horovod_tpu_torch: the PyTorch / CUDA port of horovod_tpu for NVIDIA
Hopper (H100).

Counterpart of ``horovod_tpu/__init__.py``. The user API of the training
step::

    import horovod_tpu_torch as hvd
    hvd.init()                                   # CUDA unless device="cpu"
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.01, momentum=0.9))
    hvd.broadcast_parameters(model, root_rank=0)

Collectives run through ``torch.distributed`` (NCCL on CUDA, gloo on the
CPU); attention runs through hand-written CUDA kernels
(``horovod_tpu_torch.parallel.flash_attention``). The package imports
neither JAX nor ``horovod_tpu``.
"""

from horovod_tpu_torch.common.basics import (  # noqa: F401
    init, initialized, local_rank, local_size, rank, shutdown, size,
)
from horovod_tpu_torch.common.compression import Compression  # noqa: F401
from horovod_tpu_torch.spmd import (  # noqa: F401
    Average, Max, Min, Sum, allgather, allreduce, allreduce_gradients,
    broadcast, broadcast_variables, create_mesh, mesh_rank, mesh_size,
)
from horovod_tpu_torch.torch import (  # noqa: F401
    DistributedOptimizer, broadcast_optimizer_state, broadcast_parameters,
    broadcast_train_state,
)

__version__ = "0.1.0"
