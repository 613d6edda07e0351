"""horovod_tpu_torch: the PyTorch / CUDA port of horovod_tpu for NVIDIA
Hopper (H100).

Counterpart of ``horovod_tpu/__init__.py``. The top level is the
reference's: the process basics and the negotiated named-tensor
collectives, on torch tensors (CPU or CUDA; an op's output lies on its
input's device)::

    import horovod_tpu_torch as hvd
    hvd.init()                                   # CUDA unless device="cpu"
    total = hvd.allreduce(x, op=hvd.Sum, name="x")
    handle = hvd.allreduce_async(y, name="y"); mean = hvd.synchronize(handle)
    view = hvd.metrics()                         # HOROVOD_TPU_METRICS=1

They run through the negotiated runtime (``common/runtime.py``): a
background thread per process whose coordinator agrees one order of the
named collectives across ranks, fuses them, and moves their data over
the socket star (``ops/socket_ops.py``) or, at size 1, locally.

The in-step collectives over a ``torch.distributed`` group (NCCL on
CUDA, gloo on the CPU) are ``horovod_tpu_torch.spmd``, as the
reference's in-mesh ones are ``horovod_tpu.spmd``. The training-step
optimizer wrapper and broadcasts on that path stay at the top level::

    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.01, momentum=0.9))
    hvd.broadcast_parameters(model, root_rank=0)

and the reference's hook-driven optimizer on the negotiated runtime is
``horovod_tpu_torch.torch.eager.DistributedOptimizer``. Attention runs
through hand-written CUDA kernels
(``horovod_tpu_torch.parallel.flash_attention``). The package imports
neither JAX nor ``horovod_tpu``.
"""

from horovod_tpu_torch.common.basics import (  # noqa: F401
    coordinator_threads_supported, cross_rank, cross_size, init,
    initialized, is_homogeneous, local_rank, local_size, metrics,
    mpi_threads_supported, rank, shutdown, size,
)
from horovod_tpu_torch.common.compression import Compression  # noqa: F401
from horovod_tpu_torch.common.status import (  # noqa: F401
    HorovodInternalError, WorldAbortedError,
)
from horovod_tpu_torch.ops import (  # noqa: F401
    Average, Sum, allgather, allgather_async, allreduce, allreduce_async,
    alltoall, alltoall_async, barrier, broadcast, broadcast_async,
    grouped_allreduce, grouped_allreduce_async, poll, reducescatter,
    reducescatter_async, synchronize,
)
from horovod_tpu_torch import spmd  # noqa: F401
from horovod_tpu_torch.torch import (  # noqa: F401
    DistributedOptimizer, broadcast_optimizer_state, broadcast_parameters,
    broadcast_train_state,
)

__version__ = "0.1.0"
