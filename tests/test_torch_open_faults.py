"""Faults the port had against the reference (ROADMAP.md C2, C3, C5),
each held to the reference on the CPU.

- C2: the in-step collectives multiply by the scale factor rounded to
  the tensor's dtype, as the reference's ``x * jnp.asarray(f, x.dtype)``
  (``horovod_tpu/spmd/__init__.py:107-108``, ``:119-120``). Bit equality:
  the product of two bf16 (or fp16) values is exact in fp32, so both
  frameworks round it once, to the same value.
- C3: the in-step Average of an integer tensor is the float mean, as
  ``jax.lax.pmean`` returns it; the in-place form refuses it before any
  collective.
- C5: the eager adapter and the top level carry the reference adapter's
  and top level's names.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu
import horovod_tpu.torch as ref_torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import spmd
from horovod_tpu_torch.torch import eager


@pytest.fixture(scope="module")
def cpu_world():
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _values(dtype, seed=0, n=4096):
    rng = np.random.RandomState(seed)
    return torch.tensor(rng.randn(n).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("where", ["prescale_factor", "postscale_factor"])
def test_scale_factor_is_rounded_to_the_dtype(cpu_world, dtype, where):
    x = _values(dtype)
    got = spmd.allreduce(x, op=spmd.Sum, **{where: 1 / 3})
    assert got.dtype == dtype
    assert torch.equal(got, x * torch.tensor(1 / 3, dtype=dtype))


def test_scale_factor_matches_the_reference_bit_for_bit(cpu_world):
    x = _values(torch.bfloat16, seed=1)
    got = spmd.allreduce(x, op=spmd.Sum, prescale_factor=1 / 3,
                         postscale_factor=1 / 7)
    xj = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    want = (xj * jnp.asarray(1 / 3, jnp.bfloat16)) * jnp.asarray(
        1 / 7, jnp.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_integer_average_is_the_float_mean(cpu_world):
    x = torch.arange(-5, 7, dtype=torch.int32)
    got = spmd.allreduce(x)
    assert got.dtype == torch.float32
    assert torch.equal(got, x.float())
    assert torch.equal(spmd.allreduce(x, postscale_factor=0.5),
                       x.float() * 0.5)


def test_in_place_integer_average_raises_before_the_collective(
        cpu_world, monkeypatch):
    calls = []
    monkeypatch.setattr(spmd.dist, "all_reduce",
                        lambda *a, **k: calls.append(a))
    x = torch.arange(6, dtype=torch.int32) * 3
    before = x.clone()
    with pytest.raises(ValueError, match="float"):
        spmd.allreduce_(x, op=spmd.Average, prescale_factor=2.0)
    assert calls == []
    assert torch.equal(x, before)


def test_eager_adapter_has_the_reference_adapters_names():
    missing = [n for n in ref_torch.__all__ if not hasattr(eager, n)]
    assert missing == []
    assert set(ref_torch.__all__) <= set(eager.__all__)


# Names of the reference's top level whose slices are still to come.
WAITING = {"metrics": "A6.7", "elastic": "A9", "Tenant": "A9",
           "create_tenant": "A9", "service": "A9"}


def test_top_level_has_the_references_names():
    missing = [n for n in horovod_tpu.__all__
               if n not in WAITING and not hasattr(hvd, n)]
    assert missing == []
    assert hvd.coordinator_threads_supported() is True
    assert hvd.mpi_threads_supported() is True
