"""The CPU side of the tensor-core (sm90) dq kernel: the plain dq's
``operands=torch.bfloat16`` rounding that the card's checks compare the kernel
with, its agreement with the reference's dq (Pallas, interpret mode), and
the shared tolerance (horovod_tpu_torch/utils/tolerance.py), which must
pass that rounding and fail a dq with one 64-key tile left out, as
chip_smoke.py's check of it at the main shape relies on. The kernel
itself runs on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from horovod_tpu.parallel import flash_attention as ref
from horovod_tpu_torch.parallel import flash_attention as port
from horovod_tpu_torch.utils import tolerance
from tests import torch_refpool
from tests.torch_threads import one_torch_thread  # noqa: F401

B, S, H, D = 1, 256, 2, 64


def _bwd_args(seed, causal=True):
    """Bf16-valued fp32 q, k, v, do from a numpy seed, the plain
    forward's (o, m, l), and the dq arguments built from them."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.tensor(rng.randn(B, S, H, D).astype(np.float32))
                   .to(torch.bfloat16).float() for _ in range(4))
    o, m, l = port._flash_fwd_plain(q, k, v, causal, 0, 0)
    lse = port._lse_from_stats(m, l)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    return (o, m, l), (q, k, v, do, lse, delta, causal, 0, 0)


def _rounding_limit(args):
    """Rounding ds to bf16 moves each ds by at most 2^-8 of itself, so dq
    by at most 2^-8 (|ds| @ |k|), plus fp32 noise."""
    _, ds = port._p_ds_plain(*args)
    k = args[1]
    return 2.0 ** -8 * torch.einsum("bhqk,bkhd->bqhd", ds.abs(),
                                    k.abs()) + 1e-6


@pytest.mark.parametrize("causal", [True, False])
def test_plain_dq_bf16_operands_within_provable_bound(causal):
    _, args = _bwd_args(0, causal)
    dq = port._flash_dq_plain(*args)
    dq_b = port._flash_dq_plain(*args, operands=torch.bfloat16)
    assert torch.all((dq_b - dq).abs() <= _rounding_limit(args))
    assert (dq_b - dq).abs().max() > 0


def _dq_ref():
    """A worker's job: the reference's dq (Pallas, interpret mode, blocks
    of 32) on ``_bwd_args(1)``'s inputs and stats."""
    (o, m, l), args = _bwd_args(1)
    q, k, v, do = args[:4]
    return np.asarray(ref.flash_attention_bwd(
        *(jnp.asarray(x.numpy()) for x in (q, k, v, o, m, l, do)),
        causal=True, block_q=32, block_k=32, interpret=True)[0])


def _jobs():
    """The reference result the module's tests read, as a
    ``torch_refpool`` job."""
    return [((__name__, "dq"), _dq_ref, ())]

torch_refpool.register(_jobs)


@pytest.fixture(autouse=True, scope="module")
def _references():
    torch_refpool.start()


def test_plain_bf16_operands_dq_matches_reference():
    # The reference's dq (Pallas, interpret mode, blocks of 32) from the
    # same bf16-valued inputs and stats, fp32 throughout: the rounding of
    # ds is the only difference, inside the provable bound.
    (o, m, l), args = _bwd_args(1)
    theirs = torch_refpool.result((__name__, "dq"))
    mine = port._flash_dq_plain(*args, operands=torch.bfloat16)
    limit = (_rounding_limit(args) + 1e-4).numpy()
    assert np.all(np.abs(mine.numpy() - np.asarray(theirs)) <= limit)


def test_tolerance_passes_bf16_operands_and_fails_a_lost_kv_tile():
    _, args = _bwd_args(2)
    dq = port._flash_dq_plain(*args)
    dq_b = port._flash_dq_plain(*args, operands=torch.bfloat16)
    kw = dict(step=tolerance.BF16_STEP, atol=tolerance.DQ_ATOL,
              plain_b=dq_b)
    assert tolerance.worst(dq_b, dq, 1e-4, **kw)[1] <= 1.0
    lost = chip_smoke.dq_without_keys(port, *args[:6], 128, 192)
    assert tolerance.worst(lost, dq, 1e-4, **kw)[1] > 1.0
    # With nothing left out the sum of the two parts is the whole dq.
    whole = chip_smoke.dq_without_keys(port, *args[:6], 128, 128)
    assert tolerance.worst(whole, dq, 1e-4, **kw)[1] <= 1.0
    np.testing.assert_allclose(whole.numpy(), dq.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("launcher", ["_flash_dq_sm90", "_flash_dq_simt"])
def test_dq_launchers_take_only_cuda_tensors(launcher):
    q = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    st = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(port, launcher)(q, q, q, q, st, st, True, 0, 0)
