"""The CPU side of the tensor-core (sm90) flash-attention kernels: which
design a dtype and head dim get, the plain versions' ``operands``
rounding that the card's checks compare those kernels with, and the
shared tolerance (horovod_tpu_torch/utils/tolerance.py) that must pass
that rounding and fail a lost tile, as chip_smoke.py's check of it at
the main shape relies on. The kernels themselves run on the
card (tests/test_torch_cuda.py, chip_smoke.py).
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


def _bf16_values(seed, n=4, s=S, d=D):
    """Inputs that are exact bf16 values, held as fp32 and as bf16."""
    rng = np.random.RandomState(seed)
    xs = [torch.tensor(rng.randn(B, s, H, d).astype(np.float32))
          .to(torch.bfloat16) for _ in range(n)]
    return [x.float() for x in xs], xs


@pytest.mark.parametrize("dtype,d,design", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.float32, 96, "tf32"), (torch.float32, 256, "tf32"),
    (torch.float32, 64, "tf32"), (torch.float32, 128, "tf32")])
def test_design_by_dtype_and_head_dim(dtype, d, design):
    # These cases take one design for all three kernels: fp32 takes tf32
    # at every D (past 32 tests/test_torch_flash_fwd_tf32_wide.py and
    # tests/test_torch_flash_bwd_tf32.py; up to it
    # tests/test_torch_flash_fwd_tf32_narrow.py and
    # tests/test_torch_flash_bwd_tf32_narrow.py); where the kernels part
    # (the forward alone on sm90 at 16-bit D 257-512, on stream past it)
    # see tests/test_torch_flash_sm90_wide.py.
    for kernel in port.KERNELS:
        assert port._design(dtype, d, kernel) == design


def test_plain_forward_bf16_operands_within_provable_bound():
    (q, k, v), _ = _bf16_values(0, 3)
    o, m, l = port._flash_fwd_plain(q, k, v, True, 0, 0)
    o_b, m_b, l_b = port._flash_fwd_plain(q, k, v, True, 0, 0,
                                          operands=torch.bfloat16)
    assert torch.equal(m, m_b) and torch.equal(l, l_b)
    # Rounding p to bf16 moves each p by at most 2^-8 of itself, so o by
    # at most 2^-8 (|P| @ |V|) / l, plus fp32 noise.
    s, allowed = port._scores(q, k, True, 0, 0)
    p = torch.exp(s - m[..., None]) * allowed
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.abs())
    limit = 2.0 ** -8 * pv / l.transpose(1, 2)[..., None] + 1e-6
    assert torch.all((o_b - o).abs() <= limit)
    assert (o_b - o).abs().max() > 0


def test_plain_forward_bf16_operands_differ_with_bf16_inputs():
    _, (q, k, v) = _bf16_values(1, 3)
    o, m, l = port._flash_fwd_plain(q, k, v, False, 0, 0)
    o_b, m_b, l_b = port._flash_fwd_plain(q, k, v, False, 0, 0,
                                          operands=torch.bfloat16)
    assert o_b.dtype == torch.bfloat16
    assert not torch.equal(o, o_b)
    assert torch.equal(m, m_b) and torch.equal(l, l_b)


def test_plain_dkv_bf16_operands_within_provable_bound():
    (q, k, v, do), _ = _bf16_values(2)
    o, m, l = port._flash_fwd_plain(q, k, v, True, 0, 0)
    lse = port._lse_from_stats(m, l)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, True, 0, 0)
    dk, dv = port._flash_dkv_plain(*args)
    dk_b, dv_b = port._flash_dkv_plain(*args, operands=torch.bfloat16)
    p, ds = port._p_ds_plain(*args)
    lim_v = 2.0 ** -8 * torch.einsum("bhqk,bqhd->bkhd", p, do.abs())
    lim_k = 2.0 ** -8 * torch.einsum("bhqk,bqhd->bkhd", ds.abs(), q.abs())
    assert torch.all((dv_b - dv).abs() <= lim_v + 1e-6)
    assert torch.all((dk_b - dk).abs() <= lim_k + 1e-6)
    assert (dv_b - dv).abs().max() > 0 and (dk_b - dk).abs().max() > 0


def _fwd_ref():
    """A worker's job: the reference's forward (Pallas, interpret mode)
    on ``_bf16_values(3, 3, s=64, d=16)``."""
    (q, k, v), _ = _bf16_values(3, 3, s=64, d=16)
    return np.asarray(ref.flash_attention(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), causal=True,
        block_q=32, block_k=32, interpret=True))


def _jobs():
    """The reference result the module's tests read, as a
    ``torch_refpool`` job."""
    return [((__name__, "fwd"), _fwd_ref, ())]

torch_refpool.register(_jobs)


@pytest.fixture(autouse=True, scope="module")
def _references():
    torch_refpool.start()


def test_plain_bf16_operands_forward_matches_reference():
    # The reference's forward (Pallas, interpret mode) on the same
    # bf16-valued inputs, fp32 throughout: the rounding of p is the only
    # difference, inside the provable bound 2^-8 max|v| per element.
    (q, k, v), _ = _bf16_values(3, 3, s=64, d=16)
    theirs = torch_refpool.result((__name__, "fwd"))
    mine = port._flash_fwd_plain(q, k, v, True, 0, 0,
                                 operands=torch.bfloat16)[0]
    limit = 2.0 ** -8 * v.abs().amax().item() + 2e-5
    np.testing.assert_allclose(mine.numpy(), theirs, atol=limit, rtol=0)


def test_tolerance_passes_bf16_operands_and_fails_a_lost_kv_tile():
    _, (q, k, v) = _bf16_values(4, 3)
    o = port._flash_fwd_plain(q, k, v, True, 0, 0)[0]
    o_b = port._flash_fwd_plain(q, k, v, True, 0, 0,
                                operands=torch.bfloat16)[0]
    kw = dict(step=tolerance.BF16_STEP, plain_b=o_b)
    assert tolerance.worst(o_b, o, 2e-5, **kw)[1] <= 1.0
    lost = chip_smoke.fwd_without_keys(port, q, k, v, 128, 192)
    assert tolerance.worst(lost, o, 2e-5, **kw)[1] > 1.0
    # With nothing left out the merge is the whole forward.
    whole = chip_smoke.fwd_without_keys(port, q, k, v, 128, 128)
    assert tolerance.worst(whole, o, 2e-5, **kw)[1] <= 1.0


def test_tolerance_fails_a_lost_q_tile_in_dk_dv():
    _, (q, k, v, do) = _bf16_values(5)
    o, m, l = port._flash_fwd_plain(q, k, v, True, 0, 0)
    lse = port._lse_from_stats(m, l)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, True, 0, 0)
    plain = port._flash_dkv_plain(*args)
    plain_b = port._flash_dkv_plain(*args, operands=torch.bfloat16)
    do_x, delta_x = do.clone(), delta.clone()
    do_x[:, 128:192] = 0
    delta_x[:, :, 128:192] = 0
    lost = port._flash_dkv_plain(q, k, v, do_x, lse, delta_x, True, 0, 0)
    for mine, p, pb in zip(lost, plain, plain_b):
        kw = dict(step=tolerance.BF16_STEP, plain_b=pb)
        assert tolerance.worst(pb, p, 1e-4, **kw)[1] <= 1.0
        assert tolerance.worst(mine, p, 1e-4, **kw)[1] > 1.0


def test_bound_terms():
    plain = torch.tensor([[1.0, -4.0], [0.0, 2.0]])
    plain_b = plain + torch.tensor([[0.5, 0.0], [0.0, 0.0]])
    tol = tolerance.bound(plain, 0.1, atol=0.0, step=0.5, plain_b=plain_b)
    # atol + rtol * max|row| + step * |x| + 2 * max|plain_b - plain| in row
    assert torch.equal(tol, torch.tensor([[0.4 + 0.5 + 1.0, 0.4 + 2.0 + 1.0],
                                          [0.2, 0.2 + 1.0]]))
    elem = tolerance.bound(plain, 0.1, atol=1.0, rows=False)
    assert torch.allclose(elem, 1.0 + 0.1 * plain.abs())


def test_sm90_launchers_take_only_cuda_tensors():
    q = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        port._flash_fwd_sm90(q, q, q, True, 0, 0)
    st = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        port._flash_dkv_sm90(q, q, q, q, st, st, True, 0, 0)
