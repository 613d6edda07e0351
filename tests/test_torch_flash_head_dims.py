"""The head dims and dtypes the reference's flash attention takes beyond
the kernels' first set: D 96, a head dim no kernel is built for (80, run
zero-padded at 96 on the card) and fp16, the port's plain path against
the reference's Pallas kernels in interpret mode on the CPU.

Tolerances: fp32 is held to the reference's own 2e-5 forward and 1e-4
gradient (tests/test_parallel.py). fp16 is held to the bound of
horovod_tpu_torch/utils/tolerance.py that the card's checks use for
16-bit outputs: both compute in fp32 from the same fp16 inputs and round
the output once, so an element may differ by 2e-5 (forward) or 1e-4
(gradients) of its row's largest value plus one fp16 step (2^-10) of
itself. The fp16 backward is compared from the same o, stats and do
(``flash_attention_bwd``), so that the forward's own rounding does not
feed the gradients twice.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.parallel import flash_attention as ref
from horovod_tpu_torch.parallel import flash_attention as port
from horovod_tpu_torch.utils import tolerance
from tests import torch_refpool
from tests.torch_threads import one_torch_thread  # noqa: F401

FWD_TOL = 2e-5
GRAD_TOL = 1e-4


def _inputs(seed, d, n=3, b=1, s=64, h=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, h, d).astype(np.float32) for _ in range(n)]


def _ref_flash(q, k, v):
    return ref.flash_attention(q, k, v, causal=True, block_q=32,
                               block_k=32, interpret=True)


def _host(tree):
    """A reference result as numpy arrays, to come back from a worker."""
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def _fp32_ref(d):
    """A worker's job: the reference's output and the gradients of
    sum(out ** 2) on ``_inputs(d, d)``, from one compiled program (the
    forward and its VJP with the cotangent 2 out)."""
    import jax
    qn, kn, vn = _inputs(d, d)
    qj, kj, vj = map(jnp.asarray, (qn, kn, vn))

    def both(*a):
        out, vjp = jax.vjp(_ref_flash, *a)
        return out, vjp(2.0 * out)
    return _host(jax.jit(both)(qj, kj, vj))


FP32_DIMS = [96, 80]
FP16_DIMS = [64, 96]


@pytest.mark.parametrize("d", FP32_DIMS)
def test_fp32_head_dim_matches_reference(d):
    qn, kn, vn = _inputs(d, d)
    out_ref, grads_ref = torch_refpool.result((__name__, "fp32", d))
    q, k, v = (torch.tensor(x, requires_grad=True) for x in (qn, kn, vn))
    out = port.flash_attention(q, k, v)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               atol=FWD_TOL)
    for mine, theirs in zip((q.grad, k.grad, v.grad), grads_ref):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   atol=GRAD_TOL)


def _d80_ref():
    """A worker's job: the reference's stats and backward at D 80."""
    qn, kn, vn, don = _inputs(7, 80, n=4)
    o_r, m_r, l_r = ref.flash_attention_stats(
        *map(jnp.asarray, (qn, kn, vn)), causal=True, block_q=32,
        block_k=32, interpret=True)
    grads_ref = ref.flash_attention_bwd(
        *map(jnp.asarray, (qn, kn, vn)), o_r, m_r, l_r, jnp.asarray(don),
        causal=True, block_q=32, block_k=32, interpret=True)
    return _host((o_r, m_r, l_r, grads_ref))


def test_padding_helper_on_plain_versions_matches_reference_at_d80():
    """What the card runs at D 80 (the D 96 kernel on zero-padded inputs
    with the scale of D 80), with the plain versions in the kernels'
    place: equal to the unpadded plain versions, and to the reference."""
    qn, kn, vn, don = _inputs(7, 80, n=4)
    q, k, v, do = map(torch.tensor, (qn, kn, vn, don))
    o, m, l = port._on_padded_head_dim(port._flash_fwd_plain, (q, k, v),
                                       True, 0, 0, design="simt",
                                       kernel="fwd")
    o_p, m_p, l_p = port._flash_fwd_plain(q, k, v, True, 0, 0)
    assert o.shape == q.shape
    for mine, plain in ((o, o_p), (m, m_p), (l, l_p)):
        np.testing.assert_allclose(mine.numpy(), plain.numpy(), atol=1e-6)
    o_r, m_r, l_r, grads_ref = torch_refpool.result((__name__, "d80"))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_r), atol=FWD_TOL)
    lse = port._lse_from_stats(m_p, l_p)
    delta = (do * o_p).sum(-1).transpose(1, 2).contiguous()
    args = (lse, delta, True, 0, 0)
    dq = port._on_padded_head_dim(port._flash_dq_plain, (q, k, v, do), *args,
                                  design="simt", kernel="dq")
    dk, dv = port._on_padded_head_dim(port._flash_dkv_plain, (q, k, v, do),
                                      *args, design="simt", kernel="dkv")
    plain = (port._flash_dq_plain(q, k, v, do, *args),
             *port._flash_dkv_plain(q, k, v, do, *args))
    for mine, p, theirs in zip((dq, dk, dv), plain, grads_ref):
        assert mine.shape == q.shape
        np.testing.assert_allclose(mine.numpy(), p.numpy(), atol=1e-6)
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   atol=GRAD_TOL)


def _within(mine, theirs, rtol):
    err, ratio = tolerance.worst(
        mine, torch.tensor(np.asarray(theirs.astype(jnp.float32))), rtol,
        step=tolerance.FP16_STEP)
    assert mine.dtype == torch.float16
    assert ratio <= 1.0, (err, ratio)


def _fp16_ref(d):
    """A worker's job: the reference's stats and backward in fp16."""
    qn, kn, vn, don = _inputs(11 + d, d, n=4)
    qj, kj, vj, doj = (jnp.asarray(x, jnp.float16)
                       for x in (qn, kn, vn, don))
    o_r, m_r, l_r = ref.flash_attention_stats(
        qj, kj, vj, causal=True, block_q=32, block_k=32, interpret=True)
    grads_ref = ref.flash_attention_bwd(
        qj, kj, vj, o_r, m_r, l_r, doj, causal=True, block_q=32,
        block_k=32, interpret=True)
    return _host((o_r, m_r, l_r, grads_ref))


def _jobs():
    """Every reference result the module's tests read, as
    ``torch_refpool`` jobs."""
    return ([((__name__, "fp32", d), _fp32_ref, (d,)) for d in FP32_DIMS]
            + [((__name__, "d80"), _d80_ref, ())]
            + [((__name__, "fp16", d), _fp16_ref, (d,)) for d in FP16_DIMS])


torch_refpool.register(_jobs)


@pytest.fixture(autouse=True, scope="module")
def _references():
    torch_refpool.start()


@pytest.mark.parametrize("d", FP16_DIMS)
def test_fp16_matches_reference(d):
    qn, kn, vn, don = _inputs(11 + d, d, n=4)
    o_r, m_r, l_r, grads_ref = torch_refpool.result((__name__, "fp16", d))
    q, k, v, do = (torch.tensor(x).half() for x in (qn, kn, vn, don))
    o, m, l = port.flash_attention_stats(q, k, v)
    _within(o, o_r, FWD_TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_r), atol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(l_r), rtol=1e-5)
    o_rt = torch.tensor(np.asarray(o_r.astype(jnp.float32))).half()
    grads = port.flash_attention_bwd(q, k, v, o_rt, torch.tensor(
        np.asarray(m_r)), torch.tensor(np.asarray(l_r)), do)
    for mine, theirs in zip(grads, grads_ref):
        _within(mine, theirs, GRAD_TOL)


def test_cuda_head_dims_pad_to_the_next_built_one_and_stop_at_256():
    # The simt ladder; past 512 (ROADMAP.md C4, closed) the next multiple
    # of 64, where the chunked kernels run.
    for kern in port.KERNELS:
        assert [port.padded_head_dim(d, "simt", kern)
                for d in (8, 16, 48, 80, 96, 100, 200, 256, 257, 320, 384,
                          400, 512, 513, 640)] == \
            [16, 16, 64, 96, 96, 128, 256, 256, 384, 384, 384, 512, 512,
             576, 640]
    assert port._design(torch.bfloat16, 48, "dq") == "sm90"
    # D 80 and fp16 D 128: the forward and dq both on the sm90 kernels (D
    # 80 padded to 128 for each; the simt dq would run it at 96).
    assert port._design(torch.bfloat16, 80, "fwd") == "sm90"
    assert port._design(torch.bfloat16, 80, "dq") == "sm90"
    assert port._design(torch.float16, 128, "fwd") == "sm90"
    assert port._design(torch.float16, 128, "dq") == "sm90"
