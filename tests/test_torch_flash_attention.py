"""The port's flash attention (horovod_tpu_torch.parallel.flash_attention)
against the reference's Pallas kernels run in interpret mode on the CPU.

On the CPU the port's wrappers compute with their plain PyTorch versions,
so these tests hold the plain versions, the autograd wiring, the stats,
the fallback and the errors to the reference. Tolerances are the
reference's own (tests/test_parallel.py): 2e-5 forward, 1e-4 gradients,
fp32 throughout. The kernels themselves are held to the plain versions
on the card (tests/test_torch_cuda.py and chip_smoke.py). The reference's
results are computed in the worker pool of ``tests/torch_refpool.py``,
registered at import (``_jobs``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.parallel import flash_attention as ref
from horovod_tpu_torch.parallel import flash_attention as port
from tests import torch_refpool
from tests.torch_threads import one_torch_thread  # noqa: F401

FWD_TOL = 2e-5
GRAD_TOL = 1e-4


def _inputs(seed, b, s, h, d, sk=None):
    rng = np.random.RandomState(seed)
    sk = s if sk is None else sk
    return (rng.randn(b, s, h, d).astype(np.float32),
            rng.randn(b, sk, h, d).astype(np.float32),
            rng.randn(b, sk, h, d).astype(np.float32))


def _ref_flash(q, k, v, causal, q_offset, k_offset):
    return ref.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                               k_offset=k_offset, block_q=32, block_k=32,
                               interpret=True)


def _ref_default(q, k, v, causal, q_offset, k_offset):
    """The reference at its default blocks, which take a sequence shorter
    than 128 (the ladders' smallest entry) as one block."""
    return ref.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                               k_offset=k_offset, interpret=True)


def _ref_and_grads(fn, *xs):
    """(fn(*xs), the gradients of sum(fn(*xs) ** 2) in xs) of a reference
    function, from one compiled program: the forward's output and its
    VJP with the cotangent 2 out, which is the loss's gradient."""
    def both(*args):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(2.0 * out)
    return jax.jit(both)(*map(jnp.asarray, xs))


def _host(tree):
    """A reference result as numpy arrays, to come back from a worker."""
    return jax.tree_util.tree_map(np.asarray, tree)


CASES = [
    pytest.param(True, 0, 0, id="causal"),
    pytest.param(False, 0, 0, id="noncausal"),
    pytest.param(True, 64, 0, id="kv_in_the_past"),
    pytest.param(True, 16, 32, id="partly_dead_rows"),
    pytest.param(True, 0, 64, id="kv_in_the_future"),
]


def _fwd_grads_ref(causal, q_offset, k_offset):
    qn, kn, vn = _inputs(3, 2, 64, 2, 16)
    return _host(_ref_and_grads(
        lambda q, k, v: _ref_flash(q, k, v, causal, q_offset, k_offset),
        qn, kn, vn))


@pytest.mark.parametrize("causal,q_offset,k_offset", CASES)
def test_flash_attention_forward_and_grads_match_reference(
        causal, q_offset, k_offset):
    qn, kn, vn = _inputs(3, 2, 64, 2, 16)

    out_ref, grads_ref = torch_refpool.result(
        (__name__, "fwd", causal, q_offset, k_offset))

    q, k, v = (torch.tensor(x, requires_grad=True) for x in (qn, kn, vn))
    out = port.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                               k_offset=k_offset)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               atol=FWD_TOL)
    for mine, theirs in zip((q.grad, k.grad, v.grad), grads_ref):
        assert np.all(np.isfinite(mine.numpy()))
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   atol=GRAD_TOL)


def test_flash_attention_tensor_offsets_match_int_offsets():
    qn, kn, vn = _inputs(4, 1, 64, 1, 16)
    q, k, v = map(torch.tensor, (qn, kn, vn))
    a = port.flash_attention(q, k, v, q_offset=torch.tensor(16),
                             k_offset=torch.tensor(32))
    b = port.flash_attention(q, k, v, q_offset=16, k_offset=32)
    assert torch.equal(a, b)


def _dead_rows_ref():
    qn, kn, vn = _inputs(8, 1, 64, 2, 8)
    return _host(ref.flash_attention_stats(
        *map(jnp.asarray, (qn, kn, vn)), causal=True, k_offset=40,
        block_q=32, block_k=32, interpret=True))


def test_flash_attention_stats_match_reference_with_dead_rows():
    qn, kn, vn = _inputs(8, 1, 64, 2, 8)
    # k_offset 40: queries 0..39 see no key (dead rows: m = -1e30, l = 0).
    o_r, m_r, l_r = torch_refpool.result((__name__, "dead_rows"))
    o, m, l = port.flash_attention_stats(
        *map(torch.tensor, (qn, kn, vn)), causal=True, k_offset=40)
    assert m.shape == l.shape == (1, 2, 64)
    assert m.dtype == l.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(o_r), atol=FWD_TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_r), atol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(l_r), rtol=1e-5,
                               atol=1e-6)
    assert np.all(l.numpy()[:, :, :40] == 0.0)
    assert np.all(m.numpy()[:, :, :40] == np.float32(-1e30))


def _external_stats_ref():
    qn, kn, vn = _inputs(9, 2, 64, 2, 16)
    don = np.random.RandomState(10).randn(2, 64, 2, 16).astype(np.float32)
    jq, jk, jv, jdo = map(jnp.asarray, (qn, kn, vn, don))
    o_r, m_r, l_r = ref.flash_attention_stats(
        jq, jk, jv, causal=True, q_offset=32, block_q=32, block_k=32,
        interpret=True)
    grads_ref = ref.flash_attention_bwd(
        jq, jk, jv, o_r, m_r, l_r, jdo, causal=True, q_offset=32,
        block_q=32, block_k=32, interpret=True)
    return _host((o_r, m_r, l_r, grads_ref))


def test_flash_attention_bwd_with_external_stats_matches_reference():
    qn, kn, vn = _inputs(9, 2, 64, 2, 16)
    don = np.random.RandomState(10).randn(2, 64, 2, 16).astype(np.float32)
    o_r, m_r, l_r, grads_ref = torch_refpool.result(
        (__name__, "external_stats"))
    # The port's backward fed the reference's own stats and output.
    grads = port.flash_attention_bwd(
        *map(torch.tensor, (qn, kn, vn)), torch.tensor(np.asarray(o_r)),
        torch.tensor(np.asarray(m_r)), torch.tensor(np.asarray(l_r)),
        torch.tensor(don), causal=True, q_offset=32)
    for mine, theirs in zip(grads, grads_ref):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   atol=GRAD_TOL)


def _indivisible_ref():
    qn, kn, vn = _inputs(5, 1, 200, 1, 8)
    return _host(_ref_flash(*map(jnp.asarray, (qn, kn, vn)), True, 0, 0))


def test_flash_attention_indivisible_causal_falls_back_to_dense():
    # 200 is 128 or more and neither a multiple of the port's 64-row tiles
    # nor of the reference's 32-row blocks: both take the dense
    # formulation.
    qn, kn, vn = _inputs(5, 1, 200, 1, 8)
    out_ref = torch_refpool.result((__name__, "indivisible"))
    q, k, v = (torch.tensor(x, requires_grad=True) for x in (qn, kn, vn))
    port.reset_launch_counts()
    out = port.flash_attention(q, k, v, causal=True)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               atol=FWD_TOL)
    assert q.grad is not None and np.all(np.isfinite(q.grad.numpy()))
    dense = port._dense_reference(*map(torch.tensor, (qn, kn, vn)), True)
    np.testing.assert_allclose(out.detach().numpy(), dense.numpy(),
                               atol=FWD_TOL)


def test_flash_attention_indivisible_noncausal_raises():
    # S = 200: the reference's default block there is 128, which does not
    # divide it, and the port takes no length of 128 or more that is not
    # a multiple of 64.
    qn, kn, vn = _inputs(6, 1, 200, 1, 8)
    with pytest.raises(ValueError):
        _ref_default(*map(jnp.asarray, (qn, kn, vn)), False, 0, 0)
    with pytest.raises(ValueError):
        port.flash_attention(*map(torch.tensor, (qn, kn, vn)), causal=False)
    for fn in (port.flash_attention_stats, ref.flash_attention_stats):
        with pytest.raises(ValueError):
            fn(qn, kn, vn, causal=True)


RAGGED_LENGTHS = [96, 100, 127]
# (Sq, Sk, q_offset, k_offset): unequal ragged lengths, offsets that put
# the causal diagonal through the ragged ends.
UNEQUAL_LENGTHS = [(100, 127, 27, 0), (64, 100, 36, 0), (127, 96, 0, 31)]


def _default_grads_ref(qn, kn, vn, causal, qo, ko):
    """(output, (dq, dk, dv)) of the reference at its default blocks, for
    the loss sum(out ** 2)."""
    return _host(_ref_and_grads(
        lambda q, k, v: _ref_default(q, k, v, causal, qo, ko), qn, kn, vn))


def _ragged_inputs(s):
    return _inputs(s, 2, s, 2, 16)


def _unequal_inputs(sq, sk):
    qn = _inputs(sq, 1, sq, 2, 16)[0]
    _, kn, vn = _inputs(sk, 1, sk, 2, 16)
    return qn, kn, vn


def _flash_and_grads(key, qn, kn, vn, causal, qo, ko):
    """(output, (dq, dk, dv)) of the reference at its default blocks (the
    pool's result ``key``) and of the port, for the loss
    sum(out ** 2)."""
    theirs = torch_refpool.result(key)
    q, k, v = (torch.tensor(x, requires_grad=True) for x in (qn, kn, vn))
    out = port.flash_attention(q, k, v, causal=causal, q_offset=qo,
                               k_offset=ko)
    (out ** 2).sum().backward()
    return theirs, (out.detach(), (q.grad, k.grad, v.grad))


def _assert_flash_matches(theirs, mine):
    np.testing.assert_allclose(mine[0].numpy(), np.asarray(theirs[0]),
                               atol=FWD_TOL)
    for g, want in zip(mine[1], theirs[1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                   atol=GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", RAGGED_LENGTHS)
def test_ragged_lengths_under_128_match_reference_defaults(s, causal):
    """A length under 128 that is no multiple of 64 runs the kernels (on
    the CPU their plain versions), as the reference's default blocks run
    it as one block: output and gradients agree."""
    _assert_flash_matches(*_flash_and_grads(
        (__name__, "ragged", s, causal), *_ragged_inputs(s), causal, 0, 0))


def _stats_bwd_inputs(sq, sk):
    qn = _inputs(sq + 1, 1, sq, 2, 16)[0]
    _, kn, vn = _inputs(sk + 2, 1, sk, 2, 16)
    don = np.random.RandomState(sq).randn(*qn.shape).astype(np.float32)
    return qn, kn, vn, don


def _stats_bwd_ref(sq, sk, qo, ko, causal):
    qn, kn, vn, don = _stats_bwd_inputs(sq, sk)
    jx = tuple(map(jnp.asarray, (qn, kn, vn)))
    offsets = dict(q_offset=qo, k_offset=ko)
    o_r, m_r, l_r = ref.flash_attention_stats(*jx, causal=causal,
                                              interpret=True, **offsets)
    grads_ref = ref.flash_attention_bwd(*jx, o_r, m_r, l_r,
                                        jnp.asarray(don), causal=causal,
                                        interpret=True, **offsets)
    return _host((o_r, m_r, l_r, grads_ref))


STATS_BWD_LENGTHS = [(s, s, 5, 0) for s in RAGGED_LENGTHS] + UNEQUAL_LENGTHS


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,qo,ko", STATS_BWD_LENGTHS)
def test_ragged_lengths_stats_and_bwd_match_reference_defaults(sq, sk, qo,
                                                               ko, causal):
    qn, kn, vn, don = _stats_bwd_inputs(sq, sk)
    offsets = dict(q_offset=qo, k_offset=ko)
    o_r, m_r, l_r, grads_ref = torch_refpool.result(
        (__name__, "stats_bwd", sq, sk, qo, ko, causal))
    o, m, l = port.flash_attention_stats(*map(torch.tensor, (qn, kn, vn)),
                                         causal=causal, **offsets)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_r), atol=FWD_TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_r), atol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(l_r), rtol=1e-5,
                               atol=1e-6)
    grads = port.flash_attention_bwd(
        *map(torch.tensor, (qn, kn, vn)), torch.tensor(np.asarray(o_r)),
        torch.tensor(np.asarray(m_r)), torch.tensor(np.asarray(l_r)),
        torch.tensor(don), causal=causal, **offsets)
    for mine, theirs in zip(grads, grads_ref):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   atol=GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,qo,ko", UNEQUAL_LENGTHS)
def test_unequal_ragged_lengths_match_reference_defaults(sq, sk, qo, ko,
                                                         causal):
    _assert_flash_matches(*_flash_and_grads(
        (__name__, "unequal", sq, sk, qo, ko, causal),
        *_unequal_inputs(sq, sk), causal, qo, ko))


DENSE_CASES = ((True, 0, 0), (False, 0, 0), (True, 8, 24))


def _dense_ref():
    qn, kn, vn = _inputs(7, 2, 48, 2, 8)
    return [_host(ref._dense_reference(*map(jnp.asarray, (qn, kn, vn)),
                                       causal, qo, ko))
            for causal, qo, ko in DENSE_CASES]


def test_dense_reference_matches_reference_dense():
    qn, kn, vn = _inputs(7, 2, 48, 2, 8)
    refs = torch_refpool.result((__name__, "dense"))
    for (causal, qo, ko), theirs in zip(DENSE_CASES, refs):
        mine = port._dense_reference(*map(torch.tensor, (qn, kn, vn)),
                                     causal, qo, ko)
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   atol=FWD_TOL)


def _jobs():
    """Every reference result the module's tests read, as
    ``torch_refpool`` jobs."""
    jobs = [((__name__, "fwd", *c.values), _fwd_grads_ref, c.values)
            for c in CASES]
    jobs += [((__name__, "dead_rows"), _dead_rows_ref, ()),
             ((__name__, "external_stats"), _external_stats_ref, ()),
             ((__name__, "indivisible"), _indivisible_ref, ()),
             ((__name__, "dense"), _dense_ref, ())]
    # in the order the tests read them
    both = (True, False)
    jobs += [((__name__, "ragged", s, causal), _default_grads_ref,
              (*_ragged_inputs(s), causal, 0, 0))
             for causal in both for s in RAGGED_LENGTHS]
    jobs += [((__name__, "stats_bwd", *c, causal), _stats_bwd_ref,
              (*c, causal)) for causal in both for c in STATS_BWD_LENGTHS]
    jobs += [((__name__, "unequal", *c, causal), _default_grads_ref,
              (*_unequal_inputs(*c[:2]), causal, *c[2:]))
             for causal in both for c in UNEQUAL_LENGTHS]
    return jobs


torch_refpool.register(_jobs)


@pytest.fixture(autouse=True, scope="module")
def _references():
    torch_refpool.start()


def test_cpu_path_launches_no_kernel():
    qn, kn, vn = _inputs(11, 1, 64, 2, 16)
    q, k, v = (torch.tensor(x, requires_grad=True) for x in (qn, kn, vn))
    port.reset_launch_counts()
    port.flash_attention(q, k, v).sum().backward()
    port.flash_attention_stats(q.detach(), k.detach(), v.detach())
    assert port.launch_counts() == {"flash_fwd": 0, "flash_fwd_sm90": 0,
                                    "flash_fwd_stream": 0,
                                    "flash_fwd_tf32": 0,
                                    "flash_dq": 0, "flash_dq_sm90": 0,
                                    "flash_dq_stream": 0,
                                    "flash_dq_tf32": 0,
                                    "flash_dkv": 0, "flash_dkv_sm90": 0,
                                    "flash_dkv_stream": 0,
                                    "flash_dkv_tf32": 0,
                                    "flash_bwd_sm90": 0,
                                    "flash_bwd_prep": 0}


def test_wrappers_reject_bad_inputs():
    q = torch.zeros(1, 64, 2, 16)
    with pytest.raises(ValueError):
        port._flash_fwd(q, torch.zeros(1, 64, 2, 8), q, True, 0, 0)
    with pytest.raises(TypeError):
        port._flash_fwd(q, q.double(), q, True, 0, 0)
