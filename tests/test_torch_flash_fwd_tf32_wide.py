"""The CPU side of the forward's streamed tensor-core designs
(csrc/flash_fwd_stream_sm90.cu): ``tf32``, fp32 at every head dim past 32
through 3xTF32, and ``stream``, bf16 and fp16 past D 512. The plain
forward's ``operands`` modes that the card's checks hold those kernels to,
against the reference's Pallas forward in interpret mode (blocks of 32, as
tests/test_torch_flash_head_dims.py runs it); the shared tolerance
(horovod_tpu_torch/utils/tolerance.py), which must pass 3xTF32 and fail
one TF32 product, a logit sum that lost a 64-column region of D and an
o whose columns lost their P V; and
the forward's dispatch and padding. The kernels themselves run on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances. The fp32 bound is the reference's own (tests/test_parallel.py:
2e-5 of the row for o; m and l element by element, m with an absolute
1e-5) and 3xTF32 is held to it unchanged: splitting x into hi = tf32(x)
and lo = tf32(x - hi) leaves |x - hi - lo| <= 2^-22 |x|, and the dropped
lo.lo product is below 2^-22 of the product, so 3xTF32 sits with fp32's
summation-order noise (about a tenth of the bound here) while one TF32
product (2^-11 of each factor) misses it many times over. The 16-bit
forward past D 512 rounds p to the input's type for the tensor cores;
against the reference that rounding moves o by at most (u |P| + floor)
@ |V| / l (u = 2^-8 bf16, 2^-11 fp16; floor 2^-25 for fp16 subnormals),
bounded here by (u + floor S) max|V|, as tests/test_torch_flash_sm90_wide.py
bounds it at D 256.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from horovod_tpu.parallel import flash_attention as ref
from horovod_tpu_torch import _cuda
from horovod_tpu_torch.parallel import flash_attention as port
from horovod_tpu_torch.utils import tolerance
from tests import torch_refpool
from tests.torch_threads import one_torch_thread  # noqa: F401

FWD_TOL = 2e-5
UNIT = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
FLOOR = {torch.bfloat16: 0.0, torch.float16: 2.0 ** -25}


def _values(seed, dtype, d, n=3, b=1, s=128, h=2):
    """Inputs that are exact values of ``dtype``, held as fp32."""
    rng = np.random.RandomState(seed)
    return [torch.tensor(rng.randn(b, s, h, d).astype(np.float32))
            .to(dtype).float() for _ in range(n)]


def _reference_job(seed, dtype, d):
    """A worker's job: the reference's (o, m, l) on
    ``_values(seed, dtype, d)``."""
    q, k, v = _values(seed, dtype, d)
    out = ref.flash_attention_stats(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), causal=True,
        block_q=32, block_k=32, interpret=True)
    return [torch.tensor(np.asarray(x)) for x in out]


def _reference_stats(seed, dtype, d):
    """The pool's ``_reference_job`` result for these arguments."""
    return torch_refpool.result((__name__, seed, dtype, d))


BOUND_DIMS = [32, 128, 640]
PAST_512 = [(torch.bfloat16, 640), (torch.float16, 640),
            (torch.bfloat16, 1024), (torch.float16, 1024)]
PADDED = [(torch.float32, 100, "tf32", 128), (torch.float32, 48, "tf32", 64),
          (torch.bfloat16, 600, "stream", 640),
          (torch.float16, 530, "stream", 576)]


def _jobs():
    """Every reference result the module's tests read, as
    ``torch_refpool`` jobs."""
    args = [(d, torch.float32, d) for d in BOUND_DIMS]
    args += [(d + 1, t, d) for t, d in PAST_512]
    args += [(d + 2, t, d) for t, d, _, _ in PADDED]
    return [((__name__, *a), _reference_job, a) for a in args]


torch_refpool.register(_jobs)


@pytest.fixture(autouse=True, scope="module")
def _references():
    torch_refpool.start()


def _fp32_ratios(mine, want):
    """err / bound of o, m and l under the fp32 forward bound."""
    (o, m, l), (o_r, m_r, l_r) = mine, want
    return (tolerance.worst(o, o_r, FWD_TOL)[1],
            tolerance.worst(m, m_r, FWD_TOL, atol=1e-5, rows=False)[1],
            tolerance.worst(l, l_r, FWD_TOL, rows=False)[1])


def test_tf32_rounding_keeps_ten_mantissa_bits_to_nearest():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0e-30])
    t = port._tf32(x)
    assert torch.all(t.view(torch.int32) & 0x1FFF == 0)
    # a tie goes away from zero, either sign; below half a step, down
    assert t[0].item() == 1.0 + 2.0 ** -10
    assert t[1].item() == 1.0 + 2.0 ** -10
    assert t[2].item() == -(1.0 + 2.0 ** -10)
    assert t[3].item() == 1.0
    y = torch.tensor(np.random.RandomState(0).randn(4096).astype(np.float32))
    hi = port._tf32(y)
    lo = port._tf32(y - hi)
    assert torch.all((y - hi).abs() <= 2.0 ** -11 * y.abs())
    assert torch.all((y - hi - lo).abs() <= 2.0 ** -22 * y.abs())


@pytest.mark.parametrize("d", BOUND_DIMS)
def test_3xtf32_forward_holds_the_fp32_bound_against_reference(d):
    q, k, v = _values(d, torch.float32, d)
    want = _reference_stats(d, torch.float32, d)
    mine = port._flash_fwd_plain(q, k, v, True, 0, 0, operands=port.TF32X3)
    assert max(_fp32_ratios(mine, want)) <= 1.0


@pytest.mark.parametrize("d", BOUND_DIMS)
def test_one_tf32_product_fails_the_fp32_bound(d):
    """Why the tf32 kernel takes three products: one alone misses the
    reference's fp32 bound by far more than its summation order."""
    q, k, v = _values(d, torch.float32, d)
    want = _reference_stats(d, torch.float32, d)
    mine = port._flash_fwd_plain(q, k, v, True, 0, 0, operands=port.TF32)
    assert max(_fp32_ratios(mine, want)) > 10.0


@pytest.mark.parametrize("dtype,d", PAST_512)
def test_16bit_forward_past_512_matches_reference(dtype, d):
    """The plain forward with 16-bit p, what the stream kernel is held to,
    against the reference on the same 16-bit values in fp32: only the
    rounding of p differs beyond the fp32 bounds; m and l stay fp32."""
    q, k, v = _values(d + 1, dtype, d)
    o_ref, m_ref, l_ref = _reference_stats(d + 1, dtype, d)
    o, m, l = port._flash_fwd_plain(q, k, v, True, 0, 0, operands=dtype)
    limit = (UNIT[dtype] + FLOOR[dtype] * q.shape[1]) * v.abs().amax()
    np.testing.assert_allclose(o.numpy(), o_ref.numpy(),
                               atol=limit.item() + FWD_TOL, rtol=0)
    ratios = _fp32_ratios((o_ref, m, l), (o_ref, m_ref, l_ref))
    assert max(ratios[1:]) <= 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bound_rejects_a_lost_head_dim_region(dtype):
    """A logit sum that left out one 64-column region of D (q and k zeroed
    in columns 256-319, as chip_smoke's check at bf16 D 640 builds it)
    fails the bound the card holds the kernels to: the 16-bit form with
    one output step and twice the p-rounding gap, or fp32's."""
    q, k, v = _values(7, dtype, 640)
    operands = dtype if dtype != torch.float32 else None
    o = port._flash_fwd_plain(q, k, v, True, 0, 0)[0]
    o_b = (port._flash_fwd_plain(q, k, v, True, 0, 0, operands=operands)[0]
           if operands else None)
    lost = chip_smoke.fwd_without_columns(port, q, k, v, 256, 320)
    kw = dict(step=tolerance.step_of(dtype), plain_b=o_b)
    assert tolerance.worst(o, o, FWD_TOL, **kw)[1] == 0.0
    assert tolerance.worst(lost, o, FWD_TOL, **kw)[1] > 1.0


@pytest.mark.parametrize("entry", ["hvdt_flash_fwd_stream",
                                   "hvdt_flash_fwd_tf32",
                                   "hvdt_flash_fwd_tf32_split",
                                   "hvdt_flash_fwd_tf32_part"])
def test_forward_c_entries_take_what_the_bindings_pass(entry):
    """The C entry points of csrc/flash_fwd_stream_sm90.cu declare as many
    parameters as horovod_tpu_torch/_cuda.py's ctypes signature passes
    (the library is built and loaded on the card only)."""
    with open(os.path.join(_cuda.CSRC_DIR, "flash_fwd_stream_sm90.cu")) as fh:
        src = fh.read()
    decl = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    assert decl, entry
    assert len(decl.group(1).split(",")) == len(_cuda._SIGNATURES[entry])


def test_bound_rejects_lost_pv_columns_of_a_wide_part():
    """An o whose columns 384-511 lost their P V (v zeroed there: the
    last two 64-column P V pieces of the wide tf32 build's second
    256-column part, which its producer issues only as the first two are
    consumed; a wrong piece offset or V^T stage would lose them) fails
    the fp32 bound by more than chip_smoke.py's LOST_FP32_BY, as the card
    checks the wide build at fp32 D 640 (here B 1, S 128, H 2)."""
    q, k, v = _values(8, torch.float32, 640)
    o = port._flash_fwd_plain(q, k, v, True, 0, 0, operands=port.TF32X3)[0]
    lo, hi = chip_smoke.LOST_C4["fp32_d640"]["fwd_pv_columns"]
    assert (lo, hi) == (384, 512)
    lost = chip_smoke.fwd_without_pv_columns(port, q, k, v, lo, hi)
    assert not lost[..., lo:hi].any() and lost[..., :lo].abs().max() > 0
    assert tolerance.worst(lost, o, FWD_TOL)[1] > chip_smoke.LOST_FP32_BY


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_forward_is_on_tensor_cores_past_head_dim_32(dtype):
    """On CUDA tensors the forward never takes the simt kernel: sm90 or
    stream for 16-bit (sm90's narrow builds at D <= 32), tf32 for fp32 at
    every D (its narrow builds of 16 and 32 up to D 32), each at a head
    dim it is built for within one region width of D (16 at the narrow
    builds)."""
    for d in range(1, 1200):
        design = port._design(dtype, d, "fwd")
        assert design != "simt", d
        if dtype == torch.float32:
            assert design == "tf32", d
        built = port.padded_head_dim(d, design, "fwd")
        assert d <= built
        if d <= 32:
            assert built == (16 if d <= 16 else 32)
        elif design in port.STREAM_DESIGNS:
            assert built - d < port.STREAM_DESIGNS[design][2]


@pytest.mark.parametrize("dtype,d,design,built", PADDED)
def test_forward_padding_on_plain_versions_matches_reference(dtype, d,
                                                             design, built):
    """What the card runs at a head dim the design is not built for, with
    the plain version (in the design's operand mode) in the kernel's
    place: zero-padded to ``built``, scaled by the true D, sliced back,
    within the reference's bound (fp32; 16-bit with the p-rounding limit
    of the test above)."""
    assert port._design(dtype, d, "fwd") == design
    assert port.padded_head_dim(d, design, "fwd") == built
    q, k, v = _values(d + 2, dtype, d)
    operands = port.TF32X3 if design == "tf32" else dtype

    def plain(*a, scale=None):
        return port._flash_fwd_plain(*a, operands=operands, scale=scale)
    o, m, l = port._on_padded_head_dim(plain, (q, k, v), True, 0, 0,
                                       design=design, kernel="fwd")
    assert o.shape == q.shape
    want = _reference_stats(d + 2, dtype, d)
    if design == "tf32":
        assert max(_fp32_ratios((o, m, l), want)) <= 1.0
    else:
        limit = (UNIT[dtype] + FLOOR[dtype] * q.shape[1]) * v.abs().amax()
        np.testing.assert_allclose(o.numpy(), want[0].numpy(),
                                   atol=limit.item() + FWD_TOL, rtol=0)
