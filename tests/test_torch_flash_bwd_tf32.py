"""The CPU side of the tf32 backward (csrc/flash_bwd_tf32_sm90.cu: dq and
dk/dv in fp32 at every head dim past 32 through 3xTF32): the plain
versions' ``operands=TF32X3`` mode, which the card's checks hold those
kernels to, against the reference's Pallas backward in interpret mode
(blocks of 32, as tests/test_torch_flash_head_dims.py runs it); the bound
of horovod_tpu_torch/utils/tolerance.py, which must pass it and fail one
TF32 product, a dq that lost a kv tile, a dk/dv that lost a q tile and a
dq or dk/dv that lost a 64-column piece of a wide part; the backward's
design and padding for fp32 through ``_flash_bwd`` with the plain
versions in the kernels' place; and that the C entries of the kernels'
source take what the bindings pass. The kernels themselves run on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerance: the reference's fp32 gradient bound (tests/test_parallel.py),
per element 1e-4 of the largest value in its row (the last axis), plus an
absolute 1e-6, or ``tolerance.DQ_ATOL`` for dq (a query that sees one key
has a dq of pure rounding noise); no other allowance. 3xTF32 leaves each
product within 2^-21 of fp32 (the dropped lo.lo term and the parts'
rounding), under fp32's own summation-order noise at these sizes, while
one TF32 product (2^-11 of each factor) misses the bound many times over.

The reference's gradients are computed in the worker pool of
``tests/torch_refpool.py`` (``_jobs``).
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

GRAD_TOL = 1e-4


def _values(seed, d, b=1, sq=96, sk=None, h=2):
    """q, k, v, do made with numpy; k and v have sk rows (default sq)."""
    rng = np.random.RandomState(seed)
    rows = (sq, sk or sq, sk or sq, sq)
    return [torch.tensor(rng.randn(b, n, h, d).astype(np.float32))
            for n in rows]


def _args(q, k, v, do, causal, qo, ko):
    """The plain forward's (o, m, l) and the backward's arguments."""
    o, m, l = port._flash_fwd_plain(q, k, v, causal, qo, ko)
    lse = port._lse_from_stats(m, l)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    return (o, m, l), (q, k, v, do, lse, delta, causal, qo, ko)


def _reference(stats, args, block=32):
    """The reference's (dq, dk, dv) from the same stats, interpret mode;
    ``block`` None takes its default blocks."""
    q, k, v, do, _, _, causal, qo, ko = args
    out = ref.flash_attention_bwd(
        *(jnp.asarray(x.numpy()) for x in (q, k, v, *stats, do)),
        causal=causal, q_offset=qo, k_offset=ko, block_q=block,
        block_k=block, interpret=True)
    return [torch.tensor(np.asarray(x)) for x in out]


def _reference_of(seed, d, sq, sk, causal, qo, ko, block):
    """A worker's job: ``_reference`` for the inputs
    ``_values(seed, d, sq=sq, sk=sk)``."""
    stats, args = _args(*_values(seed, d, sq=sq, sk=sk), causal, qo, ko)
    return _reference(stats, args, block)


def _pooled(seed, d, sq=96, sk=None, causal=True, qo=0, ko=0, block=32):
    """The pool's ``_reference_of`` result for these arguments."""
    return torch_refpool.result(
        (__name__, seed, d, sq, sk, causal, qo, ko, block))


def _ratios(mine, want):
    """err / bound of dq, dk and dv under the fp32 gradient bound."""
    return (tolerance.worst(mine[0], want[0], GRAD_TOL,
                            atol=tolerance.DQ_ATOL)[1],
            tolerance.worst(mine[1], want[1], GRAD_TOL)[1],
            tolerance.worst(mine[2], want[2], GRAD_TOL)[1])


def _plain(args, operands):
    dq = port._flash_dq_plain(*args, operands=operands)
    return (dq, *port._flash_dkv_plain(*args, operands=operands))


def _jobs():
    """Every reference result the module's tests read, in their order, as
    ``torch_refpool`` jobs."""
    cases = [(d + c.values[1] + c.values[2], d, 96, None, *c.values, 32)
             for c in CONFIGS for d in BOUND_DIMS]
    cases.append((5, 128, 100, 127, True, 27, 0, None))
    cases += [(d, d, 96, None, True, 0, 0, 32) for d in ONE_TF32_DIMS]
    cases += [(d, d, 64, None, True, 0, 0, 32) for d, _ in PADDED]
    return [((__name__, *c), _reference_of, c) for c in cases]


torch_refpool.register(_jobs)


@pytest.fixture(autouse=True, scope="module")
def _references():
    torch_refpool.start()


CONFIGS = [
    # causal, q_offset, k_offset
    pytest.param(True, 0, 0, id="causal"),
    pytest.param(False, 0, 0, id="noncausal"),
    pytest.param(True, 32, 0, id="q_offset"),
    pytest.param(True, 0, 40, id="dead_rows"),
]


BOUND_DIMS = [64, 128, 320, 512, 640]
ONE_TF32_DIMS = [128, 320]
PADDED = [(48, 64), (100, 128), (320, 320), (600, 608)]


@pytest.mark.parametrize("causal,qo,ko", CONFIGS)
@pytest.mark.parametrize("d", BOUND_DIMS)
def test_3xtf32_backward_holds_the_fp32_bound_against_reference(d, causal,
                                                                qo, ko):
    stats, args = _args(*_values(d + qo + ko, d), causal, qo, ko)
    want = _pooled(d + qo + ko, d, causal=causal, qo=qo, ko=ko)
    assert max(_ratios(_plain(args, port.TF32X3), want)) <= 1.0


def test_3xtf32_backward_with_unequal_ragged_lengths():
    """Sq 100 and Sk 127 (the ragged ends the kernels mask), causal with
    the diagonal through both ends, against the reference at its default
    blocks (each sequence one block)."""
    stats, args = _args(*_values(5, 128, sq=100, sk=127), True, 27, 0)
    want = _pooled(5, 128, sq=100, sk=127, qo=27, block=None)
    assert max(_ratios(_plain(args, port.TF32X3), want)) <= 1.0


@pytest.mark.parametrize("d", ONE_TF32_DIMS)
def test_one_tf32_product_fails_the_fp32_gradient_bound(d):
    """Why the tf32 kernels take three products: one alone misses the
    reference's fp32 bound by far more than its summation order."""
    stats, args = _args(*_values(d, d), True, 0, 0)
    want = _pooled(d, d)
    assert max(_ratios(_plain(args, port.TF32), want)) > 10.0


def test_bound_rejects_a_dq_that_lost_a_kv_tile():
    """dq without keys 64-127 (one 64-key tile of the kernel) fails the
    bound that 3xTF32 passes."""
    _, args = _args(*_values(3, 128, sq=256), True, 0, 0)
    dq = port._flash_dq_plain(*args, operands=port.TF32X3)
    kw = dict(atol=tolerance.DQ_ATOL)
    assert tolerance.worst(dq, port._flash_dq_plain(*args), GRAD_TOL,
                           **kw)[1] <= 1.0
    lost = chip_smoke.dq_without_keys(port, *args[:6], 64, 128)
    assert tolerance.worst(lost, dq, GRAD_TOL, **kw)[1] > 10.0


def test_bound_rejects_a_dkv_that_lost_a_q_tile():
    """dk and dv without queries 128-191 (one 64-query tile of the kernel:
    do and delta zeroed there) fail the bound."""
    _, args = _args(*_values(4, 128, sq=256), True, 0, 0)
    dk, dv = port._flash_dkv_plain(*args, operands=port.TF32X3)
    q, k, v, do, lse, delta = args[:6]
    do_x, delta_x = do.clone(), delta.clone()
    do_x[:, 128:192] = 0
    delta_x[:, :, 128:192] = 0
    dk_x, dv_x = port._flash_dkv_plain(q, k, v, do_x, lse, delta_x,
                                       *args[6:])
    assert tolerance.worst(dk_x, dk, GRAD_TOL)[1] > 10.0
    assert tolerance.worst(dv_x, dv, GRAD_TOL)[1] > 10.0


def test_bound_rejects_lost_columns_of_a_wide_dkv_part():
    """dk and dv whose columns 448-511 were left out (zero: the second
    64-column piece of the wide tf32 dk/dv's fourth 128-column part, the
    piece its producer issues last in a tile; a wrong piece offset or T
    stage would lose it) fail the fp32 gradient bound by more than
    chip_smoke.py's LOST_FP32_BY, as the card checks the wide build at fp32
    D 640 (here B 1, S 128, H 2)."""
    _, args = _args(*_values(9, 640, sq=128), True, 0, 0)
    dk, dv = port._flash_dkv_plain(*args, operands=port.TF32X3)
    lo, hi = chip_smoke.LOST_C4["fp32_d640"]["dkv_columns"]
    assert (lo, hi) == (448, 512)
    lost = chip_smoke.dkv_without_columns(dk, dv, lo, hi)
    for got, want in zip(lost, (dk, dv)):
        assert not got[..., lo:hi].any()
        assert torch.equal(got[..., :lo], want[..., :lo])
        ratio = tolerance.worst(got, want, GRAD_TOL)[1]
        assert ratio > chip_smoke.LOST_FP32_BY


def _wide_constant(name, dkv):
    """An int constant of the wide builds' ``struct Wide`` in
    csrc/flash_bwd_tf32_sm90.cu, for dk/dv or for dq."""
    with open(os.path.join(_cuda.CSRC_DIR, "flash_bwd_tf32_sm90.cu")) as fh:
        body = fh.read().split("struct Wide {")[1].split("};")[0]
    value = re.search(r"static constexpr int " + name + r" = ([^;]+);",
                      body).group(1)
    ternary = re.fullmatch(r"kDkv \? (\d+) : (\d+)", value)
    return int(ternary.group(1 if dkv else 2)) if ternary else int(value)


def test_bound_rejects_lost_columns_of_a_wide_dq_part():
    """dq whose columns 448-511 (the last 64-column piece of the wide tf32
    dq's second 256-column part, the piece its producer issues last in a
    tile) or 576-639 (a piece of D 640's 128-column remainder) were left
    out (zero) fails the fp32 gradient bound with ``DQ_ATOL`` by more than
    chip_smoke.py's LOST_FP32_BY, as the card checks the wide build at
    fp32 D 640 (here B 1, S 128, H 2); the ranges follow the source's part
    width and piece."""
    part, piece = (_wide_constant(n, dkv=False) for n in ("kOut", "kPiece"))
    lost = chip_smoke.LOST_C4["fp32_d640"]["dq_columns"]
    assert lost == ((2 * part - piece, 2 * part), (640 - piece, 640))
    assert lost[1][0] >= 640 - 640 % part > lost[0][0]
    _, args = _args(*_values(10, 640, sq=128), True, 0, 0)
    dq = port._flash_dq_plain(*args, operands=port.TF32X3)
    for lo, hi in lost:
        got = chip_smoke.dq_without_columns(dq, lo, hi)
        assert not got[..., lo:hi].any()
        assert torch.equal(got[..., :lo], dq[..., :lo])
        ratio = tolerance.worst(got, dq, GRAD_TOL,
                                atol=tolerance.DQ_ATOL)[1]
        assert ratio > chip_smoke.LOST_FP32_BY


def test_tf32_dq_part_gives_the_narrow_builds_head_dim_on_the_cpu():
    """At D 16 and 32 the tf32 dq runs its narrow builds, which own the
    whole of dQ: ``tf32_dq_part`` says D there without the kernels'
    library (not built here). Past them the C entry answers from the
    source's parts: 128 columns, and 256 past D 128."""
    for d in port.TF32_NARROW_DIMS["dq"]:
        assert port.tf32_dq_part(d) == d
    with open(os.path.join(_cuda.CSRC_DIR, "flash_bwd_tf32_sm90.cu")) as fh:
        assert fh.read().count("constexpr int kWideDqAbove = 128;") == 1
    assert _wide_constant("kOut", dkv=False) == 256
    assert _wide_constant("kOut", dkv=True) == 128


@pytest.mark.parametrize("entry", ["hvdt_flash_bwd_tf32_split",
                                   "hvdt_flash_dq_tf32",
                                   "hvdt_flash_dq_tf32_part",
                                   "hvdt_flash_dkv_tf32",
                                   "hvdt_flash_dkv_tf32_part"])
def test_backward_c_entries_take_what_the_bindings_pass(entry):
    """The C entry points of csrc/flash_bwd_tf32_sm90.cu declare as many
    parameters as horovod_tpu_torch/_cuda.py's ctypes signature passes
    (the library is built and loaded on the card only)."""
    with open(os.path.join(_cuda.CSRC_DIR, "flash_bwd_tf32_sm90.cu")) as fh:
        src = fh.read()
    decl = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    assert decl, entry
    assert len(decl.group(1).split(",")) == len(_cuda._SIGNATURES[entry])


@pytest.mark.parametrize("d,built", PADDED)
def test_fp32_backward_design_and_padding_on_plain_versions(d, built):
    """On CUDA, fp32 dq and dk/dv take the tf32 design past D 32, padded
    to the next multiple of 32 once for both; ``_flash_bwd`` with the
    plain TF32X3 versions in the kernels' place runs them so, and gives
    the reference's gradients within the fp32 bound."""
    for kern in ("dq", "dkv"):
        assert port._design(torch.float32, d, kern) == "tf32"
        assert port.padded_head_dim(d, "tf32", kern) == built
    stats, args = _args(*_values(d, d, sq=64), True, 0, 0)
    seen = []

    def plain(fn):
        def run(*a, **kw):
            seen.append(a[:4])
            return fn(*a, operands=port.TF32X3, **kw)
        return run
    launchers = {("dq", "tf32"): plain(port._flash_dq_plain),
                 ("dkv", "tf32"): plain(port._flash_dkv_plain)}
    dq, (dk, dv) = port._flash_bwd(*args, launchers=launchers)
    assert len(seen) == 2 and all(a is b for a, b in zip(*seen))
    assert seen[0][0].shape[-1] == built
    for g in (dq, dk, dv):
        assert g.shape == args[0].shape and g.dtype == torch.float32
    assert max(_ratios((dq, dk, dv), _pooled(d, d, sq=64))) <= 1.0


def test_tf32_design_serves_every_kernel_and_stream_the_forward_alone():
    """tf32 serves all three kernels past D 32 streamed over D (and up to
    it, on their narrow builds, so it refuses no head dim); stream serves
    the 16-bit forward past 512 and dq and dk/dv past 256, and refuses a
    head dim at its start."""
    assert port.STREAM_DESIGNS["tf32"][1] == dict.fromkeys(port.KERNELS, 32)
    assert port.STREAM_DESIGNS["stream"][1] == {"fwd": 512, "dq": 256,
                                                "dkv": 256}
    for d in (33, 64, 96, 257, 1000):
        for kern in port.KERNELS:
            assert port._design(torch.float32, d, kern) == "tf32"
    for kern in port.KERNELS:
        assert port._design(torch.float32, 32, kern) == "tf32"
    assert port.padded_head_dim(32, "tf32", "dkv") == 32
    with pytest.raises(ValueError, match="forward past head dim 512 and "
                                         "the dq and dk/dv past head dim "
                                         "256"):
        port.padded_head_dim(256, "stream", "dkv")
