"""The bound that holds a kernel's output to its plain PyTorch version.

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` both call it. Every
element of ``mine`` is held to

    |mine - plain| <= atol + rtol * max|plain row| + step * |plain|
                      + 2 * max over the row of |plain_b - plain|

where a row is the last axis (D for o and the gradients), or the element
itself with ``rows=False`` (the stats m and l).

- ``rtol``: kernel and plain version do the same fp32 arithmetic in
  another summation order, which moves a result by a small fraction of
  its row's scale: 2e-5 forward, 1e-4 gradients.
- ``step``: both round a bf16 output to bf16, which may part them by one
  bf16 step of the element itself, 2^-7 of it (``BF16_STEP``); an fp16
  output by one fp16 step, 2^-10 (``FP16_STEP``); fp32 outputs have
  step 0.
- ``plain_b``: for the tensor-core (sm90) kernels only, the plain version
  with ``operands`` the input's 16-bit dtype, which rounds p (and ds) to
  that type where the kernel feeds them to the tensor cores. The
  kernel's rounding is of the same kind and size but not of the same
  values (the forward rounds p against the running row max, not the
  final one), so it is allowed twice
  the largest effect that this rounding alone has in the element's row:
  FlashAttention's own test criterion, taken per row so that the large
  early rows of a causal softmax do not set the bound for the small late
  ones.
- ``atol``: 1e-6, except ``DQ_ATOL`` for the tensor-core dq. A query that
  sees exactly one key (row 0 of a causal attention at equal offsets) has
  p = 1 and dp = delta, so its dq is 0 in exact arithmetic and every
  implementation returns the rounding noise of dp - delta (two fp32 sums
  of D products, |dp| ~ sqrt(D), whose roundings differ by about 1e-5
  between summation orders at D = 128) times scale and |k|. The row's
  own scale is then that noise, so only an absolute floor holds it. On
  an H100 at the main shape the sm90 dq's worst such element was 1.6e-6
  from the plain version, while every other row stayed within 0.53 of
  its bound at atol 1e-6.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

BF16_STEP = 2.0 ** -7
FP16_STEP = 2.0 ** -10


def step_of(dtype) -> float:
    """The rounding step of an output of this dtype (see ``step``)."""
    return {torch.bfloat16: BF16_STEP, torch.float16: FP16_STEP}.get(
        dtype, 0.0)
DQ_ATOL = 1e-5


def bound(plain: torch.Tensor, rtol: float, atol: float = 1e-6,
          step: float = 0.0, rows: bool = True,
          plain_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-element bound on |mine - plain|, as the module states it."""
    plain = plain.float()
    size = plain.abs()
    tol = atol + rtol * (size.amax(-1, keepdim=True) if rows else size)
    tol = tol + step * size
    if plain_b is not None:
        gap = (plain_b.float() - plain).abs()
        tol = tol + 2.0 * (gap.amax(-1, keepdim=True) if rows else gap)
    return tol


def worst(mine: torch.Tensor, plain: torch.Tensor, rtol: float,
          **kwargs) -> Tuple[float, float]:
    """(largest absolute error, largest err / bound) of ``mine`` against
    ``plain``; a ratio above 1 (or NaN) fails the bound."""
    err = (mine.float() - plain.float()).abs()
    ratio = (err / bound(plain, rtol, **kwargs)).max().item()
    return err.max().item(), ratio
