"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one.

This file imports neither JAX nor horovod_tpu, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances, for every element: with fp32 inputs (TF32 off) kernel and
plain version do the same fp32 arithmetic in another order, so they
agree to 2e-5 of the largest value in the element's row (its last axis)
for the forward and 1e-4 for gradients; m and l are held element by
element. With bf16 inputs both compute in fp32 from the same bf16 values
and round the output to bf16, which may part them by one more bf16 step
of the element itself (2^-7 of it).
"""

import pytest
import torch

from horovod_tpu_torch.parallel import flash_attention as fa


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(mine, plain, rtol, atol, step=0.0, rows=True):
    size = plain.float().abs()
    scale = size.amax(-1, keepdim=True) if rows else size
    err = (mine.float() - plain.float()).abs()
    ratio = (err / (atol + rtol * scale + step * size)).max().item()
    assert ratio <= 1.0, (err.max().item(), ratio)


CASES = [
    # b, s, h, d, causal, q_offset, k_offset
    pytest.param(2, 256, 4, 128, True, 0, 0, id="causal_d128"),
    pytest.param(1, 128, 2, 64, False, 0, 0, id="noncausal_d64"),
    pytest.param(1, 192, 2, 64, True, 128, 0, id="q_offset"),
    pytest.param(1, 128, 2, 32, True, 0, 96, id="dead_rows"),
    pytest.param(2, 40, 3, 16, True, 0, 0, id="short_ragged"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,d,causal,qo,ko", CASES)
def test_kernels_match_plain_versions(cuda, dtype, b, s, h, d, causal, qo,
                                      ko):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(s + d)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=cuda).to(dt)
                   for _ in range(4))
    fa.reset_launch_counts()
    o, m, l = fa._flash_fwd(q, k, v, causal, qo, ko)
    o_p, m_p, l_p = fa._flash_fwd_plain(q, k, v, causal, qo, ko)
    lse = fa._lse_from_stats(m_p, l_p)
    delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa._flash_dq(q, k, v, do, lse, delta, causal, qo, ko)
    dk, dv = fa._flash_dkv(q, k, v, do, lse, delta, causal, qo, ko)
    torch.cuda.synchronize()
    assert fa.launch_counts() == {"flash_fwd": 1, "flash_dq": 1,
                                  "flash_dkv": 1}
    dq_p = fa._flash_dq_plain(q, k, v, do, lse, delta, causal, qo, ko)
    dk_p, dv_p = fa._flash_dkv_plain(q, k, v, do, lse, delta, causal, qo,
                                     ko)
    bf16 = dt == torch.bfloat16
    step = 2.0 ** -7 if bf16 else 0.0
    _close(m, m_p, 2e-5, 1e-5, rows=False)
    _close(l, l_p, 2e-5, 1e-5, rows=False)
    _close(o, o_p, 2e-5, 1e-6, step)
    for mine, plain in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
        _close(mine, plain, 1e-4, 1e-6, step)


@pytest.mark.cuda
def test_flash_attention_autograd_matches_dense_on_the_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    inputs = [torch.randn(2, 128, 2, 64, generator=g, device=cuda)
              for _ in range(3)]
    q, k, v = (x.clone().requires_grad_() for x in inputs)
    out = fa.flash_attention(q, k, v, causal=True, q_offset=64)
    (out ** 2).sum().backward()
    q2, k2, v2 = (x.clone().requires_grad_() for x in inputs)
    ref = fa._dense_reference(q2, k2, v2, True, 64, 0)
    (ref ** 2).sum().backward()
    _close(out, ref, 2e-5, 1e-6)
    for mine, theirs in ((q.grad, q2.grad), (k.grad, k2.grad),
                         (v.grad, v2.grad)):
        _close(mine, theirs, 1e-4, 1e-6)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 64, 2, 48, device=cuda)
    with pytest.raises(ValueError):
        fa._flash_fwd(q, q, q, True, 0, 0)            # head dim 48
    q = torch.zeros(1, 64, 2, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa._flash_fwd(q, q, q, True, 0, 0)            # fp16
    q = torch.zeros(1, 2, 64, 64, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError):
        fa._flash_fwd(q, q, q, True, 0, 0)            # not contiguous
