"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one.

This file imports neither JAX nor horovod_tpu, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances, for every element, are those of
horovod_tpu_torch/utils/tolerance.py: with fp32 inputs (TF32 off) kernel
and plain version do the same fp32 arithmetic in another order, so they
agree to 2e-5 of the largest value in the element's row (its last axis)
for the forward and 1e-4 for gradients; m and l are held element by
element. With bf16 inputs both compute in fp32 from the same bf16 values
and round the output to bf16, which may part them by one more bf16 step
of the element itself (2^-7 of it). The tensor-core (sm90) kernels also
round p (and ds) to bf16 for the tensor cores: their o, dq, dk and dv may
differ by twice the largest effect that this rounding alone has in the
row (the plain version with ``bf16_operands=True``); their m and l keep
the fp32 bounds. The sm90 dq has an absolute floor of 1e-5 instead of
1e-6 (``tolerance.DQ_ATOL``: the dq of a query that sees one key is pure
rounding noise).
"""

import pytest
import torch

from horovod_tpu_torch.parallel import flash_attention as fa
from horovod_tpu_torch.utils import tolerance


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(mine, plain, rtol, atol, step=0.0, rows=True, plain_b=None):
    err, ratio = tolerance.worst(mine, plain, rtol, atol=atol, step=step,
                                 rows=rows, plain_b=plain_b)
    assert ratio <= 1.0, (err, ratio)


def _inputs(cuda, dt, b, s, h, d, seed, sk=None):
    """q, k, v, do; k and v have sk rows (default s)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    rows = (s, sk or s, sk or s, s)
    return [torch.randn(b, n, h, d, generator=g, device=cuda).to(dt)
            for n in rows]


def _stats(q, k, v, do, causal, qo, ko):
    o_p, m_p, l_p = fa._flash_fwd_plain(q, k, v, causal, qo, ko)
    lse = fa._lse_from_stats(m_p, l_p)
    delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2).contiguous()
    return (o_p, m_p, l_p), lse, delta


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
    _check_kernels(cuda, getattr(torch, dtype), b, s, h, d, causal, qo, ko)


def _check_kernels(cuda, dt, b, s, h, d, causal, qo, ko, sk=None):
    """Runs the kernels _design picks and holds them to their plain
    versions; the launch counters must show that design ran."""
    q, k, v, do = _inputs(cuda, dt, b, s, h, d, s + d, sk)
    fa.reset_launch_counts()
    o, m, l = fa._flash_fwd(q, k, v, causal, qo, ko)
    (o_p, m_p, l_p), lse, delta = _stats(q, k, v, do, causal, qo, ko)
    dq = fa._flash_dq(q, k, v, do, lse, delta, causal, qo, ko)
    dk, dv = fa._flash_dkv(q, k, v, do, lse, delta, causal, qo, ko)
    torch.cuda.synchronize()
    sm90 = fa._design(dt, d) == "sm90"
    suffix = "_sm90" if sm90 else ""
    want = dict.fromkeys(fa.launch_counts(), 0)
    want.update({"flash_fwd" + suffix: 1, "flash_dq" + suffix: 1,
                 "flash_dkv" + suffix: 1})
    assert fa.launch_counts() == want
    args = (q, k, v, do, lse, delta, causal, qo, ko)
    dq_p = fa._flash_dq_plain(*args)
    dk_p, dv_p = fa._flash_dkv_plain(*args)
    o_b = dq_b = dk_b = dv_b = None
    if sm90:
        o_b = fa._flash_fwd_plain(q, k, v, causal, qo, ko,
                                  bf16_operands=True)[0]
        dq_b = fa._flash_dq_plain(*args, bf16_operands=True)
        dk_b, dv_b = fa._flash_dkv_plain(*args, bf16_operands=True)
    step = tolerance.BF16_STEP if dt == torch.bfloat16 else 0.0
    _close(m, m_p, 2e-5, 1e-5, rows=False)
    _close(l, l_p, 2e-5, 1e-5, rows=False)
    _close(o, o_p, 2e-5, 1e-6, step, plain_b=o_b)
    _close(dq, dq_p, 1e-4, tolerance.DQ_ATOL if sm90 else 1e-6, step,
           plain_b=dq_b)
    _close(dk, dk_p, 1e-4, 1e-6, step, plain_b=dk_b)
    _close(dv, dv_p, 1e-4, 1e-6, step, plain_b=dv_b)


SM90_CASES = [
    # b, s, h, d, causal, q_offset, k_offset
    pytest.param(1, 128, 2, 64, True, 0, 0, id="s128_d64"),
    pytest.param(2, 192, 3, 128, True, 0, 0, id="s192_ragged_tile"),
    pytest.param(2, 40, 3, 64, True, 0, 0, id="s40_short"),
    pytest.param(1, 512, 2, 128, False, 0, 0, id="s512_noncausal"),
    pytest.param(1, 512, 2, 64, True, 128, 0, id="q_offset"),
    pytest.param(1, 256, 2, 128, True, 0, 192, id="dead_rows"),
    pytest.param(2, 40, 2, 128, False, 0, 0, id="s40_noncausal_d128"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,causal,qo,ko", SM90_CASES)
def test_sm90_kernels_match_plain_versions(cuda, b, s, h, d, causal, qo,
                                           ko):
    _check_kernels(cuda, torch.bfloat16, b, s, h, d, causal, qo, ko)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,causal,qo", [
    pytest.param(128, 384, True, 256, id="kv_longer_ring_shard"),
    pytest.param(256, 64, False, 0, id="kv_shorter_noncausal")])
def test_sm90_kernels_with_unequal_lengths(cuda, sq, sk, causal, qo):
    _check_kernels(cuda, torch.bfloat16, 2, sq, 2, 128, causal, qo, 0, sk)


@pytest.mark.cuda
def test_simt_launchers_still_hold_bf16(cuda):
    q, k, v, do = _inputs(cuda, torch.bfloat16, 1, 256, 2, 128, 5)
    _, lse, delta = _stats(q, k, v, do, True, 0, 0)
    args = (q, k, v, do, lse, delta, True, 0, 0)
    o, m, l = fa._flash_fwd_simt(q, k, v, True, 0, 0)
    dq = fa._flash_dq_simt(*args)
    dk, dv = fa._flash_dkv_simt(*args)
    o_p, m_p, l_p = fa._flash_fwd_plain(q, k, v, True, 0, 0)
    dq_p = fa._flash_dq_plain(*args)
    dk_p, dv_p = fa._flash_dkv_plain(*args)
    step = tolerance.BF16_STEP
    _close(o, o_p, 2e-5, 1e-6, step)
    _close(m, m_p, 2e-5, 1e-5, rows=False)
    _close(l, l_p, 2e-5, 1e-5, rows=False)
    _close(dq, dq_p, 1e-4, 1e-6, step)
    _close(dk, dk_p, 1e-4, 1e-6, step)
    _close(dv, dv_p, 1e-4, 1e-6, step)


@pytest.mark.cuda
def test_sm90_refuses_a_misaligned_tensor_without_falling_back(cuda):
    flat = torch.zeros(1 + 64 * 2 * 64, device=cuda, dtype=torch.bfloat16)
    bad = flat[1:].view(1, 64, 2, 64)       # contiguous, 2 bytes off
    good = torch.zeros(1, 64, 2, 64, device=cuda, dtype=torch.bfloat16)
    st = torch.zeros(1, 2, 64, device=cuda)
    fa.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        fa._flash_fwd(bad, good, good, True, 0, 0)
    with pytest.raises(ValueError, match="16-byte"):
        fa._flash_dq(good, bad, good, good, st, st, True, 0, 0)
    with pytest.raises(ValueError, match="16-byte"):
        fa._flash_dkv(good, good, good, bad, st, st, True, 0, 0)
    assert not any(fa.launch_counts().values())


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


def _train_pass(model, images, labels):
    """Logits, loss, parameter gradients and buffers after one training
    forward and backward, on the CPU."""
    import torch.nn.functional as F
    logits = model(images)
    loss = F.cross_entropy(logits, labels)
    loss.backward()
    out = {"logits": logits.detach(), "loss": loss.detach()}
    out.update({f"grad {n}": p.grad for n, p in model.named_parameters()})
    out.update({f"buffer {n}": b for n, b in model.named_buffers()})
    return {k: v.cpu() for k, v in out.items()}


def _card_matches_cpu(cuda, build, image_size):
    """The same fp32 weights on the card (TF32 off for convolutions and
    products) and on the CPU give the same training pass within 1e-4."""
    import copy
    torch.backends.cudnn.allow_tf32 = False
    cpu_model = build()
    card_model = copy.deepcopy(cpu_model).to(cuda)
    g = torch.Generator().manual_seed(0)
    images = torch.randn(4, image_size, image_size, 3, generator=g)
    labels = torch.randint(0, 10, (4,), generator=g)
    want = _train_pass(cpu_model, images, labels)
    got = _train_pass(card_model, images.to(cuda), labels.to(cuda))
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=1e-4,
                                   atol=1e-4, msg=name)


@pytest.mark.cuda
def test_resnet_on_the_card_matches_the_cpu(cuda):
    from horovod_tpu_torch.models import resnet
    _card_matches_cpu(cuda, lambda: resnet.ResNet(
        stage_sizes=[1, 1], block_cls=resnet.BottleneckBlock, num_filters=8,
        num_classes=10, dtype=torch.float32, device="cpu"), 32)


@pytest.mark.cuda
def test_vit_on_the_card_matches_the_cpu(cuda):
    from horovod_tpu_torch.models import vit
    _card_matches_cpu(cuda, lambda: vit.ViT(vit.ViTConfig(
        image_size=32, patch_size=4, num_classes=10, embed_dim=64,
        num_layers=2, num_heads=4, dtype=torch.float32), device="cpu"), 32)


@pytest.mark.cuda
def test_entry_runs_on_the_card(cuda):
    from horovod_tpu_torch.entry import entry
    fa.reset_launch_counts()
    fn, args = entry()
    out = fn(*args)
    assert out.shape == (2, 32, 256) and out.dtype == torch.float32
    assert out.is_cuda and torch.isfinite(out).all()
    assert fa.launch_counts()["flash_fwd"] == 2     # head dim 16: simt


@pytest.fixture
def cuda_world(cuda):
    """The negotiated runtime at size 1 on the card (LocalController)."""
    import horovod_tpu_torch as hvd
    hvd.init()
    yield hvd
    hvd.shutdown()


@pytest.mark.cuda
def test_runtime_waits_for_the_ready_event_and_hands_over_on_the_stream(
        cuda_world):
    """A tensor that a chain of matmuls on the caller's stream is still
    writing when it is enqueued: the plane's stream (which scales it by
    the prescale) must wait for that work, and the output must be safe to
    read on the caller's stream right after ``synchronize``."""
    hvd = cuda_world
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(8192, 8192, generator=g, device="cuda") / 90.5
    y = torch.randn(8192, 256, generator=g, device="cuda")
    torch.cuda.synchronize()
    caller = torch.cuda.Stream()
    with torch.cuda.stream(caller):
        for _ in range(16):  # 0.55 TFLOP of fp32: milliseconds of work
            y = torch.tanh(a @ y)
        x = y[:, 0].contiguous()
        busy = not caller.query()
        out = hvd.synchronize(hvd.allreduce_async(x, op=hvd.Sum,
                                                  prescale_factor=2.0))
        got = out + 0
    torch.cuda.synchronize()
    assert busy, "the matmuls ended before the enqueue"
    assert out.device == x.device
    assert torch.equal(got, x * 2)


@pytest.mark.cuda
def test_eager_optimizer_equals_the_in_step_one_on_the_card(cuda_world):
    """bf16 compute through the sm90 flash kernels: three steps of the
    hook-driven eager optimizer equal three of the in-step one at size 1,
    losses and parameters bit for bit."""
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.models import TransformerConfig
    cfg = TransformerConfig(vocab_size=512, num_layers=2, num_heads=2,
                            head_dim=64, max_seq_len=256,
                            dtype=torch.bfloat16)
    runs = []
    for eager in (False, True):
        step, model = bench.transformer_step(cfg, 2, seed=1, eager=eager)
        losses = [step().item() for _ in range(3)]
        runs.append((losses, [p.detach().clone()
                              for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
