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
of the element itself (2^-7 of it); fp16 outputs by one fp16 step
(2^-10). The 16-bit tensor-core kernels (sm90 and stream) also round p
(and ds) to the input's 16-bit type for the tensor cores: their o, dq, dk
and dv may differ by twice the largest effect that this rounding alone
has in the row (the plain version with ``operands`` that dtype); their
m and l keep the fp32 bounds. The fp32 kernels on the tensor cores
(tf32: each product as three tf32 products, 3xTF32) are held to the fp32
bounds exactly, with no such allowance: the forward against
the fp32 plain version, dq and dk/dv against the plain versions that take
their products as they do (``operands=fa.TF32X3``). The tensor-core dq
has an absolute floor of 1e-5 instead of 1e-6 (``tolerance.DQ_ATOL``:
the dq of a query that sees one key is pure rounding noise).
"""

import math

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
    """Runs the kernels _design picks (and, for the 16-bit backward at D
    33-128, the fused kernel in place of dq and dk/dv: _fused_bwd) and
    holds them to their plain versions; the launch counters must show that
    each kernel's design ran."""
    q, k, v, do = _inputs(cuda, dt, b, s, h, d, s + d, sk)
    fa.reset_launch_counts()
    o, m, l = fa._flash_fwd(q, k, v, causal, qo, ko)
    (o_p, m_p, l_p), lse, delta = _stats(q, k, v, do, causal, qo, ko)
    dq, (dk, dv) = fa._flash_bwd(q, k, v, do, lse, delta, causal, qo, ko)
    torch.cuda.synchronize()
    designs = {kern: fa._design(dt, d, kern) for kern in fa.KERNELS}
    # the 16-bit tensor-core designs, which round p and ds to the input's type
    rounds = {kern: designs[kern] in ("sm90", "stream") for kern in fa.KERNELS}
    want = dict.fromkeys(fa.launch_counts(), 0)
    fused = fa._fused_bwd(dt, d)
    for kern in fa.KERNELS:
        if kern == "fwd" or not fused:
            want[fa.counter_name(kern, designs[kern])] = 1
    if fused:
        want["flash_bwd_sm90"] = 1
    assert fa.launch_counts() == want
    args = (q, k, v, do, lse, delta, causal, qo, ko)
    tf32 = {kern: fa.TF32X3 if designs[kern] == "tf32" else None
            for kern in fa.KERNELS}
    dq_p = fa._flash_dq_plain(*args, operands=tf32["dq"])
    dk_p, dv_p = fa._flash_dkv_plain(*args, operands=tf32["dkv"])
    o_b = dq_b = dk_b = dv_b = None
    if rounds["fwd"]:
        o_b = fa._flash_fwd_plain(q, k, v, causal, qo, ko, operands=dt)[0]
    if rounds["dq"]:
        dq_b = fa._flash_dq_plain(*args, operands=dt)
    if rounds["dkv"]:
        dk_b, dv_b = fa._flash_dkv_plain(*args, operands=dt)
    step = tolerance.step_of(dt)
    _close(m, m_p, 2e-5, 1e-5, rows=False)
    _close(l, l_p, 2e-5, 1e-5, rows=False)
    _close(o, o_p, 2e-5, 1e-6, step, plain_b=o_b)
    dq_atol = 1e-6 if designs["dq"] == "simt" else tolerance.DQ_ATOL
    _close(dq, dq_p, 1e-4, dq_atol, step, plain_b=dq_b)
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
        fa._flash_bwd(good, bad, good, good, st, st, True, 0, 0)
    with pytest.raises(ValueError, match="16-byte"):
        fa._flash_bwd(good, good, good, bad, st, st, True, 0, 0)
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
    q = torch.zeros(1, 64, 2, 64, device=cuda)
    k = torch.zeros(1, 64, 2, 96, device=cuda)
    with pytest.raises(ValueError):
        fa._flash_fwd(q, k, k, True, 0, 0)            # head dims differ
    q = torch.zeros(1, 64, 2, 64, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        fa._flash_fwd(q, q, q, True, 0, 0)            # fp64
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
    # head dim 16: the narrow sm90 forward, once a layer; simt never
    assert fa.launch_counts()["flash_fwd_sm90"] == 2
    assert fa.launch_counts()["flash_fwd"] == 0


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
    caller = torch.cuda.Stream()
    # Each kernel of the chain once first: the first launch of a kernel
    # loads its module, which waits for the device, so in a process that
    # had not run them the copy below would wait for every matmul.
    with torch.cuda.stream(caller):
        torch.tanh(a @ y)[:, 0].contiguous()
    torch.cuda.synchronize()
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
def test_entry_config_trains_on_the_narrow_kernels(cuda_world):
    """Three training steps of the entry's tiny config (bf16, 2 layers, 4
    heads of 16) through the bench's step: a finite, falling loss, and
    each step launches the narrow sm90 forward, dq and dk/dv and the
    backward's lse and delta pre-pass once a layer, no other flash
    kernel."""
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.entry import tiny_config
    cfg = tiny_config()
    step, _ = bench.transformer_step(cfg, 2, seed=0)
    fa.reset_launch_counts()
    losses = [step().item() for _ in range(3)]
    assert all(map(math.isfinite, losses)) and losses[-1] < losses[0]
    want = dict.fromkeys(fa.launch_counts(), 0)
    for name in ("flash_fwd_sm90", "flash_dq_sm90", "flash_dkv_sm90",
                 "flash_bwd_prep"):
        want[name] = 3 * cfg.num_layers
    assert fa.launch_counts() == want


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


C4_CASES = [
    # dtype, b, s, h, d, causal, q_offset, k_offset
    pytest.param("float16", 2, 256, 4, 128, True, 0, 0, id="fp16_d128"),
    pytest.param("float16", 1, 128, 2, 64, True, 0, 64, id="fp16_d64_dead"),
    pytest.param("float32", 1, 192, 2, 96, True, 0, 0, id="fp32_d96"),
    pytest.param("bfloat16", 2, 128, 2, 96, False, 0, 0, id="bf16_d96"),
    pytest.param("float16", 1, 128, 2, 96, True, 64, 0, id="fp16_d96"),
    pytest.param("float32", 1, 128, 2, 80, True, 0, 0, id="fp32_d80_padded"),
    pytest.param("bfloat16", 1, 128, 3, 80, True, 32, 0,
                 id="bf16_d80_padded"),
    pytest.param("bfloat16", 1, 128, 2, 48, True, 0, 0,
                 id="bf16_d48_padded_sm90"),
    pytest.param("float32", 1, 192, 2, 256, True, 0, 0, id="fp32_d256"),
    pytest.param("bfloat16", 2, 128, 2, 256, True, 0, 64, id="bf16_d256"),
    pytest.param("float16", 1, 40, 2, 256, True, 0, 0, id="fp16_d256_short"),
    pytest.param("float32", 1, 128, 2, 200, False, 0, 0,
                 id="fp32_d200_padded_noncausal"),
    pytest.param("float32", 1, 192, 2, 384, True, 0, 0, id="fp32_d384"),
    pytest.param("bfloat16", 2, 128, 2, 384, True, 0, 64, id="bf16_d384"),
    pytest.param("float16", 1, 40, 2, 512, True, 0, 0, id="fp16_d512_short"),
    pytest.param("bfloat16", 1, 128, 2, 448, False, 0, 0,
                 id="bf16_d448_padded_noncausal"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,s,h,d,causal,qo,ko", C4_CASES)
def test_head_dims_and_fp16_match_plain_versions(cuda, dtype, b, s, h, d,
                                                causal, qo, ko):
    """fp16, D 96 and 256, and head dims no kernel is built for (run
    zero-padded at the next one that is): forward, dq and dk/dv."""
    _check_kernels(cuda, getattr(torch, dtype), b, s, h, d, causal, qo, ko)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("bfloat16", 320), ("float32", 512),
                                     ("bfloat16", 640), ("float32", 640),
                                     ("bfloat16", 1024), ("float32", 1024),
                                     ("float16", 600)])
def test_head_dim_past_256_raises_naming_the_roadmap_item(cuda, dtype, d):
    """Past D 256 every head dim runs (ROADMAP.md C4, closed: nothing
    raises any more): the 16-bit dq and dk/dv on the stream design (D 320
    native, D 600 zero-padded to 640), the fp32 kernels on tf32."""
    _check_kernels(cuda, getattr(torch, dtype), 1, 128, 2, d, True, 0, 0)


SM90_WIDE_CASES = [
    # dtype, b, s, h, d, causal, q_offset, k_offset
    pytest.param("float16", 1, 128, 2, 64, True, 0, 0, id="fp16_d64"),
    pytest.param("float16", 2, 256, 2, 128, False, 0, 0,
                 id="fp16_d128_noncausal"),
    pytest.param("float16", 1, 192, 2, 256, True, 64, 0,
                 id="fp16_d256_q_offset"),
    pytest.param("bfloat16", 2, 40, 2, 80, True, 0, 0, id="bf16_d80_short"),
    pytest.param("bfloat16", 1, 256, 3, 96, True, 0, 0, id="bf16_d96"),
    pytest.param("bfloat16", 2, 256, 2, 256, True, 0, 0, id="bf16_d256"),
    pytest.param("bfloat16", 1, 192, 2, 256, True, 0, 128,
                 id="bf16_d256_dead_rows"),
    pytest.param("bfloat16", 1, 128, 2, 200, False, 0, 0,
                 id="bf16_d200_noncausal"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,s,h,d,causal,qo,ko", SM90_WIDE_CASES)
def test_sm90_wide_kernels_match_plain_versions(cuda, dtype, b, s, h, d,
                                                causal, qo, ko):
    """fp16 at D 64/128/256 and bf16 at D 80, 96, 200 (run zero-padded at
    128 and 256) and 256: the sm90 forward and dk/dv against their plain
    versions with fp16 or bf16 operand rounding, dq on its own design;
    the launch counters show which ran."""
    _check_kernels(cuda, getattr(torch, dtype), b, s, h, d, causal, qo, ko)


@pytest.mark.cuda
def test_sm90_wide_kernels_with_unequal_lengths(cuda):
    _check_kernels(cuda, torch.float16, 1, 128, 2, 256, True, 256, 0, 384)


SM90_DQ_FWD512_CASES = [
    # dtype, b, s, h, d, causal, q_offset, k_offset
    pytest.param("float16", 2, 256, 2, 256, True, 0, 0, id="fp16_d256"),
    pytest.param("bfloat16", 1, 320, 2, 256, True, 0, 0,
                 id="bf16_d256_ragged_q_tile"),
    pytest.param("float16", 1, 40, 2, 200, True, 0, 0, id="fp16_d200_short"),
    pytest.param("float16", 2, 128, 2, 80, True, 0, 64, id="fp16_d80_dead"),
    pytest.param("bfloat16", 1, 256, 2, 96, False, 0, 0,
                 id="bf16_d96_noncausal"),
    pytest.param("bfloat16", 1, 192, 2, 384, True, 64, 0,
                 id="bf16_d384_q_offset"),
    pytest.param("float16", 2, 128, 2, 512, False, 0, 0,
                 id="fp16_d512_noncausal"),
    pytest.param("bfloat16", 1, 256, 2, 320, True, 0, 128,
                 id="bf16_d320_dead_rows"),
    pytest.param("float16", 1, 40, 3, 448, True, 0, 0, id="fp16_d448_short"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,s,h,d,causal,qo,ko", SM90_DQ_FWD512_CASES)
def test_sm90_dq_and_forward_past_256_match_plain_versions(
        cuda, dtype, b, s, h, d, causal, qo, ko):
    """The sm90 dq at fp16 and bf16 from D 33 to 256 (32-key stages at D
    256; D 80, 96 and 200 zero-padded), and the sm90 forward at D 257-512
    (O's head dim split across two CTAs; D 320 and 448 zero-padded),
    against their plain versions with 16-bit operand rounding; the launch
    counters show which design ran."""
    _check_kernels(cuda, getattr(torch, dtype), b, s, h, d, causal, qo, ko)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("bfloat16", 512), ("float16", 256)])
def test_sm90_dq_and_wide_forward_with_unequal_lengths(cuda, dtype, d):
    _check_kernels(cuda, getattr(torch, dtype), 1, 128, 2, d, True, 256, 0,
                   384)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("bfloat16", 200), ("float16", 80),
                                     ("float32", 80), ("bfloat16", 320),
                                     ("bfloat16", 260), ("float16", 20)])
def test_backward_pads_once_and_equals_separate_launches(cuda, dtype, d):
    """flash_attention_bwd pads q, k, v and do once for the head dim dq
    and dk/dv run at (fp32 D 80, bf16 D 260, fp16 D 20; none at 16-bit D
    320, where both stream at 320, nor at bf16 D 200, where both sm90
    kernels read the caller's tensors, nor at fp16 D 80, where the fused
    kernel does); its gradients, from the pre-pass's lse and delta, equal
    those of the two kernels (at fp16 D 80 the fused one) launched apart
    through _launch on the same lse and delta, bit for bit (one order of
    sums)."""
    dt = getattr(torch, dtype)
    q, k, v, do = _inputs(cuda, dt, 1, 192, 2, d, 3)
    o, m, l = fa._flash_fwd(q, k, v, True, 0, 0)
    grads = fa.flash_attention_bwd(q, k, v, o, m, l, do)
    lse, delta, _ = fa._bwd_prep(o, do, m, l)
    args = (lse, delta, True, 0, 0)
    if fa._fused_bwd(dt, d):
        apart = fa._launch("bwd", "sm90", (q, k, v, do), *args)
    else:
        apart = (fa._launch("dq", fa._design(dt, d, "dq"), (q, k, v, do),
                            *args),
                 *fa._launch("dkv", fa._design(dt, d, "dkv"), (q, k, v, do),
                             *args))
    for mine, theirs in zip(grads, apart):
        assert torch.equal(mine, theirs)


STREAM_TF32_CASES = [
    # dtype, b, s, h, d, causal, q_offset, k_offset
    pytest.param("bfloat16", 1, 128, 2, 640, True, 0, 0, id="bf16_d640"),
    pytest.param("float16", 2, 192, 2, 640, True, 64, 0,
                 id="fp16_d640_q_offset"),
    pytest.param("bfloat16", 1, 128, 2, 1024, True, 0, 128,
                 id="bf16_d1024_dead_rows"),
    pytest.param("float16", 1, 40, 2, 1024, True, 0, 0,
                 id="fp16_d1024_short"),
    pytest.param("bfloat16", 1, 128, 2, 600, False, 0, 0,
                 id="bf16_d600_padded_noncausal"),
    pytest.param("float32", 1, 128, 2, 64, True, 0, 0, id="fp32_d64"),
    pytest.param("float32", 2, 256, 3, 128, True, 0, 0, id="fp32_d128"),
    pytest.param("float32", 1, 192, 2, 256, True, 64, 0,
                 id="fp32_d256_q_offset"),
    pytest.param("float32", 1, 128, 2, 640, True, 0, 0, id="fp32_d640"),
    pytest.param("float32", 1, 128, 2, 128, True, 0, 96,
                 id="fp32_d128_dead_rows"),
    pytest.param("float32", 2, 40, 3, 100, True, 0, 0,
                 id="fp32_d100_padded_short"),
    pytest.param("float32", 1, 256, 2, 96, False, 0, 0,
                 id="fp32_d96_noncausal"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,s,h,d,causal,qo,ko", STREAM_TF32_CASES)
def test_stream_and_tf32_forward_match_plain_versions(cuda, dtype, b, s, h,
                                                      d, causal, qo, ko):
    """The forward streamed over D: bf16 and fp16 past D 512 (stream; D
    600 zero-padded to 640) against the plain version with 16-bit p, and
    fp32 at D 64-640 (tf32, 3xTF32; D 100 zero-padded to 128) at the fp32
    bounds exactly; with offsets, dead rows and ragged tiles. dq and dk/dv
    run their own designs beside it; the counters show which ran."""
    _check_kernels(cuda, getattr(torch, dtype), b, s, h, d, causal, qo, ko)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("bfloat16", 640), ("float32", 128)])
def test_stream_and_tf32_forward_with_unequal_lengths(cuda, dtype, d):
    _check_kernels(cuda, getattr(torch, dtype), 1, 128, 2, d, True, 256, 0,
                   384)
    _check_kernels(cuda, getattr(torch, dtype), 2, 256, 2, d, False, 0, 0,
                   64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("bfloat16", 640), ("float16", 1024),
                                     ("float32", 128)])
def test_stream_and_tf32_refuse_a_misaligned_tensor(cuda, dtype, d):
    dt = getattr(torch, dtype)
    flat = torch.zeros(1 + 64 * 2 * d, device=cuda, dtype=dt)
    bad = flat[1:].view(1, 64, 2, d)        # contiguous, one element off
    good = torch.zeros(1, 64, 2, d, device=cuda, dtype=dt)
    fa.reset_launch_counts()
    for args in ((bad, good, good), (good, bad, good), (good, good, bad)):
        with pytest.raises(ValueError, match="16-byte"):
            fa._flash_fwd(*args, True, 0, 0)
    assert not any(fa.launch_counts().values())


TF32_BWD_CASES = [
    # b, s, h, d, causal, q_offset, k_offset
    pytest.param(1, 128, 2, 64, True, 0, 0, id="d64"),
    pytest.param(2, 256, 3, 128, True, 0, 0, id="d128"),
    pytest.param(1, 256, 2, 128, False, 0, 0, id="d128_noncausal"),
    pytest.param(1, 192, 2, 128, True, 64, 0, id="d128_q_offset"),
    pytest.param(1, 128, 2, 128, True, 0, 96, id="d128_dead_rows"),
    pytest.param(1, 192, 2, 320, True, 0, 0, id="d320"),
    pytest.param(1, 128, 2, 640, True, 0, 0, id="d640"),
    pytest.param(2, 128, 2, 640, False, 0, 64, id="d640_noncausal_k_offset"),
    pytest.param(2, 40, 3, 100, True, 0, 0, id="d100_padded_short"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,causal,qo,ko", TF32_BWD_CASES)
def test_tf32_backward_matches_plain_versions(cuda, b, s, h, d, causal, qo,
                                              ko):
    """fp32 dq and dk/dv on the tf32 design (3xTF32, one pre-pass for
    both; D 100 zero-padded to 128) against the plain versions with
    ``operands=TF32X3``, at the fp32 bound; the counters show that the
    forward, dq and dk/dv all ran on tf32."""
    _check_kernels(cuda, torch.float32, b, s, h, d, causal, qo, ko)
    assert fa.launch_counts()["flash_dq_tf32"] == 1
    assert fa.launch_counts()["flash_dkv_tf32"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,causal,qo,d", [
    pytest.param(128, 384, True, 256, 128, id="kv_longer_ring_shard"),
    pytest.param(256, 64, False, 0, 128, id="kv_shorter_noncausal"),
    pytest.param(192, 320, True, 128, 640, id="d640_kv_longer")])
def test_tf32_backward_with_unequal_lengths(cuda, sq, sk, causal, qo, d):
    _check_kernels(cuda, torch.float32, 2, sq, 2, d, causal, qo, 0, sk)


@pytest.mark.cuda
def test_tf32_backward_refuses_a_misaligned_tensor_without_falling_back(
        cuda):
    flat = torch.zeros(1 + 64 * 2 * 64, device=cuda)
    bad = flat[1:].view(1, 64, 2, 64)       # contiguous, 4 bytes off
    good = torch.zeros(1, 64, 2, 64, device=cuda)
    st = torch.zeros(1, 2, 64, device=cuda)
    fa.reset_launch_counts()
    for i in range(4):
        tensors = [good] * 4
        tensors[i] = bad
        with pytest.raises(ValueError, match="16-byte"):
            fa._flash_bwd(*tensors, st, st, True, 0, 0)
        for kern in ("dq", "dkv"):
            with pytest.raises(ValueError, match="16-byte"):
                fa._launch(kern, "tf32", tensors, st, st, True, 0, 0)
    assert not any(fa.launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 640])
def test_tf32_backward_one_prepass_equals_separate_launches(cuda, d):
    """The backward's one pre-pass (``_tf32_bwd_split``, read by dq and
    dk/dv) gives bit for bit what each kernel's own pre-pass gives."""
    q, k, v, do = _inputs(cuda, torch.float32, 2, 192, 2, d, 7)
    _, lse, delta = _stats(q, k, v, do, True, 0, 0)
    args = (q, k, v, do, lse, delta, True, 0, 0)
    dq, (dk, dv) = fa._flash_bwd(*args)
    split = fa._tf32_bwd_split(q, k, v, do)
    assert split.numel() == 4 * (q.numel() + k.numel()) + 2 * 2 * 2 * d * (
        192 + 2 * 192)
    mine = (dq, dk, dv, fa._flash_dq_tf32(*args, split=split),
            *fa._flash_dkv_tf32(*args, split=split))
    apart = (fa._flash_dq_tf32(*args), *fa._flash_dkv_tf32(*args))
    for a, b in zip(mine, apart * 2):
        assert torch.equal(a, b)


RAGGED_DESIGNS = [
    # dtype, head dim: every design of every kernel
    pytest.param("bfloat16", 32, id="simt_bf16_d32"),
    pytest.param("bfloat16", 16, id="narrow_bf16_d16"),
    pytest.param("float16", 32, id="narrow_fp16_d32"),
    pytest.param("float32", 32, id="tf32_narrow_fp32_d32"),
    pytest.param("bfloat16", 128, id="sm90_bf16_d128"),
    pytest.param("bfloat16", 256, id="sm90_bf16_d256"),
    pytest.param("bfloat16", 640, id="stream_bf16_d640"),
    pytest.param("float32", 128, id="tf32_fp32_d128"),
    pytest.param("float32", 640, id="tf32_fp32_d640"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,qo", [(100, 100, 16), (100, 127, 27),
                                      (127, 96, 0)])
@pytest.mark.parametrize("dtype,d", RAGGED_DESIGNS)
def test_ragged_lengths_match_plain_versions(cuda, dtype, d, sq, sk, qo):
    """Lengths under 128 that are no multiple of 64 (ROADMAP C6): a full
    first tile and a ragged second one, on every design, causal with the
    diagonal through the ragged ends."""
    _check_kernels(cuda, getattr(torch, dtype), 2, sq, 2, d, True, qo, 0, sk)


NARROW_CASES = [
    # dtype, b, s, h, d, causal, q_offset, k_offset, sk
    pytest.param("bfloat16", 2, 32, 4, 16, True, 0, 0, None,
                 id="bf16_d16_entry_shape"),
    pytest.param("float16", 2, 32, 4, 32, True, 0, 0, None, id="fp16_d32_s32"),
    pytest.param("bfloat16", 2, 100, 2, 32, True, 16, 0, None,
                 id="bf16_d32_s100_q_offset"),
    pytest.param("float16", 2, 127, 2, 16, True, 0, 0, None,
                 id="fp16_d16_s127"),
    pytest.param("bfloat16", 1, 256, 3, 16, False, 0, 0, None,
                 id="bf16_d16_noncausal"),
    pytest.param("float16", 1, 256, 2, 32, True, 0, 192, None,
                 id="fp16_d32_dead_rows"),
    pytest.param("bfloat16", 2, 128, 2, 32, True, 256, 0, 384,
                 id="bf16_d32_kv_longer"),
    pytest.param("float16", 2, 256, 2, 16, False, 0, 0, 64,
                 id="fp16_d16_kv_shorter_noncausal"),
    pytest.param("bfloat16", 1, 100, 2, 20, True, 0, 0, 127,
                 id="bf16_d20_padded_unequal"),
    pytest.param("float16", 2, 1024, 8, 16, True, 0, 0, None,
                 id="fp16_d16_c4_shape"),
    pytest.param("bfloat16", 2, 1024, 8, 32, True, 0, 0, None,
                 id="bf16_d32_c4_shape"),
    # The forward's kv tiles dealt among its consumer warpgroups: fewer
    # tiles than warpgroups (2 of 64 keys), a tile count that is no
    # multiple of theirs (10 of 64 keys, 5 of 128), a long kv (64 tiles,
    # causal with a k offset), the C4 shape without the mask, and rows
    # that see keys in the first tiles and none in a later warpgroup's
    # (k offset 1: row 64 sees keys 0-63 alone, row 128 keys 0-127).
    pytest.param("bfloat16", 2, 100, 2, 16, False, 0, 0, None,
                 id="bf16_d16_fewer_tiles_than_warpgroups"),
    pytest.param("float16", 1, 640, 2, 32, False, 0, 0, None,
                 id="fp16_d32_s640_tiles_no_multiple"),
    pytest.param("bfloat16", 1, 256, 2, 16, True, 3900, 64, 4096,
                 id="bf16_d16_long_kv_k_offset"),
    pytest.param("float16", 2, 1024, 8, 16, False, 0, 0, None,
                 id="fp16_d16_c4_shape_noncausal"),
    pytest.param("bfloat16", 2, 1024, 8, 32, False, 0, 0, None,
                 id="bf16_d32_c4_shape_noncausal"),
    pytest.param("float16", 1, 256, 2, 32, True, 0, 1, None,
                 id="fp16_d32_rows_dead_in_a_later_warpgroup"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,s,h,d,causal,qo,ko,sk", NARROW_CASES)
def test_narrow_sm90_kernels_match_plain_versions(cuda, dtype, b, s, h, d,
                                                  causal, qo, ko, sk):
    """The narrow sm90 forward, dq and dk/dv (16-bit D 16 and 32; D 20
    runs at 32) against their plain versions with 16-bit operand
    rounding: causal and not, with offsets, dead rows, unequal lengths,
    ragged tiles (S 100, 127) and the entry's S 32; the launch counters
    show which design ran."""
    _check_kernels(cuda, getattr(torch, dtype), b, s, h, d, causal, qo, ko,
                   sk)
    counts = fa.launch_counts()
    assert counts["flash_fwd_sm90"] == counts["flash_dkv_sm90"] == 1
    assert counts["flash_dq_sm90"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,causal,qo,ko,s", [
    pytest.param("bfloat16", 16, True, 0, 0, 1024, id="bf16_d16_c4"),
    pytest.param("float16", 32, True, 0, 0, 1024, id="fp16_d32_c4"),
    pytest.param("bfloat16", 32, False, 0, 0, 100, id="bf16_d32_s100"),
    pytest.param("float16", 16, True, 0, 1, 256, id="fp16_d16_k_offset")])
def test_narrow_forward_gives_the_same_bits_on_every_launch(cuda, dtype, d,
                                                            causal, qo, ko,
                                                            s):
    """The narrow forward's warpgroups add their partial l and O in a
    fixed order: two launches on the same inputs give bit-equal o, m and
    l."""
    q, k, v, _ = _inputs(cuda, getattr(torch, dtype), 2, s, 8, d, 5)
    fa.reset_launch_counts()
    first = [x.clone() for x in fa._flash_fwd(q, k, v, causal, qo, ko)]
    second = fa._flash_fwd(q, k, v, causal, qo, ko)
    torch.cuda.synchronize()
    assert fa.launch_counts()["flash_fwd_sm90"] == 2
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("bfloat16", 16), ("float16", 32)])
def test_narrow_sm90_refuses_a_misaligned_tensor_without_falling_back(
        cuda, dtype, d):
    dt = getattr(torch, dtype)
    flat = torch.zeros(1 + 64 * 2 * d, device=cuda, dtype=dt)
    bad = flat[1:].view(1, 64, 2, d)        # contiguous, 2 bytes off
    good = torch.zeros(1, 64, 2, d, device=cuda, dtype=dt)
    st = torch.zeros(1, 2, 64, device=cuda)
    fa.reset_launch_counts()
    for args in ((bad, good, good), (good, bad, good), (good, good, bad)):
        with pytest.raises(ValueError, match="16-byte"):
            fa._flash_fwd(*args, True, 0, 0)
    for i in range(4):
        tensors = [good] * 4
        tensors[i] = bad
        for kern in ("dq", "dkv"):
            with pytest.raises(ValueError, match="16-byte"):
                fa._launch(kern, "sm90", tensors, st, st, True, 0, 0)
        with pytest.raises(ValueError, match="16-byte"):
            fa._flash_bwd(*tensors, st, st, True, 0, 0)
    assert not any(fa.launch_counts().values())


STREAM_DQ_CASES = [
    # dtype, b, s, h, d, causal, q_offset, k_offset, sk
    pytest.param("bfloat16", 2, 256, 2, 320, True, 0, 0, None,
                 id="bf16_d320"),
    pytest.param("float16", 1, 256, 3, 320, False, 0, 0, None,
                 id="fp16_d320_noncausal"),
    pytest.param("float16", 2, 192, 2, 384, True, 64, 0, None,
                 id="fp16_d384_q_offset"),
    pytest.param("bfloat16", 1, 256, 2, 512, True, 0, 192, None,
                 id="bf16_d512_dead_rows"),
    pytest.param("float16", 1, 128, 2, 640, True, 0, 0, None,
                 id="fp16_d640"),
    pytest.param("bfloat16", 2, 128, 2, 640, False, 0, 64, None,
                 id="bf16_d640_noncausal_k_offset"),
    pytest.param("bfloat16", 1, 100, 2, 1024, True, 16, 0, None,
                 id="bf16_d1024_s100"),
    pytest.param("float16", 2, 127, 2, 448, True, 0, 0, None,
                 id="fp16_d448_s127"),
    pytest.param("bfloat16", 2, 128, 2, 320, True, 256, 0, 384,
                 id="bf16_d320_kv_longer"),
    pytest.param("float16", 2, 256, 2, 640, False, 0, 0, 64,
                 id="fp16_d640_kv_shorter_noncausal"),
    pytest.param("bfloat16", 1, 100, 2, 300, True, 0, 0, 127,
                 id="bf16_d300_padded_unequal"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,s,h,d,causal,qo,ko,sk", STREAM_DQ_CASES)
def test_stream_dq_matches_plain_versions(cuda, dtype, b, s, h, d, causal,
                                          qo, ko, sk):
    """The stream dq (16-bit, every multiple of 64 past D 256; D 300 runs
    at 320) against the plain dq with 16-bit ds: causal and not, with
    offsets, dead rows, unequal lengths and ragged tiles (S 100, 127);
    the forward and dk/dv on their own designs beside it."""
    _check_kernels(cuda, getattr(torch, dtype), b, s, h, d, causal, qo, ko,
                   sk)
    assert fa.launch_counts()["flash_dq_stream"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("bfloat16", 320), ("float16", 640)])
def test_stream_dq_refuses_a_misaligned_tensor_without_falling_back(
        cuda, dtype, d):
    dt = getattr(torch, dtype)
    flat = torch.zeros(1 + 64 * 2 * d, device=cuda, dtype=dt)
    bad = flat[1:].view(1, 64, 2, d)        # contiguous, 2 bytes off
    good = torch.zeros(1, 64, 2, d, device=cuda, dtype=dt)
    st = torch.zeros(1, 2, 64, device=cuda)
    fa.reset_launch_counts()
    for i in range(4):
        tensors = [good] * 4
        tensors[i] = bad
        with pytest.raises(ValueError, match="16-byte"):
            fa._launch("dq", "stream", tensors, st, st, True, 0, 0)
    assert not any(fa.launch_counts().values())


STREAM_DKV_CASES = [
    # dtype, b, s, h, d, causal, q_offset, k_offset, sk
    pytest.param("bfloat16", 2, 256, 2, 320, True, 0, 0, None,
                 id="bf16_d320"),
    pytest.param("float16", 1, 256, 3, 320, False, 0, 0, None,
                 id="fp16_d320_noncausal"),
    pytest.param("bfloat16", 1, 192, 2, 640, True, 64, 0, None,
                 id="bf16_d640_q_offset"),
    pytest.param("float16", 2, 128, 2, 640, True, 0, 0, None,
                 id="fp16_d640"),
    pytest.param("bfloat16", 2, 128, 2, 640, False, 0, 64, None,
                 id="bf16_d640_noncausal_k_offset"),
    pytest.param("float16", 1, 256, 2, 320, True, 0, 192, None,
                 id="fp16_d320_dead_rows"),
    pytest.param("bfloat16", 2, 100, 2, 320, True, 16, 0, None,
                 id="bf16_d320_s100"),
    pytest.param("float16", 2, 127, 2, 640, True, 0, 0, None,
                 id="fp16_d640_s127"),
    pytest.param("bfloat16", 2, 128, 2, 320, True, 256, 0, 384,
                 id="bf16_d320_kv_longer"),
    pytest.param("float16", 2, 256, 2, 640, False, 0, 0, 64,
                 id="fp16_d640_kv_shorter_noncausal"),
    pytest.param("bfloat16", 1, 100, 2, 300, True, 0, 0, 127,
                 id="bf16_d300_padded_unequal"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,s,h,d,causal,qo,ko,sk", STREAM_DKV_CASES)
def test_stream_dkv_matches_plain_versions(cuda, dtype, b, s, h, d, causal,
                                           qo, ko, sk):
    """The stream dk/dv (16-bit, every multiple of 64 past D 256; D 300
    runs at 320) against the plain dk/dv with 16-bit p and ds: causal and
    not, with offsets, dead rows, unequal lengths and ragged tiles (S 100,
    127); the forward and dq on their own designs beside it, and no simt
    kernel launched."""
    _check_kernels(cuda, getattr(torch, dtype), b, s, h, d, causal, qo, ko,
                   sk)
    counts = fa.launch_counts()
    assert counts["flash_dkv_stream"] == 1
    assert not any(counts[fa.counter_name(kern, "simt")]
                   for kern in fa.KERNELS)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("bfloat16", 320), ("float16", 640)])
def test_stream_dkv_refuses_a_misaligned_tensor_without_falling_back(
        cuda, dtype, d):
    dt = getattr(torch, dtype)
    flat = torch.zeros(1 + 64 * 2 * d, device=cuda, dtype=dt)
    bad = flat[1:].view(1, 64, 2, d)        # contiguous, 2 bytes off
    good = torch.zeros(1, 64, 2, d, device=cuda, dtype=dt)
    st = torch.zeros(1, 2, 64, device=cuda)
    fa.reset_launch_counts()
    for i in range(4):
        tensors = [good] * 4
        tensors[i] = bad
        with pytest.raises(ValueError, match="16-byte"):
            fa._launch("dkv", "stream", tensors, st, st, True, 0, 0)
        with pytest.raises(ValueError, match="16-byte"):
            fa._flash_bwd(*tensors, st, st, True, 0, 0)
    assert not any(fa.launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [48, 80, 96, 200, 320])
def test_sm90_forward_in_place_between_builds(cuda, d):
    """The sm90 forward at 16-bit head dims between its builds reads the
    caller's tensors (H 8: a store past d would land in the next head):
    every element of o within the bound of its plain version, m and l
    too, and o, m, l bit for bit those of the same build on inputs
    zero-padded to it (what the wrapper ran before it read in place)."""
    dt = torch.bfloat16
    q, k, v, _ = _inputs(cuda, dt, 2, 192, 8, d, d)
    built = fa.padded_head_dim(d, "sm90", "fwd")
    assert fa._reads_in_place(d, "sm90", "fwd") and built > d
    fa.reset_launch_counts()
    o, m, l = fa._launch("fwd", "sm90", (q, k, v), True, 0, 0)
    padded = fa._flash_fwd_sm90(*fa._pad_head_dim((q, k, v), built), True,
                                0, 0, scale=fa._softmax_scale(d))
    torch.cuda.synchronize()
    assert fa.launch_counts()["flash_fwd_sm90"] == 2
    o_p, m_p, l_p = fa._flash_fwd_plain(q, k, v, True, 0, 0)
    o_b = fa._flash_fwd_plain(q, k, v, True, 0, 0, operands=dt)[0]
    _close(o, o_p, 2e-5, 1e-6, tolerance.step_of(dt), plain_b=o_b)
    _close(m, m_p, 2e-5, 1e-5, rows=False)
    _close(l, l_p, 2e-5, 1e-5, rows=False)
    assert torch.equal(o, padded[0][..., :d])
    assert torch.equal(m, padded[1]) and torch.equal(l, padded[2])


@pytest.mark.cuda
def test_sm90_forward_at_its_built_head_dim_is_unchanged(cuda):
    """At the main shape (B 4, S 2048, H 16, D 128, bf16), where d is the
    built head dim, the dispatcher launches the build on the caller's
    tensors with no cut: its o, m and l equal bit for bit a direct launch
    of the build, and the in-place path at D 120 on the same build equals
    that build on the tensors zero-padded to 128."""
    dt = torch.bfloat16
    q, k, v, _ = _inputs(cuda, dt, 4, 2048, 16, 128, 1)
    fa.reset_launch_counts()
    mine = fa._flash_fwd(q, k, v, True, 0, 0)
    direct = fa._flash_fwd_sm90(q, k, v, True, 0, 0)
    cut = fa._launch("fwd", "sm90", (q[..., :120].contiguous(),
                                     k[..., :120].contiguous(),
                                     v[..., :120].contiguous()), True, 0, 0)
    q0, k0, v0 = (x.clone() for x in (q, k, v))
    for x in (q0, k0, v0):
        x[..., 120:] = 0
    padded = fa._flash_fwd_sm90(q0, k0, v0, True, 0, 0,
                                scale=fa._softmax_scale(120))
    torch.cuda.synchronize()
    assert fa.launch_counts()["flash_fwd_sm90"] == 4
    for a, b in zip(mine, direct):
        assert torch.equal(a, b)
    assert torch.equal(cut[0], padded[0][..., :120])
    assert torch.equal(cut[1], padded[1]) and torch.equal(cut[2], padded[2])


@pytest.fixture(scope="module")
def serial_forward():
    """The sm90 forward with every piece of its overlap turned off (the
    ``serial`` variant of tools/fwd_sm90_variants.py), built once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from horovod_tpu_torch import _cuda
    from horovod_tpu_torch.tools import fwd_sm90_variants
    _cuda.load()
    fn = fwd_sm90_variants.build(_cuda, ["serial"])["serial"]
    return lambda *args: fwd_sm90_variants.forward(_cuda, fn, *args)


SERIAL_CASES = [
    # dtype, b, sq, h, d, causal, q_offset, k_offset, sk
    pytest.param("bfloat16", 4, 2048, 16, 128, True, 0, 0, None, id="main"),
    pytest.param("bfloat16", 2, 512, 4, 128, False, 0, 0, None,
                 id="noncausal"),
    pytest.param("float16", 1, 384, 2, 64, True, 0, 200, None,
                 id="dead_rows_and_tile"),
    pytest.param("bfloat16", 2, 200, 3, 128, True, 120, 0, 320,
                 id="sq200_sk320"),
    pytest.param("float16", 1, 200, 2, 128, False, 0, 0, 320,
                 id="sq200_sk320_noncausal"),
    pytest.param("bfloat16", 2, 512, 8, 96, True, 0, 0, None,
                 id="in_place_d96"),
    pytest.param("bfloat16", 2, 512, 8, 200, True, 0, 0, None,
                 id="in_place_d200"),
    pytest.param("float16", 2, 1024, 8, 64, True, 0, 0, None, id="d64"),
    pytest.param("float16", 2, 1024, 8, 256, True, 0, 0, None, id="d256"),
    pytest.param("bfloat16", 2, 512, 4, 384, True, 0, 0, None, id="d384"),
    pytest.param("bfloat16", 1, 320, 3, 512, True, 64, 0, None,
                 id="d512_q_offset"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,s,h,d,causal,qo,ko,sk", SERIAL_CASES)
def test_sm90_forward_equals_its_serial_loop(cuda, serial_forward, dtype, b,
                                             s, h, d, causal, qo, ko, sk):
    """The sm90 forward's overlap (S issued ahead of the softmax, the
    consumers' turns, the persistent walk, the third kv stage) changes
    only when products are issued and waited for: its o, m and l equal
    bit for bit those of the loop with every piece off, at the main
    shape, non-causal, with rows and a whole q tile that see no key,
    ragged lengths, in place between builds and at every build past
    32."""
    dt = getattr(torch, dtype)
    q, k, v, _ = _inputs(cuda, dt, b, s, h, d, d + s, sk)
    mine = fa._launch("fwd", "sm90", (q, k, v), causal, qo, ko)
    theirs = serial_forward(q, k, v, causal, qo, ko)
    torch.cuda.synchronize()
    for a, c in zip(mine, theirs):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,s,h,d", [
    ("bfloat16", 1, 200, 2, 128), ("float16", 1, 200, 3, 512),
    ("bfloat16", 2, 1024, 9, 64), ("float16", 3, 100, 1, 256)])
def test_sm90_forward_walk_writes_every_row(cuda, dtype, b, s, h, d):
    """Grids of fewer tiles than SMs, of a ragged last q tile, of O's two
    parts at D 512, and of more tiles than SMs by a few (144): with o, m
    and l filled with NaN before the launch, every element is written,
    within the bound of the plain version."""
    from horovod_tpu_torch import _cuda
    dt = getattr(torch, dtype)
    q, k, v, _ = _inputs(cuda, dt, b, s, h, d, d)
    o, m, l = (torch.full_like(x, float("nan")) for x in fa._fwd_outputs(q))
    _cuda.check(_cuda.load().hvdt_flash_fwd_sm90(
        fa._DTYPES[dt], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), m.data_ptr(), l.data_ptr(), b, h, s, s, d, 0, 0, 1,
        fa._softmax_scale(d), torch.cuda.current_stream().cuda_stream),
        "flash forward sm90 kernel")
    torch.cuda.synchronize()
    for x in (o, m, l):
        assert not x.isnan().any()
    o_p, m_p, l_p = fa._flash_fwd_plain(q, k, v, True, 0, 0)
    o_b = fa._flash_fwd_plain(q, k, v, True, 0, 0, operands=dt)[0]
    _close(o, o_p, 2e-5, 1e-6, tolerance.step_of(dt), plain_b=o_b)
    _close(m, m_p, 2e-5, 1e-5, rows=False)
    _close(l, l_p, 2e-5, 1e-5, rows=False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("bfloat16", 48), ("bfloat16", 80),
                                     ("bfloat16", 96), ("bfloat16", 120),
                                     ("bfloat16", 136), ("bfloat16", 200),
                                     ("float16", 80)])
def test_sm90_backward_in_place_between_builds(cuda, dtype, d):
    """The sm90 backward at 16-bit head dims between its builds reads the
    caller's tensors (H 8: a store past d would land in the next head; D
    136 leaves the D 256 build's last box wholly past d): one launch of
    the fused kernel (D 48-120) or of dq and dk/dv each (D 136, 200)
    through _flash_bwd, every element of dq, dk and dv within the bound of
    its plain version, and each bit for bit what the same build gives on
    inputs zero-padded to it, sliced (what the wrapper ran before it read
    in place)."""
    dt = getattr(torch, dtype)
    q, k, v, do = _inputs(cuda, dt, 2, 192, 8, d, d)
    _, lse, delta = _stats(q, k, v, do, True, 0, 0)
    args = (lse, delta, True, 0, 0)
    fused = fa._fused_bwd(dt, d)
    kerns = ("bwd",) if fused else ("dq", "dkv")
    built = fa.padded_head_dim(d, "sm90", kerns[0])
    for kern in kerns:
        assert fa._reads_in_place(d, "sm90", kern)
        assert fa.padded_head_dim(d, "sm90", kern) == built > d
    fa.reset_launch_counts()
    dq, (dk, dv) = fa._flash_bwd(q, k, v, do, *args)
    torch.cuda.synchronize()
    counts = fa.launch_counts()
    for kern in kerns:
        assert counts[fa.counter_name(kern, "sm90")] == 1
    assert sum(counts.values()) == len(kerns)
    padded = fa._pad_head_dim((q, k, v, do), built)
    scale = fa._softmax_scale(d)
    if fused:
        dq_b, dk_b, dv_b = fa._flash_bwd_sm90(*padded, *args, scale=scale)
    else:
        dq_b = fa._flash_dq_sm90(*padded, *args, scale=scale)
        dk_b, dv_b = fa._flash_dkv_sm90(*padded, *args, scale=scale)
    torch.cuda.synchronize()
    plain_args = (q, k, v, do, *args)
    step = tolerance.step_of(dt)
    _close(dq, fa._flash_dq_plain(*plain_args), 1e-4, tolerance.DQ_ATOL,
           step, plain_b=fa._flash_dq_plain(*plain_args, operands=dt))
    for mine, p, p_b in zip((dk, dv), fa._flash_dkv_plain(*plain_args),
                            fa._flash_dkv_plain(*plain_args, operands=dt)):
        _close(mine, p, 1e-4, 1e-6, step, plain_b=p_b)
    for mine, whole in ((dq, dq_b), (dk, dk_b), (dv, dv_b)):
        assert mine.shape == q.shape
        assert torch.equal(mine, whole[..., :d])


@pytest.mark.cuda
def test_sm90_backward_at_its_built_head_dim_is_unchanged(cuda):
    """At the main shape (B 4, S 2048, H 16, D 128, bf16), where d is the
    built head dim, _flash_bwd launches the fused build on the caller's
    tensors with no cut: dq, dk and dv equal bit for bit a direct launch
    of the build, and the in-place path at D 120 on the same build equals
    it on the tensors zero-padded to 128."""
    dt = torch.bfloat16
    q, k, v, do = _inputs(cuda, dt, 4, 2048, 16, 128, 1)
    _, lse, delta = _stats(q, k, v, do, True, 0, 0)
    args = (lse, delta, True, 0, 0)
    fa.reset_launch_counts()
    dq, (dk, dv) = fa._flash_bwd(q, k, v, do, *args)
    direct = fa._flash_bwd_sm90(q, k, v, do, *args)
    cut = [x[..., :120].contiguous() for x in (q, k, v, do)]
    dq_c, (dk_c, dv_c) = fa._flash_bwd(*cut, *args)
    zeroed = [x.clone() for x in (q, k, v, do)]
    for x in zeroed:
        x[..., 120:] = 0
    scale = fa._softmax_scale(120)
    padded = fa._flash_bwd_sm90(*zeroed, *args, scale=scale)
    torch.cuda.synchronize()
    counts = fa.launch_counts()
    assert counts["flash_bwd_sm90"] == 4
    assert sum(counts.values()) == 4
    for mine, theirs in zip((dq, dk, dv), direct):
        assert torch.equal(mine, theirs)
    for mine, theirs in zip((dq_c, dk_c, dv_c), padded):
        assert torch.equal(mine, theirs[..., :120])


TF32_WIDE_CASES = [
    # b, s, h, d, causal, q_offset, k_offset, sk
    pytest.param(1, 256, 2, 160, True, 0, 0, None, id="d160"),
    pytest.param(1, 256, 2, 192, False, 0, 0, None, id="d192_noncausal"),
    pytest.param(2, 256, 3, 256, True, 0, 0, None, id="d256"),
    pytest.param(1, 192, 2, 256, False, 0, 64, None,
                 id="d256_noncausal_k_offset"),
    pytest.param(1, 256, 2, 288, True, 64, 0, None, id="d288_q_offset"),
    pytest.param(2, 256, 2, 320, True, 0, 0, None, id="d320"),
    pytest.param(1, 128, 2, 320, False, 0, 0, None, id="d320_noncausal"),
    pytest.param(1, 384, 2, 640, True, 0, 0, None, id="d640"),
    pytest.param(1, 256, 2, 640, False, 0, 0, None, id="d640_noncausal"),
    pytest.param(1, 128, 2, 640, True, 256, 0, 384,
                 id="d640_kv_longer_q_offset"),
    pytest.param(2, 256, 2, 384, False, 0, 64, 192,
                 id="d384_kv_shorter_k_offset"),
    pytest.param(1, 128, 2, 512, True, 0, 96, None, id="d512_dead_rows"),
    pytest.param(2, 100, 2, 640, True, 16, 0, None, id="d640_s100"),
    pytest.param(2, 127, 2, 192, True, 0, 0, None, id="d192_s127"),
    pytest.param(2, 100, 2, 256, True, 27, 0, 127, id="d256_s100_sk127"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,causal,qo,ko,sk", TF32_WIDE_CASES)
def test_tf32_wide_forward_matches_plain_version(cuda, b, s, h, d, causal,
                                                 qo, ko, sk):
    """The tf32 forward's wide build (fp32 past D 128: 256-column parts of
    O, P through shared memory, the last part's half past D left out) at
    the fp32 bounds exactly, against the fp32 plain version: head dims
    from 160 to 640, causal and not, offsets, dead rows, unequal lengths
    and ragged lengths (S 100 and 127). The C entry says which build ran,
    and the counter that the tf32 forward alone launched."""
    assert fa.tf32_fwd_part(d) == 256
    q, k, v, _ = _inputs(cuda, torch.float32, b, s, h, d, s + d, sk)
    fa.reset_launch_counts()
    o, m, l = fa._flash_fwd(q, k, v, causal, qo, ko)
    torch.cuda.synchronize()
    want = dict.fromkeys(fa.launch_counts(), 0)
    want["flash_fwd_tf32"] = 1
    assert fa.launch_counts() == want
    o_p, m_p, l_p = fa._flash_fwd_plain(q, k, v, causal, qo, ko)
    _close(o, o_p, 2e-5, 1e-6)
    _close(m, m_p, 2e-5, 1e-5, rows=False)
    _close(l, l_p, 2e-5, 1e-5, rows=False)


@pytest.mark.cuda
def test_tf32_forward_keeps_its_128_column_build_up_to_d128(cuda):
    """Up to D 128 the C entry runs the 128-column build (P from
    registers), past it the wide one; at D 128 the forward still holds
    the fp32 bound, and the wide build's rows of P and O at D 160 agree
    with D 128's on inputs whose columns past 128 are zero (the same
    logits; o's extra columns zero)."""
    assert [fa.tf32_fwd_part(d) for d in (64, 96, 128, 160, 640)] == \
        [128, 128, 128, 256, 256]
    q, k, v, _ = _inputs(cuda, torch.float32, 1, 256, 2, 128, 5)
    o, m, l = fa._flash_fwd(q, k, v, True, 0, 0)
    o_p, m_p, l_p = fa._flash_fwd_plain(q, k, v, True, 0, 0)
    _close(o, o_p, 2e-5, 1e-6)
    _close(m, m_p, 2e-5, 1e-5, rows=False)
    wide = fa._flash_fwd_tf32(*fa._pad_head_dim((q, k, v), 160), True, 0, 0,
                              scale=fa._softmax_scale(128))
    torch.cuda.synchronize()
    _close(wide[0][..., :128], o_p, 2e-5, 1e-6)
    assert not wide[0][..., 128:].any()
    _close(wide[1], m_p, 2e-5, 1e-5, rows=False)
    _close(wide[2], l_p, 2e-5, 1e-5, rows=False)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,causal,qo,ko,sk", TF32_WIDE_CASES)
def test_tf32_wide_dkv_matches_plain_version(cuda, b, s, h, d, causal, qo,
                                             ko, sk):
    """The tf32 dk/dv's wide build (fp32 past D 128: 128-column parts of
    dK and dV, P^T and dS^T through shared memory, the last part's half
    past D left out) at the fp32 gradient bound exactly, against the plain
    version that takes its products as three tf32 products: head dims from
    160 to 640, causal and not, offsets, dead rows, unequal lengths and
    ragged lengths (S 100 and 127). The C entry says which build ran, and
    the counter that the tf32 dk/dv launched once."""
    assert fa.tf32_dkv_part(d) == 128
    q, k, v, do = _inputs(cuda, torch.float32, b, s, h, d, s + d, sk)
    _, lse, delta = _stats(q, k, v, do, causal, qo, ko)
    fa.reset_launch_counts()
    _, (dk, dv) = fa._flash_bwd(q, k, v, do, lse, delta, causal, qo, ko)
    torch.cuda.synchronize()
    assert fa.launch_counts()["flash_dkv_tf32"] == 1
    args = (q, k, v, do, lse, delta, causal, qo, ko)
    dk_p, dv_p = fa._flash_dkv_plain(*args, operands=fa.TF32X3)
    _close(dk, dk_p, 1e-4, 1e-6)
    _close(dv, dv_p, 1e-4, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,qo,ko", [(True, 0, 0), (False, 0, 64),
                                          (True, 64, 0)])
def test_tf32_wide_dkv_equals_the_64_column_build_bit_for_bit(cuda, causal,
                                                              qo, ko):
    """Up to D 128 the C entry runs the 64-column build, past it the wide
    one; both sum each output column in the same order (the same region
    accumulators, the same k steps of a 64-column product, the same tile
    order), so on inputs whose columns past 128 are zero the wide build at
    D 160 gives the 64-column build's dk and dv at D 128 bit for bit (its
    fifth region adds exact zeros to S and dP) and zeros past them."""
    assert [fa.tf32_dkv_part(d) for d in (64, 96, 128, 160, 640)] == \
        [64, 64, 64, 128, 128]
    q, k, v, do = _inputs(cuda, torch.float32, 2, 256, 2, 128, 11)
    _, lse, delta = _stats(q, k, v, do, causal, qo, ko)
    args = (lse, delta, causal, qo, ko)
    dk, dv = fa._flash_dkv_tf32(q, k, v, do, *args)
    wide = fa._flash_dkv_tf32(*fa._pad_head_dim((q, k, v, do), 160), *args,
                              scale=fa._softmax_scale(128))
    torch.cuda.synchronize()
    for got, want in zip(wide, (dk, dv)):
        assert torch.equal(got[..., :128], want)
        assert not got[..., 128:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,causal,qo,ko,sk", TF32_WIDE_CASES)
def test_tf32_wide_dq_matches_plain_version(cuda, b, s, h, d, causal, qo, ko,
                                            sk):
    """The tf32 dq's wide build (fp32 past D 128: 256-column parts of dQ,
    dS through shared memory, the last part's columns past D left out) at
    the fp32 gradient bound with ``DQ_ATOL`` and no other allowance,
    against the plain version that takes its products as three tf32
    products: head dims from 160 to 640, causal and not, offsets, dead
    rows, unequal lengths and ragged lengths (S 100 and 127). The C entry
    says which build ran, and the counter that the tf32 dq launched
    once."""
    assert fa.tf32_dq_part(d) == 256
    q, k, v, do = _inputs(cuda, torch.float32, b, s, h, d, s + d, sk)
    _, lse, delta = _stats(q, k, v, do, causal, qo, ko)
    fa.reset_launch_counts()
    dq, _ = fa._flash_bwd(q, k, v, do, lse, delta, causal, qo, ko)
    torch.cuda.synchronize()
    assert fa.launch_counts()["flash_dq_tf32"] == 1
    args = (q, k, v, do, lse, delta, causal, qo, ko)
    dq_p = fa._flash_dq_plain(*args, operands=fa.TF32X3)
    _close(dq, dq_p, 1e-4, tolerance.DQ_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,qo,ko", [(True, 0, 0), (False, 0, 64),
                                          (True, 64, 0)])
def test_tf32_wide_dq_equals_the_128_column_build_bit_for_bit(cuda, causal,
                                                              qo, ko):
    """Up to D 128 the C entry runs the 128-column build, past it the wide
    one; both sum each column of dQ in the same order (the same region
    accumulators, the same k steps of a product, the same tile order), so
    on inputs whose columns past 128 are zero the wide build at D 160
    gives the 128-column build's dq at D 128 bit for bit (its fifth region
    adds exact zeros to S and dP) and zeros past it."""
    assert [fa.tf32_dq_part(d) for d in (64, 96, 128, 160, 640)] == \
        [128, 128, 128, 256, 256]
    q, k, v, do = _inputs(cuda, torch.float32, 2, 256, 2, 128, 13)
    _, lse, delta = _stats(q, k, v, do, causal, qo, ko)
    args = (lse, delta, causal, qo, ko)
    dq = fa._flash_dq_tf32(q, k, v, do, *args)
    wide = fa._flash_dq_tf32(*fa._pad_head_dim((q, k, v, do), 160), *args,
                             scale=fa._softmax_scale(128))
    torch.cuda.synchronize()
    assert torch.equal(wide[..., :128], dq)
    assert not wide[..., 128:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [256, 640])
def test_tf32_wide_dkv_refuses_a_misaligned_tensor(cuda, d):
    """A tensor one element off a 16-byte boundary raises before any
    launch, on the wide dk/dv as on the others: no kernel, no pre-pass and
    no other design runs in its place."""
    flat = torch.zeros(1 + 64 * 2 * d, device=cuda)
    bad = flat[1:].view(1, 64, 2, d)
    good = torch.zeros(1, 64, 2, d, device=cuda)
    st = torch.zeros(1, 2, 64, device=cuda)
    fa.reset_launch_counts()
    for i in range(4):
        tensors = [good] * 4
        tensors[i] = bad
        with pytest.raises(ValueError, match="16-byte"):
            fa._flash_dkv_tf32(*tensors, st, st, True, 0, 0)
        with pytest.raises(ValueError, match="16-byte"):
            fa._launch("dkv", "tf32", tensors, st, st, True, 0, 0)
        with pytest.raises(ValueError, match="16-byte"):
            fa._tf32_bwd_split(*tensors)
    assert not any(fa.launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [256, 640])
def test_tf32_wide_forward_refuses_a_misaligned_tensor(cuda, d):
    """A tensor one element off a 16-byte boundary raises before any
    launch, on the wide build as on the others: no kernel, no pre-pass and
    no other design runs in its place."""
    flat = torch.zeros(1 + 64 * 2 * d, device=cuda)
    bad = flat[1:].view(1, 64, 2, d)
    good = torch.zeros(1, 64, 2, d, device=cuda)
    fa.reset_launch_counts()
    for args in ((bad, good, good), (good, bad, good), (good, good, bad)):
        with pytest.raises(ValueError, match="16-byte"):
            fa._flash_fwd(*args, True, 0, 0)
        with pytest.raises(ValueError, match="16-byte"):
            fa._tf32_fwd_split(*args)
    assert not any(fa.launch_counts().values())


TF32_NARROW_CASES = [
    # b, sq, h, causal, q_offset, k_offset, sk
    pytest.param(2, 1, 2, True, 0, 0, None, id="s1"),
    pytest.param(2, 33, 3, False, 0, 0, None, id="s33_noncausal"),
    pytest.param(2, 100, 2, True, 16, 0, None, id="s100_q_offset"),
    pytest.param(1, 127, 2, False, 0, 0, None, id="s127_noncausal"),
    pytest.param(2, 100, 2, True, 27, 0, 127, id="s100_sk127_q_offset"),
    pytest.param(1, 100, 2, False, 0, 0, 127, id="s100_sk127_noncausal"),
    pytest.param(1, 128, 2, True, 0, 96, None, id="dead_rows"),
    # fewer kv tiles than warpgroups (2 of 32 keys); rows that see keys in
    # the first tiles and none in a later warpgroup's (k offset 1); a long
    # kv (128 tiles) with both offsets; the C4 shape with and without the
    # mask
    pytest.param(2, 64, 2, False, 0, 0, None,
                 id="fewer_tiles_than_warpgroups"),
    pytest.param(1, 256, 2, True, 0, 1, None,
                 id="rows_dead_in_a_later_warpgroup"),
    pytest.param(1, 256, 2, True, 3900, 64, 4096, id="long_kv_k_offset"),
    pytest.param(2, 1024, 8, True, 0, 0, None, id="c4_shape"),
    pytest.param(2, 1024, 8, False, 0, 0, None, id="c4_shape_noncausal"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 24, 32])
@pytest.mark.parametrize("b,s,h,causal,qo,ko,sk", TF32_NARROW_CASES)
def test_tf32_narrow_forward_matches_plain_versions(cuda, d, b, s, h,
                                                    causal, qo, ko, sk):
    """The narrow tf32 forward (fp32 D 16 and 32; D 24 runs at 32) held
    to the fp32 plain forward with no allowance, the narrow tf32 dq and
    dk/dv beside it: causal and not, with offsets, dead rows, unequal
    lengths and ragged tiles (S 1, 33, 100, 127); the launch counters
    show that the tf32 forward, dq and dk/dv ran once each and no simt
    kernel."""
    _check_kernels(cuda, torch.float32, b, s, h, d, causal, qo, ko, sk)
    counts = fa.launch_counts()
    assert counts["flash_fwd_tf32"] == 1 and counts["flash_fwd"] == 0
    assert counts["flash_dq_tf32"] == counts["flash_dkv_tf32"] == 1
    assert counts["flash_dq"] == counts["flash_dkv"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32])
def test_tf32_narrow_forward_rejects_a_lost_warpgroup_tile(cuda, d):
    """At the C4 shape the bound the narrow tf32 forward passes rejects,
    by more than chip_smoke.py's LOST_FP32_BY, the plain forward without
    one kv tile of the last consumer warpgroup (what a combine that lost
    its partial sums would give); and two launches give the same bits
    (the warpgroups' sums meet in a fixed order)."""
    import chip_smoke
    q, k, v, _ = _inputs(cuda, torch.float32, 2, 1024, 8, d, 9)
    fa.reset_launch_counts()
    o, m, l = fa._flash_fwd(q, k, v, True, 0, 0)
    again = fa._flash_fwd(q, k, v, True, 0, 0)
    torch.cuda.synchronize()
    assert fa.launch_counts()["flash_fwd_tf32"] == 2
    for a, b in zip((o, m, l), again):
        assert torch.equal(a, b)
    o_p = fa._flash_fwd_plain(q, k, v, True, 0, 0)[0]
    _close(o, o_p, 2e-5, 1e-6)
    lo, hi = chip_smoke.TF32_NARROW_LAST_WARPGROUP_KEYS
    lost = chip_smoke.fwd_without_keys(fa, q, k, v, lo, hi)
    ratio = tolerance.worst(lost, o_p, 2e-5)[1]
    assert ratio > chip_smoke.LOST_FP32_BY, ratio


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32])
def test_tf32_narrow_forward_refuses_a_misaligned_tensor(cuda, d):
    """A tensor one element off a 16-byte boundary raises before any
    launch: no pre-pass, no kernel and no simt kernel in its place."""
    flat = torch.zeros(1 + 64 * 2 * d, device=cuda)
    bad = flat[1:].view(1, 64, 2, d)
    good = torch.zeros(1, 64, 2, d, device=cuda)
    fa.reset_launch_counts()
    for args in ((bad, good, good), (good, bad, good), (good, good, bad)):
        with pytest.raises(ValueError, match="16-byte"):
            fa._flash_fwd(*args, True, 0, 0)
        with pytest.raises(ValueError, match="16-byte"):
            fa._tf32_fwd_split(*args)
    assert not any(fa.launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 24, 32])
@pytest.mark.parametrize("b,s,h,causal,qo,ko,sk", TF32_NARROW_CASES)
def test_tf32_narrow_backward_matches_plain_versions(cuda, d, b, s, h,
                                                     causal, qo, ko, sk):
    """The narrow tf32 dq and dk/dv (fp32 D 16 and 32; D 24 runs at 32)
    through ``_flash_bwd`` (one pre-pass for both) held to their TF32X3
    plain versions, dq at ``DQ_ATOL`` and dk and dv at the fp32 gradient
    bound, with no allowance; a second call and each launcher with its own
    pre-pass give the same bits; one launch each, no simt kernel."""
    q, k, v, do = _inputs(cuda, torch.float32, b, s, h, d, 3 * s + d, sk)
    _, lse, delta = _stats(q, k, v, do, causal, qo, ko)
    args = (q, k, v, do, lse, delta, causal, qo, ko)
    fa.reset_launch_counts()
    dq, (dk, dv) = fa._flash_bwd(*args)
    counts = fa.launch_counts()
    again = fa._flash_bwd(*args)
    apart = (fa._launch("dq", "tf32", args[:4], *args[4:]),
             *fa._launch("dkv", "tf32", args[:4], *args[4:]))
    torch.cuda.synchronize()
    assert counts["flash_dq_tf32"] == counts["flash_dkv_tf32"] == 1
    assert sum(counts.values()) == 2
    for got in ((again[0], *again[1]), apart):
        assert all(torch.equal(x, y) for x, y in zip(got, (dq, dk, dv)))
    _close(dq, fa._flash_dq_plain(*args, operands=fa.TF32X3), 1e-4,
           tolerance.DQ_ATOL)
    for got, want in zip((dk, dv), fa._flash_dkv_plain(*args,
                                                       operands=fa.TF32X3)):
        _close(got, want, 1e-4, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32])
def test_tf32_narrow_backward_rejects_a_lost_warpgroup_stage(cuda, d):
    """At the C4 shape the bound the narrow tf32 dq and dk/dv pass rejects,
    by more than chip_smoke.py's LOST_FP32_BY, the plain dq without the
    keys of one kv stage of dq's last consumer warpgroup, and the plain dk
    and dv without the queries of one q stage of dk/dv's last warpgroup
    (what a sum that lost that warpgroup's partial would give)."""
    import chip_smoke
    q, k, v, do = _inputs(cuda, torch.float32, 2, 1024, 8, d, 9)
    _, lse, delta = _stats(q, k, v, do, True, 0, 0)
    args = (q, k, v, do, lse, delta, True, 0, 0)
    dq, (dk, dv) = fa._flash_bwd(*args)
    dq_p = fa._flash_dq_plain(*args, operands=fa.TF32X3)
    dk_p, dv_p = fa._flash_dkv_plain(*args, operands=fa.TF32X3)
    _close(dq, dq_p, 1e-4, tolerance.DQ_ATOL)
    _close(dk, dk_p, 1e-4, 1e-6)
    _close(dv, dv_p, 1e-4, 1e-6)
    lost = chip_smoke.TF32_NARROW_LOST
    lo, hi = lost["dq_last_warpgroup"]
    dq_x = chip_smoke.dq_without_keys(fa, q, k, v, do, lse, delta, lo, hi,
                                      operands=fa.TF32X3)
    ratio = tolerance.worst(dq_x, dq_p, 1e-4, atol=tolerance.DQ_ATOL)[1]
    assert ratio > chip_smoke.LOST_FP32_BY, ratio
    lo, hi = lost["dkv_last_warpgroup"]
    do_x, delta_x = do.clone(), delta.clone()
    do_x[:, lo:hi] = 0
    delta_x[:, :, lo:hi] = 0
    for got, want in zip(fa._flash_dkv_plain(q, k, v, do_x, lse, delta_x,
                                             True, 0, 0,
                                             operands=fa.TF32X3),
                         (dk_p, dv_p)):
        ratio = tolerance.worst(got, want, 1e-4)[1]
        assert ratio > chip_smoke.LOST_FP32_BY, ratio


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32])
def test_tf32_narrow_backward_refuses_a_misaligned_tensor(cuda, d):
    """A tensor one element off a 16-byte boundary raises before any
    launch: no pre-pass, no narrow kernel and no simt kernel in its
    place."""
    flat = torch.zeros(1 + 64 * 2 * d, device=cuda)
    bad = flat[1:].view(1, 64, 2, d)
    good = torch.zeros(1, 64, 2, d, device=cuda)
    st = torch.zeros(1, 2, 64, device=cuda)
    fa.reset_launch_counts()
    for i in range(4):
        tensors = [good] * 4
        tensors[i] = bad
        with pytest.raises(ValueError, match="16-byte"):
            fa._flash_bwd(*tensors, st, st, True, 0, 0)
        for kern in ("dq", "dkv"):
            with pytest.raises(ValueError, match="16-byte"):
                fa._launch(kern, "tf32", tensors, st, st, True, 0, 0)
        with pytest.raises(ValueError, match="16-byte"):
            fa._tf32_bwd_split(*tensors)
    assert not any(fa.launch_counts().values())


def _tf32_bwd_planes(q, k, v, do):
    """The backward pre-pass's 14 planes in torch, in scratch order: q, do,
    k, v as tf32 hi = tf32(x) and lo = tf32(x - hi) in their layout, then
    k, q and do transposed to [B, H, D, S rounded up to 64] (zero past S)
    with the rows of every 8 positions in the order 0, 2, 4, 6, 1, 3, 5, 7,
    each hi and lo: what the seven launches before the one-launch pre-pass
    wrote."""
    def split(x):
        hi = fa._tf32(x)
        return [hi.flatten(), fa._tf32(x - hi).flatten()]

    def split_t(x):
        b, s, h, d = x.shape
        sp = -(-s // 64) * 64
        xt = torch.zeros(b, h, d, sp, device=x.device)
        xt[..., :s] = x.permute(0, 2, 3, 1)
        order = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7], device=x.device)
        idx = (torch.arange(sp, device=x.device) // 8 * 8
               + order.repeat(sp // 8))
        return split(xt[..., idx].contiguous())
    return torch.cat(split(q) + split(do) + split(k) + split(v) + split_t(k)
                     + split_t(q) + split_t(do))


@pytest.mark.cuda
@pytest.mark.parametrize("d,sq,sk", [(16, 1024, 1024), (32, 1024, 1024),
                                     (16, 100, 127), (128, 256, 256),
                                     (640, 192, 320)])
def test_tf32_backward_prepass_in_one_launch_writes_the_seven_planes(
        cuda, d, sq, sk):
    """The backward's pre-pass, one launch of ``tf32_bwd_split_all``,
    writes bit for bit the planes that its seven launches (four splits,
    three transposes) wrote: at the narrow builds' D 16 and 32, with
    unequal ragged lengths, and at the wider builds' D 128 and 640."""
    g = torch.Generator(device=cuda).manual_seed(d + sq)
    q, do = (torch.randn(2, sq, 2, d, generator=g, device=cuda)
             for _ in range(2))
    k, v = (torch.randn(2, sk, 2, d, generator=g, device=cuda)
            for _ in range(2))
    split = fa._tf32_bwd_split(q, k, v, do)
    assert torch.equal(split, _tf32_bwd_planes(q, k, v, do))


@pytest.mark.cuda
def test_simt_launchers_still_hold_fp32_at_d32(cuda):
    """The simt dq and dk/dv, which no route runs any more, still hold
    their plain versions at fp32 D 32 (ragged lengths, causal, offsets)
    when asked for."""
    q, k, v, do = _inputs(cuda, torch.float32, 2, 100, 2, 32, 5, 127)
    _, lse, delta = _stats(q, k, v, do, True, 27, 0)
    args = (q, k, v, do, lse, delta, True, 27, 0)
    fa.reset_launch_counts()
    dq = fa._launch("dq", "simt", args[:4], *args[4:])
    dk, dv = fa._launch("dkv", "simt", args[:4], *args[4:])
    torch.cuda.synchronize()
    assert fa.launch_counts()["flash_dq"] == fa.launch_counts()[
        "flash_dkv"] == 1
    _close(dq, fa._flash_dq_plain(*args), 1e-4, 1e-6)
    for got, want in zip((dk, dv), fa._flash_dkv_plain(*args)):
        _close(got, want, 1e-4, 1e-6)


# The fused 16-bit backward (csrc/flash_bwd_sm90.cu): dtype, b, sq, h, d,
# causal, q_offset, k_offset, sk. D 64 and 128 are its builds; 40, 80, 96
# and 120 run in place, 50 on one copy padded to 64.
FUSED_CASES = [
    pytest.param("bfloat16", 2, 256, 3, 128, True, 0, 0, None,
                 id="bf16_d128"),
    pytest.param("float16", 1, 512, 2, 64, False, 0, 0, None,
                 id="fp16_d64_noncausal"),
    pytest.param("bfloat16", 1, 512, 2, 64, True, 128, 0, None,
                 id="bf16_d64_q_offset"),
    pytest.param("float16", 1, 256, 2, 128, True, 0, 192, None,
                 id="fp16_d128_dead_rows"),
    pytest.param("bfloat16", 2, 100, 8, 40, True, 16, 0, None,
                 id="bf16_d40_s100"),
    pytest.param("float16", 2, 127, 8, 80, True, 0, 0, None,
                 id="fp16_d80_s127"),
    pytest.param("bfloat16", 2, 100, 8, 96, True, 27, 0, 127,
                 id="bf16_d96_sq100_sk127"),
    pytest.param("float16", 2, 192, 8, 120, False, 0, 64, None,
                 id="fp16_d120_noncausal_k_offset"),
    pytest.param("bfloat16", 2, 192, 4, 50, True, 0, 0, None,
                 id="bf16_d50_padded"),
    pytest.param("float16", 1, 128, 2, 96, True, 256, 0, 384,
                 id="fp16_d96_kv_longer"),
    pytest.param("bfloat16", 1, 256, 2, 80, False, 0, 0, 64,
                 id="bf16_d80_kv_shorter_noncausal"),
]


def _fused_check(cuda, dt, b, s, h, d, causal, qo, ko, sk=None, seed=0):
    """The fused kernel through _flash_bwd against its plain versions (dq
    at DQ_ATOL with the 16-bit operands' allowance of
    _flash_bwd_sm90_plain, dk and dv as _check_kernels holds them), one
    launch and no dq or dk/dv; its dk and dv equal flash_dkv_sm90's on the
    same inputs (through _launch, in place or padded as the pair runs
    them). Returns the inputs, the lse and delta and dq."""
    q, k, v, do = _inputs(cuda, dt, b, s, h, d, seed, sk)
    _, lse, delta = _stats(q, k, v, do, causal, qo, ko)
    args = (lse, delta, causal, qo, ko)
    fa.reset_launch_counts()
    dq, (dk, dv) = fa._flash_bwd(q, k, v, do, *args)
    torch.cuda.synchronize()
    want = dict.fromkeys(fa.launch_counts(), 0)
    want["flash_bwd_sm90"] = 1
    assert fa.launch_counts() == want
    pair_dk, pair_dv = fa._launch("dkv", "sm90", (q, k, v, do), *args)
    torch.cuda.synchronize()
    assert torch.equal(dk, pair_dk) and torch.equal(dv, pair_dv)
    plain = (q, k, v, do, *args)
    step = tolerance.step_of(dt)
    dq_b = fa._flash_bwd_sm90_plain(*plain, operands=dt)[0]
    _close(dq, fa._flash_dq_plain(*plain), 1e-4, tolerance.DQ_ATOL, step,
           plain_b=dq_b)
    for mine, p, p_b in zip((dk, dv), fa._flash_dkv_plain(*plain),
                            fa._flash_dkv_plain(*plain, operands=dt)):
        _close(mine, p, 1e-4, 1e-6, step, plain_b=p_b)
    return (q, k, v, do), args, dq


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,s,h,d,causal,qo,ko,sk", FUSED_CASES)
def test_fused_backward_matches_plain_versions(cuda, dtype, b, s, h, d,
                                               causal, qo, ko, sk):
    """The fused backward (16-bit D 33-128: its builds of 64 and 128, in
    place at multiples of 8, padded at D 50) against its plain versions,
    causal and not, with offsets, dead rows, ragged lengths (S 100, 127)
    and unequal ones; dk and dv bit for bit flash_dkv_sm90's."""
    _fused_check(cuda, getattr(torch, dtype), b, s, h, d, causal, qo, ko, sk)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("bfloat16", 128), ("float16", 80)])
def test_fused_backward_gives_the_same_bits_on_every_call(cuda, dtype, d):
    """dq (and dk, dv) of the fused kernel are the same bits over five
    calls, one of them queued behind a spin on the card, so that its CTAs
    start with the card idle, and one on another stream: the parts of dq
    are added in one fixed order, whatever order the CTAs run in."""
    dt = getattr(torch, dtype)
    (q, k, v, do), args, first = _fused_check(cuda, dt, 2, 1024, 8, d, True,
                                              0, 0, seed=4)
    outs = []
    side = torch.cuda.Stream()
    for i in range(5):
        if i == 2:
            torch.cuda._sleep(50_000_000)
        if i == 3:
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                outs.append(fa._flash_bwd(q, k, v, do, *args))
            torch.cuda.current_stream().wait_stream(side)
        else:
            outs.append(fa._flash_bwd(q, k, v, do, *args))
    torch.cuda.synchronize()
    for dq, (dk, dv) in outs:
        assert torch.equal(dq, first)
        assert torch.equal(dk, outs[0][1][0]) and torch.equal(dv,
                                                              outs[0][1][1])


@pytest.mark.cuda
def test_fused_backward_in_many_waves_finishes_and_holds(cuda):
    """B 4, H 64, S 2048, bf16 D 128: 4096 CTAs, some 31 waves on an H100,
    whose dq adds wait on CTAs handed out before them. The launch ends
    (within a minute: a wait on a CTA that is not resident would hang) and
    holds the plain versions."""
    import time
    t0 = time.perf_counter()
    _fused_check(cuda, torch.bfloat16, 4, 2048, 64, 128, True, 0, 0, seed=6)
    assert time.perf_counter() - t0 < 60


@pytest.mark.cuda
def test_fused_backward_refuses_a_misaligned_tensor(cuda):
    flat = torch.zeros(1 + 128 * 2 * 80, device=cuda, dtype=torch.bfloat16)
    bad = flat[1:].view(1, 128, 2, 80)       # contiguous, 2 bytes off
    good = torch.zeros(1, 128, 2, 80, device=cuda, dtype=torch.bfloat16)
    st = torch.zeros(1, 2, 128, device=cuda)
    fa.reset_launch_counts()
    for i in range(4):
        tensors = [good] * 4
        tensors[i] = bad
        with pytest.raises(ValueError, match="16-byte"):
            fa._flash_bwd(*tensors, st, st, True, 0, 0)
    assert not any(fa.launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("s,d", [(100, 20), (192, 64), (127, 80),
                                 (256, 128), (64, 640)])
def test_prepass_matches_its_plain_version(cuda, dtype, s, d):
    """The backward's pre-pass kernel (lse and delta in one launch, every
    dtype and head dim, 16-byte loads where a row allows them: not at
    16-bit D 20) against _bwd_stats_plain: lse within 1e-6 of |m| +
    |log l| (+inf where l == 0, equal), delta within 1e-5 of the sum of
    |do o| (another order of the same fp32 sum); and the counters it
    zeroes are zero."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(s + d)
    o, do = (torch.randn(2, s, 3, d, generator=g, device=cuda).to(dt)
             for _ in range(2))
    m = torch.randn(2, 3, s, generator=g, device=cuda)
    l = torch.rand(2, 3, s, generator=g, device=cuda) + 0.5
    l[:, :, ::7] = 0
    fa.reset_launch_counts()
    lse, delta, counters = fa._bwd_prep(o, do, m, l, 37)
    torch.cuda.synchronize()
    assert fa.launch_counts()["flash_bwd_prep"] == 1
    lse_p, delta_p = fa._bwd_stats_plain(o, do, m, l)
    dead = torch.isinf(lse_p)
    assert torch.equal(torch.isinf(lse), dead) and bool((lse[dead] > 0).all())
    terms = m.abs() + torch.log(torch.where(l > 0, l, torch.ones_like(l))).abs()
    assert bool(((lse - lse_p).abs()[~dead] <= 1e-6 * terms[~dead]).all())
    size = (do.float() * o.float()).abs().sum(-1).transpose(1, 2)
    assert bool(((delta - delta_p).abs() <= 1e-5 * size).all())
    assert counters.dtype == torch.int32 and not bool(counters.any())
