"""Smoke test of the PyTorch port (horovod_tpu_torch) on one NVIDIA H100.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit (nvcc for sm_90a):

    python3 chip_smoke.py [--seed 0] [--layers 12] [--warmup 2] [--steps 5]

Phases (any failure ends the run with a nonzero exit and no result line):

1. Card and build: prints the card's name and power limit, builds the
   flash-attention kernels from horovod_tpu_torch/csrc with nvcc and
   prints the build time.
2. Kernels against their plain PyTorch versions, on the card. bf16 at
   head dims 64 and 128 runs the tensor-core (sm90) forward, dq and dk/dv
   kernels; fp32, and a bf16 case at the main shape through the private
   launchers, run the fp32-FMA (simt) ones. Cases:
   the main path's shape (B=4, S=2048, H=16, D=128, bf16, causal), a
   non-causal, two offset, a D=64 and a short ragged case, fp32 at two
   shapes. Each element is held to the bound of
   horovod_tpu_torch/utils/tolerance.py: |mine - plain| <= atol + rtol *
   max|plain row| + step * |plain| (+ 2 * max over the row of |plain_b -
   plain| for the sm90 kernels), a row being the last axis (D for o and
   the gradients; m and l are held element by element). atol is 1e-6,
   and 1e-5 for the sm90 dq, whose row of a query that sees one key is
   pure rounding noise (utils/tolerance.py says why). Both versions
   compute in fp32 from the same inputs, in another summation order:
   rtol 2e-5 (o, m, l) or 1e-4 (gradients). bf16 outputs are rounded to
   bf16 by both, step = 2^-7; fp32 outputs have step 0. The sm90 kernels
   also feed p (and ds) to the tensor cores in bf16; plain_b is the plain
   version that rounds there too, and twice its effect in the row is
   allowed. The bound must show its power: at the main shape a plain
   result with one kv tile (keys 1024-1151 of the forward, keys 1024-1087
   of dq) or one q tile (queries 1536-1599 of dk and dv) left out must
   fail it.
3. A small model checked against the dense reference: a 2-layer fp32
   TransformerLM gives the same loss and gradients through the flash
   kernels as through dense attention (2e-5 and 1e-4).
4. The main path at full width: hvd.init(), the bench's TransformerLM
   (vocab 32000, 12 layers, 16 heads of 128, S=2048; fp32 weights, bf16
   compute) with random weights from --seed, DistributedOptimizer(SGD
   lr 0.01, momentum 0.9), broadcast_parameters, and training steps on
   one fixed batch of 4 x 2048 random tokens. The loss must be finite and
   fall, and the path must launch the sm90 forward, dq and dk/dv kernels
   once per layer per step and the simt ones never.
   One more step runs under torch.profiler and prints its device time by
   kernel.
5. The six kernels' times at the main path's shape (the simt kernels
   through their private launchers, in turns with the sm90 ones) beside
   the plain version, the PyTorch library call computing the same
   function (scaled_dot_product_attention, timed here only as a
   yardstick) and the bound: the larger of the operations the function
   needs (2 x D per visible (q, k) pair and matrix product: two products
   forward, three for dq, four for dk/dv) over the card's bf16 dense
   peak (989 TFLOP/s) and the bytes in and out over its memory rate
   (3.35 TB/s).
6. Small vision models, the card against the CPU: a narrow fp32 ResNet
   (bottleneck blocks, 8 filters) and a 2-layer ViT with the same
   weights on both (TF32 off) give the same logits, loss, parameter
   gradients and BatchNorm running statistics within 1e-4 + 1e-4 x |cpu|.
7. The bench's ResNet-50 leg at full width, through the bench's own
   step (horovod_tpu_torch.bench.classifier_step): batch 256 of 224x224
   bf16 images from --seed, labels 0, cross-replica BatchNorm over the
   data axis, SGD lr 0.01 momentum 0.9; --warmup and --steps steps, then
   one profiled step whose device time is grouped as convolutions,
   matrix products, nccl and other. Prints images/s, MFU (3 x 2 x
   4.089e9 model FLOPs per image over 989 TFLOP/s) and peak memory; the
   loss must be finite and fall, and no flash kernel may launch.
8. ViT-B/16 at 224x224, batch 64, bf16, through the same step and with
   the same checks.
9. The negotiated runtime at full width on one card: hvd.init() builds
   it with a LocalController. The main path's Transformer-LM (phase 4's
   configuration and seed) takes 5 steps with the in-step
   DistributedOptimizer, then 5 with the hook-driven
   ``torch.eager.DistributedOptimizer``: each step's loss and every
   parameter after the last step must be equal (at size 1 both averages
   are identities). Prints the seconds per step of each, a profiled step
   of each (device busy and idle), the cycles per step, the responses
   per step and tensors per response, the negotiation time per cycle and
   the runtime thread's busy time per step. Rank 0's timeline (HOROVOD_TIMELINE) must hold
   NEGOTIATE_ALLREDUCE, ALLREDUCE, QUEUE, COLLECTIVE and CYCLE_START; at
   size 1 no fusion buffer exists (the local plane, like the reference's,
   hands the tensors back), so MEMCPY_IN_FUSION_BUFFER is held in phase
   10's timeline. Then the depth-2 model takes 3 eager steps on the whole
   batch of 4: phase 10's reference.
10. A two-rank world on one card: the script starts a second process of
   itself as rank 1 (both ranks on cuda:0; NCCL refuses two ranks on one
   device, so only the runtime's socket star is used). CUDA tensors go
   through every collective against their closed-form values exactly;
   mismatched dtypes across the ranks raise on both and the world works
   afterwards; a tensor that a chain of 16 fp32 matmuls of 8192^2 x 256
   writes right before ``allreduce_async`` (the stream still busy,
   which is checked) arrives holding the chain's result (the ready
   event); the depth-2 LM at full width
   takes 3 eager steps on 2 rows per rank, which must agree with phase
   9's whole-batch steps: the mean of the ranks' losses within 1e-4 of
   the loss (relative), every parameter within 2^-6 of its largest
   update (the ranks' weight gradients are rounded to bf16 on 2 rows
   each, the whole batch's once on 4: 2^-8 of a gradient apart), the
   two ranks' parameters equal. Rank 0's timeline must hold
   MEMCPY_IN_FUSION_BUFFER. Prints the seconds per step and the bytes
   moved between the card and the host.

The last two lines are the JSON ``kernels`` line and the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
MAIN = dict(b=4, s=2048, h=16, d=128)
# The kernels the main path (bf16, D=128) runs; the simt kernels serve fp32
# and the small head dims and must not launch there.
MAIN_PATH_KERNELS = ("flash_fwd_sm90", "flash_dq_sm90", "flash_dkv_sm90")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_close(label, mine, plain, rtol, step=0.0, atol=1e-6, rows=True,
                plain_b=None, must_fail=False) -> float:
    """Holds every element of ``mine`` to the bound of utils/tolerance.py;
    returns the largest absolute error. With ``must_fail``, ``mine`` is a
    deliberately wrong result and the bound must reject it."""
    from horovod_tpu_torch.utils import tolerance
    max_err, ratio = tolerance.worst(mine, plain, rtol, atol=atol,
                                     step=step, rows=rows, plain_b=plain_b)
    ok = math.isfinite(max_err) and ratio <= 1.0
    if must_fail:
        verdict = "PASSED (too loose)" if ok else "rejected, as it must be"
    else:
        verdict = "ok" if ok else "FAIL"
    print(f"  {label:<34} max_abs_err={max_err:.3e} "
          f"worst err/tol={ratio:.3f} (rtol={rtol:g} of the "
          f"{'row' if rows else 'element'}, step={step:g}"
          f"{', 2x bf16-operand gap' if plain_b is not None else ''}) "
          f"{verdict}")
    if must_fail and ok:
        raise AssertionError(f"{label}: the bound cannot see a lost tile "
                             f"(err/tol {ratio:.3f})")
    if not must_fail and not ok:
        raise AssertionError(f"{label}: an element is {ratio:.3f} times "
                             f"its tolerance")
    return max_err


def fwd_without_keys(fa, q, k, v, lo, hi):
    """The plain causal forward with keys lo..hi-1 left out: two plain
    calls over the kept keys, merged through their (m, l) stats."""
    q, k, v = q.float(), k.float(), v.float()
    o1, m1, l1 = fa._flash_fwd_plain(q, k[:, :lo], v[:, :lo], True, 0, 0)
    o2, m2, l2 = fa._flash_fwd_plain(q, k[:, hi:], v[:, hi:], True, 0, hi)
    m = m1.maximum(m2)
    w1, w2 = l1 * (m1 - m).exp(), l2 * (m2 - m).exp()
    w1, w2, l = (x.transpose(1, 2)[..., None] for x in (w1, w2, w1 + w2))
    return (o1 * w1 + o2 * w2) / l


def dq_without_keys(fa, q, k, v, do, lse, delta, lo, hi):
    """The plain causal dq with keys lo..hi-1 left out: dq is a sum over
    keys, so it is the plain dq over keys [:lo] plus that over keys [hi:]
    at k_offset hi, with the whole attention's lse and delta."""
    q, k, v, do = q.float(), k.float(), v.float(), do.float()
    return (fa._flash_dq_plain(q, k[:, :lo], v[:, :lo], do, lse, delta,
                               True, 0, 0)
            + fa._flash_dq_plain(q, k[:, hi:], v[:, hi:], do, lse, delta,
                                 True, 0, hi))


def kernel_case(fa, torch, name, b, s, h, d, dtype, causal, qo=0, ko=0,
                seed=0, design=None, lost_tiles=False):
    """Runs the forward, dq and dk/dv kernels and their plain versions on
    one input set; returns {kernel: max_abs_err}. ``design`` forces the
    sm90 or simt launchers (default: ``fa._design``)."""
    from horovod_tpu_torch.utils.tolerance import BF16_STEP, DQ_ATOL
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    design = design or fa._design(dtype, d)
    sm90 = design == "sm90"
    fwd = fa._flash_fwd_sm90 if sm90 else fa._flash_fwd_simt
    dqk = fa._flash_dq_sm90 if sm90 else fa._flash_dq_simt
    dkv = fa._flash_dkv_sm90 if sm90 else fa._flash_dkv_simt
    suffix = "_sm90" if sm90 else ""
    print(f"case {name}: B={b} S={s} H={h} D={d} {str(dtype)[6:]} "
          f"causal={causal} q_offset={qo} k_offset={ko} design={design}")
    o, m, l = fwd(q, k, v, causal, qo, ko)
    o_p, m_p, l_p = fa._flash_fwd_plain(q, k, v, causal, qo, ko)
    lse = fa._lse_from_stats(m_p, l_p)
    delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2).contiguous()
    dq = dqk(q, k, v, do, lse, delta, causal, qo, ko)
    dk, dv = dkv(q, k, v, do, lse, delta, causal, qo, ko)
    torch.cuda.synchronize()
    step = BF16_STEP if dtype == torch.bfloat16 else 0.0
    o_b = (fa._flash_fwd_plain(q, k, v, causal, qo, ko,
                               bf16_operands=True)[0] if sm90 else None)
    errs = {"flash_fwd" + suffix: max(
        check_close("forward o", o, o_p, 2e-5, step, plain_b=o_b),
        check_close("forward m", m, m_p, 2e-5, atol=1e-5, rows=False),
        check_close("forward l", l, l_p, 2e-5, rows=False))}
    if lost_tiles:
        check_close("forward o, keys 1024-1151 left out",
                    fwd_without_keys(fa, q, k, v, 1024, 1152), o_p, 2e-5,
                    step, plain_b=o_b, must_fail=True)
    del o_p, m_p, l_p, o_b
    plain_args = (q, k, v, do, lse, delta, causal, qo, ko)
    dq_p = fa._flash_dq_plain(*plain_args)
    dq_b = (fa._flash_dq_plain(*plain_args, bf16_operands=True) if sm90
            else None)
    dq_atol = DQ_ATOL if sm90 else 1e-6
    errs["flash_dq" + suffix] = check_close("dq", dq, dq_p, 1e-4, step,
                                            atol=dq_atol, plain_b=dq_b)
    if lost_tiles:
        check_close("dq, keys 1024-1087 left out",
                    dq_without_keys(fa, q, k, v, do, lse, delta, 1024, 1088),
                    dq_p, 1e-4, step, atol=dq_atol, plain_b=dq_b,
                    must_fail=True)
    del dq_p, dq_b
    dk_p, dv_p = fa._flash_dkv_plain(*plain_args)
    dk_b, dv_b = (fa._flash_dkv_plain(*plain_args, bf16_operands=True)
                  if sm90 else (None, None))
    errs["flash_dkv" + suffix] = max(
        check_close("dk", dk, dk_p, 1e-4, step, plain_b=dk_b),
        check_close("dv", dv, dv_p, 1e-4, step, plain_b=dv_b))
    if lost_tiles:
        # Zero do and delta on queries 1536-1599: p * do and ds vanish
        # there, which leaves that q tile out of dk and dv exactly.
        do_x, delta_x = do.clone(), delta.clone()
        do_x[:, 1536:1600] = 0
        delta_x[:, :, 1536:1600] = 0
        dk_x, dv_x = fa._flash_dkv_plain(q, k, v, do_x, lse, delta_x, causal,
                                         qo, ko)
        check_close("dk, queries 1536-1599 left out", dk_x, dk_p, 1e-4,
                    step, plain_b=dk_b, must_fail=True)
        check_close("dv, queries 1536-1599 left out", dv_x, dv_p, 1e-4,
                    step, plain_b=dv_b, must_fail=True)
    torch.cuda.empty_cache()
    return errs


def small_model_check(torch, seed):
    """Loss and gradients of a 2-layer fp32 model through the kernels
    equal those through dense attention."""
    from horovod_tpu_torch.models import (
        TransformerConfig, TransformerLM, causal_attention,
        lm_loss_from_hidden)
    losses, grads = [], []
    for attention_fn in (None, causal_attention):
        cfg = TransformerConfig(vocab_size=512, num_layers=2, num_heads=2,
                                head_dim=64, max_seq_len=256,
                                dtype=torch.float32,
                                attention_fn=attention_fn)
        g = torch.Generator(device="cuda").manual_seed(seed)
        model = TransformerLM(cfg, device="cuda", generator=g)
        tokens = torch.randint(0, 512, (2, 256), generator=g, device="cuda")
        hidden = model(tokens, return_hidden=True)
        loss = lm_loss_from_hidden(hidden, model.lm_head.weight.t(), tokens,
                                   chunk=100)
        loss.backward()
        losses.append(loss.detach())
        grads.append(torch.cat([p.grad.flatten()
                                for p in model.parameters()]))
    print("small model: flash path vs dense attention, fp32")
    check_close("loss", losses[0], losses[1], 2e-5)
    check_close("parameter gradients", grads[0], grads[1], 1e-4)


# Kernel-name fragments of each group of the profiled step's breakdown;
# a kernel goes to the first group one of whose fragments its name holds.
LM_GROUPS = {"flash attention kernels": ("flash_",),
             "matrix products": ("gemm", "cutlass", "xmma", "nvjet"),
             "nccl": ("nccl",)}
CONV_GROUPS = {"convolutions": ("conv", "fprop", "dgrad", "wgrad",
                                "implicit"),
               "matrix products": ("gemm", "cutlass", "xmma", "nvjet"),
               "nccl": ("nccl",)}


def check_falling(values):
    if not all(math.isfinite(x) for x in values):
        raise AssertionError(f"the loss is not finite: {values}")
    if not values[-1] < values[0]:
        raise AssertionError(f"the loss did not fall on the repeated "
                             f"batch: {values}")


def profiled_step(torch, step):
    """Runs ``step()`` once under torch.profiler; returns the profile and
    the step's host time."""
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        step().item()
        wall = time.perf_counter() - t0
    return prof, wall


def print_breakdown(prof, wall, groups):
    """Device time of one profiled step by kernel, in ``groups``, beside
    that step's host time ``wall`` (its complement is the device's idle
    share)."""
    from torch.autograd import DeviceType
    # Kernels only: a CPU op's self device time repeats its kernels'.
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us == 0:
        print("  profiled step: the profiler recorded no device time "
              "(breakdown not measured)")
        return
    by_group = {g: [] for g in list(groups) + ["other"]}
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
        name = e.key.lower()
        group = next((g for g, keys in groups.items()
                      if any(k in name for k in keys)), "other")
        by_group[group].append(e)
    # The device's and the host's clocks differ: a busy time above the
    # host time reads as no idle share.
    idle = max(0.0, 1 - total_us / 1e6 / wall)
    print(f"  profiled step: device busy {total_us / 1e3:.1f} ms of "
          f"{wall * 1e3:.1f} ms host time (idle {idle:.1%})")
    for group, members in by_group.items():
        us = sum(e.self_device_time_total for e in members)
        launches = sum(e.count for e in members)
        print(f"    {group:<26} {us / 1e3:9.2f} ms  {us / total_us:6.1%}  "
              f"{launches} launches")
        # The largest kernels of the group, so that its contents show.
        for e in members[:3]:
            print(f"      {e.self_device_time_total / 1e3:9.2f} ms  "
                  f"x{e.count:<4} {e.key[:90]}")


def main_path(torch, hvd, args, card):
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.models import TransformerConfig
    from horovod_tpu_torch.parallel import flash_attention as fa
    from horovod_tpu_torch.utils.timing import steady_state_sec_per_step

    hvd.init()
    b, s = MAIN["b"], MAIN["s"]
    cfg = TransformerConfig(vocab_size=32000, num_layers=args.layers,
                            num_heads=16, head_dim=128, max_seq_len=s,
                            dtype=torch.bfloat16)
    train, model = bench.transformer_step(cfg, b, seed=args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    losses = []

    def step():
        losses.append(train())
        return losses[-1]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    sec = steady_state_sec_per_step(step, lambda loss: loss.item(),
                                    warmup_steps=args.warmup,
                                    chunks=args.steps, chunk_steps=1)
    prof, wall = profiled_step(torch, step)
    counts = fa.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    values = [x.item() for x in losses]
    print(f"main path: L{cfg.num_layers} d{cfg.embed_dim} S{s} B{b} "
          f"V{cfg.vocab_size}, {n_params / 1e6:.1f}M parameters, "
          f"{len(values)} steps ({args.warmup} warm-up)")
    print(f"  losses: {' '.join(f'{x:.4f}' for x in values)}")
    print(f"  launches: {counts}")
    # Model FLOPs as bench.py counts them: 6 x matmul parameters (all but
    # the embedding table) + 12 x L x S x d per token.
    model_flops = b * s * (6 * (n_params - cfg.vocab_size * cfg.embed_dim)
                           + 12 * cfg.num_layers * s * cfg.embed_dim)
    print(f"  sec/step {sec:.4f}, tokens/s {b * s / sec:.0f}, "
          f"model TFLOP/s {model_flops / sec / 1e12:.1f} "
          f"(MFU {model_flops / sec / PEAK_BF16_FLOPS:.1%} of 989 bf16), "
          f"max_memory_allocated {peak / 2**30:.2f} GiB  [{card}]")
    print_breakdown(prof, wall, LM_GROUPS)
    check_falling(values)
    want = cfg.num_layers * len(values)
    expected = {name: (want if name in MAIN_PATH_KERNELS else 0)
                for name in counts}
    if counts != expected:
        raise AssertionError(f"expected {want} launches ({cfg.num_layers} "
                             f"per step) of each of {MAIN_PATH_KERNELS} "
                             f"and none of the others, got {counts}")
    hvd.shutdown()
    del model, train
    torch.cuda.empty_cache()
    return counts


def vision_small_check(torch, seed):
    """A narrow fp32 ResNet and ViT with the same weights on the card
    (TF32 off) and on the CPU: logits, loss, every parameter gradient
    and the BatchNorm running statistics of one training pass agree
    within 1e-4 + 1e-4 |cpu| element by element."""
    import copy
    import torch.nn.functional as F
    from horovod_tpu_torch.models import vit
    from horovod_tpu_torch.models import resnet

    def train_pass(model, images, labels):
        logits = model(images)
        loss = F.cross_entropy(logits, labels)
        loss.backward()
        out = {"logits": logits.detach(), "loss": loss.detach()}
        out.update({n: p.grad for n, p in model.named_parameters()})
        out.update(dict(model.named_buffers()))
        return {k: v.cpu() for k, v in out.items()}

    builds = {
        "resnet (bottleneck, 8 filters)": lambda: resnet.ResNet(
            stage_sizes=[1, 1], block_cls=resnet.BottleneckBlock,
            num_filters=8, num_classes=10, dtype=torch.float32,
            device="cpu", generator=torch.Generator().manual_seed(seed)),
        "vit (2 layers, d 64)": lambda: vit.ViT(vit.ViTConfig(
            image_size=32, patch_size=4, num_classes=10, embed_dim=64,
            num_layers=2, num_heads=4, dtype=torch.float32), device="cpu",
            generator=torch.Generator().manual_seed(seed)),
    }
    g = torch.Generator().manual_seed(seed)
    images = torch.randn(4, 32, 32, 3, generator=g)
    labels = torch.randint(0, 10, (4,), generator=g)
    print("small vision models: the card against the CPU, fp32")
    for label, build in builds.items():
        cpu_model = build()
        card_model = copy.deepcopy(cpu_model).to("cuda")
        want = train_pass(cpu_model, images, labels)
        got = train_pass(card_model, images.cuda(), labels.cuda())
        ratio = max(((got[k] - want[k]).abs()
                     / (1e-4 + 1e-4 * want[k].abs())).max().item()
                    for k in want)
        print(f"  {label:<34} {len(want)} tensors, worst err/tol "
              f"{ratio:.3f} {'ok' if ratio <= 1 else 'FAIL'}")
        if not ratio <= 1:
            raise AssertionError(f"{label}: the card and the CPU differ "
                                 f"({ratio:.3f} of the tolerance)")


def classifier_leg(torch, hvd, args, card, label, build, batch,
                   macs_per_image=None):
    """``steps`` timed training steps (after ``warmup``) of the image
    classifier ``build()`` through the bench's ``classifier_step`` at 224x224,
    then one profiled step. The loss must be finite and fall, and no
    flash kernel may launch. Prints images/s, MFU where the model's
    multiply-adds per image are known, peak memory and the profiled
    step's device time by group."""
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.parallel import flash_attention as fa
    from horovod_tpu_torch.utils.timing import steady_state_sec_per_step

    hvd.init()
    model = build()
    train = bench.classifier_step(model, batch, seed=args.seed)
    losses = []

    def step():
        losses.append(train())
        return losses[-1]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    sec = steady_state_sec_per_step(step, lambda loss: loss.item(),
                                    warmup_steps=args.warmup,
                                    chunks=args.steps, chunk_steps=1)
    prof, wall = profiled_step(torch, step)
    counts = fa.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    values = [x.item() for x in losses]
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{label}: batch {batch} of 224x224, {n_params / 1e6:.2f}M "
          f"parameters, {len(values)} steps ({args.warmup} warm-up)")
    print(f"  losses: {' '.join(f'{x:.4f}' for x in values)}")
    mfu = ""
    if macs_per_image is not None:
        flops = 3 * 2 * macs_per_image * batch
        mfu = (f", model TFLOP/s {flops / sec / 1e12:.1f} (MFU "
               f"{flops / sec / PEAK_BF16_FLOPS:.1%} of 989 bf16)")
    print(f"  sec/step {sec:.4f}, images/s {batch / sec:.1f}{mfu}, "
          f"max_memory_allocated {peak / 2**30:.2f} GiB  [{card}]")
    print_breakdown(prof, wall, CONV_GROUPS)
    check_falling(values)
    if any(counts.values()):
        raise AssertionError(f"{label} launched flash kernels: {counts}")
    hvd.shutdown()
    del model, train, step
    torch.cuda.empty_cache()


def kernel_times(torch, fa):
    """ms, plain_ms, library_ms and bound_ms of each kernel at the main
    path's shape (bf16, causal); the simt kernels are timed through their
    private launchers on the same inputs."""
    import torch.nn.functional as F
    b, s, h, d = MAIN["b"], MAIN["s"], MAIN["h"], MAIN["d"]
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    o, m, l = fa._flash_fwd(q, k, v, True, 0, 0)
    lse = fa._lse_from_stats(m, l)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, True, 0, 0)
    fwd_args = (q, k, v, True, 0, 0)
    plain = {"fwd": time_ms(lambda: fa._flash_fwd_plain(*fwd_args), 5),
             "dq": time_ms(lambda: fa._flash_dq_plain(*args), 5),
             "dkv": time_ms(lambda: fa._flash_dkv_plain(*args), 5)}
    # Each function's two designs are timed in turns: simt, sm90, sm90,
    # simt, each a mean of 20 launches; the kept time is the mean of two.
    t = {}
    for fn, pair in (("fwd", (lambda: fa._flash_fwd_simt(*fwd_args),
                              lambda: fa._flash_fwd_sm90(*fwd_args))),
                     ("dq", (lambda: fa._flash_dq_simt(*args),
                             lambda: fa._flash_dq_sm90(*args))),
                     ("dkv", (lambda: fa._flash_dkv_simt(*args),
                              lambda: fa._flash_dkv_sm90(*args)))):
        order = (0, 1, 1, 0)
        ms = [time_ms(pair[i], 20) for i in order]
        t[f"flash_{fn}"] = ((ms[0] + ms[3]) / 2, plain[fn])
        t[f"flash_{fn}_sm90"] = ((ms[1] + ms[2]) / 2, plain[fn])
    # The library yardstick on [B, H, S, D] copies made outside the timing.
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 20)
    qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))

    def fwd_bwd():
        F.scaled_dot_product_attention(qg, kg, vg, is_causal=True).backward(
            dot)
    lib_fwd_bwd = time_ms(fwd_bwd, 20)
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), dot, retain_graph=True), 20)

    bh, elt = b * h, 2
    tensor = b * s * h * d * elt
    stats = b * h * s * 4
    # 2 x D operations per visible (q, k) pair (half of them, causal) for
    # each matrix product the function needs: s and p.v forward; s, dp
    # and ds.k for dq; s, dp, p^T.do and ds^T.q for dk/dv.
    flops = {"fwd": 4 * bh * s * s * d // 2,
             "dq": 6 * bh * s * s * d // 2,
             "dkv": 8 * bh * s * s * d // 2}
    moved = {"fwd": 4 * tensor + 2 * stats,      # q k v in, o m l out
             "dq": 5 * tensor + 2 * stats,       # q k v do lse delta, dq
             "dkv": 6 * tensor + 2 * stats}      # ... dk dv out
    rows = {}
    for name in t:
        fn = name.split("_")[1]
        op_ms = flops[fn] / PEAK_BF16_FLOPS * 1e3
        byte_ms = moved[fn] / PEAK_BYTES_PER_S * 1e3
        rows[name] = dict(
            ms=t[name][0], plain_ms=t[name][1],
            library_ms=lib_fwd if fn == "fwd" else lib_fwd_bwd,
            bound_ms=max(op_ms, byte_ms),
            bound_by="operations" if op_ms >= byte_ms else "bytes")
        if fn != "fwd":
            rows[name]["library_bwd_only_ms"] = lib_bwd
    return rows


# The full-width LM of phase 4 (bench.py's), at a depth given per phase.
LM_FULL = dict(vocab_size=32000, num_heads=16, head_dim=128,
               max_seq_len=MAIN["s"])


def check_timeline(path, required):
    """The timeline file at ``path`` must hold every event name in
    ``required``."""
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)}
    missing = [n for n in required if n not in names]
    print(f"  timeline: {len(names)} event names; holds "
          f"{', '.join(required)}: "
          f"{'ok' if not missing else 'FAIL, missing ' + str(missing)}")
    if missing:
        raise AssertionError(f"timeline {path} lacks {missing}")


def timed_steps(step, n):
    """Runs ``n`` steps, each ended by its loss's ``.item()``; returns
    the losses and each step's host seconds."""
    losses, secs = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        losses.append(step().item())
        secs.append(time.perf_counter() - t0)
    return losses, secs


def runtime_counts():
    from horovod_tpu_torch.common import basics
    return dict(basics.runtime().stats)


def print_negotiation(before, after, steps):
    d = {k: after[k] - before[k] for k in after}
    per_cycle_ms = d["negotiate_s"] / max(1, d["cycles"]) * 1e3
    negotiate_ms, execute_ms = (d["negotiate_s"] / steps * 1e3,
                                d["execute_s"] / steps * 1e3)
    print(f"  runtime: {d['cycles'] / steps:.1f} cycles per step, "
          f"{d['responses'] / steps:.1f} responses per step, "
          f"{d['tensors'] / max(1, d['responses']):.2f} tensors per "
          f"response, negotiation {per_cycle_ms:.3f} ms per cycle; the "
          f"loop's thread busy {negotiate_ms + execute_ms:.1f} ms per step "
          f"(negotiation {negotiate_ms:.1f}, execution {execute_ms:.1f})")


def eager_runtime_phase(torch, hvd, args, card, workdir):
    """Phase 9: the eager (hook-driven, negotiated) optimizer against the
    in-step one at full width on one card; returns phase 10's whole-batch
    reference (losses, initial and final parameters on the host)."""
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.models import TransformerConfig
    timeline = os.path.join(workdir, "timeline_size1.json")
    os.environ.update(HOROVOD_TIMELINE=timeline,
                      HOROVOD_TIMELINE_MARK_CYCLES="1")
    cfg = TransformerConfig(num_layers=args.layers, dtype=torch.bfloat16,
                            **LM_FULL)
    b = MAIN["b"]
    hvd.init()
    try:
        runs = {}
        for eager in (False, True):
            step, model = bench.transformer_step(cfg, b, seed=args.seed,
                                                 eager=eager)
            torch.cuda.synchronize()
            before = runtime_counts()
            losses, secs = timed_steps(step, 5)
            after = runtime_counts()
            params = [p.detach().clone() for p in model.parameters()]
            prof, wall = profiled_step(torch, step)
            runs[eager] = (losses, secs, params, before, after, prof, wall)
            del step, model
            torch.cuda.empty_cache()
        print(f"eager runtime, size 1: L{cfg.num_layers} d{cfg.embed_dim} "
              f"S{cfg.max_seq_len} B{b} V{cfg.vocab_size}, 5 steps each "
              f"from seed {args.seed}  [{card}]")
        for eager, label in ((False, "in-step"), (True, "eager")):
            losses, secs, _, before, after, prof, wall = runs[eager]
            print(f"  {label:<8} losses {' '.join(f'{x:.6f}' for x in losses)}"
                  f"; sec/step {statistics.median(secs[1:]):.4f} (median "
                  f"of steps 2-5; step 1 {secs[0]:.3f})")
            if eager:
                print_negotiation(before, after, 5)
            print_breakdown(prof, wall, LM_GROUPS)
        (l0, _, p0, *_), (l1, _, p1, *_) = runs[False], runs[True]
        same = l0 == l1 and all(torch.equal(a, c) for a, c in zip(p0, p1))
        print(f"  eager == in-step (5 losses, {len(p0)} parameters): "
              f"{'ok' if same else 'FAIL'}")
        if not same:
            worst = max((a - c).abs().max().item() for a, c in zip(p0, p1))
            raise AssertionError(f"the eager steps differ from the in-step "
                                 f"ones: losses {l0} vs {l1}, largest "
                                 f"parameter difference {worst:.3e}")
        del runs, p0, p1
        torch.cuda.empty_cache()
        # Phase 10's reference: one rank, the whole batch of 4.
        cfg2 = dataclasses.replace(cfg, num_layers=2)
        step, model = bench.transformer_step(cfg2, 4, seed=args.seed,
                                             eager=True)
        init = [p.detach().to("cpu", copy=True) for p in model.parameters()]
        losses, _ = timed_steps(step, 3)
        ref = (losses, init, [p.detach().to("cpu", copy=True)
                             for p in model.parameters()])
        del step, model
    finally:
        hvd.shutdown()
        for k in ("HOROVOD_TIMELINE", "HOROVOD_TIMELINE_MARK_CYCLES"):
            os.environ.pop(k, None)
    check_timeline(timeline, ("NEGOTIATE_ALLREDUCE", "ALLREDUCE", "QUEUE",
                              "COLLECTIVE", "CYCLE_START"))
    torch.cuda.empty_cache()
    return ref


def world_check(torch, label, got, want):
    ok = (got.dtype == want.dtype and got.device == want.device
          and got.shape == want.shape and torch.equal(got, want))
    print(f"    {label:<40} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: got {got} want {want}")


def two_rank_world(torch, hvd, args, rank, port, workdir, ref=None):
    """Phase 10, run by both ranks of a world of two on one card. Only
    the runtime's ops run (NCCL refuses two ranks on one device)."""
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.models import TransformerConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE="2",
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                      HOROVOD_CONTROLLER_PORT=str(port))
    timeline = os.path.join(workdir, "timeline_size2.json")
    if rank == 0:
        os.environ.update(HOROVOD_TIMELINE=timeline,
                          HOROVOD_TIMELINE_MARK_CYCLES="1")
    hvd.init()
    try:
        dev = torch.device("cuda", torch.cuda.current_device())
        print(f"two-rank world: rank {hvd.rank()} of {hvd.size()} on {dev}")
        print("  collectives on CUDA tensors, against closed forms:")
        c = lambda *a: world_check(torch, *a)  # noqa: E731
        x = torch.full((4, 3), float(rank + 1), device=dev)
        c("allreduce sum fp32", hvd.allreduce(x, op=hvd.Sum, name="w.ar"),
          torch.full((4, 3), 3.0, device=dev))
        c("allreduce average fp32", hvd.allreduce(x, name="w.avg"),
          torch.full((4, 3), 1.5, device=dev))
        xb = (torch.arange(64, device=dev) + rank).bfloat16()
        c("allreduce sum bf16", hvd.allreduce(xb, op=hvd.Sum, name="w.bf"),
          (2 * torch.arange(64, device=dev) + 1).bfloat16())
        c("allgather, dim 0 of 1 and 2 rows",
          hvd.allgather(torch.full((rank + 1, 2), float(rank), device=dev),
                        name="w.ag"),
          torch.tensor([[0.0, 0], [1, 1], [1, 1]], device=dev))
        c("broadcast from rank 1, fp64",
          hvd.broadcast(torch.full((3, 3), rank * 10.0, device=dev,
                                   dtype=torch.float64), 1, name="w.bc"),
          torch.full((3, 3), 10.0, device=dev, dtype=torch.float64))
        c("alltoall", hvd.alltoall(torch.arange(4.0, device=dev)
                                   + 100 * rank, name="w.a2a"),
          torch.tensor([0.0, 1, 100, 101], device=dev) + 2 * rank)
        c("reducescatter", hvd.reducescatter(
            torch.arange(6.0, device=dev) * (rank + 1), name="w.rs"),
          torch.arange(6.0, device=dev)[3 * rank:3 * rank + 3] * 3)
        outs = hvd.grouped_allreduce(
            [torch.full((16 + i,), (rank + 1.0) * (i + 1), device=dev)
             for i in range(6)], op=hvd.Sum, name="w.grp")
        for i, o in enumerate(outs):
            c(f"grouped member {i} (one fused response)", o,
              torch.full((16 + i,), 3.0 * (i + 1), device=dev))

        print("  negative probe: float32 on rank 0, float64 on rank 1")
        try:
            hvd.allreduce(torch.ones(3, device=dev,
                                     dtype=(torch.float32, torch.float64)
                                     [rank]), name="w.mm")
        except hvd.HorovodInternalError as e:
            print(f"    raised on rank {rank}: {str(e)[:70]}")
        else:
            raise AssertionError("mismatched dtypes did not raise")
        c("the world works afterwards", hvd.allreduce(
            torch.ones(3, device=dev), op=hvd.Sum, name="w.after"),
          torch.full((3,), 2.0, device=dev))

        print("  ready event: 16 chained 8192^2 x 256 fp32 matmuls write x "
              "right before allreduce_async")
        g = torch.Generator(device=dev).manual_seed(args.seed + 7)
        a = torch.randn(8192, 8192, generator=g, device=dev) / 90.5
        y = torch.randn(8192, 256, generator=g, device=dev)
        torch.cuda.synchronize()
        for _ in range(16):
            y = torch.tanh(a @ y)
        x = y[:, 0] * (rank + 1)
        busy = not torch.cuda.current_stream().query()
        h = hvd.allreduce_async(x, op=hvd.Sum, name="w.ready")
        got = hvd.synchronize(h).clone()
        torch.cuda.synchronize()
        xs = hvd.allgather(x.cpu()[None], name="w.ready.x")
        print(f"    the stream was still busy at the enqueue: {busy}")
        c("arrived holding the matmuls' result", got,
          (xs[0] + xs[1]).to(dev))
        if not busy:
            raise AssertionError("the matmuls ended before the enqueue: "
                                 "the check would show nothing")

        print("  the LM at full width, depth 2, 2 rows per rank, 3 eager "
              "steps:")
        plane = basics.runtime().op_manager.backends[0]
        cfg = TransformerConfig(num_layers=2, dtype=torch.bfloat16,
                                **LM_FULL)
        step, model = bench.transformer_step(cfg, 2, seed=args.seed,
                                             eager=True)
        torch.cuda.synchronize()
        before = runtime_counts()
        to_host, from_host = plane.bytes_to_host, plane.bytes_from_host
        losses, secs = timed_steps(step, 3)
        print(f"    losses {' '.join(f'{v:.6f}' for v in losses)}; sec/step "
              f"{' '.join(f'{v:.3f}' for v in secs)}")
        print(f"    bytes card->host {(plane.bytes_to_host - to_host) / 3:.4g}"
              f" and host->card {(plane.bytes_from_host - from_host) / 3:.4g}"
              f" per step")
        print_negotiation(before, runtime_counts(), 3)
        params = [p.detach().to("cpu", copy=True) for p in model.parameters()]
        sums = torch.stack([p.double().sum() for p in params])
        every = hvd.allgather(sums[None], name="w.sums")
        all_losses = hvd.allgather(torch.tensor([losses]), name="w.losses")
        del step, model
    finally:
        hvd.shutdown()
        for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
                  "HOROVOD_CONTROLLER_ADDR", "HOROVOD_CONTROLLER_PORT",
                  "HOROVOD_TIMELINE", "HOROVOD_TIMELINE_MARK_CYCLES"):
            os.environ.pop(k, None)
    if rank != 0:
        return
    check_timeline(timeline, ("NEGOTIATE_ALLREDUCE", "ALLREDUCE",
                              "MEMCPY_IN_FUSION_BUFFER",
                              "MEMCPY_OUT_FUSION_BUFFER", "CYCLE_START"))
    ref_losses, ref_init, ref_after = ref
    mean = all_losses.mean(0).tolist()
    loss_err = max(abs(m - r) / abs(r) for m, r in zip(mean, ref_losses))
    ratio = max(((p - q).abs().max() / (q - i).abs().max()).item()
                for p, q, i in zip(params, ref_after, ref_init))
    same = torch.equal(every[0], every[1])
    print(f"  against one rank on the whole batch: losses "
          f"{' '.join(f'{v:.6f}' for v in ref_losses)}, the ranks' mean "
          f"within {loss_err:.2e} of them (bound 1e-4); every parameter "
          f"within {ratio:.2e} of its largest update (bound 2^-6 = "
          f"{2 ** -6:.2e}); the two ranks' parameters equal: {same}")
    if not (loss_err <= 1e-4 and ratio <= 2 ** -6 and same):
        raise AssertionError("the two-rank steps do not agree with the "
                             "whole-batch steps")


def start_rank1(args, port, workdir):
    """Phase 10's rank 1: this script again, with its output in a log."""
    log = open(os.path.join(workdir, "rank1.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seed",
         str(args.seed), "--world-rank1", str(port), workdir],
        stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return proc


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=5)
    # Internal: run as rank 1 of phase 10's world (port, work directory).
    ap.add_argument("--world-rank1", nargs=2, metavar=("PORT", "DIR"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import _cuda
    from horovod_tpu_torch.parallel import flash_attention as fa
    if args.world_rank1:
        port, workdir = args.world_rank1
        two_rank_world(torch, hvd, args, 1, int(port), workdir)
        return 0

    # Phase 1: card and build.
    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    _cuda.load()
    built = "nvcc ran" if _cuda.build_seconds is not None else \
        "library already built"
    print(f"kernel build: {time.perf_counter() - t0:.1f} s ({built})")

    # Phase 2: kernels against their plain versions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, fp32 = torch.bfloat16, torch.float32
    errs = kernel_case(fa, torch, "main_simt", **MAIN, dtype=bf16,
                       causal=True, seed=7, design="simt")
    errs.update(kernel_case(fa, torch, "main", **MAIN, dtype=bf16,
                            causal=True, lost_tiles=True))
    kernel_case(fa, torch, "noncausal", 2, 256, 4, 128, bf16, False, seed=1)
    kernel_case(fa, torch, "q_offset", 1, 512, 4, 128, bf16, True, qo=128,
                seed=2)
    kernel_case(fa, torch, "dead_rows", 1, 256, 4, 128, bf16, True, ko=192,
                seed=3)
    kernel_case(fa, torch, "d64", 2, 512, 8, 64, bf16, True, seed=4)
    kernel_case(fa, torch, "short_ragged", 2, 40, 3, 64, bf16, True, seed=8)
    kernel_case(fa, torch, "fp32", 2, 512, 4, 128, fp32, True, qo=64,
                seed=5)
    kernel_case(fa, torch, "main_fp32", **MAIN, dtype=fp32, causal=True,
                seed=6)

    # Phase 3: a small model against the dense reference.
    small_model_check(torch, args.seed)

    # Phase 4: the main path.
    counts = main_path(torch, hvd, args, card)

    # Phase 5: times.
    rows = kernel_times(torch, fa)

    # Phase 6: small vision models, the card against the CPU.
    vision_small_check(torch, args.seed)

    # Phase 7: the bench's ResNet-50 leg at full width.
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.models import ResNet50, ViT_B16
    g = torch.Generator(device="cuda")
    classifier_leg(torch, hvd, args, card, "resnet50 (bf16, cross-replica "
                   "BatchNorm over data)", lambda: ResNet50(
                       num_classes=1000, dtype=torch.bfloat16,
                       axis_name="data", generator=g.manual_seed(args.seed)),
                   batch=256, macs_per_image=bench.RESNET50_MACS_PER_IMAGE)

    # Phase 8: ViT-B/16.
    classifier_leg(torch, hvd, args, card, "vit_b16 (bf16)",
                   lambda: ViT_B16(generator=g.manual_seed(args.seed)),
                   batch=64)

    with tempfile.TemporaryDirectory(prefix="chip_smoke.") as workdir:
        # Phase 9: the negotiated runtime at size 1.
        ref = eager_runtime_phase(torch, hvd, args, card, workdir)
        # Phase 10: a two-rank world on this card.
        port = free_port()
        rank1 = start_rank1(args, port, workdir)
        try:
            two_rank_world(torch, hvd, args, 0, port, workdir, ref)
            rank1.wait(timeout=300)
        finally:
            if rank1.poll() is None:
                rank1.kill()
                rank1.wait()
        if rank1.returncode != 0:
            with open(os.path.join(workdir, "rank1.log")) as f:
                print(f.read()[-4000:])
            raise AssertionError(f"rank 1 exited with {rank1.returncode}")
    csrc, ref = "horovod_tpu_torch/csrc/", \
        "horovod_tpu/parallel/flash_attention.py:"
    sources = {"flash_fwd": ("flash_fwd.cu", "58"),
               "flash_fwd_sm90": ("flash_fwd_sm90.cu", "58"),
               "flash_dq": ("flash_bwd.cu", "204"),
               "flash_dq_sm90": ("flash_dq_sm90.cu", "204"),
               "flash_dkv": ("flash_bwd.cu", "236"),
               "flash_dkv_sm90": ("flash_dkv_sm90.cu", "236")}
    kernels = []
    for name, (src, replaces) in sources.items():
        kernels.append(dict(name=name, route="cuda", source=csrc + src,
                            replaces=ref + replaces, launches=counts[name],
                            max_abs_err=errs[name], **rows[name]))
        r = rows[name]
        print(f"{name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, "
              f"library {r['library_ms']:.3f}, bound {r['bound_ms']:.4f} "
              f"by {r['bound_by']})")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
