"""Smoke test of the PyTorch port (horovod_tpu_torch) on one NVIDIA H100.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit (nvcc for sm_90a):

    python3 chip_smoke.py [--seed 0] [--layers 12] [--warmup 2] [--steps 5]

Phases (any failure ends the run with a nonzero exit and no result line):

1. Card and build: prints the card's name and power limit, builds the
   flash-attention kernels from horovod_tpu_torch/csrc with nvcc and
   prints the build time.
2. Kernels against their plain PyTorch versions, on the card: forward
   (o, m, l), dq and dk/dv at the main path's shape (B=4, S=2048, H=16,
   D=128, bf16, causal) and at a non-causal, two offset, a D=64 and an
   fp32 case, and in fp32 at the main path's shape too. Each element is
   held to its own bound, |mine - plain| <= atol + rtol * max|plain row|
   + step * |plain|, where a row is the last axis (D for o and the
   gradients; m and l are held element by element, row = the element).
   Both versions compute in fp32 from the same inputs, in another
   summation order, which moves a result by a small fraction of its
   row's scale: rtol 2e-5 (o, m, l) or 1e-4 (gradients). bf16 outputs
   are then rounded to bf16 by both, which may part them by one bf16
   step of the element itself, step = 2^-7; fp32 outputs have step 0.
   One step at a value that is a power of two fills the bound, so a
   bf16 case's worst err/tol reads near 0.99; two steps fail it.
3. A small model checked against the dense reference: a 2-layer fp32
   TransformerLM gives the same loss and gradients through the flash
   kernels as through dense attention (2e-5 and 1e-4).
4. The main path at full width: hvd.init(), the bench's TransformerLM
   (vocab 32000, 12 layers, 16 heads of 128, S=2048; fp32 weights, bf16
   compute) with random weights from --seed, DistributedOptimizer(SGD
   lr 0.01, momentum 0.9), broadcast_parameters, and training steps on
   one fixed batch of 4 x 2048 random tokens. The loss must be finite and
   fall, and each kernel must launch once per layer per step. One more
   step runs under torch.profiler and prints its device time by kernel.
5. Kernel times at the main path's shape beside the plain version, the
   PyTorch library call computing the same function
   (scaled_dot_product_attention, timed here only as a yardstick) and the
   bound: the larger of the operations the function needs (2 x D per
   visible (q, k) pair and matrix product: two products forward, three
   for dq, four for dk/dv) over the card's bf16 dense peak
   (989 TFLOP/s) and the bytes in and out over its memory rate
   (3.35 TB/s).

The last two lines are the JSON ``kernels`` line and the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
MAIN = dict(b=4, s=2048, h=16, d=128)


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


def check_close(label, mine, plain, rtol, step=0.0, atol=1e-6,
                rows=True) -> float:
    """Holds every element of ``mine`` to atol + rtol * max|plain row| +
    step * |plain| (``rows=False``: the row is the element itself);
    returns the largest absolute error."""
    mine, plain = mine.float(), plain.float()
    err = (mine - plain).abs()
    size = plain.abs()
    scale = size.amax(-1, keepdim=True) if rows else size
    tol = atol + rtol * scale + step * size
    ratio = (err / tol).max().item()
    max_err = err.max().item()
    ok = math.isfinite(max_err) and ratio <= 1.0
    print(f"  {label:<34} max_abs_err={max_err:.3e} "
          f"worst err/tol={ratio:.3f} (rtol={rtol:g} of the "
          f"{'row' if rows else 'element'}, step={step:g}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: an element is {ratio:.3f} times "
                             f"its tolerance")
    return max_err


def kernel_case(fa, torch, name, b, s, h, d, dtype, causal, qo=0, ko=0,
                seed=0):
    """Runs the three kernels and their plain versions on one input set;
    returns {kernel: max_abs_err}."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    bf16 = dtype == torch.bfloat16
    print(f"case {name}: B={b} S={s} H={h} D={d} {str(dtype)[6:]} "
          f"causal={causal} q_offset={qo} k_offset={ko}")
    o, m, l = fa._flash_fwd(q, k, v, causal, qo, ko)
    o_p, m_p, l_p = fa._flash_fwd_plain(q, k, v, causal, qo, ko)
    lse = fa._lse_from_stats(m_p, l_p)
    delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa._flash_dq(q, k, v, do, lse, delta, causal, qo, ko)
    dk, dv = fa._flash_dkv(q, k, v, do, lse, delta, causal, qo, ko)
    torch.cuda.synchronize()
    step = 2.0 ** -7 if bf16 else 0.0
    errs = {"flash_fwd": max(
        check_close("forward o", o, o_p, 2e-5, step),
        check_close("forward m", m, m_p, 2e-5, atol=1e-5, rows=False),
        check_close("forward l", l, l_p, 2e-5, rows=False))}
    del o_p, m_p, l_p
    errs["flash_dq"] = check_close(
        "dq", dq, fa._flash_dq_plain(q, k, v, do, lse, delta, causal, qo,
                                     ko), 1e-4, step)
    dk_p, dv_p = fa._flash_dkv_plain(q, k, v, do, lse, delta, causal, qo, ko)
    errs["flash_dkv"] = max(check_close("dk", dk, dk_p, 1e-4, step),
                            check_close("dv", dv, dv_p, 1e-4, step))
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


def print_breakdown(prof, wall):
    """Device time of one profiled step by kernel, grouped, beside that
    step's host time ``wall`` (its complement is the device's idle
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
    groups = {"flash attention kernels": ("flash_",),
              "matrix products": ("gemm", "cutlass", "xmma", "nvjet"),
              "nccl": ("nccl",)}
    by_group = dict.fromkeys(list(groups) + ["other"], 0.0)
    for e in kernels:
        name = e.key.lower()
        group = next((g for g, keys in groups.items()
                      if any(k in name for k in keys)), "other")
        by_group[group] += e.self_device_time_total
    # The device's and the host's clocks differ: a busy time above the
    # host time reads as no idle share.
    idle = max(0.0, 1 - total_us / 1e6 / wall)
    print(f"  profiled step: device busy {total_us / 1e3:.1f} ms of "
          f"{wall * 1e3:.1f} ms host time (idle {idle:.1%})")
    for group, us in by_group.items():
        print(f"    {group:<26} {us / 1e3:9.2f} ms  {us / total_us:6.1%}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<4} "
              f"{e.key[:70]}")


def main_path(torch, hvd, args, card):
    from horovod_tpu_torch.models import (
        TransformerConfig, TransformerLM, lm_loss_from_hidden)
    from horovod_tpu_torch.parallel import flash_attention as fa
    from horovod_tpu_torch.utils.timing import steady_state_sec_per_step

    hvd.init()
    b, s = MAIN["b"], MAIN["s"]
    cfg = TransformerConfig(vocab_size=32000, num_layers=args.layers,
                            num_heads=16, head_dim=128, max_seq_len=s,
                            dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    model = TransformerLM(cfg, generator=g)
    n_params = sum(p.numel() for p in model.parameters())
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        axis="data")
    hvd.broadcast_parameters(model, root_rank=0)
    tokens = torch.randint(0, cfg.vocab_size, (b * hvd.size(), s),
                           generator=g, device="cuda")
    tokens = tokens[hvd.rank() * b:(hvd.rank() + 1) * b]
    losses = []

    def step():
        opt.zero_grad(set_to_none=True)
        hidden = model(tokens, return_hidden=True)
        loss = lm_loss_from_hidden(hidden, model.lm_head.weight.t(), tokens)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        return losses[-1]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    sec = steady_state_sec_per_step(step, lambda loss: loss.item(),
                                    warmup_steps=args.warmup,
                                    chunks=args.steps, chunk_steps=1)
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        step().item()
        wall = time.perf_counter() - t0
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
    print_breakdown(prof, wall)
    if not all(math.isfinite(x) for x in values):
        raise AssertionError("the loss is not finite")
    if not values[-1] < values[0]:
        raise AssertionError("the loss did not fall on the repeated batch")
    want = cfg.num_layers * len(values)
    if any(n != want for n in counts.values()):
        raise AssertionError(f"expected {want} launches of each kernel "
                             f"({cfg.num_layers} per step), got {counts}")
    hvd.shutdown()
    del model, opt
    torch.cuda.empty_cache()
    return counts


def kernel_times(torch, fa):
    """ms, plain_ms, library_ms and bound_ms of each kernel at the main
    path's shape (bf16, causal)."""
    import torch.nn.functional as F
    b, s, h, d = MAIN["b"], MAIN["s"], MAIN["h"], MAIN["d"]
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    o, m, l = fa._flash_fwd(q, k, v, True, 0, 0)
    lse = fa._lse_from_stats(m, l)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, True, 0, 0)
    t = {
        "flash_fwd": (time_ms(lambda: fa._flash_fwd(q, k, v, True, 0, 0), 20),
                      time_ms(lambda: fa._flash_fwd_plain(q, k, v, True, 0, 0),
                              5)),
        "flash_dq": (time_ms(lambda: fa._flash_dq(*args), 20),
                     time_ms(lambda: fa._flash_dq_plain(*args), 5)),
        "flash_dkv": (time_ms(lambda: fa._flash_dkv(*args), 20),
                      time_ms(lambda: fa._flash_dkv_plain(*args), 5)),
    }
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
    flops = {"flash_fwd": 4 * bh * s * s * d // 2,
             "flash_dq": 6 * bh * s * s * d // 2,
             "flash_dkv": 8 * bh * s * s * d // 2}
    moved = {"flash_fwd": 4 * tensor + 2 * stats,      # q k v in, o m l out
             "flash_dq": 5 * tensor + 2 * stats,       # q k v do lse delta, dq
             "flash_dkv": 6 * tensor + 2 * stats}      # ... dk dv out
    rows = {}
    for name in t:
        op_ms = flops[name] / PEAK_BF16_FLOPS * 1e3
        byte_ms = moved[name] / PEAK_BYTES_PER_S * 1e3
        rows[name] = dict(
            ms=t[name][0], plain_ms=t[name][1],
            library_ms=lib_fwd if name == "flash_fwd" else lib_fwd_bwd,
            bound_ms=max(op_ms, byte_ms),
            bound_by="operations" if op_ms >= byte_ms else "bytes")
        if name != "flash_fwd":
            rows[name]["library_bwd_only_ms"] = lib_bwd
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=5)
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
    errs = kernel_case(fa, torch, "main", **MAIN, dtype=bf16, causal=True)
    kernel_case(fa, torch, "noncausal", 2, 256, 4, 128, bf16, False, seed=1)
    kernel_case(fa, torch, "q_offset", 1, 512, 4, 128, bf16, True, qo=128,
                seed=2)
    kernel_case(fa, torch, "dead_rows", 1, 256, 4, 128, bf16, True, ko=192,
                seed=3)
    kernel_case(fa, torch, "d64", 2, 512, 8, 64, bf16, True, seed=4)
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
    sources = {"flash_fwd": ("horovod_tpu_torch/csrc/flash_fwd.cu",
                             "horovod_tpu/parallel/flash_attention.py:58"),
               "flash_dq": ("horovod_tpu_torch/csrc/flash_bwd.cu",
                            "horovod_tpu/parallel/flash_attention.py:204"),
               "flash_dkv": ("horovod_tpu_torch/csrc/flash_bwd.cu",
                             "horovod_tpu/parallel/flash_attention.py:236")}
    kernels = []
    for name, (src, replaces) in sources.items():
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces, launches=counts[name],
                            max_abs_err=errs[name], **rows[name]))
        r = rows[name]
        print(f"{name}: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, "
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
