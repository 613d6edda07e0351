"""The fused 16-bit backward's design choices, measured.

``csrc/flash_bwd_sm90.cu`` computes dq, dk and dv of the bf16 and fp16
backward at head dims 33-128 in one launch (``flash_bwd_sm90``) and adds
each kv tile's part of dq into an fp32 accumulator in a fixed kv-tile
order (one TMA bulk copy or bulk reduce a part, two writer warps, so two
adds in flight), so that dq's bits are the same on every run. This tool builds each
variant below into ``build/horovod_tpu_torch/bwd_sm90_variants/`` (one
nvcc each, all started together, with ``narrow_variants.build``; ptxas'
register and spill report printed, the package's unchanged source among
them, whose fused kernel must show no spill and no serialized wgmma):

- ``join_sdp``: S^T and dP^T in one commit group and dV's product after
  both (``kJoinSdP``), in place of flash_dkv_sm90's order (S^T alone,
  then dV's product with dP^T's); dk and dv keep their bits either way;
- ``ascending``, ``descending``: the adds, and the handout of the tiles,
  in ascending or descending kv-tile order at every shape (``kOrder``; the
  package takes descending where the tiles make one wave of CTAs,
  ascending where they come in waves);
- ``free_order``: the parts added as they arrive (``kFreeOrder``: bulk
  reduce into an accumulator the C entry zeroes, the last to arrive reads
  the sum back and converts), with no turn to wait for: the cost of the
  fixed order. Its dq's bits may differ from run to run; it is held to the
  bound alone;
- ``red``, ``stores``: the middle parts added by RED (atomicAdd of
  float4, fire and forget) or by plain loads and stores, in place of
  the bulk reduce (``kAddMode``);
- ``convert_in_kernel``: no conversion pass: each q tile's last adder
  adds its part, reads the sum back into its staging buffer and writes dq
  in the input's type (``kConvertPass``; the design not taken: its writers
  spill, and it was 13-20% slower at the C4 shapes);
- ``stages3``: three Q and dO stages in the ring (``kStages``; they fit
  beside the two staging buffers at the D 64 build only, so at D 128 the
  variant is the package);
- ``no_adds``: the writers drop the parts (``kAdds``): a probe of what
  the kernel costs without dq's adds; its dq is wrong and not checked;
- ``regs_40_232``: the producer warpgroup (the TMA producer and the dQ
  writers) at 40 registers a thread and the consumers at 232, in place of
  24 and 240.

On the same inputs, lse and delta (the pre-pass's) it holds every
variant's dq to the plain
version with the bound chip_smoke.py holds the package's to (``DQ_ATOL``,
the 16-bit operands' allowance from ``_flash_bwd_sm90_plain``), requires
its dk and dv to equal the package's bit for bit and, but for
``ascending``, ``descending``, ``free_order`` and ``no_adds``, its dq
too (every other
variant adds the parts in the same order), and times the package's kernel and the
variant's in turns (package, variant, variant, package; CUDA-event means
of 20 launches behind the spin, ``chip_smoke.time_ms``), with the sm90 dq
plus dk/dv on the same inputs, the pre-pass and SDPA's backward alone
beside them. Shapes: bf16 at the main shape (B=4, S=2048, H=16, D=128,
causal), Phi-3-mini's (B=2, S=2048, H=32, D=96) and chip_smoke.py's C4
shape (B=2, S=1024, H=8, causal) at bf16 D 80 and 96 and fp16 D 64 and
128. Run from the root of a checkout, on the card:

    python3 horovod_tpu_torch/tools/bwd_sm90_variants.py
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = "flash_bwd_sm90.cu"
ADD_MODE = "constexpr int kAddMode = 2;"
ORDER = "constexpr int kOrder = 2;"
# variant -> [(text of the package's source, text of the variant)];
# "package" is the package's own source built again: its ptxas report, and
# the spread of two builds of one source timed in turns
VARIANTS = {
    "package": [],
    "join_sdp": [("constexpr bool kJoinSdP = false;",
                  "constexpr bool kJoinSdP = true;")],
    "ascending": [(ORDER, "constexpr int kOrder = 0;")],
    "descending": [(ORDER, "constexpr int kOrder = 1;")],
    "free_order": [("constexpr bool kFreeOrder = false;",
                    "constexpr bool kFreeOrder = true;")],
    "red": [(ADD_MODE, "constexpr int kAddMode = 1;")],
    "stores": [(ADD_MODE, "constexpr int kAddMode = 0;")],
    "convert_in_kernel": [("constexpr bool kConvertPass = true;",
                           "constexpr bool kConvertPass = false;")],
    "stages3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "no_adds": [("constexpr bool kAdds = true;",
                 "constexpr bool kAdds = false;")],
    "regs_40_232": [("regs_dec<24>();", "regs_dec<40>();"),
                    ("regs_inc<240>();", "regs_inc<232>();")],
}
# Variants whose dq may differ from the package's bits (another order of
# the adds; for no_adds, no adds at all).
OTHER_BITS = ("ascending", "descending", "free_order", "no_adds")
UNCHECKED = ("no_adds",)
ENTRIES = {SOURCE: "hvdt_flash_bwd_sm90"}
SEED = 23


def shapes(chip_smoke):
    """(label, dtype name, B, S, H, D) of the shapes the tool times."""
    main = chip_smoke.MAIN
    phi3 = chip_smoke.PHI3
    c4 = chip_smoke.C4_SHAPE
    return ([("main", "bfloat16", main["b"], main["s"], main["h"], main["d"]),
             ("phi3", "bfloat16", phi3["b"], phi3["s"], phi3["h"], phi3["d"])]
            + [(f"c4_{dt[:1]}{dt[-2:]}_d{d}", dt, c4["b"], c4["s"], c4["h"], d)
               for dt, d in (("bfloat16", 80), ("bfloat16", 96),
                             ("float16", 64), ("float16", 128))])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bwd_sm90_variants: no CUDA device; this script runs on the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    import torch.nn.functional as F
    from horovod_tpu_torch import _cuda
    from horovod_tpu_torch.parallel import flash_attention as fa
    from horovod_tpu_torch.utils import tolerance
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import fwd_sm90_variants
    import narrow_variants

    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.load()
    logs = {}
    variants = narrow_variants.build(
        _cuda, {name: (SOURCE, edits) for name, edits in VARIANTS.items()},
        ENTRIES, "bwd_sm90_variants", "flash_bwd_sm90", logs,
        required=False)
    bad = fwd_sm90_variants.package_report(logs["package"], "flash_bwd_sm90")
    if bad:
        raise AssertionError("the package's fused backward spills or "
                             "serializes its wgmmas:\n" + "\n".join(bad))
    card = chip_smoke.card_line()
    for label, dt, b, s, h, d in shapes(chip_smoke):
        dtype = getattr(torch, dt)
        g = torch.Generator(device="cuda").manual_seed(SEED)
        q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda")
                       .to(dtype) for _ in range(4))
        o, m, l = fa._flash_fwd(q, k, v, True, 0, 0)
        lse, delta, _ = fa._bwd_prep(o, do, m, l)
        args = (q, k, v, do, lse, delta, True, 0, 0)
        dq_p = fa._flash_dq_plain(*args)
        dq_b = fa._flash_bwd_sm90_plain(*args, operands=dtype)[0]
        step = tolerance.step_of(dtype)
        built = fa.padded_head_dim(d, "sm90", "bwd")
        n = fa._fused_bwd_counters(q)

        def run(fn):
            counters = torch.zeros(n, dtype=torch.int32, device="cuda")
            acc = torch.empty((n - 1) * fa.BLOCK * built, device="cuda")
            outs = [torch.empty_like(x) for x in (q, k, v)]
            _cuda.check(fn(fa._DTYPES[dtype], *(x.data_ptr() for x in (
                q, k, v, do, lse, delta, *outs, acc, counters)),
                b, h, s, s, d, 0, 0, 1, fa._softmax_scale(d),
                torch.cuda.current_stream().cuda_stream), "variant")
            return outs

        def mine():
            return list(fa._flash_bwd_sm90(*args))

        ours = mine()
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous().requires_grad_()
                           for x in (q, k, v, do))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        sdpa = chip_smoke.time_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), 20)
        pair = (chip_smoke.time_ms(lambda: fa._launch(
                    "dq", "sm90", (q, k, v, do), *args[4:]), 20)
                + chip_smoke.time_ms(lambda: fa._launch(
                    "dkv", "sm90", (q, k, v, do), *args[4:]), 20))
        pre = chip_smoke.time_ms(lambda: fa._bwd_prep(o, do, m, l, n), 20)
        route = chip_smoke.time_ms(
            lambda: fa.flash_attention_bwd(q, k, v, o, m, l, do), 20)
        print(f"{label} B{b} S{s} H{h} D{d} {dt}: route {route:.4f} ms "
              f"({route / sdpa:.2f}x SDPA's backward alone {sdpa:.4f}); "
              f"the sm90 dq + dk/dv {pair:.4f}, pre-pass {pre:.4f}  "
              f"[{card}]", flush=True)
        for name, (fn, _) in variants.items():
            theirs = run(fn)
            torch.cuda.synchronize()
            ratio = tolerance.worst(theirs[0], dq_p, 1e-4,
                                    atol=tolerance.DQ_ATOL, step=step,
                                    plain_b=dq_b)[1]
            same_kv = all(torch.equal(a, c)
                          for a, c in zip(ours[1:], theirs[1:]))
            same_dq = torch.equal(ours[0], theirs[0])
            if (not same_kv or name not in OTHER_BITS and not same_dq
                    or name not in UNCHECKED and not ratio <= 1.0):
                raise AssertionError(
                    f"{label}: {name} differs from the package's build "
                    f"(dq err/tol {ratio:.3f}, dk and dv bit-equal "
                    f"{same_kv}, dq bit-equal {same_dq})")
            t = [chip_smoke.time_ms(f, 20) for f in (
                mine, lambda: run(fn), lambda: run(fn), mine)]
            pkg, va = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            print(f"  {name:<17}: package {t[0]:.4f} / {t[3]:.4f} ms, "
                  f"variant {t[1]:.4f} / {t[2]:.4f} ms, package "
                  f"{va / pkg:.3f}x faster; dq err/tol {ratio:.3f}, dq "
                  f"bit-equal {same_dq}", flush=True)
        del q, k, v, do, o, ours, qt, kt, vt, dot, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
