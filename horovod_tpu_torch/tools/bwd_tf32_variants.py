"""The fp32 (3xTF32) dk/dv's design choices, measured.

``csrc/flash_bwd_tf32_sm90.cu`` runs fp32 dk/dv past D ``kWideAbove`` on
a wide build (128-column parts of dK and dV, P^T and dS^T through shared
memory, so that S and dP are paid half as often as in 64-column parts)
and orders its grid head-major (one head's CTAs side by side;
``kHeadMajor``; the wide build takes heads in groups of about one wave
of CTAs, each group's heaviest row tiles first, ``kHeadGroups``). This
tool builds each variant below into
``build/horovod_tpu_torch/bwd_tf32_variants/`` (one nvcc each, all
started together, with ``narrow_variants.build``; ptxas' register and
spill report printed, the package's unchanged source among them, whose
wide build must show no spill and no serialized wgmma):

- ``64cols``: the 64-column build at every head dim (the design before
  the wide build);
- ``wide_from_64``: the wide build past D 64 (the main shape's D 128
  on it);
- ``bh_fastest``: the package's builds with the b h index fastest on the
  grid;
- ``head_by_head``: the wide build's head-major grid one head after
  another, not in groups of heads of about one wave (``kHeadGroups``);
- ``split_by_output``: the design not taken past D 128
  (``kSplitByOutput``): 64 keys and 256 columns a CTA, one consumer
  summing S^T and making dV, the other summing dP^T and making dK, P
  handed over in shared memory.

On the same inputs and the same pre-pass it holds every variant's dk and
dv to the plain TF32X3 versions with the bound chip_smoke.py holds the
package's build to, requires each to equal the package's bit for bit
(every build sums each output column in the same order: the same region
accumulators, the same k steps of each product, the same tile order),
and times the package's build and the variant in turns (package,
variant, variant, package; CUDA-event means of 20 launches behind the
spin, ``chip_smoke.time_ms``, the pre-pass not included; the pre-pass
alone and SDPA's backward alone on the same inputs printed beside them).
Shapes: fp32 at the main shape (B=4, S=2048, H=16, D=128, causal), at
its B, S and H with D 256 (64 heads: the wide build where L2 holds the
fewest heads) and at chip_smoke.py's C4 shape (B=2, S=1024, H=8, causal)
at D 160, 256, 320, 384, 512 and 640. Run from the root of a checkout,
on the card:

    python3 horovod_tpu_torch/tools/bwd_tf32_variants.py
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = "flash_bwd_tf32_sm90.cu"
NO_WIDE = ("constexpr int kWideAbove = 128;",
           "constexpr int kWideAbove = 1 << 30;")
WIDE_FROM_64 = ("constexpr int kWideAbove = 128;",
                "constexpr int kWideAbove = 64;")
SPLIT = ("constexpr bool kSplitByOutput = false;",
         "constexpr bool kSplitByOutput = true;")
# variant -> (source, [(text of the package's source, text of the
# variant)]); "package" is the package's own source built again: its
# ptxas report, and the spread of two builds of one source timed in turns
VARIANTS = {
    "package": (SOURCE, []),
    "64cols": (SOURCE, [NO_WIDE]),
    "wide_from_64": (SOURCE, [WIDE_FROM_64]),
    "bh_fastest": (SOURCE, [("constexpr bool kHeadMajor = true;",
                             "constexpr bool kHeadMajor = false;")]),
    "split_by_output": (SOURCE, [SPLIT]),
    "head_by_head": (SOURCE, [("constexpr bool kHeadGroups = true;",
                               "constexpr bool kHeadGroups = false;")]),
}
ENTRIES = {SOURCE: "hvdt_flash_dkv_tf32"}
C4_DIMS = (160, 256, 320, 384, 512, 640)
SEED = 18


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bwd_tf32_variants: no CUDA device; this script runs on the "
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
    variants = narrow_variants.build(_cuda, VARIANTS, ENTRIES,
                                     "bwd_tf32_variants", "tf32", logs)
    bad = fwd_sm90_variants.package_report(logs["package"],
                                           "flash_dkv_tf32_wide")
    if bad:
        raise AssertionError("the package's wide dk/dv spills or "
                             "serializes its wgmmas:\n" + "\n".join(bad))
    card = chip_smoke.card_line()
    shapes = [("main", dict(chip_smoke.MAIN)),
              ("main_d256", dict(chip_smoke.MAIN, d=256))]
    shapes += [(f"c4_d{d}", dict(chip_smoke.C4_SHAPE, d=d))
               for d in C4_DIMS]
    for label, sh in shapes:
        b, s, h, d = (sh[x] for x in "bshd")
        g = torch.Generator(device="cuda").manual_seed(SEED)
        q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda")
                       for _ in range(4))
        o, m, l = fa._flash_fwd(q, k, v, True, 0, 0)
        lse = fa._lse_from_stats(m, l)
        delta = (do * o).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta, True, 0, 0)
        want = fa._flash_dkv_plain(*args, operands=fa.TF32X3)
        split = fa._tf32_bwd_split(q, k, v, do)
        sizes = (b, h, s, s, d, 0, 0, 1, fa._softmax_scale(d))

        def run(fn):
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            _cuda.check(fn(split.data_ptr(), lse.data_ptr(),
                           delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                           *sizes, torch.cuda.current_stream().cuda_stream),
                        "variant dk/dv")
            return dk, dv

        def mine():
            return fa._flash_dkv_tf32(*args, split=split)
        ours = mine()
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous().requires_grad_()
                           for x in (q, k, v, do))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        sdpa = chip_smoke.time_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), 20)
        pre = chip_smoke.time_ms(lambda: fa._tf32_bwd_split(q, k, v, do), 20)
        print(f"{label} B{b} S{s} H{h} D{d} fp32 dk/dv: package build "
              f"{fa.tf32_dkv_part(d)}-column parts; pre-pass {pre:.4f} ms; "
              f"SDPA backward alone {sdpa:.4f} ms  [{card}]", flush=True)
        for name, (fn, _) in variants.items():
            theirs = run(fn)
            torch.cuda.synchronize()
            ratio = max(tolerance.worst(x, p, 1e-4)[1]
                        for x, p in zip(theirs, want))
            same = all(torch.equal(a, c) for a, c in zip(ours, theirs))
            if not same or not ratio <= 1.0:
                raise AssertionError(
                    f"{label}: {name} differs from the package's build "
                    f"(worst err/tol {ratio:.3f}, bit-equal {same})")
            t = [chip_smoke.time_ms(f, 20) for f in (
                mine, lambda: run(fn), lambda: run(fn), mine)]
            pkg, var = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            print(f"  {name:<10}: package {t[0]:.4f} / {t[3]:.4f} ms "
                  f"({(pkg + pre) / sdpa:.2f}x SDPA with the pre-pass), "
                  f"variant {t[1]:.4f} / {t[2]:.4f} ms "
                  f"({(var + pre) / sdpa:.2f}x), package {var / pkg:.3f}x "
                  f"faster (worst err/tol {ratio:.3f}, bit-equal)",
                  flush=True)
        del q, k, v, do, o, split, want, ours, qt, kt, vt, dot, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
