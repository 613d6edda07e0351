"""The narrow tf32 forward (fp32 at head dims 16 and 32): the choices of
its design, measured.

``csrc/flash_fwd_tf32_narrow_sm90.cu`` fixes the design in four
constants: the consumer warpgroups that share a q tile's kv tiles
(``kNarrowSplit``), the keys of a kv stage (``kNarrowKv``), the depth of
each warpgroup's ring (``kNarrowStages``) and the CTAs per SM that
``__launch_bounds__`` asks for (``kNarrowCtasPerSm``). This tool builds
each variant below into ``build/horovod_tpu_torch/narrow_tf32_variants/``
(one nvcc each, all started together, with ``narrow_variants.build``;
ptxas' register and spill report printed; a variant whose tiles exceed
shared memory fails its static_assert and is reported as not built),
asserts that the package's build spills nothing and serializes no wgmma,
holds every variant's o, m and l to the plain fp32 forward with the bound
chip_smoke.py holds the package's build to (the ratio printed even where
it fails), says whether they equal the package's bit for bit (the stage
count keeps the package's sums; the warpgroups and the stage's keys move
their order) and times the package's build and the variant in turns
(package, variant, variant, package; CUDA-event means of 20 launches
behind the spin, ``chip_smoke.time_ms``, the pre-pass included), with the
pre-pass alone, the simt kernel it replaces and SDPA's fp32 forward on the
same inputs beside them. Shapes: fp32 at chip_smoke.py's C4 shape (B=2,
S=1024, H=8, causal), D 16 and 32, and at the entry's shape (B 2, S 32,
H 4, D 16). Run from the root of a checkout, on the card:

    python3 horovod_tpu_torch/tools/narrow_tf32_variants.py
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = "flash_fwd_tf32_narrow_sm90.cu"
ENTRIES = {SOURCE: "hvdt_flash_fwd_tf32_narrow"}
SUBDIR = "narrow_tf32_variants"
SPLIT1 = ("kNarrowSplit = 4;", "kNarrowSplit = 1;")
SPLIT2 = ("kNarrowSplit = 4;", "kNarrowSplit = 2;")
SPLIT3 = ("kNarrowSplit = 4;", "kNarrowSplit = 3;")
KV64 = ("kNarrowKv = 32;", "kNarrowKv = 64;")
STAGES1 = ("kNarrowStages = 3;", "kNarrowStages = 1;")
STAGES2 = ("kNarrowStages = 3;", "kNarrowStages = 2;")
STAGES4 = ("kNarrowStages = 3;", "kNarrowStages = 4;")
CTAS2 = ("kNarrowCtasPerSm = 1;", "kNarrowCtasPerSm = 2;")
# variant -> [(text of the package's source, text of the variant)];
# "package" is the package's own source built again: its ptxas report, and
# the spread of two builds of one source timed in turns
VARIANTS = {
    "package": [],
    "split1": [SPLIT1],
    "split2": [SPLIT2],
    "split3": [SPLIT3],
    "split2_kv64": [SPLIT2, KV64],
    "split3_kv64": [SPLIT3, KV64, STAGES2],
    "kv64_1stage": [KV64, STAGES1],
    "split2_2cta": [SPLIT2, CTAS2],
    "stages2": [STAGES2],
    "stages4": [STAGES4],
    "split3_stages4": [SPLIT3, STAGES4],
}
# Variants whose sums run in the package's order: bit-equal or wrong.
SAME_SUMS = ("package", "stages2", "stages4")
# (label, B, S, H, D), fp32, causal
SHAPES = (("c4_fp32_d16", 2, 1024, 8, 16),
          ("c4_fp32_d32", 2, 1024, 8, 32),
          ("entry_fp32", 2, 32, 4, 16))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("narrow_tf32_variants: no CUDA device; this script runs on "
              "the card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    import torch.nn.functional as F
    from horovod_tpu_torch import _cuda
    from horovod_tpu_torch.parallel import flash_attention as fa
    from horovod_tpu_torch.tools.fwd_sm90_variants import package_report
    from horovod_tpu_torch.tools.narrow_variants import build
    from horovod_tpu_torch.utils import tolerance

    _cuda.load()
    logs = {}
    variants = build(_cuda, {name: (SOURCE, edits)
                             for name, edits in VARIANTS.items()},
                     ENTRIES, SUBDIR, "flash_fwd_tf32_narrow", logs=logs,
                     required=False)
    bad = package_report(logs["package"], "flash_fwd_tf32_narrow")
    if bad:
        raise AssertionError("the package's narrow tf32 forward spills or "
                             "serializes its wgmmas:\n" + "\n".join(bad))
    card = chip_smoke.card_line()
    for label, b, s, h, d in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(12)
        q, k, v = (torch.randn(b, s, h, d, generator=g, device="cuda")
                   for _ in range(3))
        plain = fa._flash_fwd_plain(q, k, v, True, 0, 0)
        bounds = ((2e-5, 1e-6, True), (2e-5, 1e-5, False),
                  (2e-5, 1e-6, False))
        sizes = (b, h, s, s, d, 0, 0, 1, fa._softmax_scale(d))

        def run(fn):
            o, m, l = fa._fwd_outputs(q)
            scratch = fa._tf32_fwd_scratch(q, k)
            _cuda.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(), m.data_ptr(), l.data_ptr(),
                           scratch.data_ptr(), *sizes,
                           torch.cuda.current_stream().cuda_stream),
                        "variant forward")
            return o, m, l

        def mine():
            return fa._flash_fwd_tf32(q, k, v, True, 0, 0)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = chip_smoke.time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 20)
        pre = chip_smoke.time_ms(lambda: fa._tf32_fwd_split(q, k, v), 20)
        simt = chip_smoke.time_ms(
            lambda: fa._flash_fwd_simt(q, k, v, True, 0, 0), 20)
        print(f"{label} B{b} S{s} H{h} D{d} fp32: SDPA forward {sdpa:.4f} "
              f"ms, simt {simt:.4f} ms, pre-pass alone {pre:.4f} ms  "
              f"[{card}]", flush=True)
        ours = tuple(x.clone() for x in mine())
        for name, (fn, _) in variants.items():
            theirs = tuple(x.clone() for x in run(fn))
            torch.cuda.synchronize()
            ratio = max(tolerance.worst(x, p, rtol, atol=atol, rows=rows)[1]
                        for x, p, (rtol, atol, rows) in zip(theirs, plain,
                                                            bounds))
            same = all(torch.equal(a, c) for a, c in zip(ours, theirs))
            if name in SAME_SUMS and not same:
                raise AssertionError(f"{label}: {name} sums in the "
                                     f"package's order but differs from it")
            if not ratio <= 1.0:
                print(f"  {name:<15}: {ratio:.3f} of the bound, not timed",
                      flush=True)
                continue
            t = [chip_smoke.time_ms(f, 20) for f in (
                mine, lambda: run(fn), lambda: run(fn), mine)]
            pkg, var = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            print(f"  {name:<15}: package {t[0]:.4f} / {t[3]:.4f} ms, "
                  f"variant {t[1]:.4f} / {t[2]:.4f} ms ({var / pkg:.3f}x "
                  f"the package; {pkg / sdpa:.2f}x / {var / sdpa:.2f}x "
                  f"SDPA; worst err/tol {ratio:.3f}, "
                  f"{'bit-equal' if same else 'other sums'})", flush=True)
        del q, k, v, qt, kt, vt, plain, ours
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
