"""The fp32 (3xTF32) forward's design choices, measured.

``csrc/flash_fwd_stream_sm90.cu`` runs fp32 head dims past 128 on a wide
build (256-column parts of O, P through shared memory; ``kWideAbove``)
whose P V products make 64 columns each, through a ring of two V^T
stages (``kPvCols``), orders the tf32 grid head-major (one head's CTAs
side by side; ``kHeadMajor``) and sums the wide build's S with one region
accumulator (``kPingPong``). This tool builds each variant below into
``build/horovod_tpu_torch/fwd_tf32_variants/`` (one nvcc each, all started
together, with ``narrow_variants.build``; ptxas' register and spill
report printed, the package's unchanged source among them):

- ``128cols_bh_fastest``: the 128-column build at every head dim with the
  b h index fastest on the grid (the design before the wide build);
- ``128cols``: the 128-column build at every head dim, head-major (the
  grid order alone);
- ``bh_fastest``: the package's builds with b h fastest;
- ``ping_pong``: the wide build's S loop with two region accumulators
  taken in turn, one region's products in flight while the last is
  summed;
- ``pv_128cols``: the wide build's P V in 128-column products through one
  V^T stage (the second waits for the first's products).

On the same inputs it holds every variant's o, m and l to the plain fp32
forward with the bound chip_smoke.py holds the package's build to
(reporting the ratio even where it fails), requires the variants whose
sums run in the package's order (the grid order and the ping-pong: each
CTA computes the same values) to equal the package's bit for bit and
says whether the others do, and times the package's build and the
variant in turns (package, variant, variant, package; CUDA-event means of
20 launches behind the spin, ``chip_smoke.time_ms``, the pre-pass
included; the pre-pass alone and SDPA's fp32 forward on the same inputs
printed beside them). Shapes: fp32 at chip_smoke.py's C4 shape (B=2,
S=1024, H=8, causal) at D 256, 320, 384, 512 and 640, and at the main
shape (B=4, S=2048, H=16, D=128, causal). Run from the root of a
checkout, on the card:

    python3 horovod_tpu_torch/tools/fwd_tf32_variants.py
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = "flash_fwd_stream_sm90.cu"
NO_WIDE = ("constexpr int kWideAbove = 128;",
           "constexpr int kWideAbove = 1 << 30;")
BH_FASTEST = ("constexpr bool kHeadMajor = true;",
              "constexpr bool kHeadMajor = false;")
# variant -> (source, [(text of the package's source, text of the
# variant)]); "package" is the package's own source built again: its
# ptxas report, and the spread of two builds of one source timed in turns
VARIANTS = {
    "package": (SOURCE, []),
    "128cols_bh_fastest": (SOURCE, [NO_WIDE, BH_FASTEST]),
    "128cols": (SOURCE, [NO_WIDE]),
    "bh_fastest": (SOURCE, [BH_FASTEST]),
    "ping_pong": (SOURCE, [("constexpr bool kPingPong = false;",
                            "constexpr bool kPingPong = true;")]),
    "pv_128cols": (SOURCE, [("constexpr int kPvCols = 64;",
                             "constexpr int kPvCols = 128;")]),
}
ENTRIES = {SOURCE: "hvdt_flash_fwd_tf32"}
# The variants that must equal the package's build bit for bit.
SAME_SUMS = ("package", "bh_fastest", "ping_pong")
C4_DIMS = (256, 320, 384, 512, 640)
SEED = 15


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fwd_tf32_variants: no CUDA device; this script runs on the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    import torch.nn.functional as F
    from horovod_tpu_torch import _cuda
    from horovod_tpu_torch.parallel import flash_attention as fa
    from horovod_tpu_torch.utils import tolerance
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import narrow_variants

    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.load()
    variants = narrow_variants.build(_cuda, VARIANTS, ENTRIES,
                                     "fwd_tf32_variants", "flash_fwd")
    card = chip_smoke.card_line()
    shapes = [(f"c4_d{d}", dict(chip_smoke.C4_SHAPE, d=d)) for d in C4_DIMS]
    shapes.append(("main", dict(chip_smoke.MAIN)))
    for label, sh in shapes:
        b, s, h, d = (sh[x] for x in "bshd")
        g = torch.Generator(device="cuda").manual_seed(SEED)
        q, k, v = (torch.randn(b, s, h, d, generator=g, device="cuda")
                   for _ in range(3))
        plain = fa._flash_fwd_plain(q, k, v, True, 0, 0)
        scratch = fa._tf32_fwd_scratch(q, k)
        outs = fa._fwd_outputs(q)
        stream = torch.cuda.current_stream().cuda_stream

        def run(fn):
            _cuda.check(fn(*(t.data_ptr() for t in (q, k, v, *outs)),
                           scratch.data_ptr(), b, h, s, s, d, 0, 0, 1,
                           fa._softmax_scale(d), stream), "variant forward")
            return outs

        def mine():
            return fa._flash_fwd(q, k, v, True, 0, 0)
        ours = mine()
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = chip_smoke.time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 20)
        pre = chip_smoke.time_ms(lambda: fa._tf32_fwd_split(q, k, v), 20)
        print(f"{label} B{b} S{s} H{h} D{d} fp32: package build "
              f"{fa.tf32_fwd_part(d)}-column parts; pre-pass {pre:.4f} ms; "
              f"SDPA {sdpa:.4f} ms  [{card}]", flush=True)
        for name, (fn, _) in variants.items():
            theirs = tuple(x.clone() for x in run(fn))
            torch.cuda.synchronize()
            ratio = max(
                tolerance.worst(theirs[0], plain[0], 2e-5)[1],
                tolerance.worst(theirs[1], plain[1], 2e-5, atol=1e-5,
                                rows=False)[1],
                tolerance.worst(theirs[2], plain[2], 2e-5, rows=False)[1])
            same = all(torch.equal(a, c) for a, c in zip(ours, theirs))
            if name in SAME_SUMS and not same:
                raise AssertionError(f"{label}: {name} differs from the "
                                     f"package's build")
            if not ratio <= 1.0:
                print(f"  {name:<19}: {ratio:.3f} of the bound, not timed",
                      flush=True)
                continue
            t = [chip_smoke.time_ms(f, 20) for f in (
                mine, lambda: run(fn), lambda: run(fn), mine)]
            pkg, var = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            print(f"  {name:<19}: package {t[0]:.4f} / {t[3]:.4f} ms "
                  f"({pkg / sdpa:.2f}x SDPA), variant {t[1]:.4f} / "
                  f"{t[2]:.4f} ms ({var / sdpa:.2f}x SDPA), package "
                  f"{var / pkg:.3f}x faster (worst err/tol {ratio:.3f}, "
                  f"{'bit-equal' if same else 'other sums'})", flush=True)
        del q, k, v, plain, scratch, outs, ours, qt, kt, vt
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
