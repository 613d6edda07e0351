"""The fp32 (3xTF32) dq's and dk/dv's design choices, measured.

``csrc/flash_bwd_tf32_sm90.cu`` runs fp32 dq past D ``kWideDqAbove`` on a
wide build (256-column parts of dQ, dS through shared memory) and dk/dv
past D ``kWideAbove`` on one of its own (128-column parts of dK and dV,
P^T and dS^T through shared memory), so that S and dP are paid half as
often as in the 128-column dq's and 64-column dk/dv's parts, and orders
its grids head-major (one head's CTAs side by side; ``kHeadMajor``; the
wide builds take heads in groups of about one wave of CTAs, each group's
heaviest row tiles first: ``kHeadGroups`` for dk/dv, ``kDqHeadGroups``
for dq). This tool builds each variant below into
``build/horovod_tpu_torch/bwd_tf32_variants/`` (one nvcc each, all
started together, with ``narrow_variants.build``; ptxas' register and
spill report printed, the package's unchanged source among them, whose
wide builds must show no spill and no serialized wgmma):

- ``64cols``: the 64-column dk/dv at every head dim (the dk/dv design
  before its wide build);
- ``wide_from_64``: the wide dk/dv past D 64 (the main shape's D 128
  on it);
- ``bh_fastest``: the package's builds with the b h index fastest on the
  grid (dq and dk/dv);
- ``head_by_head``: the wide dk/dv's head-major grid one head after
  another, not in groups of heads of about one wave (``kHeadGroups``);
- ``split_by_output``: the dk/dv design not taken past D 128
  (``kSplitByOutput``): 64 keys and 256 columns a CTA, one consumer
  summing S^T and making dV, the other summing dP^T and making dK, P
  handed over in shared memory;
- ``dq_128cols``: the 128-column dq at every head dim (the dq design
  before its wide build);
- ``dq_wide_from_256``: the wide dq past D 256 only (C4 D 256 and the
  main shape's D 256 on the 128-column build);
- ``dq_wide_from_64``: the wide dq past D 64 (the main shape's D 128 on
  it: one 128-column part, the same products, dS through shared
  memory);
- ``dq_head_by_head``: the wide dq's grid one head after another
  (``kDqHeadGroups``).

A name's prefix says which kernel a variant changes (``dq_``; the others
dk/dv, and ``bh_fastest`` both). With ``--parent DIR``, a checkout of an
earlier commit, the tool also builds that checkout's source as ``parent``
(its own headers beside it) and holds and times it as the others, both
kernels: its dq and dk/dv must be the package's bit for bit. On the same
inputs and the same pre-pass it holds every variant's dq and dk/dv to
the plain TF32X3 versions with
the bounds chip_smoke.py holds the package's builds to (dq at
``DQ_ATOL``), requires each to equal the package's bit for bit (every
build sums each output column in the same order: the same region
accumulators, the same k steps of each product, the same tile order),
and times the package's kernel and the variant's in turns (package,
variant, variant, package; CUDA-event means of 20 launches behind the
spin, ``chip_smoke.time_ms``, the pre-pass not included; the route
``fa._flash_bwd``, the pre-pass alone and SDPA's backward alone on the
same inputs printed beside them). Shapes: fp32 at the main shape (B=4,
S=2048, H=16, D=128, causal), at its B, S and H with D 256 (64 heads:
the wide builds where L2 holds the fewest heads) and at chip_smoke.py's
C4 shape (B=2, S=1024, H=8, causal) at D 160, 256, 320, 384, 512 and 640.
Run from the root of a checkout, on the card:

    python3 horovod_tpu_torch/tools/bwd_tf32_variants.py [--parent DIR]
"""

from __future__ import annotations

import ctypes
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
NO_WIDE_DQ = ("constexpr int kWideDqAbove = 128;",
              "constexpr int kWideDqAbove = 1 << 30;")
DQ_WIDE_FROM_256 = ("constexpr int kWideDqAbove = 128;",
                    "constexpr int kWideDqAbove = 256;")
DQ_WIDE_FROM_64 = ("constexpr int kWideDqAbove = 128;",
                   "constexpr int kWideDqAbove = 64;")
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
    "dq_128cols": (SOURCE, [NO_WIDE_DQ]),
    "dq_wide_from_256": (SOURCE, [DQ_WIDE_FROM_256]),
    "dq_wide_from_64": (SOURCE, [DQ_WIDE_FROM_64]),
    "dq_head_by_head": (SOURCE, [("constexpr bool kDqHeadGroups = true;",
                                  "constexpr bool kDqHeadGroups = false;")]),
}
ENTRIES = {SOURCE: "hvdt_flash_dkv_tf32"}
DQ_ENTRY = "hvdt_flash_dq_tf32"  # from each variant's library
C4_DIMS = (160, 256, 320, 384, 512, 640)
SEED = 18


def kernels_of(name):
    """The kernels (dq, dkv) whose time a variant may change."""
    if name.startswith("dq_"):
        return ("dq",)
    both = ("package", "bh_fastest", "parent")
    return ("dq", "dkv") if name in both else ("dkv",)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
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
                                     "bwd_tf32_variants", "tf32_wide", logs)
    subdirs = dict.fromkeys(variants, "bwd_tf32_variants")
    if "--parent" in argv:
        parent = os.path.join(argv[argv.index("--parent") + 1],
                              "horovod_tpu_torch", "csrc")
        variants.update(narrow_variants.build(
            _cuda, {"parent": (SOURCE, [])}, ENTRIES, "bwd_tf32_parent",
            "tf32_wide", csrc=parent))
        subdirs["parent"] = "bwd_tf32_parent"
    bad = [line for kernel in ("flash_dkv_tf32_wide", "flash_dq_tf32_wide")
           for line in fwd_sm90_variants.package_report(logs["package"],
                                                        kernel)]
    if bad:
        raise AssertionError("the package's wide dq or dk/dv spills or "
                             "serializes its wgmmas:\n" + "\n".join(bad))
    fns = {}
    for name, (dkv_fn, _) in variants.items():
        lib = ctypes.CDLL(os.path.join(_cuda.BUILD_DIR, subdirs[name], name,
                                       "lib.so"))
        dq_fn = getattr(lib, DQ_ENTRY)
        dq_fn.argtypes = _cuda._SIGNATURES[DQ_ENTRY]
        dq_fn.restype = ctypes.c_int
        fns[name] = {"dq": dq_fn, "dkv": dkv_fn}
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
        want = (fa._flash_dq_plain(*args, operands=fa.TF32X3),
                *fa._flash_dkv_plain(*args, operands=fa.TF32X3))
        split = fa._tf32_bwd_split(q, k, v, do)
        sizes = (b, h, s, s, d, 0, 0, 1, fa._softmax_scale(d))

        def run(fn, kern):
            outs = ([torch.empty_like(q)] if kern == "dq"
                    else [torch.empty_like(k), torch.empty_like(v)])
            _cuda.check(fn(split.data_ptr(), lse.data_ptr(),
                           delta.data_ptr(), *(x.data_ptr() for x in outs),
                           *sizes, torch.cuda.current_stream().cuda_stream),
                        f"variant {kern}")
            return outs

        mine = {"dq": lambda: [fa._flash_dq_tf32(*args, split=split)],
                "dkv": lambda: fa._flash_dkv_tf32(*args, split=split)}
        ours = mine["dq"]() + list(mine["dkv"]())
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous().requires_grad_()
                           for x in (q, k, v, do))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        sdpa = chip_smoke.time_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), 20)
        pre = chip_smoke.time_ms(lambda: fa._tf32_bwd_split(q, k, v, do), 20)
        route = chip_smoke.time_ms(lambda: fa._flash_bwd(*args), 20)
        print(f"{label} B{b} S{s} H{h} D{d} fp32: package dq "
              f"{fa.tf32_dq_part(d)}-column parts, dk/dv "
              f"{fa.tf32_dkv_part(d)}; route {route:.4f} ms "
              f"({route / sdpa:.2f}x SDPA's backward alone {sdpa:.4f}), "
              f"pre-pass alone {pre:.4f}  [{card}]", flush=True)
        for name, kfns in fns.items():
            theirs = run(kfns["dq"], "dq") + run(kfns["dkv"], "dkv")
            torch.cuda.synchronize()
            ratio = max(
                tolerance.worst(theirs[0], want[0], 1e-4,
                                atol=tolerance.DQ_ATOL)[1],
                *(tolerance.worst(x, p, 1e-4)[1]
                  for x, p in zip(theirs[1:], want[1:])))
            same = all(torch.equal(a, c) for a, c in zip(ours, theirs))
            if not same or not ratio <= 1.0:
                raise AssertionError(
                    f"{label}: {name} differs from the package's build "
                    f"(worst err/tol {ratio:.3f}, bit-equal {same})")
            line = f"  {name:<16}:"
            for kern in kernels_of(name):
                def var(kern=kern):
                    return run(kfns[kern], kern)
                t = [chip_smoke.time_ms(f, 20) for f in (
                    mine[kern], var, var, mine[kern])]
                pkg, va = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
                line += (f" {kern} package {t[0]:.4f} / {t[3]:.4f} ms, "
                         f"variant {t[1]:.4f} / {t[2]:.4f} ms, package "
                         f"{va / pkg:.3f}x faster;")
            print(f"{line} worst err/tol {ratio:.3f}, bit-equal",
                  flush=True)
        del q, k, v, do, o, split, want, ours, qt, kt, vt, dot, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
