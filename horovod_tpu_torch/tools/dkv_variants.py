"""The stream dk/dv's design choices, measured (bf16 and fp16 dk/dv past
head dim 256).

``csrc/flash_dkv_stream_sm90.cu`` fixes its part width (``kOut``, 256
columns of dk and dv a CTA, 128 a consumer warpgroup) and whether each
128-byte region's S^T and dP^T go to an accumulator of their own
(``kSplitChains``). This tool builds each variant below into
``build/horovod_tpu_torch/dkv_variants/`` (one nvcc each, all started
together, with ``narrow_variants.build``; ptxas' register and spill
report printed, the package's unchanged source among them), holds every
variant's dk and dv to the plain versions with the bound chip_smoke.py
holds the package's build to (reporting the ratio even where it fails),
says whether they equal the package's bit for bit, and times the package's build and the variant in turns (package,
variant, variant, package; CUDA-event means of 20 launches,
``chip_smoke.time_ms``) at chip_smoke.py's C4 shape (B=2, S=1024, H=8,
causal). Run from the root of a checkout, on the card:

    python3 horovod_tpu_torch/tools/dkv_variants.py
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STREAM = "flash_dkv_stream_sm90.cu"
# variant -> (source, [(text of the package's source, text of the
# variant)]); "package" is the package's own source built again: its
# ptxas report, and the spread of two builds of one source timed in turns
VARIANTS = {
    "package": (STREAM, []),
    "stream_128cols": (STREAM, [("kOut = 256;", "kOut = 128;")]),
    "stream_one_chain": (STREAM, [("kSplitChains = true;",
                                   "kSplitChains = false;")]),
}
ENTRIES = {STREAM: "hvdt_flash_dkv_stream"}
CASES = (("bfloat16", 320), ("bfloat16", 640), ("float16", 640))
SEED = 21


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("dkv_variants: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from horovod_tpu_torch import _cuda
    from horovod_tpu_torch.parallel import flash_attention as fa
    from horovod_tpu_torch.utils import tolerance
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import narrow_variants

    _cuda.load()
    variants = narrow_variants.build(_cuda, VARIANTS, ENTRIES,
                                     "dkv_variants", "flash_dkv")
    card = chip_smoke.card_line()
    b, s, h = (chip_smoke.C4_SHAPE[x] for x in "bsh")
    for dt_name, d in CASES:
        dt = getattr(torch, dt_name)
        g = torch.Generator(device="cuda").manual_seed(SEED)
        q, k, v, do = (torch.randn(b, s, h, d, generator=g,
                                   device="cuda").to(dt) for _ in range(4))
        o_p, m_p, l_p = fa._flash_fwd_plain(q, k, v, True, 0, 0)
        lse = fa._lse_from_stats(m_p, l_p)
        delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        args = (q, k, v, do, lse, delta, True, 0, 0)
        plain = fa._flash_dkv_plain(*args)
        plain_b = fa._flash_dkv_plain(*args, operands=dt)
        design = fa._design(dt, d, "dkv")

        def mine():
            return fa._launch("dkv", design, args[:4], *args[4:])

        def run(fn):
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            _cuda.check(fn(
                fa._DTYPES[dt], *(x.data_ptr() for x in args[:6]),
                dk.data_ptr(), dv.data_ptr(), b, h, s, s, d, 0, 0, 1,
                fa._softmax_scale(d),
                torch.cuda.current_stream().cuda_stream), "variant dk/dv")
            return dk, dv

        def ratio(out):
            return max(tolerance.worst(x, p, 1e-4,
                                       step=tolerance.step_of(dt),
                                       plain_b=pb)[1]
                       for x, p, pb in zip(out, plain, plain_b))
        ours = mine()
        for name, (fn, _) in variants.items():
            theirs = run(fn)
            torch.cuda.synchronize()
            same = all(torch.equal(a, c) for a, c in zip(ours, theirs))
            t = [chip_smoke.time_ms(f, 20) for f in (
                mine, lambda: run(fn), lambda: run(fn), mine)]
            print(f"{dt_name} D{d} {name:<17}: package {t[0]:.4f} / "
                  f"{t[3]:.4f} ms, variant {t[1]:.4f} / {t[2]:.4f} ms "
                  f"(err/tol package {ratio(ours):.3f}, variant "
                  f"{ratio(theirs):.3f}; "
                  f"{'bit-equal' if same else 'other sums'})  [{card}]",
                  flush=True)
        del q, k, v, do, ours, plain, plain_b
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
