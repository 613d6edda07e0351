"""The 16-bit dq kernels' design choices, measured: the narrow sm90 dq
(head dims 16 and 32) and the stream dq (past 256).

``csrc/flash_dq_sm90.cu`` fixes the narrow dq's ring depth
(``kNarrowStages``, 3) and ``csrc/flash_dq_stream_sm90.cu`` the stream
dq's part width (``kOut``, 256 columns of dq a CTA) and whether each
128-byte region's S and dP go to an accumulator of their own
(``kSplitChains``). This tool builds each variant below into
``build/horovod_tpu_torch/dq_variants/`` (one nvcc each, all started
together, with ``narrow_variants.build``; ptxas' register and spill
report printed), holds every variant's dq to the plain version with the
bound chip_smoke.py holds the package's build to (reporting the ratio
even where it fails), says whether it equals the package's dq bit for
bit, and times the package's build and the variant in turns (package,
variant, variant, package; CUDA-event means of 20 launches,
``chip_smoke.time_ms``) at chip_smoke.py's C4 shape (B=2, S=1024, H=8,
causal). The inputs are those of seed 21 (``chip_smoke.kernel_case``'s
generator), on which the one-chain stream dq at fp16 D 640 misses the
bound. Run from the root of a checkout, on the card:

    python3 horovod_tpu_torch/tools/dq_variants.py
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NARROW, STREAM = "flash_dq_sm90.cu", "flash_dq_stream_sm90.cu"
# variant -> (source, [(text of the package's source, text of the
# variant)]); CASES: the (dtype name, head dim) cases each source serves
VARIANTS = {
    "narrow_2stages": (NARROW, [("kNarrowStages = 3;",
                                 "kNarrowStages = 2;")]),
    "stream_128cols": (STREAM, [("kOut = 256;", "kOut = 128;")]),
    "stream_one_chain": (STREAM, [("kSplitChains = true;",
                                   "kSplitChains = false;")]),
}
ENTRIES = {NARROW: "hvdt_flash_dq_sm90", STREAM: "hvdt_flash_dq_stream"}
CASES = {NARROW: (("bfloat16", 16), ("bfloat16", 32), ("float16", 16)),
         STREAM: (("bfloat16", 320), ("bfloat16", 640), ("float16", 640),
                  ("float16", 768))}
SEED = 21


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("dq_variants: no CUDA device; this script runs on the card",
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
    variants = narrow_variants.build(_cuda, VARIANTS, ENTRIES, "dq_variants",
                                     "flash_dq")
    card = chip_smoke.card_line()
    b, s, h = (chip_smoke.C4_SHAPE[x] for x in "bsh")
    for source, cases in CASES.items():
        for dt_name, d in cases:
            dt = getattr(torch, dt_name)
            g = torch.Generator(device="cuda").manual_seed(SEED)
            q, k, v, do = (torch.randn(b, s, h, d, generator=g,
                                       device="cuda").to(dt)
                           for _ in range(4))
            o_p, m_p, l_p = fa._flash_fwd_plain(q, k, v, True, 0, 0)
            lse = fa._lse_from_stats(m_p, l_p)
            delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2)
            delta = delta.contiguous()
            args = (q, k, v, do, lse, delta, True, 0, 0)
            plain = fa._flash_dq_plain(*args)
            plain_b = fa._flash_dq_plain(*args, operands=dt)
            design = fa._design(dt, d, "dq")

            def mine():
                return fa._launch("dq", design, args[:4], *args[4:])

            def run(fn):
                dq = torch.empty_like(q)
                _cuda.check(fn(
                    fa._DTYPES[dt], *(x.data_ptr() for x in args[:6]),
                    dq.data_ptr(), b, h, s, s, d, 0, 0, 1,
                    fa._softmax_scale(d),
                    torch.cuda.current_stream().cuda_stream), "variant dq")
                return dq

            def ratio(dq):
                return tolerance.worst(dq, plain, 1e-4,
                                       atol=tolerance.DQ_ATOL,
                                       step=tolerance.step_of(dt),
                                       plain_b=plain_b)[1]
            ours = mine()
            for name, (fn, src) in variants.items():
                if src != source:
                    continue
                theirs = run(fn)
                torch.cuda.synchronize()
                same = torch.equal(ours, theirs)
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
