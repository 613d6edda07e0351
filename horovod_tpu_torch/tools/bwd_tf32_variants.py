"""Two choices of the tf32 backward (dq and dk/dv), measured.

``csrc/flash_bwd_tf32_sm90.cu`` orders its grid so that the CTAs of one
(b, h) run side by side (``kHeadMajor``), and streams its operands
through 2 ring stages and 2 stages of the transposed factor. This tool
builds that file twice more into ``build/horovod_tpu_torch/
bwd_tf32_variants/`` (one nvcc each, started together): ``bh_fastest``,
with ``kHeadMajor = false`` (the b h index fastest on the grid), and
``ring3_t1``, with 3 ring stages and 1 T stage (the same shared memory
spent on the ring). On the same inputs and the same pre-pass it checks
that each variant gives the package's dq, dk and dv bit for bit, and
times the package's build and each variant in turns (package, variant,
variant, package; CUDA-event means of 20 launches, the pre-pass not
included) at the fp32 main shape (B=4, S=2048, H=16, D=128) and at fp32
D 256 and 640 (B=2, S=1024, H=8), causal. Run from the root of a
checkout, on the card:

    python3 horovod_tpu_torch/tools/bwd_tf32_variants.py
"""

from __future__ import annotations

import ctypes
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = "flash_bwd_tf32_sm90.cu"
# variant -> (text of the package's source, text of the variant's)
VARIANTS = {
    "bh_fastest": [("constexpr bool kHeadMajor = true;",
                    "constexpr bool kHeadMajor = false;")],
    "ring3_t1": [("constexpr int kStages = 2;", "constexpr int kStages = 3;"),
                 ("constexpr int kStagesT = 2;",
                  "constexpr int kStagesT = 1;")],
}
ENTRIES = ("hvdt_flash_dq_tf32", "hvdt_flash_dkv_tf32")


def build(cuda):
    """{variant: {entry name: its C function}}."""
    with open(os.path.join(cuda.CSRC_DIR, SOURCE)) as fh:
        src = fh.read()
    out = os.path.join(cuda.BUILD_DIR, "bwd_tf32_variants")
    cmds, libs = [], {}
    for name, edits in VARIANTS.items():
        body = src
        for old, new in edits:
            if old not in body:
                raise RuntimeError(f"{SOURCE} declares no {old!r}")
            body = body.replace(old, new)
        d = os.path.join(out, name)
        os.makedirs(d, exist_ok=True)
        for hdr in os.listdir(cuda.CSRC_DIR):
            if hdr.endswith(".cuh"):
                shutil.copy(os.path.join(cuda.CSRC_DIR, hdr), d)
        with open(os.path.join(d, SOURCE), "w") as fh:
            fh.write(body)
        libs[name] = os.path.join(d, "lib.so")
        cmds.append([cuda._nvcc(), *cuda.NVCC_FLAGS, "-shared", "-o",
                     libs[name], os.path.join(d, SOURCE)])
    cuda._run_all(cmds)
    fns = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        fns[name] = {}
        for entry in ENTRIES:
            fn = getattr(lib, entry)
            fn.argtypes = cuda._SIGNATURES[entry]
            fn.restype = ctypes.c_int
            fns[name][entry] = fn
    return fns


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bwd_tf32_variants: no CUDA device; this script runs on the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from horovod_tpu_torch import _cuda
    from horovod_tpu_torch.parallel import flash_attention as fa

    _cuda.load()
    variants = build(_cuda)
    card = chip_smoke.card_line()
    shapes = {"main": dict(chip_smoke.MAIN),
              "d256": dict(chip_smoke.C4_SHAPE, d=256),
              "d640": dict(chip_smoke.C4_SHAPE, d=640)}
    for label, sh in shapes.items():
        b, s, h, d = (sh[x] for x in "bshd")
        g = torch.Generator(device="cuda").manual_seed(6)
        q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda")
                       for _ in range(4))
        o, m, l = fa._flash_fwd(q, k, v, True, 0, 0)
        lse = fa._lse_from_stats(m, l)
        delta = (do * o).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta, True, 0, 0)
        split = fa._tf32_bwd_split(q, k, v, do)
        sizes = (b, h, s, s, d, 0, 0, 1, fa._softmax_scale(d))

        def run(fns, kern):
            stream = torch.cuda.current_stream().cuda_stream
            ptrs = (split.data_ptr(), lse.data_ptr(), delta.data_ptr())
            if kern == "dq":
                dq = torch.empty_like(q)
                _cuda.check(fns["hvdt_flash_dq_tf32"](
                    *ptrs, dq.data_ptr(), *sizes, stream), "variant dq")
                return (dq,)
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            _cuda.check(fns["hvdt_flash_dkv_tf32"](
                *ptrs, dk.data_ptr(), dv.data_ptr(), *sizes, stream),
                "variant dk/dv")
            return dk, dv

        mine = {"dq": lambda: (fa._flash_dq_tf32(*args, split=split),),
                "dkv": lambda: fa._flash_dkv_tf32(*args, split=split)}
        for name, fns in variants.items():
            for kern in ("dq", "dkv"):
                want, got = mine[kern](), run(fns, kern)
                torch.cuda.synchronize()
                if not all(torch.equal(a, c) for a, c in zip(want, got)):
                    raise AssertionError(f"{name} {kern} differs from the "
                                         f"package's build")
                t = [chip_smoke.time_ms(f, 20) for f in (
                    mine[kern], lambda: run(fns, kern),
                    lambda: run(fns, kern), mine[kern])]
                print(f"{label} B{b} S{s} H{h} D{d} {kern:<3}: package "
                      f"{t[0]:.4f} / {t[3]:.4f} ms, {name} {t[1]:.4f} / "
                      f"{t[2]:.4f} ms (bit-equal)  [{card}]", flush=True)
        del q, k, v, do, o, split
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
