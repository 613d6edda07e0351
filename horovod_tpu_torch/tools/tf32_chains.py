"""Accumulator chains of the tf32 (3xTF32) forward, measured.

The tensor cores add each product into their fp32 accumulator without
rounding to nearest, so a long chain of wgmmas on one accumulator drifts.
``csrc/flash_fwd_stream_sm90.cu`` therefore gives each region's S and
each kv tile's P V an accumulator of its own and sums them by fp32 adds
(``kSplitChains``, in both of its tf32 builds). This tool builds that file
a second time with ``kSplitChains = false`` (one chain over all of D for
S and one over all keys for O) into ``build/horovod_tpu_torch/
tf32_chains/``, runs both builds on the same inputs at the fp32 main
shape (B=4, S=2048, H=16, D=128: the 128-column build) and at fp32 D 640
(B=2, S=1024, H=8: the wide build), causal, prints each one's
largest err / bound of o, m and l against the plain fp32 version (the
bound of horovod_tpu_torch/utils/tolerance.py that chip_smoke.py holds the
kernel to: rtol 2e-5, atol 1e-6, m's atol 1e-5) and times them in turns
(split, one, one, split; CUDA-event means of 20 launches, the pre-pass
included). Run from the root of a checkout, on the card:

    python3 horovod_tpu_torch/tools/tf32_chains.py
"""

from __future__ import annotations

import ctypes
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = "flash_fwd_stream_sm90.cu"
# The one-chain build's edit: (text of the package's source, its text).
EDIT = ("constexpr bool kSplitChains = true;",
        "constexpr bool kSplitChains = false;")


def build(cuda):
    """The C entry point of the one-chain build."""
    src_dir = cuda.CSRC_DIR
    with open(os.path.join(src_dir, SOURCE)) as fh:
        src = fh.read()
    if EDIT[0] not in src:
        raise RuntimeError(f"{SOURCE} declares no {EDIT[0]!r}")
    body = src.replace(*EDIT)
    out = os.path.join(cuda.BUILD_DIR, "tf32_chains")
    os.makedirs(out, exist_ok=True)
    for name in os.listdir(src_dir):
        if name.endswith(".cuh"):
            shutil.copy(os.path.join(src_dir, name), out)
    with open(os.path.join(out, SOURCE), "w") as fh:
        fh.write(body)
    lib = os.path.join(out, "lib.so")
    # flash_fwd.cu holds hvdt_error_string, which cuda.check reads from
    # the package's own library; this build needs only the entry point.
    cuda._run_all([[cuda._nvcc(), *cuda.NVCC_FLAGS, "-shared", "-o", lib,
                    os.path.join(out, SOURCE)]])
    fn = ctypes.CDLL(lib).hvdt_flash_fwd_tf32
    fn.argtypes = cuda._SIGNATURES["hvdt_flash_fwd_tf32"]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tf32_chains: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from horovod_tpu_torch import _cuda
    from horovod_tpu_torch.parallel import flash_attention as fa
    from horovod_tpu_torch.utils import tolerance

    _cuda.load()
    one_chain = build(_cuda)
    card = chip_smoke.card_line()
    shapes = {"main": dict(chip_smoke.MAIN),
              "d640": dict(chip_smoke.C4_SHAPE, d=640)}
    for label, sh in shapes.items():
        b, s, h, d = (sh[x] for x in "bshd")
        g = torch.Generator(device="cuda").manual_seed(6)
        q, k, v = (torch.randn(b, s, h, d, generator=g, device="cuda")
                   for _ in range(3))
        plain = fa._flash_fwd_plain(q, k, v, True, 0, 0)
        scratch = fa._tf32_fwd_scratch(q, k)
        outs = fa._fwd_outputs(q)
        stream = torch.cuda.current_stream().cuda_stream

        def one():
            _cuda.check(one_chain(
                *(t.data_ptr() for t in (q, k, v, *outs)),
                scratch.data_ptr(), b, h, s, s, d, 0, 0, 1,
                fa._softmax_scale(d), stream), "one-chain tf32 forward")
            return outs

        def split():
            return fa._flash_fwd_tf32(q, k, v, True, 0, 0)
        runs = {"split": split, "one": one}
        for name, fn in runs.items():
            o, m, l = fn()
            torch.cuda.synchronize()
            ratios = (tolerance.worst(o, plain[0], 2e-5)[1],
                      tolerance.worst(m, plain[1], 2e-5, atol=1e-5,
                                      rows=False)[1],
                      tolerance.worst(l, plain[2], 2e-5, rows=False)[1])
            print(f"{label} B={b} S={s} H={h} D={d} {name} chain(s): worst "
                  f"err/bound o {ratios[0]:.3f} m {ratios[1]:.3f} l "
                  f"{ratios[2]:.3f}")
        ms = {name: [] for name in runs}
        for name in ("split", "one", "one", "split"):
            ms[name].append(chip_smoke.time_ms(runs[name], 20))
        for name, xs in ms.items():
            print(f"{label} {name} chain(s): {sum(xs) / len(xs):.4f} ms "
                  f"({' '.join(f'{x:.4f}' for x in xs)})  [{card}]")
        del q, k, v, plain, scratch, outs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
