"""Depth of the kv ring of the tensor-core dq kernel, measured.

Builds ``csrc/flash_dq_sm90.cu`` once for each ring depth (``kStages`` =
2, 3, 4; one nvcc each, all started together) into
``build/horovod_tpu_torch/dq_stages/``, checks that every depth gives
exactly the dq of the package's own build, and times the depths in turns
(2, 3, 4, 4, 3, 2; each a CUDA-event mean of 50 launches) at the main
path's shape (B=4, S=2048, H=16, D=128, bf16, causal), where the kernel
runs 64-key stages. Run from the root of a checkout, on the card:

    python3 horovod_tpu_torch/tools/dq_stages.py
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEPTHS = (2, 3, 4)


def build(cuda):
    """{depth: the variant's C entry point}."""
    src_dir = cuda.CSRC_DIR
    with open(os.path.join(src_dir, "flash_dq_sm90.cu")) as fh:
        src = fh.read()
    out = os.path.join(cuda.BUILD_DIR, "dq_stages")
    cmds, libs = [], {}
    for n in DEPTHS:
        d = os.path.join(out, f"stages{n}")
        os.makedirs(d, exist_ok=True)
        for name in os.listdir(src_dir):
            if name.endswith(".cuh"):
                shutil.copy(os.path.join(src_dir, name), d)
        body = re.sub(r"constexpr int kStages = \d+;",
                      f"constexpr int kStages = {n};", src)
        if f"kStages = {n};" not in body:
            raise RuntimeError("flash_dq_sm90.cu declares no kStages")
        with open(os.path.join(d, "flash_dq_sm90.cu"), "w") as fh:
            fh.write(body)
        libs[n] = os.path.join(d, "lib.so")
        cmds.append([cuda._nvcc(), *cuda.NVCC_FLAGS, "-shared", "-o",
                     libs[n], os.path.join(d, "flash_dq_sm90.cu")])
    cuda._run_all(cmds)
    fns = {}
    for n, path in libs.items():
        fn = ctypes.CDLL(path).hvdt_flash_dq_sm90
        fn.argtypes = cuda._SIGNATURES["hvdt_flash_dq_sm90"]
        fn.restype = ctypes.c_int
        fns[n] = fn
    return fns


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("dq_stages: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from horovod_tpu_torch import _cuda
    from horovod_tpu_torch.parallel import flash_attention as fa

    fns = build(_cuda)
    b, s, h, d = (chip_smoke.MAIN[x] for x in "bshd")
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    o, m, l = fa._flash_fwd(q, k, v, True, 0, 0)
    lse = fa._lse_from_stats(m, l)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    ref = fa._flash_dq_sm90(q, k, v, do, lse, delta, True, 0, 0)
    outs = {n: torch.empty_like(q) for n in fns}
    stream = torch.cuda.current_stream().cuda_stream

    def call(n):
        _cuda.check(fns[n](fa._DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                           v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                           delta.data_ptr(),
                           outs[n].data_ptr(), b, h, s, s, d, 0, 0, 1,
                           fa._softmax_scale(d), stream),
                    f"dq with {n} stages")

    for n in fns:
        call(n)
    torch.cuda.synchronize()
    for n in fns:
        if not torch.equal(outs[n], ref):
            print(f"{n} stages: dq differs from the package's build")
            return 1
    ms = {n: [] for n in fns}
    for n in DEPTHS + DEPTHS[::-1]:
        ms[n].append(chip_smoke.time_ms(lambda: call(n), 50))
    card = chip_smoke.card_line()
    for n in fns:
        print(f"{n} stages: {sum(ms[n]) / len(ms[n]):.4f} ms "
              f"({' '.join(f'{x:.4f}' for x in ms[n])})  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
