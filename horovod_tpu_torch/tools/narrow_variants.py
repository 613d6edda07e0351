"""The narrow sm90 forward and dk/dv (16-bit head dims 16 and 32): the
choices of their CTA shape, measured.

``csrc/flash_fwd_sm90.cu`` and ``csrc/flash_dkv_sm90.cu`` fix four (three)
constants of the narrow design: consumer warpgroups per CTA
(``kNarrowGroups``: 64 q rows, or 64 keys, each), the keys of a forward kv
stage (``kNarrowKv``), the ring's depth (``kNarrowStages``) and the CTAs
per SM that ``__launch_bounds__`` asks for (``kNarrowCtasPerSm``). This
tool builds each variant below into ``build/horovod_tpu_torch/
narrow_variants/`` (one nvcc each, all started together; ptxas' register
and spill report printed), holds every variant's outputs to the plain
versions with the bound chip_smoke.py holds the package's build to, says
whether they equal the package's bit for bit (the same per-row arithmetic
where only the CTA shape changes), and times the package's build and the
variant in turns (package, variant, variant, package; CUDA-event means of
20 launches, ``chip_smoke.time_ms``) at chip_smoke.py's C4 shape (B=2,
S=1024, H=8, causal), bf16, D 16 and 32. Run from the root of a checkout,
on the card:

    python3 horovod_tpu_torch/tools/narrow_variants.py
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
FWD, DKV = "flash_fwd_sm90.cu", "flash_dkv_sm90.cu"
# variant -> (source, [(text of the package's source, text of the variant)])
VARIANTS = {
    "fwd_kv64": (FWD, [("kNarrowKv = 128;", "kNarrowKv = 64;")]),
    "fwd_kv64_4cta": (FWD, [("kNarrowKv = 128;", "kNarrowKv = 64;"),
                            ("kNarrowCtasPerSm = 2;",
                             "kNarrowCtasPerSm = 4;")]),
    "fwd_128rows": (FWD, [("kNarrowGroups = 1;", "kNarrowGroups = 2;")]),
    "fwd_128rows_1cta": (FWD, [("kNarrowGroups = 1;", "kNarrowGroups = 2;"),
                               ("kNarrowCtasPerSm = 2;",
                                "kNarrowCtasPerSm = 1;")]),
    "fwd_3stages": (FWD, [("kNarrowStages = 2;", "kNarrowStages = 3;")]),
    "fwd_1cta": (FWD, [("kNarrowCtasPerSm = 2;", "kNarrowCtasPerSm = 1;")]),
    "dkv_128keys": (DKV, [("kNarrowGroups = 1;", "kNarrowGroups = 2;")]),
    "dkv_128keys_1cta": (DKV, [("kNarrowGroups = 1;", "kNarrowGroups = 2;"),
                               ("kNarrowCtasPerSm = 2;",
                                "kNarrowCtasPerSm = 1;")]),
    "dkv_2stages": (DKV, [("kNarrowStages = 3;", "kNarrowStages = 2;")]),
    "dkv_4cta": (DKV, [("kNarrowCtasPerSm = 2;", "kNarrowCtasPerSm = 4;")]),
    "dkv_1cta": (DKV, [("kNarrowCtasPerSm = 2;", "kNarrowCtasPerSm = 1;")]),
}
ENTRIES = {FWD: "hvdt_flash_fwd_sm90", DKV: "hvdt_flash_dkv_sm90"}


def build(cuda, variants=None, entries=None, subdir="narrow_variants",
          report="narrow", logs=None):
    """{variant: (its C entry point, its source)} of ``variants`` (default
    VARIANTS; ``entries``: {source: C entry point}, default ENTRIES),
    built under ``build/horovod_tpu_torch/<subdir>/``; prints ptxas'
    report of each variant's kernels whose names hold ``report``, and
    every ptxas warning and note of serialized wgmmas. ``logs``, a dict, takes each variant's whole
    compiler output."""
    variants, entries = variants or VARIANTS, entries or ENTRIES
    out = os.path.join(cuda.BUILD_DIR, subdir)
    cmds, libs = [], {}
    for name, (source, edits) in variants.items():
        with open(os.path.join(cuda.CSRC_DIR, source)) as fh:
            body = fh.read()
        for old, new in edits:
            if old not in body:
                raise RuntimeError(f"{source} declares no {old!r}")
            body = body.replace(old, new)
        d = os.path.join(out, name)
        os.makedirs(d, exist_ok=True)
        for hdr in os.listdir(cuda.CSRC_DIR):
            if hdr.endswith(".cuh"):
                shutil.copy(os.path.join(cuda.CSRC_DIR, hdr), d)
        with open(os.path.join(d, source), "w") as fh:
            fh.write(body)
        libs[name] = (os.path.join(d, "lib.so"), source)
        cmds.append([cuda._nvcc(), *cuda.NVCC_FLAGS, "-Xptxas", "-v",
                     "-shared", "-o", libs[name][0],
                     os.path.join(d, source)])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    fns = {}
    for (name, (path, source)), proc in zip(libs.items(), procs):
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name} failed to build:\n{out}")
        if logs is not None:
            logs[name] = out
        # ptxas: the registers and spills of each entry named by `report`.
        entry = None
        for line in out.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '(\w+)'", line)
            if m:
                entry = m.group(1) if report in m.group(1) else None
            elif "warning" in line or "serialized" in line:
                print(f"  {name}: {line.strip()}")
            elif entry and ("Used" in line or "spill" in line):
                # the mangled name past its file's unique prefix
                print(f"  {name}: {entry.split('_cu_')[-1][8:56]}: "
                      f"{line.split('info    :')[-1].strip()}")
        lib = ctypes.CDLL(path)
        fn = getattr(lib, entries[source])
        fn.argtypes = cuda._SIGNATURES[entries[source]]
        fn.restype = ctypes.c_int
        fns[name] = (fn, source)
    return fns


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("narrow_variants: no CUDA device; this script runs on the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from horovod_tpu_torch import _cuda
    from horovod_tpu_torch.parallel import flash_attention as fa
    from horovod_tpu_torch.utils import tolerance

    _cuda.load()
    variants = build(_cuda)
    card = chip_smoke.card_line()
    b, s, h = (chip_smoke.C4_SHAPE[x] for x in "bsh")
    for d in (16, 32):
        dt = torch.bfloat16
        g = torch.Generator(device="cuda").manual_seed(12)
        q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda")
                       .to(dt) for _ in range(4))
        o_p, m_p, l_p = fa._flash_fwd_plain(q, k, v, True, 0, 0)
        lse = fa._lse_from_stats(m_p, l_p)
        delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        args = (q, k, v, do, lse, delta, True, 0, 0)
        want = {FWD: (o_p,), DKV: fa._flash_dkv_plain(*args)}
        rounded = {FWD: (fa._flash_fwd_plain(q, k, v, True, 0, 0,
                                             operands=dt)[0],),
                   DKV: fa._flash_dkv_plain(*args, operands=dt)}
        sizes = (b, h, s, s, d, 0, 0, 1, fa._softmax_scale(d))

        def run(fn, source):
            stream = torch.cuda.current_stream().cuda_stream
            if source == FWD:
                o, m, l = fa._fwd_outputs(q)
                _cuda.check(fn(1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               o.data_ptr(), m.data_ptr(), l.data_ptr(),
                               *sizes, stream), "variant forward")
                return (o,)
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            _cuda.check(fn(1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                           dk.data_ptr(), dv.data_ptr(), *sizes, stream),
                        "variant dk/dv")
            return dk, dv

        mine = {FWD: lambda: (fa._flash_fwd_sm90(q, k, v, True, 0, 0)[0],),
                DKV: lambda: fa._flash_dkv_sm90(*args)}
        for name, (fn, source) in variants.items():
            ours, theirs = mine[source](), run(fn, source)
            torch.cuda.synchronize()
            rtol = 2e-5 if source == FWD else 1e-4
            step = tolerance.step_of(dt)
            ratio = max(tolerance.worst(x, p, rtol, step=step, plain_b=pb)[1]
                        for x, p, pb in zip(theirs, want[source],
                                            rounded[source]))
            same = all(torch.equal(a, c) for a, c in zip(ours, theirs))
            if not ratio <= 1.0:
                print(f"D{d} {name:<14}: {ratio:.3f} of the bound, not "
                      f"timed  [{card}]", flush=True)
                continue
            t = [chip_smoke.time_ms(f, 20) for f in (
                mine[source], lambda: run(fn, source),
                lambda: run(fn, source), mine[source])]
            print(f"D{d} {name:<14}: package {t[0]:.4f} / {t[3]:.4f} ms, "
                  f"variant {t[1]:.4f} / {t[2]:.4f} ms (worst err/tol "
                  f"{ratio:.3f}, {'bit-equal' if same else 'other sums'}) "
                  f" [{card}]", flush=True)
        del q, k, v, do
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
