"""The narrow sm90 forward and dk/dv (16-bit head dims 16 and 32): the
choices of their design, measured.

``csrc/flash_fwd_sm90.cu`` fixes the narrow forward's design in six
constants: the consumer warpgroups that share a q tile's kv tiles
(``kNarrowSplit``), the keys of a kv stage (``kNarrowKv``), the depth of
each warpgroup's ring (``kNarrowStages``), the CTAs per SM that
``__launch_bounds__`` asks for (``kNarrowCtasPerSm``), S of the next kv
tile issued under this tile's reduction (``kNarrowOverlap``) and the
exponential as one MUFU.EX2 (``kNarrowExp2Ftz``). ``csrc/flash_dkv_sm90.cu``
fixes three of the narrow dk/dv's (consumer warpgroups of 64 keys, ring
depth, CTAs per SM). This tool builds each variant below into
``build/horovod_tpu_torch/narrow_variants/`` (one nvcc each, all started
together; ptxas' register and spill report printed), holds every
variant's outputs to the plain versions with the bound chip_smoke.py
holds the package's build to, says whether they equal the package's bit
for bit, and times the package's build and the variant in turns
(package, variant, variant, package; CUDA-event means of 20 launches,
``chip_smoke.time_ms``) with SDPA's forward on the same inputs beside
them: the forward at chip_smoke.py's C4 shape (B=2, S=1024, H=8, causal),
bf16 and fp16, D 16 and 32, and at the entry's shape (B 2, S 32, H 4, D
16, bf16); dk/dv at the C4 shape, bf16. ``package`` is the package's
source built again (the spread of two builds in turns; its ptxas report
must show no spill and no serialized wgmma in the narrow forward),
``before_split`` the forward's design before the split (one warpgroup,
128-key stages, two stages, two CTAs an SM, exp2f) and
``before_split_mask_every_tile`` that design with every tile through the
masked copy of the logits, as the source before tested its mask. With
``--parent DIR``, a checkout of the source before the split, the tool
also builds that checkout's ``flash_fwd_sm90.cu`` as ``parent``,
requires ``before_split`` to equal it bit for bit and times it in turns
with the package. Run from the root of a checkout, on the card:

    python3 horovod_tpu_torch/tools/narrow_variants.py [--parent DIR]
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
# The forward's constants as the package sets them, and as a variant does.
SPLIT1 = ("kNarrowSplit = 4;", "kNarrowSplit = 1;")
SPLIT2 = ("kNarrowSplit = 4;", "kNarrowSplit = 2;")
SPLIT3 = ("kNarrowSplit = 4;", "kNarrowSplit = 3;")
KV128 = ("kNarrowKv = 64;", "kNarrowKv = 128;")
STAGES2 = ("kNarrowStages = 3;", "kNarrowStages = 2;")
STAGES4 = ("kNarrowStages = 3;", "kNarrowStages = 4;")
CTAS2 = ("kNarrowCtasPerSm = 1;", "kNarrowCtasPerSm = 2;")
OVERLAP = ("kNarrowOverlap = false;", "kNarrowOverlap = true;")
EXP2F = ("kNarrowExp2Ftz = true;", "kNarrowExp2Ftz = false;")
# Every tile through the masked copy of the logits, as the design before
# the split ran them (one copy, the mask tested per tile inside it).
MASK_EVERY_TILE = ("    return k0 + kKv > Sk || (causal && k_off + k0 + "
                   "kKv - 1 > first_qpos);", "    return true;")
# variant -> (source, [(text of the package's source, text of the variant)])
VARIANTS = {
    "package": (FWD, []),
    "before_split": (FWD, [SPLIT1, KV128, STAGES2, CTAS2, EXP2F]),
    "before_split_mask_every_tile": (FWD, [SPLIT1, KV128, STAGES2, CTAS2,
                                           EXP2F, MASK_EVERY_TILE]),
    "fwd_split1": (FWD, [SPLIT1]),
    "fwd_split1_2cta": (FWD, [SPLIT1, CTAS2]),
    "fwd_split2": (FWD, [SPLIT2]),
    "fwd_split2_2cta": (FWD, [SPLIT2, CTAS2]),
    "fwd_split3": (FWD, [SPLIT3]),
    "fwd_2cta": (FWD, [CTAS2]),
    "fwd_kv128": (FWD, [KV128]),
    "fwd_2stages": (FWD, [STAGES2]),
    "fwd_4stages": (FWD, [STAGES4]),
    "fwd_overlap": (FWD, [OVERLAP]),
    "fwd_exp2f": (FWD, [EXP2F]),
    "dkv_128keys": (DKV, [("kNarrowGroups = 1;", "kNarrowGroups = 2;")]),
    "dkv_128keys_1cta": (DKV, [("kNarrowGroups = 1;", "kNarrowGroups = 2;"),
                               ("kNarrowCtasPerSm = 2;",
                                "kNarrowCtasPerSm = 1;")]),
    "dkv_2stages": (DKV, [("kNarrowStages = 3;", "kNarrowStages = 2;")]),
    "dkv_4cta": (DKV, [("kNarrowCtasPerSm = 2;", "kNarrowCtasPerSm = 4;")]),
    "dkv_1cta": (DKV, [("kNarrowCtasPerSm = 2;", "kNarrowCtasPerSm = 1;")]),
}
# The forward's shapes: (label, B, S, H, D, dtype name), causal.
SHAPES = (("c4_bf16_d16", 2, 1024, 8, 16, "bfloat16"),
          ("c4_bf16_d32", 2, 1024, 8, 32, "bfloat16"),
          ("c4_fp16_d16", 2, 1024, 8, 16, "float16"),
          ("c4_fp16_d32", 2, 1024, 8, 32, "float16"),
          ("entry", 2, 32, 4, 16, "bfloat16"))
ENTRIES = {FWD: "hvdt_flash_fwd_sm90", DKV: "hvdt_flash_dkv_sm90"}


def build(cuda, variants=None, entries=None, subdir="narrow_variants",
          report="narrow", logs=None, csrc=None, required=True):
    """{variant: (its C entry point, its source)} of ``variants`` (default
    VARIANTS; ``entries``: {source: C entry point}, default ENTRIES),
    built under ``build/horovod_tpu_torch/<subdir>/`` from the sources in
    ``csrc`` (default the package's); prints ptxas' report of each
    variant's kernels whose names hold ``report``, and every ptxas warning
    and note of serialized wgmmas. ``logs``, a dict, takes each variant's
    whole compiler output. A variant that fails to build raises, or with
    ``required`` False is reported and left out."""
    variants, entries = variants or VARIANTS, entries or ENTRIES
    csrc = csrc or cuda.CSRC_DIR
    out = os.path.join(cuda.BUILD_DIR, subdir)
    cmds, libs = [], {}
    for name, (source, edits) in variants.items():
        with open(os.path.join(csrc, source)) as fh:
            body = fh.read()
        for old, new in edits:
            if old not in body:
                raise RuntimeError(f"{source} declares no {old!r}")
            body = body.replace(old, new)
        d = os.path.join(out, name)
        os.makedirs(d, exist_ok=True)
        for hdr in os.listdir(csrc):
            if hdr.endswith(".cuh"):
                shutil.copy(os.path.join(csrc, hdr), d)
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
            if required:
                raise RuntimeError(f"{name} failed to build:\n{out}")
            print(f"  {name}: does not build: " + " ".join(
                line.strip() for line in out.splitlines()
                if "fatal" in line or "error" in line)[:300])
            continue
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


def _bound_ms(chip_smoke, b, s, h, d, dt):
    """The causal forward's least time on the card: its products over the
    16-bit tensor peak or its bytes (q, k, v read, o written, m and l)
    over the memory rate, whichever is larger."""
    flops = 4 * b * h * s * s * d // 2
    moved = 4 * b * s * h * d * 2 + 2 * b * h * s * 4
    return max(flops / chip_smoke.PEAK_FLOPS[dt],
               moved / chip_smoke.PEAK_BYTES_PER_S) * 1e3


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("narrow_variants: no CUDA device; this script runs on the "
              "card", file=sys.stderr)
        return 1
    argv = sys.argv[1:] if argv is None else argv
    sys.path.insert(0, ROOT)
    import chip_smoke
    import torch.nn.functional as F
    from horovod_tpu_torch import _cuda
    from horovod_tpu_torch.parallel import flash_attention as fa
    from horovod_tpu_torch.utils import tolerance

    _cuda.load()
    logs = {}
    variants = build(_cuda, required=False, logs=logs)
    from horovod_tpu_torch.tools.fwd_sm90_variants import package_report
    bad = package_report(logs["package"], "flash_fwd_sm90_narrow")
    if bad:
        raise AssertionError("the package's narrow forward spills or "
                             "serializes its wgmmas:\n" + "\n".join(bad))
    if "--parent" in argv:
        parent = os.path.join(argv[argv.index("--parent") + 1],
                              "horovod_tpu_torch", "csrc")
        variants.update(build(_cuda, {"parent": (FWD, [])},
                              subdir="narrow_parent", csrc=parent))
    card = chip_smoke.card_line()
    for label, b, s, h, d, dt_name in SHAPES:
        dt = getattr(torch, dt_name)
        code = {torch.bfloat16: 1, torch.float16: 2}[dt]
        g = torch.Generator(device="cuda").manual_seed(12)
        q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda")
                       .to(dt) for _ in range(4))
        o_p, m_p, l_p = fa._flash_fwd_plain(q, k, v, True, 0, 0)
        lse = fa._lse_from_stats(m_p, l_p)
        delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        args = (q, k, v, do, lse, delta, True, 0, 0)
        # (plain, plain with the 16-bit operand rounding or None, rtol,
        # atol, rows) of each output
        want = {FWD: ((o_p, fa._flash_fwd_plain(q, k, v, True, 0, 0,
                                                operands=dt)[0],
                       2e-5, 1e-6, True),
                      (m_p, None, 2e-5, 1e-5, False),
                      (l_p, None, 2e-5, 1e-6, False))}
        if label in ("c4_bf16_d16", "c4_bf16_d32"):
            want[DKV] = tuple(
                (p, pb, 1e-4, 1e-6, True) for p, pb in zip(
                    fa._flash_dkv_plain(*args),
                    fa._flash_dkv_plain(*args, operands=dt)))
        sizes = (b, h, s, s, d, 0, 0, 1, fa._softmax_scale(d))

        def run(fn, source):
            stream = torch.cuda.current_stream().cuda_stream
            if source == FWD:
                o, m, l = fa._fwd_outputs(q)
                _cuda.check(fn(code, q.data_ptr(), k.data_ptr(),
                               v.data_ptr(), o.data_ptr(), m.data_ptr(),
                               l.data_ptr(), *sizes, stream),
                            "variant forward")
                return o, m, l
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            _cuda.check(fn(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                           dk.data_ptr(), dv.data_ptr(), *sizes, stream),
                        "variant dk/dv")
            return dk, dv

        mine = {FWD: lambda: fa._flash_fwd_sm90(q, k, v, True, 0, 0),
                DKV: lambda: fa._flash_dkv_sm90(*args)}
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = chip_smoke.time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 20)
        bound = _bound_ms(chip_smoke, b, s, h, d, dt_name)
        print(f"{label} B{b} S{s} H{h} D{d} {dt_name}: SDPA forward "
              f"{sdpa:.4f} ms, bound {bound:.4f} ms  [{card}]", flush=True)
        outs = {}
        for name, (fn, source) in variants.items():
            if source not in want:
                continue
            ours = tuple(x.clone() for x in mine[source]())
            theirs = outs[name] = tuple(x.clone() for x in run(fn, source))
            torch.cuda.synchronize()
            ratio = max(tolerance.worst(x, p, rtol, atol=atol,
                                        step=tolerance.step_of(dt),
                                        rows=rows, plain_b=pb)[1]
                        for x, (p, pb, rtol, atol, rows) in zip(
                            theirs, want[source]))
            same = all(torch.equal(a, c) for a, c in zip(ours, theirs))
            if not ratio <= 1.0:
                print(f"  {name:<16}: {ratio:.3f} of the bound, not timed",
                      flush=True)
                continue
            t = [chip_smoke.time_ms(f, 20) for f in (
                mine[source], lambda: run(fn, source),
                lambda: run(fn, source), mine[source])]
            pkg, var = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            vs = (f"; {pkg / sdpa:.2f}x / {var / sdpa:.2f}x SDPA"
                  if source == FWD else "")
            print(f"  {name:<16}: package {t[0]:.4f} / {t[3]:.4f} ms, "
                  f"variant {t[1]:.4f} / {t[2]:.4f} ms ({var / pkg:.3f}x "
                  f"the package{vs}; worst err/tol {ratio:.3f}, "
                  f"{'bit-equal' if same else 'other sums'})", flush=True)
        if "parent" in outs and "before_split" in outs:
            if not all(torch.equal(a, c)
                       for a, c in zip(outs["parent"], outs["before_split"])):
                raise AssertionError(f"{label}: before_split differs from the "
                                     f"parent's forward")
            print("  before_split equals the parent's forward bit for bit",
                  flush=True)
        del q, k, v, do, qt, kt, vt, outs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
