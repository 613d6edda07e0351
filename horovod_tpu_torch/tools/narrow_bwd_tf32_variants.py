"""The narrow tf32 dq and dk/dv (fp32 at head dims 16 and 32): the choices
of their design, measured.

``csrc/flash_bwd_tf32_narrow_sm90.cu`` fixes the design in seven
constants: per kernel the consumer warpgroups that share a CTA's stages
(``kDqSplit``, ``kDkvSplit``), the rows of a stage (``kDqKv`` keys,
``kDkvQ`` queries) and the depth of each warpgroup's ring (``kDqStages``,
``kDkvStages``), and whether dP's k8 steps each take an accumulator of
their own (``kDpSteps``). This tool builds each variant below into
``build/horovod_tpu_torch/narrow_bwd_tf32_variants/`` (one nvcc each, all
started together, with ``narrow_variants.build``; ptxas' register and
spill report printed; a variant whose tiles exceed shared memory at D 16
or 32 fails its static_assert and is reported as not built), asserts that
the package's build spills nothing and serializes no wgmma, and on the
package's pre-pass of each input set holds every variant's dq, dk and dv
to the TF32X3 plain versions with the bound chip_smoke.py holds the
package's build to (the ratio printed even where it fails). A variant of
one kernel's constants must leave the other kernel's output bit for bit
the package's, and one of a ring's depth alone its own kernel's too. The
tool times the package's kernel and the variant's in turns (package,
variant, variant, package; CUDA-event means of 20 launches behind the
spin, ``chip_smoke.time_ms``, the pre-pass apart), with the route
(``_flash_bwd``: one pre-pass, dq, dk/dv), the pre-pass alone, the simt
kernels it replaces and SDPA's backward alone on the same inputs beside
them. Shapes: fp32 at chip_smoke.py's C4 shape (B=2, S=1024, H=8,
causal), D 16 and 32, and at the entry's shape (B 2, S 32, H 4, D 16).
Last, the rounding noise of a query and a key that see only each other (B
2, Sq = Sk = 1, H 2, D 16, 24 and 32, NOISE_SEEDS input sets each): the
worst err/bound of dq (``DQ_ATOL``) and of dk and dv (atol 1e-6) of the
package and of ``dp_one_chain`` against the TF32X3 plain versions, and of
the plain versions and the package against an fp64 evaluation of the
same tf32 parts (the noise of each alone). Run from the root of a checkout, on the
card:

    python3 horovod_tpu_torch/tools/narrow_bwd_tf32_variants.py
"""

from __future__ import annotations

import ctypes
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = "flash_bwd_tf32_narrow_sm90.cu"
ENTRIES = {SOURCE: "hvdt_flash_dq_tf32_narrow"}
DKV_ENTRY = "hvdt_flash_dkv_tf32_narrow"  # from each variant's library
SUBDIR = "narrow_bwd_tf32_variants"
DQ_SPLIT1 = ("kDqSplit = 2;", "kDqSplit = 1;")
DQ_SPLIT3 = ("kDqSplit = 2;", "kDqSplit = 3;")
DQ_SPLIT4 = ("kDqSplit = 2;", "kDqSplit = 4;")
DQ_KV32 = ("kDqKv = 64;", "kDqKv = 32;")
DQ_STAGES1 = ("kDqStages = 2;", "kDqStages = 1;")
DKV_SPLIT1 = ("kDkvSplit = 3;", "kDkvSplit = 1;")
DKV_SPLIT2 = ("kDkvSplit = 3;", "kDkvSplit = 2;")
DKV_SPLIT4 = ("kDkvSplit = 3;", "kDkvSplit = 4;")
DKV_Q64 = ("kDkvQ = 32;", "kDkvQ = 64;")
DKV_STAGES1 = ("kDkvStages = 2;", "kDkvStages = 1;")
DKV_STAGES3 = ("kDkvStages = 2;", "kDkvStages = 3;")
DP_ONE_CHAIN = ("kDpSteps = true;", "kDpSteps = false;")
# variant -> [(text of the package's source, text of the variant)];
# "package" is the package's own source built again: its ptxas report, and
# the spread of two builds of one source timed in turns. A name's prefix
# says which kernel it changes (dq_, dkv_; others both).
VARIANTS = {
    "package": [],
    "dq_split1": [DQ_SPLIT1],
    "dq_split2_kv32": [DQ_KV32],
    "dq_split3_kv32": [DQ_SPLIT3, DQ_KV32],
    "dq_split4_kv32": [DQ_SPLIT4, DQ_KV32],
    "dq_split4_kv32_stages1": [DQ_SPLIT4, DQ_KV32, DQ_STAGES1],
    "dq_stages1": [DQ_STAGES1],
    "dkv_split1": [DKV_SPLIT1],
    "dkv_split2": [DKV_SPLIT2],
    "dkv_split4": [DKV_SPLIT4],
    "dkv_split4_stages1": [DKV_SPLIT4, DKV_STAGES1],
    "dkv_split1_q64": [DKV_SPLIT1, DKV_Q64],
    "dkv_split2_q64_stages1": [DKV_SPLIT2, DKV_Q64, DKV_STAGES1],
    "dkv_split2_stages3": [DKV_SPLIT2, DKV_STAGES3],
    "dkv_stages1": [DKV_STAGES1],
    "dp_one_chain": [DP_ONE_CHAIN],
}
# Variants whose sums run in the package's order: bit-equal or wrong.
SAME_SUMS = ("package", "dq_stages1", "dkv_stages1")
# (label, B, S, H, D), fp32, causal
SHAPES = (("c4_fp32_d16", 2, 1024, 8, 16),
          ("c4_fp32_d32", 2, 1024, 8, 32),
          ("entry_fp32", 2, 32, 4, 16))
NOISE_SEEDS = 100


def kernels_of(name):
    """The kernels (dq, dkv) whose output a variant may change."""
    for kern in ("dq", "dkv"):
        if name.startswith(kern + "_"):
            return (kern,)
    return ("dq", "dkv")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("narrow_bwd_tf32_variants: no CUDA device; this script runs "
              "on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    import torch.nn.functional as F
    from horovod_tpu_torch import _cuda
    from horovod_tpu_torch.parallel import flash_attention as fa
    from horovod_tpu_torch.tools.fwd_sm90_variants import package_report
    from horovod_tpu_torch.tools.narrow_variants import build
    from horovod_tpu_torch.utils import tolerance

    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.load()
    logs = {}
    built = build(_cuda, {name: (SOURCE, edits)
                          for name, edits in VARIANTS.items()},
                  ENTRIES, SUBDIR, "flash_bwd_tf32_narrow", logs=logs,
                  required=False)
    bad = package_report(logs["package"], "flash_bwd_tf32_narrow")
    if bad:
        raise AssertionError("the package's narrow tf32 dq and dk/dv spill "
                             "or serialize their wgmmas:\n" + "\n".join(bad))
    fns = {}
    for name, (dq_fn, _) in built.items():
        lib = ctypes.CDLL(os.path.join(_cuda.BUILD_DIR, SUBDIR, name,
                                       "lib.so"))
        dkv_fn = getattr(lib, DKV_ENTRY)
        dkv_fn.argtypes = _cuda._SIGNATURES[DKV_ENTRY]
        dkv_fn.restype = ctypes.c_int
        fns[name] = {"dq": dq_fn, "dkv": dkv_fn}
    card = chip_smoke.card_line()

    def inputs(b, s, h, d, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda")
                       for _ in range(4))
        o, m, l = fa._flash_fwd_plain(q, k, v, True, 0, 0)
        lse = fa._lse_from_stats(m, l)
        delta = (do * o).sum(-1).transpose(1, 2).contiguous()
        return q, k, v, do, lse, delta

    def launch(fn, kern, split, q, k, lse, delta, scale):
        """One variant kernel on the package's pre-pass at q's head dim."""
        b, sq, h, d = q.shape
        outs = ([torch.empty_like(q)] if kern == "dq"
                else [torch.empty_like(k), torch.empty_like(k)])
        _cuda.check(fn(split.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                       *(x.data_ptr() for x in outs), b, h, sq, k.shape[1],
                       d, 0, 0, 1, scale,
                       torch.cuda.current_stream().cuda_stream),
                    f"variant {kern}")
        return outs

    def grads(name, q, k, v, do, lse, delta):
        """(dq, dk, dv) of a variant at q's true head dim: padded to its
        build, the package's pre-pass, the scale of the true D, sliced."""
        d = q.shape[-1]
        built_d = fa.padded_head_dim(d, "tf32", "dq")
        t = fa._pad_head_dim((q, k, v, do), built_d)
        split = fa._tf32_bwd_split(*t)
        out = []
        for kern in ("dq", "dkv"):
            out += launch(fns[name][kern], kern, split, t[0], t[1], lse,
                          delta, fa._softmax_scale(d))
        return tuple(x[..., :d] for x in out)

    def ratios(mine, plain):
        return (tolerance.worst(mine[0], plain[0], 1e-4,
                                atol=tolerance.DQ_ATOL)[1],
                max(tolerance.worst(mine[1], plain[1], 1e-4)[1],
                    tolerance.worst(mine[2], plain[2], 1e-4)[1]))

    for label, b, s, h, d in SHAPES:
        q, k, v, do, lse, delta = inputs(b, s, h, d, 12)
        args = (q, k, v, do, lse, delta, True, 0, 0)
        plain = (fa._flash_dq_plain(*args, operands=fa.TF32X3),
                 *fa._flash_dkv_plain(*args, operands=fa.TF32X3))
        split = fa._tf32_bwd_split(q, k, v, do)
        scale = fa._softmax_scale(d)
        mine = {"dq": lambda: fa._flash_dq_tf32(*args, split=split),
                "dkv": lambda: fa._flash_dkv_tf32(*args, split=split)}
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in
                           (q, k, v, do))
        qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        sdpa = chip_smoke.time_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), dot, retain_graph=True), 20)
        route = chip_smoke.time_ms(lambda: fa._flash_bwd(*args), 20)
        pre = chip_smoke.time_ms(lambda: fa._tf32_bwd_split(q, k, v, do), 20)
        simt = (chip_smoke.time_ms(lambda: fa._flash_dq_simt(*args), 20)
                + chip_smoke.time_ms(lambda: fa._flash_dkv_simt(*args), 20))
        print(f"{label} B{b} S{s} H{h} D{d} fp32: route {route:.4f} ms "
              f"({route / sdpa:.2f}x SDPA's backward alone {sdpa:.4f}), "
              f"pre-pass alone {pre:.4f}, simt dq + dk/dv {simt:.4f}  "
              f"[{card}]", flush=True)
        ours = (mine["dq"](), *mine["dkv"]())
        for name in fns:
            theirs = grads(name, q, k, v, do, lse, delta)
            torch.cuda.synchronize()
            ratio = max(ratios(theirs, plain))
            same = {"dq": torch.equal(ours[0], theirs[0]),
                    "dkv": all(torch.equal(a, c) for a, c in
                               zip(ours[1:], theirs[1:]))}
            kerns = kernels_of(name)
            for kern in ("dq", "dkv"):
                if (kern not in kerns or name in SAME_SUMS) and not same[kern]:
                    raise AssertionError(f"{label}: {name} changes {kern}, "
                                         f"whose sums it keeps")
            if not ratio <= 1.0:
                print(f"  {name:<23}: {ratio:.3f} of the bound, not timed",
                      flush=True)
                continue
            line = f"  {name:<23}:"
            for kern in kerns:
                def var(kern=kern):
                    return launch(fns[name][kern], kern, split, q, k, lse,
                                  delta, scale)
                t = [chip_smoke.time_ms(f, 20) for f in (
                    mine[kern], var, var, mine[kern])]
                pkg, va = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
                line += (f" {kern} package {t[0]:.4f} / {t[3]:.4f} ms, "
                         f"variant {t[1]:.4f} / {t[2]:.4f} ms "
                         f"({va / pkg:.3f}x);")
            print(f"{line} worst err/tol {ratio:.3f}, "
                  f"{'bit-equal' if all(same.values()) else 'other sums'}",
                  flush=True)
        del q, k, v, do, qt, kt, vt, dot, qg, kg, vg, out, plain, ours
        torch.cuda.empty_cache()

    def exact(q, k, v, do, lse, delta):
        """(dq, dk, dv) of one query and one key (no mask) in fp64 from the
        TF32X3 plain versions' tf32 parts: what both would give without
        fp32 rounding."""
        def parts(x):
            hi = fa._tf32(x)
            return hi.double(), fa._tf32(x - hi).double()

        def product(eq, a, b):
            (a_hi, a_lo), (b_hi, b_lo) = parts(a), parts(b)
            return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
                    + torch.einsum(eq, a_hi, b_hi))
        scale = fa._softmax_scale(q.shape[-1])
        s = product("bqhd,bkhd->bhqk", q, k) * scale
        p = torch.exp(s - lse.double()[..., None])
        dp = product("bqhd,bkhd->bhqk", do, v)
        ds = p * (dp - delta.double()[..., None]) * scale
        return (torch.einsum("bhqk,bkhd->bqhd", ds, k.double()),
                torch.einsum("bhqk,bqhd->bkhd", ds, q.double()),
                torch.einsum("bhqk,bqhd->bkhd", p, do.double()))

    print(f"rounding noise at Sq = Sk = 1 (B 2, H 2), {NOISE_SEEDS} input "
          f"sets: worst err/tol of dq (atol {tolerance.DQ_ATOL:g}) and of "
          f"dk, dv (atol 1e-6) against the TF32X3 plain versions, and of "
          f"those and the package against an fp64 evaluation of the same "
          f"tf32 parts", flush=True)
    for d in (16, 24, 32):
        worst = {}
        for seed in range(NOISE_SEEDS):
            q, k, v, do, lse, delta = inputs(2, 1, 2, d, seed)
            args = (q, k, v, do, lse, delta, True, 0, 0)
            plain = (fa._flash_dq_plain(*args, operands=fa.TF32X3),
                     *fa._flash_dkv_plain(*args, operands=fa.TF32X3))
            ideal = exact(q, k, v, do, lse, delta)
            got = {name: grads(name, q, k, v, do, lse, delta)
                   for name in ("package", "dp_one_chain") if name in fns}
            pairs = {name: (mine, plain) for name, mine in got.items()}
            pairs["plain vs fp64"] = (plain, ideal)
            if "package" in got:
                pairs["package vs fp64"] = (got["package"], ideal)
            for name, (mine, want) in pairs.items():
                r = ratios(mine, want)
                w = worst.setdefault(name, [0.0, 0.0])
                worst[name] = [max(w[0], r[0]), max(w[1], r[1])]
        print(f"  D {d}: " + "; ".join(
            f"{name} dq {w[0]:.3f}, dk/dv {w[1]:.3f}"
            for name, w in worst.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
