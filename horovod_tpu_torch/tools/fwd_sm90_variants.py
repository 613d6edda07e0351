"""The 16-bit sm90 forward's overlap, measured piece by piece.

``csrc/flash_fwd_sm90.cu`` runs its builds of D 64 to 512 on a loop that
keeps the tensor cores busy through four pieces, each turned off by one
constant (``PIECES``): S of the next kv tile issued before this tile's
softmax (``kOverlap``), the two consumer warpgroups taking turns at their
products (``kPingPong``), one CTA an SM walking the tiles (``kPersistent``)
and O stored through shared memory, 16 bytes a thread
(``kStagedStore``). This tool builds each variant below into
``build/horovod_tpu_torch/fwd_sm90_variants/`` (one nvcc each, all started
together, with ``narrow_variants.build``; ptxas' register and spill
report and its warnings printed):

- ``package``: the package's source built again (the spread of two builds
  of one source timed in turns);
- ``serial``: every piece off, the loop of one tile after another with
  each product waited for before the softmax (the design before the
  overlap);
- ``serial_exp2f``: ``serial`` with CUDA's ``exp2f`` for the exponential,
  the arithmetic of the design before the overlap;
- ``no_<piece>``: that piece alone off.

No piece changes an operation or its order, so on the same inputs every
variant's o, m and l must equal ``serial``'s bit for bit, and so must the
package's (``serial_exp2f`` too, where no p falls below 2^-126); the tool
asserts that, holds each to the plain forward with
the bound chip_smoke.py holds the package to, asserts that the package's
own build has no spill and no serialized wgmma, and times the package
and the variant in turns (package, variant, variant, package; CUDA-event
means of 20 launches behind the spin, ``chip_smoke.time_ms``), with SDPA's
forward on the same inputs, the bound, TFLOP/s and the share of the
bound beside them. Shapes (causal): the main shape (B 4, S 2048, H 16, D
128, bf16), chip_smoke.py's C4 shape (B 2, S 1024, H 8) at fp16 D 64,
128, 256 and bf16 D 80, 96, 200, 384, 512, and the Gemma-7B widths (B 2,
S 2048, H 16, D 256, bf16). Run from the root of a checkout, on the card:

    python3 horovod_tpu_torch/tools/fwd_sm90_variants.py

With ``--trace`` it builds instead the package's source with clock marks
(``TRACE``: ``clock64`` at the waits and turns of the consumers' loop of
CTA 0, tiles 0-3) and prints, per consumer and tile, the SM cycles of the
tile's start (to its first softmax done), of a kv iteration (median, and
its parts: the wait for the turn, issue to S done, S done to P V done,
P V done to the next iteration) and of its end (the last P V and the
store), at the main shape, causal and not.
"""

from __future__ import annotations

import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = "flash_fwd_sm90.cu"
# piece -> (its line in the package's source, the line turning it off)
PIECES = {
    "overlap": ("constexpr bool kOverlap = true;",
                "constexpr bool kOverlap = false;"),
    "pingpong": ("constexpr bool kPingPong = true;",
                 "constexpr bool kPingPong = false;"),
    "persistent": ("constexpr bool kPersistent = true;",
                   "constexpr bool kPersistent = false;"),
    "staged_store": ("constexpr bool kStagedStore = true;",
                     "constexpr bool kStagedStore = false;"),
}
# The exponential as CUDA's exp2f, which keeps results below 2^-126 from
# flushing to zero at the cost of three more instructions.
EXP2F = ('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
         "  y = exp2f(x);")
# variant -> [(text of the package's source, text of the variant)]
VARIANTS = {"package": [], "serial": list(PIECES.values()),
            "serial_exp2f": [*PIECES.values(), EXP2F],
            **{f"no_{p}": [edit] for p, edit in PIECES.items()}}
ENTRIES = {SOURCE: "hvdt_flash_fwd_sm90"}
SUBDIR = "fwd_sm90_variants"
# (label, B, S, H, D, dtype name)
SHAPES = (("main", 4, 2048, 16, 128, "bfloat16"),
          ("c4_fp16_d64", 2, 1024, 8, 64, "float16"),
          ("c4_fp16_d128", 2, 1024, 8, 128, "float16"),
          ("c4_fp16_d256", 2, 1024, 8, 256, "float16"),
          ("c4_bf16_d80", 2, 1024, 8, 80, "bfloat16"),
          ("c4_bf16_d96", 2, 1024, 8, 96, "bfloat16"),
          ("c4_bf16_d200", 2, 1024, 8, 200, "bfloat16"),
          ("c4_bf16_d384", 2, 1024, 8, 384, "bfloat16"),
          ("c4_bf16_d512", 2, 1024, 8, 512, "bfloat16"),
          ("gemma", 2, 2048, 16, 256, "bfloat16"))
SEED = 17
# The clock marks of --trace: [(text of the package's source, text with
# the marks)]. Mark m of consumer c in tile `it` goes to g_trace[c][it][m]:
# 0 the tile's start, 1 Q there, 2 K_0 there, 3 the first turn, 4 S_0
# done, 5 its softmax and P done; for kv iteration j = 1..12 at 2 + 4 j:
# K_j and V_{j-1} there, the turn, S_j done, P_{j-1} V_{j-1} done; 54 the
# last V there, 55 its turn, 56 its P V done, 57 O in shared memory, 58
# the consumer's barrier, 59 the store done; 62 the tile's nk.
TRACE = [
    ("constexpr int kRows = 128;  // q rows of a tile\n",
     "constexpr int kRows = 128;  // q rows of a tile\n"
     "__device__ long long g_trace[2][4][64];\n"),
    ("      bar_wait(&q_full[qb], (it / kQB) & 1);\n",
     "      auto mark = [&](int id) {\n"
     "        if (blockIdx.x == 0 && t == 0 && it < 4)\n"
     "          g_trace[c][it][id] = clock64();\n"
     "      };\n"
     "      mark(0);\n"
     "      if (blockIdx.x == 0 && t == 0 && it < 4) g_trace[c][it][62] = nk;\n"
     "      bar_wait(&q_full[qb], (it / kQB) & 1);\n"
     "      mark(1);\n"),
    ("        bar_wait(&k_full[stage(0)], phase(0));\n"
     "        turn_begin();\n"
     "        scores(s, stage(0));\n"
     "        turn_end();\n"
     "        wgmma_wait<0>();\n"
     "        fence_regs(s);\n",
     "        bar_wait(&k_full[stage(0)], phase(0));\n"
     "        mark(2);\n"
     "        turn_begin();\n"
     "        mark(3);\n"
     "        scores(s, stage(0));\n"
     "        turn_end();\n"
     "        wgmma_wait<0>();\n"
     "        fence_regs(s);\n"
     "        mark(4);\n"),
    ("        softmax(s, 0, corr);\n"
     "        pack(pa, s);\n"
     "        for (int j = 1; j < nk; ++j) {\n"
     "          bar_wait(&k_full[stage(j)], phase(j));\n"
     "          bar_wait(&v_full[stage(j - 1)], phase(j - 1));\n"
     "          turn_begin();\n",
     "        softmax(s, 0, corr);\n"
     "        pack(pa, s);\n"
     "        mark(5);\n"
     "        for (int j = 1; j < nk; ++j) {\n"
     "          bar_wait(&k_full[stage(j)], phase(j));\n"
     "          bar_wait(&v_full[stage(j - 1)], phase(j - 1));\n"
     "          if (j <= 12) mark(2 + 4 * j);\n"
     "          turn_begin();\n"
     "          if (j <= 12) mark(3 + 4 * j);\n"),
    ("          wgmma_wait<1>();\n"
     "          fence_regs(s);\n"
     "          release(&k_empty[stage(j)]);\n",
     "          wgmma_wait<1>();\n"
     "          fence_regs(s);\n"
     "          if (j <= 12) mark(4 + 4 * j);\n"
     "          release(&k_empty[stage(j)]);\n"),
    ("          softmax(s, j, corr);\n"
     "          wgmma_wait<0>();\n"
     "          fence_regs(acc);\n"
     "          release(&v_empty[stage(j - 1)]);\n",
     "          softmax(s, j, corr);\n"
     "          wgmma_wait<0>();\n"
     "          fence_regs(acc);\n"
     "          if (j <= 12) mark(5 + 4 * j);\n"
     "          release(&v_empty[stage(j - 1)]);\n"),
    ("        bar_wait(&v_full[stage(nk - 1)], phase(nk - 1));\n"
     "        turn_begin();\n"
     "        pv(acc, pa, stage(nk - 1));\n"
     "        turn_end();\n"
     "        wgmma_wait<0>();\n"
     "        fence_regs(acc);\n",
     "        bar_wait(&v_full[stage(nk - 1)], phase(nk - 1));\n"
     "        mark(54);\n"
     "        turn_begin();\n"
     "        mark(55);\n"
     "        pv(acc, pa, stage(nk - 1));\n"
     "        turn_end();\n"
     "        wgmma_wait<0>();\n"
     "        fence_regs(acc);\n"
     "        mark(56);\n"),
    ("        named_bar_sync(kStoreBar + c, 128);\n",
     "        mark(57);\n"
     "        named_bar_sync(kStoreBar + c, 128);\n"
     "        mark(58);\n"),
    ("        fence_proxy_async();\n"
     "        release(&q_empty[qb]);\n"
     "      }\n",
     "        fence_proxy_async();\n"
     "        release(&q_empty[qb]);\n"
     "      }\n"
     "      mark(59);\n"),
    ("}  // namespace\n}  // namespace hvdt\n",
     "}  // namespace\n}  // namespace hvdt\n\n"
     "extern \"C\" int hvdt_fwd_trace_read(void* dst) {\n"
     "  return (int)cudaMemcpyFromSymbol(dst, hvdt::g_trace,\n"
     "                                   sizeof(hvdt::g_trace));\n"
     "}\n"),
]


def build(cuda, names=None, logs=None):
    """{variant: its C entry point} of ``names`` (default every variant),
    built by ``narrow_variants.build``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import narrow_variants
    chosen = {n: (SOURCE, VARIANTS[n]) for n in (names or VARIANTS)}
    fns = narrow_variants.build(cuda, chosen, ENTRIES, SUBDIR,
                                "flash_fwd_sm90", logs)
    return {n: fn for n, (fn, _) in fns.items()}


def forward(cuda, fn, q, k, v, causal=True, q_off=0, k_off=0):
    """(o, m, l) of a variant's C entry on [B, S, H, d] tensors (as the
    package's wrapper calls it: the logits scaled by 1/sqrt(d))."""
    import torch
    from horovod_tpu_torch.parallel import flash_attention as fa
    b, sq, h, d = q.shape
    o, m, l = fa._fwd_outputs(q)
    dtype = {torch.bfloat16: 1, torch.float16: 2}[q.dtype]
    cuda.check(fn(dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  o.data_ptr(), m.data_ptr(), l.data_ptr(), b, h, sq,
                  k.shape[1], d, q_off, k_off, int(causal),
                  fa._softmax_scale(d),
                  torch.cuda.current_stream().cuda_stream),
               "variant forward")
    return o, m, l


def package_report(log, kernel="flash_fwd_sm90"):
    """[problem] of the package's ``kernel`` instances in ptxas' output:
    spills and serialized wgmmas (none is allowed)."""
    bad, entry = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '(\w+)'", line)
        if m:
            entry = m.group(1) if kernel in m.group(1) else None
        elif "serialized" in line:
            bad.append(line.strip())
        elif entry and re.search(r"[1-9]\d* bytes spill", line):
            bad.append(f"{entry}: {line.strip()}")
    return bad


def trace(cuda) -> None:
    """Builds the package's source with TRACE's marks and prints CTA 0's
    tiles 1-3 (past the first's start-up), per consumer, in SM cycles."""
    import ctypes
    import statistics
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import narrow_variants
    fn = narrow_variants.build(cuda, {"trace": (SOURCE, TRACE)}, ENTRIES,
                               SUBDIR, "flash_fwd_sm90")["trace"][0]
    lib = ctypes.CDLL(os.path.join(cuda.BUILD_DIR, SUBDIR, "trace",
                                   "lib.so"))
    read = lib.hvdt_fwd_trace_read
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    for causal in (True, False):
        g = torch.Generator(device="cuda").manual_seed(SEED)
        q, k, v = (torch.randn(4, 2048, 16, 128, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        for _ in range(3):
            forward(cuda, fn, q, k, v, causal)
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (2 * 4 * 64))()
        cuda.check(read(buf), "trace read")
        print(f"main shape B4 S2048 H16 D128 bf16 causal={causal}: SM "
              f"cycles of CTA 0 (iteration: median of j = 1..12; turn / "
              f"issue to S done / S done to P V done / to the next)")
        for it in (1, 2, 3):
            for c in (0, 1):
                m = [buf[(c * 4 + it) * 64 + i] for i in range(64)]
                js = [j for j in range(1, 12)
                      if m[2 + 4 * j] and m[2 + 4 * (j + 1)]]
                it_len = [m[2 + 4 * (j + 1)] - m[2 + 4 * j] for j in js]
                part = [statistics.median(m[2 + 4 * j + e + 1] -
                                          m[2 + 4 * j + e] for j in js)
                        if js else 0 for e in range(3)]
                tail = [statistics.median(
                    m[2 + 4 * (j + 1)] - m[5 + 4 * j] for j in js)
                    if js else 0]
                print(f"  tile {it} consumer {c} nk {m[62]}: start "
                      f"{m[5] - m[0]} (Q {m[1] - m[0]}, K {m[2] - m[1]}, "
                      f"turn {m[3] - m[2]}, S {m[4] - m[3]}, softmax "
                      f"{m[5] - m[4]}); iteration "
                      f"{statistics.median(it_len) if it_len else 0} "
                      f"({' / '.join(str(x) for x in part + tail)}); last "
                      f"P V {m[56] - m[54]}, store {m[59] - m[56]}; tile "
                      f"{m[59] - m[0]}", flush=True)


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("fwd_sm90_variants: no CUDA device; this script runs on the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    if "--trace" in (sys.argv[1:] if argv is None else argv):
        from horovod_tpu_torch import _cuda
        _cuda.load()
        trace(_cuda)
        return 0
    import chip_smoke
    import torch.nn.functional as F
    from horovod_tpu_torch import _cuda
    from horovod_tpu_torch.parallel import flash_attention as fa
    from horovod_tpu_torch.utils import tolerance

    _cuda.load()
    logs = {}
    variants = build(_cuda, logs=logs)
    bad = package_report(logs["package"])
    if bad:
        raise AssertionError("the package's forward spills or serializes "
                             "its wgmmas:\n" + "\n".join(bad))
    card = chip_smoke.card_line()
    for label, b, s, h, d, dt in SHAPES:
        dtype = getattr(torch, dt)
        g = torch.Generator(device="cuda").manual_seed(SEED)
        q, k, v = (torch.randn(b, s, h, d, generator=g, device="cuda")
                   .to(dtype) for _ in range(3))
        o_p, m_p, l_p = fa._flash_fwd_plain(q, k, v, True, 0, 0)
        o_b = fa._flash_fwd_plain(q, k, v, True, 0, 0, operands=dtype)[0]
        step = tolerance.step_of(dtype)

        def mine():
            return fa._flash_fwd(q, k, v, True, 0, 0)
        ours = mine()
        serial = forward(_cuda, variants["serial"], q, k, v)
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(ours, serial)):
            raise AssertionError(f"{label}: the package differs from serial")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = chip_smoke.time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 20)
        flops = 4 * b * h * s * s * d // 2
        moved = 4 * b * s * h * d * q.element_size() + 2 * b * h * s * 4
        bound = max(flops / chip_smoke.PEAK_FLOPS[dt],
                    moved / chip_smoke.PEAK_BYTES_PER_S) * 1e3
        print(f"{label} B{b} S{s} H{h} D{d} {dt}: SDPA {sdpa:.4f} ms, "
              f"bound {bound:.4f} ms  [{card}]", flush=True)
        for name, fn in variants.items():
            theirs = tuple(x.clone() for x in forward(_cuda, fn, q, k, v))
            torch.cuda.synchronize()
            if not all(torch.equal(a, c) for a, c in zip(serial, theirs)):
                raise AssertionError(f"{label}: {name} differs from serial")
            ratio = max(
                tolerance.worst(theirs[0], o_p, 2e-5, step=step,
                                plain_b=o_b)[1],
                tolerance.worst(theirs[1], m_p, 2e-5, atol=1e-5,
                                rows=False)[1],
                tolerance.worst(theirs[2], l_p, 2e-5, rows=False)[1])
            if not ratio <= 1.0:
                raise AssertionError(f"{label}: {name} at {ratio:.3f} of "
                                     f"the bound")
            t = [chip_smoke.time_ms(f, 20) for f in (
                mine, lambda: forward(_cuda, fn, q, k, v),
                lambda: forward(_cuda, fn, q, k, v), mine)]
            pkg, var = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            print(f"  {name:<16}: package {t[0]:.4f} / {t[3]:.4f} ms "
                  f"({pkg / sdpa:.2f}x SDPA, {flops / pkg / 1e9:.0f} TFLOP/s,"
                  f" {bound / pkg:.1%} of the bound), variant {t[1]:.4f} / "
                  f"{t[2]:.4f} ms ({var / sdpa:.2f}x SDPA, "
                  f"{flops / var / 1e9:.0f} TFLOP/s), package "
                  f"{var / pkg:.3f}x faster (worst err/tol {ratio:.3f}, "
                  f"bit-equal to serial)", flush=True)
        del q, k, v, o_p, m_p, l_p, o_b, ours, serial, qt, kt, vt
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
