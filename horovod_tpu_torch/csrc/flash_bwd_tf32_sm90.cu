// Flash-attention backward for Hopper's tensor cores (sm_90a) in fp32:
// dq and dk/dv at every head dim past 32 (a multiple of 32; the wrapper
// zero-pads any other) through 3xTF32, the "tf32" design of both kernels.
//
// Replaces the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` (with
// the shared recompute `_recompute_p_ds`) in
// horovod_tpu/parallel/flash_attention.py, launched by `_flash_bwd_bhsd`,
// as flash_dq_sm90.cu and flash_dkv_sm90.cu do for bf16 and fp16 up to D
// 256 and flash_bwd_tf32_narrow_sm90.cu for fp32 D <= 32. Same function:
// for every visible (q, k) pair p = exp(s - lse) (lse = +inf on rows that
// saw no key, so p = 0 there) and ds = p (dp - delta) scale, recomputed
// from q, k, v, do and the forward's per-row lse and delta = rowsum(do *
// o); then dq = sum over k of ds k, dk = sum over q of ds^T q and dv = sum
// over q of p^T do, in fp32. Runtime offsets shift the causal mask;
// tiles wholly in the future are skipped; a CTA that sees no tile writes
// zeros.
//
// What bounds it on this card. At the fp32 main shape (B 4, S 2048, H 16,
// D 128, causal) dq takes three matrix products per visible pair (s, dp,
// ds k) and dk/dv four (s, dp, p^T do, ds^T q): 1.03e11 and 1.37e11
// operations, and 3xTF32 takes each product as three tf32 products, so
// 0.625 and 0.833 ms at 494.7 TFLOP/s dense tf32, against 0.05 ms for the
// 168 and 201 MB of inputs and outputs at 3.35 TB/s: the tensor cores are
// the limit. This design also reads the CTA's rows again from L2 for every
// tile and pays S and dP once per part of the output's head dim (below);
// which of those holds it back has not been measured (no ncu). The grid's
// order, measured by tools/bwd_tf32_variants.py (NVIDIA H100 80GB HBM3,
// 700 W): with b h fastest each co-resident CTA streamed its own head's planes,
// and the hi and lo planes of 64 heads far outgrow the 50 MB L2; one
// head's CTAs side by side share them: dq 1.79 against 2.69 ms, dk/dv
// 2.92 against 3.68 at the main shape, 1.85-1.90 / 3.24 against 1.93 /
// 3.68 at D 640. At D 256 (B 2, S 1024, H 8: 256 CTAs, two waves) b h
// fastest won (dq 0.39 against 0.48-0.53, dk/dv 0.63 against 0.71): its
// first wave holds every head's heaviest tiles. A third ring stage in
// place of the second T stage made dq 1-5% faster and dk/dv 5-13% slower.
//
// Numerics, as the tf32 forward (flash_fwd_stream_sm90.cu): each fp32 x is
// split into hi = tf32(x) and lo = tf32(x - hi), and every product (S,
// dP and the output's) is taken as lo.hi + hi.lo + hi.hi in tf32 wgmmas
// (m64nNk8) with fp32 accumulators; the dropped lo.lo term is below 2^-22
// of the product. The tensor cores add into their accumulator without
// rounding to nearest, so one chain over all of D or all of a sequence
// drifts (the forward's one-chain build put o at 1.35 of the fp32 bound:
// tools/tf32_chains.py), and dq, dk and dv each sum over up to 2048
// terms. So each region's S and dP, and each tile's output product, goes
// to an accumulator of its own, the small products first, and those are
// summed by fp32 adds. P and dS are split in registers after the softmax;
// dS is computed from the unrounded P.
//
// Layout: tf32 wgmma has no transpose bit, both operands are K-major.
// S = Q K^T and dP = dO V^T (dq), S^T = K Q^T and dP^T = V dO^T (dk/dv)
// reduce over D and read [B, S, H, D] as it stands. The output products
// reduce over the sequence: dq += dS K needs K^T, dk += dS^T Q needs Q^T,
// dv += P^T dO needs dO^T, each with the sequence contiguous. One pre-pass
// per backward (hvdt_flash_bwd_tf32_split: sm90_common.cuh's
// tf32_bwd_split_all, one launch), which both kernels read (and the narrow
// builds of flash_bwd_tf32_narrow_sm90.cu), writes 14 planes into scratch
// the wrapper allocates: q, do, k, v hi and lo in [B, S, H, D], and K^T,
// Q^T, dO^T hi and lo as [B, H, D, S rounded up to 64] (zero past S, the
// rows of every 8 permuted so that the accumulator fragment of dS, P^T or
// dS^T is wgmma's register A operand with no shuffle). At the fp32 main
// shape each plane is 67.1 MB: 0.94 GB written and 0.27 GB read.
//
// Design. One template serves both kernels. A CTA owns kRows = 128 rows
// (queries for dq, keys for dk/dv; two consumer warpgroups of 64, wgmma's
// M) and one part of the output's head dim (kOut columns), and walks the
// tiles of kTile = 64 rows of the other sequence that it can see. The
// grid is (row tiles x parts, B H): blockIdx.x runs over one head's CTAs,
// heaviest causal rows first (the last q tiles for dq, the first kv tiles
// for dk/dv), the parts of a row tile side by side. Three warpgroups:
// - a producer, which gives its registers away (setmaxnreg); one thread
//   issues every copy as a TMA load: per tile, first the T stage (the
//   transposed factor of the output products for the CTA's columns, and
//   for dk/dv the tile's lse and delta, which the producer warp's lanes
//   write), then the ring: for S, then for dP, D / 32 stages of one
//   128-byte column region each, [128 rows][32] of the CTA's operand (Q
//   or dO; K or V) and [64][32] of the tile's (K or V; Q or dO), hi and lo;
// - two consumers, each owning 64 rows: per tile, S summed over the
//   regions (12 m64n64k8 wgmmas a region into a fresh accumulator), then
//   P (masked only on tiles that cross the diagonal or a ragged end: TMA
//   zero-fills rows past S and the p of a zero score is not zero), then
//   dP the same way and dS = P (dP - delta) scale; then the output
//   products from registers, 24 wgmmas (m64, n kOut, k8) each into a fresh
//   accumulator: dq += dS K^T; dv += P^T dO^T, then dk += dS^T Q^T. A
//   tile wholly in the future of a warpgroup's 64 rows is waited for and
//   released without a product.
// Each CTA owns its output rows and columns: no atomics, no second pass.
//
// Shared memory (the same for any D): a ring stage holds the CTA's region
// hi and lo, 2 x 128x32x4 = 32,768 B, and the tile's, 2 x 64x32x4 =
// 16,384 B: 49,152 B; a T stage holds K^T hi and lo for 128 columns of D
// (dq: 2 x 128x64x4) or Q^T and dO^T hi and lo for 64 (dk/dv: 4 x
// 64x64x4): 65,536 B; 2 + 2 stages = 229,376 B, plus dk/dv's lse and
// delta (2 stages x 2 x 64 x 4 = 1,024 B), the barriers (64 B) and the
// 1 KB alignment pad: 230,464 B (dq) and 231,488 B (dk/dv) of 232,448.
// Registers of a consumer thread (setmaxnreg gives 240): dq holds dQ 64,
// S (then P) 32, dP (then dS) 32 and a region's product 32 while dP is
// summed, then dQ 64 + the tile's product 64 + dS hi 32 + dS lo 32 = 192
// at the output product (ptxas spills 96 bytes of it). The 64-column
// dk/dv build holds dK 32 + dV 32 + P 32 + dS 32 + the split's hi 32 +
// the tile's product 32 = 192. Its parts pay S and dP once each: at D 128
// dq does the function's three products and dk/dv 2 x 2 + 2 = 6 of its
// 4; at D 640, 5 x 2 + 1 of 3 and 10 x 2 + 2 of 4.
//
// The wide dk/dv build (flash_dkv_tf32_wide, fp32 past D kWideAbove =
// 128): parts of 128 columns of dK and dV (D 640: five; D 160: 128 + 32,
// the last part's columns past D neither loaded, multiplied nor stored),
// so S^T and dP^T are paid once per 128 columns, half as often: at D 640
// 5 x 2 + 2 = 12 products of the function's 4 (22 in 64-column parts),
// at D 512 10 (18), at D 256 6 (10). The ring, its regions and its order
// are the 64-column build's. A consumer holds dK and dV for its 64 keys
// and 128 columns, 128 registers, so that only S (or dP) and a region's
// product fit beside them (192); so P^T and dS^T go to the tensor cores
// from shared memory, as the wide forward's P does:
// - per tile, S^T, then P (registers) split into hi and lo planes of the
//   consumer's own X buffer, [64 keys][64 queries] each, two K-major
//   regions of [64][32] in the 128-byte swizzle, the queries of every 8
//   in the order in which the pre-pass stores Q^T's and dO^T's rows
//   (store_x), behind a named barrier of the warpgroup and a proxy fence;
// - dV += P^T dO in 64-column pieces (kPiece), each into a fresh
//   32-register accumulator folded into its columns of dV by fp32 adds,
//   A (P^T) and B (a dO^T piece, hi and lo, 32 KB) both from shared
//   memory (m64n64k8: lo.hi and hi.lo, then hi.hi, the k steps of
//   reg_product); the dO^T pieces come through a ring of two T stages;
// - P parked, unrounded, in the X hi plane (each thread its own 32
//   words), dP^T summed, P taken back, dS = P (dP - delta) scale split
//   into the X planes, and dK += dS^T Q from Q^T pieces the same way.
// The per-column sums run in the 64-column build's order (the same region
// accumulators, the same k steps of a 64-column product, the same tile
// order), so dk and dv are its bit for bit (tools/bwd_tf32_variants.py and
// the card tests check it). The producer (one thread) issues per tile the
// ring pass of S, the tile's dO^T pieces, the ring pass of dP and its
// Q^T pieces, the order in which the consumers take them; each consumer
// loads the tile's lse and delta itself (64 threads one row each, before S
// is summed) into its own copy in shared memory. Shared memory: 2 ring
// stages, 98,304 B; X hi and lo of both consumers, 2 x 2 x 64x64x4 =
// 65,536 B; 2 T stages of a piece hi and lo, 2 x 2 x 64x64x4 = 65,536 B;
// the stats, 2 x 2 x 64 x 4 = 1,024 B: 230,400 B (231,488 with 64 B of
// barriers and the 1 KB pad, of 232,448). Registers: ptxas reports no
// spill for the wide build; it did, 400 bytes of dK, dV and descriptors,
// until the consumer became a template on its warpgroup (its X planes'
// addresses, and the wgmma descriptors built on them, then sit in uniform
// registers) and the CTA's place (its head, first key and first column,
// which thread 0 works out into shared memory) was read anew in each tile
// rather than kept live across the tile loop. Its grid is head-major in
// groups of heads (kHeadGroups): a group holds about one wave of CTAs
// (ceil(SMs / a head's CTAs) heads) and runs its heaviest row tiles
// first, so that the last CTAs to start are light ones; one head at a time
// the heaviest CTA of the last heads started last and its tail cost up to
// 1.31x at B 2, S 1024, H 8 (D 160), while b h fastest, every head's
// heaviest first, lost 1.31x with 64 heads (L2; PERF.md).
// Its times against the 64-column build: tools/bwd_tf32_variants.py and
// PERF.md (at D 128 the wide build was no faster, so it starts past 128).
//
// The split design (flash_dkv_tf32_split, kSplitByOutput; built and
// timed by tools/bwd_tf32_variants.py, not run by the package): a CTA owns
// 64 keys and 256 columns; consumer 0 sums S^T from a ring of its own (K
// and Q regions), makes P, hands it over unrounded through shared memory
// (each thread its 32 words: both consumers hold the same fragment of the
// tile) and makes dV += P^T dO; consumer 1 sums dP^T from its ring (V and
// dO), takes P (each p read just before its use) and makes dS and dK +=
// dS^T Q. Each holds 128 registers of output, the product's A operand
// split in registers (reg_product, 32 columns a product into a fresh
// 16-register accumulator: 208 at the product), and the T pieces (32
// columns, 16 KB) come through a 2-stage ring per consumer: 2 x 2 ring
// stages of 32 KB, the hand-over 16 KB, 2 x 2 T stages of 16 KB, the
// stats (1 KB) and 18 barriers: 215,184 B with the pad (ptxas spills 32
// bytes of loop scalars). S^T and dP^T are paid once per 256
// columns (D 640: 3 x 2 + 2 products of the function's 4, against the
// wide build's 12), and its dk and dv are the wide build's bit for bit.
// Timed against the wide build (PERF.md, same card) it is faster where a
// part's T pieces are few beside its regions (C4 shape D 512 and 640, and
// D 160, one part against two) and slower at D 256-384 and with 64 heads,
// where its eight T pieces a tile wait on their loads: the geometric mean
// over the tool's seven shapes past D 128 is 1.02 of the wide build's, so
// the package runs the wide build. Its T pieces through the consumers' own
// rings (three stages of 32 KB each, every stage a region or a 64-column
// piece) were faster at D 256 and slower at D 640 and with 64 heads.
#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace hvdt {
namespace {

using namespace sm90;

constexpr int kRows = 128;   // rows of a CTA: queries (dq) or keys (dk/dv)
constexpr int kTile = 64;    // rows of a tile: keys (dq) or queries (dk/dv)
constexpr int kCols = 32;    // fp32 columns of a 128-byte region
constexpr int kStages = 2;   // ring stages
constexpr int kStagesT = 2;  // T stages
// the transposed planes' rows: S rounded up
constexpr int kSeqPad = kTf32BwdSeqPad;
constexpr int kConsumerRegs = 240;
// The grid's order: one head's CTAs side by side (see the header).
// tools/bwd_tf32_variants.py builds this file with false (b h fastest) to
// measure why.
constexpr bool kHeadMajor = true;
// dk/dv: head dims past this take the wide build (128-column parts, P^T
// and dS^T through shared memory), the others the 64-column build.
// tools/bwd_tf32_variants.py builds this file with no wide build at all,
// and with the wide build past 64.
constexpr int kWideAbove = 128;
// dk/dv past kWideAbove: the consumers split by rows (false: the wide
// build) or by output (true: the split design, 256-column parts).
// tools/bwd_tf32_variants.py builds this file with true.
constexpr bool kSplitByOutput = false;
// The wide build's head-major grid: heads taken in groups of about one
// wave of CTAs, each group's heaviest row tiles first (true), or one
// head's CTAs after another (false). tools/bwd_tf32_variants.py builds
// this file with false.
constexpr bool kHeadGroups = true;

// The tensor maps of one kernel: the ring's operands of S (pass 0) and dP
// (pass 1), the CTA's rows (a) and the tile's (b), and the T stage's
// transposed factors: [0] that of dS (K^T for dq, Q^T for dk/dv), [1]
// that of P^T (dO^T, dk/dv only); each as [hi, lo].
struct Maps {
  CUtensorMap a[2][2], b[2][2], t[2][2];
};

// The ring of the 128-row builds (dq and both dk/dv builds): a stage
// holds one 128-byte column region of the CTA's rows and of the tile's,
// hi and lo (the split design's rings hold 64 rows of the CTA's).
struct Ring {
  static constexpr int kRegionA = kRows * 128;  // [128][32] fp32
  static constexpr int kRegionB = kTile * 128;  // [64][32] fp32
  static constexpr int kStage = 2 * (kRegionA + kRegionB);
  static constexpr int kBytes = kStages * kStage;  // at the start of smem
};

template <bool kDkv>
struct BwdShape {
  static constexpr int kOut = kDkv ? 64 : 128;  // output columns of a CTA
  static constexpr int kOps = kDkv ? 2 : 1;     // transposed factors
  // One plane of a T stage: kTile / 32 regions of [kOut][32].
  static constexpr int kPlaneT = kTile * kOut * 4;
  static constexpr int kStageT = 2 * kOps * kPlaneT;
  static constexpr int kT = Ring::kBytes;
  static constexpr int kStats = kT + kStagesT * kStageT;  // lse, delta
  static constexpr int kBar = kStats + (kDkv ? kStagesT * 2 * kTile * 4 : 0);
  // full and empty per ring stage, t_full and t_empty per T stage
  static constexpr int kBytes = kBar + 8 * 2 * (kStages + kStagesT);
  static_assert(kBytes + 1024 <= 232448,
                "tf32 backward tiles exceed shared memory");
  // fp32 registers of a consumer thread at its peak, the output product:
  // the outputs, the tile's product, the split operand's hi and lo, and
  // for dk/dv the other operand (dS while dV takes P); the rest of the
  // 240 holds addresses, stats and loop state.
  static constexpr int kPeakRegs =
      kOps * kOut / 2 + kOut / 2 + 2 * (kTile / 2) + (kOps - 1) * kTile / 2;
  static_assert(kPeakRegs <= 192, "tf32 backward accumulators exceed the "
                "consumer registers");
  static_assert(kTile % kCols == 0 && kOut % 8 == 0, "tile shapes");
};

// The wide dk/dv build's tiles and shared memory (see the header).
struct WideDkv {
  static constexpr int kOut = 128;    // columns of dK and dV a CTA owns
  static constexpr int kPiece = 64;   // columns of one output product
  static constexpr int kPieces = kOut / kPiece;
  static constexpr int kStagesT = 2;  // T pieces in flight
  static constexpr int kRegionX = 64 * 128;       // [64 keys][32 queries]
  static constexpr int kPlaneX = 64 * kTile * 4;  // a consumer's P^T or
                                                  // dS^T, hi or lo
  static constexpr int kRegionT = kPiece * 128;   // [64 columns][32 queries]
  static constexpr int kPlaneT = kPiece * kTile * 4;  // a piece, hi or lo
  static constexpr int kStageT = 2 * kPlaneT;
  static constexpr int kX = Ring::kBytes;
  static constexpr int kT = kX + 2 * 2 * kPlaneX;
  // Each consumer's copy of the tile's lse and delta.
  static constexpr int kStats = kT + kStagesT * kStageT;
  static constexpr int kBar = kStats + 2 * 2 * kTile * 4;
  // full and empty per ring stage and per T stage, then the CTA's place
  static constexpr int kPlace = kBar + 8 * 2 * (kStages + kStagesT);
  static constexpr int kBytes = kPlace + 16;
  static_assert(kBytes + 1024 <= 232448,
                "wide tf32 dk/dv tiles exceed shared memory");
  static_assert(kX % 1024 == 0 && kT % 1024 == 0 && kPlaneX % 1024 == 0 &&
                    kRegionT % 1024 == 0,
                "swizzled regions start on 1024-byte boundaries");
  // Both dk/dv builds read the transposed factors through one tensor
  // map's boxes of 64 rows of D.
  static_assert(kPiece == BwdShape<true>::kOut, "T boxes of both builds");
  // A park of P (a consumer thread's 32 values) fits one X plane.
  static_assert(128 * (kTile / 2) * 4 == kPlaneX, "P's park");
};

// The first q tile that keys row_start .. row_start + kRows - 1 see: q
// tile u sees the CTA's first key once q_off + 64 u + 63 >= its position.
__device__ __forceinline__ int dkv_first_tile(int row_start, int q_off,
                                              int k_off, int causal,
                                              int tiles) {
  if (!causal) return 0;
  const long long need = (long long)k_off + row_start - q_off - (kTile - 1);
  return need <= 0 ? 0
                   : (int)min((long long)tiles, (need + kTile - 1) / kTile);
}

// The producer's ring pass of one tile into the ring at `ring` (S's
// operands or dP's): D / 32 stages, each [kRowsA rows][32] of the CTA's
// operand (map a) and [64][32] of the tile's (map bm), hi and lo. `n`
// counts the ring stages issued.
template <int kRowsA = kRows>
__device__ __forceinline__ void issue_ring_pass(
    uint8_t* ring, const CUtensorMap (&a)[2], const CUtensorMap (&bm)[2],
    uint64_t* full, uint64_t* empty, int& n, int D, int h, int b,
    int row_start, int tile0) {
  constexpr int kRegionA = kRowsA * 128, kRegionB = Ring::kRegionB;
  constexpr int kStage = 2 * (kRegionA + kRegionB);
  for (int col = 0; col < D; col += kCols, ++n) {
    const int s = n % kStages;
    // Stage s is free once the consumers released load n - 2.
    if (n >= kStages) bar_wait(&empty[s], ((n / kStages) & 1) ^ 1);
    uint8_t* stage = ring + s * kStage;
    bar_arrive_tx(&full[s], kStage);
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
      tma_load_4d(stage + pl * kRegionA, &a[pl], &full[s], col, h,
                  row_start, b);
      tma_load_4d(stage + 2 * kRegionA + pl * kRegionB, &bm[pl], &full[s],
                  col, h, tile0, b);
    }
  }
}

// dk/dv: the producer warp's lanes write one tile's lse (pre-scaled by
// log2 e; +inf past Sq, so that p is 0 there) and delta into `st`,
// [lse 64][delta 64].
__device__ __forceinline__ void write_stats(float* st, const float* lse,
                                            const float* delta, int bh,
                                            int Sq, int tile0, int lane) {
  for (int i = lane; i < kTile; i += 32) {
    const int row = tile0 + i;
    st[i] = row < Sq ? lse[(size_t)bh * Sq + row] * kLog2e
                     : __int_as_float(0x7f800000);
    st[kTile + i] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
  }
}

// Sums A_r B_r^T over the D / 32 regions of one ring pass, each region's
// 12 products (lo.hi and hi.lo, then hi.hi, four k steps each) in an
// accumulator of its own, the regions summed by fp32 adds. The ring at
// `ring` holds per stage the CTA's region ([kRowsA][32] hi and lo; this
// warpgroup's 64 rows from a_off) and the tile's ([64][32] hi and lo).
// `n` counts the ring stages consumed. A warpgroup whose rows do not see
// the tile (`live` false) waits for each stage and releases it without a
// product.
template <int kRowsA = kRows>
__device__ __forceinline__ void ring_sum(float (&out)[kTile / 2],
                                         uint32_t ring, uint64_t* full,
                                         uint64_t* empty, int& n, int D,
                                         uint32_t a_off, bool live,
                                         int lane) {
  constexpr uint32_t kRegionA = kRowsA * 128, kRegionB = Ring::kRegionB;
  for (int col = 0; col < D; col += kCols, ++n) {
    const int st = n % kStages;
    const uint32_t stage = ring + st * 2 * (kRegionA + kRegionB);
    const uint32_t a = stage + a_off;  // this warpgroup's 64 rows
    const uint32_t b = stage + 2 * kRegionA;
    bar_wait(&full[st], (n / kStages) & 1);
    if (live) {
      float part[kTile / 2];
      fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_tf32_ss<kTile>(part, desc_sw128(a + kRegionA + 32 * kk, 16),
                             desc_sw128(b + 32 * kk, 16), kk > 0);
        wgmma_tf32_ss<kTile>(part, desc_sw128(a + 32 * kk, 16),
                             desc_sw128(b + kRegionB + 32 * kk, 16), 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_tf32_ss<kTile>(part, desc_sw128(a + 32 * kk, 16),
                             desc_sw128(b + 32 * kk, 16), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int e = 0; e < kTile / 2; ++e)
        out[e] = col > 0 ? out[e] + part[e] : part[e];
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[st]);
  }
}

// P in place of S on a consumer thread's fragment: p = exp2(s scale log2 e
// - l2), l2 the pre-scaled lse of the row (dq: lse_r[i]) or of the tile
// row (dk/dv: st_lse), masked only where `masked` (tiles that cross the
// diagonal or a ragged end: TMA zero-fills rows past S and the p of a
// zero score is not zero). The thread's rows sit at global positions pos
// and pos + 8, its tile rows tc = 8 (e / 4) + col + e % 2 at tpos0 + tc,
// of which those below `tile_left` exist.
template <bool kDkv>
__device__ __forceinline__ void p_in_place(float (&s)[kTile / 2],
                                           const float* st_lse,
                                           const float (&lse_r)[2],
                                           bool masked, int pos, int tpos0,
                                           int tile_left, int causal,
                                           int col, float scale_log2) {
#pragma unroll
  for (int e = 0; e < kTile / 2; ++e) {
    const int i = (e / 2) % 2;
    const int tc = 8 * (e / 4) + col + e % 2;  // row of the tile
    const float l2 = kDkv ? st_lse[tc] : lse_r[i];
    float p = exp2f(fmaf(s[e], scale_log2, -l2));
    if (masked) {
      const int rpos = pos + 8 * i, tpos = tpos0 + tc;
      const bool ok = tc < tile_left &&
                      (!causal || (kDkv ? tpos >= rpos : rpos >= tpos));
      p = ok ? p : 0.f;
    }
    s[e] = p;
  }
}

// dS = P (dP - delta) scale in place of dP, delta that of the row (dq:
// delta_r[i]) or of the tile row (dk/dv: st_delta).
template <bool kDkv>
__device__ __forceinline__ void ds_in_place(float (&dp)[kTile / 2],
                                            const float (&p)[kTile / 2],
                                            const float* st_delta,
                                            const float (&delta_r)[2],
                                            int col, float scale) {
#pragma unroll
  for (int e = 0; e < kTile / 2; ++e) {
    const int tc = 8 * (e / 4) + col + e % 2;
    const float dl = kDkv ? st_delta[tc] : delta_r[(e / 2) % 2];
    dp[e] = p[e] * (dp[e] - dl) * scale;
  }
}

// out = X Y over the tile's kTile rows in 3xTF32, X given as the
// accumulator fragment of a [64][kTile] tile split into hi and lo, Y^T
// the T stage's plane at y (hi) and y_lo: kTile / 32 regions of
// [N][128 B], its rows permuted within every 8 as tf32_split_t stores
// them, so that this thread's columns 2t, 2t + 1 of each 8 go in as A
// columns t, t + 4.
template <int N>
__device__ __forceinline__ void reg_product(float (&out)[N / 2],
                                            uint32_t (&hi)[kTile / 2],
                                            float (&lo)[kTile / 2],
                                            uint32_t y, uint32_t y_lo) {
  fence_regs(out);
  fence_regs(hi);
  fence_regs(lo);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTile / 8; ++kk) {
    const uint32_t ah[4] = {hi[4 * kk], hi[4 * kk + 2], hi[4 * kk + 1],
                            hi[4 * kk + 3]};
    const uint32_t al[4] = {
        __float_as_uint(lo[4 * kk]), __float_as_uint(lo[4 * kk + 2]),
        __float_as_uint(lo[4 * kk + 1]), __float_as_uint(lo[4 * kk + 3])};
    const uint32_t off = (kk / 4) * N * 128 + (kk % 4) * 32;
    wgmma_tf32_rs<N>(out, al, desc_sw128(y + off, 16), kk > 0);
    wgmma_tf32_rs<N>(out, ah, desc_sw128(y_lo + off, 16), 1);
  }
#pragma unroll
  for (int kk = 0; kk < kTile / 8; ++kk) {
    const uint32_t ah[4] = {hi[4 * kk], hi[4 * kk + 2], hi[4 * kk + 1],
                            hi[4 * kk + 3]};
    const uint32_t off = (kk / 4) * N * 128 + (kk % 4) * 32;
    wgmma_tf32_rs<N>(out, ah, desc_sw128(y + off, 16), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(out);
  fence_regs(hi);
  fence_regs(lo);
}

// kDkv false: dq (out0 = dq). kDkv true: dk/dv (out0 = dk, out1 = dv),
// the 64-column build.
template <bool kDkv>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_tf32(const __grid_constant__ Maps maps,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ out0,
                   float* __restrict__ out1, int H, int Sq, int Sk, int D,
                   int q_off, int k_off, int causal, float scale) {
  using Sh = BwdShape<kDkv>;
  constexpr int kOut = Sh::kOut;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Sh::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* t_full = empty + kStages;
  uint64_t* t_empty = t_full + kStagesT;

  // The CTA's (row tile, part) index runs fastest, so that the CTAs that
  // stream the same K and V (dq) or Q and dO (dk/dv) run together and find
  // them in L2.
  const int bh = kHeadMajor ? blockIdx.y : blockIdx.x;
  const int cta = kHeadMajor ? blockIdx.x : blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int nparts = (D + kOut - 1) / kOut;
  const int c0 = (cta % nparts) * kOut;  // its first output column
  const int row_tile = cta / nparts;
  // The CTA's first row, its rows' and its tiles' offsets and lengths, and
  // the tiles [u0, u1) it sees.
  const int rows_off = kDkv ? k_off : q_off, tile_off = kDkv ? q_off : k_off;
  const int rows_len = kDkv ? Sk : Sq, tile_len = kDkv ? Sq : Sk;
  int row_start, u0 = 0, u1 = (tile_len + kTile - 1) / kTile;
  if constexpr (kDkv) {
    row_start = row_tile * kRows;
    u0 = dkv_first_tile(row_start, q_off, k_off, causal, u1);
  } else {
    row_start = ((rows_len + kRows - 1) / kRows - 1 - row_tile) * kRows;
    if (causal) {
      // kv tile u is visible while k_off + 64 u <= q_off + row_start + 127.
      const long long reach = (long long)q_off + row_start + kRows - 1 - k_off;
      u1 = min(u1, reach < 0 ? 0 : (int)(reach / kTile) + 1);
    }
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < kStagesT; ++s) {
      bar_init(&t_full[s], kDkv ? 32 : 1);  // dk/dv: the producer warp
      bar_init(&t_empty[s], 8);
    }
    bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: thread 0 issues the copies; for dk/dv its warp's lanes
    // write each T stage's lse and delta.
    regs_dec<24>();
    if (threadIdx.x < (kDkv ? 32 : 1)) {
      const int lane = threadIdx.x;
      int n = 0;  // ring stages issued so far
      for (int u = u0; u < u1; ++u) {
        const int m = u - u0, st = m % kStagesT, tile0 = u * kTile;
        if (m >= kStagesT) bar_wait(&t_empty[st], ((m / kStagesT) & 1) ^ 1);
        if constexpr (kDkv)
          write_stats(reinterpret_cast<float*>(smem + Sh::kStats) +
                          st * 2 * kTile,
                      lse, delta, bh, Sq, tile0, lane);
        if (lane == 0) {
          uint8_t* tt = smem + Sh::kT + st * Sh::kStageT;
          bar_arrive_tx(&t_full[st], Sh::kStageT);
#pragma unroll
          for (int o = 0; o < Sh::kOps; ++o)
#pragma unroll
            for (int pl = 0; pl < 2; ++pl)
#pragma unroll
              for (int rr = 0; rr < kTile / kCols; ++rr)
                tma_load_4d(tt + (2 * o + pl) * Sh::kPlaneT + rr * kOut * 128,
                            &maps.t[o][pl], &t_full[st], tile0 + rr * kCols,
                            c0, h, b);
#pragma unroll
          for (int pass = 0; pass < 2; ++pass)
            issue_ring_pass(smem, maps.a[pass], maps.b[pass], full, empty,
                            n, D, h, b, row_start, tile0);
        } else {
          bar_arrive(&t_full[st]);
        }
        if constexpr (kDkv) __syncwarp();
      }
    }
  } else {
    // Consumers: warpgroup c owns rows 64c .. 64c + 63 of the CTA.
    regs_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row0 = 64 * c + 16 * (t / 32) + lane / 4;  // +8 for i = 1
    const int col = 2 * (lane % 4);  // the tile rows of each 8 it holds
    const int first_pos = rows_off + row_start + 64 * c;
    const float scale_log2 = scale * kLog2e;

    // dq: the rows' lse (pre-scaled by log2 e) and delta; rows past Sq get
    // lse = +inf, so their p is exactly 0.
    float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
    if constexpr (!kDkv) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row_start + row0 + 8 * i;
        lse_r[i] = row < Sq ? lse[(size_t)bh * Sq + row] * kLog2e
                            : __int_as_float(0x7f800000);
        delta_r[i] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
      }
    }

    float acc0[kOut / 2], acc1[kDkv ? kOut / 2 : 1];
#pragma unroll
    for (int e = 0; e < kOut / 2; ++e) acc0[e] = 0.f;
#pragma unroll
    for (int e = 0; e < (kDkv ? kOut / 2 : 1); ++e) acc1[e] = 0.f;

    int n = 0;  // ring stages consumed so far
    for (int u = u0; u < u1; ++u) {
      const int m = u - u0, st = m % kStagesT, tile0 = u * kTile;
      // Whether the warpgroup's rows see any of the tile, and whether some
      // pair of the tile is hidden (the diagonal or a ragged end).
      bool live = true, masked = tile0 + kTile > tile_len;
      if (causal) {
        if constexpr (kDkv) {
          live = q_off + tile0 + kTile - 1 >= first_pos;
          masked = masked || q_off + tile0 < first_pos + 63;
        } else {
          live = k_off + tile0 <= first_pos + 63;
          masked = masked || k_off + tile0 + kTile - 1 > first_pos;
        }
      }

      float s[kTile / 2];
      ring_sum(s, smem_u32(smem), full, empty, n, D, c * 64 * 128, live,
               lane);
      bar_wait(&t_full[st], (m / kStagesT) & 1);
      const float* st_lse =
          reinterpret_cast<const float*>(smem + Sh::kStats) + st * 2 * kTile;
      if (live)
        p_in_place<kDkv>(s, st_lse, lse_r, masked,
                         rows_off + row_start + row0, tile_off + tile0,
                         tile_len - tile0, causal, col, scale_log2);
      float dp[kTile / 2];
      ring_sum(dp, smem_u32(smem), full, empty, n, D, c * 64 * 128, live,
               lane);
      if (live) {
        ds_in_place<kDkv>(dp, s, st_lse + kTile, delta_r, col, scale);
        const uint32_t tt = smem_u32(smem + Sh::kT + st * Sh::kStageT);
        uint32_t hi[kTile / 2];
        float part[kOut / 2];
        if constexpr (kDkv) {
          // dV += P^T dO, from dO^T (the T stage's second factor).
          split_tf32(s, hi);
          reg_product<kOut>(part, hi, s, tt + 2 * Sh::kPlaneT,
                            tt + 3 * Sh::kPlaneT);
#pragma unroll
          for (int e = 0; e < kOut / 2; ++e) acc1[e] += part[e];
        }
        // dQ += dS K (from K^T), or dK += dS^T Q (from Q^T).
        split_tf32(dp, hi);
        reg_product<kOut>(part, hi, dp, tt, tt + Sh::kPlaneT);
#pragma unroll
        for (int e = 0; e < kOut / 2; ++e) acc0[e] += part[e];
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&t_empty[st]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_start + row0 + 8 * i;
      if (row >= rows_len) continue;
      const size_t off = ((size_t)(b * rows_len + row) * H + h) * D + c0 + col;
#pragma unroll
      for (int jj = 0; jj < kOut / 8; ++jj) {
        if (c0 + col + 8 * jj >= D) continue;
        store2<float>(out0 + off + 8 * jj, acc0[4 * jj + 2 * i],
                      acc0[4 * jj + 2 * i + 1]);
        if constexpr (kDkv)
          store2<float>(out1 + off + 8 * jj, acc1[4 * jj + 2 * i],
                        acc1[4 * jj + 2 * i + 1]);
      }
    }
  }
}

// ---- the wide dk/dv build -------------------------------------------------

// This consumer thread's fragment of P^T or dS^T (keys r16, r16 + 8 of
// the consumer's 64; queries 2 t4, 2 t4 + 1 of every 8) split into hi =
// tf32(x) and lo = tf32(x - hi), written to the consumer's X planes: each
// [64 keys][64 query positions] as two K-major regions of [64][32] in the
// 128-byte swizzle (element (r, p) of a region at byte r * 128 + ((p / 4)
// ^ (r % 8)) * 16 + (p % 4) * 4), queries 8g + 2 t4 and 8g + 2 t4 + 1 at
// positions 8g + t4 and 8g + 4 + t4: the order in which the pre-pass
// stores the rows of Q^T and dO^T, and in which reg_product feeds the
// register fragment. A warp's 32 stores of one e fall on 32 distinct
// banks.
__device__ __forceinline__ void store_x(const float (&x)[kTile / 2],
                                        uint32_t hi, uint32_t lo, int r16,
                                        int t4) {
#pragma unroll
  for (int e = 0; e < kTile / 2; ++e) {
    const int g = e / 4, r = r16 + 8 * ((e / 2) % 2);
    const int chunk = 2 * (g % 4) + e % 2;  // the 16-byte chunk, unswizzled
    const uint32_t byte = (g / 4) * WideDkv::kRegionX + r * 128 +
                          ((chunk ^ (r % 8)) << 4) + t4 * 4;
    const float h = tf32_round(x[e]);
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(hi + byte), "f"(h)
                 : "memory");
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(lo + byte),
                 "f"(tf32_round(x[e] - h))
                 : "memory");
  }
}

// P parked while dP is summed: this thread's 32 values at its own slots
// of an X plane (value e of thread t at word 128 e + t), read back by the
// same thread.
__device__ __forceinline__ void park(const float (&x)[kTile / 2],
                                     uint32_t plane, int t) {
#pragma unroll
  for (int e = 0; e < kTile / 2; ++e)
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(plane + (128 * e + t) * 4),
                 "f"(x[e])
                 : "memory");
}
__device__ __forceinline__ void unpark(float (&x)[kTile / 2], uint32_t plane,
                                       int t) {
#pragma unroll
  for (int e = 0; e < kTile / 2; ++e)
    asm volatile("ld.shared.f32 %0, [%1];\n"
                 : "=f"(x[e])
                 : "r"(plane + (128 * e + t) * 4)
                 : "memory");
}

// out = X Y for kPiece columns in 3xTF32, both factors from shared
// memory: X (P^T or dS^T: hi at x, lo at x_lo; two regions of [64][32])
// as the A operand, Y^T (a T piece: y, y_lo; two regions of [kPiece][32])
// as B; lo.hi and hi.lo first, then hi.hi, one k8 step per 8 query
// positions, as reg_product; waits for the products.
__device__ __forceinline__ void x_product(float (&out)[WideDkv::kPiece / 2],
                                          uint32_t x, uint32_t x_lo,
                                          uint32_t y, uint32_t y_lo) {
  using W = WideDkv;
  fence_regs(out);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTile / 8; ++kk) {
    const uint32_t ox = (kk / 4) * W::kRegionX + (kk % 4) * 32;
    const uint32_t oy = (kk / 4) * W::kRegionT + (kk % 4) * 32;
    wgmma_tf32_ss<W::kPiece>(out, desc_sw128(x_lo + ox, 16),
                             desc_sw128(y + oy, 16), kk > 0);
    wgmma_tf32_ss<W::kPiece>(out, desc_sw128(x + ox, 16),
                             desc_sw128(y_lo + oy, 16), 1);
  }
#pragma unroll
  for (int kk = 0; kk < kTile / 8; ++kk) {
    const uint32_t ox = (kk / 4) * W::kRegionX + (kk % 4) * 32;
    const uint32_t oy = (kk / 4) * W::kRegionT + (kk % 4) * 32;
    wgmma_tf32_ss<W::kPiece>(out, desc_sw128(x + ox, 16),
                             desc_sw128(y + oy, 16), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(out);
}

// The producer's v-th T piece of a design W (WideDkv, SplitDkv): hi and
// lo of a transposed factor (`map`: Q^T or dO^T) for rows `row` .. row +
// W::kPiece - 1 of D (zeros past D), the tile's 64 queries from tile0 in
// two regions, into stage v % W::kStagesT of the T ring at `tring`, which
// is free once the consumers released piece v - W::kStagesT.
template <class W>
__device__ __forceinline__ void load_t_piece(uint8_t* tring, uint64_t* t_full,
                                             uint64_t* t_empty,
                                             const CUtensorMap (&map)[2],
                                             int v, int tile0, int row, int h,
                                             int b) {
  const int st = v % W::kStagesT;
  if (v >= W::kStagesT) bar_wait(&t_empty[st], ((v / W::kStagesT) & 1) ^ 1);
  uint8_t* tt = tring + st * W::kStageT;
  bar_arrive_tx(&t_full[st], W::kStageT);
#pragma unroll
  for (int pl = 0; pl < 2; ++pl)
#pragma unroll
    for (int rr = 0; rr < kTile / kCols; ++rr)
      tma_load_4d(tt + pl * W::kPlaneT + rr * W::kRegionT, &map[pl],
                  &t_full[st], tile0 + rr * kCols, row, h, b);
}

// The consumer's side of one tile's output product: for each piece of
// the part, waits for its T stage (the v-th piece consumed), takes X Y
// into a fresh accumulator, adds it into the piece's columns of acc by
// fp32 adds, and releases the stage (a warpgroup whose rows do not see
// the tile releases it without a product).
__device__ __forceinline__ void pieces_product(
    float (&acc)[WideDkv::kPieces][WideDkv::kPiece / 2], uint8_t* smem,
    uint64_t* t_full, uint64_t* t_empty, int& v, int pieces, uint32_t x,
    uint32_t x_lo, bool live, int lane) {
  using W = WideDkv;
#pragma unroll
  for (int pc = 0; pc < W::kPieces; ++pc, ++v) {
    if (pc == pieces) break;
    const int st = v % W::kStagesT;
    bar_wait(&t_full[st], (v / W::kStagesT) & 1);
    if (live) {
      const uint32_t y = smem_u32(smem + W::kT + st * W::kStageT);
      float part[W::kPiece / 2];
      x_product(part, x, x_lo, y, y + W::kPlaneT);
#pragma unroll
      for (int e = 0; e < W::kPiece / 2; ++e) acc[pc][e] += part[e];
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&t_empty[st]);
  }
}

// The place of a dk/dv CTA of kKeys keys and kOut columns: its b H + h,
// its first key and its first column of dK and dV. blockIdx is read
// through volatile asm, so that each call reads it anew: the consumers
// take their place afresh in every tile, and nothing of it stays live
// across the tile loop (kept there, it was what ptxas spilled).
struct CtaPlace {
  int bh, row_start, c0;
};
template <int kKeys, int kOut>
__device__ __forceinline__ CtaPlace cta_place(int D) {
  uint32_t x, y;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(x));
  asm volatile("mov.u32 %0, %%ctaid.y;\n" : "=r"(y));
  const int bh = kHeadMajor ? y : x, cta = kHeadMajor ? x : y;
  const int nparts = (D + kOut - 1) / kOut;
  return {bh, cta / nparts * kKeys, cta % nparts * kOut};
}
// The wide build's CTA place. Head-major, its grid is one line of CTAs in
// groups of `group` heads (the last group may hold fewer): a group's CTAs
// row tile by row tile, heaviest first, its heads side by side, a row
// tile's parts fastest; with group 1, one head's CTAs after another.
// Thread 0 works it out once, into shared memory (wide_place reads it).
__device__ __forceinline__ CtaPlace wide_cta(int D, int Sk, int group) {
  if constexpr (!kHeadMajor) return cta_place<kRows, WideDkv::kOut>(D);
  const int x = blockIdx.x, n = gridDim.x;
  const int nparts = (D + WideDkv::kOut - 1) / WideDkv::kOut;
  const int per_head = (Sk + kRows - 1) / kRows * nparts;
  const int first = x / (group * per_head) * group;
  const int heads = min(group, n / per_head - first);
  const int idx = x - first * per_head;
  const int row_tile = idx / (heads * nparts), rest = idx % (heads * nparts);
  return {first + rest / nparts, row_tile * kRows,
          rest % nparts * WideDkv::kOut};
}

// The CTA's place from shared memory, read anew at each call: the
// consumers take it afresh in every tile, and nothing of it stays live
// across the tile loop (kept there, it was what ptxas spilled).
__device__ __forceinline__ CtaPlace wide_place(const uint8_t* smem) {
  const volatile int* q =
      reinterpret_cast<const volatile int*>(smem + WideDkv::kPlace);
  return {q[0], q[1], q[2]};
}

// The wide build's consumer warpgroup C (keys 64 C .. 64 C + 63 of the
// CTA), a template so that its X planes' addresses, and the descriptors
// built on them, are the same for all its threads (ptxas keeps them in
// uniform registers; with C read from threadIdx they took the registers
// that the accumulators needed, and ptxas spilled).
template <int C>
__device__ __forceinline__ void dkv_wide_consumer(
    uint8_t* smem, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int H, int Sq, int Sk, int D, int q_off,
    int k_off, int causal, float scale) {
  using W = WideDkv;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + W::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* t_full = empty + kStages;
  uint64_t* t_empty = t_full + W::kStagesT;
  float* st = reinterpret_cast<float*>(smem + W::kStats) + C * 2 * kTile;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r16 = 16 * (t / 32) + lane / 4;  // its keys of the 64: +8
  const int row0 = 64 * C + r16;
  const int col = 2 * (lane % 4);  // the tile rows of each 8 it holds
  const float scale_log2 = scale * kLog2e;
  const uint32_t x_hi = smem_u32(smem + W::kX + 2 * C * W::kPlaneX);
  const uint32_t x_lo = x_hi + W::kPlaneX;
  const float no_stats[2] = {0.f, 0.f};

  float acc_k[W::kPieces][W::kPiece / 2], acc_v[W::kPieces][W::kPiece / 2];
#pragma unroll
  for (int pc = 0; pc < W::kPieces; ++pc)
#pragma unroll
    for (int e = 0; e < W::kPiece / 2; ++e) acc_k[pc][e] = acc_v[pc][e] = 0.f;

  int n = 0, v = 0;  // ring stages and T pieces consumed so far
  const int u0 = dkv_first_tile(wide_place(smem).row_start, q_off,
                                k_off, causal, (Sq + kTile - 1) / kTile);
  for (int tile0 = u0 * kTile; tile0 < Sq; tile0 += kTile) {
    const CtaPlace at = wide_place(smem);
    const int first_pos = k_off + at.row_start + 64 * C;
    // The part's pieces that start below D (the last part's others are
    // neither loaded, multiplied nor stored).
    const int pieces = (min(W::kOut, D - at.c0) + W::kPiece - 1) / W::kPiece;
    // Whether the warpgroup's keys see any of the tile (the same for its
    // 128 threads), and whether some pair of the tile is hidden.
    bool live = true, masked = tile0 + kTile > Sq;
    if (causal) {
      live = q_off + tile0 + kTile - 1 >= first_pos;
      masked = masked || q_off + tile0 < first_pos + 63;
    }
    // The tile's lse (pre-scaled by log2 e; +inf past Sq, so that p is 0
    // there) and delta, one row a thread of the first 64, loaded before S
    // is summed and stored after it.
    float lse_t = __int_as_float(0x7f800000), delta_t = 0.f;
    if (t < kTile && tile0 + t < Sq) {
      lse_t = lse[(size_t)at.bh * Sq + tile0 + t] * kLog2e;
      delta_t = delta[(size_t)at.bh * Sq + tile0 + t];
    }

    // S^T, then P^T into the X planes: the first barrier waits for the
    // warpgroup's last products that read them and hands the stats over,
    // the second hands the stores (made visible to wgmma by the proxy
    // fence) to the products.
    float s[kTile / 2];
    ring_sum(s, smem_u32(smem), full, empty, n, D, C * 64 * 128, live, lane);
    if (live) {
      if (t < kTile) {
        st[t] = lse_t;
        st[kTile + t] = delta_t;
      }
      named_bar_sync(1 + C, 128);
      p_in_place<true>(s, st, no_stats, masked, k_off + at.row_start + row0,
                       q_off + tile0, Sq - tile0, causal, col, scale_log2);
      store_x(s, x_hi, x_lo, r16, lane % 4);
      fence_proxy_async();
      named_bar_sync(1 + C, 128);
    }
    // dV += P^T dO, a 64-column piece a product.
    pieces_product(acc_v, smem, t_full, t_empty, v, pieces, x_hi, x_lo, live,
                   lane);
    // P parked in the hi plane once every product that read it is done.
    if (live) {
      named_bar_sync(1 + C, 128);
      park(s, x_hi, t);
    }

    // dP^T, then dS^T = P (dP - delta) scale into the X planes, once every
    // thread has taken its P back.
    float dp[kTile / 2];
    ring_sum(dp, smem_u32(smem), full, empty, n, D, C * 64 * 128, live,
             lane);
    if (live) {
      unpark(s, x_hi, t);
      ds_in_place<true>(dp, s, st + kTile, no_stats, col, scale);
      named_bar_sync(1 + C, 128);
      store_x(dp, x_hi, x_lo, r16, lane % 4);
      fence_proxy_async();
      named_bar_sync(1 + C, 128);
    }
    // dK += dS^T Q.
    pieces_product(acc_k, smem, t_full, t_empty, v, pieces, x_hi, x_lo, live,
                   lane);
  }

  const CtaPlace end = wide_place(smem);
  const int b = end.bh / H, h = end.bh % H;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = end.row_start + row0 + 8 * i;
    if (row >= Sk) continue;
    const size_t off = ((size_t)(b * Sk + row) * H + h) * D + end.c0 + col;
#pragma unroll
    for (int pc = 0; pc < W::kPieces; ++pc)
#pragma unroll
      for (int jj = 0; jj < W::kPiece / 8; ++jj) {
        const int cc = W::kPiece * pc + 8 * jj;
        if (end.c0 + col + cc >= D) continue;
        store2<float>(dk + off + cc, acc_k[pc][4 * jj + 2 * i],
                      acc_k[pc][4 * jj + 2 * i + 1]);
        store2<float>(dv + off + cc, acc_v[pc][4 * jj + 2 * i],
                      acc_v[pc][4 * jj + 2 * i + 1]);
      }
  }
}

// dk/dv past kWideAbove: 128-column parts of dK and dV (see the header).
__global__ void __launch_bounds__(384, 1)
    flash_dkv_tf32_wide(const __grid_constant__ Maps maps,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv,
                        int H, int Sq, int Sk, int D, int q_off, int k_off,
                        int causal, float scale, int group) {
  using W = WideDkv;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + W::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* t_full = empty + kStages;
  uint64_t* t_empty = t_full + W::kStagesT;

  if (threadIdx.x == 0) {
    const CtaPlace place = wide_cta(D, Sk, group);
    int* at = reinterpret_cast<int*>(smem + W::kPlace);
    at[0] = place.bh;
    at[1] = place.row_start;
    at[2] = place.c0;
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < W::kStagesT; ++s) {
      bar_init(&t_full[s], 1);
      bar_init(&t_empty[s], 8);
    }
    bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: thread 0 issues, per tile, the ring pass of S, the dO^T
    // pieces of dV, the ring pass of dP and the Q^T pieces of dK: the order
    // in which the consumers take them.
    regs_dec<24>();
    if (threadIdx.x == 0) {
      const CtaPlace at = wide_place(smem);
      const int b = at.bh / H, h = at.bh % H;
      const int u0 = dkv_first_tile(at.row_start, q_off, k_off, causal,
                                    (Sq + kTile - 1) / kTile);
      int n = 0, v = 0;  // ring stages and T pieces issued so far
      for (int tile0 = u0 * kTile; tile0 < Sq; tile0 += kTile) {
        issue_ring_pass(smem, maps.a[0], maps.b[0], full, empty, n, D, h, b,
                        at.row_start, tile0);
        for (int c = at.c0; c < min(D, at.c0 + W::kOut); c += W::kPiece)
          load_t_piece<W>(smem + W::kT, t_full, t_empty, maps.t[1], v++,
                          tile0, c, h, b);
        issue_ring_pass(smem, maps.a[1], maps.b[1], full, empty, n, D, h, b,
                        at.row_start, tile0);
        for (int c = at.c0; c < min(D, at.c0 + W::kOut); c += W::kPiece)
          load_t_piece<W>(smem + W::kT, t_full, t_empty, maps.t[0], v++,
                          tile0, c, h, b);
      }
    }
  } else {
    regs_inc<kConsumerRegs>();
    if (wg == 1)
      dkv_wide_consumer<0>(smem, lse, delta, dk, dv, H, Sq, Sk, D, q_off,
                           k_off, causal, scale);
    else
      dkv_wide_consumer<1>(smem, lse, delta, dk, dv, H, Sq, Sk, D, q_off,
                           k_off, causal, scale);
  }
}

// ---- the split-by-output dk/dv design -------------------------------------

// dS = P (dP - delta) scale in place of dP, as ds_in_place, each p read
// from its park just before it is used (the whole of P beside dP and dK
// made ptxas spill).
__device__ __forceinline__ void ds_from_park(float (&dp)[kTile / 2],
                                             uint32_t plane, int t,
                                             const float* st_delta, int col,
                                             float scale) {
#pragma unroll
  for (int e = 0; e < kTile / 2; ++e) {
    float p;
    asm volatile("ld.shared.f32 %0, [%1];\n"
                 : "=f"(p)
                 : "r"(plane + (128 * e + t) * 4)
                 : "memory");
    const int tc = 8 * (e / 4) + col + e % 2;
    dp[e] = p * (dp[e] - st_delta[tc]) * scale;
  }
}

// The split design's tiles and shared memory (see the header): a CTA owns
// 64 keys and a part of kOut columns; consumer 0 sums S^T and makes dV,
// consumer 1 sums dP^T and makes dK, each with a ring of its own.
struct SplitDkv {
  static constexpr int kKeys = 64;    // keys of a CTA
  static constexpr int kOut = 256;    // columns of dK and dV a CTA owns
  static constexpr int kPiece = 32;   // columns of one output product
  static constexpr int kPieces = kOut / kPiece;
  static constexpr int kStagesT = 2;  // T pieces in flight, per consumer
  // A ring stage: the CTA's region and the tile's, [64][32] each, hi and lo.
  static constexpr int kStage = 2 * (kKeys * 128 + Ring::kRegionB);
  static constexpr int kRegionT = kPiece * 128;       // [32 columns][32]
  static constexpr int kPlaneT = kPiece * kTile * 4;  // a piece, hi or lo
  static constexpr int kStageT = 2 * kPlaneT;
  static constexpr int kRing0 = 0;                          // K, Q: S^T
  static constexpr int kRing1 = kRing0 + kStages * kStage;  // V, dO: dP^T
  static constexpr int kH = kRing1 + kStages * kStage;      // P handed over
  static constexpr int kT0 = kH + 128 * (kTile / 2) * 4;    // dO^T pieces
  static constexpr int kT1 = kT0 + kStagesT * kStageT;      // Q^T pieces
  // Each consumer's lse (0) or delta (1), two tiles' worth.
  static constexpr int kStats = kT1 + kStagesT * kStageT;
  static constexpr int kBar = kStats + 2 * 2 * kTile * 4;
  // full and empty per stage of the two rings and the two T rings, and
  // the hand-over of P (full and empty)
  static constexpr int kBytes = kBar + 8 * (4 * kStages + 4 * kStagesT + 2);
  static_assert(kBytes + 1024 <= 232448,
                "split tf32 dk/dv tiles exceed shared memory");
  static_assert(kRing1 % 1024 == 0 && kT0 % 1024 == 0 &&
                    kT1 % 1024 == 0 && kRegionT % 1024 == 0,
                "swizzled regions start on 1024-byte boundaries");
};

__device__ __forceinline__ CtaPlace split_cta(int D) {
  return cta_place<SplitDkv::kKeys, SplitDkv::kOut>(D);
}

// Consumer R of the split design: R 0 sums S^T from ring 0, makes P,
// hands it over (unrounded, each thread its 32 words in H) and makes dV
// += P^T dO; R 1 sums dP^T from ring 1, takes P, makes dS = P (dP -
// delta) scale and dK += dS^T Q. Both hold the same fragment of the
// tile (the CTA's 64 keys by the tile's 64 queries), so thread t of one
// reads in H what thread t of the other wrote. The output products take
// their A operand (P^T or dS^T, split) from registers, 32 columns a
// product (reg_product<32>), each into a fresh accumulator folded into
// the part's columns by fp32 adds.
template <int R>
__device__ __forceinline__ void dkv_split_consumer(
    uint8_t* smem, const float* __restrict__ stat, float* __restrict__ out,
    int H, int Sq, int Sk, int D, int q_off, int k_off, int causal,
    float scale) {
  using X = SplitDkv;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + X::kBar);
  uint64_t* full = bars + R * 2 * kStages;
  uint64_t* empty = full + kStages;
  uint64_t* t_full = bars + 4 * kStages + R * 2 * X::kStagesT;
  uint64_t* t_empty = t_full + X::kStagesT;
  uint64_t* h_full = bars + 4 * kStages + 4 * X::kStagesT;
  uint64_t* h_empty = h_full + 1;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r16 = 16 * (t / 32) + lane / 4;  // its keys of the 64: +8
  const int col = 2 * (lane % 4);  // the tile rows of each 8 it holds
  const float scale_log2 = scale * kLog2e;
  const uint32_t ring = smem_u32(smem + (R ? X::kRing1 : X::kRing0));
  const uint32_t tring = smem_u32(smem + (R ? X::kT1 : X::kT0));
  const uint32_t hand = smem_u32(smem + X::kH);
  const float no_stats[2] = {0.f, 0.f};

  float acc[X::kPieces][X::kPiece / 2];  // dV (R 0) or dK (R 1)
#pragma unroll
  for (int pc = 0; pc < X::kPieces; ++pc)
#pragma unroll
    for (int e = 0; e < X::kPiece / 2; ++e) acc[pc][e] = 0.f;

  int n = 0, v = 0, m = 0;  // ring stages, T pieces and tiles so far
  const int u0 = dkv_first_tile(split_cta(D).row_start, q_off, k_off,
                                causal, (Sq + kTile - 1) / kTile);
  for (int tile0 = u0 * kTile; tile0 < Sq; tile0 += kTile, ++m) {
    const CtaPlace at = split_cta(D);
    const int first_pos = k_off + at.row_start;
    const int pieces = (min(X::kOut, D - at.c0) + X::kPiece - 1) / X::kPiece;
    bool live = true, masked = tile0 + kTile > Sq;
    if (causal) {
      live = q_off + tile0 + kTile - 1 >= first_pos;
      masked = masked || q_off + tile0 < first_pos + 63;
    }
    // The tile's lse (R 0; pre-scaled by log2 e, +inf past Sq) or delta
    // (R 1), one row a thread of the first 64, into this tile's buffer.
    float* st = reinterpret_cast<float*>(smem + X::kStats) +
                (2 * R + tile0 / kTile % 2) * kTile;
    float stat_t = R ? 0.f : __int_as_float(0x7f800000);
    if (t < kTile && tile0 + t < Sq)
      stat_t = stat[(size_t)at.bh * Sq + tile0 + t] * (R ? 1.f : kLog2e);

    float x[kTile / 2];  // S^T, then P (R 0); dP^T, then dS (R 1)
    ring_sum<X::kKeys>(x, ring, full, empty, n, D, 0, live, lane);
    if (live) {
      if (t < kTile) st[t] = stat_t;
      named_bar_sync(1 + R, 128);
    }
    if constexpr (R == 0) {
      if (live)
        p_in_place<true>(x, st, no_stats, masked, first_pos + r16,
                         q_off + tile0, Sq - tile0, causal, col, scale_log2);
      // H is free once consumer 1 took the last tile's P.
      if (m > 0) bar_wait(h_empty, (m - 1) & 1);
      if (live) park(x, hand, t);
      __syncwarp();
      if (lane == 0) bar_arrive(h_full);
    } else {
      bar_wait(h_full, m & 1);
      if (live) ds_from_park(x, hand, t, st, col, scale);
      __syncwarp();
      if (lane == 0) bar_arrive(h_empty);
    }
    uint32_t hi[kTile / 2];
    if (live) split_tf32(x, hi);
    // dV += P^T dO (R 0) or dK += dS^T Q (R 1), 32 columns a product.
#pragma unroll
    for (int pc = 0; pc < X::kPieces; ++pc, ++v) {
      if (pc == pieces) break;
      const int sp = v % X::kStagesT;
      bar_wait(&t_full[sp], (v / X::kStagesT) & 1);
      if (live) {
        const uint32_t y = tring + sp * X::kStageT;
        float part[X::kPiece / 2];
        reg_product<X::kPiece>(part, hi, x, y, y + X::kPlaneT);
#pragma unroll
        for (int e = 0; e < X::kPiece / 2; ++e) acc[pc][e] += part[e];
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&t_empty[sp]);
    }
  }

  const CtaPlace end = split_cta(D);
  const int b = end.bh / H, h = end.bh % H;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = end.row_start + r16 + 8 * i;
    if (row >= Sk) continue;
    const size_t off = ((size_t)(b * Sk + row) * H + h) * D + end.c0 + col;
#pragma unroll
    for (int pc = 0; pc < X::kPieces; ++pc)
#pragma unroll
      for (int jj = 0; jj < X::kPiece / 8; ++jj) {
        const int cc = X::kPiece * pc + 8 * jj;
        if (end.c0 + col + cc >= D) continue;
        store2<float>(out + off + cc, acc[pc][4 * jj + 2 * i],
                      acc[pc][4 * jj + 2 * i + 1]);
      }
  }
}

// dk/dv past kWideAbove with kSplitByOutput: 64 keys and 256 columns of
// dK and dV a CTA, the consumers split by output (see the header).
__global__ void __launch_bounds__(384, 1)
    flash_dkv_tf32_split(const __grid_constant__ Maps maps,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int H, int Sq, int Sk, int D, int q_off, int k_off,
                         int causal, float scale) {
  using X = SplitDkv;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + X::kBar);

  if (threadIdx.x == 0) {
    // Consumer w's ring and T ring: full (the producer's thread) and
    // empty (lane 0 of each of the consumer's warps).
    for (int w = 0; w < 2; ++w) {
      uint64_t* ring = bars + w * 2 * kStages;
      uint64_t* tring = bars + 4 * kStages + w * 2 * X::kStagesT;
      for (int s = 0; s < kStages; ++s) {
        bar_init(&ring[s], 1);
        bar_init(&ring[kStages + s], 4);
      }
      for (int s = 0; s < X::kStagesT; ++s) {
        bar_init(&tring[s], 1);
        bar_init(&tring[X::kStagesT + s], 4);
      }
    }
    bar_init(&bars[4 * kStages + 4 * X::kStagesT], 4);      // P handed over
    bar_init(&bars[4 * kStages + 4 * X::kStagesT + 1], 4);  // P taken
    bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: lane 0 of warp w issues consumer w's stream, per tile its
    // ring pass (w 0: K and Q, w 1: V and dO) and its T pieces (dO^T for
    // dV, Q^T for dK), the order in which that consumer takes them.
    regs_dec<24>();
    const int w = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0 && w < 2) {
      const CtaPlace at = split_cta(D);
      const int b = at.bh / H, h = at.bh % H;
      const int u0 = dkv_first_tile(at.row_start, q_off, k_off, causal,
                                    (Sq + kTile - 1) / kTile);
      uint64_t* full = bars + w * 2 * kStages;
      uint64_t* t_full = bars + 4 * kStages + w * 2 * X::kStagesT;
      uint8_t* ring = smem + (w ? X::kRing1 : X::kRing0);
      uint8_t* tring = smem + (w ? X::kT1 : X::kT0);
      int n = 0, v = 0;  // ring stages and T pieces issued so far
      for (int tile0 = u0 * kTile; tile0 < Sq; tile0 += kTile) {
        issue_ring_pass<X::kKeys>(ring, maps.a[w], maps.b[w], full,
                                  full + kStages, n, D, h, b, at.row_start,
                                  tile0);
        for (int c = at.c0; c < min(D, at.c0 + X::kOut); c += X::kPiece)
          load_t_piece<X>(tring, t_full, t_full + X::kStagesT, maps.t[1 - w],
                          v++, tile0, c, h, b);
      }
    }
  } else {
    regs_inc<kConsumerRegs>();
    if (wg == 1)
      dkv_split_consumer<0>(smem, lse, dv, H, Sq, Sk, D, q_off, k_off,
                            causal, scale);
    else
      dkv_split_consumer<1>(smem, delta, dk, H, Sq, Sk, D, q_off, k_off,
                            causal, scale);
  }
}

// The split design's launch: the tensor maps of its 64-key CTA (the
// CTA's K and V boxes of 64 rows) and its 32-column T pieces.
cudaError_t run_split(const Tf32BwdPlanes& p, const void* lse, const void* delta,
                      void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
                      int q_off, int k_off, int causal, float scale,
                      cudaStream_t stream) {
  const int sqp = padded_keys(Sq, kSeqPad);
  const float* a[2][2] = {{p.k, p.k_lo}, {p.v, p.v_lo}};
  const float* bt[2][2] = {{p.q, p.q_lo}, {p.dout, p.do_lo}};
  const float* t[2][2] = {{p.qt, p.qt_lo}, {p.dot, p.dot_lo}};
  Maps maps;
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 2 && err == cudaSuccess; ++i)
    for (int j = 0; j < 2 && err == cudaSuccess; ++j) {
      err = encode_bshd<float>(&maps.a[i][j], a[i][j], B, Sk, H, D,
                               SplitDkv::kKeys);
      if (err == cudaSuccess)
        err = encode_bshd<float>(&maps.b[i][j], bt[i][j], B, Sq, H, D, kTile);
      if (err == cudaSuccess)
        err = encode_bhds<float>(&maps.t[i][j], t[i][j], B, H, D, sqp,
                                 SplitDkv::kPiece);
    }
  if (err != cudaSuccess) return err;
  const int ctas = (Sk + SplitDkv::kKeys - 1) / SplitDkv::kKeys *
                   ((D + SplitDkv::kOut - 1) / SplitDkv::kOut);
  const dim3 grid = kHeadMajor ? dim3(ctas, B * H) : dim3(B * H, ctas);
  return launch_ws(flash_dkv_tf32_split, grid, SplitDkv::kBytes + 1024,
                   stream, maps, (const float*)lse, (const float*)delta,
                   (float*)dk, (float*)dv, H, Sq, Sk, D, q_off, k_off, causal,
                   scale);
}

template <bool kDkv>
cudaError_t run(void* scratch, const void* lse, const void* delta,
                void* out0, void* out1, int B, int H, int Sq, int Sk, int D,
                int q_off, int k_off, int causal, float scale,
                cudaStream_t stream) {
  using Sh = BwdShape<kDkv>;
  const Tf32BwdPlanes p = tf32_bwd_planes(scratch, B, H, Sq, Sk, D);
  const int sqp = padded_keys(Sq, kSeqPad), skp = padded_keys(Sk, kSeqPad);
  // The CTA's rows (box 128) and the tile's (box 64) of S and dP, and the
  // transposed factors (box kOut rows of D by 32 of the sequence; the wide
  // dk/dv build's pieces are boxes of the same 64 rows).
  const float* a[2][2] = {{p.q, p.q_lo}, {p.dout, p.do_lo}};
  const float* bt[2][2] = {{p.k, p.k_lo}, {p.v, p.v_lo}};
  const float* t[2][2] = {{p.kt, p.kt_lo}, {p.kt, p.kt_lo}};
  int rows = Sq, tiles = Sk, tp = skp;
  if constexpr (kDkv) {
    const float* ka[2][2] = {{p.k, p.k_lo}, {p.v, p.v_lo}};
    const float* qb[2][2] = {{p.q, p.q_lo}, {p.dout, p.do_lo}};
    const float* qt[2][2] = {{p.qt, p.qt_lo}, {p.dot, p.dot_lo}};
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) {
        a[i][j] = ka[i][j];
        bt[i][j] = qb[i][j];
        t[i][j] = qt[i][j];
      }
    rows = Sk;
    tiles = Sq;
    tp = sqp;
  }
  Maps maps;
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 2 && err == cudaSuccess; ++i)
    for (int j = 0; j < 2 && err == cudaSuccess; ++j) {
      err = encode_bshd<float>(&maps.a[i][j], a[i][j], B, rows, H, D, kRows);
      if (err == cudaSuccess)
        err = encode_bshd<float>(&maps.b[i][j], bt[i][j], B, tiles, H, D,
                                 kTile);
      if (err == cudaSuccess)
        err = encode_bhds<float>(&maps.t[i][j], t[i][j], B, H, D, tp,
                                 Sh::kOut);
    }
  if (err != cudaSuccess) return err;
  const int row_tiles = (rows + kRows - 1) / kRows;
  if constexpr (kDkv) {
    if (D > kWideAbove && kSplitByOutput)
      return run_split(p, lse, delta, out0, out1, B, H, Sq, Sk, D, q_off,
                       k_off, causal, scale, stream);
    if (D > kWideAbove) {
      // A head's CTAs, and the heads of a group: about one wave.
      const int per_head =
          row_tiles * ((D + WideDkv::kOut - 1) / WideDkv::kOut);
      int group = 1;
      if (kHeadGroups) {
        int dev, sms;
        err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
          err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev);
        if (err != cudaSuccess) return err;
        group = (sms + per_head - 1) / per_head;
      }
      const dim3 grid =
          kHeadMajor ? dim3(per_head * B * H) : dim3(B * H, per_head);
      return launch_ws(flash_dkv_tf32_wide, grid, WideDkv::kBytes + 1024,
                       stream, maps, (const float*)lse, (const float*)delta,
                       (float*)out0, (float*)out1, H, Sq, Sk, D, q_off,
                       k_off, causal, scale, group);
    }
  }
  const int ctas = row_tiles * ((D + Sh::kOut - 1) / Sh::kOut);
  const dim3 grid = kHeadMajor ? dim3(ctas, B * H) : dim3(B * H, ctas);
  return launch_ws(flash_bwd_tf32<kDkv>, grid, Sh::kBytes + 1024, stream,
                   maps, (const float*)lse, (const float*)delta, (float*)out0,
                   (float*)out1, H, Sq, Sk, D, q_off, k_off, causal, scale);
}

}  // namespace
}  // namespace hvdt

// The backward's pre-pass, one per backward, which the tf32 dq and dk/dv
// read (these builds and those of flash_bwd_tf32_narrow_sm90.cu), in one
// launch (sm90_common.cuh: tf32_bwd_split). q, do: contiguous fp32 [B,
// Sq, H, D]; k, v: [B, Sk, H, D]; 16-byte-aligned bases; D 16 or a
// multiple of 32. scratch: fp32, 16-byte aligned, 4 B Sq H D + 4 B Sk H D
// + 2 B H D Skp + 4 B H D Sqp elements (Sqp, Skp: Sq and Sk rounded up to
// 64): q hi, q lo, do hi, do lo, k hi, k lo, v hi, v lo in their layout,
// then K^T hi and lo [B, H, D, Skp], Q^T hi and lo and dO^T hi and lo [B,
// H, D, Sqp], in that order.
extern "C" int hvdt_flash_bwd_tf32_split(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         void* scratch, int B, int H, int Sq,
                                         int Sk, int D, void* stream) {
  return hvdt::sm90::tf32_bwd_split(q, k, v, dout, scratch, B, H, Sq, Sk, D,
                                    (cudaStream_t)stream);
}

// dq through 3xTF32 from the pre-pass's scratch (of the same B, H, Sq,
// Sk, D). lse, delta: fp32 [B, H, Sq]. dq: fp32 [B, Sq, H, D]. scale
// multiplies the logits (1/sqrt of the head dim before any zero padding).
extern "C" int hvdt_flash_dq_tf32(void* scratch, const void* lse,
                                  const void* delta, void* dq, int B, int H,
                                  int Sq, int Sk, int D, int q_off,
                                  int k_off, int causal, float scale,
                                  void* stream) {
  if (D <= 0 || D % 32) return cudaErrorInvalidValue;
  return hvdt::run<false>(scratch, lse, delta, dq, nullptr, B, H, Sq, Sk, D,
                          q_off, k_off, causal, scale, (cudaStream_t)stream);
}

// The columns of dK and dV a CTA of the tf32 dk/dv owns at head dim D,
// which names the build hvdt_flash_dkv_tf32 runs: 64 up to kWideAbove,
// 128 (the wide build) past it.
extern "C" int hvdt_flash_dkv_tf32_part(int D) {
  if (D <= hvdt::kWideAbove) return hvdt::BwdShape<true>::kOut;
  return hvdt::kSplitByOutput ? hvdt::SplitDkv::kOut : hvdt::WideDkv::kOut;
}

// dk and dv through 3xTF32, as hvdt_flash_dq_tf32, on the build of D
// (hvdt_flash_dkv_tf32_part). dk, dv: fp32 [B, Sk, H, D].
extern "C" int hvdt_flash_dkv_tf32(void* scratch, const void* lse,
                                   const void* delta, void* dk, void* dv,
                                   int B, int H, int Sq, int Sk, int D,
                                   int q_off, int k_off, int causal,
                                   float scale, void* stream) {
  if (D <= 0 || D % 32) return cudaErrorInvalidValue;
  return hvdt::run<true>(scratch, lse, delta, dk, dv, B, H, Sq, Sk, D,
                         q_off, k_off, causal, scale, (cudaStream_t)stream);
}
