// Flash-attention backward for Hopper's tensor cores (sm_90a) in fp32:
// dq and dk/dv at every head dim past 32 (a multiple of 32; the wrapper
// zero-pads any other) through 3xTF32, the "tf32" design of both kernels.
//
// Replaces the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` (with
// the shared recompute `_recompute_p_ds`) in
// horovod_tpu/parallel/flash_attention.py, launched by `_flash_bwd_bhsd`,
// as flash_dq_sm90.cu and flash_dkv_sm90.cu do for bf16 and fp16 up to D
// 256 and flash_bwd.cu for D <= 32. Same function: for every visible
// (q, k) pair p = exp(s - lse) (lse = +inf on rows that saw no key, so
// p = 0 there) and ds = p (dp - delta) scale, recomputed from q, k, v, do
// and the forward's per-row lse and delta = rowsum(do * o); then
// dq = sum over k of ds k, dk = sum over q of ds^T q and dv = sum over q of
// p^T do, in fp32. Runtime offsets shift the causal mask; tiles wholly in
// the future are skipped; a CTA that sees no tile writes zeros.
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
// per backward (hvdt_flash_bwd_tf32_split, the kernels of
// sm90_common.cuh), which both kernels read, writes 14 planes into scratch
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
// at the output product (ptxas spills 96 bytes of it, dk/dv none). A
// 128-column dk and dv part would hold dK 64 + dV 64 + a fresh 64 with P
// and dS (over 240), so dk/dv's parts are 64 columns: dK 32 + dV 32 +
// P 32 + dS 32 + the split's hi 32 + the tile's product 32 = 192. The
// parts pay S and dP once each: at D 128 dq does
// the function's three products and dk/dv 2 x 2 + 2 = 6 of its 4; at D
// 640, 5 x 2 + 1 of 3 and 10 x 2 + 2 of 4.
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
constexpr int kSeqPad = 64;  // the transposed planes' rows: S rounded up
constexpr int kConsumerRegs = 240;
// The grid's order: one head's CTAs side by side (see the header).
// tools/bwd_tf32_variants.py builds this file with false (b h fastest) to
// measure why.
constexpr bool kHeadMajor = true;

// The pre-pass's 14 planes, in scratch order.
struct Planes {
  float *q, *q_lo, *dout, *do_lo, *k, *k_lo, *v, *v_lo;  // [B, S, H, D]
  float *kt, *kt_lo;                   // [B, H, D, Sk rounded up to 64]
  float *qt, *qt_lo, *dot, *dot_lo;    // [B, H, D, Sq rounded up to 64]
};

inline Planes planes(void* scratch, int B, int H, int Sq, int Sk, int D) {
  const size_t nq = (size_t)B * Sq * H * D, nk = (size_t)B * Sk * H * D;
  const size_t nkt = (size_t)B * H * D * padded_keys(Sk, kSeqPad);
  const size_t nqt = (size_t)B * H * D * padded_keys(Sq, kSeqPad);
  float* x = (float*)scratch;
  float* at[14];
  const size_t n[14] = {nq, nq, nq, nq, nk, nk, nk, nk,
                        nkt, nkt, nqt, nqt, nqt, nqt};
  for (int i = 0; i < 14; ++i) {
    at[i] = x;
    x += n[i];
  }
  return Planes{at[0], at[1], at[2],  at[3],  at[4],  at[5],  at[6],
                at[7], at[8], at[9], at[10], at[11], at[12], at[13]};
}

// The tensor maps of one kernel: the ring's operands of S (pass 0) and dP
// (pass 1), the CTA's rows (a) and the tile's (b), and the T stage's
// transposed factors: [0] that of dS (K^T for dq, Q^T for dk/dv), [1]
// that of P^T (dO^T, dk/dv only); each as [hi, lo].
struct Maps {
  CUtensorMap a[2][2], b[2][2], t[2][2];
};

template <bool kDkv>
struct BwdShape {
  static constexpr int kOut = kDkv ? 64 : 128;  // output columns of a CTA
  static constexpr int kOps = kDkv ? 2 : 1;     // transposed factors
  static constexpr int kRegionA = kRows * 128;  // [128][32] fp32
  static constexpr int kRegionB = kTile * 128;  // [64][32] fp32
  static constexpr int kStage = 2 * (kRegionA + kRegionB);
  // One plane of a T stage: kTile / 32 regions of [kOut][32].
  static constexpr int kPlaneT = kTile * kOut * 4;
  static constexpr int kStageT = 2 * kOps * kPlaneT;
  static constexpr int kRing = 0;
  static constexpr int kT = kRing + kStages * kStage;
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

// Sums A_r B_r^T over the D / 32 regions of one ring pass, each region's
// 12 products (lo.hi and hi.lo, then hi.hi, four k steps each) in an
// accumulator of its own, the regions summed by fp32 adds. `n` counts the
// ring stages consumed. A warpgroup whose rows do not see the tile
// (`live` false) waits for each stage and releases it without a product.
template <bool kDkv>
__device__ __forceinline__ void ring_sum(float (&out)[kTile / 2],
                                         uint8_t* smem, uint64_t* full,
                                         uint64_t* empty, int& n, int nreg,
                                         int c, bool live, int lane) {
  using Sh = BwdShape<kDkv>;
  for (int r = 0; r < nreg; ++r, ++n) {
    const int st = n % kStages;
    const uint32_t stage = smem_u32(smem + Sh::kRing + st * Sh::kStage);
    const uint32_t a = stage + c * 64 * 128;  // this warpgroup's 64 rows
    const uint32_t b = stage + 2 * Sh::kRegionA;
    bar_wait(&full[st], (n / kStages) & 1);
    if (live) {
      float part[kTile / 2];
      fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_tf32_ss<kTile>(part, desc_sw128(a + Sh::kRegionA + 32 * kk, 16),
                             desc_sw128(b + 32 * kk, 16), kk > 0);
        wgmma_tf32_ss<kTile>(part, desc_sw128(a + 32 * kk, 16),
                             desc_sw128(b + Sh::kRegionB + 32 * kk, 16), 1);
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
        out[e] = r > 0 ? out[e] + part[e] : part[e];
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[st]);
  }
}

// x split in registers: hi = tf32(x) (as bits), and x becomes
// tf32(x - hi).
__device__ __forceinline__ void split_tf32(float (&x)[kTile / 2],
                                           uint32_t (&hi)[kTile / 2]) {
#pragma unroll
  for (int e = 0; e < kTile / 2; ++e) {
    const float h = tf32_round(x[e]);
    hi[e] = __float_as_uint(h);
    x[e] = tf32_round(x[e] - h);
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

// kDkv false: dq (out0 = dq). kDkv true: dk/dv (out0 = dk, out1 = dv).
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
  const int nreg = D / kCols;
  // The CTA's first row, its rows' and its tiles' offsets and lengths, and
  // the tiles [u0, u1) it sees.
  const int rows_off = kDkv ? k_off : q_off, tile_off = kDkv ? q_off : k_off;
  const int rows_len = kDkv ? Sk : Sq, tile_len = kDkv ? Sq : Sk;
  int row_start, u0 = 0, u1 = (tile_len + kTile - 1) / kTile;
  if constexpr (kDkv) {
    row_start = row_tile * kRows;
    if (causal) {
      // q tile u sees the CTA's first key once q_off + 64 u + 63 >= its
      // position.
      const long long need = (long long)k_off + row_start - q_off - (kTile - 1);
      u0 = need <= 0 ? 0
                     : (int)min((long long)u1, (need + kTile - 1) / kTile);
    }
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
    // write each T stage's lse (pre-scaled by log2 e; +inf past Sq, so
    // that p is 0 there) and delta.
    regs_dec<24>();
    if (threadIdx.x < (kDkv ? 32 : 1)) {
      const int lane = threadIdx.x;
      int n = 0;  // ring stages issued so far
      for (int u = u0; u < u1; ++u) {
        const int m = u - u0, st = m % kStagesT, tile0 = u * kTile;
        if (m >= kStagesT) bar_wait(&t_empty[st], ((m / kStagesT) & 1) ^ 1);
        if constexpr (kDkv) {
          float* st_lse = reinterpret_cast<float*>(smem + Sh::kStats) +
                          st * 2 * kTile;
          for (int i = lane; i < kTile; i += 32) {
            const int row = tile0 + i;
            st_lse[i] = row < Sq ? lse[(size_t)bh * Sq + row] * kLog2e
                                 : __int_as_float(0x7f800000);
            st_lse[kTile + i] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
          }
        }
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
          for (int pass = 0; pass < 2; ++pass) {
            for (int r = 0; r < nreg; ++r, ++n) {
              const int s = n % kStages;
              // Stage s is free once the consumers released load n - 2.
              if (n >= kStages) bar_wait(&empty[s], ((n / kStages) & 1) ^ 1);
              uint8_t* stage = smem + Sh::kRing + s * Sh::kStage;
              bar_arrive_tx(&full[s], Sh::kStage);
#pragma unroll
              for (int pl = 0; pl < 2; ++pl) {
                tma_load_4d(stage + pl * Sh::kRegionA, &maps.a[pass][pl],
                            &full[s], r * kCols, h, row_start, b);
                tma_load_4d(stage + 2 * Sh::kRegionA + pl * Sh::kRegionB,
                            &maps.b[pass][pl], &full[s], r * kCols, h, tile0,
                            b);
              }
            }
          }
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
      ring_sum<kDkv>(s, smem, full, empty, n, nreg, c, live, lane);
      bar_wait(&t_full[st], (m / kStagesT) & 1);
      const float* st_lse =
          reinterpret_cast<const float*>(smem + Sh::kStats) + st * 2 * kTile;
      if (live) {
        // P in place of S.
#pragma unroll
        for (int e = 0; e < kTile / 2; ++e) {
          const int i = (e / 2) % 2;
          const int tc = 8 * (e / 4) + col + e % 2;  // row of the tile
          const float l2 = kDkv ? st_lse[tc] : lse_r[i];
          float p = exp2f(fmaf(s[e], scale_log2, -l2));
          if (masked) {
            const int pos = rows_off + row_start + row0 + 8 * i;
            const int tpos = tile_off + tile0 + tc;
            const bool ok = tile0 + tc < tile_len &&
                            (!causal || (kDkv ? tpos >= pos : pos >= tpos));
            p = ok ? p : 0.f;
          }
          s[e] = p;
        }
      }
      float dp[kTile / 2];
      ring_sum<kDkv>(dp, smem, full, empty, n, nreg, c, live, lane);
      if (live) {
        // dS in place of dP.
#pragma unroll
        for (int e = 0; e < kTile / 2; ++e) {
          const int tc = 8 * (e / 4) + col + e % 2;
          const float dl = kDkv ? st_lse[kTile + tc] : delta_r[(e / 2) % 2];
          dp[e] = s[e] * (dp[e] - dl) * scale;
        }
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

template <bool kDkv>
cudaError_t run(void* scratch, const void* lse, const void* delta,
                void* out0, void* out1, int B, int H, int Sq, int Sk, int D,
                int q_off, int k_off, int causal, float scale,
                cudaStream_t stream) {
  using Sh = BwdShape<kDkv>;
  const Planes p = planes(scratch, B, H, Sq, Sk, D);
  const int sqp = padded_keys(Sq, kSeqPad), skp = padded_keys(Sk, kSeqPad);
  // The CTA's rows (box 128) and the tile's (box 64) of S and dP, and the
  // transposed factors (box kOut rows of D by 32 of the sequence).
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
  const int ctas = (rows + kRows - 1) / kRows * ((D + Sh::kOut - 1) / Sh::kOut);
  const dim3 grid = kHeadMajor ? dim3(ctas, B * H) : dim3(B * H, ctas);
  return launch_ws(flash_bwd_tf32<kDkv>, grid, Sh::kBytes + 1024, stream,
                   maps, (const float*)lse, (const float*)delta, (float*)out0,
                   (float*)out1, H, Sq, Sk, D, q_off, k_off, causal, scale);
}

}  // namespace
}  // namespace hvdt

// The backward's pre-pass, one per backward, which both kernels read.
// q, do: contiguous fp32 [B, Sq, H, D]; k, v: [B, Sk, H, D]; 16-byte-aligned
// bases; D a multiple of 32. scratch: fp32, 16-byte aligned, 4 B Sq H D +
// 4 B Sk H D + 2 B H D Skp + 4 B H D Sqp elements (Sqp, Skp: Sq and Sk
// rounded up to 64): q hi, q lo, do hi, do lo, k hi, k lo, v hi, v lo in
// their layout, then K^T hi and lo [B, H, D, Skp], Q^T hi and lo and dO^T
// hi and lo [B, H, D, Sqp], in that order.
extern "C" int hvdt_flash_bwd_tf32_split(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         void* scratch, int B, int H, int Sq,
                                         int Sk, int D, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 0 || D % 32) return cudaErrorInvalidValue;
  const hvdt::Planes p = hvdt::planes(scratch, B, H, Sq, Sk, D);
  const int sqp = hvdt::sm90::padded_keys(Sq, hvdt::kSeqPad);
  const int skp = hvdt::sm90::padded_keys(Sk, hvdt::kSeqPad);
  const size_t nq = (size_t)B * Sq * H * D, nk = (size_t)B * Sk * H * D;
  const int blocks = 132 * 8;
  const void* in[4] = {q, dout, k, v};
  float* hi[4] = {p.q, p.dout, p.k, p.v};
  float* lo[4] = {p.q_lo, p.do_lo, p.k_lo, p.v_lo};
  for (int i = 0; i < 4; ++i)
    hvdt::sm90::tf32_split<<<blocks, 256, 0, st>>>(
        (const float4*)in[i], (float4*)hi[i], (float4*)lo[i],
        (i < 2 ? nq : nk) / 4);
  hvdt::sm90::tf32_split_t<<<dim3(B * H, D / 32, skp / 32), 256, 0, st>>>(
      (const float*)k, p.kt, p.kt_lo, Sk, H, D, skp);
  hvdt::sm90::tf32_split_t<<<dim3(B * H, D / 32, sqp / 32), 256, 0, st>>>(
      (const float*)q, p.qt, p.qt_lo, Sq, H, D, sqp);
  hvdt::sm90::tf32_split_t<<<dim3(B * H, D / 32, sqp / 32), 256, 0, st>>>(
      (const float*)dout, p.dot, p.dot_lo, Sq, H, D, sqp);
  return cudaGetLastError();
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

// dk and dv through 3xTF32, as hvdt_flash_dq_tf32. dk, dv: fp32
// [B, Sk, H, D].
extern "C" int hvdt_flash_dkv_tf32(void* scratch, const void* lse,
                                   const void* delta, void* dk, void* dv,
                                   int B, int H, int Sq, int Sk, int D,
                                   int q_off, int k_off, int causal,
                                   float scale, void* stream) {
  if (D <= 0 || D % 32) return cudaErrorInvalidValue;
  return hvdt::run<true>(scratch, lse, delta, dk, dv, B, H, Sq, Sk, D,
                         q_off, k_off, causal, scale, (cudaStream_t)stream);
}
