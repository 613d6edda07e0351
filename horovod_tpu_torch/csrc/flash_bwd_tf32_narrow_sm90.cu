// Flash-attention backward for Hopper's tensor cores (sm_90a), fp32 at head
// dims 16 and 32 through 3xTF32: dq and dk/dv, the "tf32" design's narrow
// builds (the wrapper zero-pads D 1-15 to 16 and D 17-31 to 32 and passes
// the scale of the true D).
//
// Replaces the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` (with the
// shared recompute `_recompute_p_ds`) in
// horovod_tpu/parallel/flash_attention.py, launched by `_flash_bwd_bhsd`,
// for fp32 at D <= 32, where flash_bwd.cu's fp32-FMA kernels ran before;
// flash_bwd_tf32_sm90.cu takes fp32 past D 32, flash_dq_sm90.cu and
// flash_dkv_sm90.cu the 16-bit types. Same function and contract as
// flash_bwd_tf32_sm90.cu: for every visible (q, k) pair p = exp(s - lse)
// (lse = +inf on rows that saw no key, so p = 0 there) and ds = p (dp -
// delta) scale; dq = sum over k of ds k, dk = sum over q of ds^T q, dv =
// sum over q of p^T do, in fp32; runtime offsets shift the causal mask;
// stages wholly in the future are skipped; a warpgroup or a CTA that sees
// none contributes zeros; [B, S, H, D] outputs.
//
// What bounds it on this card. At the C4 shape (B 2, S 1024, H 8, causal)
// and D 32, dq does 1.61 GFLOP (s, dp, ds k) and dk/dv 2.15 (s, dp, p^T do,
// ds^T q): 3xTF32 takes each product as three tf32 products, 0.0098 and
// 0.0130 ms at the 494.7 TFLOP/s tf32 peak, against 0.0240 and 0.0321 ms
// for the same products as fp32 FMAs and 0.0032 / 0.0038 ms for the bytes
// in and out. At D 16 all of these halve. As in the narrow tf32 forward
// (flash_fwd_tf32_narrow_sm90.cu), no term is large: one warpgroup's serial
// chain of steps per stage (the TMA wait, S and dP, p and ds, the output
// products) binds unless several warpgroups share a CTA's stages, and then
// the count of small products (m64nNk8 tf32 wgmmas with N 16 to 64) and
// the pre-pass beside the kernels. On an H100 (PERF.md) dq takes 0.031 ms
// and dk/dv 0.043 at D 32, about 3.2 times their tf32 bounds; one
// warpgroup a CTA took 1.07-1.45 times as long.
//
// Operands: the backward's pre-pass (hvdt_flash_bwd_tf32_split, one launch
// of sm90_common.cuh's tf32_bwd_split_all, run once for both kernels) writes
// q, do, k, v split into hi = tf32(x) and lo = tf32(x - hi) in their [B,
// S, H, D] layout, and K^T, Q^T, dO^T hi and lo as [B, H, D, S rounded up
// to 64] with the rows of every 8 permuted so that an accumulator fragment
// (dS, P^T, dS^T) is tf32 wgmma's register A operand with no shuffle. Each
// product is lo.hi + hi.lo + hi.hi in m64nNk8 tf32 wgmmas with fp32
// accumulators: S = Q K^T and dP = dO V^T (dq) or S^T = K Q^T and dP^T =
// V dO^T (dk/dv), N = the stage's rows, each into an accumulator of its
// own, dP's k8 steps each into one of its own (kDpSteps); then each
// stage's output product (dS K; P^T dO and dS^T Q) into a fresh
// accumulator folded into the output by fp32 adds (kSplitChains in
// flash_fwd_stream_sm90.cu says why one chain is not enough). [rows][D]
// tiles have rows of 64 or 128 bytes: TMA writes them in the swizzle of
// that width (encode_bshd) and wgmma reads them through descriptors of the
// same mode; the transposed tiles are [D][32 rows] regions of 128 bytes.
//
// Structure (the narrow tf32 forward's). A CTA owns 64 rows (wgmma's M):
// a q tile for dq (Q and dO hi and lo resident, and each thread's rows' lse
// and delta in registers), a kv tile for dk/dv (K and V hi and lo
// resident). G consumer warpgroups (kDqSplit, kDkvSplit) all hold those
// rows and take the other sequence's stages round-robin (dq: kv stages of
// kDqKv keys, j = w, w + G, ...; dk/dv: q stages of kDkvQ queries from the
// first one the tile sees), each through a ring of its own (dq: K, V and
// K^T hi and lo; dk/dv: Q, dO, Q^T and dO^T hi and lo) fed by lane w of the
// one producer warp, which waits on that warpgroup's barriers alone; lane 0
// also loads the resident tiles. dk/dv's consumers load their stage's lse
// and delta from memory themselves before waiting for it. Per stage: S and
// dP issued together, one wait; p = exp2(s scale log2 e - lse log2 e),
// masked only on stages that cross the diagonal or a ragged end (TMA
// zero-fills rows past S and the p of a zero score is not zero; rows past
// Sq have lse = +inf, so p = 0); ds = p (dp - delta) scale from the
// unrounded p; p (dk/dv) and ds split into hi and lo in registers; the
// output products. After its last stage, warpgroups 1 .. G - 1 leave their
// partial dQ (dK and dV) in their own rings behind a named barrier
// (kSumBar) and warpgroup 0 adds them to its own in the order w = 1, 2,
// ... and stores them, masked past S: the same bits from run to run. A
// warpgroup with no stage (S 32, S 1, a causal first q tile, a kv tile past
// every query) passes the barrier with zeros. The grid is (B H, tiles),
// the heaviest causal tiles first (dq: the last q tiles; dk/dv: the first
// kv tiles). tools/narrow_bwd_tf32_variants.py rebuilds this file with
// other constants (PERF.md has its table).
//
// The constants are tools/narrow_bwd_tf32_variants.py's choice on an H100
// (PERF.md): dq 2 warpgroups on 64-key stages (4 on 32-key stages, the
// design first sized, took 1.06x at C4 D 16 and 32), dk/dv 3 on 32-query
// stages (2 took 1.00-1.05x, 1 1.17-1.45x; 64-query stages, 4 warpgroups
// on one stage each and 3 stages of 2 warpgroups were slower).
//
// Budgets at D 32 (of 232,448 B of shared memory; at D 16 every tile
// halves). dq: Q and dO hi and lo 4 x 64 x 128 = 32,768 B resident; a
// 64-key stage K, V and K^T hi and lo 6 x 64 x 128 = 49,152 B; G 2 rings
// of 2 stages 196,608 B; 229,448 B with the barriers (230,472 with the
// 1 KB alignment pad). dk/dv: K and V hi and lo 32,768 B resident; a
// 32-query stage Q, dO, Q^T and dO^T hi and lo 8 x 32 x 128 = 32,768 B;
// G 3 rings of 2 stages 196,608 B; 229,480 B with the barriers (230,504).
// Registers of a consumer thread: dq holds dQ (D / 2 = 16), S (then P and
// dS lo, kDqKv / 2 = 32), dP 32, a k8 step of dP 32, dS hi 32 and the
// stage's product 16; dk/dv holds dK and dV 32, S^T and dP^T 32, a k8
// step of dP^T 16, the split's hi 16, the product 16 and its stage's lse
// and delta 16: under the 224 (dq, 2 x 128 + 32 threads) and 152 (dk/dv,
// 3 x 128 + 32) a thread that one CTA an SM leaves; ptxas reports no
// spill.
#include "flash_common.cuh"
#include "sm90_common.cuh"

#include <utility>

namespace hvdt {
namespace {

using namespace sm90;

constexpr int kDqSplit = 2;     // dq: consumer warpgroups on a q tile
constexpr int kDqKv = 64;       // dq: keys of a kv stage
constexpr int kDqStages = 2;    // dq: stages of each warpgroup's ring
constexpr int kDkvSplit = 3;    // dk/dv: consumer warpgroups on a kv tile
constexpr int kDkvQ = 32;       // dk/dv: queries of a q stage
constexpr int kDkvStages = 2;   // dk/dv: stages of each warpgroup's ring
constexpr int kRows = 64;       // rows of a CTA: queries (dq), keys (dk/dv)
// dP (dP^T) with each k8 step of D in an accumulator of its own, the steps
// added by fp32 adds (true), or in one chain over D (false). The tensor
// cores' adds do not round to nearest (flash_bwd_tf32_sm90.cu), so a
// chain's error grows with its running sum. Where ds is only the rounding
// noise of dp - delta (a query and a key that see only each other: S 1),
// one chain left dk at up to 1.94 times the fp32 bound at D 32 over 100
// input sets on an H100, the steps at 0.91 (tools/narrow_bwd_tf32_variants.py;
// the plain version's own noise there is of the same size, PERF.md).
constexpr bool kDpSteps = true;
// The consumer warpgroups' named barrier: their partial sums.
constexpr int kSumBar = 1;

// The constants of one kernel: dq (kDkv false) or dk/dv.
template <bool kDkv>
struct Split {
  static constexpr int kG = kDkv ? kDkvSplit : kDqSplit;
  static constexpr int kN = kDkv ? kDkvQ : kDqKv;  // rows of a stage
  static constexpr int kStages = kDkv ? kDkvStages : kDqStages;
  static constexpr int kOps = kDkv ? 2 : 1;  // transposed factors a stage holds
  static constexpr int kThreads = 128 * kG + 32;
};

template <bool kDkv, int D>
struct NarrowBwdSmem {
  using C = Split<kDkv>;
  static constexpr int kRowBytes = D * 4;            // 64 or 128
  static constexpr int kTileR = kRows * kRowBytes;   // a resident [64][D]
  static constexpr int kTileN = C::kN * kRowBytes;   // a stage's [kN][D]
  static constexpr int kRegionT = D * 128;           // [D][32 rows]
  static constexpr int kPlaneT = C::kN / 32 * kRegionT;
  // A stage: the two operands of S and dP (dq: K, V; dk/dv: Q, dO) hi and
  // lo, then the transposed factors hi and lo (dq: K^T; dk/dv: Q^T, dO^T).
  static constexpr int kT = 4 * kTileN;
  static constexpr int kStage = kT + 2 * C::kOps * kPlaneT;
  static constexpr int kRing = C::kStages * kStage;  // a warpgroup's
  // The resident tiles at 0: dq Q hi, Q lo, dO hi, dO lo; dk/dv K and V.
  static constexpr int kRings = 4 * kTileR;
  static constexpr int kBar = kRings + C::kG * kRing;
  // res_full, full[G][stages], empty[G][stages]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * C::kG * C::kStages);
  // A warpgroup's partial output (D / 2 fp32 a thread for each of dQ, or
  // dK and dV), written over its own ring after its last stage.
  static constexpr int kPart = C::kOps * (D / 2) * 128 * 4;
  static_assert(D == 16 || D == 32, "narrow tf32 builds: D 16 and 32");
  static_assert(C::kN == 32 || C::kN == 64,
                "stages of one or two 32-row transposed regions");
  static_assert(kTileR % 1024 == 0 && kTileN % 1024 == 0 &&
                    kRegionT % 1024 == 0 && kStage % 1024 == 0,
                "swizzled tiles start on 1024-byte boundaries");
  static_assert(kPart <= kRing, "a partial output exceeds its ring");
  static_assert(kBytes + 1024 <= 232448,
                "narrow tf32 backward tiles exceed shared memory");
};

// The tensor maps of one kernel: the resident tiles (dq Q, dO; dk/dv K,
// V), the stage's operands of S and dP (dq K, V; dk/dv Q, dO), each as
// [hi, lo], and the transposed factors (dq K^T; dk/dv Q^T then dO^T).
struct NarrowMaps {
  CUtensorMap res[4], stage[4], t[2][2];
};

// s = A B^T as tf32x3_scores takes it, but each k8 step (lo.hi, hi.lo,
// then hi.hi of its 8 columns of D) in the fresh accumulator t, added to s
// by fp32 adds (kDpSteps); waits for the products, and for any issued
// before.
template <int D, int N>
__device__ __forceinline__ void scores_by_step(float (&s)[N / 2], uint32_t a,
                                               uint32_t a_lo, uint32_t b,
                                               uint32_t b_lo) {
  constexpr int kRB = D * 4;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    float t[N / 2];
    fence_regs(t);
    wgmma_fence();
    wgmma_tf32_ss<N>(t, desc_rows<kRB>(a_lo + 32 * kk),
                     desc_rows<kRB>(b + 32 * kk), 0);
    wgmma_tf32_ss<N>(t, desc_rows<kRB>(a + 32 * kk),
                     desc_rows<kRB>(b_lo + 32 * kk), 1);
    wgmma_tf32_ss<N>(t, desc_rows<kRB>(a + 32 * kk),
                     desc_rows<kRB>(b + 32 * kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(t);
#pragma unroll
    for (int e = 0; e < N / 2; ++e) s[e] = kk > 0 ? s[e] + t[e] : t[e];
  }
}

// kDkv false: dq (out0 = dq, [B, Sq, H, D]). kDkv true: dk/dv (out0 = dk,
// out1 = dv, [B, Sk, H, D]).
template <bool kDkv, int D>
__global__ void __launch_bounds__(Split<kDkv>::kThreads, 1)
    flash_bwd_tf32_narrow(const __grid_constant__ NarrowMaps maps,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ out0, float* __restrict__ out1,
                          int H, int Sq, int Sk, int q_off, int k_off,
                          int causal, float scale) {
  using C = Split<kDkv>;
  using L = NarrowBwdSmem<kDkv, D>;
  constexpr int kG = C::kG, kN = C::kN, kStg = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* res_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = res_full + 1;  // [G][stages]
  uint64_t* empty = full + kG * kStg;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  // The CTA's first row: the last q tiles first (dq), the first kv tiles
  // first (dk/dv), the heaviest causal tiles either way. Its stages [j0,
  // n) of the other sequence.
  const int r0 = kDkv ? blockIdx.y * kRows
                      : (gridDim.y - 1 - blockIdx.y) * kRows;
  int j0 = 0, n = ((kDkv ? Sq : Sk) + kN - 1) / kN;
  if (causal) {
    if constexpr (kDkv) {
      // q stage u is visible once q_off + kN u + kN - 1 >= k_off + r0.
      const long long need = (long long)k_off + r0 - q_off - (kN - 1);
      j0 = need <= 0 ? 0 : (int)min((long long)n, (need + kN - 1) / kN);
    } else {
      // kv stage j is visible while k_off + kN j <= q_off + r0 + 63.
      const long long reach = (long long)q_off + r0 + kRows - 1 - k_off;
      n = min(n, reach < 0 ? 0 : (int)(reach / kN) + 1);
    }
  }
  // Stages of warpgroup w: j0 + w + G i for i < stages_of(w).
  auto stages_of = [&](int w) {
    return n - j0 > w ? (n - j0 - w + kG - 1) / kG : 0;
  };

  if (threadIdx.x == 0) {
    bar_init(res_full, 1);
    for (int s = 0; s < kG * kStg; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 4);  // lane 0 of each warp of the warpgroup
    }
    bar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == 4 * kG) {
    // Producer: the last warp. Lane 0 loads the resident tiles; lane w < G
    // feeds warpgroup w's ring, waiting on that warpgroup's barriers alone.
    const int w = threadIdx.x % 32;
    if (w == 0) {
      bar_arrive_tx(res_full, 4 * L::kTileR);
#pragma unroll
      for (int x = 0; x < 4; ++x)
        tma_load_4d(smem + x * L::kTileR, &maps.res[x], res_full, 0, h, r0,
                    b);
    }
    if (w < kG) {
      const int nw = stages_of(w);
      uint8_t* ring = smem + L::kRings + w * L::kRing;
      uint64_t* fb = full + w * kStg;
      uint64_t* eb = empty + w * kStg;
      for (int i = 0; i < nw; ++i) {
        const int st = i % kStg, row = (j0 + w + kG * i) * kN;
        uint8_t* stage = ring + st * L::kStage;
        // Stage st is free once the warpgroup released load i - kStg.
        if (i >= kStg) bar_wait(&eb[st], ((i / kStg) & 1) ^ 1);
        bar_arrive_tx(&fb[st], L::kStage);
#pragma unroll
        for (int x = 0; x < 4; ++x)
          tma_load_4d(stage + x * L::kTileN, &maps.stage[x], &fb[st], 0, h,
                      row, b);
#pragma unroll
        for (int op = 0; op < C::kOps; ++op)
#pragma unroll
          for (int pl = 0; pl < 2; ++pl)
#pragma unroll
            for (int r = 0; r < kN / 32; ++r)
              tma_load_4d(stage + L::kT + (2 * op + pl) * L::kPlaneT +
                              r * L::kRegionT,
                          &maps.t[op][pl], &fb[st], row + 32 * r, 0, h, b);
      }
    }
    return;
  }

  // Consumers: warpgroup w, all on the CTA's 64 rows.
  const int w = warp / 4;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int row0 = 16 * (t / 32) + lane / 4;  // +8 for i = 1
  const int col = 2 * (lane % 4);             // the stage rows of each 8
  const uint32_t a = smem_u32(smem), a_lo = a + L::kTileR;
  const uint32_t a2 = a + 2 * L::kTileR, a2_lo = a + 3 * L::kTileR;
  const uint32_t ring = smem_u32(smem + L::kRings + w * L::kRing);
  uint64_t* fb = full + w * kStg;
  uint64_t* eb = empty + w * kStg;
  // The place of the CTA's first row, and of this thread's.
  const int first = (kDkv ? k_off : q_off) + r0, pos0 = first + row0;
  const int len = kDkv ? Sq : Sk;  // the stages' sequence
  const float scale_log2 = scale * kLog2e;
  const int nw = stages_of(w);

  // dq: the rows' lse (pre-scaled by log2 e) and delta; rows past Sq get
  // lse = +inf, so their p is exactly 0.
  float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
  if constexpr (!kDkv) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + row0 + 8 * i;
      lse_r[i] = row < Sq ? lse[(size_t)bh * Sq + row] * kLog2e
                          : __int_as_float(0x7f800000);
      delta_r[i] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
    }
  }

  float acc0[D / 2], acc1[kDkv ? D / 2 : 1];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc0[e] = 0.f;
#pragma unroll
  for (int e = 0; e < (kDkv ? D / 2 : 1); ++e) acc1[e] = 0.f;

  bar_wait(res_full, 0);
  for (int i = 0; i < nw; ++i) {
    const int st = i % kStg, n0 = (j0 + w + kG * i) * kN;
    const uint32_t stage = ring + st * L::kStage;
    // dk/dv: the stage's lse (pre-scaled; +inf past Sq) and delta of this
    // thread's columns, 8 g + col + e2, loaded before the stage is waited
    // for: the loads clamped to the last row, the values past Sq chosen
    // after them.
    float l2[kDkv ? kN / 4 : 1], dl[kDkv ? kN / 4 : 1];
    if constexpr (kDkv) {
#pragma unroll
      for (int g = 0; g < kN / 8; ++g)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int qr = n0 + 8 * g + col + e2;
          const size_t at = (size_t)bh * Sq + min(qr, Sq - 1);
          const float lv = __ldg(lse + at), dv = __ldg(delta + at);
          l2[2 * g + e2] = qr < Sq ? lv * kLog2e : __int_as_float(0x7f800000);
          dl[2 * g + e2] = qr < Sq ? dv : 0.f;
        }
    }
    bar_wait(&fb[st], (i / kStg) & 1);
    float s[kN / 2], dp[kN / 2];
    tf32x3_scores<D, kN>(s, a, a_lo, stage, stage + L::kTileN);
    if constexpr (kDpSteps) {
      scores_by_step<D, kN>(dp, a2, a2_lo, stage + 2 * L::kTileN,
                            stage + 3 * L::kTileN);
    } else {
      tf32x3_scores<D, kN>(dp, a2, a2_lo, stage + 2 * L::kTileN,
                           stage + 3 * L::kTileN);
      wgmma_wait<0>();
    }
    fence_regs(s);
    fence_regs(dp);

    // Whether some pair of the stage is hidden: the diagonal or a ragged
    // end (the CTA's first row against the stage's last, or the reverse).
    const bool masked =
        n0 + kN > len ||
        (causal && (kDkv ? q_off + n0 < first + kRows - 1
                         : k_off + n0 + kN - 1 > first));
    // P in place of S, then dS = P (dP - delta) scale in place of dP.
#pragma unroll
    for (int e = 0; e < kN / 2; ++e) {
      const int ri = (e / 2) % 2, c = 8 * (e / 4) + col + e % 2;
      const int si = 2 * (e / 4) + e % 2;  // its index in l2 and dl
      const float l = kDkv ? l2[si] : lse_r[ri];
      float p = exp2f(fmaf(s[e], scale_log2, -l));
      if (masked) {
        const int rpos = pos0 + 8 * ri;
        const int npos = (kDkv ? q_off : k_off) + n0 + c;
        const bool ok = n0 + c < len &&
                        (!causal || (kDkv ? npos >= rpos : rpos >= npos));
        p = ok ? p : 0.f;
      }
      s[e] = p;
      dp[e] = p * (dp[e] - (kDkv ? dl[si] : delta_r[ri])) * scale;
    }
    const uint32_t tt = stage + L::kT;
    uint32_t hi[kN / 2];
    float part[D / 2];
    if constexpr (kDkv) {
      // dV += P^T dO, from dO^T (the stage's second transposed factor).
      split_tf32(s, hi);
      tf32x3_reg_product<D, kN>(part, hi, s, tt + 2 * L::kPlaneT,
                                tt + 3 * L::kPlaneT);
#pragma unroll
      for (int e = 0; e < D / 2; ++e) acc1[e] += part[e];
    }
    // dQ += dS K (from K^T), or dK += dS^T Q (from Q^T).
    split_tf32(dp, hi);
    tf32x3_reg_product<D, kN>(part, hi, dp, tt, tt + L::kPlaneT);
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc0[e] += part[e];
    __syncwarp();
    if (lane == 0) bar_arrive(&eb[st]);
  }

  if constexpr (kG > 1) {
    // Warpgroups 1 .. G - 1 leave their partial outputs in their rings
    // (whose last reads, by TMA and wgmma, are done); warpgroup 0 adds them
    // to its own in warpgroup order.
    if (w > 0) {
      float* part = reinterpret_cast<float*>(smem + L::kRings + w * L::kRing);
      fence_proxy_async();
#pragma unroll
      for (int e = 0; e < D / 2; ++e) part[e * 128 + t] = acc0[e];
      if constexpr (kDkv) {
#pragma unroll
        for (int e = 0; e < D / 2; ++e) part[(D / 2 + e) * 128 + t] = acc1[e];
      }
      named_bar_arrive(kSumBar, 128 * kG);
      return;
    }
    named_bar_sync(kSumBar, 128 * kG);
#pragma unroll
    for (int u = 1; u < kG; ++u) {
      const float* part =
          reinterpret_cast<const float*>(smem + L::kRings + u * L::kRing);
#pragma unroll
      for (int e = 0; e < D / 2; ++e) acc0[e] += part[e * 128 + t];
      if constexpr (kDkv) {
#pragma unroll
        for (int e = 0; e < D / 2; ++e)
          acc1[e] += part[(D / 2 + e) * 128 + t];
      }
    }
  }
  const int rows = kDkv ? Sk : Sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + row0 + 8 * i;
    if (row >= rows) continue;
    const size_t off = ((size_t)(b * rows + row) * H + h) * D + col;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      store2<float>(out0 + off + 8 * jj, acc0[4 * jj + 2 * i],
                    acc0[4 * jj + 2 * i + 1]);
      if constexpr (kDkv)
        store2<float>(out1 + off + 8 * jj, acc1[4 * jj + 2 * i],
                      acc1[4 * jj + 2 * i + 1]);
    }
  }
}

template <bool kDkv, int D>
cudaError_t run_narrow(void* scratch, const void* lse, const void* delta,
                       void* out0, void* out1, int B, int H, int Sq, int Sk,
                       int q_off, int k_off, int causal, float scale,
                       cudaStream_t stream) {
  using C = Split<kDkv>;
  using L = NarrowBwdSmem<kDkv, D>;
  const Tf32BwdPlanes p = tf32_bwd_planes(scratch, B, H, Sq, Sk, D);
  const int sqp = padded_keys(Sq, kTf32BwdSeqPad);
  const int skp = padded_keys(Sk, kTf32BwdSeqPad);
  // dq: Q, dO resident, K, V a stage, K^T; dk/dv: K, V resident, Q, dO a
  // stage, Q^T and dO^T.
  const float* res[4] = {p.q, p.q_lo, p.dout, p.do_lo};
  const float* stage[4] = {p.k, p.k_lo, p.v, p.v_lo};
  const float* tr[2][2] = {{p.kt, p.kt_lo}, {p.kt, p.kt_lo}};
  int rows = Sq, len = Sk, tp = skp;
  if constexpr (kDkv) {
    for (int x = 0; x < 4; ++x) std::swap(res[x], stage[x]);
    tr[0][0] = p.qt;
    tr[0][1] = p.qt_lo;
    tr[1][0] = p.dot;
    tr[1][1] = p.dot_lo;
    rows = Sk;
    len = Sq;
    tp = sqp;
  }
  NarrowMaps maps;
  cudaError_t err = cudaSuccess;
  for (int x = 0; x < 4 && err == cudaSuccess; ++x) {
    err = encode_bshd<float>(&maps.res[x], res[x], B, rows, H, D, kRows);
    if (err == cudaSuccess)
      err = encode_bshd<float>(&maps.stage[x], stage[x], B, len, H, D,
                               C::kN);
  }
  for (int op = 0; op < C::kOps && err == cudaSuccess; ++op)
    for (int pl = 0; pl < 2 && err == cudaSuccess; ++pl)
      err = encode_bhds<float>(&maps.t[op][pl], tr[op][pl], B, H, D, tp, D);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (rows + kRows - 1) / kRows);
  return launch_threads(flash_bwd_tf32_narrow<kDkv, D>, grid, C::kThreads,
                        L::kBytes + 1024, stream, maps, (const float*)lse,
                        (const float*)delta, (float*)out0, (float*)out1, H,
                        Sq, Sk, q_off, k_off, causal, scale);
}

template <bool kDkv>
cudaError_t run_for_dim(void* scratch, const void* lse, const void* delta,
                        void* out0, void* out1, int B, int H, int Sq, int Sk,
                        int D, int q_off, int k_off, int causal, float scale,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 16)
    return run_narrow<kDkv, 16>(scratch, lse, delta, out0, out1, B, H, Sq,
                                Sk, q_off, k_off, causal, scale, st);
  if (D == 32)
    return run_narrow<kDkv, 32>(scratch, lse, delta, out0, out1, B, H, Sq,
                                Sk, q_off, k_off, causal, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace hvdt

// dq through 3xTF32 at head dim 16 or 32, from the backward pre-pass's
// scratch (hvdt_flash_bwd_tf32_split of the same B, H, Sq, Sk, D).
// Arguments as for hvdt_flash_dq_tf32 in flash_bwd_tf32_sm90.cu: lse,
// delta fp32 [B, H, Sq]; dq fp32 [B, Sq, H, D]; scale multiplies the
// logits (1/sqrt of the head dim before any zero padding of D).
extern "C" int hvdt_flash_dq_tf32_narrow(void* scratch, const void* lse,
                                         const void* delta, void* dq, int B,
                                         int H, int Sq, int Sk, int D,
                                         int q_off, int k_off, int causal,
                                         float scale, void* stream) {
  return hvdt::run_for_dim<false>(scratch, lse, delta, dq, nullptr, B, H, Sq,
                                  Sk, D, q_off, k_off, causal, scale, stream);
}

// dk and dv through 3xTF32 at head dim 16 or 32, as
// hvdt_flash_dq_tf32_narrow. dk, dv: fp32 [B, Sk, H, D].
extern "C" int hvdt_flash_dkv_tf32_narrow(void* scratch, const void* lse,
                                          const void* delta, void* dk,
                                          void* dv, int B, int H, int Sq,
                                          int Sk, int D, int q_off,
                                          int k_off, int causal, float scale,
                                          void* stream) {
  return hvdt::run_for_dim<true>(scratch, lse, delta, dk, dv, B, H, Sq, Sk,
                                 D, q_off, k_off, causal, scale, stream);
}
