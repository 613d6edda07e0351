// Flash-attention dq backward for Hopper's tensor cores (sm_90a), streamed
// over the head dim: bf16 and fp16 at every multiple of 64 past 256 (the
// "stream" design of dq). One template over the element type serves both.
//
// Replaces the TPU kernel `_bwd_dq_kernel` (with the shared recompute
// `_recompute_p_ds`) in horovod_tpu/parallel/flash_attention.py, launched by
// `_flash_bwd_bhsd`, as flash_dq_sm90.cu does for 16-bit head dims up to
// 256 and flash_bwd_tf32_sm90.cu for fp32. Same function: for every visible
// (q, k) pair recompute p = exp(s - lse) and ds = p (dp - delta) scale from
// q, k, v, do and the forward's per-row lse (+inf on rows that saw no key,
// so p is exactly 0 there) and delta = rowsum(do * o); then dq = sum over k
// of ds k, accumulated in fp32 and written in the input's type. Runtime
// offsets shift the causal mask; kv tiles wholly in the future are skipped;
// a CTA that sees no kv tile writes zeros.
//
// What bounds it on this card. Three matrix products per visible pair (s,
// dp, ds k) against five [B, S, H, D] tensors moved: at bf16 D 640 (B 2,
// S 1024, H 8, causal) 3.2e10 operations over 105 MB, about 300 operations
// per byte, at the card's balance point (989 TFLOP/s of bf16 or fp16 over
// 3.35 TB/s); and this design does more products than the function (below),
// so the tensor cores are the limit. It also reads the CTA's Q and dO
// regions again from L2 for every kv tile; which of the two holds it back
// has not been measured (no ncu).
//
// Why streamed. flash_dq_sm90.cu keeps the CTA's Q and dO tiles resident:
// at D 256 they take 128 KB of shared memory and dQ 128 registers a
// consumer thread, and nothing larger fits. Here no tile spans the head
// dim, so shared memory does not grow with D and any multiple of 64 runs
// (D 320 natively; the wrapper zero-pads any other D to the next one). No
// tf32 machinery is needed (flash_bwd_tf32_sm90.cu's hi and lo planes and
// transposed pre-pass): a 16-bit wgmma B operand can be MN-major, so dQ +=
// dS K reads K's rows as they lie in [B, S, H, D].
//
// Design. One CTA per (128-row q tile, part of dq's head dim, batch*head);
// the grid is head-major, (q tiles x parts, B H): one head's CTAs run side
// by side and find its K and V in L2 (that order took the tf32 dq from
// 2.69 to 1.79 ms at the fp32 main shape, tools/bwd_tf32_variants.py), the
// heaviest causal q tiles first and a tile's parts together. Three
// warpgroups:
// - a producer, which gives its registers away (setmaxnreg) and whose one
//   elected thread issues every copy as a TMA load: per kv tile, first
//   the tile's K for the CTA's part of dq ([64 keys][kOut], the regions
//   past D neither loaded nor used) into one of kStagesK stages, then the
//   ring: for S, then for dP, D / 64 stages of one 128-byte column region
//   each, [128][64] of Q (then dO) and [64][64] of K (then V);
// - two consumers, each owning 64 q rows (wgmma's M), which take the
//   registers and keep their rows' lse (pre-scaled by log2 e) and delta in
//   them. Per kv tile:
//     S = sum over regions of Q_r K_r^T, dP = sum of dO_r V_r^T
//                                (m64n64k16 from shared memory, both
//                                 K-major, each region's products in an
//                                 accumulator of their own, below)
//     P = exp(S scale - lse)     (masked only on tiles that cross the
//                                 diagonal or the ragged end of Sk: TMA
//                                 zero-fills keys past Sk, and the p of a
//                                 zero score is not zero)
//     dS = P (dP - delta) scale  (to the input's type in registers as
//                                 wgmma's A)
//     dQ_part += dS K_part       (m64 n kOut k16, K's part from its own
//                                 stage as an MN-major B)
//   A kv tile wholly in the future of a consumer's 64 rows is waited for
//   and released without a product.
// Each CTA owns its dq rows and columns: no atomics, no second pass. 16-bit
// ds is what the reference's dots take on the TPU by default; the checks
// allow for exactly that rounding, in the input's type.
//
// The part width, kOut = 256, the widest wgmma N. Every part pays S and dP
// again (2 D operations per pair each) and its own dQ product (2 kOut,
// whatever part of it lies within D), so at D 640 three parts (256 + 256 +
// 128) do 3 (4 x 640 + 2 x 256) / (3 x 2 x 640) = 2.4 times the function's
// products, and five parts of 128 would do 3.7 times; at D 320 two parts
// do 1.9 times and three of 128 2.4 times.
// tools/dq_variants.py builds this file with kOut 128 and times it
// against the package's build (PERF.md records the times).
//
// Each region's S and dP go to an accumulator of their own and are summed
// by fp32 adds (kSplitChains), as in the tf32 kernels: the tensor cores add
// into their accumulator without rounding to nearest, so one chain over
// all of D drifts. Most rows do not notice (the 16-bit check allows twice
// the effect of rounding ds), but a query that sees one key has p = 1 and
// dp = delta, so its dq is the rounding noise of dp - delta times scale
// and k, held only by the absolute floor (DQ_ATOL, 1e-5); |dp| grows as
// sqrt(D). With one chain, an H100 80GB HBM3 at 700 W put that row at 1.30
// of its bound at fp16 D 640 (C4 shape: B 2, S 1024, H 8, causal) and 1.09
// at D 768, against 0.54 and 0.47 with a chain per region
// (tools/dq_variants.py builds the one-chain variant). The cost: a
// region's products are waited for before the next region's are issued.
//
// Registers of a consumer thread (setmaxnreg gives 240): dQ's part 128, S
// 32, dP 32 and the region's product 32 while dP is summed (224), then dS
// packed to 16 while S, turned into dS, is read (176); the rest holds
// addresses, the rows' stats and loop state. Shared memory (the same for
// any D): a ring stage is
// 128x64x2 + 64x64x2 = 24,576 B, a K stage 64x256x2 = 32,768 B; 6 + 2
// stages = 212,992 B, with 128 B of barriers and the 1 KB alignment pad
// 214,144 of 232,448.
#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace hvdt {
namespace {

using namespace sm90;

constexpr int kRows = 128;   // q rows of a CTA
constexpr int kKeys = 64;    // keys of a kv tile
constexpr int kCols = 64;    // 16-bit columns of a 128-byte region
constexpr int kOut = 256;    // columns of dq a CTA owns
constexpr int kStages = 6;   // ring stages
constexpr int kStagesK = 2;  // stages of K's part
// Each region's products in an accumulator of their own, summed by fp32
// adds (see the header). tools/dq_variants.py builds this file with false,
// one chain for S and one for dP, to measure why.
constexpr bool kSplitChains = true;

struct StreamDqSmem {
  static constexpr int kRegionQ = kRows * 128;   // [128][64] 16-bit
  static constexpr int kRegionK = kKeys * 128;   // [64][64] 16-bit
  static constexpr int kStage = kRegionQ + kRegionK;
  static constexpr int kStageK = (kOut / kCols) * kRegionK;  // [64][kOut]
  static constexpr int kRing = 0;
  static constexpr int kK = kRing + kStages * kStage;
  static constexpr int kBar = kK + kStagesK * kStageK;
  // full and empty per ring stage, k_full and k_empty per K stage
  static constexpr int kBytes = kBar + 8 * 2 * (kStages + kStagesK);
  static_assert(kBytes + 1024 <= 232448,
                "stream dq tiles exceed shared memory");
  // fp32 registers of a consumer thread at its peak: dQ's part, S, dP and
  // a region's product.
  static_assert(kOut / 2 + 3 * kKeys / 2 <= 224,
                "stream dq accumulators exceed the consumer registers");
};

// acc = the sum over the D / 64 regions of one ring pass of A_r B_r^T (Q_r
// K_r^T or dO_r V_r^T): with kSplitChains each region's products in an
// accumulator of their own, summed by fp32 adds; else one chain, one
// region's products left in flight while the next region's copy is
// awaited. Each stage goes back to the producer once its products are
// done. `n` counts the ring stages consumed. A warpgroup
// whose rows do not see the tile (`live` false) waits for each stage and
// releases it without a product.
template <typename T>
__device__ __forceinline__ void ring_sum(float (&acc)[kKeys / 2],
                                         uint8_t* smem, uint64_t* full,
                                         uint64_t* empty, int& n, int nreg,
                                         int c, bool live, int lane) {
  using L = StreamDqSmem;
  for (int r = 0; r < nreg; ++r, ++n) {
    const int st = n % kStages;
    const uint32_t stage = smem_u32(smem + L::kRing + st * L::kStage);
    const uint32_t a = stage + c * 64 * 128;  // this warpgroup's 64 rows
    const uint32_t b = stage + L::kRegionQ;
    bar_wait(&full[st], (n / kStages) & 1);
    if (live && kSplitChains) {
      float part[kKeys / 2];
      fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<kKeys, T>(part, desc_sw128(a + 32 * kk, 16),
                           desc_sw128(b + 32 * kk, 16), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int e = 0; e < kKeys / 2; ++e)
        acc[e] = r > 0 ? acc[e] + part[e] : part[e];
    } else if (live) {
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<kKeys, T>(acc, desc_sw128(a + 32 * kk, 16),
                           desc_sw128(b + 32 * kk, 16), r > 0 || kk > 0);
      wgmma_commit();
      fence_regs(acc);
      // The region before is done; its stage goes back to the producer.
      wgmma_wait<1>();
    }
    if (r > 0) {
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[(n - 1) % kStages]);
    }
  }
  if (live && !kSplitChains) {
    wgmma_wait<0>();
    fence_regs(acc);
  }
  if (nreg > 0) {
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[(n - 1) % kStages]);
  }
}

template <typename T>
__global__ void __launch_bounds__(384, 1)
    flash_dq_stream(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int Sq, int Sk, int D, int q_off, int k_off,
                    int causal, float scale) {
  using L = StreamDqSmem;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* k_full = empty + kStages;
  uint64_t* k_empty = k_full + kStagesK;

  // The CTA's (q tile, part) index runs fastest, so that the CTAs that
  // stream one head's K and V run together and find them in L2.
  const int bh = blockIdx.y, cta = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int nparts = (D + kOut - 1) / kOut;
  const int c0 = (cta % nparts) * kOut;  // the first column of dq it owns
  const int q0 = ((Sq + kRows - 1) / kRows - 1 - cta / nparts) * kRows;
  const int nreg = D / kCols;
  int nk = (Sk + kKeys - 1) / kKeys;
  if (causal) {
    // kv tile j is visible while k_off + 64 j <= q_off + q0 + 127.
    const long long reach = (long long)q_off + q0 + kRows - 1 - k_off;
    nk = min(nk, reach < 0 ? 0 : (int)(reach / kKeys) + 1);
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < kStagesK; ++s) {
      bar_init(&k_full[s], 1);
      bar_init(&k_empty[s], 8);
    }
    bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer.
    regs_dec<24>();
    if (threadIdx.x == 0) {
      // The regions of K's part that lie within D (the last part's others
      // are neither loaded nor stored).
      const int k_regions = min(kOut, D - c0) / kCols;
      int n = 0;  // ring stages issued so far
      for (int j = 0; j < nk; ++j) {
        const int sk = j % kStagesK;
        if (j >= kStagesK) bar_wait(&k_empty[sk], ((j / kStagesK) & 1) ^ 1);
        uint8_t* kt = smem + L::kK + sk * L::kStageK;
        bar_arrive_tx(&k_full[sk], k_regions * L::kRegionK);
        for (int rr = 0; rr < k_regions; ++rr)
          tma_load_4d(kt + rr * L::kRegionK, &tk, &k_full[sk],
                      c0 + rr * kCols, h, j * kKeys, b);
#pragma unroll
        for (int pass = 0; pass < 2; ++pass) {
          for (int r = 0; r < nreg; ++r, ++n) {
            const int st = n % kStages;
            // Stage st is free once the consumers released load n - kStages.
            if (n >= kStages) bar_wait(&empty[st], ((n / kStages) & 1) ^ 1);
            uint8_t* stage = smem + L::kRing + st * L::kStage;
            bar_arrive_tx(&full[st], L::kStage);
            tma_load_4d(stage, pass ? &tdo : &tq, &full[st], r * kCols, h, q0,
                        b);
            tma_load_4d(stage + L::kRegionQ, pass ? &tv : &tk, &full[st],
                        r * kCols, h, j * kKeys, b);
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns rows 64c .. 64c + 63 of the q tile.
    regs_inc<240>();
    const int c = wg - 1;
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row0 = 64 * c + 16 * (t / 32) + lane / 4;  // +8 for i = 1
    const int col = 2 * (lane % 4);
    const int first_qpos = q_off + q0 + 64 * c;
    const float scale_log2 = scale * kLog2e;

    // Rows past Sq get lse = +inf, so their p is exactly 0.
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + row0 + 8 * i;
      lse_r[i] = row < Sq ? lse[(size_t)bh * Sq + row] * kLog2e
                          : __int_as_float(0x7f800000);
      delta_r[i] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
    }

    float acc[kOut / 2];
#pragma unroll
    for (int i = 0; i < kOut / 2; ++i) acc[i] = 0.f;

    int n = 0;  // ring stages consumed so far
    for (int j = 0; j < nk; ++j) {
      const int k0 = j * kKeys, sk = j % kStagesK;
      const bool live = !causal || k_off + k0 <= first_qpos + 63;
      float s[kKeys / 2], dp[kKeys / 2];
      ring_sum<T>(s, smem, full, empty, n, nreg, c, live, lane);
      ring_sum<T>(dp, smem, full, empty, n, nreg, c, live, lane);
      bar_wait(&k_full[sk], (j / kStagesK) & 1);
      if (live) {
        // P, masked only on tiles that cross the diagonal or the ragged
        // end of Sk; then dS = P (dP - delta) scale in place of S.
        const bool masked =
            k0 + kKeys > Sk || (causal && k_off + k0 + kKeys - 1 > first_qpos);
#pragma unroll
        for (int e = 0; e < kKeys / 2; ++e) {
          const int i = (e / 2) % 2;
          float p = exp2f(fmaf(s[e], scale_log2, -lse_r[i]));
          if (masked) {
            const int kc = k0 + 8 * (e / 4) + col + e % 2;
            const bool ok = kc < Sk && (!causal || q_off + q0 + row0 + 8 * i >=
                                                       k_off + kc);
            p = ok ? p : 0.f;
          }
          s[e] = p * (dp[e] - delta_r[i]) * scale;
        }
        uint32_t op[kKeys / 4];
#pragma unroll
        for (int e = 0; e < kKeys / 4; ++e)
          op[e] = pack2<T>(s[2 * e], s[2 * e + 1]);

        // dQ_part += dS K_part, K's part an MN-major operand: a k16 step
        // is 16 keys (2048 bytes), LBO the step to the next 64 columns.
        const uint32_t k_base = smem_u32(smem + L::kK + sk * L::kStageK);
        fence_regs(acc);
        fence_regs(op);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          const uint32_t a[4] = {op[4 * kk], op[4 * kk + 1], op[4 * kk + 2],
                                 op[4 * kk + 3]};
          wgmma_rs<kOut, T>(acc, a,
                            desc_sw128(k_base + kk * 16 * 128, L::kRegionK),
                            1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(op);
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&k_empty[sk]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + row0 + 8 * i;
      if (row >= Sq) continue;
      T* out = dq + ((size_t)(b * Sq + row) * H + h) * D + c0 + col;
#pragma unroll
      for (int jj = 0; jj < kOut / 8; ++jj)
        if (c0 + col + 8 * jj < D)
          store2<T>(out + 8 * jj, acc[4 * jj + 2 * i],
                    acc[4 * jj + 2 * i + 1]);
    }
  }
}

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dq, int B, int H,
                int Sq, int Sk, int D, int q_off, int k_off, int causal,
                float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = encode_bshd<T>(&tq, q, B, Sq, H, D, kRows);
  if (err == cudaSuccess) err = encode_bshd<T>(&tdo, dout, B, Sq, H, D, kRows);
  if (err == cudaSuccess) err = encode_bshd<T>(&tk, k, B, Sk, H, D, kKeys);
  if (err == cudaSuccess) err = encode_bshd<T>(&tv, v, B, Sk, H, D, kKeys);
  if (err != cudaSuccess) return err;
  const int ctas = (Sq + kRows - 1) / kRows * ((D + kOut - 1) / kOut);
  return launch_ws(flash_dq_stream<T>, dim3(ctas, B * H),
                   StreamDqSmem::kBytes + 1024, stream, tq, tk, tv, tdo,
                   (const float*)lse, (const float*)delta, (T*)dq, H, Sq, Sk,
                   D, q_off, k_off, causal, scale);
}

}  // namespace
}  // namespace hvdt

// dtype: 1 bf16, 2 fp16 (hvdt::DType). q, k, v, do: contiguous [B, S, H, D]
// of that type with 16-byte-aligned bases; D a multiple of 64. lse, delta:
// fp32 [B, H, Sq]. dq: [B, Sq, H, D] of that type. scale multiplies the
// logits (1/sqrt of the head dim before any zero padding of D).
extern "C" int hvdt_flash_dq_stream(int dtype, const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int B, int H, int Sq, int Sk,
                                    int D, int q_off, int k_off, int causal,
                                    float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 0 || D % 64) return cudaErrorInvalidValue;
  if (dtype == hvdt::kBFloat16)
    return hvdt::run<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, B, H, Sq,
                                    Sk, D, q_off, k_off, causal, scale, st);
  if (dtype == hvdt::kFloat16)
    return hvdt::run<__half>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, D,
                             q_off, k_off, causal, scale, st);
  return cudaErrorInvalidValue;
}
