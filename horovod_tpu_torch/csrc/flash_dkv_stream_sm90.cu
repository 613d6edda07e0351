// Flash-attention dk/dv backward for Hopper's tensor cores (sm_90a), streamed
// over the head dim: bf16 and fp16 at every multiple of 64 past 256 (the
// "stream" design of dk/dv). One template over the element type serves both.
//
// Replaces the TPU kernel `_bwd_dkv_kernel` (with the shared recompute
// `_recompute_p_ds`) in horovod_tpu/parallel/flash_attention.py, launched by
// `_flash_bwd_bhsd`, as flash_dkv_sm90.cu does for 16-bit head dims up to
// 256 and flash_bwd_tf32_sm90.cu for fp32. Same function: for every visible
// (q, k) pair recompute p = exp(s - lse) and ds = p (dp - delta) scale from
// q, k, v, do and the forward's per-row lse (+inf on rows that saw no key,
// so p is exactly 0 there) and delta = rowsum(do * o); then dv = sum over q
// of p^T do and dk = sum over q of ds^T q, accumulated in fp32 and written
// in the input's type. Runtime offsets shift the causal mask; q tiles wholly
// in the past of a CTA's keys are skipped; a CTA that sees no query writes
// zeros.
//
// What bounds it on this card. Four matrix products per visible pair (s,
// dp, p^T do, ds^T q) against six [B, S, H, D] tensors moved: at bf16 D 640
// (B 2, S 1024, H 8, causal) 4.3e10 operations over 126 MB, about 340
// operations per byte, past the card's balance point (989 TFLOP/s of bf16
// or fp16 over 3.35 TB/s); and this design does more products than the
// function (below), so the tensor cores are the limit. It also reads Q, K,
// V and dO again from L2 for every part and q tile; which of the two holds
// it back has not been measured (no ncu).
//
// Why streamed. flash_dkv_sm90.cu keeps a CTA's K and V resident and its
// q tiles whole: at D 256 that is K, V and two stages of Q and dO, 192 KB,
// and dK and dV 128 registers a consumer thread; nothing larger fits. Here
// no tile spans the head dim, so shared memory does not grow with D and
// any multiple of 64 runs (D 320 natively; the wrapper zero-pads any other
// D to the next one), as in the stream dq (flash_dq_stream_sm90.cu), whose
// ring this kernel shares in form.
//
// Design. One CTA per (64-key tile, part of the head dim, batch*head); the
// grid is head-major, (kv tiles x parts, B H): one head's CTAs run side by
// side and find its Q and dO in L2, the causally heaviest kv tiles (the
// first ones) first and a tile's parts together. Three warpgroups:
// - a producer, which gives its registers away (setmaxnreg) and whose one
//   elected thread issues every copy as a TMA load: per 64-row q tile,
//   first the tile's Q and dO restricted to the CTA's part ([64 q][kOut]
//   each, the regions past D neither loaded nor used) into one of
//   kStagesP stages, then the ring: for S^T, then for dP^T, D / 64 stages
//   of one 128-byte column region each, [64][64] of K (then V) and [64][64]
//   of Q (then dO);
// - two consumers, which take the registers and split the work twice per
//   q tile, as flash_dkv_sm90_wide does at D 256:
//     S^T = sum over regions of K_r Q_r^T, dP^T = sum of V_r dO_r^T
//                         (warpgroup c on queries 32c .. 32c + 31:
//                          m64n32k16 from shared memory, both K-major,
//                          each region's products in an accumulator of
//                          their own, below)
//     P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta) scale
//                         (masked only on tiles that cross the diagonal
//                          or the ragged end of Sq; dS from the unrounded
//                          P)
//   then each writes its half of P^T and dS^T, in the input's type, into
//   two swizzled [64 keys][64 q] tiles in shared memory behind a proxy
//   fence and a named barrier over the 256 consumer threads, and takes
//   its own kOut / 2 columns of the part:
//     dV_part += P^T dO_part, dK_part += dS^T Q_part
//                         (m64 n kOut/2 k16, A the P^T or dS^T tile, B
//                          dO's or Q's part as an MN-major operand)
//   A second pass of the named barrier before the next tile's writes keeps
//   them from overwriting tiles the other warpgroup still reads. A
//   warpgroup whose columns all lie past D (the last part's second half at
//   D 320 or 640) computes and writes its half of P^T and dS^T, which the
//   other one needs, and skips its products.
// Each CTA owns its dk and dv rows and columns: no atomics, no second pass.
// 16-bit p and ds are what the reference's dots take on the TPU by default;
// the checks allow for exactly that rounding, in the input's type.
//
// The part width, kOut = 256, two consumers of 128 columns. Every part pays
// S^T and dP^T again (2 D operations per pair each) and its own dK and dV
// products (2 kOut each, whatever part of it lies within D), so at D 640
// three parts (256 + 256 + 128) do (3 x 4 x 640 + 4 x 640) / (4 x 2 x 640)
// = 2.0 times the function's products, and five parts of 128 would do 3.0
// times; at D 320 two parts (256 + 64) do 1.5 times and three of 128 2.0
// times. tools/dkv_variants.py builds this file with kOut 128 and times it
// against the package's build (PERF.md records the times).
//
// Each region's S^T and dP^T go to an accumulator of their own and are
// summed by fp32 adds (kSplitChains), as in the stream dq: the tensor cores
// add into their accumulator without rounding to nearest, so one chain
// over all of D drifts, and a key that only one query sees (the last keys
// of a causal sequence) has p = 1 and dp = delta, so its dk is the rounding
// noise of dp - delta times scale and q. tools/dkv_variants.py builds the
// one-chain variant and holds it to the same bound. The cost: a region's
// products are waited for before the next region's are issued.
//
// Registers of a consumer thread (setmaxnreg gives 240): dK's and dV's
// halves of the part 64 + 64, S^T 16, dP^T 16 and a region's product 16,
// the lse and delta of its 8 queries 16 (192); the rest holds addresses
// and loop state. Shared memory (the same for any D): a ring stage is 2 x
// 64x64x2 = 16,384 B, a part stage Q and dO 2 x 64x256x2 = 65,536 B, P^T
// and dS^T 2 x 8,192; 5 ring stages and 2 part stages = 229,376 B, with
// 112 B of barriers and the 1 KB alignment pad 230,512 of 232,448.
#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace hvdt {
namespace {

using namespace sm90;

constexpr int kKeys = 64;         // keys of a CTA
constexpr int kQRows = 64;        // queries of a q tile
constexpr int kCols = 64;         // 16-bit columns of a 128-byte region
constexpr int kOut = 256;         // columns of dk and dv a CTA owns
constexpr int kHalf = kOut / 2;   // ... and each consumer of them
constexpr int kStages = 5;        // ring stages
constexpr int kStagesP = 2;       // stages of Q's and dO's part
// Each region's products in an accumulator of their own, summed by fp32
// adds (see the header). tools/dkv_variants.py builds this file with
// false, one chain for S^T and one for dP^T, to measure why.
constexpr bool kSplitChains = true;

struct StreamDkvSmem {
  static constexpr int kRegion = 64 * 128;              // [64][64] 16-bit
  static constexpr int kStage = 2 * kRegion;            // K (V) and Q (dO)
  static constexpr int kPart = (kOut / kCols) * kRegion;  // [64 q][kOut]
  static constexpr int kRing = 0;
  static constexpr int kQ = kRing + kStages * kStage;
  static constexpr int kDo = kQ + kStagesP * kPart;
  static constexpr int kPt = kDo + kStagesP * kPart;    // P^T [64 k][64 q]
  static constexpr int kDst = kPt + kRegion;            // dS^T
  static constexpr int kBar = kDst + kRegion;
  // full and empty per ring stage, p_full and p_empty per part stage
  static constexpr int kBytes = kBar + 8 * 2 * (kStages + kStagesP);
  static_assert(kHalf % kCols == 0, "a consumer's columns are whole regions");
  static_assert(kBytes + 1024 <= 232448,
                "stream dk/dv tiles exceed shared memory");
  // fp32 registers of a consumer thread at its peak: dK's and dV's halves,
  // S^T, dP^T, a region's product, and its queries' lse and delta.
  static_assert(kHalf + 3 * kQRows / 4 + 16 <= 224,
                "stream dk/dv accumulators exceed the consumer registers");
};

// acc = the sum over the D / 64 regions of one ring pass of A_r B_r^T (K_r
// Q_r^T or V_r dO_r^T) on this warpgroup's 32 queries (rows 32c .. 32c + 31
// of the stage's Q or dO region): with kSplitChains each region's products
// in an accumulator of their own, summed by fp32 adds; else one chain, one
// region's products left in flight while the next region's copy is
// awaited. Each stage goes back to the producer once its products are
// done. `n` counts the ring stages consumed.
template <typename T>
__device__ __forceinline__ void ring_sum(float (&acc)[kQRows / 4],
                                         uint8_t* smem, uint64_t* full,
                                         uint64_t* empty, int& n, int nreg,
                                         int c, int lane) {
  using L = StreamDkvSmem;
  for (int r = 0; r < nreg; ++r, ++n) {
    const int st = n % kStages;
    const uint32_t a = smem_u32(smem + L::kRing + st * L::kStage);
    const uint32_t b = a + L::kRegion + c * 32 * 128;
    bar_wait(&full[st], (n / kStages) & 1);
    if (kSplitChains) {
      float part[kQRows / 4];
      fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<kQRows / 2, T>(part, desc_sw128(a + 32 * kk, 16),
                                desc_sw128(b + 32 * kk, 16), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[st]);
#pragma unroll
      for (int e = 0; e < kQRows / 4; ++e)
        acc[e] = r > 0 ? acc[e] + part[e] : part[e];
    } else {
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<kQRows / 2, T>(acc, desc_sw128(a + 32 * kk, 16),
                                desc_sw128(b + 32 * kk, 16), r > 0 || kk > 0);
      wgmma_commit();
      fence_regs(acc);
      // The region before is done; its stage goes back to the producer.
      wgmma_wait<1>();
      if (r > 0) {
        __syncwarp();
        if (lane == 0) bar_arrive(&empty[(n - 1) % kStages]);
      }
    }
  }
  if (!kSplitChains && nreg > 0) {
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[(n - 1) % kStages]);
  }
}

template <typename T>
__global__ void __launch_bounds__(384, 1)
    flash_dkv_stream(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Sq, int Sk, int D,
                     int q_off, int k_off, int causal, float scale) {
  using L = StreamDkvSmem;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* p_full = empty + kStages;
  uint64_t* p_empty = p_full + kStagesP;

  // The CTA's (kv tile, part) index runs fastest, so that the CTAs that
  // stream one head's Q and dO run together and find them in L2.
  const int bh = blockIdx.y, cta = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int nparts = (D + kOut - 1) / kOut;
  const int c0 = (cta % nparts) * kOut;  // the first column it owns
  const int k0 = (cta / nparts) * kKeys;
  const int nreg = D / kCols;
  const int nq = (Sq + kQRows - 1) / kQRows;
  int first = 0;
  if (causal) {
    // q tile t sees this kv tile once q_off + 64 t + 63 >= k_off + k0.
    const long long need = (long long)k_off + k0 - q_off - (kQRows - 1);
    first = need <= 0 ? 0
                      : (int)min((long long)nq, (need + kQRows - 1) / kQRows);
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < kStagesP; ++s) {
      bar_init(&p_full[s], 1);
      bar_init(&p_empty[s], 8);
    }
    bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer.
    regs_dec<24>();
    if (threadIdx.x == 0) {
      // The regions of the part that lie within D (the last part's others
      // are neither loaded nor stored).
      const int p_regions = min(kOut, D - c0) / kCols;
      int n = 0;  // ring stages issued so far
      for (int t = first; t < nq; ++t) {
        const int i = t - first, sp = i % kStagesP, q0 = t * kQRows;
        // The part first: the consumers need it only after this tile's
        // ring, so it loads while they finish the last tile.
        if (i >= kStagesP) bar_wait(&p_empty[sp], ((i / kStagesP) & 1) ^ 1);
        uint8_t* qp = smem + L::kQ + sp * L::kPart;
        uint8_t* dop = smem + L::kDo + sp * L::kPart;
        bar_arrive_tx(&p_full[sp], 2 * p_regions * L::kRegion);
        for (int rr = 0; rr < p_regions; ++rr) {
          tma_load_4d(qp + rr * L::kRegion, &tq, &p_full[sp], c0 + rr * kCols,
                      h, q0, b);
          tma_load_4d(dop + rr * L::kRegion, &tdo, &p_full[sp],
                      c0 + rr * kCols, h, q0, b);
        }
#pragma unroll
        for (int pass = 0; pass < 2; ++pass) {
          for (int r = 0; r < nreg; ++r, ++n) {
            const int st = n % kStages;
            // Stage st is free once the consumers released load n - kStages.
            if (n >= kStages) bar_wait(&empty[st], ((n / kStages) & 1) ^ 1);
            uint8_t* stage = smem + L::kRing + st * L::kStage;
            bar_arrive_tx(&full[st], L::kStage);
            tma_load_4d(stage, pass ? &tv : &tk, &full[st], r * kCols, h, k0,
                        b);
            tma_load_4d(stage + L::kRegion, pass ? &tdo : &tq, &full[st],
                        r * kCols, h, q0, b);
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup c takes queries 32c .. 32c + 31 of each q tile
    // for S^T and dP^T, and columns kHalf c .. kHalf c + kHalf - 1 of the
    // part of dK and dV.
    regs_inc<240>();
    const int c = wg - 1;
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row0 = 16 * (t / 32) + lane / 4;  // key row; +8 for i = 1
    const int col = 2 * (lane % 4);
    const int qc0 = 32 * c;
    const int kpos0 = k_off + k0 + row0;
    const int last_kpos = k_off + k0 + kKeys - 1;
    const int h0 = c0 + kHalf * c;  // this warpgroup's first column
    const bool has_cols = h0 < D;
    const float scale_log2 = scale * kLog2e;
    const uint32_t pt_base = smem_u32(smem + L::kPt);
    const uint32_t dst_base = smem_u32(smem + L::kDst);

    float acc_dk[kHalf / 2], acc_dv[kHalf / 2];
#pragma unroll
    for (int i = 0; i < kHalf / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

    int n = 0;  // ring stages consumed so far
    for (int tq_i = first; tq_i < nq; ++tq_i) {
      const int i = tq_i - first, sp = i % kStagesP, q0 = tq_i * kQRows;
      // lse (pre-scaled by log2 e) and delta of this thread's 8 queries,
      // 8 j + col + x of its 32 (j < 4, x < 2); rows past Sq get lse =
      // +inf, so their p is exactly 0.
      float lse_r[8], delta_r[8];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int row = q0 + qc0 + 8 * j + col + x;
          lse_r[2 * j + x] = row < Sq ? lse[(size_t)bh * Sq + row] * kLog2e
                                      : __int_as_float(0x7f800000);
          delta_r[2 * j + x] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
        }
      float s[kQRows / 4], dp[kQRows / 4];
      ring_sum<T>(s, smem, full, empty, n, nreg, c, lane);
      ring_sum<T>(dp, smem, full, empty, n, nreg, c, lane);

      // P^T and dS^T, masked only on tiles that cross the diagonal or the
      // ragged end of Sq.
      const bool masked =
          q0 + kQRows > Sq || (causal && q_off + q0 + qc0 < last_kpos);
#pragma unroll
      for (int e = 0; e < kQRows / 4; ++e) {
        const int qi = 2 * (e / 4) + e % 2;
        const int qc = qc0 + 8 * (e / 4) + col + e % 2;
        float p = exp2f(fmaf(s[e], scale_log2, -lse_r[qi]));
        if (masked) {
          const bool ok = q0 + qc < Sq &&
                          (!causal || q_off + q0 + qc >= kpos0 + 8 * ((e / 2) % 2));
          p = ok ? p : 0.f;
        }
        s[e] = p;
        dp[e] = p * (dp[e] - delta_r[qi]) * scale;
      }

      // Both halves into the shared P^T and dS^T tiles: element (key r,
      // query q) at byte r * 128 + ((q / 8) ^ (r % 8)) * 16 + (q % 8) * 2,
      // the 128-byte swizzle. The first barrier waits for the other
      // warpgroup's products of the last q tile, which read these tiles.
      named_bar_sync(1, 256);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int r = row0 + 8 * x;
          const int byte = r * 128 + (((qc0 / 8 + j) ^ (r % 8)) << 4) + col * 2;
          *reinterpret_cast<uint32_t*>(smem + L::kPt + byte) =
              pack2<T>(s[4 * j + 2 * x], s[4 * j + 2 * x + 1]);
          *reinterpret_cast<uint32_t*>(smem + L::kDst + byte) =
              pack2<T>(dp[4 * j + 2 * x], dp[4 * j + 2 * x + 1]);
        }
      fence_proxy_async();
      named_bar_sync(1, 256);

      // dV_part += P^T dO_part and dK_part += dS^T Q_part over the 64
      // queries, on this warpgroup's columns, in one commit group: dO's
      // and Q's parts MN-major, a k16 step 16 queries (2048 bytes), LBO
      // the step to the next 64 columns.
      bar_wait(&p_full[sp], (i / kStagesP) & 1);
      if (has_cols) {
        const uint32_t own = c * (kHalf / kCols) * L::kRegion;
        const uint32_t qp = smem_u32(smem + L::kQ + sp * L::kPart) + own;
        const uint32_t dop = smem_u32(smem + L::kDo + sp * L::kPart) + own;
        fence_regs(acc_dv);
        fence_regs(acc_dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kQRows / 16; ++kk)
          wgmma_ss<kHalf, T, 1>(acc_dv, desc_sw128(pt_base + kk * 32, 16),
                                desc_sw128(dop + kk * 16 * 128, L::kRegion),
                                1);
#pragma unroll
        for (int kk = 0; kk < kQRows / 16; ++kk)
          wgmma_ss<kHalf, T, 1>(acc_dk, desc_sw128(dst_base + kk * 32, 16),
                                desc_sw128(qp + kk * 16 * 128, L::kRegion),
                                1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc_dv);
        fence_regs(acc_dk);
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&p_empty[sp]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = k0 + row0 + 8 * i;
      if (key >= Sk || !has_cols) continue;
      const size_t off = ((size_t)(b * Sk + key) * H + h) * D + h0 + col;
#pragma unroll
      for (int jj = 0; jj < kHalf / 8; ++jj)
        if (h0 + col + 8 * jj < D) {
          store2<T>(dk + off + 8 * jj, acc_dk[4 * jj + 2 * i],
                    acc_dk[4 * jj + 2 * i + 1]);
          store2<T>(dv + off + 8 * jj, acc_dv[4 * jj + 2 * i],
                    acc_dv[4 * jj + 2 * i + 1]);
        }
    }
  }
}

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dk, void* dv, int B,
                int H, int Sq, int Sk, int D, int q_off, int k_off,
                int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = encode_bshd<T>(&tq, q, B, Sq, H, D, kQRows);
  if (err == cudaSuccess) err = encode_bshd<T>(&tdo, dout, B, Sq, H, D, kQRows);
  if (err == cudaSuccess) err = encode_bshd<T>(&tk, k, B, Sk, H, D, kKeys);
  if (err == cudaSuccess) err = encode_bshd<T>(&tv, v, B, Sk, H, D, kKeys);
  if (err != cudaSuccess) return err;
  const int ctas = (Sk + kKeys - 1) / kKeys * ((D + kOut - 1) / kOut);
  return launch_ws(flash_dkv_stream<T>, dim3(ctas, B * H),
                   StreamDkvSmem::kBytes + 1024, stream, tq, tk, tv, tdo,
                   (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, H,
                   Sq, Sk, D, q_off, k_off, causal, scale);
}

}  // namespace
}  // namespace hvdt

// dtype: 1 bf16, 2 fp16 (hvdt::DType). q, k, v, do: contiguous [B, S, H, D]
// of that type with 16-byte-aligned bases; D a multiple of 64. lse, delta:
// fp32 [B, H, Sq]. dk, dv: [B, Sk, H, D] of that type. scale multiplies the
// logits (1/sqrt of the head dim before any zero padding of D).
extern "C" int hvdt_flash_dkv_stream(int dtype, const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int B, int H, int Sq,
                                     int Sk, int D, int q_off, int k_off,
                                     int causal, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 0 || D % 64) return cudaErrorInvalidValue;
  if (dtype == hvdt::kBFloat16)
    return hvdt::run<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                    Sq, Sk, D, q_off, k_off, causal, scale,
                                    st);
  if (dtype == hvdt::kFloat16)
    return hvdt::run<__half>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk,
                             D, q_off, k_off, causal, scale, st);
  return cudaErrorInvalidValue;
}
