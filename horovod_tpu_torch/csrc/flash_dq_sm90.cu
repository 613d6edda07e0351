// Flash-attention dq backward for Hopper's tensor cores (sm_90a), bf16 and
// fp16, built at head dims 16, 32, 64, 128 and 256 and run at every
// multiple of 8 between them on the caller's tensors (below).
//
// Replaces the TPU kernel `_bwd_dq_kernel` (with the shared recompute
// `_recompute_p_ds`) in horovod_tpu/parallel/flash_attention.py, launched by
// `_flash_bwd_bhsd`, as flash_dq_kernel in flash_bwd.cu does for fp32 at
// head dims up to 32 and flash_dq_stream_sm90.cu for 16-bit head dims past
// 256. Same function: for every visible
// (q, k) pair recompute p = exp(s - lse) and ds = p (dp - delta) scale from
// q, k, v, do and the forward's per-row lse (+inf on rows that saw no key,
// so p is exactly 0 there) and delta = rowsum(do * o); then dq = sum over k
// of ds k, accumulated in fp32 and written in the input's type.
//
// What bounds it on this card. Three matrix products per visible pair (s, dp,
// ds k) against five [B, S, H, D] tensors moved: at the main path's shape
// (B=4, S=2048, H=16, D=128, causal) 1.03e11 operations over 168 MB, about
// 600 operations per byte, twice the card's balance point of about 295
// (989 TFLOP/s of bf16 or fp16 over 3.35 TB/s): the tensor cores are the
// limit. At D 256 (Gemma-7B's heads) the same count holds per byte.
//
// Design. One CTA per (128-row q tile, batch*head), heaviest causal tiles
// first (the q tile index runs backwards along grid.y, so the short rows form
// the tail wave). Three warpgroups:
// - a producer, which gives its registers away (setmaxnreg) and whose one
//   elected thread issues every copy as a TMA load through 4-D tensor maps
//   over [B, S, H, D]: the Q and dO tiles once, on one barrier, then K and V
//   through a three-stage ring of kv stages guarded by full/empty
//   mbarriers, from kv stage 0 up to the causal reach of the q tile (on an
//   H100 a third stage took 4.4% off the two-stage time at D 128 and a
//   fourth added nothing: horovod_tpu_torch/tools/dq_stages.py);
// - two consumers, each owning 64 q rows (wgmma's M), which take the
//   registers and keep their rows' lse (pre-scaled by log2 e) and delta in
//   them. Per kv stage of kKeys keys, so that at most dQ, S, dP and the
//   16-bit operand are live:
//     S = Q K^T and dP = dO V^T  (m64 n kKeys k16, both operands K-major in
//                                 smem, in one commit group so that they
//                                 overlap)
//     P = exp(S scale - lse)     (masked only on stages that cross the
//                                 diagonal or the ragged end of Sk: TMA
//                                 zero-fills keys past Sk, and the p of a
//                                 zero score is not zero)
//     dS = P (dP - delta) scale  (to the input's type in registers as
//                                 wgmma's A)
//     dQ += dS K                 (m64 n D k16, K from smem as an MN-major B
//                                 over its D / 64 swizzled column regions,
//                                 so K is never transposed)
//   A kv stage wholly in the future of a consumer's 64 rows is waited for
//   and released without a product.
// Each CTA owns its dq rows: no atomics, no second pass. A CTA that sees no
// kv stage loads nothing, waits on no barrier and writes dq = 0. 16-bit ds is
// what the reference's dots take on the TPU by default; the checks allow for
// exactly that rounding, in the input's type (bf16 or fp16).
// Shared memory and registers by head dim (a consumer thread holds dQ, D/2
// fp32, S and dP, kKeys/2 each, and dS as kKeys/4 packed pairs):
//   D 64, 128: 64-key stages. At D 128, Q 32 KB + dO 32 KB + 3 x (K 16 KB +
//     V 16 KB) = 160 KB; dQ 64 + S 32 + dP 32 + dS 16 registers.
//   D 256: 64-key stages would need Q 64 KB + dO 64 KB + 3 x (K 32 KB + V
//     32 KB) = 320 KB, and dQ 128 + S 32 + dP 32 + dS 16 registers, so the
//     stages are 32 keys: Q 128x256x2 = 65,536 B + dO 65,536 B + 3 x (K
//     32x256x2 = 16,384 B + V 16,384 B) = 229,376 B (plus the barriers and
//     the 1 KB alignment pad: 230,456 of 232,448); dQ 128 + S 16 + dP 16 +
//     dS 8 registers, under the 240 that setmaxnreg gives a consumer. S and
//     dP are m64n32k16 products, dQ += dS K two m64n256k16 ones per stage.
//   D 16, 32: a design of its own (flash_dq_sm90_narrow, below).
// Head dims between the builds (16-bit d past 32, a multiple of 8, so that
// a row of d values is a legal TMA stride) run the kernel of the next
// build D on the caller's [B, S, H, d] tensors as they are (kCut), as the
// forward does (flash_fwd_sm90.cu): the tensor maps of Q, dO, K and V take
// d as the extent and d * 2 bytes as the row stride and keep the build's
// 128-byte boxes, so TMA fills columns d .. D - 1 of every tile with zeros
// (a box wholly past d reads zeros alone), and the store of dQ takes d as
// its row stride and skips the columns past d. The products are the
// build's own, so dq equals that of the inputs zero-padded to D bit for
// bit, without the four copies in and the one out that padding cost. At d
// = D the build runs as it did.
#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace hvdt {
namespace {

using namespace sm90;

constexpr int kRows = 128;  // q rows of a CTA
constexpr int kStages = 3;

// Keys of a kv stage at head dim D (see the header).
template <int D>
constexpr int dq_keys() {
  return D <= 128 ? 64 : 32;
}

template <int D>
struct DqSmem {
  static constexpr int kKeys = dq_keys<D>();
  static constexpr int kRegionQ = kRows * 128;   // [128][64] 16-bit
  static constexpr int kRegionK = kKeys * 128;   // [kKeys][64] 16-bit
  static constexpr int kTileQ = (D / 64) * kRegionQ;
  static constexpr int kTileK = (D / 64) * kRegionK;
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + kTileQ;
  static constexpr int kK = kDo + kTileQ;
  static constexpr int kV = kK + kStages * kTileK;
  static constexpr int kBar = kV + kStages * kTileK;
  // q_full, full[kStages], empty[kStages]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages);
  static_assert(kBytes + 1024 <= 232448, "dq tiles exceed shared memory");
};

template <typename T, int D, bool kCut>
__global__ void __launch_bounds__(384, 1)
    flash_dq_sm90(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq, int H,
                  int Sq, int Sk, int d, int q_off, int k_off, int causal,
                  float scale) {
  using L = DqSmem<D>;
  constexpr int kKeys = L::kKeys;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  int nk = (Sk + kKeys - 1) / kKeys;
  if (causal) {
    // kv stage j is visible while k_off + kKeys j <= q_off + q0 + 127.
    const long long reach = (long long)q_off + q0 + kRows - 1 - k_off;
    nk = min(nk, reach < 0 ? 0 : (int)(reach / kKeys) + 1);
  }

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer.
    regs_dec<24>();
    if (threadIdx.x == 0 && nk > 0) {
      bar_arrive_tx(q_full, 2 * L::kTileQ);
      for (int r = 0; r < D / 64; ++r) {
        tma_load_4d(smem + L::kQ + r * L::kRegionQ, &tq, q_full, 64 * r, h, q0,
                    b);
        tma_load_4d(smem + L::kDo + r * L::kRegionQ, &tdo, q_full, 64 * r, h,
                    q0, b);
      }
      for (int j = 0; j < nk; ++j) {
        const int st = j % kStages;
        // Stage st is free once the consumers released load j - kStages.
        if (j >= kStages) bar_wait(&empty[st], ((j / kStages) & 1) ^ 1);
        uint8_t* kt = smem + L::kK + st * L::kTileK;
        uint8_t* vt = smem + L::kV + st * L::kTileK;
        bar_arrive_tx(&full[st], 2 * L::kTileK);
        for (int r = 0; r < D / 64; ++r) {
          tma_load_4d(kt + r * L::kRegionK, &tk, &full[st], 64 * r, h,
                      j * kKeys, b);
          tma_load_4d(vt + r * L::kRegionK, &tv, &full[st], 64 * r, h,
                      j * kKeys, b);
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
    const uint32_t q_base = smem_u32(smem + L::kQ) + c * 64 * 128;
    const uint32_t do_base = smem_u32(smem + L::kDo) + c * 64 * 128;

    // Rows past Sq get lse = +inf, so their p is exactly 0.
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + row0 + 8 * i;
      lse_r[i] = row < Sq ? lse[(size_t)bh * Sq + row] * kLog2e
                          : __int_as_float(0x7f800000);
      delta_r[i] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    if (nk > 0) bar_wait(q_full, 0);
    for (int j = 0; j < nk; ++j) {
      const int st = j % kStages, ph = (j / kStages) & 1;
      const int k0 = j * kKeys;
      const uint32_t k_base = smem_u32(smem + L::kK + st * L::kTileK);
      const uint32_t v_base = smem_u32(smem + L::kV + st * L::kTileK);
      bar_wait(&full[st], ph);
      if (!causal || k_off + k0 <= first_qpos + 63) {
        // S = Q K^T and dP = dO V^T, in one commit group.
        float s[kKeys / 2], dp[kKeys / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t a_off = (kk / 4) * L::kRegionQ + (kk % 4) * 32;
          const uint32_t b_off = (kk / 4) * L::kRegionK + (kk % 4) * 32;
          wgmma_ss<kKeys, T>(s, desc_sw128(q_base + a_off, 16),
                             desc_sw128(k_base + b_off, 16), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t a_off = (kk / 4) * L::kRegionQ + (kk % 4) * 32;
          const uint32_t b_off = (kk / 4) * L::kRegionK + (kk % 4) * 32;
          wgmma_ss<kKeys, T>(dp, desc_sw128(do_base + a_off, 16),
                             desc_sw128(v_base + b_off, 16), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        // P, masked only on stages that cross the diagonal or the ragged end
        // of Sk; then dS = P (dP - delta) scale in place of S.
        const bool masked = k0 + kKeys > Sk ||
                            (causal && k_off + k0 + kKeys - 1 > first_qpos);
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

        // dQ += dS K.
        fence_regs(acc);
        fence_regs(op);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          const uint32_t a[4] = {op[4 * kk], op[4 * kk + 1], op[4 * kk + 2],
                                 op[4 * kk + 3]};
          wgmma_rs<D, T>(acc, a,
                         desc_sw128(k_base + kk * 16 * 128, L::kRegionK), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(op);
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[st]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + row0 + 8 * i;
      if (row >= Sq) continue;
      // kCut: rows of d columns, of which those past d are not stored.
      T* out = dq + ((size_t)(b * Sq + row) * H + h) * (kCut ? d : D) + col;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        if (!kCut || col + 8 * jj < d)
          store2<T>(out + 8 * jj, acc[4 * jj + 2 * i],
                    acc[4 * jj + 2 * i + 1]);
    }
  }
}

// ---- D 16 and 32: narrow rows ---------------------------------------------
//
// A 16-bit row of Q, dO, K or V is 32 bytes at D 16 and 64 at D 32, so every
// tile is one region in the swizzle of the row's width (sm90_common.cuh),
// loaded by one TMA box. The design mirrors the narrow dk/dv
// (flash_dkv_sm90.cu) with the roles of the sequences swapped: S = Q K^T
// and dP = dO V^T take one k16 step at D 16 and two at D 32 (m64n64, both
// operands K-major), and dQ += dS K has N = D (m64n16k16 or m64n32k16, K
// read from the same stage as an MN-major operand, a k16 step 16 rows). At
// these widths neither the tensor cores nor the bytes bind: each CTA's
// serial chain per kv stage (the TMA wait, two products, the exponentials,
// one more product) and the number of CTAs in flight do. So a CTA is one
// consumer warpgroup of 64 q rows and one producer warp: Q and dO stay
// resident, K and V come through a ring of kNarrowStages 64-key stages,
// the rows' lse (pre-scaled by log2 e) and delta stay in registers, there
// is no register hand-over (a consumer thread holds dQ in D / 2 registers,
// S and dP in 32 each, dS in 16), and kNarrowCtasPerSm CTAs share an SM.
// The heaviest causal q tiles come first on grid.y; a CTA that sees no kv
// stage loads nothing and writes dq = 0.
//
// One pass over K suffices, unlike the narrow forward's two. The forward
// rounds p for the tensor cores, and an online softmax rounds it against
// the running max, not the final one that the plain version uses; hence
// its first pass for the max. Here p = exp(s - lse) takes the forward's
// final lse as an input, so p and ds are rounded from the same fp32 values
// as the plain version rounds (up to the fp32 order of S and dP), and dQ
// is a plain sum over the keys with nothing to rescale.
//
// tools/dq_variants.py builds this file with two ring stages and times
// it against the package's build on the card (PERF.md records the times).
constexpr int kNarrowStages = 3;     // kv stages in the ring
constexpr int kNarrowCtasPerSm = 2;  // __launch_bounds__' minimum
constexpr int kNarrowRows = 64;      // q rows of a CTA
constexpr int kNarrowKeys = 64;      // keys of a kv stage
constexpr int kNarrowThreads = 128 + 32;

template <int D>
struct NarrowDqSmem {
  static constexpr int kRowBytes = D * 2;
  static constexpr int kTileQ = kNarrowRows * kRowBytes;   // [64][D]
  static constexpr int kTileK = kNarrowKeys * kRowBytes;   // [64][D]
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + kTileQ;
  static constexpr int kK = kDo + kTileQ;
  static constexpr int kV = kK + kNarrowStages * kTileK;
  static constexpr int kBar = kV + kNarrowStages * kTileK;
  // q_full, full[stages], empty[stages]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kNarrowStages);
  static_assert(kTileQ % 1024 == 0 && kTileK % 1024 == 0,
                "narrow tiles keep the 1024-byte alignment");
  static_assert(kNarrowCtasPerSm * (kBytes + 1024) <= 232448,
                "narrow dq tiles exceed shared memory");
};

template <typename T, int D>
__global__ void __launch_bounds__(kNarrowThreads, kNarrowCtasPerSm)
    flash_dq_sm90_narrow(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dq,
                         int H, int Sq, int Sk, int q_off, int k_off,
                         int causal, float scale) {
  using L = NarrowDqSmem<D>;
  constexpr int kStg = kNarrowStages, kKeys = kNarrowKeys, kRB = L::kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStg;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kNarrowRows;
  int nk = (Sk + kKeys - 1) / kKeys;
  if (causal) {
    // kv stage j is visible while k_off + 64 j <= q_off + q0 + 63.
    const long long reach = (long long)q_off + q0 + kNarrowRows - 1 - k_off;
    nk = min(nk, reach < 0 ? 0 : (int)(reach / kKeys) + 1);
  }

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < kStg; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 4);  // lane 0 of each consumer warp
    }
    bar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == 4) {
    // Producer: the last warp, one lane.
    if (threadIdx.x % 32 == 0 && nk > 0) {
      bar_arrive_tx(q_full, 2 * L::kTileQ);
      tma_load_4d(smem + L::kQ, &tq, q_full, 0, h, q0, b);
      tma_load_4d(smem + L::kDo, &tdo, q_full, 0, h, q0, b);
      for (int j = 0; j < nk; ++j) {
        const int st = j % kStg;
        if (j >= kStg) bar_wait(&empty[st], ((j / kStg) & 1) ^ 1);
        bar_arrive_tx(&full[st], 2 * L::kTileK);
        tma_load_4d(smem + L::kK + st * L::kTileK, &tk, &full[st], 0, h,
                    j * kKeys, b);
        tma_load_4d(smem + L::kV + st * L::kTileK, &tv, &full[st], 0, h,
                    j * kKeys, b);
      }
    }
    return;
  }

  // The consumer warpgroup: rows q0 .. q0 + 63.
  const int t = threadIdx.x, lane = t % 32;
  const int row0 = 16 * (t / 32) + lane / 4;  // +8 for i = 1
  const int col = 2 * (lane % 4);
  const int first_qpos = q_off + q0;
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_base = smem_u32(smem + L::kQ);
  const uint32_t do_base = smem_u32(smem + L::kDo);

  // Rows past Sq get lse = +inf, so their p is exactly 0.
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + row0 + 8 * i;
    lse_r[i] = row < Sq ? lse[(size_t)bh * Sq + row] * kLog2e
                        : __int_as_float(0x7f800000);
    delta_r[i] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  if (nk > 0) bar_wait(q_full, 0);
  for (int j = 0; j < nk; ++j) {
    const int st = j % kStg, k0 = j * kKeys;
    const uint32_t k_base = smem_u32(smem + L::kK + st * L::kTileK);
    const uint32_t v_base = smem_u32(smem + L::kV + st * L::kTileK);
    bar_wait(&full[st], (j / kStg) & 1);

    // S = Q K^T and dP = dO V^T, in one commit group.
    float s[kKeys / 2], dp[kKeys / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kKeys, T>(s, desc_narrow<kRB>(q_base + kk * 32, 16),
                         desc_narrow<kRB>(k_base + kk * 32, 16), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kKeys, T>(dp, desc_narrow<kRB>(do_base + kk * 32, 16),
                         desc_narrow<kRB>(v_base + kk * 32, 16), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P, masked only on stages that cross the diagonal or the ragged end of
    // Sk (TMA zero-fills keys past Sk, and the p of a zero score is not
    // zero); then dS = P (dP - delta) scale in place of S.
    const bool masked =
        k0 + kKeys > Sk || (causal && k_off + k0 + kKeys - 1 > first_qpos);
#pragma unroll
    for (int e = 0; e < kKeys / 2; ++e) {
      const int i = (e / 2) % 2;
      float p = exp2f(fmaf(s[e], scale_log2, -lse_r[i]));
      if (masked) {
        const int kc = k0 + 8 * (e / 4) + col + e % 2;
        const bool ok =
            kc < Sk && (!causal || first_qpos + row0 + 8 * i >= k_off + kc);
        p = ok ? p : 0.f;
      }
      s[e] = p * (dp[e] - delta_r[i]) * scale;
    }
    uint32_t op[kKeys / 4];
#pragma unroll
    for (int e = 0; e < kKeys / 4; ++e)
      op[e] = pack2<T>(s[2 * e], s[2 * e + 1]);

    // dQ += dS K, K an MN-major operand from the same stage.
    fence_regs(acc);
    fence_regs(op);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t a[4] = {op[4 * kk], op[4 * kk + 1], op[4 * kk + 2],
                             op[4 * kk + 3]};
      wgmma_rs<D, T>(acc, a, desc_narrow<kRB>(k_base + kk * 16 * kRB,
                                               L::kTileK), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(op);
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[st]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + row0 + 8 * i;
    if (row >= Sq) continue;
    T* out = dq + ((size_t)(b * Sq + row) * H + h) * D + col;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      store2<T>(out + 8 * jj, acc[4 * jj + 2 * i], acc[4 * jj + 2 * i + 1]);
  }
}

template <typename T, int D>
cudaError_t run_narrow(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, int B, int H, int Sq, int Sk, int q_off,
                       int k_off, int causal, float scale,
                       cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = encode_bshd<T>(&tq, q, B, Sq, H, D, kNarrowRows);
  if (err == cudaSuccess)
    err = encode_bshd<T>(&tdo, dout, B, Sq, H, D, kNarrowRows);
  if (err == cudaSuccess) err = encode_bshd<T>(&tk, k, B, Sk, H, D, kNarrowKeys);
  if (err == cudaSuccess) err = encode_bshd<T>(&tv, v, B, Sk, H, D, kNarrowKeys);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kNarrowRows - 1) / kNarrowRows);
  return launch_threads(flash_dq_sm90_narrow<T, D>, grid, kNarrowThreads,
                        NarrowDqSmem<D>::kBytes + 1024, stream, tq, tk, tv,
                        tdo, (const float*)lse, (const float*)delta, (T*)dq,
                        H, Sq, Sk, q_off, k_off, causal, scale);
}

// The build of head dim D on tensors of head dim d <= D (d < D: kCut, see
// the header).
template <typename T, int D>
cudaError_t run(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dq, int B, int H,
                int Sq, int Sk, int d, int q_off, int k_off, int causal,
                float scale, cudaStream_t stream) {
  constexpr int kKeys = dq_keys<D>();
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = encode_bshd<T>(&tq, q, B, Sq, H, d, kRows, D);
  if (err == cudaSuccess)
    err = encode_bshd<T>(&tdo, dout, B, Sq, H, d, kRows, D);
  if (err == cudaSuccess) err = encode_bshd<T>(&tk, k, B, Sk, H, d, kKeys, D);
  if (err == cudaSuccess) err = encode_bshd<T>(&tv, v, B, Sk, H, d, kKeys, D);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kRows - 1) / kRows);
  if (d == D)
    return launch_ws(flash_dq_sm90<T, D, false>, grid,
                     DqSmem<D>::kBytes + 1024, stream, tq, tk, tv, tdo,
                     (const float*)lse, (const float*)delta, (T*)dq, H, Sq,
                     Sk, d, q_off, k_off, causal, scale);
  return launch_ws(flash_dq_sm90<T, D, true>, grid, DqSmem<D>::kBytes + 1024,
                   stream, tq, tk, tv, tdo, (const float*)lse,
                   (const float*)delta, (T*)dq, H, Sq, Sk, d, q_off, k_off,
                   causal, scale);
}

// The build a head dim d runs at: 16 and 32 (narrow) for themselves, any
// other multiple of 8 past 32 the next of 64, 128 and 256.
template <typename T>
cudaError_t run_for_dim(int d, const void* q, const void* k, const void* v,
                        const void* g, const void* lse, const void* delta,
                        void* dq, int B, int H, int Sq, int Sk, int qo,
                        int ko, int causal, float sc, cudaStream_t st) {
  if (d == 16) return run_narrow<T, 16>(q, k, v, g, lse, delta, dq, B, H, Sq, Sk, qo, ko, causal, sc, st);
  if (d == 32) return run_narrow<T, 32>(q, k, v, g, lse, delta, dq, B, H, Sq, Sk, qo, ko, causal, sc, st);
  if (d <= 32 || d % 8) return cudaErrorInvalidValue;
  if (d <= 64) return run<T, 64>(q, k, v, g, lse, delta, dq, B, H, Sq, Sk, d, qo, ko, causal, sc, st);
  if (d <= 128) return run<T, 128>(q, k, v, g, lse, delta, dq, B, H, Sq, Sk, d, qo, ko, causal, sc, st);
  if (d <= 256) return run<T, 256>(q, k, v, g, lse, delta, dq, B, H, Sq, Sk, d, qo, ko, causal, sc, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace hvdt

// dtype: 1 bf16, 2 fp16 (hvdt::DType). q, k, v, do: contiguous [B, S, H, D]
// of that type with 16-byte-aligned bases; D is 16, 32 or a multiple of 8
// from 40 to 256 (run by the build of 64, 128 or 256). lse, delta: fp32
// [B, H, Sq]. dq: [B, Sq, H, D] of that type.
extern "C" int hvdt_flash_dq_sm90(int dtype, const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dq,
                                  int B, int H, int Sq, int Sk, int D,
                                  int q_off, int k_off, int causal,
                                  float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == hvdt::kBFloat16)
    return hvdt::run_for_dim<__nv_bfloat16>(D, q, k, v, dout, lse, delta, dq,
                                            B, H, Sq, Sk, q_off, k_off, causal,
                                            scale, st);
  if (dtype == hvdt::kFloat16)
    return hvdt::run_for_dim<__half>(D, q, k, v, dout, lse, delta, dq, B, H,
                                     Sq, Sk, q_off, k_off, causal, scale, st);
  return cudaErrorInvalidValue;
}
