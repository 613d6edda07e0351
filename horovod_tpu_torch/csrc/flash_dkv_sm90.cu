// Flash-attention dk/dv backward for Hopper's tensor cores (sm_90a), bf16 and
// fp16, built at head dims 16, 32, 64, 128 and 256 and run at every
// multiple of 8 between them on the caller's tensors (below).
//
// Replaces the TPU kernel `_bwd_dkv_kernel` (with the shared recompute
// `_recompute_p_ds`) in horovod_tpu/parallel/flash_attention.py, launched by
// `_flash_bwd_bhsd`, as flash_dkv_kernel in flash_bwd.cu does for fp32 at
// head dims up to 32 and 16-bit ones past 256. Same function: for every visible
// (q, k) pair recompute p = exp(s - lse) and ds = p (dp - delta) scale from
// q, k, v, do and the forward's per-row lse (+inf on rows that saw no key,
// so p is exactly 0 there) and delta = rowsum(do * o); then dv = sum over q
// of p^T do and dk = sum over q of ds^T q, accumulated in fp32 and written
// in the input's type.
//
// What bounds it on this card. Four matrix products per visible pair (s, dp,
// p^T do, ds^T q) against six [B, S, H, D] tensors moved: about 500
// operations per byte at the main path's shape (B=4, S=2048, H=16, D=128,
// causal), so the 16-bit tensor cores (989 TFLOP/s) are the limit.
//
// Design at D 64 and 128. One CTA per (128-row kv tile, batch*head); the
// causally heaviest kv tiles (the first ones) come first on grid.y. K and V
// are loaded once by TMA and stay in shared memory. A producer warp streams
// 64-row q tiles (Q and dO by TMA through 4-D tensor maps over [B, S, H,
// D], lse and delta by its 32 lanes) through a two-stage ring guarded by
// full/empty mbarriers, from the first q tile that can see the kv tile. Two
// consumer warpgroups each own 64 keys (wgmma's M) and, per q tile, compute
// in this order, so that at most dK, dV, P^T and dP^T (plus the 16-bit
// operand) are live:
//   S^T = K Q^T                (m64n64k16, both operands K-major in smem)
//   P^T = exp(S^T scale - lse) (fp32 registers)
//   dV += P^T dO               (P^T to the input's type in registers as
//                               wgmma's A; dO from smem as an MN-major B)
//   dP^T = V dO^T              (m64n64k16 from smem)
//   dS^T = P^T (dP^T - delta) scale, then dK += dS^T Q  (as for dV)
// Each CTA owns its dk and dv rows: no atomics, no second pass. dq stays its
// own kernel (flash_dq_sm90.cu, flash_bwd.cu). 16-bit p and ds are what the
// reference's dots take on the TPU by default; the checks allow for exactly
// that rounding, in the input's type. At D=128 shared memory holds K 32 KB
// + V 32 KB + Q 2x16 KB + dO 2x16 KB. D 256 and D 16 and 32 have designs of
// their own (below).
// Head dims between the builds (16-bit d past 32, a multiple of 8, so that
// a row of d values is a legal TMA stride) run the kernel of the next
// build D (64 or 128, or 256 on the D 256 design) on the caller's [B, S, H,
// d] tensors as they are (kCut), as the forward does (flash_fwd_sm90.cu):
// the tensor maps of K, V, Q and dO take d as the extent and d * 2 bytes
// as the row stride and keep the build's 128-byte boxes, so TMA fills
// columns d .. D - 1 of every tile with zeros (a box wholly past d reads
// zeros alone), and the stores of dK and dV take d as their row stride and
// skip the columns past d. The products are the build's own, so dk and dv
// equal those of the inputs zero-padded to D bit for bit, without the four
// copies in and the two out that padding cost. At d = D the build runs as
// it did.
#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace hvdt {
namespace {

using namespace sm90;

constexpr int kKeys = 128;  // keys of a CTA
constexpr int kQRows = 64;  // queries of a stage
constexpr int kStages = 2;

template <int D>
struct DkvSmem {
  static constexpr int kRegionK = kKeys * 128;     // [128][64] 16-bit
  static constexpr int kRegionQ = kQRows * 128;    // [64][64] 16-bit
  static constexpr int kTileK = (D / 64) * kRegionK;
  static constexpr int kTileQ = (D / 64) * kRegionQ;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTileK;
  static constexpr int kQ = kV + kTileK;
  static constexpr int kDo = kQ + kStages * kTileQ;
  static constexpr int kStats = kDo + kStages * kTileQ;  // lse, delta [64]
  static constexpr int kBar = kStats + kStages * 2 * kQRows * 4;
  // kv_full, full[2], empty[2]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages);
};

template <typename T, int D, bool kCut>
__global__ void __launch_bounds__(384, 1)
    flash_dkv_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, int H, int Sq, int Sk, int d,
                   int q_off, int k_off, int causal, float scale) {
  using L = DkvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kKeys;
  const int nq = (Sq + kQRows - 1) / kQRows;
  int first = 0;
  if (causal) {
    // q tile t sees this kv tile once q_off + 64 t + 63 >= k_off + k0.
    const long long need = (long long)k_off + k0 - q_off - (kQRows - 1);
    first = need <= 0 ? 0 : (int)min((long long)nq, (need + kQRows - 1) / kQRows);
  }

  if (threadIdx.x == 0) {
    bar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 32);   // the producer warp's lanes
      bar_init(&empty[s], 8);   // lane 0 of each consumer warp
    }
    bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: warp 0 only.
    regs_dec<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        bar_arrive_tx(kv_full, 2 * L::kTileK);
        for (int r = 0; r < D / 64; ++r) {
          tma_load_4d(smem + L::kK + r * L::kRegionK, &tk, kv_full, 64 * r, h,
                      k0, b);
          tma_load_4d(smem + L::kV + r * L::kRegionK, &tv, kv_full, 64 * r, h,
                      k0, b);
        }
      }
      for (int t = first; t < nq; ++t) {
        const int n = t - first, st = n % kStages;
        if (n >= kStages) bar_wait(&empty[st], ((n / kStages) & 1) ^ 1);
        const int q0 = t * kQRows;
        // lse (pre-scaled by log2 e) and delta of the tile's rows; rows past
        // Sq get lse = +inf, so their p is exactly 0.
        float* st_lse = reinterpret_cast<float*>(smem + L::kStats) +
                        st * 2 * kQRows;
        float* st_delta = st_lse + kQRows;
        for (int i = lane; i < kQRows; i += 32) {
          const int row = q0 + i;
          st_lse[i] = row < Sq ? lse[(size_t)bh * Sq + row] * kLog2e
                               : __int_as_float(0x7f800000);
          st_delta[i] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
        }
        if (lane == 0) {
          bar_arrive_tx(&full[st], 2 * L::kTileQ);
          uint8_t* qt = smem + L::kQ + st * L::kTileQ;
          uint8_t* dot = smem + L::kDo + st * L::kTileQ;
          for (int r = 0; r < D / 64; ++r) {
            tma_load_4d(qt + r * L::kRegionQ, &tq, &full[st], 64 * r, h, q0, b);
            tma_load_4d(dot + r * L::kRegionQ, &tdo, &full[st], 64 * r, h, q0,
                        b);
          }
        } else {
          bar_arrive(&full[st]);
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns keys k0 + 64c .. k0 + 64c + 63.
    regs_inc<240>();
    const int c = wg - 1;
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row0 = 64 * c + 16 * (t / 32) + lane / 4;  // +8 for i = 1
    const int col = 2 * (lane % 4);
    const int kpos0 = k_off + k0 + row0;
    const int last_kpos = k_off + k0 + 64 * c + 63;
    const float scale_log2 = scale * kLog2e;
    const uint32_t k_base = smem_u32(smem + L::kK) + c * 64 * 128;
    const uint32_t v_base = smem_u32(smem + L::kV) + c * 64 * 128;

    float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

    bar_wait(kv_full, 0);
    for (int tq_i = first; tq_i < nq; ++tq_i) {
      const int n = tq_i - first, st = n % kStages, ph = (n / kStages) & 1;
      const int q0 = tq_i * kQRows;
      const uint32_t q_st = smem_u32(smem + L::kQ + st * L::kTileQ);
      const uint32_t do_st = smem_u32(smem + L::kDo + st * L::kTileQ);
      const float* st_lse =
          reinterpret_cast<const float*>(smem + L::kStats) + st * 2 * kQRows;
      const float* st_delta = st_lse + kQRows;
      bar_wait(&full[st], ph);

      // S^T = K Q^T.
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a_off = (kk / 4) * L::kRegionK + (kk % 4) * 32;
        const uint32_t b_off = (kk / 4) * L::kRegionQ + (kk % 4) * 32;
        wgmma_ss<64, T>(s, desc_sw128(k_base + a_off, 16),
                        desc_sw128(q_st + b_off, 16), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // P^T, masked only on tiles that cross the diagonal or the ragged end.
      const bool masked =
          q0 + kQRows > Sq || (causal && q_off + q0 < last_kpos);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int qc = 8 * (e / 4) + col + e % 2;
        float p = exp2f(fmaf(s[e], scale_log2, -st_lse[qc]));
        if (masked) {
          const bool ok = q0 + qc < Sq &&
                          (!causal || q_off + q0 + qc >= kpos0 + 8 * ((e / 2) % 2));
          p = ok ? p : 0.f;
        }
        s[e] = p;
      }
      uint32_t op[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) op[e] = pack2<T>(s[2 * e], s[2 * e + 1]);

      // dV += P^T dO, then dP^T = V dO^T, in one commit group.
      fence_regs(acc_dv);
      fence_regs(op);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk) {
        const uint32_t a[4] = {op[4 * kk], op[4 * kk + 1], op[4 * kk + 2],
                               op[4 * kk + 3]};
        wgmma_rs<D, T>(acc_dv, a,
                       desc_sw128(do_st + kk * 16 * 128, L::kRegionQ), 1);
      }
      float dp[32];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a_off = (kk / 4) * L::kRegionK + (kk % 4) * 32;
        const uint32_t b_off = (kk / 4) * L::kRegionQ + (kk % 4) * 32;
        wgmma_ss<64, T>(dp, desc_sw128(v_base + a_off, 16),
                        desc_sw128(do_st + b_off, 16), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_dv);
      fence_regs(dp);
      fence_regs(op);

      // dS^T = P^T (dP^T - delta) scale, then dK += dS^T Q.
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int qc = 8 * (e / 4) + col + e % 2;
        dp[e] = s[e] * (dp[e] - st_delta[qc]) * scale;
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) op[e] = pack2<T>(dp[2 * e], dp[2 * e + 1]);
      fence_regs(acc_dk);
      fence_regs(op);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk) {
        const uint32_t a[4] = {op[4 * kk], op[4 * kk + 1], op[4 * kk + 2],
                               op[4 * kk + 3]};
        wgmma_rs<D, T>(acc_dk, a,
                       desc_sw128(q_st + kk * 16 * 128, L::kRegionQ), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_dk);
      fence_regs(op);
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[st]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = k0 + row0 + 8 * i;
      if (key >= Sk) continue;
      // kCut: rows of d columns, of which those past d are not stored.
      const size_t off =
          ((size_t)(b * Sk + key) * H + h) * (kCut ? d : D) + col;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        if (kCut && col + 8 * jj >= d) continue;
        store2<T>(dk + off + 8 * jj, acc_dk[4 * jj + 2 * i],
                  acc_dk[4 * jj + 2 * i + 1]);
        store2<T>(dv + off + 8 * jj, acc_dv[4 * jj + 2 * i],
                  acc_dv[4 * jj + 2 * i + 1]);
      }
    }
  }
}

// ---- D 256 ------------------------------------------------------------------
//
// At D 256 the design above does not fit: a consumer owning 64 keys would
// hold dK and dV as 2 x 64 x 256 / 128 = 256 fp32 registers a thread. Here
// one CTA owns 64 keys, and per 64-row q tile the two consumer warpgroups
// split the work twice:
// - first the q columns: warpgroup c computes S^T = K Q^T and dP^T = V dO^T
//   for queries 32c .. 32c + 31 (m64n32k16, both operands K-major in
//   shared memory), then its half of P^T and of dS^T = P^T (dP^T - delta)
//   scale in fp32 (dS from the unrounded P), and writes both halves in the
//   input's type into two swizzled [64 keys][64 q] tiles in shared memory
//   (the layout TMA gives a K-major tile), behind a proxy fence and a
//   named barrier over the 256 consumer threads;
// - then the head dim: warpgroup c does dV[:, 128c .. 128c + 127] += P^T dO
//   and dK[:, 128c .. 128c + 127] += dS^T Q (m64n128k16, A the P^T or dS^T
//   tile, B dO or Q as an MN-major operand), both from shared memory. A
//   second pass of the named barrier before the next tile's writes keeps
//   them from overwriting tiles the other warpgroup still reads.
// Registers per consumer thread: dK 64 + dV 64 + S^T 16 + dP^T 16.
// Shared memory: K 64x256x2 = 32,768 + V 32,768 + Q 2 x 32,768 + dO 2 x
// 32,768 + P^T and dS^T 2 x 8,192 + lse and delta 2 x 2 x 64 x 4 = 1,024
// + barriers = 214,056 bytes (215,080 with the alignment pad).
// Head dims 136 to 248 run here too (kCut, see the header): warpgroup c
// stores the columns 128c + col of dK and dV below d, so at d <= 192 the
// second warpgroup's last 64-column box holds zeros alone.

constexpr int kWideD = 256;
constexpr int kWideKeys = 64;  // keys of a CTA at D 256

struct WideSmem {
  static constexpr int kRegion = 64 * 128;              // [64][64] 16-bit
  static constexpr int kTile = (kWideD / 64) * kRegion; // [64][256]
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTile;
  static constexpr int kQ = kV + kTile;
  static constexpr int kDo = kQ + kStages * kTile;
  static constexpr int kPt = kDo + kStages * kTile;     // P^T [64 k][64 q]
  static constexpr int kDst = kPt + kRegion;            // dS^T
  static constexpr int kStats = kDst + kRegion;         // lse, delta [64]
  static constexpr int kBar = kStats + kStages * 2 * kQRows * 4;
  // kv_full, full[2], empty[2]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages);
  static_assert(kBytes + 1024 <= 232448, "dk/dv tiles exceed shared memory");
};

template <typename T, bool kCut>
__global__ void __launch_bounds__(384, 1)
    flash_dkv_sm90_wide(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, int H, int Sq, int Sk, int d,
                        int q_off, int k_off, int causal, float scale) {
  using L = WideSmem;
  constexpr int D = kWideD;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kWideKeys;
  const int nq = (Sq + kQRows - 1) / kQRows;
  int first = 0;
  if (causal) {
    // q tile t sees this kv tile once q_off + 64 t + 63 >= k_off + k0.
    const long long need = (long long)k_off + k0 - q_off - (kQRows - 1);
    first = need <= 0 ? 0 : (int)min((long long)nq, (need + kQRows - 1) / kQRows);
  }

  if (threadIdx.x == 0) {
    bar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 32);   // the producer warp's lanes
      bar_init(&empty[s], 8);   // lane 0 of each consumer warp
    }
    bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: warp 0 only.
    regs_dec<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        bar_arrive_tx(kv_full, 2 * L::kTile);
        for (int r = 0; r < D / 64; ++r) {
          tma_load_4d(smem + L::kK + r * L::kRegion, &tk, kv_full, 64 * r, h,
                      k0, b);
          tma_load_4d(smem + L::kV + r * L::kRegion, &tv, kv_full, 64 * r, h,
                      k0, b);
        }
      }
      for (int t = first; t < nq; ++t) {
        const int n = t - first, st = n % kStages;
        if (n >= kStages) bar_wait(&empty[st], ((n / kStages) & 1) ^ 1);
        const int q0 = t * kQRows;
        float* st_lse = reinterpret_cast<float*>(smem + L::kStats) +
                        st * 2 * kQRows;
        float* st_delta = st_lse + kQRows;
        for (int i = lane; i < kQRows; i += 32) {
          const int row = q0 + i;
          st_lse[i] = row < Sq ? lse[(size_t)bh * Sq + row] * kLog2e
                               : __int_as_float(0x7f800000);
          st_delta[i] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
        }
        if (lane == 0) {
          bar_arrive_tx(&full[st], 2 * L::kTile);
          uint8_t* qt = smem + L::kQ + st * L::kTile;
          uint8_t* dot = smem + L::kDo + st * L::kTile;
          for (int r = 0; r < D / 64; ++r) {
            tma_load_4d(qt + r * L::kRegion, &tq, &full[st], 64 * r, h, q0, b);
            tma_load_4d(dot + r * L::kRegion, &tdo, &full[st], 64 * r, h, q0,
                        b);
          }
        } else {
          bar_arrive(&full[st]);
        }
      }
    }
  } else {
    // Consumers: warpgroup c takes queries 32c .. 32c + 31 of each q tile
    // for S^T and dP^T, and columns 128c .. 128c + 127 of dK and dV.
    regs_inc<240>();
    const int c = wg - 1;
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row0 = 16 * (t / 32) + lane / 4;  // key row; +8 for i = 1
    const int col = 2 * (lane % 4);
    const int qc0 = 32 * c;
    const int kpos0 = k_off + k0 + row0;
    const int last_kpos = k_off + k0 + kWideKeys - 1;
    const float scale_log2 = scale * kLog2e;
    const uint32_t k_base = smem_u32(smem + L::kK);
    const uint32_t v_base = smem_u32(smem + L::kV);
    const uint32_t pt_base = smem_u32(smem + L::kPt);
    const uint32_t dst_base = smem_u32(smem + L::kDst);

    float acc_dk[64], acc_dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc_dk[i] = acc_dv[i] = 0.f;

    bar_wait(kv_full, 0);
    for (int tq_i = first; tq_i < nq; ++tq_i) {
      const int n = tq_i - first, st = n % kStages, ph = (n / kStages) & 1;
      const int q0 = tq_i * kQRows;
      const uint32_t q_st = smem_u32(smem + L::kQ + st * L::kTile);
      const uint32_t do_st = smem_u32(smem + L::kDo + st * L::kTile);
      const float* st_lse =
          reinterpret_cast<const float*>(smem + L::kStats) + st * 2 * kQRows;
      const float* st_delta = st_lse + kQRows;
      bar_wait(&full[st], ph);

      // S^T = K Q^T and dP^T = V dO^T on this warpgroup's 32 queries.
      float s[16], dp[16];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a_off = (kk / 4) * L::kRegion + (kk % 4) * 32;
        const uint32_t b_off = a_off + qc0 * 128;
        wgmma_ss<32, T>(s, desc_sw128(k_base + a_off, 16),
                        desc_sw128(q_st + b_off, 16), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a_off = (kk / 4) * L::kRegion + (kk % 4) * 32;
        const uint32_t b_off = a_off + qc0 * 128;
        wgmma_ss<32, T>(dp, desc_sw128(v_base + a_off, 16),
                        desc_sw128(do_st + b_off, 16), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P^T and dS^T, masked only on tiles that cross the diagonal or the
      // ragged end.
      const bool masked = q0 + kQRows > Sq ||
                          (causal && q_off + q0 + qc0 < last_kpos);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int qc = qc0 + 8 * (e / 4) + col + e % 2;
        float p = exp2f(fmaf(s[e], scale_log2, -st_lse[qc]));
        if (masked) {
          const bool ok = q0 + qc < Sq &&
                          (!causal || q_off + q0 + qc >= kpos0 + 8 * ((e / 2) % 2));
          p = ok ? p : 0.f;
        }
        s[e] = p;
        dp[e] = p * (dp[e] - st_delta[qc]) * scale;
      }

      // Both halves into the shared P^T and dS^T tiles: element (key r,
      // query q) at byte r * 128 + ((q / 8) ^ (r % 8)) * 16 + (q % 8) * 2,
      // the 128-byte swizzle. The first barrier waits for the other
      // warpgroup's products of the last q tile, which read these tiles.
      named_bar_sync(1, 256);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = row0 + 8 * i;
          const int byte =
              r * 128 + (((qc0 / 8 + j) ^ (r % 8)) << 4) + col * 2;
          *reinterpret_cast<uint32_t*>(smem + L::kPt + byte) =
              pack2<T>(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]);
          *reinterpret_cast<uint32_t*>(smem + L::kDst + byte) =
              pack2<T>(dp[4 * j + 2 * i], dp[4 * j + 2 * i + 1]);
        }
      fence_proxy_async();
      named_bar_sync(1, 256);

      // dV[:, 128c ..] += P^T dO and dK[:, 128c ..] += dS^T Q over the 64
      // queries, in one commit group.
      const uint32_t half = 2 * c * L::kRegion;
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk)
        wgmma_ss<128, T, 1>(acc_dv, desc_sw128(pt_base + kk * 32, 16),
                            desc_sw128(do_st + half + kk * 16 * 128, L::kRegion),
                            1);
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk)
        wgmma_ss<128, T, 1>(acc_dk, desc_sw128(dst_base + kk * 32, 16),
                            desc_sw128(q_st + half + kk * 16 * 128, L::kRegion),
                            1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[st]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = k0 + row0 + 8 * i;
      if (key >= Sk) continue;
      // kCut: rows of d columns; the mask is on the absolute column.
      const size_t off =
          ((size_t)(b * Sk + key) * H + h) * (kCut ? d : D) + 128 * c + col;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        if (kCut && 128 * c + col + 8 * jj >= d) continue;
        store2<T>(dk + off + 8 * jj, acc_dk[4 * jj + 2 * i],
                  acc_dk[4 * jj + 2 * i + 1]);
        store2<T>(dv + off + 8 * jj, acc_dv[4 * jj + 2 * i],
                  acc_dv[4 * jj + 2 * i + 1]);
      }
    }
  }
}

// ---- D 16 and 32: narrow rows ---------------------------------------------
//
// A 16-bit row is 32 bytes at D 16 and 64 at D 32: each tile is one region
// in the swizzle of the row's width (sm90_common.cuh), one TMA box. The
// order of the products is the D 64-128 design's: S^T = K Q^T and dP^T =
// V dO^T take one k16 step at D 16 and two at D 32 (m64n64, both operands
// K-major); dV += P^T dO and dK += dS^T Q have N = D (m64n16k16 or
// m64n32k16, dO and Q read from the same stage as MN-major operands, a k16
// step 16 rows). As in the narrow forward, the tensor cores and the bytes
// are far from binding: each CTA's chain per q tile (the TMA wait, two
// products, the exponentials, two more products) and the number of CTAs
// in flight are. So a CTA is kNarrowGroups consumer warpgroups of 64 keys
// and one producer warp (K and V resident, Q, dO, lse and delta through a
// ring of kNarrowStages 64-row q tiles), no register hand-over (a consumer
// thread holds dK and dV in D registers, S^T and dP^T in 64), and
// kNarrowCtasPerSm of them share an SM. tools/narrow_variants.py builds and
// times the other choices of these constants on the card (PERF.md records
// the times): 128-key CTAs were 17-18% slower at one an SM (43-52% at
// two, where they spill), four CTAs an SM spilled and ran 23-34% slower,
// a third stage 1-3% faster than two (taken), one CTA an SM's bound the
// same.
constexpr int kNarrowGroups = 1;     // consumer warpgroups (keys / 64)
constexpr int kNarrowStages = 3;     // q tiles in the ring
constexpr int kNarrowCtasPerSm = 2;  // __launch_bounds__' minimum
constexpr int kNarrowKeys = 64 * kNarrowGroups;
constexpr int kNarrowThreads = 128 * kNarrowGroups + 32;

template <int D>
struct NarrowSmem {
  static constexpr int kRowBytes = D * 2;
  static constexpr int kTileK = kNarrowKeys * kRowBytes;  // [keys][D]
  static constexpr int kTileQ = kQRows * kRowBytes;       // [64][D]
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTileK;
  static constexpr int kQ = kV + kTileK;
  static constexpr int kDo = kQ + kNarrowStages * kTileQ;
  static constexpr int kStats = kDo + kNarrowStages * kTileQ;  // lse, delta [64]
  static constexpr int kBar = kStats + kNarrowStages * 2 * kQRows * 4;
  // kv_full, full[stages], empty[stages]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kNarrowStages);
  static_assert(kTileK % 1024 == 0 && kTileQ % 1024 == 0,
                "narrow tiles keep the 1024-byte alignment");
  static_assert(kNarrowCtasPerSm * (kBytes + 1024) <= 232448,
                "narrow dk/dv tiles exceed shared memory");
};

template <typename T, int D>
__global__ void __launch_bounds__(kNarrowThreads, kNarrowCtasPerSm)
    flash_dkv_sm90_narrow(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int H,
                          int Sq, int Sk, int q_off, int k_off, int causal,
                          float scale) {
  using L = NarrowSmem<D>;
  constexpr int kStg = kNarrowStages, kRB = L::kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStg;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kNarrowKeys;
  const int nq = (Sq + kQRows - 1) / kQRows;
  int first = 0;
  if (causal) {
    // q tile t sees this kv tile once q_off + 64 t + 63 >= k_off + k0.
    const long long need = (long long)k_off + k0 - q_off - (kQRows - 1);
    first = need <= 0 ? 0 : (int)min((long long)nq, (need + kQRows - 1) / kQRows);
  }

  if (threadIdx.x == 0) {
    bar_init(kv_full, 1);
    for (int s = 0; s < kStg; ++s) {
      bar_init(&full[s], 32);                   // the producer warp's lanes
      bar_init(&empty[s], 4 * kNarrowGroups);   // lane 0 of each consumer warp
    }
    bar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == 4 * kNarrowGroups) {
    // Producer: the last warp.
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      bar_arrive_tx(kv_full, 2 * L::kTileK);
      tma_load_4d(smem + L::kK, &tk, kv_full, 0, h, k0, b);
      tma_load_4d(smem + L::kV, &tv, kv_full, 0, h, k0, b);
    }
    for (int t = first; t < nq; ++t) {
      const int n = t - first, st = n % kStg;
      if (n >= kStg) bar_wait(&empty[st], ((n / kStg) & 1) ^ 1);
      const int q0 = t * kQRows;
      // lse (pre-scaled by log2 e) and delta of the tile's rows; rows past
      // Sq get lse = +inf, so their p is exactly 0.
      float* st_lse = reinterpret_cast<float*>(smem + L::kStats) + st * 2 * kQRows;
      float* st_delta = st_lse + kQRows;
      for (int i = lane; i < kQRows; i += 32) {
        const int row = q0 + i;
        st_lse[i] = row < Sq ? lse[(size_t)bh * Sq + row] * kLog2e
                             : __int_as_float(0x7f800000);
        st_delta[i] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
      }
      if (lane == 0) {
        bar_arrive_tx(&full[st], 2 * L::kTileQ);
        tma_load_4d(smem + L::kQ + st * L::kTileQ, &tq, &full[st], 0, h, q0, b);
        tma_load_4d(smem + L::kDo + st * L::kTileQ, &tdo, &full[st], 0, h, q0,
                    b);
      } else {
        bar_arrive(&full[st]);
      }
    }
    return;
  }

  // Consumers: warpgroup c owns keys k0 + 64c .. k0 + 64c + 63.
  const int c = warp / 4;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int row0 = 64 * c + 16 * (t / 32) + lane / 4;  // +8 for i = 1
  const int col = 2 * (lane % 4);
  const int kpos0 = k_off + k0 + row0;
  const int last_kpos = k_off + k0 + 64 * c + 63;
  const float scale_log2 = scale * kLog2e;
  const uint32_t k_base = smem_u32(smem + L::kK) + c * 64 * kRB;
  const uint32_t v_base = smem_u32(smem + L::kV) + c * 64 * kRB;

  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  bar_wait(kv_full, 0);
  for (int tq_i = first; tq_i < nq; ++tq_i) {
    const int n = tq_i - first, st = n % kStg, ph = (n / kStg) & 1;
    const int q0 = tq_i * kQRows;
    const uint32_t q_st = smem_u32(smem + L::kQ + st * L::kTileQ);
    const uint32_t do_st = smem_u32(smem + L::kDo + st * L::kTileQ);
    const float* st_lse =
        reinterpret_cast<const float*>(smem + L::kStats) + st * 2 * kQRows;
    const float* st_delta = st_lse + kQRows;
    bar_wait(&full[st], ph);

    // S^T = K Q^T.
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64, T>(s, desc_narrow<kRB>(k_base + kk * 32, 16),
                      desc_narrow<kRB>(q_st + kk * 32, 16), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // P^T, masked only on tiles that cross the diagonal or the ragged end.
    const bool masked = q0 + kQRows > Sq || (causal && q_off + q0 < last_kpos);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int qc = 8 * (e / 4) + col + e % 2;
      float p = exp2f(fmaf(s[e], scale_log2, -st_lse[qc]));
      if (masked) {
        const bool ok = q0 + qc < Sq &&
                        (!causal || q_off + q0 + qc >= kpos0 + 8 * ((e / 2) % 2));
        p = ok ? p : 0.f;
      }
      s[e] = p;
    }
    uint32_t op[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) op[e] = pack2<T>(s[2 * e], s[2 * e + 1]);

    // dV += P^T dO, then dP^T = V dO^T, in one commit group.
    fence_regs(acc_dv);
    fence_regs(op);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQRows / 16; ++kk) {
      const uint32_t a[4] = {op[4 * kk], op[4 * kk + 1], op[4 * kk + 2],
                             op[4 * kk + 3]};
      wgmma_rs<D, T>(acc_dv, a, desc_narrow<kRB>(do_st + kk * 16 * kRB, L::kTileQ),
                     1);
    }
    float dp[32];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64, T>(dp, desc_narrow<kRB>(v_base + kk * 32, 16),
                      desc_narrow<kRB>(do_st + kk * 32, 16), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dv);
    fence_regs(dp);
    fence_regs(op);

    // dS^T = P^T (dP^T - delta) scale, then dK += dS^T Q.
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int qc = 8 * (e / 4) + col + e % 2;
      dp[e] = s[e] * (dp[e] - st_delta[qc]) * scale;
    }
#pragma unroll
    for (int e = 0; e < 16; ++e) op[e] = pack2<T>(dp[2 * e], dp[2 * e + 1]);
    fence_regs(acc_dk);
    fence_regs(op);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQRows / 16; ++kk) {
      const uint32_t a[4] = {op[4 * kk], op[4 * kk + 1], op[4 * kk + 2],
                             op[4 * kk + 3]};
      wgmma_rs<D, T>(acc_dk, a, desc_narrow<kRB>(q_st + kk * 16 * kRB, L::kTileQ),
                     1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dk);
    fence_regs(op);
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[st]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + row0 + 8 * i;
    if (key >= Sk) continue;
    const size_t off = ((size_t)(b * Sk + key) * H + h) * D + col;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      store2<T>(dk + off + 8 * jj, acc_dk[4 * jj + 2 * i],
                acc_dk[4 * jj + 2 * i + 1]);
      store2<T>(dv + off + 8 * jj, acc_dv[4 * jj + 2 * i],
                acc_dv[4 * jj + 2 * i + 1]);
    }
  }
}

template <typename T, int D>
cudaError_t run_narrow(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int H, int Sq, int Sk,
                       int q_off, int k_off, int causal, float scale,
                       cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = encode_bshd<T>(&tq, q, B, Sq, H, D, kQRows);
  if (err == cudaSuccess) err = encode_bshd<T>(&tdo, dout, B, Sq, H, D, kQRows);
  if (err == cudaSuccess) err = encode_bshd<T>(&tk, k, B, Sk, H, D, kNarrowKeys);
  if (err == cudaSuccess) err = encode_bshd<T>(&tv, v, B, Sk, H, D, kNarrowKeys);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sk + kNarrowKeys - 1) / kNarrowKeys);
  return launch_threads(flash_dkv_sm90_narrow<T, D>, grid, kNarrowThreads,
                        NarrowSmem<D>::kBytes + 1024, stream, tq, tk, tv, tdo,
                        (const float*)lse, (const float*)delta, (T*)dk,
                        (T*)dv, H, Sq, Sk, q_off, k_off, causal, scale);
}

// The build of head dim D on tensors of head dim d <= D (d < D: kCut, see
// the header).
template <typename T, int D, bool kCut>
cudaError_t launch_build(const CUtensorMap& tq, const CUtensorMap& tk,
                         const CUtensorMap& tv, const CUtensorMap& tdo,
                         const void* lse, const void* delta, void* dk,
                         void* dv, dim3 grid, int H, int Sq, int Sk, int d,
                         int q_off, int k_off, int causal, float scale,
                         cudaStream_t stream) {
  if constexpr (D == kWideD)
    return launch_ws(flash_dkv_sm90_wide<T, kCut>, grid,
                     WideSmem::kBytes + 1024, stream, tq, tk, tv, tdo,
                     (const float*)lse, (const float*)delta, (T*)dk, (T*)dv,
                     H, Sq, Sk, d, q_off, k_off, causal, scale);
  else
    return launch_ws(flash_dkv_sm90<T, D, kCut>, grid,
                     DkvSmem<D>::kBytes + 1024, stream, tq, tk, tv, tdo,
                     (const float*)lse, (const float*)delta, (T*)dk, (T*)dv,
                     H, Sq, Sk, d, q_off, k_off, causal, scale);
}

template <typename T, int D>
cudaError_t run(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dk, void* dv, int B,
                int H, int Sq, int Sk, int d, int q_off, int k_off,
                int causal, float scale, cudaStream_t stream) {
  constexpr int keys = D == kWideD ? kWideKeys : kKeys;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = encode_bshd<T>(&tq, q, B, Sq, H, d, kQRows, D);
  if (err == cudaSuccess)
    err = encode_bshd<T>(&tdo, dout, B, Sq, H, d, kQRows, D);
  if (err == cudaSuccess) err = encode_bshd<T>(&tk, k, B, Sk, H, d, keys, D);
  if (err == cudaSuccess) err = encode_bshd<T>(&tv, v, B, Sk, H, d, keys, D);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sk + keys - 1) / keys);
  if (d == D)
    return launch_build<T, D, false>(tq, tk, tv, tdo, lse, delta, dk, dv,
                                     grid, H, Sq, Sk, d, q_off, k_off,
                                     causal, scale, stream);
  return launch_build<T, D, true>(tq, tk, tv, tdo, lse, delta, dk, dv, grid,
                                  H, Sq, Sk, d, q_off, k_off, causal, scale,
                                  stream);
}

// The build a head dim d runs at: 16 and 32 (narrow) for themselves, any
// other multiple of 8 past 32 the next of 64, 128 and 256.
template <typename T>
cudaError_t run_for_dim(int d, const void* q, const void* k, const void* v,
                        const void* g, const void* lse, const void* delta,
                        void* dk, void* dv, int B, int H, int Sq, int Sk,
                        int qo, int ko, int causal, float sc,
                        cudaStream_t st) {
  if (d == 16) return run_narrow<T, 16>(q, k, v, g, lse, delta, dk, dv, B, H, Sq, Sk, qo, ko, causal, sc, st);
  if (d == 32) return run_narrow<T, 32>(q, k, v, g, lse, delta, dk, dv, B, H, Sq, Sk, qo, ko, causal, sc, st);
  if (d <= 32 || d % 8) return cudaErrorInvalidValue;
  if (d <= 64) return run<T, 64>(q, k, v, g, lse, delta, dk, dv, B, H, Sq, Sk, d, qo, ko, causal, sc, st);
  if (d <= 128) return run<T, 128>(q, k, v, g, lse, delta, dk, dv, B, H, Sq, Sk, d, qo, ko, causal, sc, st);
  if (d <= 256) return run<T, 256>(q, k, v, g, lse, delta, dk, dv, B, H, Sq, Sk, d, qo, ko, causal, sc, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace hvdt

// dtype: 1 bf16, 2 fp16 (hvdt::DType). q, k, v, do: contiguous [B, S, H, D]
// of that type with 16-byte-aligned bases; D is 16, 32 or a multiple of 8
// from 40 to 256 (run by the build of 64, 128 or 256). lse, delta: fp32
// [B, H, Sq]. dk, dv: [B, Sk, H, D] of that type.
extern "C" int hvdt_flash_dkv_sm90(int dtype, const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int H, int Sq,
                                   int Sk, int D, int q_off, int k_off,
                                   int causal, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == hvdt::kBFloat16)
    return hvdt::run_for_dim<__nv_bfloat16>(D, q, k, v, dout, lse, delta, dk,
                                            dv, B, H, Sq, Sk, q_off, k_off,
                                            causal, scale, st);
  if (dtype == hvdt::kFloat16)
    return hvdt::run_for_dim<__half>(D, q, k, v, dout, lse, delta, dk, dv, B,
                                     H, Sq, Sk, q_off, k_off, causal, scale,
                                     st);
  return cudaErrorInvalidValue;
}
