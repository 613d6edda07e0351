// Flash-attention dk/dv backward for Hopper's tensor cores (sm_90a), bf16 at
// head dims 64 and 128.
//
// Replaces the TPU kernel `_bwd_dkv_kernel` (with the shared recompute
// `_recompute_p_ds`) in horovod_tpu/parallel/flash_attention.py, launched by
// `_flash_bwd_bhsd`, as flash_dkv_kernel in flash_bwd.cu does for fp32 and the
// small head dims. Same function: for every visible (q, k) pair recompute
// p = exp(s - lse) and ds = p (dp - delta) scale from q, k, v, do and the
// forward's per-row lse (+inf on rows that saw no key, so p is exactly 0
// there) and delta = rowsum(do * o); then dv = sum over q of p^T do and
// dk = sum over q of ds^T q, accumulated in fp32 and written in bf16.
//
// What bounds it on this card. Four matrix products per visible pair (s, dp,
// p^T do, ds^T q) against six [B, S, H, D] tensors moved: about 500
// operations per byte at the main path's shape (B=4, S=2048, H=16, D=128,
// causal), so the bf16 tensor cores (989 TFLOP/s) are the limit.
//
// Design. One CTA per (128-row kv tile, batch*head); the causally heaviest
// kv tiles (the first ones) come first on grid.y. K and V are loaded once by
// TMA and stay in shared memory. A producer warp streams 64-row q tiles
// (Q and dO by TMA through 4-D tensor maps over [B, S, H, D], lse and delta
// by its 32 lanes) through a two-stage ring guarded by full/empty mbarriers,
// from the first q tile that can see the kv tile. Two consumer warpgroups
// each own 64 keys (wgmma's M) and, per q tile, compute in this order, so
// that at most dK, dV, P^T and dP^T (plus the bf16 operand) are live:
//   S^T = K Q^T                (m64n64k16, both operands K-major in smem)
//   P^T = exp(S^T scale - lse) (fp32 registers)
//   dV += P^T dO               (P^T to bf16 in registers as wgmma's A; dO
//                               from smem as an MN-major B)
//   dP^T = V dO^T              (m64n64k16 from smem)
//   dS^T = P^T (dP^T - delta) scale, then dK += dS^T Q  (as for dV)
// Each CTA owns its dk and dv rows: no atomics, no second pass. dq stays its
// own kernel (flash_bwd.cu). bf16 p and ds are what the reference's dots take
// on the TPU by default; the checks allow for exactly that rounding. At
// D=128 shared memory holds K 32 KB + V 32 KB + Q 2x16 KB + dO 2x16 KB.
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
  static constexpr int kRegionK = kKeys * 128;     // [128][64] bf16
  static constexpr int kRegionQ = kQRows * 128;    // [64][64] bf16
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

template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_dkv_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int H, int Sq, int Sk,
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
        wgmma_ss<64>(s, desc_sw128(k_base + a_off, 16),
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
      for (int e = 0; e < 16; ++e) op[e] = pack_bf16(s[2 * e], s[2 * e + 1]);

      // dV += P^T dO, then dP^T = V dO^T, in one commit group.
      fence_regs(acc_dv);
      fence_regs(op);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk) {
        const uint32_t a[4] = {op[4 * kk], op[4 * kk + 1], op[4 * kk + 2],
                               op[4 * kk + 3]};
        wgmma_rs<D>(acc_dv, a, desc_sw128(do_st + kk * 16 * 128, L::kRegionQ),
                    1);
      }
      float dp[32];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a_off = (kk / 4) * L::kRegionK + (kk % 4) * 32;
        const uint32_t b_off = (kk / 4) * L::kRegionQ + (kk % 4) * 32;
        wgmma_ss<64>(dp, desc_sw128(v_base + a_off, 16),
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
      for (int e = 0; e < 16; ++e) op[e] = pack_bf16(dp[2 * e], dp[2 * e + 1]);
      fence_regs(acc_dk);
      fence_regs(op);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk) {
        const uint32_t a[4] = {op[4 * kk], op[4 * kk + 1], op[4 * kk + 2],
                               op[4 * kk + 3]};
        wgmma_rs<D>(acc_dk, a, desc_sw128(q_st + kk * 16 * 128, L::kRegionQ),
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
        *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * jj) =
            __floats2bfloat162_rn(acc_dk[4 * jj + 2 * i],
                                  acc_dk[4 * jj + 2 * i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * jj) =
            __floats2bfloat162_rn(acc_dv[4 * jj + 2 * i],
                                  acc_dv[4 * jj + 2 * i + 1]);
      }
    }
  }
}

template <int D>
cudaError_t run(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dk, void* dv, int B,
                int H, int Sq, int Sk, int q_off, int k_off, int causal,
                float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = encode_bshd(&tq, q, B, Sq, H, D, kQRows);
  if (err == cudaSuccess) err = encode_bshd(&tdo, dout, B, Sq, H, D, kQRows);
  if (err == cudaSuccess) err = encode_bshd(&tk, k, B, Sk, H, D, kKeys);
  if (err == cudaSuccess) err = encode_bshd(&tv, v, B, Sk, H, D, kKeys);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sk + kKeys - 1) / kKeys);
  return launch_ws(flash_dkv_sm90<D>, grid, DkvSmem<D>::kBytes + 1024,
                   stream, tq, tk, tv, tdo, (const float*)lse,
                   (const float*)delta, (__nv_bfloat16*)dk,
                   (__nv_bfloat16*)dv, H, Sq, Sk, q_off, k_off, causal,
                   scale);
}

}  // namespace
}  // namespace hvdt

// q, k, v, do: contiguous bf16 [B, S, H, D] with 16-byte-aligned bases; D is
// 64 or 128. lse, delta: fp32 [B, H, Sq]. dk, dv: bf16 [B, Sk, H, D].
extern "C" int hvdt_flash_dkv_sm90(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int H, int Sq,
                                   int Sk, int D, int q_off, int k_off,
                                   int causal, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64: return hvdt::run<64>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, q_off, k_off, causal, scale, st);
    case 128: return hvdt::run<128>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, q_off, k_off, causal, scale, st);
    default: return cudaErrorInvalidValue;
  }
}
