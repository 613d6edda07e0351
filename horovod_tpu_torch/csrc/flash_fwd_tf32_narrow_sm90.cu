// Flash-attention forward for Hopper's tensor cores (sm_90a), fp32 at head
// dims 16 and 32 through 3xTF32 (the "tf32" design's narrow builds; the
// wrapper zero-pads D 1-15 to 16 and D 17-31 to 32 and passes the scale of
// the true D).
//
// Replaces the TPU kernel `_kernel` in horovod_tpu/parallel/flash_attention.py
// (launched by `_flash_bhsd`) for fp32 at D <= 32, where flash_fwd.cu's
// fp32-FMA kernel ran before; flash_fwd_stream_sm90.cu takes fp32 past D 32
// and flash_fwd_sm90.cu the 16-bit types. Same function and contract: an
// online softmax whose running max m, normalizer l and output accumulator
// stay in fp32; runtime offsets give the global positions of q[0] and k[0];
// kv tiles wholly in the future of a q tile are skipped; rows that see no
// key give o = 0, m = -1e30, l = 0; [B, S, H, D] is read in place (through
// the pre-pass below) and the stats are written as [B, H, S].
//
// What bounds it on this card. At the C4 shape (B 2, S 1024, H 8, causal)
// and D 32 the function does 1.07 GFLOP over 8.4 MB of q, k, v and o:
// 3xTF32 takes three tf32 products where fp32 takes one, 0.0065 ms at the
// 494.7 TFLOP/s tf32 peak, against 0.0025 ms for the bytes and 0.0160 ms for
// the same products as fp32 FMAs (flash_fwd.cu reached 12% of that). At D
// 16 all of these halve. No term is large. One warpgroup a q tile is bound
// by its serial chain of steps per kv tile (the TMA wait, S, the softmax,
// P V); with the tiles shared among warpgroups (below) 3 and 4 of them
// take the same time on an H100 (PERF.md), which is then bound by the
// count of its small products (m64n32k8 and m64n16k8, about a quarter of
// the tf32 peak's rate at N 32), and the pre-pass beside it.
//
// Operands. As in the tf32 builds of flash_fwd_stream_sm90.cu: the pre-pass
// (sm90_common.cuh: tf32_fwd_split) writes Q and K split into hi = tf32(x)
// and lo = tf32(x - hi) in their [B, S, H, D] layout, and V^T hi and lo as
// [B, H, D, Sk rounded up to 32] with the keys of every 8 permuted so that
// P's accumulator fragment feeds tf32 wgmma's register A operand without a
// shuffle. Each product is hi.hi + hi.lo + lo.hi in m64nNk8 tf32 wgmmas
// with fp32 accumulators, the small products first: S = Q K^T (N = the kv
// stage's keys) and each kv tile's P V (N = D) into an accumulator of its
// own, which fp32 fmas fold into O (O = O corr + P V; kSplitChains in
// flash_fwd_stream_sm90.cu says why one chain is not enough). Q and K rows
// are 64 or 128 bytes: TMA writes them in the swizzle of that width
// (encode_bshd) and wgmma reads them through descriptors of the same mode
// (a k8 step is 32 bytes of a row: two at D 16, four at D 32); V^T rows are
// 32 keys of 128 bytes, as in the 128-column build.
//
// Structure (the narrow 16-bit forward's, flash_fwd_sm90.cu
// flash_fwd_sm90_narrow). A CTA owns one tile of 64 q rows (wgmma's M; grid
// (B H, q tiles), the heaviest causal q tiles first on grid.y), and
// kNarrowSplit consumer warpgroups share its kv tiles of kNarrowKv keys:
// - all hold the same 64 rows; warpgroup w takes kv tiles j = w, w + G,
//   w + 2 G, ... (G = kNarrowSplit; round-robin, so that the causal
//   diagonal's tile is no one warpgroup's), each through a ring of
//   kNarrowStages stages of its own (K hi and lo, V^T hi and lo) fed by
//   lane w of the one producer warp, which waits on that warpgroup's
//   barriers alone; lane 0 also loads Q hi and lo once;
// - each warpgroup runs an online softmax over its own tiles (its own
//   running max, l and O; p is split into tf32 hi and lo, so its rounding
//   is that of 3xTF32 wherever the max stands, and one pass suffices where
//   the 16-bit build needs two);
// - after its last tile, warpgroups 1 .. G - 1 leave their O, m and l in
//   their own rings (free by then) behind a named barrier (kSumBar), and
//   warpgroup 0 takes the rows' max m over the G, adds each warpgroup's O
//   and l scaled by exp(m_w - m) to its own in the order w = 1, 2, ...,
//   normalizes and stores o, m and l. A warpgroup with no kv tile (S 32, a
//   causal first q tile) passes the barrier with m = -1e30, l = 0 and
//   O = 0, whose scale is 0 (or 1 where no warpgroup saw a key). o, m and l
//   are the same bits from run to run.
// tools/narrow_tf32_variants.py rebuilds this file with other constants
// (PERF.md has its table).
//
// Budgets (registers and shared memory, at D 32). A consumer thread holds O
// (D / 2 = 16), a tile's P V (16), S and then P lo (kKv / 2 = 16) and P hi
// (16): 64 registers, under the 120 that 4 x 128 + 32 threads leave each.
// Shared memory: Q hi and lo 2 x 64 x 128 = 16,384 B; a stage holds K hi
// and lo 2 x 32 x 128 and V^T hi and lo 2 x 32 x 128, 16,384 B; 4 rings of
// 3 stages 196,608 B; 213,192 B with the barriers (214,216 with the 1 KB
// alignment pad, of 232,448). At D 16 every tile halves. 64-key stages
// would double a stage and leave one a ring at G 4.
#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace hvdt {
namespace {

using namespace sm90;

constexpr int kNarrowSplit = 4;      // consumer warpgroups on one q tile
constexpr int kNarrowKv = 32;        // keys of a kv stage
constexpr int kNarrowStages = 3;     // kv stages of each warpgroup's ring
constexpr int kNarrowCtasPerSm = 1;  // __launch_bounds__' minimum
constexpr int kRows = 64;            // q rows of a CTA
constexpr int kThreads = 128 * kNarrowSplit + 32;
// The consumer warpgroups' named barrier: their partial sums.
constexpr int kSumBar = 1;

template <int D>
struct NarrowTf32Smem {
  static constexpr int kRowBytes = D * 4;                // 64 or 128
  static constexpr int kTileQ = kRows * kRowBytes;       // [64][D], a plane
  static constexpr int kTileK = kNarrowKv * kRowBytes;   // [kKv][D], a plane
  static constexpr int kRegionV = D * 128;               // [D][32 keys]
  static constexpr int kPlaneV = kNarrowKv / 32 * kRegionV;
  // K hi, K lo, V^T hi, V^T lo
  static constexpr int kStage = 2 * (kTileK + kPlaneV);
  static constexpr int kRing = kNarrowStages * kStage;  // a warpgroup's
  static constexpr int kQ = 0;                           // Q hi, then Q lo
  static constexpr int kRings = kQ + 2 * kTileQ;
  static constexpr int kBar = kRings + kNarrowSplit * kRing;
  // q_full, full[G][stages], empty[G][stages]
  static constexpr int kBytes =
      kBar + 8 * (1 + 2 * kNarrowSplit * kNarrowStages);
  // A warpgroup's partial O (D / 2 fp32 a thread), m and l (2 each),
  // written over its own ring after its last tile: [D / 2 + 4][128] fp32.
  static constexpr int kPart = (D / 2 + 4) * 128 * 4;
  static_assert(D == 16 || D == 32, "narrow tf32 builds: D 16 and 32");
  static_assert(kNarrowKv == 32 || kNarrowKv == 64,
                "kv stages of one or two 32-key V^T regions");
  static_assert(kTileQ % 1024 == 0 && kTileK % 1024 == 0 &&
                    kRegionV % 1024 == 0,
                "swizzled tiles start on 1024-byte boundaries");
  static_assert(kPart <= kRing, "a partial O exceeds its warpgroup's ring");
  static_assert(kNarrowCtasPerSm * (kBytes + 1024) <= 232448,
                "narrow tf32 forward tiles exceed shared memory");
};

template <int D>
__global__ void __launch_bounds__(kThreads, kNarrowCtasPerSm)
    flash_fwd_tf32_narrow(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tq_lo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tk_lo,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tv_lo,
                          float* __restrict__ o, float* __restrict__ m_out,
                          float* __restrict__ l_out, int H, int Sq, int Sk,
                          int q_off, int k_off, int causal, float scale) {
  using L = NarrowTf32Smem<D>;
  constexpr int kKv = kNarrowKv, kStg = kNarrowStages, kG = kNarrowSplit;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = q_full + 1;  // [G][stages]
  uint64_t* empty = full + kG * kStg;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  int nk = (Sk + kKv - 1) / kKv;
  if (causal) {
    // kv tile j is visible while k_off + kKv j <= q_off + q0 + rows - 1.
    const long long reach = (long long)q_off + q0 + kRows - 1 - k_off;
    nk = min(nk, reach < 0 ? 0 : (int)(reach / kKv) + 1);
  }
  // kv tiles of warpgroup w: j = w + G i for i < tiles_of(w).
  auto tiles_of = [&](int w) { return nk > w ? (nk - w + kG - 1) / kG : 0; };

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < kG * kStg; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 4);  // lane 0 of each warp of the warpgroup
    }
    bar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == 4 * kG) {
    // Producer: the last warp. Lane 0 loads Q hi and lo; lane w < G feeds
    // warpgroup w's ring with K hi and lo and V^T hi and lo of its tiles,
    // waiting on that warpgroup's barriers alone.
    const int w = threadIdx.x % 32;
    if (w == 0) {
      bar_arrive_tx(q_full, 2 * L::kTileQ);
      tma_load_4d(smem + L::kQ, &tq, q_full, 0, h, q0, b);
      tma_load_4d(smem + L::kQ + L::kTileQ, &tq_lo, q_full, 0, h, q0, b);
    }
    if (w < kG) {
      const int nw = tiles_of(w);
      uint8_t* ring = smem + L::kRings + w * L::kRing;
      uint64_t* fb = full + w * kStg;
      uint64_t* eb = empty + w * kStg;
      for (int i = 0; i < nw; ++i) {
        const int st = i % kStg, key = (w + kG * i) * kKv;
        uint8_t* kt = ring + st * L::kStage;
        uint8_t* vt = kt + 2 * L::kTileK;
        // Stage st is free once the warpgroup released load i - kStg.
        if (i >= kStg) bar_wait(&eb[st], ((i / kStg) & 1) ^ 1);
        bar_arrive_tx(&fb[st], L::kStage);
        tma_load_4d(kt, &tk, &fb[st], 0, h, key, b);
        tma_load_4d(kt + L::kTileK, &tk_lo, &fb[st], 0, h, key, b);
#pragma unroll
        for (int r = 0; r < kKv / 32; ++r) {
          tma_load_4d(vt + r * L::kRegionV, &tv, &fb[st], key + 32 * r, 0,
                      h, b);
          tma_load_4d(vt + L::kPlaneV + r * L::kRegionV, &tv_lo, &fb[st],
                      key + 32 * r, 0, h, b);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup w, all on the q tile's 64 rows.
  const int w = warp / 4;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int row0 = 16 * (t / 32) + lane / 4;  // +8 for i = 1
  const int col = 2 * (lane % 4);
  const uint32_t q_hi = smem_u32(smem + L::kQ), q_lo = q_hi + L::kTileQ;
  const uint32_t ring = smem_u32(smem + L::kRings + w * L::kRing);
  uint64_t* fb = full + w * kStg;
  uint64_t* eb = empty + w * kStg;
  const int first_qpos = q_off + q0;
  const int qpos0 = q_off + q0 + row0;
  const int nw = tiles_of(w);

  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};

  bar_wait(q_full, 0);
  for (int i = 0; i < nw; ++i) {
    const int st = i % kStg, k0 = (w + kG * i) * kKv;
    const uint32_t kt = ring + st * L::kStage, vt = kt + 2 * L::kTileK;
    bar_wait(&fb[st], (i / kStg) & 1);
    float s[kKv / 2];
    tf32x3_scores<D, kKv>(s, q_hi, q_lo, kt, kt + L::kTileK);
    wgmma_wait<0>();
    fence_regs(s);

    const bool masked =
        k0 + kKv > Sk || (causal && k_off + k0 + kKv - 1 > first_qpos);
    float corr[2];
    online_softmax<kKv>(s, m_i, l_i, corr, masked, k0, col, qpos0, Sk,
                        k_off, causal, scale);
    // P split in registers: ph = tf32(p), and s becomes tf32(p - ph).
    uint32_t ph[kKv / 2];
    split_tf32(s, ph);
    float pv[D / 2];
    tf32x3_reg_product<D, kKv>(pv, ph, s, vt, vt + L::kPlaneV);
    __syncwarp();
    if (lane == 0) bar_arrive(&eb[st]);
#pragma unroll
    for (int e = 0; e < D / 2; ++e)
      acc[e] = fmaf(acc[e], corr[(e / 2) % 2], pv[e]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 1);
    l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 2);
  }
  if (kG > 1) {
    // Warpgroups 1 .. G - 1 leave their partial O, m and l in their rings
    // (whose last reads, by TMA and wgmma, are done); warpgroup 0 rescales
    // them to the rows' max and adds them to its own in warpgroup order.
    if (w > 0) {
      float* part = reinterpret_cast<float*>(smem + L::kRings + w * L::kRing);
      fence_proxy_async();
#pragma unroll
      for (int e = 0; e < D / 2; ++e) part[e * 128 + t] = acc[e];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        part[(D / 2 + i) * 128 + t] = m_i[i];
        part[(D / 2 + 2 + i) * 128 + t] = l_i[i];
      }
      named_bar_arrive(kSumBar, 128 * kG);
      return;
    }
    named_bar_sync(kSumBar, 128 * kG);
    // The rows' max over the warpgroups (exact, in any order).
    float m[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int u = 1; u < kG; ++u) {
      const float* part =
          reinterpret_cast<const float*>(smem + L::kRings + u * L::kRing);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        m[i] = fmaxf(m[i], part[(D / 2 + i) * 128 + t]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float a = exp2f((m_i[i] - m[i]) * kLog2e);
      l_i[i] *= a;
#pragma unroll
      for (int e = i * 2; e < D / 2; e += 4) {
        acc[e] *= a;
        acc[e + 1] *= a;
      }
      m_i[i] = m[i];
    }
#pragma unroll
    for (int u = 1; u < kG; ++u) {
      const float* part =
          reinterpret_cast<const float*>(smem + L::kRings + u * L::kRing);
      float a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[i] = exp2f((part[(D / 2 + i) * 128 + t] - m[i]) * kLog2e);
        l_i[i] = fmaf(part[(D / 2 + 2 + i) * 128 + t], a[i], l_i[i]);
      }
#pragma unroll
      for (int e = 0; e < D / 2; ++e)
        acc[e] = fmaf(part[e * 128 + t], a[(e / 2) % 2], acc[e]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + row0 + 8 * i;
    if (row >= Sq) continue;
    const float inv = 1.f / (l_i[i] == 0.f ? 1.f : l_i[i]);
    float* orow = o + ((size_t)(b * Sq + row) * H + h) * D + col;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      store2<float>(orow + 8 * jj, acc[4 * jj + 2 * i] * inv,
                    acc[4 * jj + 2 * i + 1] * inv);
    if (lane % 4 == 0) {
      m_out[(size_t)bh * Sq + row] = m_i[i];
      l_out[(size_t)bh * Sq + row] = l_i[i];
    }
  }
}

template <int D>
cudaError_t run_narrow(const Tf32Planes& p, void* o, void* m, void* l, int B,
                       int H, int Sq, int Sk, int q_off, int k_off,
                       int causal, float scale, cudaStream_t stream) {
  CUtensorMap maps[6];
  const int skp = padded_keys(Sk);
  cudaError_t err = encode_bshd<float>(&maps[0], p.qh, B, Sq, H, D, kRows);
  if (err == cudaSuccess)
    err = encode_bshd<float>(&maps[1], p.ql, B, Sq, H, D, kRows);
  if (err == cudaSuccess)
    err = encode_bshd<float>(&maps[2], p.kh, B, Sk, H, D, kNarrowKv);
  if (err == cudaSuccess)
    err = encode_bshd<float>(&maps[3], p.kl, B, Sk, H, D, kNarrowKv);
  if (err == cudaSuccess)
    err = encode_bhds<float>(&maps[4], p.vh, B, H, D, skp, D);
  if (err == cudaSuccess)
    err = encode_bhds<float>(&maps[5], p.vl, B, H, D, skp, D);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kRows - 1) / kRows);
  return launch_threads(flash_fwd_tf32_narrow<D>, grid, kThreads,
                        NarrowTf32Smem<D>::kBytes + 1024, stream, maps[0],
                        maps[1], maps[2], maps[3], maps[4], maps[5],
                        (float*)o, (float*)m, (float*)l, H, Sq, Sk, q_off,
                        k_off, causal, scale);
}

}  // namespace
}  // namespace hvdt

// fp32 through 3xTF32 at head dim 16 or 32: the pre-pass
// (hvdt::sm90::tf32_fwd_split), then the narrow build of D. Arguments as
// for hvdt_flash_fwd_tf32 in flash_fwd_stream_sm90.cu: q, k, v contiguous
// fp32 [B, S, H, D] with 16-byte-aligned bases; o fp32 [B, Sq, H, D]; m, l
// fp32 [B, H, Sq]; scratch fp32, 16-byte aligned, 2 B Sq H D + 2 B Sk H D +
// 2 B H D Skp elements (Skp = Sk rounded up to 32); scale multiplies the
// logits (1/sqrt of the head dim before any zero padding of D).
extern "C" int hvdt_flash_fwd_tf32_narrow(const void* q, const void* k,
                                          const void* v, void* o, void* m,
                                          void* l, void* scratch, int B,
                                          int H, int Sq, int Sk, int D,
                                          int q_off, int k_off, int causal,
                                          float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D != 16 && D != 32) return cudaErrorInvalidValue;
  const cudaError_t err =
      hvdt::sm90::tf32_fwd_split(q, k, v, scratch, B, H, Sq, Sk, D, st);
  if (err != cudaSuccess) return err;
  const hvdt::sm90::Tf32Planes p =
      hvdt::sm90::tf32_planes(scratch, B, H, Sq, Sk, D);
  if (D == 16)
    return hvdt::run_narrow<16>(p, o, m, l, B, H, Sq, Sk, q_off, k_off,
                                causal, scale, st);
  return hvdt::run_narrow<32>(p, o, m, l, B, H, Sq, Sk, q_off, k_off, causal,
                              scale, st);
}
