// Flash-attention forward for Hopper's tensor cores (sm_90a), streamed over
// the head dim: bf16 and fp16 at head dims past 512 (the "stream" design),
// and fp32 at every head dim past 32 through 3xTF32 (the "tf32" design).
// One template over the element type serves both.
//
// Replaces the TPU kernel `_kernel` in horovod_tpu/parallel/flash_attention.py
// (launched by `_flash_bhsd`), as flash_fwd_sm90.cu does for 16-bit head
// dims up to 512 and flash_fwd.cu for fp32 at D <= 32. Same function and
// contract: an online softmax whose running max m, normalizer l and output
// accumulator stay in fp32; runtime offsets give the global positions of
// q[0] and k[0]; kv tiles wholly in the future of a q tile are skipped;
// rows that see no key give o = 0, m = -1e30, l = 0; [B, S, H, D] is read
// in place and the stats are written as [B, H, S].
//
// What bounds it on this card. At bf16 D 640 (B 2, S 1024, H 8, causal)
// the function does about 860 operations per byte it must move, and at the
// fp32 main shape (B 4, S 2048, H 16, D 128) 3xTF32 does three products
// where fp32 would do one: both are bound by the tensor cores (989
// TFLOP/s 16-bit, 494.7 TFLOP/s tf32), not by device memory. This design
// reads Q again from L2 for every kv tile and pays S once per part of O;
// which of those holds it back has not been measured (no ncu).
//
// Why streamed. flash_fwd_sm90.cu keeps the CTA's 128-row Q tile resident
// in shared memory; at D 640 that tile alone is 160 KB (256 KB at D 1024),
// and a resident fp32 Q with its tf32 lo part is 128 KB at D 128. Here no
// tile spans the head dim, so shared memory does not grow with D and any
// multiple of the region width runs (the wrapper zero-pads any other D to
// the next one: 64 columns for 16-bit, 32 for fp32).
//
// Design. One CTA per (128-row q tile, batch*head, part of O's head dim on
// grid.z), heaviest causal tiles first. Three warpgroups:
// - a producer, which gives its registers away (setmaxnreg) and whose one
//   elected thread issues every copy as a TMA load: for each kv tile, the
//   D / kCols (Q region, K region) pairs, [128][128 bytes] and
//   [kKv][128 bytes], through a ring of kStagesQK stages, then the tile's
//   V for the CTA's part of O through a ring of kStagesV stages;
// - two consumers, each owning 64 q rows (wgmma's M), which take the
//   registers. Per kv tile: S = sum over regions r of Q_r K_r^T, as m64
//   n64 wgmmas from shared memory, one region's products left in flight
//   while the next region's copy is awaited; the online softmax on the
//   accumulator fragments (row max by two quad shuffles; l summed from
//   the unrounded fp32 p); then O_part += P V_part with P fed as wgmma's
//   register A operand.
// Every part computes the same S, m and l (the parts pay S once each); the
// z = 0 CTA writes m and l.
//
// 16-bit ("stream", T bf16 or fp16): kKv 64, parts of kOut = 256 columns
// (D 640: 256 + 256 + 128, the last part's V regions past D not loaded and
// its columns past D not stored). V is read MN-major, as in
// flash_fwd_sm90.cu. p is rounded to T for the tensor cores, as there.
// Registers: O 128 + S 32 + P 16 a consumer thread. Shared memory: a QK
// stage is 128x64x2 + 64x64x2 = 24,576 B, a V stage 64x256x2 = 32,768 B;
// 6 + 2 stages = 212,992 B (+ 128 B of barriers and the 1 KB alignment
// pad, of 232,448). S costs 2 D per (q, k) pair per part, P V 2 x 256:
// at D 640 the three parts do (3 x 640 + 768) / (2 x 640) = 2.1 times the
// products of the function.
//
// fp32 ("tf32", T float): each fp32 x is split into hi = tf32(x) and
// lo = tf32(x - hi) (tf32_round: 10 mantissa bits, to nearest) and each
// product is taken as hi.hi + hi.lo + lo.hi in tf32 wgmmas (m64nNk8) with
// fp32 accumulators, for S = Q K^T and for O += P V alike: the dropped
// lo.lo term is below 2^-22 of the product, which keeps the fp32
// tolerance (one tf32 product alone misses it more than tenfold:
// tests/test_torch_flash_fwd_tf32_wide.py). tf32 wgmma takes
// both operands K-major (no transpose bit), so O += P V needs V^T (keys
// contiguous). A pre-pass (tf32_split, tf32_split_t) writes,
// once per call, Q and K hi and lo in their [B, S, H, D] layout and V^T hi
// and lo as [B, H, D, Skp] (Skp = Sk rounded up to 32, zero past Sk), into
// scratch the wrapper allocates: it reads q, k, v once and writes six
// tensors of their size (at the main shape 201 MB in, 403 MB out). Its
// kernels are in sm90_common.cuh, shared with the backward.
// Within every 8 keys V^T stores key 8g + 2i at 8g + i
// and key 8g + 2i + 1 at 8g + 4 + i: the accumulator fragment of P holds
// keys 2t, 2t + 1 of each 8 where tf32's register A fragment wants columns
// t, t + 4, so P goes to the tensor cores without a shuffle, and the
// products pair each p with its own key's v. P is split in registers
// after the softmax. The tensor cores add into their accumulator without
// rounding to nearest, so one chain over all of D (or all keys) drifts:
// with one accumulator for S and one for O, an H100 80GB HBM3 at 700 W
// put o at 1.35 of the fp32 bound at the main shape and l at 1.07 at D
// 640 (tools/tf32_chains.py measures both builds). So each region's
// S and each kv tile's P V go to an accumulator of their own, the small
// products first, and are summed into S and O by fp32 adds and fmas.
// kKv 64, parts of kOut = 128 columns. Registers: O 64 + the tile's P V
// 64 + S (then P lo) 32 + P hi 32, and the region's S 32 while S is
// summed. Shared memory: a QK stage holds Q hi, Q lo, K hi, K lo:
// 2 x (128x32x4 + 64x32x4) = 49,152 B; a V stage V^T hi and lo for the
// part, 2 x 128x64x4 = 65,536 B; 2 + 2 stages = 229,376 B (230,464 with
// the barriers and the pad, of 232,448).
#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace hvdt {
namespace {

using namespace sm90;

constexpr int kRows = 128;  // q rows of a CTA
// tf32: each region's S and each kv tile's P V in an accumulator of its
// own, summed by fp32 adds (see the header). tools/tf32_chains.py builds
// this file with false, one chain for S and one for O, to measure why.
constexpr bool kSplitChains = true;

// The stream design's tile shapes for T (see the header).
template <typename T>
struct StreamShape {
  static constexpr bool kTf32 = std::is_same<T, float>::value;
  static constexpr int kKv = 64;                  // rows of a kv tile
  static constexpr int kOut = kTf32 ? 128 : 256;  // columns of O a CTA owns
  static constexpr int kStagesQK = kTf32 ? 2 : 6;
  static constexpr int kStagesV = 2;
  static constexpr int kPlanes = kTf32 ? 2 : 1;   // tf32: hi and lo
  static constexpr int kCols = 128 / (int)sizeof(T);  // columns of a region
};

template <typename T>
struct StreamSmem {
  using Sh = StreamShape<T>;
  static constexpr int kRegionQ = kRows * 128;    // [128][128 B], one plane
  static constexpr int kRegionK = Sh::kKv * 128;  // [kKv][128 B]
  static constexpr int kStageQK = Sh::kPlanes * (kRegionQ + kRegionK);
  // 16-bit: V [kKv][kOut] as kOut / 64 regions of [kKv][64]; tf32: V^T
  // [kOut][kKv] as kKv / 32 regions of [kOut][32], per plane.
  static constexpr int kPlaneV = Sh::kKv * Sh::kOut * (int)sizeof(T);
  static constexpr int kStageV = Sh::kPlanes * kPlaneV;
  static constexpr int kQK = 0;
  static constexpr int kV = kQK + Sh::kStagesQK * kStageQK;
  static constexpr int kBar = kV + Sh::kStagesV * kStageV;
  // qk_full and qk_empty per QK stage, v_full and v_empty per V stage
  static constexpr int kBytes = kBar + 8 * 2 * (Sh::kStagesQK + Sh::kStagesV);
  static_assert(kBytes + 1024 <= 232448,
                "stream forward tiles exceed shared memory");
};

template <typename T>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_stream(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tq_lo,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tk_lo,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tv_lo,
                     T* __restrict__ o, float* __restrict__ m_out,
                     float* __restrict__ l_out, int H, int Sq, int Sk, int D,
                     int q_off, int k_off, int causal, float scale) {
  using Sh = StreamShape<T>;
  using L = StreamSmem<T>;
  constexpr int kKv = Sh::kKv, kOut = Sh::kOut, kCols = Sh::kCols;
  constexpr int kStQK = Sh::kStagesQK, kStV = Sh::kStagesV;
  constexpr bool kTf32 = Sh::kTf32;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* qk_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* qk_empty = qk_full + kStQK;
  uint64_t* v_full = qk_empty + kStQK;
  uint64_t* v_empty = v_full + kStV;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int c0 = blockIdx.z * kOut;  // the first column of O this CTA owns
  const int nreg = D / kCols;
  int nk = (Sk + kKv - 1) / kKv;
  if (causal) {
    // kv tile j is visible while k_off + kKv j <= q_off + q0 + 127.
    const long long reach = (long long)q_off + q0 + kRows - 1 - k_off;
    nk = min(nk, reach < 0 ? 0 : (int)(reach / kKv) + 1);
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStQK; ++s) {
      bar_init(&qk_full[s], 1);
      bar_init(&qk_empty[s], 8);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < kStV; ++s) {
      bar_init(&v_full[s], 1);
      bar_init(&v_empty[s], 8);
    }
    bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer.
    regs_dec<24>();
    if (threadIdx.x == 0) {
      // 16-bit: the V regions of this part that lie within D (the last
      // part's others are neither loaded nor stored).
      const int v_regions = min(kOut, D - c0) / kCols;
      int n = 0;  // (Q, K) region pairs issued so far
      for (int j = 0; j < nk; ++j) {
        for (int r = 0; r < nreg; ++r, ++n) {
          const int st = n % kStQK;
          // Stage st is free once the consumers released load n - kStQK.
          if (n >= kStQK) bar_wait(&qk_empty[st], ((n / kStQK) & 1) ^ 1);
          uint8_t* qt = smem + L::kQK + st * L::kStageQK;
          uint8_t* kt = qt + Sh::kPlanes * L::kRegionQ;
          bar_arrive_tx(&qk_full[st], L::kStageQK);
          tma_load_4d(qt, &tq, &qk_full[st], r * kCols, h, q0, b);
          tma_load_4d(kt, &tk, &qk_full[st], r * kCols, h, j * kKv, b);
          if constexpr (kTf32) {
            tma_load_4d(qt + L::kRegionQ, &tq_lo, &qk_full[st], r * kCols, h,
                        q0, b);
            tma_load_4d(kt + L::kRegionK, &tk_lo, &qk_full[st], r * kCols, h,
                        j * kKv, b);
          }
        }
        const int sv = j % kStV;
        if (j >= kStV) bar_wait(&v_empty[sv], ((j / kStV) & 1) ^ 1);
        uint8_t* vt = smem + L::kV + sv * L::kStageV;
        if constexpr (kTf32) {
          // V^T hi and lo: rows c0 .. c0 + kOut - 1 of D (zeros past D),
          // keys j kKv .. j kKv + kKv - 1 in kKv / 32 regions.
          bar_arrive_tx(&v_full[sv], L::kStageV);
          for (int rr = 0; rr < kKv / kCols; ++rr) {
            tma_load_4d(vt + rr * kOut * 128, &tv, &v_full[sv],
                        j * kKv + rr * kCols, c0, h, b);
            tma_load_4d(vt + L::kPlaneV + rr * kOut * 128, &tv_lo,
                        &v_full[sv], j * kKv + rr * kCols, c0, h, b);
          }
        } else {
          bar_arrive_tx(&v_full[sv], v_regions * L::kRegionK);
          for (int rr = 0; rr < v_regions; ++rr)
            tma_load_4d(vt + rr * L::kRegionK, &tv, &v_full[sv],
                        c0 + rr * kCols, h, j * kKv, b);
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

    float acc[kOut / 2];
#pragma unroll
    for (int i = 0; i < kOut / 2; ++i) acc[i] = 0.f;
    float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};

    int n = 0;  // (Q, K) region pairs consumed so far
    for (int j = 0; j < nk; ++j) {
      const int k0 = j * kKv;

      // S = sum over the regions of Q_r K_r^T.
      float s[kKv / 2];
      for (int r = 0; r < nreg; ++r, ++n) {
        const int st = n % kStQK;
        const uint32_t stage = smem_u32(smem + L::kQK + st * L::kStageQK);
        const uint32_t q_base = stage + c * 64 * 128;
        const uint32_t k_base = stage + Sh::kPlanes * L::kRegionQ;
        bar_wait(&qk_full[st], (n / kStQK) & 1);
        if constexpr (kTf32) {
          // The region's 12 products go to an accumulator of their own,
          // the small ones (lo.hi, hi.lo) first: the tensor cores add
          // into the accumulator without rounding to nearest, so a long
          // chain drifts; the regions are summed by fp32 adds.
          float sr[kKv / 2];
          float(&acc_s)[kKv / 2] = kSplitChains ? sr : s;
          fence_regs(acc_s);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint32_t step = 32 * kk;
            wgmma_tf32_ss<kKv>(
                acc_s, desc_sw128(q_base + L::kRegionQ + step, 16),
                desc_sw128(k_base + step, 16),
                kk > 0 || (!kSplitChains && r > 0));
            wgmma_tf32_ss<kKv>(acc_s, desc_sw128(q_base + step, 16),
                               desc_sw128(k_base + L::kRegionK + step, 16),
                               1);
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_tf32_ss<kKv>(acc_s, desc_sw128(q_base + 32 * kk, 16),
                               desc_sw128(k_base + 32 * kk, 16), 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc_s);
          __syncwarp();
          if (lane == 0) bar_arrive(&qk_empty[st]);
          if constexpr (kSplitChains) {
#pragma unroll
            for (int e = 0; e < kKv / 2; ++e)
              s[e] = r > 0 ? s[e] + sr[e] : sr[e];
          }
        } else {
          fence_regs(s);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<kKv, T>(s, desc_sw128(q_base + 32 * kk, 16),
                             desc_sw128(k_base + 32 * kk, 16),
                             r > 0 || kk > 0);
          wgmma_commit();
          fence_regs(s);
          // One region's products stay in flight; the one before is
          // done, and its stage goes back to the producer.
          wgmma_wait<1>();
          if (r > 0) {
            __syncwarp();
            if (lane == 0) bar_arrive(&qk_empty[(n - 1) % kStQK]);
          }
        }
      }
      if constexpr (!kTf32) {
        wgmma_wait<0>();
        fence_regs(s);
        if (nreg > 0) {
          __syncwarp();
          if (lane == 0) bar_arrive(&qk_empty[(n - 1) % kStQK]);
        }
      }

      // Scale, mask (only tiles that cross the diagonal or the ragged
      // end), row max.
      const bool masked =
          k0 + kKv > Sk || (causal && k_off + k0 + kKv - 1 > first_qpos);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int e = 0; e < kKv / 2; ++e) {
        const int i = (e / 2) % 2;
        float x = s[e] * scale;
        if (masked) {
          const int kc = k0 + 8 * (e / 4) + col + e % 2;
          const bool ok =
              kc < Sk && (!causal || q_off + q0 + row0 + 8 * i >= k_off + kc);
          x = ok ? x : __int_as_float(0xff800000);  // -inf
        }
        s[e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
      float corr[2], mb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_i[i], mx[i]);
        corr[i] = exp2f((m_i[i] - m_new) * kLog2e);
        m_i[i] = m_new;
        mb[i] = m_new * kLog2e;
      }
      // p = exp(x - m): masked entries (-inf) give exactly 0. l keeps this
      // thread's share of the row, from the unrounded p; the quad's shares
      // are added at the end.
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < kKv / 2; ++e) {
        const int i = (e / 2) % 2;
        const float p = exp2f(fmaf(s[e], kLog2e, -mb[i]));
        s[e] = p;
        rs[i] += p;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_i[i] = l_i[i] * corr[i] + rs[i];
      if constexpr (!kTf32) {
#pragma unroll
        for (int e = 0; e < kOut / 2; ++e) acc[e] *= corr[(e / 2) % 2];
      }

      const int sv = j % kStV;
      const uint32_t v_base = smem_u32(smem + L::kV + sv * L::kStageV);
      if constexpr (kTf32) {
        // P split in registers: ph = tf32(p), and s becomes tf32(p - ph).
        uint32_t ph[kKv / 2];
#pragma unroll
        for (int e = 0; e < kKv / 2; ++e) {
          const float hi = tf32_round(s[e]);
          ph[e] = __float_as_uint(hi);
          s[e] = tf32_round(s[e] - hi);
        }
        bar_wait(&v_full[sv], (j / kStV) & 1);
        // The tile's P V goes to an accumulator of its own, small products
        // first (as S above), and O = O corr + P V by fp32 fmas.
        float pv[kOut / 2];
        float(&acc_o)[kOut / 2] = kSplitChains ? pv : acc;
        if constexpr (!kSplitChains) {
#pragma unroll
          for (int e = 0; e < kOut / 2; ++e) acc[e] *= corr[(e / 2) % 2];
        }
        fence_regs(acc_o);
        fence_regs(ph);
        fence_regs(s);
        wgmma_fence();
        // This thread's p of keys 2t, 2t + 1 of each 8 go in as A columns
        // t, t + 4 (V^T stores the keys in that order).
#pragma unroll
        for (int kk = 0; kk < kKv / 8; ++kk) {
          const uint32_t hi[4] = {ph[4 * kk], ph[4 * kk + 2], ph[4 * kk + 1],
                                  ph[4 * kk + 3]};
          const uint32_t lo[4] = {
              __float_as_uint(s[4 * kk]), __float_as_uint(s[4 * kk + 2]),
              __float_as_uint(s[4 * kk + 1]), __float_as_uint(s[4 * kk + 3])};
          const uint32_t off = (kk / 4) * kOut * 128 + (kk % 4) * 32;
          wgmma_tf32_rs<kOut>(acc_o, lo, desc_sw128(v_base + off, 16),
                              kk > 0 || !kSplitChains);
          wgmma_tf32_rs<kOut>(acc_o, hi,
                              desc_sw128(v_base + L::kPlaneV + off, 16), 1);
        }
#pragma unroll
        for (int kk = 0; kk < kKv / 8; ++kk) {
          const uint32_t hi[4] = {ph[4 * kk], ph[4 * kk + 2], ph[4 * kk + 1],
                                  ph[4 * kk + 3]};
          const uint32_t off = (kk / 4) * kOut * 128 + (kk % 4) * 32;
          wgmma_tf32_rs<kOut>(acc_o, hi, desc_sw128(v_base + off, 16), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc_o);
        __syncwarp();
        if (lane == 0) bar_arrive(&v_empty[sv]);
        if constexpr (kSplitChains) {
#pragma unroll
          for (int e = 0; e < kOut / 2; ++e)
            acc[e] = fmaf(acc[e], corr[(e / 2) % 2], pv[e]);
        }
      } else {
        uint32_t pa[kKv / 4];
#pragma unroll
        for (int e = 0; e < kKv / 4; ++e)
          pa[e] = pack2<T>(s[2 * e], s[2 * e + 1]);
        bar_wait(&v_full[sv], (j / kStV) & 1);
        fence_regs(acc);
        fence_regs(pa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKv / 16; ++kk) {
          const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                                 pa[4 * kk + 3]};
          wgmma_rs<kOut, T>(acc, a,
                            desc_sw128(v_base + kk * 16 * 128, L::kRegionK),
                            1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) bar_arrive(&v_empty[sv]);
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 1);
      l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 2);
      const int row = q0 + row0 + 8 * i;
      if (row >= Sq) continue;
      const float inv = 1.f / (l_i[i] == 0.f ? 1.f : l_i[i]);
      T* orow = o + ((size_t)(b * Sq + row) * H + h) * D + c0 + col;
#pragma unroll
      for (int jj = 0; jj < kOut / 8; ++jj)
        if (c0 + col + 8 * jj < D)
          store2<T>(orow + 8 * jj, acc[4 * jj + 2 * i] * inv,
                    acc[4 * jj + 2 * i + 1] * inv);
      if (blockIdx.z == 0 && lane % 4 == 0) {
        m_out[(size_t)bh * Sq + row] = m_i[i];
        l_out[(size_t)bh * Sq + row] = l_i[i];
      }
    }
  }
}

template <typename T>
cudaError_t run(const void* q, const void* q_lo, const void* k,
                const void* k_lo, const void* v, const void* v_lo, void* o,
                void* m, void* l, int B, int H, int Sq, int Sk, int D,
                int q_off, int k_off, int causal, float scale,
                cudaStream_t stream) {
  using Sh = StreamShape<T>;
  CUtensorMap tq, tq_lo, tk, tk_lo, tv, tv_lo;
  cudaError_t err = encode_bshd<T>(&tq, q, B, Sq, H, D, kRows);
  if (err == cudaSuccess) err = encode_bshd<T>(&tk, k, B, Sk, H, D, Sh::kKv);
  if constexpr (Sh::kTf32) {
    const int skp = padded_keys(Sk);
    if (err == cudaSuccess)
      err = encode_bshd<T>(&tq_lo, q_lo, B, Sq, H, D, kRows);
    if (err == cudaSuccess)
      err = encode_bshd<T>(&tk_lo, k_lo, B, Sk, H, D, Sh::kKv);
    if (err == cudaSuccess)
      err = encode_bhds<T>(&tv, v, B, H, D, skp, Sh::kOut);
    if (err == cudaSuccess)
      err = encode_bhds<T>(&tv_lo, v_lo, B, H, D, skp, Sh::kOut);
  } else {
    if (err == cudaSuccess) err = encode_bshd<T>(&tv, v, B, Sk, H, D, Sh::kKv);
    tq_lo = tk_lo = tv_lo = tq;  // unused
  }
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kRows - 1) / kRows,
                  (D + Sh::kOut - 1) / Sh::kOut);
  return launch_ws(flash_fwd_stream<T>, grid, StreamSmem<T>::kBytes + 1024,
                   stream, tq, tq_lo, tk, tk_lo, tv, tv_lo, (T*)o, (float*)m,
                   (float*)l, H, Sq, Sk, D, q_off, k_off, causal, scale);
}

}  // namespace
}  // namespace hvdt

// dtype: 1 bf16, 2 fp16 (hvdt::DType). q, k, v: contiguous [B, S, H, D] of
// that type with 16-byte-aligned bases; D a multiple of 64. o: [B, Sq, H,
// D] of that type; m, l: fp32 [B, H, Sq]. scale multiplies the logits
// (1/sqrt of the head dim before any zero padding of D).
extern "C" int hvdt_flash_fwd_stream(int dtype, const void* q, const void* k,
                                     const void* v, void* o, void* m, void* l,
                                     int B, int H, int Sq, int Sk, int D,
                                     int q_off, int k_off, int causal,
                                     float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 0 || D % 64) return cudaErrorInvalidValue;
  if (dtype == hvdt::kBFloat16)
    return hvdt::run<__nv_bfloat16>(q, nullptr, k, nullptr, v, nullptr, o, m,
                                    l, B, H, Sq, Sk, D, q_off, k_off, causal,
                                    scale, st);
  if (dtype == hvdt::kFloat16)
    return hvdt::run<__half>(q, nullptr, k, nullptr, v, nullptr, o, m, l, B,
                             H, Sq, Sk, D, q_off, k_off, causal, scale, st);
  return cudaErrorInvalidValue;
}

// fp32 through 3xTF32. q, k, v: contiguous fp32 [B, S, H, D] with
// 16-byte-aligned bases; D a multiple of 32. o: fp32 [B, Sq, H, D]; m, l:
// fp32 [B, H, Sq]. scratch: fp32, 16-byte aligned, 2 B Sq H D + 2 B Sk H D
// + 2 B H D Skp elements (Skp = Sk rounded up to 32): the pre-pass's Q hi,
// Q lo, K hi, K lo, V^T hi and V^T lo, in that order.
extern "C" int hvdt_flash_fwd_tf32(const void* q, const void* k,
                                   const void* v, void* o, void* m, void* l,
                                   void* scratch, int B, int H, int Sq,
                                   int Sk, int D, int q_off, int k_off,
                                   int causal, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 0 || D % 32) return cudaErrorInvalidValue;
  const int skp = hvdt::sm90::padded_keys(Sk);
  const size_t nq = (size_t)B * Sq * H * D, nk = (size_t)B * Sk * H * D;
  const size_t nv = (size_t)B * H * D * skp;
  float* qh = (float*)scratch;
  float* ql = qh + nq;
  float* kh = ql + nq;
  float* kl = kh + nk;
  float* vh = kl + nk;
  float* vl = vh + nv;
  const int blocks = 132 * 8;
  hvdt::sm90::tf32_split<<<blocks, 256, 0, st>>>(
      (const float4*)q, (float4*)qh, (float4*)ql, nq / 4);
  hvdt::sm90::tf32_split<<<blocks, 256, 0, st>>>(
      (const float4*)k, (float4*)kh, (float4*)kl, nk / 4);
  hvdt::sm90::tf32_split_t<<<dim3(B * H, D / 32, skp / 32), 256, 0, st>>>(
      (const float*)v, vh, vl, Sk, H, D, skp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return hvdt::run<float>(qh, ql, kh, kl, vh, vl, o, m, l, B, H, Sq, Sk, D,
                          q_off, k_off, causal, scale, st);
}
