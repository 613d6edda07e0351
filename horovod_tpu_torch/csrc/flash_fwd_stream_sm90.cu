// Flash-attention forward for Hopper's tensor cores (sm_90a), streamed over
// the head dim: bf16 and fp16 at head dims past 512 (the "stream" design),
// and fp32 at every head dim past 32 through 3xTF32 (the "tf32" design, in
// two builds: 128-column parts of O up to D 128, 256-column parts past it).
// One template over the element type serves the stream design and the
// first tf32 build; flash_fwd_tf32_wide is the second.
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
// where fp32 would do one: by the function alone both are bound by the
// tensor cores (989 TFLOP/s 16-bit, 494.7 TFLOP/s tf32), not by device
// memory. This design reads Q again from L2 for every kv tile and pays S
// once per part of O. With 128-column parts at every fp32 D the time fit
// parts x regions and nothing else (about 0.0188 ms per region round at B
// 2, S 1024, H 8 on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md): the QK
// stages it streams, about 3 TB/s of Q and K planes, held it back, not the
// tensor cores. So past D 128 the tf32 parts are 256 columns wide (S paid
// half as often) and the tf32 grid is head-major (below).
//
// Why streamed. flash_fwd_sm90.cu keeps the CTA's 128-row Q tile resident
// in shared memory; at D 640 that tile alone is 160 KB (256 KB at D 1024),
// and a resident fp32 Q with its tf32 lo part is 128 KB at D 128. Here no
// tile spans the head dim, so shared memory does not grow with D and any
// multiple of the region width runs (the wrapper zero-pads any other D to
// the next one: 64 columns for 16-bit, 32 for fp32).
//
// Design. One CTA per (128-row q tile, batch*head, part of O's head dim),
// heaviest causal tiles first. Three warpgroups:
// - a producer, which gives its registers away (setmaxnreg) and whose one
//   elected thread issues every copy as a TMA load: for each kv tile, the
//   D / kCols (Q region, K region) pairs, [128][128 bytes] and
//   [kKv][128 bytes], through a ring of kStagesQK stages, then the tile's
//   V for the CTA's part of O;
// - two consumers, each owning 64 q rows (wgmma's M), which take the
//   registers. Per kv tile: S = sum over regions r of Q_r K_r^T, as m64
//   n64 wgmmas from shared memory; the online softmax on the accumulator
//   fragments (row max by two quad shuffles; l summed from the unrounded
//   fp32 p); then O_part += P V_part.
// Every part computes the same S, m and l (the parts pay S once each); the
// part-0 CTA writes m and l.
//
// 16-bit ("stream", T bf16 or fp16): grid (b h, q tiles, parts). kKv 64,
// parts of kOut = 256 columns (D 640: 256 + 256 + 128, the last part's V
// regions past D not loaded and its columns past D not stored). One
// region's products stay in flight while the next region's copy is
// awaited. V is read MN-major, as in flash_fwd_sm90.cu; p is rounded to T
// and fed as wgmma's register A operand. Registers: O 128 + S 32 + P 16 a
// consumer thread. Shared memory: a QK stage is 128x64x2 + 64x64x2 =
// 24,576 B, a V stage 64x256x2 = 32,768 B; 6 + 2 stages = 212,992 B (+ 128
// B of barriers and the 1 KB alignment pad, of 232,448). S costs 2 D per
// (q, k) pair per part, P V 2 x 256: at D 640 the three parts do (3 x 640
// + 768) / (2 x 640) = 2.1 times the products of the function.
//
// fp32 ("tf32", T float): each fp32 x is split into hi = tf32(x) and
// lo = tf32(x - hi) (tf32_round: 10 mantissa bits, to nearest) and each
// product is taken as hi.hi + hi.lo + lo.hi in tf32 wgmmas (m64nNk8) with
// fp32 accumulators, for S = Q K^T and for O += P V alike: the dropped
// lo.lo term is below 2^-22 of the product, which keeps the fp32
// tolerance (one tf32 product alone misses it more than tenfold:
// tests/test_torch_flash_fwd_tf32_wide.py). tf32 wgmma takes
// both operands K-major (no transpose bit), so O += P V needs V^T (keys
// contiguous). A pre-pass (tf32_split, tf32_split_t; its own C entry,
// hvdt_flash_fwd_tf32_split, which hvdt_flash_fwd_tf32 runs first) writes,
// once per call, Q and K hi and lo in their [B, S, H, D] layout and V^T hi
// and lo as [B, H, D, Skp] (Skp = Sk rounded up to 32, zero past Sk), into
// scratch the wrapper allocates: it reads q, k, v once and writes six
// tensors of their size (at the main shape 201 MB in, 403 MB out). Its
// kernels are in sm90_common.cuh, shared with the backward.
// Within every 8 keys V^T stores key 8g + 2i at 8g + i
// and key 8g + 2i + 1 at 8g + 4 + i: the accumulator fragment of P holds
// keys 2t, 2t + 1 of each 8 where tf32's A fragment wants columns
// t, t + 4, so P goes to the tensor cores without a shuffle, and the
// products pair each p with its own key's v. The tensor cores add into
// their accumulator without rounding to nearest, so one chain over all of
// D (or all keys) drifts: with one accumulator for S and one for O, an
// H100 80GB HBM3 at 700 W put o at 1.35 of the fp32 bound at the main
// shape and l at 1.07 at D 640 (tools/tf32_chains.py measures both
// builds). So each region's S and each kv tile's P V go to an accumulator
// of their own, the small products first, and are summed into S and O by
// fp32 adds and fmas. kKv 64 in both builds.
//
// Both tf32 builds run their grid head-major (kHeadMajor), as the tf32
// backward does: grid (q tiles x parts, b h), blockIdx.x over one head's
// CTAs, q tiles heaviest first, each q tile's parts side by side. A wave of
// 132 CTAs then streams the Q and K planes of a few heads, which L2 keeps
// (fp32 D 640 at B 2, S 1024, H 8: 24 CTAs a head, about 5 heads a wave;
// with b h fastest every head's planes at once, 168 MB against a 50 MB
// L2). tools/fwd_tf32_variants.py builds both with b h fastest
// (PERF.md): slower past D 256 and at the main shape.
//
// The 128-column build (flash_fwd_stream<float>, fp32 D 33-128): parts of
// kOut = 128 columns; P split in registers after the softmax and fed as
// wgmma's register A operand. Registers: O 64 + the tile's P V 64 + S
// (then P lo) 32 + P hi 32, and the region's S 32 while S is summed.
// Shared memory: a QK stage holds Q hi, Q lo, K hi, K lo: 2 x (128x32x4 +
// 64x32x4) = 49,152 B; a V stage V^T hi and lo for the part, 2 x 128x64x4
// = 65,536 B; 2 + 2 stages = 229,376 B (230,464 with the barriers and the
// pad, of 232,448).
//
// The wide build (flash_fwd_tf32_wide, fp32 past D kWideAbove = 128):
// parts of 256 columns (D 640: 256 + 256 + 128, the last part's columns
// past D neither loaded, multiplied nor stored), so S is paid once per
// 256 columns of O: region rounds per pair of tiles fall from 100 to 60
// at D 640 and from 16 to 8 at D 256 (2.0 and 1.0 times the function's
// products, from 3.0 and 1.5). A consumer holds O for its 64 rows and 256
// columns, 128 registers. In the S loop: O 128, S 32 and a region's
// products 32 (192). P V goes in pieces of kPvCols = 64 columns, each
// into a fresh 32-register accumulator folded into its columns of O by
// fmaf(O, corr, pv): 128 + 32 = 160. P cannot stay in registers (O 128 +
// a piece's accumulator + P hi and lo 64 leaves too little of the 240
// setmaxnreg gives): after the softmax each consumer splits its P into
// shared memory, [64 rows][64 keys] hi and lo, each plane two K-major
// regions of [64][32] in the 128-byte swizzle, a thread's keys 2t, 2t + 1
// of every 8 at positions t, t + 4 (V^T's order, so the pre-pass is the
// same), and the P V products read it as wgmma's shared-memory A operand
// (m64n64k8). Shared memory: 2 QK stages, 98,304 B; P hi and lo of both
// consumers, 2 x 2 x 64x64x4 = 65,536 B; a ring of two V^T stages, each hi
// and lo of 64 columns x 64 keys, 2 x 2 x 64x64x4 = 65,536 B: 229,376 B
// (230,464 with 64 B of barriers and the 1 KB pad, of 232,448). The
// producer issues a tile's first two V^T pieces right after its QK stages
// and the other two, each as soon as a piece is consumed, after the next
// tile's first QK stages. tools/fwd_tf32_variants.py builds the
// alternatives (times in PERF.md): 128-column pieces through one V^T stage
// (64 + 128 = 192 registers at P V) make ptxas spill O in the kv loop and
// run slower; two region accumulators taken in turn in the S loop (224)
// make it spill and serialize the wgmmas, far slower.
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
// tf32: the grid's order, one head's CTAs side by side (see the header).
// tools/fwd_tf32_variants.py builds this file with false (b h fastest).
constexpr bool kHeadMajor = true;
// tf32: fp32 head dims past this take the wide build (256-column parts, P
// through shared memory), the others the 128-column build.
// tools/fwd_tf32_variants.py builds this file with no wide build at all.
constexpr int kWideAbove = 128;
// The wide build's S loop: two region accumulators taken in turn (see the
// header). tools/fwd_tf32_variants.py builds this file with true.
constexpr bool kPingPong = false;
// The wide build's columns of O per P V product: 64, through a ring of two
// V^T stages, or 128, through one (see the header).
// tools/fwd_tf32_variants.py builds this file with 128.
constexpr int kPvCols = 64;

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

// The wide tf32 build's tiles and shared memory (see the header).
struct Wide {
  static constexpr int kKv = 64;      // keys of a kv tile
  static constexpr int kOut = 256;    // columns of O a CTA owns
  static constexpr int kPv = kPvCols;  // columns of O one P V product makes
  static constexpr int kPieces = kOut / kPv;  // P V products a kv tile
  static constexpr int kCols = 32;    // fp32 columns of a 128-byte region
  static constexpr int kStagesQK = 2;
  static constexpr int kStagesV = 128 / kPv;  // 64 KB of V^T stages
  static constexpr int kRegionQ = kRows * 128;  // [128][32] fp32, one plane
  static constexpr int kRegionK = kKv * 128;    // [64][32]
  static constexpr int kStageQK = 2 * (kRegionQ + kRegionK);  // hi and lo
  static constexpr int kRegionP = 64 * 128;     // [64 rows][32 keys]
  static constexpr int kPlaneP = 64 * kKv * 4;  // a consumer's P, hi or lo
  static constexpr int kRegionV = kPv * 128;    // [kPv columns][32 keys]
  static constexpr int kPlaneV = kPv * kKv * 4;  // a V^T piece, hi or lo
  static constexpr int kStageV = 2 * kPlaneV;
  static constexpr int kQK = 0;
  static constexpr int kP = kQK + kStagesQK * kStageQK;
  static constexpr int kV = kP + 2 * 2 * kPlaneP;
  static constexpr int kBar = kV + kStagesV * kStageV;
  // full and empty per QK stage and per V stage
  static constexpr int kBytes = kBar + 8 * 2 * (kStagesQK + kStagesV);
  static_assert(kPv == 64 || kPv == 128, "P V products of 64 or 128 columns");
  static_assert(kBytes + 1024 <= 232448,
                "wide tf32 forward tiles exceed shared memory");
  static_assert(kP % 1024 == 0 && kV % 1024 == 0 && kPlaneP % 1024 == 0 &&
                    kRegionV % 1024 == 0,
                "swizzled regions start on 1024-byte boundaries");
  static_assert(kKv == StreamShape<float>::kKv,
                "both tf32 builds read K through one tensor map's boxes");
};

// A CTA's (b h, q tile counted from the last, part of O) on a grid of
// grid_of<kHM>: head-major, (q tiles x parts, b h), or b h fastest, (b h,
// q tiles, parts).
struct CtaIdx {
  int bh, q_tile, part;
};
template <bool kHM>
__device__ __forceinline__ CtaIdx cta_index(int parts) {
  if constexpr (kHM)
    return {(int)blockIdx.y, (int)blockIdx.x / parts,
            (int)blockIdx.x % parts};
  return {(int)blockIdx.x, (int)blockIdx.y, (int)blockIdx.z};
}
template <bool kHM>
inline dim3 grid_of(int bh, int q_tiles, int parts) {
  return kHM ? dim3(q_tiles * parts, bh) : dim3(bh, q_tiles, parts);
}

// The kv tiles of kKv keys that q rows q0 .. q0 + kRows - 1 see: tile j is
// visible while k_off + kKv j <= q_off + q0 + kRows - 1.
template <int kKv>
__device__ __forceinline__ int visible_tiles(int Sk, int q0, int q_off,
                                             int k_off, int causal) {
  int nk = (Sk + kKv - 1) / kKv;
  if (causal) {
    const long long reach = (long long)q_off + q0 + kRows - 1 - k_off;
    nk = min(nk, reach < 0 ? 0 : (int)(reach / kKv) + 1);
  }
  return nk;
}

// One region's S in 3xTF32: 12 m64n(kKv)k8 wgmmas from shared memory into
// acc, lo.hi and hi.lo first, then hi.hi (the small products first: see
// the header), committed as one group. `accumulate`: add into acc (else
// its first product overwrites it).
template <int kKv>
__device__ __forceinline__ void region_scores(float (&acc)[kKv / 2],
                                              uint32_t q, uint32_t q_lo,
                                              uint32_t k, uint32_t k_lo,
                                              bool accumulate) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t step = 32 * kk;
    wgmma_tf32_ss<kKv>(acc, desc_sw128(q_lo + step, 16),
                       desc_sw128(k + step, 16), kk > 0 || accumulate);
    wgmma_tf32_ss<kKv>(acc, desc_sw128(q + step, 16),
                       desc_sw128(k_lo + step, 16), 1);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_tf32_ss<kKv>(acc, desc_sw128(q + 32 * kk, 16),
                       desc_sw128(k + 32 * kk, 16), 1);
  wgmma_commit();
}

// The online softmax of one kv tile (keys k0 ..) on a consumer thread's
// accumulator fragment s of S (rows qpos, qpos + 8 in global positions):
// scale, mask (only where `masked`: tiles that cross the diagonal or the
// ragged end), the row max by two quad shuffles, p = exp(x - m) in place
// of s (masked entries give exactly 0), l from the unrounded p (this
// thread's share of the row; the quad's shares are added at the end), and
// corr, the factor of the O accumulated so far.
template <int kKv>
__device__ __forceinline__ void online_softmax(
    float (&s)[kKv / 2], float (&m_i)[2], float (&l_i)[2], float (&corr)[2],
    bool masked, int k0, int col, int qpos, int Sk, int k_off, int causal,
    float scale) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int e = 0; e < kKv / 2; ++e) {
    const int i = (e / 2) % 2;
    float x = s[e] * scale;
    if (masked) {
      const int kc = k0 + 8 * (e / 4) + col + e % 2;
      const bool ok = kc < Sk && (!causal || qpos + 8 * i >= k_off + kc);
      x = ok ? x : __int_as_float(0xff800000);  // -inf
    }
    s[e] = x;
    mx[i] = fmaxf(mx[i], x);
  }
  float mb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m_i[i], mx[i]);
    corr[i] = exp2f((m_i[i] - m_new) * kLog2e);
    m_i[i] = m_new;
    mb[i] = m_new * kLog2e;
  }
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
}

// Sums l over the quad that holds a row, and stores this thread's part of
// rows q0 + row0 and q0 + row0 + 8 of O (below Sq): acc holds columns
// c0 + col + 8 jj and the one after, divided by l (l = 0: a row that saw
// no key, o = 0), those below D. Returns nothing; m and l are the
// caller's to store.
template <typename T, int N>
__device__ __forceinline__ void store_o(T* __restrict__ o, const float (&acc)[N],
                                        const float (&inv)[2], int b, int h,
                                        int H, int Sq, int D, int q0,
                                        int row0, int c0, int col) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + row0 + 8 * i;
    if (row >= Sq) continue;
    T* orow = o + ((size_t)(b * Sq + row) * H + h) * D + c0 + col;
#pragma unroll
    for (int jj = 0; jj < N / 4; ++jj)
      if (c0 + col + 8 * jj < D)
        store2<T>(orow + 8 * jj, acc[4 * jj + 2 * i] * inv[i],
                  acc[4 * jj + 2 * i + 1] * inv[i]);
  }
}

// l summed over the quad, and 1 / l (1 where l is 0).
__device__ __forceinline__ void finish_rows(float (&l_i)[2],
                                            float (&inv)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 1);
    l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 2);
    inv[i] = 1.f / (l_i[i] == 0.f ? 1.f : l_i[i]);
  }
}

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

  const CtaIdx at =
      cta_index<kTf32 && kHeadMajor>((D + kOut - 1) / kOut);
  const int bh = at.bh;
  const int b = bh / H, h = bh % H;
  const int q0 = ((Sq + kRows - 1) / kRows - 1 - at.q_tile) * kRows;
  const int c0 = at.part * kOut;  // the first column of O this CTA owns
  const int nreg = D / kCols;
  const int nk = visible_tiles<kKv>(Sk, q0, q_off, k_off, causal);

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
          // The region's 12 products go to an accumulator of their own;
          // the regions are summed by fp32 adds.
          float sr[kKv / 2];
          float(&acc_s)[kKv / 2] = kSplitChains ? sr : s;
          region_scores<kKv>(acc_s, q_base, q_base + L::kRegionQ, k_base,
                             k_base + L::kRegionK, !kSplitChains && r > 0);
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

      const bool masked =
          k0 + kKv > Sk || (causal && k_off + k0 + kKv - 1 > first_qpos);
      float corr[2];
      online_softmax<kKv>(s, m_i, l_i, corr, masked, k0, col,
                          q_off + q0 + row0, Sk, k_off, causal, scale);
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

    float inv[2];
    finish_rows(l_i, inv);
    store_o<T>(o, acc, inv, b, h, H, Sq, D, q0, row0, c0, col);
    if (at.part == 0 && lane % 4 == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = q0 + row0 + 8 * i;
        if (row >= Sq) continue;
        m_out[(size_t)bh * Sq + row] = m_i[i];
        l_out[(size_t)bh * Sq + row] = l_i[i];
      }
    }
  }
}

// The wide build's P: this consumer thread's p (rows r16, r16 + 8 of the
// consumer's 64; keys 2 t4, 2 t4 + 1 of every 8) split into hi = tf32(p)
// and lo = tf32(p - hi), written to the consumer's shared planes: each
// [64 rows][64 key positions] as two K-major regions of [64][32] in the
// 128-byte swizzle (element (r, x) of a region at byte r * 128 + ((x / 4)
// ^ (r % 8)) * 16 + (x % 4) * 4), keys 8g + 2 t4 and 8g + 2 t4 + 1 at
// positions 8g + t4 and 8g + 4 + t4, V^T's order. A warp's 32 stores of
// one e fall on 32 distinct banks.
__device__ __forceinline__ void store_p(const float (&s)[Wide::kKv / 2],
                                        uint32_t hi, uint32_t lo, int r16,
                                        int t4) {
#pragma unroll
  for (int e = 0; e < Wide::kKv / 2; ++e) {
    const int g = e / 4, r = r16 + 8 * ((e / 2) % 2);
    const int chunk = 2 * (g % 4) + e % 2;  // the 16-byte chunk, unswizzled
    const uint32_t byte = (g / 4) * Wide::kRegionP + r * 128 +
                          ((chunk ^ (r % 8)) << 4) + t4 * 4;
    const float h = tf32_round(s[e]);
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(hi + byte), "f"(h)
                 : "memory");
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(lo + byte),
                 "f"(tf32_round(s[e] - h))
                 : "memory");
  }
}

// x, which the compiler may not see through: the kv loop's shared
// addresses of P and V^T repeat, and without this it computes the
// descriptors built on them once, ahead of the loop, in registers.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// out (+)= P V for kPv columns of O in 3xTF32, both factors from shared
// memory: P (hi at p, lo at p_lo; two regions of [64][32]) as the A
// operand, V^T (v, v_lo; two regions of [kPv][32]) as B; lo.hi and hi.lo
// first, then hi.hi, one k8 step per 8 key positions; waits for the
// products. `accumulate`: add into out (else overwrite it).
__device__ __forceinline__ void pv_piece(float (&out)[Wide::kPv / 2],
                                         uint32_t p, uint32_t p_lo,
                                         uint32_t v, uint32_t v_lo,
                                         bool accumulate) {
  p = opaque(p);
  p_lo = opaque(p_lo);
  v = opaque(v);
  v_lo = opaque(v_lo);
  fence_regs(out);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Wide::kKv / 8; ++kk) {
    const uint32_t op = (kk / 4) * Wide::kRegionP + (kk % 4) * 32;
    const uint32_t ov = (kk / 4) * Wide::kRegionV + (kk % 4) * 32;
    wgmma_tf32_ss<Wide::kPv>(out, desc_sw128(p_lo + op, 16),
                             desc_sw128(v + ov, 16), kk > 0 || accumulate);
    wgmma_tf32_ss<Wide::kPv>(out, desc_sw128(p + op, 16),
                             desc_sw128(v_lo + ov, 16), 1);
  }
#pragma unroll
  for (int kk = 0; kk < Wide::kKv / 8; ++kk) {
    const uint32_t op = (kk / 4) * Wide::kRegionP + (kk % 4) * 32;
    const uint32_t ov = (kk / 4) * Wide::kRegionV + (kk % 4) * 32;
    wgmma_tf32_ss<Wide::kPv>(out, desc_sw128(p + op, 16),
                             desc_sw128(v + ov, 16), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(out);
}

// The wide build's region r of a kv tile: waits for its QK stage (the
// n-th consumed) and issues its products into acc.
__device__ __forceinline__ void wide_region(float (&acc)[Wide::kKv / 2],
                                            uint8_t* smem, uint64_t* qk_full,
                                            int n, int c) {
  const int st = n % Wide::kStagesQK;
  const uint32_t stage = smem_u32(smem + Wide::kQK + st * Wide::kStageQK);
  const uint32_t q = stage + c * 64 * 128, k = stage + 2 * Wide::kRegionQ;
  bar_wait(&qk_full[st], (n / Wide::kStagesQK) & 1);
  region_scores<Wide::kKv>(acc, q, q + Wide::kRegionQ, k,
                           k + Wide::kRegionK, false);
}

// Hands the n-th consumed QK stage back to the producer and adds the
// region's products (part) into S (the first region's are S).
__device__ __forceinline__ void wide_region_done(
    float (&s)[Wide::kKv / 2], float (&part)[Wide::kKv / 2],
    uint64_t* qk_empty, int n, int r, int lane) {
  fence_regs(part);
  __syncwarp();
  if (lane == 0) bar_arrive(&qk_empty[n % Wide::kStagesQK]);
#pragma unroll
  for (int e = 0; e < Wide::kKv / 2; ++e)
    s[e] = r > 0 ? s[e] + part[e] : part[e];
}

// The wide build's producer: the u-th V^T piece, hi and lo of kv tile j
// for rows `row` .. row + kPv - 1 of D (zeros past D), keys j kKv .. j kKv
// + kKv - 1 in kKv / 32 regions, into V stage u % kStagesV, which is free
// once the consumers released piece u - kStagesV.
__device__ __forceinline__ void load_v_piece(uint8_t* smem, uint64_t* v_full,
                                             uint64_t* v_empty,
                                             const CUtensorMap* tv,
                                             const CUtensorMap* tv_lo, int u,
                                             int j, int row, int h, int b) {
  constexpr int kSt = Wide::kStagesV;
  const int sv = u % kSt;
  if (u >= kSt) bar_wait(&v_empty[sv], ((u / kSt) & 1) ^ 1);
  uint8_t* vt = smem + Wide::kV + sv * Wide::kStageV;
  bar_arrive_tx(&v_full[sv], Wide::kStageV);
#pragma unroll
  for (int rr = 0; rr < Wide::kKv / Wide::kCols; ++rr) {
    const int key = j * Wide::kKv + rr * Wide::kCols;
    tma_load_4d(vt + rr * Wide::kRegionV, tv, &v_full[sv], key, row, h, b);
    tma_load_4d(vt + Wide::kPlaneV + rr * Wide::kRegionV, tv_lo, &v_full[sv],
                key, row, h, b);
  }
}

__global__ void __launch_bounds__(384, 1)
    flash_fwd_tf32_wide(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tq_lo,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tk_lo,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tv_lo,
                        float* __restrict__ o, float* __restrict__ m_out,
                        float* __restrict__ l_out, int H, int Sq, int Sk,
                        int D, int q_off, int k_off, int causal,
                        float scale) {
  using W = Wide;
  constexpr int kKv = W::kKv, kPv = W::kPv, kStQK = W::kStagesQK;
  constexpr int kStV = W::kStagesV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* qk_full = reinterpret_cast<uint64_t*>(smem + W::kBar);
  uint64_t* qk_empty = qk_full + kStQK;
  uint64_t* v_full = qk_empty + kStQK;
  uint64_t* v_empty = v_full + kStV;

  const CtaIdx at = cta_index<kHeadMajor>((D + W::kOut - 1) / W::kOut);
  const int bh = at.bh;
  const int b = bh / H, h = bh % H;
  const int q0 = ((Sq + kRows - 1) / kRows - 1 - at.q_tile) * kRows;
  const int c0 = at.part * W::kOut;  // the first column of O this CTA owns
  // The part's P V pieces that start below D (the last part's others are
  // neither loaded, multiplied nor stored).
  const int pieces = (min(W::kOut, D - c0) + kPv - 1) / kPv;
  const int nreg = D / W::kCols;
  const int nk = visible_tiles<kKv>(Sk, q0, q_off, k_off, causal);

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
    // Producer: per kv tile j, its D / 32 QK stages, then its first kStV
    // V^T pieces (their stages were released before its S loop); the rest
    // of tile j's pieces, each of which waits for a piece of tile j to be
    // consumed, go after the first kStQK QK stages of tile j + 1 (which
    // its S loop needs first), or at the end.
    regs_dec<24>();
    if (threadIdx.x == 0) {
      const int early = min(pieces, kStV);
      int n = 0, u = 0;  // QK stages and V^T pieces issued so far
      for (int j = 0; j < nk; ++j) {
        for (int r = 0; r < nreg; ++r, ++n) {
          const int st = n % kStQK;
          if (n >= kStQK) bar_wait(&qk_empty[st], ((n / kStQK) & 1) ^ 1);
          uint8_t* qt = smem + W::kQK + st * W::kStageQK;
          uint8_t* kt = qt + 2 * W::kRegionQ;
          bar_arrive_tx(&qk_full[st], W::kStageQK);
          tma_load_4d(qt, &tq, &qk_full[st], r * W::kCols, h, q0, b);
          tma_load_4d(qt + W::kRegionQ, &tq_lo, &qk_full[st], r * W::kCols,
                      h, q0, b);
          tma_load_4d(kt, &tk, &qk_full[st], r * W::kCols, h, j * kKv, b);
          tma_load_4d(kt + W::kRegionK, &tk_lo, &qk_full[st], r * W::kCols,
                      h, j * kKv, b);
          if (j > 0 && r == min(kStQK, nreg) - 1)
            for (int pc = early; pc < pieces; ++pc)
              load_v_piece(smem, v_full, v_empty, &tv, &tv_lo, u++, j - 1,
                           c0 + kPv * pc, h, b);
        }
        for (int pc = 0; pc < early; ++pc)
          load_v_piece(smem, v_full, v_empty, &tv, &tv_lo, u++, j,
                       c0 + kPv * pc, h, b);
      }
      if (nk > 0)
        for (int pc = early; pc < pieces; ++pc)
          load_v_piece(smem, v_full, v_empty, &tv, &tv_lo, u++, nk - 1,
                       c0 + kPv * pc, h, b);
    }
  } else {
    // Consumers: warpgroup c owns rows 64c .. 64c + 63 of the q tile.
    regs_inc<240>();
    const int c = wg - 1;
    const int t = threadIdx.x % 128, lane = t % 32;
    const int r16 = 16 * (t / 32) + lane / 4;  // its rows of the 64: +8
    const int row0 = 64 * c + r16;
    const int col = 2 * (lane % 4);
    const int first_qpos = q_off + q0 + 64 * c;
    const uint32_t p_hi = smem_u32(smem + W::kP + 2 * c * W::kPlaneP);
    const uint32_t p_lo = p_hi + W::kPlaneP;
    const uint32_t v_hi = smem_u32(smem + W::kV), v_lo = v_hi + W::kPlaneV;

    float acc[W::kPieces][kPv / 2];  // O, the part's pieces
#pragma unroll
    for (int pc = 0; pc < W::kPieces; ++pc)
#pragma unroll
      for (int e = 0; e < kPv / 2; ++e) acc[pc][e] = 0.f;
    float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};

    int n = 0;  // QK stages consumed so far
    for (int j = 0; j < nk; ++j) {
      const int k0 = j * kKv;

      // S = sum over the regions of Q_r K_r^T, each region's products in
      // an accumulator of their own, summed in region order.
      float s[kKv / 2];
      if constexpr (!kSplitChains) {
        for (int r = 0; r < nreg; ++r, ++n) {
          const int st = n % kStQK;
          const uint32_t stage = smem_u32(smem + W::kQK + st * W::kStageQK);
          const uint32_t q = stage + c * 64 * 128, k = stage + 2 * W::kRegionQ;
          bar_wait(&qk_full[st], (n / kStQK) & 1);
          region_scores<kKv>(s, q, q + W::kRegionQ, k, k + W::kRegionK,
                             r > 0);
          wgmma_wait<0>();
          fence_regs(s);
          __syncwarp();
          if (lane == 0) bar_arrive(&qk_empty[st]);
        }
      } else if constexpr (kPingPong) {
        // Regions into sa and sb in turn: region r's products are issued
        // before region r - 1 is summed.
        float sa[kKv / 2], sb[kKv / 2];
        for (int r = 0; r < nreg; r += 2) {
          wide_region(sa, smem, qk_full, n + r, c);
          if (r > 0) {
            wgmma_wait<1>();
            wide_region_done(s, sb, qk_empty, n + r - 1, r - 1, lane);
          }
          if (r + 1 < nreg) {
            wide_region(sb, smem, qk_full, n + r + 1, c);
            wgmma_wait<1>();
          } else {
            wgmma_wait<0>();
          }
          wide_region_done(s, sa, qk_empty, n + r, r, lane);
        }
        if (nreg % 2 == 0) {
          wgmma_wait<0>();
          wide_region_done(s, sb, qk_empty, n + nreg - 1, nreg - 1, lane);
        }
        n += nreg;
      } else {
        float sr[kKv / 2];
        for (int r = 0; r < nreg; ++r, ++n) {
          wide_region(sr, smem, qk_full, n, c);
          wgmma_wait<0>();
          wide_region_done(s, sr, qk_empty, n, r, lane);
        }
      }

      const bool masked =
          k0 + kKv > Sk || (causal && k_off + k0 + kKv - 1 > first_qpos);
      float corr[2];
      online_softmax<kKv>(s, m_i, l_i, corr, masked, k0, col,
                          q_off + q0 + row0, Sk, k_off, causal, scale);

      // P into this warpgroup's shared planes: the first barrier waits for
      // the warpgroup's last products that read them, the second hands the
      // stores (made visible to wgmma by the proxy fence) to the products.
      named_bar_sync(1 + c, 128);
      store_p(s, p_hi, p_lo, r16, lane % 4);
      fence_proxy_async();
      named_bar_sync(1 + c, 128);

      // O = O corr + P V, kPv columns at a time, each piece's P V into an
      // accumulator of its own.
#pragma unroll
      for (int pc = 0; pc < W::kPieces; ++pc) {
        if (pc == pieces) break;
        const int u = j * pieces + pc, sv = u % kStV;
        bar_wait(&v_full[sv], (u / kStV) & 1);
        float pv[kPv / 2];
        float(&acc_o)[kPv / 2] = kSplitChains ? pv : acc[pc];
        if constexpr (!kSplitChains) {
#pragma unroll
          for (int e = 0; e < kPv / 2; ++e) acc[pc][e] *= corr[(e / 2) % 2];
        }
        const uint32_t stage = sv * W::kStageV;
        pv_piece(acc_o, p_hi, p_lo, v_hi + stage, v_lo + stage,
                 !kSplitChains);
        __syncwarp();
        if (lane == 0) bar_arrive(&v_empty[sv]);
        if constexpr (kSplitChains) {
#pragma unroll
          for (int e = 0; e < kPv / 2; ++e)
            acc[pc][e] = fmaf(acc[pc][e], corr[(e / 2) % 2], pv[e]);
        }
      }
    }

    float inv[2];
    finish_rows(l_i, inv);
#pragma unroll
    for (int pc = 0; pc < W::kPieces; ++pc)
      if (pc < pieces)
        store_o<float>(o, acc[pc], inv, b, h, H, Sq, D, q0, row0,
                       c0 + kPv * pc, col);
    if (at.part == 0 && lane % 4 == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = q0 + row0 + 8 * i;
        if (row >= Sq) continue;
        m_out[(size_t)bh * Sq + row] = m_i[i];
        l_out[(size_t)bh * Sq + row] = l_i[i];
      }
    }
  }
}

// The tensor maps of the tf32 builds over the pre-pass's planes: Q and K
// hi and lo by 128-byte regions of kRows and kKv rows, V^T hi and lo by
// regions of `v_rows` rows of D (the columns of O one product makes).
inline cudaError_t tf32_maps(CUtensorMap (&m)[6], const void* q,
                             const void* q_lo, const void* k,
                             const void* k_lo, const void* v,
                             const void* v_lo, int B, int H, int Sq, int Sk,
                             int D, int v_rows) {
  const int skp = padded_keys(Sk);
  cudaError_t err = encode_bshd<float>(&m[0], q, B, Sq, H, D, kRows);
  if (err == cudaSuccess)
    err = encode_bshd<float>(&m[1], q_lo, B, Sq, H, D, kRows);
  if (err == cudaSuccess)
    err = encode_bshd<float>(&m[2], k, B, Sk, H, D, Wide::kKv);
  if (err == cudaSuccess)
    err = encode_bshd<float>(&m[3], k_lo, B, Sk, H, D, Wide::kKv);
  if (err == cudaSuccess)
    err = encode_bhds<float>(&m[4], v, B, H, D, skp, v_rows);
  if (err == cudaSuccess)
    err = encode_bhds<float>(&m[5], v_lo, B, H, D, skp, v_rows);
  return err;
}

template <typename T>
cudaError_t run(const void* q, const void* q_lo, const void* k,
                const void* k_lo, const void* v, const void* v_lo, void* o,
                void* m, void* l, int B, int H, int Sq, int Sk, int D,
                int q_off, int k_off, int causal, float scale,
                cudaStream_t stream) {
  using Sh = StreamShape<T>;
  CUtensorMap maps[6];
  cudaError_t err;
  if constexpr (Sh::kTf32) {
    err = tf32_maps(maps, q, q_lo, k, k_lo, v, v_lo, B, H, Sq, Sk, D,
                    Sh::kOut);
  } else {
    err = encode_bshd<T>(&maps[0], q, B, Sq, H, D, kRows);
    if (err == cudaSuccess)
      err = encode_bshd<T>(&maps[2], k, B, Sk, H, D, Sh::kKv);
    if (err == cudaSuccess)
      err = encode_bshd<T>(&maps[4], v, B, Sk, H, D, Sh::kKv);
    maps[1] = maps[3] = maps[5] = maps[0];  // unused
  }
  if (err != cudaSuccess) return err;
  const dim3 grid = grid_of<Sh::kTf32 && kHeadMajor>(
      B * H, (Sq + kRows - 1) / kRows, (D + Sh::kOut - 1) / Sh::kOut);
  return launch_ws(flash_fwd_stream<T>, grid, StreamSmem<T>::kBytes + 1024,
                   stream, maps[0], maps[1], maps[2], maps[3], maps[4],
                   maps[5], (T*)o, (float*)m, (float*)l, H, Sq, Sk, D, q_off,
                   k_off, causal, scale);
}

cudaError_t run_wide(const void* q, const void* q_lo, const void* k,
                     const void* k_lo, const void* v, const void* v_lo,
                     void* o, void* m, void* l, int B, int H, int Sq, int Sk,
                     int D, int q_off, int k_off, int causal, float scale,
                     cudaStream_t stream) {
  CUtensorMap maps[6];
  const cudaError_t err = tf32_maps(maps, q, q_lo, k, k_lo, v, v_lo, B, H,
                                    Sq, Sk, D, Wide::kPv);
  if (err != cudaSuccess) return err;
  const dim3 grid = grid_of<kHeadMajor>(B * H, (Sq + kRows - 1) / kRows,
                                        (D + Wide::kOut - 1) / Wide::kOut);
  return launch_ws(flash_fwd_tf32_wide, grid, Wide::kBytes + 1024, stream,
                   maps[0], maps[1], maps[2], maps[3], maps[4], maps[5],
                   (float*)o, (float*)m, (float*)l, H, Sq, Sk, D, q_off,
                   k_off, causal, scale);
}

// The pre-pass's six planes in scratch order: Q hi, Q lo, K hi, K lo, V^T
// hi, V^T lo.
struct Tf32Planes {
  float *qh, *ql, *kh, *kl, *vh, *vl;
};
inline Tf32Planes tf32_planes(void* scratch, int B, int H, int Sq, int Sk,
                              int D) {
  const size_t nq = (size_t)B * Sq * H * D, nk = (size_t)B * Sk * H * D;
  const size_t nv = (size_t)B * H * D * padded_keys(Sk);
  float* x = (float*)scratch;
  return {x, x + nq, x + 2 * nq, x + 2 * nq + nk, x + 2 * nq + 2 * nk,
          x + 2 * nq + 2 * nk + nv};
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

// The tf32 forward's pre-pass alone: q, k, v as for hvdt_flash_fwd_tf32,
// into its scratch (the six planes, in the order given there).
extern "C" int hvdt_flash_fwd_tf32_split(const void* q, const void* k,
                                         const void* v, void* scratch, int B,
                                         int H, int Sq, int Sk, int D,
                                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 0 || D % 32) return cudaErrorInvalidValue;
  const hvdt::Tf32Planes p = hvdt::tf32_planes(scratch, B, H, Sq, Sk, D);
  const size_t nq = (size_t)B * Sq * H * D, nk = (size_t)B * Sk * H * D;
  const int skp = hvdt::sm90::padded_keys(Sk);
  const int blocks = 132 * 8;
  hvdt::sm90::tf32_split<<<blocks, 256, 0, st>>>(
      (const float4*)q, (float4*)p.qh, (float4*)p.ql, nq / 4);
  hvdt::sm90::tf32_split<<<blocks, 256, 0, st>>>(
      (const float4*)k, (float4*)p.kh, (float4*)p.kl, nk / 4);
  hvdt::sm90::tf32_split_t<<<dim3(B * H, D / 32, skp / 32), 256, 0, st>>>(
      (const float*)v, p.vh, p.vl, Sk, H, D, skp);
  return cudaGetLastError();
}

// The columns of O a CTA of the tf32 forward owns at head dim D, which
// names the build hvdt_flash_fwd_tf32 runs: 128 up to kWideAbove, 256
// (the wide build) past it.
extern "C" int hvdt_flash_fwd_tf32_part(int D) {
  return D > hvdt::kWideAbove ? hvdt::Wide::kOut
                              : hvdt::StreamShape<float>::kOut;
}

// fp32 through 3xTF32: the pre-pass, then the build of D. q, k, v:
// contiguous fp32 [B, S, H, D] with 16-byte-aligned bases; D a multiple of
// 32. o: fp32 [B, Sq, H, D]; m, l: fp32 [B, H, Sq]. scratch: fp32,
// 16-byte aligned, 2 B Sq H D + 2 B Sk H D + 2 B H D Skp elements (Skp =
// Sk rounded up to 32): the pre-pass's Q hi, Q lo, K hi, K lo, V^T hi and
// V^T lo, in that order.
extern "C" int hvdt_flash_fwd_tf32(const void* q, const void* k,
                                   const void* v, void* o, void* m, void* l,
                                   void* scratch, int B, int H, int Sq,
                                   int Sk, int D, int q_off, int k_off,
                                   int causal, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int err =
      hvdt_flash_fwd_tf32_split(q, k, v, scratch, B, H, Sq, Sk, D, stream);
  if (err != cudaSuccess) return err;
  const hvdt::Tf32Planes p = hvdt::tf32_planes(scratch, B, H, Sq, Sk, D);
  if (D > hvdt::kWideAbove)
    return hvdt::run_wide(p.qh, p.ql, p.kh, p.kl, p.vh, p.vl, o, m, l, B, H,
                          Sq, Sk, D, q_off, k_off, causal, scale, st);
  return hvdt::run<float>(p.qh, p.ql, p.kh, p.kl, p.vh, p.vl, o, m, l, B, H,
                          Sq, Sk, D, q_off, k_off, causal, scale, st);
}
