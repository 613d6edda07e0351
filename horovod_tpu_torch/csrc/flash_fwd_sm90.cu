// Flash-attention forward for Hopper's tensor cores (sm_90a), bf16 and fp16,
// built at head dims 16, 32, 64, 128, 256, 384 and 512 and run at every
// multiple of 8 between them on the caller's tensors (below).
//
// Replaces the TPU kernel `_kernel` in horovod_tpu/parallel/flash_attention.py
// (launched by `_flash_bhsd`), as flash_fwd_stream_sm90.cu does for fp32
// and 16-bit head dims past 512 and flash_fwd_tf32_narrow_sm90.cu for fp32
// at head dims up to 32. Same function and contract: an online
// softmax whose running max m, normalizer l and output accumulator stay in
// fp32; runtime offsets give
// the global positions of q[0] and k[0]; kv tiles wholly in the future of a
// q tile are skipped; rows that see no key give o = 0, m = -1e30, l = 0;
// [B, S, H, D] is read in place and the stats are written as [B, H, S].
//
// What bounds it on this card. At the main path's shape (B=4, S=2048, H=16,
// D=128, causal) the function does about 500 operations per byte it must
// move, above the card's balance point of about 295 (989 TFLOP/s of bf16
// over 3.35 TB/s): the tensor cores, not the memory, are the limit.
//
// Design. Tiles of 128 q rows, one per (q tile, batch*head, part of O's
// head dim). Three warpgroups a CTA:
// - a producer, which gives its registers away (setmaxnreg) and whose one
//   elected thread issues every copy as a TMA load through 4-D tensor maps
//   over [B, S, H, D]: a tile's Q, then K and the CTA's columns of V
//   through a ring of kv stages guarded by full/empty mbarriers (K and V
//   released apart, K as soon as S has read it);
// - two consumers, each owning 64 q rows (wgmma's M), which take the
//   registers. Per kv tile: S = Q K^T as m64 n kKv k16 wgmmas from shared
//   memory; the online softmax on the accumulator fragments in registers
//   (row max by two quad shuffles; l summed from the unrounded fp32 p); P
//   converted to the input's type in registers and fed to O += P V as
//   wgmma's register A operand, with V read from shared memory as an
//   MN-major B operand, so V is never transposed.
// A 16-bit p is what the reference's own dots take on the TPU by default
// (16-bit multiplies, f32 accumulation); the checks allow for exactly that
// rounding, in the input's type (bf16 or fp16).
//
// What keeps the tensor cores busy (FA3, Shah et al. 2024, sections
// 3.1-3.2), each piece turned off by one constant below, so that
// tools/fwd_sm90_variants.py can rebuild the serial loop (every piece off)
// and each piece alone; none changes an operation or its order, so o, m
// and l are bit for bit those of the serial loop:
// - kOverlap: a consumer issues S of kv tile j + 1 before the softmax of
//   tile j is used: per tile it issues S_{j+1} and then O += P_j V_j,
//   waits for S_{j+1} alone, runs the softmax of j + 1 while P_j V_j is in
//   flight, then waits for P_j V_j; the rescale of O by tile j + 1's
//   correction runs before P_{j+1} V_{j+1} is issued, in the shadow of
//   S_{j+2}. O is still scaled, then summed, tile by tile in order. At D
//   64 to 256 only (kOV).
// - kPingPong: the two consumers take turns at issuing their products
//   (two named barriers, kTurnBar + c), so that one's products run while
//   the other does its softmax instead of both at once; at D 64 and 128
//   only (kPP).
// - kPersistent: min(SMs, tiles) CTAs walk the tiles (FwdTile: the
//   heaviest causal q tiles first) in rounds of one tile a CTA, every
//   other round backwards (walk_tile), so that one tile's last products
//   and stores overlap the next tile's loads and no CTA takes only heavy
//   tiles; the producer loads the next Q into a second buffer (D <= 128)
//   or once both consumers have released this one.
// - kStagedStore: O goes to global memory through the consumer's rows of
//   the Q buffer, 16 bytes a thread along the rows, instead of as 4-byte
//   stores straight from the accumulator fragments (8 rows apart).
// Tried and left out, as they did not pay (PERF.md): a third kv stage at
// D 64 and 128, and a tile's last turn issuing the next tile's first S.
// The exponential is one MUFU.EX2 (exp2_ftz).
// Shared memory and registers by head dim (a consumer thread holds its
// part of O, kOut/2 fp32 for a part kOut columns wide, the scores S, kKv/2,
// and P as kKv/4 packed pairs; with kOverlap, S of one tile and P of the
// one before are live together):
//   D 64, 128: 128-row kv stages, O whole. At D=128, Q 2x32 KB (two
//     buffers) + K 2x32 KB + V 2x32 KB = 192 KB; O 64 + S 64 + P 32
//     registers.
//   D 256: 128-row stages would need Q 64 KB + K 2x64 KB + V 2x64 KB =
//     320 KB, so the kv stages are 64 rows: Q 128x256x2 = 65,536 B, K
//     2x64x256x2 = 65,536 B, V 65,536 B, 196,608 B in all (plus the
//     barriers and the 1 KB alignment pad); O 128 + S 32 + P 16 registers,
//     under the 240 that setmaxnreg gives a consumer.
//   D 384, 512: one consumer's whole O would be 64 x D / 128 = 192 or 256
//     registers, past the 240, so O's head dim is split in two parts
//     (kOut = 192 or 256 columns, two tiles of the walk). Each CTA holds Q
//     at full D, streams K at full D and its half of V in 32-row kv
//     stages, recomputes S over the whole D (the two halves pay S twice:
//     1.5x the forward's products) and accumulates only its half of O;
//     both halves compute the same m and l, and part 0 writes them. At D
//     512: Q 128x512x2 = 131,072 B + 2 x (K 32x512x2 = 32,768 B + V half
//     32x256x2 = 16,384 B) = 229,376 B (230,480 with the barriers and the
//     pad, of 232,448); O 128 + S 16 + P 8 registers. At D 384: 98,304 +
//     2 x (24,576 + 12,288) = 172,032 B; O 96 + S 16 + P 8 registers, and
//     O += P V is an m64n192k16 product.
//   D 16, 32: a design of its own (flash_fwd_sm90_narrow, below): a CTA
//     per tile of 64 q rows, whose kv tiles its consumer warpgroups
//     share (kNarrowSplit), in two passes (the rows' max, then p).
// Head dims between the builds (16-bit d past 32, a multiple of 8, so that
// a row of d values is a legal TMA stride): the kernel of the next build D
// runs on the caller's [B, S, H, d] tensors as they are (kCut). Their
// tensor maps take d as the extent and d * 2 bytes as the row stride and
// keep the build's 128-byte boxes, so TMA fills columns d .. D - 1 of every
// Q, K and V tile with zeros, as a zero pad of the inputs would (a box that
// lies wholly past d reads zeros alone; the transaction bytes are the full
// box either way), and the store of O takes d as its row stride and skips
// the columns past d. The products and the softmax are the build's own, so
// o, m and l equal those of the padded inputs bit for bit, without the
// three copies in and the one out that padding cost (more than the kernel
// at D 80, 96 and 200, PERF.md). At d = D the build runs as it did.
#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace hvdt {
namespace {

using namespace sm90;

constexpr int kRows = 128;  // q rows of a tile

// 2^x as one MUFU.EX2: exp2f adds a range check and two multiplies around
// it to keep results below 2^-126 from flushing to zero. Flushed, such a p
// drops out of l (at least 1: the row's max gives p = 1) and of o below
// their rounding, as does a correction that small; the checks hold o, m
// and l to the plain version as before.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The pieces of the overlapped loop (header).
constexpr bool kOverlap = true;
constexpr bool kPingPong = true;
constexpr bool kPersistent = true;
constexpr bool kStagedStore = true;

// Consumer c waits for its turn on named barrier kTurnBar + c, and for
// its rows of O in shared memory on kStoreBar + c.
constexpr int kTurnBar = 1;
constexpr int kStoreBar = 3;

// Rows of a kv stage at head dim D (see the header).
template <int D>
constexpr int kv_rows() {
  return D <= 128 ? 128 : D <= 256 ? 64 : 32;
}

// Columns of O that one CTA accumulates: all of D up to 256, half past it.
template <int D>
constexpr int out_cols() {
  return D <= 256 ? D : D / 2;
}

template <int D>
struct FwdSmem {
  static constexpr int kKv = kv_rows<D>();
  static constexpr int kOut = out_cols<D>();
  static constexpr int kStages = 2;
  // Q buffers: a second where it fits (D <= 128) lets the producer load
  // the next tile's Q while this one's is read.
  static constexpr int kQBufs = kPersistent && D <= 128 ? 2 : 1;
  static constexpr int kRegionQ = kRows * 128;        // [128][64] 16-bit
  static constexpr int kRegionKv = kKv * 128;         // [kKv][64]
  static constexpr int kTileQ = (D / 64) * kRegionQ;  // [128][D]
  static constexpr int kTileK = (D / 64) * kRegionKv;
  static constexpr int kTileV = (kOut / 64) * kRegionKv;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBufs * kTileQ;
  static constexpr int kV = kK + kStages * kTileK;
  static constexpr int kBar = kV + kStages * kTileV;
  // q_full[], q_empty[], k_full[], v_full[], k_empty[], v_empty[]
  static constexpr int kBytes = kBar + 8 * (2 * kQBufs + 4 * kStages);
  static_assert(kBytes + 1024 <= 232448, "forward tiles exceed shared memory");
};

// Tile t of the walk: the part of O's head dim fastest (D 384, 512: the
// two parts of one q tile side by side), then batch*head, then the q tiles
// from the last (the heaviest causal one) down, so that the tiles' work
// never grows along the walk; nk is the number of kv tiles it sees.
template <int D>
struct FwdTile {
  int bh, q0, c0, nk;
  __device__ FwdTile(int t, int BH, int nq, int Sk, int q_off, int k_off,
                     int causal) {
    constexpr int kKv = FwdSmem<D>::kKv, kParts = D / FwdSmem<D>::kOut;
    c0 = (t % kParts) * FwdSmem<D>::kOut;
    bh = (t / kParts) % BH;
    q0 = (nq - 1 - t / kParts / BH) * kRows;
    nk = (Sk + kKv - 1) / kKv;
    if (causal) {
      // kv tile j is visible while k_off + kKv j <= q_off + q0 + 127.
      const long long reach = (long long)q_off + q0 + kRows - 1 - k_off;
      nk = min(nk, reach < 0 ? 0 : (int)(reach / kKv) + 1);
    }
  }
};

// The r-th tile a CTA takes: round r of the walk is tiles r G .. r G + G
// - 1 of a grid of G CTAs, taken in the grid's order in even rounds and
// backwards in odd ones, so that the CTAs that took the heaviest tiles of
// a round take the lightest of the next (without kPersistent, G is the
// number of tiles and each CTA takes one).
__device__ __forceinline__ int walk_tile(int r) {
  return r * gridDim.x +
         (r % 2 == 0 ? blockIdx.x : gridDim.x - 1 - blockIdx.x);
}

template <typename T, int D, bool kCut>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   T* __restrict__ o, float* __restrict__ m_out,
                   float* __restrict__ l_out, int B, int H, int Sq, int Sk,
                   int d, int q_off, int k_off, int causal, float scale) {
  using L = FwdSmem<D>;
  constexpr int kKv = L::kKv, kOut = L::kOut, kSt = L::kStages;
  constexpr int kQB = L::kQBufs;
  // The ping-pong pays with 128-key kv tiles (D <= 128), the overlap with
  // 64 keys or more (D <= 256); the shorter products past them lost 3-11%
  // to each (PERF.md).
  constexpr bool kPP = kPingPong && kKv == 128;
  constexpr bool kOV = kOverlap && kKv >= 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_empty = q_full + kQB;
  uint64_t* k_full = q_empty + kQB;
  uint64_t* v_full = k_full + kSt;
  uint64_t* k_empty = v_full + kSt;
  uint64_t* v_empty = k_empty + kSt;

  const int BH = B * H;
  const int nq = (Sq + kRows - 1) / kRows;
  const int tiles = BH * nq * (D / kOut);

  if (threadIdx.x == 0) {
    for (int b = 0; b < kQB; ++b) {
      bar_init(&q_full[b], 1);
      bar_init(&q_empty[b], 8);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < kSt; ++s) {
      bar_init(&k_full[s], 1);
      bar_init(&v_full[s], 1);
      bar_init(&k_empty[s], 8);
      bar_init(&v_empty[s], 8);
    }
    bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer. Load n of the ring (counted over the CTA's tiles) goes to
    // stage n % kSt, once the consumers released load n - kSt there.
    regs_dec<24>();
    if (threadIdx.x == 0) {
      int n = 0;
      for (int it = 0; walk_tile(it) < tiles; ++it) {
        const FwdTile<D> tl(walk_tile(it), BH, nq, Sk, q_off, k_off, causal);
        const int b = tl.bh / H, h = tl.bh % H;
        // Q buffer it % kQB, once the consumers released its last use.
        const int qb = it % kQB, quse = it / kQB;
        if (quse > 0) bar_wait(&q_empty[qb], (quse & 1) ^ 1);
        bar_arrive_tx(&q_full[qb], L::kTileQ);
        for (int r = 0; r < D / 64; ++r)
          tma_load_4d(smem + L::kQ + qb * L::kTileQ + r * L::kRegionQ, &tq,
                      &q_full[qb], 64 * r, h, tl.q0, b);
        for (int j = 0; j < tl.nk; ++j, ++n) {
          const int st = n % kSt, free_ph = ((n / kSt) & 1) ^ 1;
          uint8_t* kt = smem + L::kK + st * L::kTileK;
          uint8_t* vt = smem + L::kV + st * L::kTileV;
          if (n >= kSt) bar_wait(&k_empty[st], free_ph);
          bar_arrive_tx(&k_full[st], L::kTileK);
          for (int r = 0; r < D / 64; ++r)
            tma_load_4d(kt + r * L::kRegionKv, &tk, &k_full[st], 64 * r, h,
                        j * kKv, b);
          if (n >= kSt) bar_wait(&v_empty[st], free_ph);
          bar_arrive_tx(&v_full[st], L::kTileV);
          for (int r = 0; r < kOut / 64; ++r)
            tma_load_4d(vt + r * L::kRegionKv, &tv, &v_full[st],
                        tl.c0 + 64 * r, h, j * kKv, b);
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns rows 64c .. 64c + 63 of each q tile.
    regs_inc<240>();
    const int c = wg - 1;
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row0 = 64 * c + 16 * (t / 32) + lane / 4;  // +8 for i = 1
    const int col = 2 * (lane % 4);
    uint32_t q_base;  // this consumer's rows of the tile's Q buffer

    // Lane 0 of each warp releases a barrier of 8 arrivals.
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) bar_arrive(bar);
    };
    // S = Q K^T of stage st into s: issued and committed, not waited for.
    auto scores = [&](float (&s)[kKv / 2], int st) {
      const uint32_t k_base = smem_u32(smem + L::kK + st * L::kTileK);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t step = (kk % 4) * 32;
        wgmma_ss<kKv, T>(
            s, desc_sw128(q_base + (kk / 4) * L::kRegionQ + step, 16),
            desc_sw128(k_base + (kk / 4) * L::kRegionKv + step, 16), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of stage st: issued and committed, not waited for.
    auto pv = [&](float (&acc)[kOut / 2], uint32_t (&pa)[kKv / 4], int st) {
      const uint32_t v_base = smem_u32(smem + L::kV + st * L::kTileV);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKv / 16; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                               pa[4 * kk + 3]};
        wgmma_rs<kOut, T>(acc, a,
                          desc_sw128(v_base + kk * 16 * 128, L::kRegionKv), 1);
      }
      wgmma_commit();
    };

    int ring = 0;          // kv loads consumed
    bool opened = false;   // consumer 1 opened the ping-pong
    for (int it = 0; walk_tile(it) < tiles; ++it) {
      const FwdTile<D> tl(walk_tile(it), BH, nq, Sk, q_off, k_off, causal);
      const int b = tl.bh / H, h = tl.bh % H, q0 = tl.q0, nk = tl.nk;
      const int first_qpos = q_off + q0 + 64 * c;
      const int qb = it % kQB;
      uint8_t* q_rows = smem + L::kQ + qb * L::kTileQ + c * 64 * 128;
      q_base = smem_u32(q_rows);
      // Q is released after its last S, or with kStagedStore after O has
      // gone through this consumer's rows of it.
      auto release_q = [&]() {
        if (!kStagedStore) release(&q_empty[qb]);
      };

      float acc[kOut / 2];
#pragma unroll
      for (int i = 0; i < kOut / 2; ++i) acc[i] = 0.f;
      float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};

      // The turns of the ping-pong: one per point where this consumer
      // issues products (with kOverlap nk + 1: S_0, then S_{j+1} with
      // P_j V_j, then the last P V; else 2 nk), and the two consumers'
      // turns alternate over all the CTA's tiles. Consumer 0 goes first:
      // consumer 1 opens the first turn for it, hands back every turn of
      // its own (the last of a tile too, so that consumer 0 starts the next
      // tile while consumer 1 stores this one) but the CTA's very last, and
      // so leaves no arrival over.
      const int turns = nk == 0 ? 0 : kOV ? nk + 1 : 2 * nk;
      bool last_tile = true;  // no later tile of the CTA has turns
      for (int r = it + 1; kPP && c == 1 && walk_tile(r) < tiles; ++r)
        if (FwdTile<D>(walk_tile(r), BH, nq, Sk, q_off, k_off, causal).nk) {
          last_tile = false;
          break;
        }
      int turn = 0;
      auto turn_begin = [&]() {
        if (!kPP) return;
        if (c == 1 && turn == 0 && !opened) {
          named_bar_arrive(kTurnBar, 256);
          opened = true;
        }
        named_bar_sync(kTurnBar + c, 256);
      };
      auto turn_end = [&]() {
        if (kPP && !(c == 1 && last_tile && turn == turns - 1))
          named_bar_arrive(kTurnBar + 1 - c, 256);
        ++turn;
      };

      // The online softmax of kv tile j's scores in s, in place: scaled,
      // masked (only tiles that cross the diagonal or the ragged end), the
      // row max, the correction of the rows' earlier sums, then p =
      // exp(x - m) (masked entries, -inf, give exactly 0) and l, which
      // keeps this thread's share of the row; the quad's shares are added
      // at the end.
      auto softmax_of = [&](float (&s)[kKv / 2], int j, float (&corr)[2],
                            const bool masked) {
        const int k0 = j * kKv;
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int e = 0; e < kKv / 2; ++e) {
          const int i = (e / 2) % 2;
          float x = s[e] * scale;
          if (masked) {
            const int kc = k0 + 8 * (e / 4) + col + e % 2;
            const bool ok = kc < Sk &&
                            (!causal || q_off + q0 + row0 + 8 * i >= k_off + kc);
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
          corr[i] = exp2_ftz((m_i[i] - m_new) * kLog2e);
          m_i[i] = m_new;
          mb[i] = m_new * kLog2e;
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < kKv / 2; ++e) {
          const int i = (e / 2) % 2;
          const float p = exp2_ftz(fmaf(s[e], kLog2e, -mb[i]));
          s[e] = p;
          rs[i] += p;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) l_i[i] = l_i[i] * corr[i] + rs[i];
      };
      // Two whole copies, masked or not: ptxas puts the wait for P V at the
      // top of the block that holds it, so a softmax ending in a block of
      // its own keeps its exponentials above that wait (one copy with the
      // mask inside lost them below it, out of P V's shadow).
      auto softmax = [&](float (&s)[kKv / 2], int j, float (&corr)[2]) {
        const int k0 = j * kKv;
        if (k0 + kKv > Sk || (causal && k_off + k0 + kKv - 1 > first_qpos))
          softmax_of(s, j, corr, true);
        else
          softmax_of(s, j, corr, false);
      };
      auto rescale = [&](const float (&corr)[2]) {
#pragma unroll
        for (int e = 0; e < kOut / 2; ++e) acc[e] *= corr[(e / 2) % 2];
      };
      auto pack = [&](uint32_t (&pa)[kKv / 4], const float (&s)[kKv / 2]) {
#pragma unroll
        for (int e = 0; e < kKv / 4; ++e)
          pa[e] = pack2<T>(s[2 * e], s[2 * e + 1]);
      };
      // Stage and phase of the tile's kv tile j.
      auto stage = [&](int j) { return (ring + j) % kSt; };
      auto phase = [&](int j) { return ((ring + j) / kSt) & 1; };

      bar_wait(&q_full[qb], (it / kQB) & 1);
      if (nk == 0) release_q();
      float s[kKv / 2], corr[2];
      uint32_t pa[kKv / 4];
      if (kOV && nk > 0) {
        bar_wait(&k_full[stage(0)], phase(0));
        turn_begin();
        scores(s, stage(0));
        turn_end();
        wgmma_wait<0>();
        fence_regs(s);
        release(&k_empty[stage(0)]);
        if (nk == 1) release_q();
        softmax(s, 0, corr);
        pack(pa, s);
        for (int j = 1; j < nk; ++j) {
          bar_wait(&k_full[stage(j)], phase(j));
          bar_wait(&v_full[stage(j - 1)], phase(j - 1));
          turn_begin();
          scores(s, stage(j));
          rescale(corr);
          pv(acc, pa, stage(j - 1));
          turn_end();
          wgmma_wait<1>();
          fence_regs(s);
          release(&k_empty[stage(j)]);
          if (j == nk - 1) release_q();
          softmax(s, j, corr);
          wgmma_wait<0>();
          fence_regs(acc);
          release(&v_empty[stage(j - 1)]);
          pack(pa, s);
        }
        rescale(corr);
        bar_wait(&v_full[stage(nk - 1)], phase(nk - 1));
        turn_begin();
        pv(acc, pa, stage(nk - 1));
        turn_end();
        wgmma_wait<0>();
        fence_regs(acc);
        release(&v_empty[stage(nk - 1)]);
      } else if (!kOV) {
        for (int j = 0; j < nk; ++j) {
          bar_wait(&k_full[stage(j)], phase(j));
          turn_begin();
          scores(s, stage(j));
          turn_end();
          wgmma_wait<0>();
          fence_regs(s);
          release(&k_empty[stage(j)]);
          if (j == nk - 1) release_q();
          softmax(s, j, corr);
          rescale(corr);
          pack(pa, s);
          bar_wait(&v_full[stage(j)], phase(j));
          turn_begin();
          pv(acc, pa, stage(j));
          turn_end();
          wgmma_wait<0>();
          fence_regs(acc);
          release(&v_empty[stage(j)]);
        }
      }
      ring += nk;

      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 1);
        l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 2);
        inv[i] = 1.f / (l_i[i] == 0.f ? 1.f : l_i[i]);
      }
      // kCut: rows of d columns, of which those past d are not stored.
      const int ld = kCut ? d : D;
      if (kStagedStore) {
        // O through this consumer's rows of the Q buffer, in Q's layout (a
        // region of 64 rows x 128 bytes per 64 columns, 16-byte chunks
        // XOR-ed with the row % 8, so that neither pass conflicts on the
        // banks), then to global memory 16 bytes a thread, row by row.
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int rr = row0 - 64 * c + 8 * i;
#pragma unroll
          for (int jj = 0; jj < kOut / 8; ++jj)
            *reinterpret_cast<uint32_t*>(
                q_rows + (jj / 8) * L::kRegionQ + rr * 128 +
                (((jj % 8) ^ (rr % 8)) * 16) + col * 2) =
                pack2<T>(acc[4 * jj + 2 * i] * inv[i],
                         acc[4 * jj + 2 * i + 1] * inv[i]);
        }
        named_bar_sync(kStoreBar + c, 128);
        constexpr int kChunks = kOut / 8;  // 16-byte chunks of a row
#pragma unroll
        for (int e = t; e < 64 * kChunks; e += 128) {
          const int rr = e / kChunks, jj = e % kChunks;
          const int row = q0 + 64 * c + rr;
          const uint4 v = *reinterpret_cast<const uint4*>(
              q_rows + (jj / 8) * L::kRegionQ + rr * 128 +
              (((jj % 8) ^ (rr % 8)) * 16));
          if (row < Sq && (!kCut || tl.c0 + 8 * jj < d))
            *reinterpret_cast<uint4*>(
                o + ((size_t)(b * Sq + row) * H + h) * ld + tl.c0 + 8 * jj) =
                v;
        }
        // The next Q that TMA writes here comes after these accesses.
        fence_proxy_async();
        release(&q_empty[qb]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = q0 + row0 + 8 * i;
        if (row >= Sq) continue;
        if (!kStagedStore) {
          T* orow = o + ((size_t)(b * Sq + row) * H + h) * ld + tl.c0 + col;
#pragma unroll
          for (int jj = 0; jj < kOut / 8; ++jj)
            if (!kCut || tl.c0 + col + 8 * jj < d)
              store2<T>(orow + 8 * jj, acc[4 * jj + 2 * i] * inv[i],
                        acc[4 * jj + 2 * i + 1] * inv[i]);
        }
        if (tl.c0 == 0 && lane % 4 == 0) {
          m_out[(size_t)tl.bh * Sq + row] = m_i[i];
          l_out[(size_t)tl.bh * Sq + row] = l_i[i];
        }
      }
    }
  }
}

// The build of head dim D on tensors of head dim d <= D (d < D: kCut, see
// the header).
template <typename T, int D>
cudaError_t run(const void* q, const void* k, const void* v, void* o, void* m,
                void* l, int B, int H, int Sq, int Sk, int d, int q_off,
                int k_off, int causal, float scale, cudaStream_t stream) {
  constexpr int kKv = kv_rows<D>();
  CUtensorMap tq, tk, tv;
  cudaError_t err = encode_bshd<T>(&tq, q, B, Sq, H, d, kRows, D);
  if (err == cudaSuccess) err = encode_bshd<T>(&tk, k, B, Sk, H, d, kKv, D);
  if (err == cudaSuccess) err = encode_bshd<T>(&tv, v, B, Sk, H, d, kKv, D);
  if (err != cudaSuccess) return err;
  const long long tiles =
      (long long)B * H * ((Sq + kRows - 1) / kRows) * (D / out_cols<D>());
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  int grid = (int)tiles;
  if (kPersistent) {
    int dev, sms;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    grid = grid < sms ? grid : sms;
  }
  if (d == D)
    return launch_ws(flash_fwd_sm90<T, D, false>, dim3(grid),
                     FwdSmem<D>::kBytes + 1024, stream, tq, tk, tv, (T*)o,
                     (float*)m, (float*)l, B, H, Sq, Sk, d, q_off, k_off,
                     causal, scale);
  return launch_ws(flash_fwd_sm90<T, D, true>, dim3(grid),
                   FwdSmem<D>::kBytes + 1024, stream, tq, tk, tv, (T*)o,
                   (float*)m, (float*)l, B, H, Sq, Sk, d, q_off, k_off, causal,
                   scale);
}

// ---- D 16 and 32: narrow rows ---------------------------------------------
//
// A 16-bit row of Q, K or V is 32 bytes at D 16 and 64 at D 32, so every
// tile is one region in the swizzle of the row's width (sm90_common.cuh),
// loaded by one TMA box. The products are small: S = Q K^T takes one k16
// step at D 16 and two at D 32, O += P V is m64n16k16 or m64n32k16. At
// these widths neither the tensor cores nor the bytes bound the kernel
// (at the C4 shape, B 2, S 1024, H 8, causal, the bytes take 0.7 us and
// the products less than 1 us): what bounds it is the serial chain of
// steps per kv tile (the TMA wait, S, the softmax's exponentials, P V) of
// the CTAs that see the most tiles. Each CTA takes one tile of 64 q rows
// (wgmma's M; the grid is (B H, q tiles), the heaviest causal q tiles
// first on grid.y), and kNarrowSplit consumer warpgroups share its kv
// tiles, so that the chain is split among them:
// - All hold the same 64 rows; warpgroup w takes kv tiles j = w, w + G,
//   w + 2 G, ... (G = kNarrowSplit; dealt round-robin, so that the causal
//   diagonal's tile is no one warpgroup's), through a ring of
//   kNarrowStages stages of its own (K, then V) fed by lane w of the one
//   producer warp, which waits on that warpgroup's barriers alone. The
//   heaviest C4 CTA's chain goes from 2 x 16 steps of 64 keys (two
//   passes, below) to 2 x 4.
// - After pass 1 the warpgroups leave their rows' maxes in shared memory
//   behind a named barrier (kNarrowMaxBar) and each takes the max of the
//   G, so every warpgroup rounds p against the row's final max. After
//   pass 2 warpgroups 1 .. G - 1 leave their partial O and l in their own
//   rings (free by then) behind another (kNarrowSumBar), and warpgroup 0
//   adds them to its own in the order w = 1, 2, ..., normalizes and
//   stores o, m and l. A warpgroup with no kv tile (S 32, a causal first
//   q tile) passes both barriers with m = -1e30, l = 0 and O = 0. o, m
//   and l are the same bits from run to run; against one warpgroup only
//   the fp32 order of l's and O's sums differs.
// - kNarrowOverlap (built, off): S of the next tile issued before this
//   tile's reduction: in pass 1 the max of tile i under S of tile i + 1,
//   in pass 2 S_{i+1} with P_i V_i and the softmax of i + 1 under P_i V_i
//   (the sm90 forward's kOverlap). Each product is issued and waited for
//   in one iteration, the reduction under it in blocks of its own (masked
//   and unmasked copies), above the wait: ptxas puts a wgmma wait at the
//   top of its block. With four warpgroups to an SM the others' work
//   fills those waits already, and the overlap's second S array costs
//   more than it hides.
// - kNarrowExp2Ftz: the exponential as one MUFU.EX2 (exp2_ftz) in place
//   of exp2f's range check and two multiplies around it.
// - The logits of each tile in two whole copies, masked and unmasked,
//   chosen once a tile, as in the sm90 forward.
// None changes the products or the rounding of p: with one warpgroup o, m
// and l are bit for bit the same at 64- or 128-key stages and with the
// overlap on or off, and with exp2f those of the design before (one
// warpgroup, 128-key stages, two CTAs an SM: tools/narrow_variants.py's
// `before_split`, bit-equal to that source). The tool's A/B on an H100 (C4 bf16
// and fp16, D 16 and 32; PERF.md): the package 0.76-0.83x SDPA's forward;
// one warpgroup 1.25x the package, two 1.00-1.08x, three 0.94x at D 16 and
// 1.03x at D 32; 128-key stages 1.17-1.42x (ptxas serializes the wgmmas
// for want of registers); 2 or 4 stages 1.04x or 1.01x; the overlap on
// 1.02-1.03x; exp2f 1.03x; `before_split` 1.09-1.10x (the source before, 1.48-
// 1.58x); two CTAs an SM do not compile at G 4 (56 registers a thread).
//
// Two passes over the kv tiles. S is nearly free here, so a first pass
// computes S alone and each row's max m; the second computes S again, p =
// exp(s - m) against that final m, l and O += P V. p is then rounded to
// the input's type for the tensor cores against the same max as the plain
// version rounds it, l is the sum of the same fp32 p, and no tile rescales
// O. An online softmax rounds p against the running max instead, which
// moves each o by as much as the rounding itself; the checks allow twice
// the rounding's largest effect in a row of o, and a row of 16 or 32
// outputs is too few to bound that reliably: on an H100 the online form
// reached 1.19 to 3.49 of the bound at the C4 shape, bit-equal to the D
// 64 kernel on zero-padded inputs, and the two-pass form 0.85 at most. K
// comes through the ring twice (from L2 the second time); a stage's one
// barrier counts K's bytes, or K's and V's.
constexpr int kNarrowSplit = 4;         // consumer warpgroups on one q tile
constexpr int kNarrowKv = 64;           // keys of a kv stage
constexpr int kNarrowStages = 3;        // kv stages of each warpgroup's ring
constexpr int kNarrowCtasPerSm = 1;     // __launch_bounds__' minimum
constexpr bool kNarrowOverlap = false;  // S of the next tile under this one
constexpr bool kNarrowExp2Ftz = true;   // p by one MUFU.EX2, else exp2f
constexpr int kNarrowRows = 64;         // q rows of a CTA
constexpr int kNarrowThreads = 128 * kNarrowSplit + 32;
// The consumer warpgroups' named barriers: the rows' maxes of pass 1 in
// shared memory, and the partial sums of pass 2.
constexpr int kNarrowMaxBar = 1;
constexpr int kNarrowSumBar = 2;

template <int D>
struct NarrowFwdSmem {
  static constexpr int kRowBytes = D * 2;
  static constexpr int kTileQ = kNarrowRows * kRowBytes;  // [rows][D]
  static constexpr int kTileKv = kNarrowKv * kRowBytes;   // [kKv][D]
  static constexpr int kStage = 2 * kTileKv;              // K, then V
  static constexpr int kRing = kNarrowStages * kStage;    // a warpgroup's
  static constexpr int kQ = 0;
  static constexpr int kRings = kQ + kTileQ;
  // The warpgroups' row maxes after pass 1: [G][2][128] fp32, a thread's
  // two rows at [w][i][thread].
  static constexpr int kMax = kRings + kNarrowSplit * kRing;
  static constexpr int kBar = kMax + kNarrowSplit * 2 * 128 * 4;
  // q_full, full[G][stages], empty[G][stages]
  static constexpr int kBytes =
      kBar + 8 * (1 + 2 * kNarrowSplit * kNarrowStages);
  // A warpgroup's partial O (D / 2 fp32 a thread) and l (2), written over
  // its own ring after its last tile: [D / 2 + 2][128] fp32.
  static constexpr int kPart = (D / 2 + 2) * 128 * 4;
  static_assert(kTileQ % 1024 == 0 && kTileKv % 1024 == 0,
                "narrow tiles keep the 1024-byte alignment");
  static_assert(kPart <= kRing, "a partial O exceeds its warpgroup's ring");
  static_assert(kNarrowCtasPerSm * (kBytes + 1024) <= 232448,
                "narrow forward tiles exceed shared memory");
};

// S = Q K^T for one kv stage into s: issued and committed, not waited for.
// A consumer thread's fragment: s[n] is row row0 + 8 ((n / 2) % 2), key k0
// + 8 (n / 4) + col + n % 2.
template <typename T, int D>
__device__ __forceinline__ void narrow_scores(float (&s)[kNarrowKv / 2],
                                              uint32_t q_base,
                                              uint32_t k_base) {
  constexpr int kRB = D * 2;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<kNarrowKv, T>(s, desc_narrow<kRB>(q_base + kk * 32, 16),
                           desc_narrow<kRB>(k_base + kk * 32, 16), kk > 0);
  wgmma_commit();
}

// The scores in s scaled, with the entries a causal or ragged tile hides
// at -inf (kMasked: only tiles that cross the diagonal or the ragged end
// are checked).
template <bool kMasked>
__device__ __forceinline__ void narrow_logits(float (&s)[kNarrowKv / 2],
                                              int k0, int Sk, int causal,
                                              int qpos0, int k_off, int col,
                                              float scale) {
#pragma unroll
  for (int n = 0; n < kNarrowKv / 2; ++n) {
    float x = s[n] * scale;
    if (kMasked) {
      const int kc = k0 + 8 * (n / 4) + col + n % 2;
      const bool ok =
          kc < Sk && (!causal || qpos0 + 8 * ((n / 2) % 2) >= k_off + kc);
      x = ok ? x : __int_as_float(0xff800000);  // -inf
    }
    s[n] = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kNarrowThreads, kNarrowCtasPerSm)
    flash_fwd_sm90_narrow(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          T* __restrict__ o, float* __restrict__ m_out,
                          float* __restrict__ l_out, int H, int Sq, int Sk,
                          int q_off, int k_off, int causal, float scale) {
  using L = NarrowFwdSmem<D>;
  constexpr int kKv = kNarrowKv, kStg = kNarrowStages, kG = kNarrowSplit;
  constexpr int kRB = L::kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = q_full + 1;       // [G][stages]
  uint64_t* empty = full + kG * kStg;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kNarrowRows;
  int nk = (Sk + kKv - 1) / kKv;
  if (causal) {
    // kv tile j is visible while k_off + kKv j <= q_off + q0 + rows - 1.
    const long long reach = (long long)q_off + q0 + kNarrowRows - 1 - k_off;
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
    // Producer: the last warp. Lane 0 loads Q; lane w < G feeds warpgroup
    // w's ring: its loads n < nw carry K of its tile n (pass 1), loads nw
    // + i K and V of its tile i (pass 2). Each lane waits on its own
    // warpgroup's barriers alone.
    const int w = threadIdx.x % 32;
    if (w == 0) {
      bar_arrive_tx(q_full, L::kTileQ);
      tma_load_4d(smem + L::kQ, &tq, q_full, 0, h, q0, b);
    }
    if (w < kG) {
      const int nw = tiles_of(w);
      uint8_t* ring = smem + L::kRings + w * L::kRing;
      uint64_t* fb = full + w * kStg;
      uint64_t* eb = empty + w * kStg;
      for (int n = 0; n < 2 * nw; ++n) {
        const int st = n % kStg, j = w + kG * (n < nw ? n : n - nw);
        uint8_t* kt = ring + st * L::kStage;
        if (n >= kStg) bar_wait(&eb[st], ((n / kStg) & 1) ^ 1);
        bar_arrive_tx(&fb[st], (n < nw ? 1 : 2) * L::kTileKv);
        tma_load_4d(kt, &tk, &fb[st], 0, h, j * kKv, b);
        if (n >= nw)
          tma_load_4d(kt + L::kTileKv, &tv, &fb[st], 0, h, j * kKv, b);
      }
    }
    return;
  }

  // Consumers: warpgroup w, all on the q tile's 64 rows.
  const int w = warp / 4;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int row0 = 16 * (t / 32) + lane / 4;  // +8 for i = 1
  const int col = 2 * (lane % 4);
  const uint32_t q_base = smem_u32(smem + L::kQ);
  const uint32_t ring = smem_u32(smem + L::kRings + w * L::kRing);
  uint64_t* fb = full + w * kStg;
  uint64_t* eb = empty + w * kStg;
  const int first_qpos = q_off + q0;
  const int qpos0 = q_off + q0 + row0;
  const int nw = tiles_of(w);

  // K and V of load n of the ring, its wait and its release.
  auto k_of = [&](int n) { return ring + (n % kStg) * L::kStage; };
  auto v_of = [&](int n) { return k_of(n) + L::kTileKv; };
  auto wait_load = [&](int n) { bar_wait(&fb[n % kStg], (n / kStg) & 1); };
  auto release = [&](int n) {
    __syncwarp();
    if (lane == 0) bar_arrive(&eb[n % kStg]);
  };
  // Whether the warpgroup's tile i crosses the diagonal or the ragged end.
  auto masked_at = [&](int i) {
    const int k0 = (w + kG * i) * kKv;
    return k0 + kKv > Sk || (causal && k_off + k0 + kKv - 1 > first_qpos);
  };

  bar_wait(q_full, 0);
  // Pass 1: the rows' max (kNegInf, the reference's mask value, where a
  // row sees no key).
  float m_i[2] = {kNegInf, kNegInf};
  auto fold = [&](const float (&s)[kKv / 2]) {
#pragma unroll
    for (int n = 0; n < kKv / 2; ++n)
      m_i[(n / 2) % 2] = fmaxf(m_i[(n / 2) % 2], s[n]);
  };
  // The max of the warpgroup's tile i, in s: two whole copies, masked or
  // not, each a block of its own.
  auto fold_tile = [&](float (&s)[kKv / 2], int i) {
    const int k0 = (w + kG * i) * kKv;
    if (masked_at(i)) {
      narrow_logits<true>(s, k0, Sk, causal, qpos0, k_off, col, scale);
      fold(s);
    } else {
      narrow_logits<false>(s, k0, Sk, causal, qpos0, k_off, col, scale);
      fold(s);
    }
  };
  if (kNarrowOverlap) {
    // cur holds S of load i, waited for; S of load i + 1 goes into nxt
    // while cur's max is taken.
    auto step = [&](float (&cur)[kKv / 2], float (&nxt)[kKv / 2], int i) {
      wait_load(i + 1);
      narrow_scores<T, D>(nxt, q_base, k_of(i + 1));
      fold_tile(cur, i);
      wgmma_wait<0>();
      fence_regs(nxt);
      release(i + 1);
    };
    if (nw > 0) {
      float sa[kKv / 2], sb[kKv / 2];
      wait_load(0);
      narrow_scores<T, D>(sa, q_base, k_of(0));
      wgmma_wait<0>();
      fence_regs(sa);
      release(0);
      int i = 0;
      for (; i + 2 < nw; i += 2) {
        step(sa, sb, i);
        step(sb, sa, i + 1);
      }
      if (i + 1 < nw) {
        step(sa, sb, i);
        fold_tile(sb, i + 1);
      } else {
        fold_tile(sa, i);
      }
    }
  } else {
    for (int i = 0; i < nw; ++i) {
      float s[kKv / 2];
      wait_load(i);
      narrow_scores<T, D>(s, q_base, k_of(i));
      wgmma_wait<0>();
      fence_regs(s);
      release(i);
      fold_tile(s, i);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m_i[i] = fmaxf(m_i[i], __shfl_xor_sync(0xffffffffu, m_i[i], 1));
    m_i[i] = fmaxf(m_i[i], __shfl_xor_sync(0xffffffffu, m_i[i], 2));
  }
  if (kG > 1) {
    // The max over the warpgroups (exact, in any order).
    float* mx = reinterpret_cast<float*>(smem + L::kMax);
#pragma unroll
    for (int i = 0; i < 2; ++i) mx[(2 * w + i) * 128 + t] = m_i[i];
    named_bar_sync(kNarrowMaxBar, 128 * kG);
#pragma unroll
    for (int u = 0; u < kG; ++u)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        m_i[i] = fmaxf(m_i[i], mx[(2 * u + i) * 128 + t]);
  }
  const float mb[2] = {m_i[0] * kLog2e, m_i[1] * kLog2e};

  // Pass 2: p = exp(s - m) (masked entries, -inf, give exactly 0), l, and
  // O += P V with P in the input's type and V an MN-major operand (a k16
  // step is 16 rows of V).
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float l_i[2] = {0.f, 0.f};
  auto exps = [&](float (&s)[kKv / 2]) {
#pragma unroll
    for (int e = 0; e < kKv / 2; ++e) {
      const int i = (e / 2) % 2;
      const float x = fmaf(s[e], kLog2e, -mb[i]);
      const float p = kNarrowExp2Ftz ? exp2_ftz(x) : exp2f(x);
      s[e] = p;
      l_i[i] += p;
    }
  };
  // p of the warpgroup's tile i from its S in s, in place: two whole
  // copies, as fold_tile.
  auto softmax = [&](float (&s)[kKv / 2], int i) {
    const int k0 = (w + kG * i) * kKv;
    if (masked_at(i)) {
      narrow_logits<true>(s, k0, Sk, causal, qpos0, k_off, col, scale);
      exps(s);
    } else {
      narrow_logits<false>(s, k0, Sk, causal, qpos0, k_off, col, scale);
      exps(s);
    }
  };
  auto pack = [&](uint32_t (&pa)[kKv / 4], const float (&s)[kKv / 2]) {
#pragma unroll
    for (int e = 0; e < kKv / 4; ++e) pa[e] = pack2<T>(s[2 * e], s[2 * e + 1]);
  };
  // O += P V of load n: issued and committed, not waited for.
  auto pv = [&](uint32_t (&pa)[kKv / 4], int n) {
    const uint32_t v_base = v_of(n);
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKv / 16; ++kk) {
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                             pa[4 * kk + 3]};
      wgmma_rs<D, T>(acc, a, desc_narrow<kRB>(v_base + kk * 16 * kRB,
                                               L::kTileKv), 1);
    }
    wgmma_commit();
  };
  if (kNarrowOverlap) {
    if (nw > 0) {
      float s[kKv / 2];
      uint32_t pa[kKv / 4];
      wait_load(nw);
      narrow_scores<T, D>(s, q_base, k_of(nw));
      wgmma_wait<0>();
      fence_regs(s);
      softmax(s, 0);
      pack(pa, s);
      for (int i = 1; i < nw; ++i) {
        wait_load(nw + i);
        narrow_scores<T, D>(s, q_base, k_of(nw + i));
        pv(pa, nw + i - 1);
        wgmma_wait<1>();
        fence_regs(s);
        softmax(s, i);
        wgmma_wait<0>();
        fence_regs(acc);
        release(nw + i - 1);
        pack(pa, s);
      }
      pv(pa, 2 * nw - 1);
      wgmma_wait<0>();
      fence_regs(acc);
      release(2 * nw - 1);
    }
  } else {
    for (int i = 0; i < nw; ++i) {
      float s[kKv / 2];
      uint32_t pa[kKv / 4];
      wait_load(nw + i);
      narrow_scores<T, D>(s, q_base, k_of(nw + i));
      wgmma_wait<0>();
      fence_regs(s);
      softmax(s, i);
      pack(pa, s);
      pv(pa, nw + i);
      wgmma_wait<0>();
      fence_regs(acc);
      release(nw + i);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 1);
    l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 2);
  }
  if (kG > 1) {
    // Warpgroups 1 .. G - 1 leave their partial O and l in their rings
    // (whose last reads, by TMA and wgmma, are done); warpgroup 0 adds
    // them to its own in warpgroup order.
    if (w > 0) {
      float* part = reinterpret_cast<float*>(smem + L::kRings + w * L::kRing);
      fence_proxy_async();
#pragma unroll
      for (int e = 0; e < D / 2; ++e) part[e * 128 + t] = acc[e];
#pragma unroll
      for (int i = 0; i < 2; ++i) part[(D / 2 + i) * 128 + t] = l_i[i];
      named_bar_arrive(kNarrowSumBar, 128 * kG);
      return;
    }
    named_bar_sync(kNarrowSumBar, 128 * kG);
#pragma unroll
    for (int u = 1; u < kG; ++u) {
      const float* part =
          reinterpret_cast<const float*>(smem + L::kRings + u * L::kRing);
#pragma unroll
      for (int e = 0; e < D / 2; ++e) acc[e] += part[e * 128 + t];
#pragma unroll
      for (int i = 0; i < 2; ++i) l_i[i] += part[(D / 2 + i) * 128 + t];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + row0 + 8 * i;
    if (row >= Sq) continue;
    const float inv = 1.f / (l_i[i] == 0.f ? 1.f : l_i[i]);
    T* orow = o + ((size_t)(b * Sq + row) * H + h) * D + col;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      store2<T>(orow + 8 * jj, acc[4 * jj + 2 * i] * inv,
                acc[4 * jj + 2 * i + 1] * inv);
    if (lane % 4 == 0) {
      m_out[(size_t)bh * Sq + row] = m_i[i];
      l_out[(size_t)bh * Sq + row] = l_i[i];
    }
  }
}

template <typename T, int D>
cudaError_t run_narrow(const void* q, const void* k, const void* v, void* o,
                       void* m, void* l, int B, int H, int Sq, int Sk,
                       int q_off, int k_off, int causal, float scale,
                       cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = encode_bshd<T>(&tq, q, B, Sq, H, D, kNarrowRows);
  if (err == cudaSuccess) err = encode_bshd<T>(&tk, k, B, Sk, H, D, kNarrowKv);
  if (err == cudaSuccess) err = encode_bshd<T>(&tv, v, B, Sk, H, D, kNarrowKv);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kNarrowRows - 1) / kNarrowRows);
  return launch_threads(flash_fwd_sm90_narrow<T, D>, grid, kNarrowThreads,
                        NarrowFwdSmem<D>::kBytes + 1024, stream, tq, tk, tv,
                        (T*)o, (float*)m, (float*)l, H, Sq, Sk, q_off, k_off,
                        causal, scale);
}

// The build a head dim d runs at: 16 and 32 (narrow) for themselves, any
// other multiple of 8 past 32 the next of 64, 128, 256, 384 and 512.
template <typename T>
cudaError_t run_for_dim(int d, const void* q, const void* k, const void* v,
                        void* o, void* m, void* l, int B, int H, int Sq,
                        int Sk, int q_off, int k_off, int causal, float sc,
                        cudaStream_t st) {
  if (d == 16) return run_narrow<T, 16>(q, k, v, o, m, l, B, H, Sq, Sk, q_off, k_off, causal, sc, st);
  if (d == 32) return run_narrow<T, 32>(q, k, v, o, m, l, B, H, Sq, Sk, q_off, k_off, causal, sc, st);
  if (d <= 32 || d % 8) return cudaErrorInvalidValue;
  if (d <= 64) return run<T, 64>(q, k, v, o, m, l, B, H, Sq, Sk, d, q_off, k_off, causal, sc, st);
  if (d <= 128) return run<T, 128>(q, k, v, o, m, l, B, H, Sq, Sk, d, q_off, k_off, causal, sc, st);
  if (d <= 256) return run<T, 256>(q, k, v, o, m, l, B, H, Sq, Sk, d, q_off, k_off, causal, sc, st);
  if (d <= 384) return run<T, 384>(q, k, v, o, m, l, B, H, Sq, Sk, d, q_off, k_off, causal, sc, st);
  if (d <= 512) return run<T, 512>(q, k, v, o, m, l, B, H, Sq, Sk, d, q_off, k_off, causal, sc, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace hvdt

// dtype: 1 bf16, 2 fp16 (hvdt::DType). q, k, v: contiguous [B, S, H, D] of
// that type with 16-byte-aligned bases; D is 16, 32 or a multiple of 8 from
// 40 to 512 (run by the build of 64, 128, 256, 384 or 512). o: [B, Sq, H, D]
// of that type; m, l: fp32 [B, H, Sq]. scale multiplies the logits (1/sqrt
// of the head dim before any zero padding of D).
extern "C" int hvdt_flash_fwd_sm90(int dtype, const void* q, const void* k,
                                   const void* v, void* o, void* m, void* l,
                                   int B, int H, int Sq, int Sk, int D,
                                   int q_off, int k_off, int causal,
                                   float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == hvdt::kBFloat16)
    return hvdt::run_for_dim<__nv_bfloat16>(D, q, k, v, o, m, l, B, H, Sq, Sk,
                                            q_off, k_off, causal, scale, st);
  if (dtype == hvdt::kFloat16)
    return hvdt::run_for_dim<__half>(D, q, k, v, o, m, l, B, H, Sq, Sk, q_off,
                                     k_off, causal, scale, st);
  return cudaErrorInvalidValue;
}
