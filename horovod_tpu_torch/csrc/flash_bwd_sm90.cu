// Fused flash-attention backward for Hopper's tensor cores (sm_90a), bf16
// and fp16 at head dims 33-128: dq, dk and dv in one launch, built at D 64
// and 128 and run at every multiple of 8 between them on the caller's
// tensors (kCut, as flash_dkv_sm90.cu does), beside a pre-pass kernel that
// makes the backward's lse and delta for every CUDA route.
//
// Replaces the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` (with
// the shared recompute `_recompute_p_ds`) in
// horovod_tpu/parallel/flash_attention.py, launched by `_flash_bwd_bhsd`,
// in place of the pair flash_dq_sm90.cu and flash_dkv_sm90.cu (which stay
// built, checked and timed beside it). Same function: for every visible
// (q, k) pair p = exp(s - lse) (lse = +inf on rows that saw no key, so p is
// exactly 0 there) and ds = p (dp - delta) scale; dv = sum over q of p^T
// do, dk = sum over q of ds^T q and dq = sum over k of ds k, each summed in
// fp32 and written in the input's type; p and ds reach the tensor cores in
// the input's type, as the reference's dots take them on the TPU by
// default.
//
// What bounds it on this card. Five matrix products per visible pair (s,
// dp, p^T do, ds^T q, ds k) against seven [B, S, H, D] tensors moved: at
// the main path's shape (B 4, S 2048, H 16, D 128, causal) 1.72e11
// operations over 235 MB, about 730 operations per byte against the
// card's balance point of about 295: the tensor cores are the limit. The
// pair paid seven products for the same function (dq's kernel S, dP and
// dS K; dk/dv's S^T, dP^T, P^T dO and dS^T Q).
//
// Design (D 64 and 128). flash_dkv_sm90's CTA, ring and roles, with dQ
// added: one CTA per (128-key kv tile, batch*head), K and V resident, one
// producer warp streaming 64-row Q and dO tiles and their lse and delta
// through a ring of kStages stages, and two consumer warpgroups of 64 keys
// each that compute, per q tile and in the pair's order and accumulators,
//   S^T = K Q^T, P^T, dV += P^T dO, dP^T = V dO^T, dS^T, dK += dS^T Q
// so that dk and dv are flash_dkv_sm90's bit for bit. Then:
//   - each consumer writes its packed dS^T [64 keys][64 q] into a swizzled
//     shared plane (two buffers, one per parity of the q tile), the layout
//     TMA gives a K-major tile, and passes a proxy fence and a named
//     barrier of the two consumers;
//   - dQ's part of this (kv tile, q tile), dS [64 q][128 keys] K [128
//     keys][D], is one SS wgmma chain per consumer over the 128 keys: A the
//     two planes read transposed (MN-major), B K's resident tile read as an
//     MN-major operand, as flash_dq_sm90 reads it; consumer c takes columns
//     c D / 2 .. (c + 1) D / 2 - 1 (m64 n(D / 2) k16, D / 4 accumulator
//     registers, live while S^T and dP^T are not);
//   - the consumers hand the part (fp32 [64][D]) to a dQ writer through
//     one of two staging buffers in shared memory (part_full / part_empty
//     mbarriers, q tiles alternating), and go on to the next q tile while
//     it is added.
// The Q and dO stage is released once dK's product is done; dQ's reads
// only K and the planes. (Issuing S^T and dP^T in one commit group and
// dV's product after both, `kJoinSdP`, keeps dk's and dv's bits and moved
// the time by 3% or less either way: tools/bwd_sm90_variants.py.)
//
// dq's adds, in one fixed order. The parts of q tile t come from kv tiles
// 0 .. J_t (every kv tile that sees t: the causal mask lets tile j see t
// once k_off + 128 j <= q_off + 64 t + 63). They are summed into an fp32
// accumulator, [B H, q tiles, 64, D] (`acc`, scratch the wrapper
// allocates; nothing zeroes it), in one fixed kv-tile order: the first
// adder stores its part, each next one adds its own. Each store or add is
// one TMA bulk copy or bulk reduce-add of the staged 32 KB (at D 128),
// issued by lane 0 of the part's writer warp (the producer warpgroup's
// warps 1 and 2, one per staging buffer, so that two adds are in flight)
// and waited for to its end. A per-(batch*head, q tile) counter in global
// memory (`turn`, zeroed by the pre-pass or the wrapper) says whose turn
// it is: it counts the parts added; each adder waits until it reads its
// rank and releases rank + 1 (st.release) once its add is done. So dq's
// bits are the same on every run, on any stream, at any load; they differ
// from flash_dq_sm90's, whose sum over the keys is one chain. A second,
// small kernel (flash_bwd_sm90_convert, launched by the same C entry)
// writes dq in the input's type from the accumulator, and zeros for the
// q tiles that no kv tile sees (offsets, Sq > Sk).
// The order (`desc`, chosen by the C entry from what it can see): where
// all the CTAs fit on the card at once (B H kv tiles <= SMs, the C4 shape
// of chip_smoke.py), descending kv tiles; where they come in waves (the
// LM's shapes), ascending. A CTA walks its q tiles in ascending order from
// the first it sees (flash_dkv_sm90's order, which dk and dv keep), so kv
// tile j reaches q tile t two q tiles before kv tile j - 1 does: in
// ascending order each adder waits for one that comes later, and with all
// CTAs running together a q tile's last add lags its compute by a whole
// chain of adds (17-19% at the C4 shapes); in descending order each
// adder's turn has come by the time its part is staged. In waves the
// ascending order hands the heaviest causal kv tiles out first, and
// descending hands them out last (1.34-1.37x slower at the main and
// Phi-3-mini shapes):
// tools/bwd_sm90_variants.py times both (`ascending`, `descending`).
// Converting in the kernel, by each q tile's last adder (it adds its part,
// reads the sum back into its staging buffer and writes dq), cost the
// writers their registers (ptxas spilled 24-56 bytes) and 6-24% at the C4
// shapes, within 1.3% either way at the main and Phi-3-mini shapes
// (`convert_in_kernel`). Plain loads and stores or RED in place of the
// bulk copies were 2.0-4.4x slower (`stores`, `red`), and adds in arrival
// order into a zeroed accumulator 2-7% slower than the fixed order
// (`free_order`).
//
// Why no wait can deadlock. A CTA takes its tile from a global counter
// (`tile = atomicAdd`, the counter after the turn flags, zeroed with
// them) when it starts to run, so tiles are handed out in their order,
// each to a CTA that is resident, whatever order the hardware dispatches
// CTAs in. The order is kv tile outer, in the order of the adds (tile id
// = j B H + b h ascending, (nk - 1 - j) B H + b h descending), b h inner.
// A CTA waits only on the CTA of the kv tile before its own in that order,
// of its own (b, h), whose id is lower: that CTA was handed its tile
// earlier and is running or done. By induction over the ids, the lowest
// unfinished tile waits on nothing unfinished, so it finishes, and every
// tile does. Within a CTA the writers wait on other CTAs only; the
// consumers wait on the producer and on the writers (the staging
// buffers), the producer on the consumers. A writer warp's lanes wait for
// lane 0 at a __syncwarp each part: left to run ahead, they spun on the
// next part's barrier, which lane 0 completes, while lane 0 spun on its
// turn, and a build whose turn spin slept (__nanosleep) hung.
//
// Registers: a consumer holds dK and dV (D / 2 each), S^T and dP^T (32
// each) and dS^T packed (16); dQ's part (D / 4) is live only once S^T and
// dP^T are dead: at D 128 at most 64 + 64 + 32 + 32 + 16 while dP^T is
// summed, under the 240 that setmaxnreg gives a consumer (at 232 ptxas
// serialized the D 128 build's wgmmas, 6-10% slower: `regs_40_232`); the
// producer warpgroup (the TMA producer and the two writers) keeps 24.
// ptxas reports no spill and no serialized wgmma for the D 64 and 128
// builds.
// Shared memory at D 128, two stages: K 32 KB + V 32 KB + Q 2 x 16 KB + dO
// 2 x 16 KB + dS^T planes 2 x 16 KB + two staged parts 2 x 32 KB + lse and
// delta + barriers = 230,504 bytes (231,528 with the alignment pad): no
// third stage (kStages 3 takes effect at D 64 only, where it changed
// nothing measurable).
//
// The pre-pass (flash_bwd_prep) reads o and do once, in their own type,
// and writes lse = m + log l (+inf where l = 0) and delta = sum over d of
// do * o in fp32, [B, H, Sq], and zeroes the counters, in one launch: a
// group of lanes a row (b, s, h), about a lane a 16-byte load (16-byte
// loads where a row allows them), a trip each where the grid allows.
#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace hvdt {
namespace {

using namespace sm90;

constexpr int kKeys = 128;  // keys of a CTA (a kv tile)
constexpr int kQRows = 64;  // queries of a q tile (a stage)
// The choices tools/bwd_sm90_variants.py changes (one text edit each):
constexpr int kStages = 2;           // Q and dO stages in the ring (3 only
                                     // where shared memory holds them)
constexpr int kAddMode = 2;          // the first and middle adds: 0 loads
                                     // and stores, 1 RED (atomicAdd of
                                     // float4), 2 one TMA bulk copy (the
                                     // first) or bulk reduce (the others)
constexpr bool kFreeOrder = false;   // adds in arrival order (bits vary)
constexpr bool kConvertPass = true;  // dq converted by a second kernel
                                     // (false: by each q tile's last adder)
constexpr bool kAdds = true;         // false: parts dropped (a probe)
constexpr bool kJoinSdP = false;     // S^T and dP^T in one commit group,
                                     // dV's product after both (false:
                                     // flash_dkv_sm90's order, dV's with
                                     // dP^T's)
constexpr int kOrder = 2;            // the order of the adds and of the
                                     // handout: 0 ascending kv tiles, 1
                                     // descending, 2 descending where the
                                     // tiles make one wave, else ascending

template <int D>
struct BwdSmem {
  static constexpr int kRegionK = kKeys * 128;    // [128][64] 16-bit
  static constexpr int kRegionQ = kQRows * 128;   // [64][64] 16-bit
  static constexpr int kTileK = (D / 64) * kRegionK;
  static constexpr int kTileQ = (D / 64) * kRegionQ;
  static constexpr int kPlanes = kKeys * 128;     // dS^T [128 keys][64 q]
  static constexpr int kPart = kQRows * D * 4;    // a dQ part, fp32 [64][D]
  static constexpr int bytes(int stages) {
    return 2 * kTileK + 2 * stages * kTileQ + 2 * kPlanes + 2 * kPart +
           stages * 2 * kQRows * 4 + 8 * (7 + 2 * stages) + 16;
  }
  static constexpr int kStg =
      bytes(kStages) + 1024 <= 232448 ? kStages : 2;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTileK;
  static constexpr int kQ = kV + kTileK;
  static constexpr int kDo = kQ + kStg * kTileQ;
  static constexpr int kDs = kDo + kStg * kTileQ;    // two plane buffers
  static constexpr int kStage = kDs + 2 * kPlanes;   // two staged parts
  static constexpr int kStats = kStage + 2 * kPart;  // lse, delta [64]
  static constexpr int kBar = kStats + kStg * 2 * kQRows * 4;
  // kv_full, full[kStg], empty[kStg], part_full[2], part_empty[2],
  // sum_full[2]
  static constexpr int kTileId = kBar + 8 * (7 + 2 * kStg);
  static constexpr int kBytes = kTileId + 16;
  static_assert(kBytes == bytes(kStg), "the layout's size");
  static_assert(kDs % 1024 == 0, "the dS^T planes keep the swizzle's alignment");
  static_assert(kBytes + 1024 <= 232448, "fused backward tiles exceed shared memory");
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Orders this thread's view of global memory (generic proxy) before its
// later bulk copies (async proxy).
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// `bytes` from global memory into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` of shared memory stored to (kAdd: added to, fp32) global memory
// as one bulk operation, committed; bulk_wait_read() frees the source,
// bulk_wait() waits for the writes.
template <bool kAdd>
__device__ __forceinline__ void bulk_out(void* dst, const void* src,
                                         uint32_t bytes) {
  if constexpr (kAdd)
    asm volatile(
        "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
        "[%0], [%1], %2;\n" ::"l"(dst), "r"(smem_u32(src)), "r"(bytes)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            dst), "r"(smem_u32(src)), "r"(bytes)
        : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Four fp32 values rounded to T at p (8-byte aligned).
template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2<T>(v.x, v.y),
                                            pack2<T>(v.z, v.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The first q tile that the kv tile of keys k0 .. k0 + 127 sees (nq when
// none): q tile t sees it once q_off + 64 t + 63 >= k_off + k0.
__device__ __forceinline__ int first_q_tile(int k0, int nq, int q_off,
                                            int k_off, int causal) {
  if (!causal) return 0;
  const long long need = (long long)k_off + k0 - q_off - (kQRows - 1);
  return need <= 0 ? 0
                   : (int)min((long long)nq, (need + kQRows - 1) / kQRows);
}

// The last kv tile that sees q tile t (rows q0 .. q0 + 63), or -1: the
// kv tiles 0 .. that one add the q tile's parts.
__device__ __forceinline__ int last_kv_tile(int q0, int nk, int q_off,
                                            int k_off, int causal) {
  if (!causal) return nk - 1;
  const long long reach = (long long)q_off + q0 + kQRows - 1 - k_off;
  return reach < 0 ? -1 : (int)min((long long)nk - 1, reach / kKeys);
}

template <typename T, int D, bool kCut>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   T* __restrict__ dk, T* __restrict__ dv,
                   float* __restrict__ acc, int* __restrict__ turn, int BH,
                   int H, int Sq, int Sk, int d, int q_off, int k_off,
                   int causal, float scale, int desc) {
  using L = BwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  constexpr int kStg = L::kStg;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStg;
  uint64_t* part_full = empty + kStg;   // [2], one per staged part
  uint64_t* part_empty = part_full + 2;
  uint64_t* sum_full = part_empty + 2;
  int* tile_id = reinterpret_cast<int*>(smem + L::kTileId);

  const int nq = (Sq + kQRows - 1) / kQRows;
  const int nk = (Sk + kKeys - 1) / kKeys;
  if (threadIdx.x == 0) {
    // The tile counter follows the turn flags. Tile ids in handout order:
    // the kv tile outer, in the order of the adds (`desc`), b h inner. The
    // CTA's b h, kv tile and first q tile go to shared memory beside its id
    // (the writers read them back from there).
    const int id = atomicAdd(turn + (size_t)BH * nq, 1);
    const int jj = desc ? nk - 1 - id / BH : id / BH;
    tile_id[0] = id;
    tile_id[1] = id % BH;
    tile_id[2] = jj;
    tile_id[3] = first_q_tile(jj * kKeys, nq, q_off, k_off, causal);
    bar_init(kv_full, 1);
    for (int s = 0; s < kStg; ++s) {
      bar_init(&full[s], 32);   // the producer warp's lanes
      bar_init(&empty[s], 8);   // lane 0 of each consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      bar_init(&part_full[s], 8);   // lane 0 of each consumer warp
      bar_init(&part_empty[s], 1);  // the part's writer
      bar_init(&sum_full[s], 1);
    }
    bar_init_fence();
  }
  __syncthreads();
  const int bh = tile_id[1], j = tile_id[2], first = tile_id[3];
  const int b = bh / H, h = bh % H;
  const int k0 = j * kKeys;
  const int dd = kCut ? d : D;  // the row stride of dq, dk and dv

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    regs_dec<24>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp == 0) {
      // Producer: warp 0.
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
        const int n = t - first, st = n % kStg;
        if (n >= kStg) bar_wait(&empty[st], ((n / kStg) & 1) ^ 1);
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
      return;
    }
    if (warp == 3) {
      // The q tiles no kv tile sees (those before the first that kv tile 0
      // sees) belong to kv tile 0: dq = 0.
      if (j == 0 && !kConvertPass) {
        T* dq_bh = dq + (size_t)b * Sq * H * dd + (size_t)h * dd;
        const int rows = min(first * kQRows, Sq);
#pragma unroll 1
        for (int i = lane; i < rows * (dd / 8); i += 32)
          *reinterpret_cast<uint4*>(dq_bh + (size_t)(i / (dd / 8)) * H * dd +
                                    8 * (i % (dd / 8))) = make_uint4(0, 0, 0, 0);
      }
      return;
    }
    // The dQ writers: warp 1 + p takes the parts staged in buffer p, the
    // CTA's q tiles first + p, first + p + 2, ..., so that two adds are in
    // flight. Lane 0 waits and issues; the lanes convert. Their warpgroup
    // has 24 registers a thread, so the loop keeps little state: the CTA's
    // b h, kv tile and first q tile are read back from shared memory where
    // they are needed.
    const int p = warp - 1;
    const volatile int* cta = tile_id;
    int sums = 0;  // uses of sum_full[p] so far
#pragma unroll 1
    for (int n = p;; n += 2) {
      const int t = cta[3] + n;
      if (t >= (Sq + kQRows - 1) / kQRows) break;
      float* stg = reinterpret_cast<float*>(smem + L::kStage + p * L::kPart);
      const int last = last_kv_tile(t * kQRows, (Sk + kKeys - 1) / kKeys,
                                    q_off, k_off, causal);
      // The order of the adders: 0 for the first to add.
      const int rank = desc ? last - cta[2] : cta[2];
      const size_t at = (size_t)cta[1] * ((Sq + kQRows - 1) / kQRows) + t;
      int* flag = turn + at;
      float* accp = acc + at * (kQRows * D);
      bar_wait(&part_full[p], (n >> 1) & 1);
      bool convert = false;   // this warp writes the q tile's dq
      bool reload = false;    // from the sum read back into stg
      if constexpr (!kAdds) {
      } else if constexpr (kFreeOrder) {
        // Every part added as it comes (acc zeroed by the C entry); with no
        // conversion pass, the last to arrive reads the sum back and
        // converts.
        if (lane == 0) {
          bulk_out<true>(accp, stg, L::kPart);
          bulk_wait();
          if (!kConvertPass) {
            fence_proxy_async_global();
            __threadfence();
            reload = atomicAdd(flag, 1) == last;
          }
        }
        reload = __shfl_sync(0xffffffffu, reload, 0);
        convert = reload;
      } else {
        convert = rank == last && !kConvertPass;
        reload = convert && rank > 0;
        if (rank == 0 && convert) {
          // The only adder: its part is the sum.
        } else if (kAddMode == 2) {
          if (lane == 0) {
            // This part into acc: stored by the first adder, added by the
            // others, each in its turn.
            if (rank > 0) {
              while (ld_acquire(flag) != rank) {
              }
              fence_proxy_async_global();
              bulk_out<true>(accp, stg, L::kPart);
            } else {
              bulk_out<false>(accp, stg, L::kPart);
            }
            bulk_wait_read();
            // The part is read: its buffer is free, unless the sum comes
            // back into it.
            if (!reload) bar_arrive(&part_empty[p]);
            bulk_wait();
            fence_proxy_async_global();
            if (rank < last) st_release(flag, rank + 1);
          }
        } else {
          if (rank > 0 && lane == 0) {
            while (ld_acquire(flag) != rank) {
            }
          }
          __syncwarp();
          float4* acc4 = reinterpret_cast<float4*>(accp);
          const float4* stg4 = reinterpret_cast<const float4*>(stg);
#pragma unroll 1
          for (int c = lane; c < kQRows * D / 4; c += 32) {
            if (rank == 0)
              __stcg(acc4 + c, stg4[c]);
            else if (kAddMode == 1)
              atomicAdd(acc4 + c, stg4[c]);
            else
              __stcg(acc4 + c, add4(__ldcg(acc4 + c), stg4[c]));
          }
          __syncwarp();
          if (lane == 0) {
            if (!reload) bar_arrive(&part_empty[p]);
            __threadfence();
            if (rank < last) st_release(flag, rank + 1);
          }
        }
      }
      if (reload) {
        // The whole sum (this part in it) back into this part's buffer.
        if (lane == 0) {
          fence_proxy_async_global();
          bar_arrive_tx(&sum_full[p], L::kPart);
          bulk_load(stg, accp, L::kPart, &sum_full[p]);
        }
        bar_wait(&sum_full[p], sums & 1);
        ++sums;
      }
      if (convert) {
        // dq in the input's type, rows below Sq, columns below d: lane l
        // takes columns 8 (l % (D / 8)) .. + 7 of rows l / (D / 8), + 256 /
        // D, ..., 16 bytes a store.
        constexpr int kLanesPerRow = D / 8, kRowsPerStep = 32 / kLanesPerRow;
        const int col = 8 * (lane % kLanesPerRow);
        if (col < dd) {
          const int row0 = lane / kLanesPerRow;
          const int rows = min(kQRows, Sq - t * kQRows);
          const int bh_ = cta[1];
          T* out = dq + ((size_t)(bh_ / H) * Sq + t * kQRows + row0) * H * dd +
                   (size_t)(bh_ % H) * dd + col;
          const float4* in =
              reinterpret_cast<const float4*>(stg + row0 * D + col);
#pragma unroll 1
          for (int r = row0; r < rows; r += kRowsPerStep) {
            const float4 lo = in[0], hi = in[1];
            *reinterpret_cast<uint4*>(out) =
                make_uint4(pack2<T>(lo.x, lo.y), pack2<T>(lo.z, lo.w),
                           pack2<T>(hi.x, hi.y), pack2<T>(hi.z, hi.w));
            out += (size_t)kRowsPerStep * H * dd;
            in += kRowsPerStep * D / 4;
          }
        }
        __syncwarp();
      }
      if (lane == 0 && (convert || !kAdds || kFreeOrder))
        bar_arrive(&part_empty[p]);
      // The lanes wait here for lane 0 (no lane spins on the next part's
      // barrier while lane 0 spins on a turn).
      __syncwarp();
    }
    return;
  }

  // Consumers: warpgroup c owns keys k0 + 64c .. k0 + 64c + 63 for dK and
  // dV and columns c D / 2 .. (c + 1) D / 2 - 1 of dQ's part.
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
  // Consumer c's columns of K, the B of dQ += dS K (MN-major).
  const uint32_t kn_base = smem_u32(smem + L::kK) +
                           (c * D / 2 / 64) * L::kRegionK +
                           (c * D / 2 % 64) * 2;

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
    uint8_t* planes = smem + L::kDs + (n & 1) * L::kPlanes;
    bar_wait(&full[st], ph);

    // S^T = K Q^T and (kJoinSdP) dP^T = V dO^T, in one commit group.
    float s[32], dp[32];
    uint32_t op[16], op_p[16];  // dS^T and (kJoinSdP) P^T, packed
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * L::kRegionK + (kk % 4) * 32;
      const uint32_t b_off = (kk / 4) * L::kRegionQ + (kk % 4) * 32;
      wgmma_ss<64, T>(s, desc_sw128(k_base + a_off, 16),
                      desc_sw128(q_st + b_off, 16), kk > 0);
    }
    if constexpr (kJoinSdP) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a_off = (kk / 4) * L::kRegionK + (kk % 4) * 32;
        const uint32_t b_off = (kk / 4) * L::kRegionQ + (kk % 4) * 32;
        wgmma_ss<64, T>(dp, desc_sw128(v_base + a_off, 16),
                        desc_sw128(do_st + b_off, 16), kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if constexpr (kJoinSdP) fence_regs(dp);

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
    if constexpr (kJoinSdP) {
#pragma unroll
      for (int e = 0; e < 16; ++e) op_p[e] = pack2<T>(s[2 * e], s[2 * e + 1]);
    } else {
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
    }

    // dS^T = P^T (dP^T - delta) scale, packed in the input's type.
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int qc = 8 * (e / 4) + col + e % 2;
      dp[e] = s[e] * (dp[e] - st_delta[qc]) * scale;
    }
#pragma unroll
    for (int e = 0; e < 16; ++e) op[e] = pack2<T>(dp[2 * e], dp[2 * e + 1]);

    // This consumer's rows of the dS^T plane: element (key r, query q) at
    // byte r * 128 + ((q / 8) ^ (r % 8)) * 16 + (q % 8) * 2, the 128-byte
    // swizzle (op[2 jj + i] holds queries 8 jj + col, + 1 of row row0 + 8 i).
    // The buffer of this q tile's parity was last read by both consumers'
    // dQ products of q tile n - 2, which ended before either passed the
    // named barrier of q tile n - 1.
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = row0 + 8 * i;
        *reinterpret_cast<uint32_t*>(planes + r * 128 +
                                     ((jj ^ (r % 8)) << 4) + col * 2) =
            op[2 * jj + i];
      }

    // (kJoinSdP: dV += P^T dO, then) dK += dS^T Q.
    fence_regs(acc_dk);
    fence_regs(op);
    if constexpr (kJoinSdP) {
      fence_regs(acc_dv);
      fence_regs(op_p);
    }
    wgmma_fence();
    if constexpr (kJoinSdP) {
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk) {
        const uint32_t a[4] = {op_p[4 * kk], op_p[4 * kk + 1],
                               op_p[4 * kk + 2], op_p[4 * kk + 3]};
        wgmma_rs<D, T>(acc_dv, a,
                       desc_sw128(do_st + kk * 16 * 128, L::kRegionQ), 1);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kQRows / 16; ++kk) {
      const uint32_t a[4] = {op[4 * kk], op[4 * kk + 1], op[4 * kk + 2],
                             op[4 * kk + 3]};
      wgmma_rs<D, T>(acc_dk, a,
                     desc_sw128(q_st + kk * 16 * 128, L::kRegionQ), 1);
    }
    wgmma_commit();

    // dQ's part = dS K over the 128 keys, once both consumers' planes are
    // in: A the planes read transposed (keys the reduction dim, a k16 step
    // 16 key rows), B consumer c's columns of K (MN-major).
    fence_proxy_async();
    named_bar_sync(1, 256);
    float acc_dq[D / 4];
    const uint32_t ds_base = smem_u32(planes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_ss<D / 2, T, 1, 1>(acc_dq, desc_sw128(ds_base + kk * 16 * 128,
                                                  L::kPlanes),
                               desc_sw128(kn_base + kk * 16 * 128,
                                          L::kRegionK),
                               kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dk);
    fence_regs(op);
    fence_regs(acc_dq);
    if constexpr (kJoinSdP) {
      fence_regs(acc_dv);
      fence_regs(op_p);
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[st]);

    // Hand the part to its writer through staged buffer n % 2, fp32 [64][D]
    // as acc holds it: acc_dq[4 jj + 2 i + e] at row 16 (t / 32) + lane / 4
    // + 8 i, column c D / 2 + 8 jj + col + e. The buffer is free once its
    // part of two q tiles before is read.
    const int pb = n & 1;
    float* part = reinterpret_cast<float*>(smem + L::kStage + pb * L::kPart);
    if (n >= 2) bar_wait(&part_empty[pb], ((n >> 1) - 1) & 1);
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 16 * (t / 32) + lane / 4 + 8 * i;
        *reinterpret_cast<float2*>(part + r * D + c * D / 2 + 8 * jj + col) =
            make_float2(acc_dq[4 * jj + 2 * i], acc_dq[4 * jj + 2 * i + 1]);
      }
    fence_proxy_async();  // the bulk copies read it
    __syncwarp();
    if (lane == 0) bar_arrive(&part_full[pb]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + row0 + 8 * i;
    if (key >= Sk) continue;
    // kCut: rows of d columns, of which those past d are not stored.
    const size_t off = ((size_t)(b * Sk + key) * H + h) * dd + col;
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

// kConvertPass: dq from the accumulator in a second launch (grid (q tiles,
// B H), 256 threads), zeros where no kv tile sees a q tile.
template <typename T, int D, bool kCut>
__global__ void __launch_bounds__(256)
    flash_bwd_sm90_convert(const float* __restrict__ acc, T* __restrict__ dq,
                           int H, int Sq, int Sk, int d, int q_off, int k_off,
                           int causal) {
  const int t = blockIdx.x, bh = blockIdx.y, nq = gridDim.x;
  const int b = bh / H, h = bh % H, q0 = t * kQRows;
  const int dd = kCut ? d : D;
  const bool seen = last_kv_tile(q0, (Sk + kKeys - 1) / kKeys, q_off, k_off,
                                 causal) >= 0;
  const float4* a =
      reinterpret_cast<const float4*>(acc + ((size_t)bh * nq + t) * (kQRows * D));
  for (int c = threadIdx.x; c < kQRows * D / 4; c += 256) {
    const int row = c / (D / 4), col = 4 * (c % (D / 4));
    if (q0 + row < Sq && col < dd)
      store4<T>(dq + ((size_t)(b * Sq + q0 + row) * H + h) * dd + col,
                seen ? __ldcg(a + c) : make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

template <typename T, int D, bool kCut>
cudaError_t launch_build(const CUtensorMap& tq, const CUtensorMap& tk,
                         const CUtensorMap& tv, const CUtensorMap& tdo,
                         const void* lse, const void* delta, void* dq,
                         void* dk, void* dv, void* acc, void* counters, int B,
                         int H, int Sq, int Sk, int d, int q_off, int k_off,
                         int causal, float scale, cudaStream_t stream) {
  const int nq = (Sq + kQRows - 1) / kQRows, nk = (Sk + kKeys - 1) / kKeys;
  cudaError_t err = cudaSuccess;
  if constexpr (kFreeOrder)
    err = cudaMemsetAsync(acc, 0, (size_t)B * H * nq * kQRows * D * 4, stream);
  if (err != cudaSuccess) return err;
  int desc = kOrder == 1;
  if (kOrder == 2) {
    // Descending where every tile gets an SM at once (the chain of adds
    // then follows the order the CTAs reach each q tile in); ascending,
    // heaviest causal kv tiles first, where the tiles come in waves.
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    desc = B * H * nk <= sms;
  }
  err = launch_ws(flash_bwd_sm90<T, D, kCut>, dim3(B * H * nk),
                  BwdSmem<D>::kBytes + 1024, stream, tq, tk, tv, tdo,
                  (const float*)lse, (const float*)delta, (T*)dq, (T*)dk,
                  (T*)dv, (float*)acc, (int*)counters, B * H, H, Sq, Sk, d,
                  q_off, k_off, causal, scale, desc);
  if (err != cudaSuccess || !kConvertPass) return err;
  flash_bwd_sm90_convert<T, D, kCut><<<dim3(nq, B * H), 256, 0, stream>>>(
      (const float*)acc, (T*)dq, H, Sq, Sk, d, q_off, k_off, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dq, void* dk,
                void* dv, void* acc, void* counters, int B, int H, int Sq,
                int Sk, int d, int q_off, int k_off, int causal, float scale,
                cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = encode_bshd<T>(&tq, q, B, Sq, H, d, kQRows, D);
  if (err == cudaSuccess)
    err = encode_bshd<T>(&tdo, dout, B, Sq, H, d, kQRows, D);
  if (err == cudaSuccess) err = encode_bshd<T>(&tk, k, B, Sk, H, d, kKeys, D);
  if (err == cudaSuccess) err = encode_bshd<T>(&tv, v, B, Sk, H, d, kKeys, D);
  if (err != cudaSuccess) return err;
  if (d == D)
    return launch_build<T, D, false>(tq, tk, tv, tdo, lse, delta, dq, dk, dv,
                                     acc, counters, B, H, Sq, Sk, d, q_off,
                                     k_off, causal, scale, stream);
  return launch_build<T, D, true>(tq, tk, tv, tdo, lse, delta, dq, dk, dv,
                                  acc, counters, B, H, Sq, Sk, d, q_off,
                                  k_off, causal, scale, stream);
}

template <typename T>
cudaError_t run_for_dim(int d, const void* q, const void* k, const void* v,
                        const void* g, const void* lse, const void* delta,
                        void* dq, void* dk, void* dv, void* acc,
                        void* counters, int B, int H, int Sq, int Sk, int qo,
                        int ko, int causal, float sc, cudaStream_t st) {
  if (d <= 32 || d > 128 || d % 8) return cudaErrorInvalidValue;
  if (d <= 64)
    return run<T, 64>(q, k, v, g, lse, delta, dq, dk, dv, acc, counters, B,
                      H, Sq, Sk, d, qo, ko, causal, sc, st);
  return run<T, 128>(q, k, v, g, lse, delta, dq, dk, dv, acc, counters, B, H,
                     Sq, Sk, d, qo, ko, causal, sc, st);
}

// ---- the pre-pass -----------------------------------------------------------

// Eight products do * o of one 16-byte chunk of T, summed in order onto s.
template <typename T>
__device__ __forceinline__ float dot_chunk(float s, uint4 a, uint4 b) {
  const T* x = reinterpret_cast<const T*>(&a);
  const T* y = reinterpret_cast<const T*>(&b);
#pragma unroll
  for (int e = 0; e < (int)(16 / sizeof(T)); ++e)
    s = fmaf(to_f32(x[e]), to_f32(y[e]), s);
  return s;
}

// A row r = (b s) H + h of o and do ([B, S, H, D], D contiguous) to each
// group of `lanes` lanes (a power of 2 up to 32, about a lane a 16-byte
// chunk of the row, so that a warp takes 32 / lanes rows at once):
// delta[b, h, s] = sum over d of do * o (lane-strided partial sums, then a
// butterfly over the group), lse[b, h, s] = m + log l (+inf where l = 0);
// the first threads zero `counters`.
template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_prep(const T* __restrict__ o, const T* __restrict__ dout,
                   const float* __restrict__ m, const float* __restrict__ l,
                   float* __restrict__ lse, float* __restrict__ delta,
                   int* __restrict__ counters, int n_counters, int H, int Sq,
                   int D, long long rows, int vec, int lanes) {
  const long long gt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long threads = (long long)gridDim.x * blockDim.x;
  for (long long i = gt; i < n_counters; i += threads) counters[i] = 0;
  const int sub = threadIdx.x % lanes;
  const int group = threadIdx.x % 32 / lanes;  // of the warp's groups
  const long long groups = threads / lanes;
  for (long long r = gt / lanes; r - group < rows; r += groups) {
    // (every lane of a warp runs the same trips: rows past the end add
    // nothing and write nothing)
    float s = 0.f;
    if (r < rows) {
      if (vec) {
        const uint4* x = reinterpret_cast<const uint4*>(o + r * D);
        const uint4* y = reinterpret_cast<const uint4*>(dout + r * D);
        for (int cc = sub; cc < D * (int)sizeof(T) / 16; cc += lanes)
          s = dot_chunk<T>(s, x[cc], y[cc]);
      } else {
        for (int e = sub; e < D; e += lanes)
          s = fmaf(to_f32(o[r * D + e]), to_f32(dout[r * D + e]), s);
      }
    }
    for (int off = lanes / 2; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (sub == 0 && r < rows) {
      const int h = (int)(r % H);
      const long long bs = r / H;
      const size_t at = ((size_t)(bs / Sq) * H + h) * Sq + bs % Sq;
      const float lv = l[at];
      delta[at] = s;
      lse[at] = lv > 0.f ? m[at] + logf(lv) : __int_as_float(0x7f800000);
    }
  }
}

template <typename T>
cudaError_t run_prep(const void* o, const void* dout, const void* m,
                     const void* l, void* lse, void* delta, void* counters,
                     int n_counters, int B, int H, int Sq, int D,
                     cudaStream_t st) {
  const long long rows = (long long)B * Sq * H;
  const int vec = (D * (int)sizeof(T)) % 16 == 0 &&
                  (reinterpret_cast<uintptr_t>(o) |
                   reinterpret_cast<uintptr_t>(dout)) % 16 == 0;
  const int units = vec ? D * (int)sizeof(T) / 16 : D;  // a row's loads
  int lanes = 1;
  while (lanes < 32 && lanes < units) lanes *= 2;
  // A group of lanes a row, one trip each where the grid allows it.
  const long long blocks = std::max<long long>(
      1, std::min<long long>(1 << 30,
                             std::max<long long>((rows * lanes + 255) / 256,
                                                 (n_counters + 255) / 256)));
  flash_bwd_prep<T><<<(unsigned)blocks, 256, 0, st>>>(
      (const T*)o, (const T*)dout, (const float*)m, (const float*)l,
      (float*)lse, (float*)delta, (int*)counters, n_counters, H, Sq, D, rows,
      vec, lanes);
  return cudaGetLastError();
}

}  // namespace
}  // namespace hvdt

// dtype: 1 bf16, 2 fp16 (hvdt::DType). q, k, v, do: contiguous [B, S, H, D]
// of that type with 16-byte-aligned bases; D a multiple of 8 from 40 to 128
// (run by the build of 64 or 128). lse, delta: fp32 [B, H, Sq]. dq: [B, Sq,
// H, D], dk, dv: [B, Sk, H, D] of that type. acc: fp32 scratch of B H
// ceil(Sq / 64) 64 x (the build's D) values; counters: B H ceil(Sq / 64) + 1
// int32, zero on entry (hvdt_flash_bwd_prep zeroes them).
extern "C" int hvdt_flash_bwd_sm90(int dtype, const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, void* dk, void* dv, void* acc,
                                   void* counters, int B, int H, int Sq,
                                   int Sk, int D, int q_off, int k_off,
                                   int causal, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == hvdt::kBFloat16)
    return hvdt::run_for_dim<__nv_bfloat16>(D, q, k, v, dout, lse, delta, dq,
                                            dk, dv, acc, counters, B, H, Sq,
                                            Sk, q_off, k_off, causal, scale,
                                            st);
  if (dtype == hvdt::kFloat16)
    return hvdt::run_for_dim<__half>(D, q, k, v, dout, lse, delta, dq, dk, dv,
                                     acc, counters, B, H, Sq, Sk, q_off,
                                     k_off, causal, scale, st);
  return cudaErrorInvalidValue;
}

// dtype: 0 fp32, 1 bf16, 2 fp16. o, do: contiguous [B, Sq, H, D] of that
// type; m, l: fp32 [B, H, Sq]; lse, delta: fp32 [B, H, Sq] out; counters:
// n_counters int32 zeroed (none when n_counters is 0).
extern "C" int hvdt_flash_bwd_prep(int dtype, const void* o, const void* dout,
                                   const void* m, const void* l, void* lse,
                                   void* delta, void* counters,
                                   int n_counters, int B, int H, int Sq,
                                   int D, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == hvdt::kFloat32)
    return hvdt::run_prep<float>(o, dout, m, l, lse, delta, counters,
                                 n_counters, B, H, Sq, D, st);
  if (dtype == hvdt::kBFloat16)
    return hvdt::run_prep<__nv_bfloat16>(o, dout, m, l, lse, delta, counters,
                                         n_counters, B, H, Sq, D, st);
  if (dtype == hvdt::kFloat16)
    return hvdt::run_prep<__half>(o, dout, m, l, lse, delta, counters,
                                  n_counters, B, H, Sq, D, st);
  return cudaErrorInvalidValue;
}
