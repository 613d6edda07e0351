// Shared pieces of the fp32-FMA flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu); the tensor-core kernels (*_sm90.cu) take only kNegInf and
// DType from here and their own pieces from sm90_common.cuh.
//
// Layout: q, k, v, o, do and the gradients are contiguous [B, S, H, D]
// tensors (the module layout of models/transformer.py), read in place, so
// no [B*H, S, D] transpose is ever materialized. Softmax statistics
// (m, l, lse, delta) are contiguous [B, H, S] fp32.
//
// Tiling: every kernel works on score tiles of R x KB with 256 threads:
// R rows owned by the block (q rows in the forward and dq, key rows in
// dk/dv) against KB rows of the tile its loop walks. The thread at
// (ty = tid / 16, tx = tid % 16) owns rows ty + 16*i (i < R/16) and
// columns tx + 16*j (j < KB/16) of a score tile, and columns tx + 16*c
// (c < D/16) of an [R, D] output tile. The 16 threads sharing a row are
// the two halves of one warp, so row reductions are four xor-shuffles.
// Up to D = 128 R = KB = 64. The tiles are [rows][D + 1] fp32, so a
// block's shared memory grows with D and must stay within the 227 KB
// (232448 bytes) a block may opt into; the tiles shrink past two head
// dims, the counterpart of the reference's _ladders_for:
//   D 256: the backward kernels own R = 32 rows (64-row tiles would need
//     280 KB for dq and 297 KB for dk/dv; 32 rows need 206 and 214 KB);
//     the forward's three 64-row tiles and score tile need 209 KB.
//   D 384 and 512: the loop's tiles shrink to KB = 32 rows, the forward
//     owns R = 32 and the backward R = 16 rows. At D 512 the forward
//     needs 3 x 32 x 513 x 4 + 32 x 33 x 4 = 201216 bytes, dq
//     2 x 16 x 513 x 4 + 2 x 32 x 513 x 4 + 16 x 33 x 4 = 199104 and
//     dk/dv 196992 + 2 x 16 x 33 x 4 + 2 x 32 x 4 = 201472; a 32-row
//     backward would need 262656 bytes for its four tiles alone. Past
//     D 512 even these tiles do not fit: 16 x 641 x 4 x 2 + 32 x 641 x 4
//     x 2 = 246144 bytes for the backward's four tiles at D 640, and
//     shrinking the loop's tiles below 32 rows would leave each thread
//     one column.
//   Past D 512 (any multiple of kChunk = 64; the wrapper zero-pads other
//     D to the next one) the kernels hold no tile of the whole head dim.
//     grid.z splits the output's head dim into chunks of 64 columns, one
//     per block, and each block streams the reductions over D (s = q k^T,
//     and in the backward dp = do v^T) through [64][65] tiles of the same
//     width, accumulating only its own chunk of o, dq, dk or dv; the
//     chunk-0 blocks write m and l. R = KB = 64 rows whatever D is: the
//     forward holds 4 such tiles (q, k, v chunks and the score tile;
//     4 x 64 x 65 x 4 = 66560 bytes), dq 5 (83200) and dk/dv 6 plus lse
//     and delta (100352). Every block recomputes s (and dp), so the logit
//     products are paid D / 64 times: right first, fast later.
// Tiles live in shared memory as fp32 with a row pitch of D + 1 floats,
// which puts the 16 rows a half-warp reads at one column in 16 distinct
// banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace hvdt {

constexpr int kBlock = 64;       // rows of a q tile and of a kv tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // the reference's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// Width of the head-dim chunks past D 512 (see Tiling).
constexpr int kChunk = 64;

// Rows of the tile the loop walks at head dim D (see Tiling).
template <int D>
__host__ __device__ constexpr int loop_rows() {
  return D <= 256 ? kBlock : kBlock / 2;
}

// Rows of the q tile a forward block owns at head dim D.
template <int D>
__host__ __device__ constexpr int fwd_rows() {
  return D <= 256 ? kBlock : kBlock / 2;
}

// Rows of the tile a backward block owns at head dim D.
template <int D>
__host__ __device__ constexpr int owned_rows() {
  return D <= 128 ? kBlock : D <= 256 ? kBlock / 2 : kBlock / 4;
}

// Copies rows [row0, row0 + R) of one head into an [R][D + 1] fp32 tile.
// `head` points at (b, s = 0, h, d = 0); consecutive rows are `row_stride`
// elements apart. Rows at or past `seq` read as zero.
template <typename T, int D, int R = kBlock>
__device__ __forceinline__ void load_tile(float* tile, const T* head,
                                          int row0, int seq,
                                          int row_stride) {
  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    const int s = row0 + r;
    tile[r * (D + 1) + c] =
        s < seq ? to_f32(head[(size_t)s * row_stride + c]) : 0.f;
  }
}

// Reductions across the 16 lanes that share a tile row.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Shared memory of a kernel holding `tiles` [KB][D + 1] loop tiles,
// `owned` [R][D + 1] tiles and `squares` [R][KB + 1] score tiles, plus
// `extra` floats.
constexpr size_t smem_bytes(int d, int tiles, int owned, int squares,
                            int extra, int r = kBlock, int kb = kBlock) {
  return sizeof(float) *
         ((size_t)tiles * kb * (d + 1) + (size_t)owned * r * (d + 1) +
          (size_t)squares * r * (kb + 1) + extra);
}

// The most dynamic shared memory a block may opt into on sm_90.
constexpr size_t kMaxSmem = 232448;

// Launches `kernel` with `bytes` of dynamic shared memory (above the 48 KB
// default, hence the attribute, set on every call so that any current
// device gets it) and returns the launch's error.
template <typename K, typename... Args>
inline cudaError_t launch(K kernel, dim3 grid, size_t bytes,
                          cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

// The element type of a tensor: 0 is float32, 1 is bfloat16, 2 is float16.
enum DType : int { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

}  // namespace hvdt
