// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Layout: q, k, v, o, do and the gradients are contiguous [B, S, H, D]
// tensors (the module layout of models/transformer.py), read in place, so
// no [B*H, S, D] transpose is ever materialized. Softmax statistics
// (m, l, lse, delta) are contiguous [B, H, S] fp32.
//
// Tiling: every kernel works on 64x64 score tiles with 256 threads. The
// thread at (ty = tid / 16, tx = tid % 16) owns rows ty + 16*i and columns
// tx + 16*j (i, j < 4) of a score tile, and columns tx + 16*c (c < D/16)
// of a [64, D] output tile. The 16 threads sharing a row are the two
// halves of one warp, so row reductions are four xor-shuffles.
// Tiles live in shared memory as fp32 with a row pitch of D + 1 floats,
// which puts the 16 rows a half-warp reads at one column in 16 distinct
// banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hvdt {

constexpr int kBlock = 64;       // rows of a q tile and of a kv tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // the reference's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copies rows [row0, row0 + 64) of one head into a [64][D + 1] fp32 tile.
// `head` points at (b, s = 0, h, d = 0); consecutive rows are `row_stride`
// elements apart. Rows at or past `seq` read as zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* tile, const T* head,
                                          int row0, int seq,
                                          int row_stride) {
  for (int idx = threadIdx.x; idx < kBlock * D; idx += kThreads) {
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

// Shared memory of a kernel holding `tiles` [64][D + 1] tiles and `squares`
// [64][65] score tiles, plus `extra` floats.
constexpr size_t smem_bytes(int d, int tiles, int squares, int extra) {
  return sizeof(float) *
         ((size_t)tiles * kBlock * (d + 1) +
          (size_t)squares * kBlock * (kBlock + 1) + extra);
}

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

// The element type of a tensor: 0 is float32, 1 is bfloat16.
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

}  // namespace hvdt
