// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` in horovod_tpu/parallel/flash_attention.py
// (launched by `_flash_bhsd`). Same function: causal or non-causal attention
// with an online softmax whose running max m, normalizer l and output
// accumulator are kept in fp32; runtime offsets give the global positions
// of q[0] and k[0]; kv tiles wholly in the future of a q tile are skipped;
// rows that see no key (l == 0) give o = 0, m = -1e30.
//
// Design. One block per (64-row q tile, batch*head), with the kv tiles as a
// loop inside the block: the TPU's sequential kv grid axis. Under causal
// masking the loop's bound is the last kv tile that starts at or before the
// tile's last query, computed from the runtime offsets, which is the TPU
// kernel's block-skip. The running statistics of a row live in registers
// of the 16 threads that own the row (each keeps the same copy), so only
// the score tile p goes through shared memory between the two products.
//
// What bounds it on this card. At the main path's shape (S=2048, D=128,
// causal, bf16) the function does about 500 operations per byte it must
// move, above the card's balance point of about 295 (989 TFLOP/s over
// 3.35 TB/s): it is bound by arithmetic, not by memory. This first version
// does the products as fp32 FMAs from fp32 tiles in shared memory, so its
// ceiling is the card's fp32 rate (about 67 TFLOP/s), not the bf16
// tensor-core rate (989 TFLOP/s) that the bound is stated against; its
// 113 KB of shared memory at D=128 also allows one block (8 warps) per SM.
// Moving the two products to wgmma on bf16 tiles fed by TMA is the
// redesign that closes that gap.
#include "flash_common.cuh"

namespace hvdt {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     int H, int Sq, int Sk, int q_off, int k_off, int causal,
                     float scale) {
  constexpr int P = D + 1;
  constexpr int PS = kBlock + 1;
  constexpr int C = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;               // [64][P]
  float* ks = qs + kBlock * P;    // [64][P]
  float* vs = ks + kBlock * P;    // [64][P]
  float* ps = vs + kBlock * P;    // [64][PS]

  const int q0 = blockIdx.x * kBlock;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int rs = H * D;
  const T* qh = q + ((size_t)b * Sq * H + h) * D;
  const T* kh = k + ((size_t)b * Sk * H + h) * D;
  const T* vh = v + ((size_t)b * Sk * H + h) * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, D>(qs, qh, q0, Sq, rs);

  float acc[4][C];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  int nk = (Sk + kBlock - 1) / kBlock;
  if (causal) {
    // Tile j is visible while k_off + 64*j <= q_off + q0 + 63.
    const long long reach = (long long)q_off + q0 + kBlock - 1 - k_off;
    const int last = reach < 0 ? -1 : (int)(reach / kBlock);
    nk = min(nk, last + 1);
  }

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBlock;
    __syncthreads();  // the previous tile's products are done
    load_tile<T, D>(ks, kh, k0, Sk, rs);
    load_tile<T, D>(vs, vh, k0, Sk, rs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * P + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) bb[jj] = ks[(tx + 16 * jj) * P + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(a[i], bb[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_off + q0 + ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kc = k0 + tx + 16 * jj;
        ok[jj] = kc < Sk && (!causal || qpos >= k_off + kc);
        s[i][jj] = ok[jj] ? s[i][jj] * scale : kNegInf;
        mx = fmaxf(mx, s[i][jj]);
      }
      const float m_new = fmaxf(m_i[i], row_max(mx));
      const float corr = expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = ok[jj] ? expf(s[i][jj] - m_new) : 0.f;
        ps[(ty + 16 * i) * PS + tx + 16 * jj] = p;
        sum += p;
      }
      l_i[i] = l_i[i] * corr + row_sum(sum);
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlock; ++kk) {
      float p[4], vv[C];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = vs[kk * P + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float inv = 1.f / (l_i[i] == 0.f ? 1.f : l_i[i]);
    T* orow = o + ((size_t)(b * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) orow[tx + 16 * c] = from_f32<T>(acc[i][c] * inv);
    if (tx == 0) {
      m_out[(size_t)bh * Sq + row] = m_i[i];
      l_out[(size_t)bh * Sq + row] = l_i[i];
    }
  }
}

template <typename T, int D>
cudaError_t run_fwd(const void* q, const void* k, const void* v, void* o,
                    void* m, void* l, int B, int H, int Sq, int Sk,
                    int q_off, int k_off, int causal, cudaStream_t stream) {
  const dim3 grid((Sq + kBlock - 1) / kBlock, B * H);
  return launch(flash_fwd_kernel<T, D>, grid, smem_bytes(D, 3, 1, 0), stream,
                (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)m,
                (float*)l, H, Sq, Sk, q_off, k_off, causal,
                (float)(1.0 / sqrt((double)D)));
}

template <typename T>
cudaError_t fwd_for_dim(int D, const void* q, const void* k, const void* v,
                        void* o, void* m, void* l, int B, int H, int Sq,
                        int Sk, int q_off, int k_off, int causal,
                        cudaStream_t st) {
  switch (D) {
    case 16: return run_fwd<T, 16>(q, k, v, o, m, l, B, H, Sq, Sk, q_off, k_off, causal, st);
    case 32: return run_fwd<T, 32>(q, k, v, o, m, l, B, H, Sq, Sk, q_off, k_off, causal, st);
    case 64: return run_fwd<T, 64>(q, k, v, o, m, l, B, H, Sq, Sk, q_off, k_off, causal, st);
    case 128: return run_fwd<T, 128>(q, k, v, o, m, l, B, H, Sq, Sk, q_off, k_off, causal, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace hvdt

extern "C" int hvdt_flash_fwd(int dtype, const void* q, const void* k,
                              const void* v, void* o, void* m, void* l, int B,
                              int H, int Sq, int Sk, int D, int q_off,
                              int k_off, int causal, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == hvdt::kFloat32)
    return hvdt::fwd_for_dim<float>(D, q, k, v, o, m, l, B, H, Sq, Sk, q_off,
                                    k_off, causal, st);
  if (dtype == hvdt::kBFloat16)
    return hvdt::fwd_for_dim<__nv_bfloat16>(D, q, k, v, o, m, l, B, H, Sq, Sk,
                                            q_off, k_off, causal, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* hvdt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
