// Flash-attention backward for Hopper (sm_90a): the dq kernel and the dk/dv
// kernel, the FlashAttention-2 split.
//
// Replaces the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` (with the
// shared recompute `_recompute_p_ds`) in
// horovod_tpu/parallel/flash_attention.py, launched by `_flash_bwd_bhsd`.
// Same function: for every visible 64x64 tile, recompute
// p = exp(s - lse) and ds = p * (dp - delta) * scale from q, k, v, do and the
// forward's per-row lse (+inf on rows that saw no key, so p is exactly 0
// there) and delta = rowsum(do * o); then
//   dq = sum over kv tiles of ds @ k              (dq kernel)
//   dv = sum over q tiles of p^T @ do,
//   dk = sum over q tiles of ds^T @ q             (dk/dv kernel)
// with fp32 accumulators, written out in the input type.
//
// Design. dq: one block per (q tile, batch*head), looping over kv tiles up
// to the causal bound, like the forward. dk/dv: one block per (kv tile,
// batch*head), looping over q tiles from the first one that can see the kv
// tile. Each output tile is owned by one block, so no atomics and no second
// pass are needed. The dk/dv kernel computes the transposed tiles s^T and
// dp^T directly (rows are keys), so p^T and ds^T reach shared memory
// already in the layout the two products read.
//
// What bounds it on this card. Like the forward, both kernels are bound by
// arithmetic at the main path's shape (per tile, dq does 3 and dk/dv 4
// products where the forward does 2). This first version runs them as fp32
// FMAs from fp32 shared-memory tiles (149 KB for dq and 166 KB for dk/dv
// at D=128, one block per SM), so the fp32 rate is its ceiling; wgmma on
// bf16 tiles is the redesign that removes it.
#include "flash_common.cuh"

namespace hvdt {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int Sq, int Sk, int q_off, int k_off, int causal,
                    float scale) {
  constexpr int P = D + 1;
  constexpr int PS = kBlock + 1;
  constexpr int C = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;               // [64][P]
  float* dos = qs + kBlock * P;   // [64][P]
  float* ks = dos + kBlock * P;   // [64][P]
  float* vs = ks + kBlock * P;    // [64][P]
  float* dss = vs + kBlock * P;   // [64][PS]

  const int q0 = blockIdx.x * kBlock;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int rs = H * D;
  const size_t qhead = ((size_t)b * Sq * H + h) * D;
  const T* kh = k + ((size_t)b * Sk * H + h) * D;
  const T* vh = v + ((size_t)b * Sk * H + h) * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, D>(qs, q + qhead, q0, Sq, rs);
  load_tile<T, D>(dos, dout + qhead, q0, Sq, rs);

  float lse_i[4], delta_i[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_i[i] = row < Sq ? lse[(size_t)bh * Sq + row] : __int_as_float(0x7f800000);
    delta_i[i] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  int nk = (Sk + kBlock - 1) / kBlock;
  if (causal) {
    const long long reach = (long long)q_off + q0 + kBlock - 1 - k_off;
    const int last = reach < 0 ? -1 : (int)(reach / kBlock);
    nk = min(nk, last + 1);
  }

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBlock;
    __syncthreads();
    load_tile<T, D>(ks, kh, k0, Sk, rs);
    load_tile<T, D>(vs, vh, k0, Sk, rs);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[(ty + 16 * i) * P + d];
        g[i] = dos[(ty + 16 * i) * P + d];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        kb[jj] = ks[(tx + 16 * jj) * P + d];
        vb[jj] = vs[(tx + 16 * jj) * P + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          s[i][jj] = fmaf(a[i], kb[jj], s[i][jj]);
          dp[i][jj] = fmaf(g[i], vb[jj], dp[i][jj]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_off + q0 + ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kc = k0 + tx + 16 * jj;
        const bool ok = kc < Sk && (!causal || qpos >= k_off + kc);
        const float p = ok ? expf(s[i][jj] * scale - lse_i[i]) : 0.f;
        dss[(ty + 16 * i) * PS + tx + 16 * jj] =
            p * (dp[i][jj] - delta_i[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlock; ++kk) {
      float ds[4], kv[C];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dss[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int c = 0; c < C; ++c) kv[c] = ks[kk * P + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(ds[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    T* out = dq + ((size_t)(b * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) out[tx + 16 * c] = from_f32<T>(acc[i][c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Sq, int Sk, int q_off,
                     int k_off, int causal, float scale) {
  constexpr int P = D + 1;
  constexpr int PS = kBlock + 1;
  constexpr int C = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;               // [64][P]
  float* vs = ks + kBlock * P;    // [64][P]
  float* qs = vs + kBlock * P;    // [64][P]
  float* dos = qs + kBlock * P;   // [64][P]
  float* pts = dos + kBlock * P;  // [64 keys][PS]  p^T
  float* dsts = pts + kBlock * PS;  // [64 keys][PS]  ds^T
  float* lse_s = dsts + kBlock * PS;  // [64]
  float* delta_s = lse_s + kBlock;    // [64]

  const int k0 = blockIdx.x * kBlock;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int rs = H * D;
  const size_t qhead = ((size_t)b * Sq * H + h) * D;
  const size_t khead = ((size_t)b * Sk * H + h) * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, D>(ks, k + khead, k0, Sk, rs);
  load_tile<T, D>(vs, v + khead, k0, Sk, rs);

  float dk_acc[4][C], dv_acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int nq = (Sq + kBlock - 1) / kBlock;
  int first = 0;
  if (causal) {
    // q tile t sees this kv tile once q_off + 64*t + 63 >= k_off + k0.
    const long long need = (long long)k_off + k0 - q_off - (kBlock - 1);
    first = need <= 0 ? 0 : (int)((need + kBlock - 1) / kBlock);
  }

  for (int t = first; t < nq; ++t) {
    const int q0 = t * kBlock;
    __syncthreads();
    load_tile<T, D>(qs, q + qhead, q0, Sq, rs);
    load_tile<T, D>(dos, dout + qhead, q0, Sq, rs);
    if (threadIdx.x < kBlock) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] =
          row < Sq ? lse[(size_t)bh * Sq + row] : __int_as_float(0x7f800000);
      delta_s[threadIdx.x] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
    }
    __syncthreads();

    // Transposed tiles: rows are keys (ty + 16*i), columns queries.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float ka[4], va[4], qb[4], gb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ka[i] = ks[(ty + 16 * i) * P + d];
        va[i] = vs[(ty + 16 * i) * P + d];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        qb[jj] = qs[(tx + 16 * jj) * P + d];
        gb[jj] = dos[(tx + 16 * jj) * P + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          s[i][jj] = fmaf(ka[i], qb[jj], s[i][jj]);
          dp[i][jj] = fmaf(va[i], gb[jj], dp[i][jj]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kpos = k_off + k0 + ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int qc = tx + 16 * jj;
        const bool ok = q0 + qc < Sq && (!causal || q_off + q0 + qc >= kpos);
        const float p = ok ? expf(s[i][jj] * scale - lse_s[qc]) : 0.f;
        pts[(ty + 16 * i) * PS + qc] = p;
        dsts[(ty + 16 * i) * PS + qc] = p * (dp[i][jj] - delta_s[qc]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < kBlock; ++qq) {
      float pt[4], dst[4], gv[C], qv[C];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pt[i] = pts[(ty + 16 * i) * PS + qq];
        dst[i] = dsts[(ty + 16 * i) * PS + qq];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        gv[c] = dos[qq * P + tx + 16 * c];
        qv[c] = qs[qq * P + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dv_acc[i][c] = fmaf(pt[i], gv[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dst[i], qv[c], dk_acc[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= Sk) continue;
    const size_t off = ((size_t)(b * Sk + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dk[off + tx + 16 * c] = from_f32<T>(dk_acc[i][c]);
      dv[off + tx + 16 * c] = from_f32<T>(dv_acc[i][c]);
    }
  }
}

template <typename T, int D>
cudaError_t run_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int B, int H, int Sq, int Sk, int q_off,
                   int k_off, int causal, cudaStream_t stream) {
  const dim3 grid((Sq + kBlock - 1) / kBlock, B * H);
  return launch(flash_dq_kernel<T, D>, grid, smem_bytes(D, 4, 1, 0), stream,
                (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                (const float*)lse, (const float*)delta, (T*)dq, H, Sq, Sk,
                q_off, k_off, causal, (float)(1.0 / sqrt((double)D)));
}

template <typename T, int D>
cudaError_t run_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int B, int H, int Sq, int Sk,
                    int q_off, int k_off, int causal, cudaStream_t stream) {
  const dim3 grid((Sk + kBlock - 1) / kBlock, B * H);
  return launch(flash_dkv_kernel<T, D>, grid,
                smem_bytes(D, 4, 2, 2 * kBlock), stream, (const T*)q,
                (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
                (const float*)delta, (T*)dk, (T*)dv, H, Sq, Sk, q_off, k_off,
                causal, (float)(1.0 / sqrt((double)D)));
}

template <typename T>
cudaError_t dq_for_dim(int D, const void* q, const void* k, const void* v,
                       const void* g, const void* lse, const void* delta,
                       void* dq, int B, int H, int Sq, int Sk, int qo, int ko,
                       int causal, cudaStream_t st) {
  switch (D) {
    case 16: return run_dq<T, 16>(q, k, v, g, lse, delta, dq, B, H, Sq, Sk, qo, ko, causal, st);
    case 32: return run_dq<T, 32>(q, k, v, g, lse, delta, dq, B, H, Sq, Sk, qo, ko, causal, st);
    case 64: return run_dq<T, 64>(q, k, v, g, lse, delta, dq, B, H, Sq, Sk, qo, ko, causal, st);
    case 128: return run_dq<T, 128>(q, k, v, g, lse, delta, dq, B, H, Sq, Sk, qo, ko, causal, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dkv_for_dim(int D, const void* q, const void* k, const void* v,
                        const void* g, const void* lse, const void* delta,
                        void* dk, void* dv, int B, int H, int Sq, int Sk,
                        int qo, int ko, int causal, cudaStream_t st) {
  switch (D) {
    case 16: return run_dkv<T, 16>(q, k, v, g, lse, delta, dk, dv, B, H, Sq, Sk, qo, ko, causal, st);
    case 32: return run_dkv<T, 32>(q, k, v, g, lse, delta, dk, dv, B, H, Sq, Sk, qo, ko, causal, st);
    case 64: return run_dkv<T, 64>(q, k, v, g, lse, delta, dk, dv, B, H, Sq, Sk, qo, ko, causal, st);
    case 128: return run_dkv<T, 128>(q, k, v, g, lse, delta, dk, dv, B, H, Sq, Sk, qo, ko, causal, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace hvdt

extern "C" int hvdt_flash_dq(int dtype, const void* q, const void* k,
                             const void* v, const void* dout, const void* lse,
                             const void* delta, void* dq, int B, int H, int Sq,
                             int Sk, int D, int q_off, int k_off, int causal,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == hvdt::kFloat32)
    return hvdt::dq_for_dim<float>(D, q, k, v, dout, lse, delta, dq, B, H, Sq,
                                   Sk, q_off, k_off, causal, st);
  if (dtype == hvdt::kBFloat16)
    return hvdt::dq_for_dim<__nv_bfloat16>(D, q, k, v, dout, lse, delta, dq, B,
                                           H, Sq, Sk, q_off, k_off, causal, st);
  return cudaErrorInvalidValue;
}

extern "C" int hvdt_flash_dkv(int dtype, const void* q, const void* k,
                              const void* v, const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int B,
                              int H, int Sq, int Sk, int D, int q_off,
                              int k_off, int causal, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == hvdt::kFloat32)
    return hvdt::dkv_for_dim<float>(D, q, k, v, dout, lse, delta, dk, dv, B,
                                    H, Sq, Sk, q_off, k_off, causal, st);
  if (dtype == hvdt::kBFloat16)
    return hvdt::dkv_for_dim<__nv_bfloat16>(D, q, k, v, dout, lse, delta, dk,
                                            dv, B, H, Sq, Sk, q_off, k_off,
                                            causal, st);
  return cudaErrorInvalidValue;
}
