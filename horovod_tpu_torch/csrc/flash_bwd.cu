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
// at D=128, one block per SM), so the fp32 rate is its ceiling. For bf16
// and fp16 at head dims 33 to 256, flash_dkv_sm90.cu and flash_dq_sm90.cu
// (wgmma on 16-bit tiles fed by TMA) replace both kernels; these serve
// the rest: fp32 (at the head dims 16, 32, 64, 96, 128, 256, 384, 512),
// 16-bit inputs at D 16 and 32 and 384 and 512, and any multiple of 64
// past 512 (the wrapper zero-pads any other D to the next of these and
// passes the scale of the true D).
//
// Past D = 128 the tile a block owns (q rows for dq, key rows for dk/dv)
// shrinks from 64 to 32 rows (owned_rows in flash_common.cuh), the analog
// of the reference's _ladders_for: at D = 256 four 64-row fp32 tiles and
// the score tile(s) would need 280 KB (dq) and 297 KB (dk/dv) of shared
// memory, above the 227 KB a block may opt into; with the owned tiles at
// 32 rows they need 206 KB and 214 KB. The tiles the loop walks stay at 64
// rows, so a score tile is 32 x 64 there and each thread owns two of its
// rows. Keeping 16-bit tiles in their own type would not have sufficed:
// fp32 inputs at D = 256 still need the smaller tile. At D 384 and 512
// the owned tile is 16 rows and the loop's tiles 32 (199 KB for dq and
// 201 KB for dk/dv at D 512): each thread owns one row and two columns
// of a 16 x 32 score tile. Past D 512 the *_chunked kernels split the
// head dim into 64-column chunks (flash_common.cuh works the bytes out).
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
  constexpr int C = D / 16;
  constexpr int R = owned_rows<D>();
  constexpr int RI = R / 16;
  constexpr int KB = loop_rows<D>();
  constexpr int KJ = KB / 16;
  constexpr int PS = KB + 1;
  extern __shared__ float smem[];
  float* qs = smem;               // [R][P]
  float* dos = qs + R * P;        // [R][P]
  float* ks = dos + R * P;        // [KB][P]
  float* vs = ks + KB * P;        // [KB][P]
  float* dss = vs + KB * P;       // [R][PS]

  const int q0 = blockIdx.x * R;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int rs = H * D;
  const size_t qhead = ((size_t)b * Sq * H + h) * D;
  const T* kh = k + ((size_t)b * Sk * H + h) * D;
  const T* vh = v + ((size_t)b * Sk * H + h) * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, D, R>(qs, q + qhead, q0, Sq, rs);
  load_tile<T, D, R>(dos, dout + qhead, q0, Sq, rs);

  float lse_i[RI], delta_i[RI], acc[RI][C];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_i[i] = row < Sq ? lse[(size_t)bh * Sq + row] : __int_as_float(0x7f800000);
    delta_i[i] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  int nk = (Sk + KB - 1) / KB;
  if (causal) {
    const long long reach = (long long)q_off + q0 + R - 1 - k_off;
    const int last = reach < 0 ? -1 : (int)(reach / KB);
    nk = min(nk, last + 1);
  }

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * KB;
    __syncthreads();
    load_tile<T, D, KB>(ks, kh, k0, Sk, rs);
    load_tile<T, D, KB>(vs, vh, k0, Sk, rs);
    __syncthreads();

    float s[RI][KJ], dp[RI][KJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RI], g[RI], kb[KJ], vb[KJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        a[i] = qs[(ty + 16 * i) * P + d];
        g[i] = dos[(ty + 16 * i) * P + d];
      }
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj) {
        kb[jj] = ks[(tx + 16 * jj) * P + d];
        vb[jj] = vs[(tx + 16 * jj) * P + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int jj = 0; jj < KJ; ++jj) {
          s[i][jj] = fmaf(a[i], kb[jj], s[i][jj]);
          dp[i][jj] = fmaf(g[i], vb[jj], dp[i][jj]);
        }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q_off + q0 + ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj) {
        const int kc = k0 + tx + 16 * jj;
        const bool ok = kc < Sk && (!causal || qpos >= k_off + kc);
        const float p = ok ? expf(s[i][jj] * scale - lse_i[i]) : 0.f;
        dss[(ty + 16 * i) * PS + tx + 16 * jj] =
            p * (dp[i][jj] - delta_i[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < KB; ++kk) {
      float ds[RI], kv[C];
#pragma unroll
      for (int i = 0; i < RI; ++i) ds[i] = dss[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int c = 0; c < C; ++c) kv[c] = ks[kk * P + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(ds[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
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
  constexpr int C = D / 16;
  constexpr int R = owned_rows<D>();
  constexpr int RI = R / 16;
  constexpr int KB = loop_rows<D>();
  constexpr int KJ = KB / 16;
  constexpr int PS = KB + 1;
  extern __shared__ float smem[];
  float* ks = smem;               // [R][P]
  float* vs = ks + R * P;         // [R][P]
  float* qs = vs + R * P;         // [KB][P]
  float* dos = qs + KB * P;       // [KB][P]
  float* pts = dos + KB * P;      // [R keys][PS]  p^T
  float* dsts = pts + R * PS;     // [R keys][PS]  ds^T
  float* lse_s = dsts + R * PS;   // [KB]
  float* delta_s = lse_s + KB;    // [KB]

  const int k0 = blockIdx.x * R;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int rs = H * D;
  const size_t qhead = ((size_t)b * Sq * H + h) * D;
  const size_t khead = ((size_t)b * Sk * H + h) * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, D, R>(ks, k + khead, k0, Sk, rs);
  load_tile<T, D, R>(vs, v + khead, k0, Sk, rs);

  float dk_acc[RI][C], dv_acc[RI][C];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int nq = (Sq + KB - 1) / KB;
  int first = 0;
  if (causal) {
    // q tile t sees this kv tile once q_off + KB*t + KB - 1 >= k_off + k0.
    const long long need = (long long)k_off + k0 - q_off - (KB - 1);
    first = need <= 0 ? 0 : (int)((need + KB - 1) / KB);
  }

  for (int t = first; t < nq; ++t) {
    const int q0 = t * KB;
    __syncthreads();
    load_tile<T, D, KB>(qs, q + qhead, q0, Sq, rs);
    load_tile<T, D, KB>(dos, dout + qhead, q0, Sq, rs);
    if (threadIdx.x < KB) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] =
          row < Sq ? lse[(size_t)bh * Sq + row] : __int_as_float(0x7f800000);
      delta_s[threadIdx.x] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
    }
    __syncthreads();

    // Transposed tiles: rows are keys (ty + 16*i), columns queries.
    float s[RI][KJ], dp[RI][KJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float ka[RI], va[RI], qb[KJ], gb[KJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        ka[i] = ks[(ty + 16 * i) * P + d];
        va[i] = vs[(ty + 16 * i) * P + d];
      }
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj) {
        qb[jj] = qs[(tx + 16 * jj) * P + d];
        gb[jj] = dos[(tx + 16 * jj) * P + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int jj = 0; jj < KJ; ++jj) {
          s[i][jj] = fmaf(ka[i], qb[jj], s[i][jj]);
          dp[i][jj] = fmaf(va[i], gb[jj], dp[i][jj]);
        }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int kpos = k_off + k0 + ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj) {
        const int qc = tx + 16 * jj;
        const bool ok = q0 + qc < Sq && (!causal || q_off + q0 + qc >= kpos);
        const float p = ok ? expf(s[i][jj] * scale - lse_s[qc]) : 0.f;
        pts[(ty + 16 * i) * PS + qc] = p;
        dsts[(ty + 16 * i) * PS + qc] = p * (dp[i][jj] - delta_s[qc]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < KB; ++qq) {
      float pt[RI], dst[RI], gv[C], qv[C];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        pt[i] = pts[(ty + 16 * i) * PS + qq];
        dst[i] = dsts[(ty + 16 * i) * PS + qq];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        gv[c] = dos[qq * P + tx + 16 * c];
        qv[c] = qs[qq * P + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dv_acc[i][c] = fmaf(pt[i], gv[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dst[i], qv[c], dk_acc[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
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

// Past D 512: one block per (64-row tile it owns, batch*head, 64-column
// chunk of the head dim). s and dp stream over D through chunk tiles; the
// block accumulates only its chunk of dq, or of dk and dv
// (flash_common.cuh, Tiling).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_dq_chunked_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dq, int H, int Sq, int Sk, int D,
                            int q_off, int k_off, int causal, float scale) {
  constexpr int P = kChunk + 1;
  constexpr int C = kChunk / 16;
  constexpr int R = kBlock;
  constexpr int RI = R / 16;
  constexpr int KB = kBlock;
  constexpr int KJ = KB / 16;
  constexpr int PS = KB + 1;
  extern __shared__ float smem[];
  float* qs = smem;               // [R][P]  chunks of the q tile
  float* dos = qs + R * P;        // [R][P]
  float* ks = dos + R * P;        // [KB][P] chunks of the kv tile
  float* vs = ks + KB * P;        // [KB][P]
  float* dss = vs + KB * P;       // [R][PS]

  const int q0 = blockIdx.x * R;
  const int bh = blockIdx.y;
  const int d0 = blockIdx.z * kChunk;
  const int b = bh / H, h = bh % H;
  const int rs = H * D;
  const size_t qhead = ((size_t)b * Sq * H + h) * D;
  const T* kh = k + ((size_t)b * Sk * H + h) * D;
  const T* vh = v + ((size_t)b * Sk * H + h) * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float lse_i[RI], delta_i[RI], acc[RI][C];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_i[i] = row < Sq ? lse[(size_t)bh * Sq + row] : __int_as_float(0x7f800000);
    delta_i[i] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  int nk = (Sk + KB - 1) / KB;
  if (causal) {
    const long long reach = (long long)q_off + q0 + R - 1 - k_off;
    const int last = reach < 0 ? -1 : (int)(reach / KB);
    nk = min(nk, last + 1);
  }

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * KB;
    float s[RI][KJ], dp[RI][KJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj) s[i][jj] = dp[i][jj] = 0.f;
    for (int dc = 0; dc < D; dc += kChunk) {
      __syncthreads();
      load_tile<T, kChunk, R>(qs, q + qhead + dc, q0, Sq, rs);
      load_tile<T, kChunk, R>(dos, dout + qhead + dc, q0, Sq, rs);
      load_tile<T, kChunk, KB>(ks, kh + dc, k0, Sk, rs);
      load_tile<T, kChunk, KB>(vs, vh + dc, k0, Sk, rs);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < kChunk; ++d) {
        float a[RI], g[RI], kb[KJ], vb[KJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          a[i] = qs[(ty + 16 * i) * P + d];
          g[i] = dos[(ty + 16 * i) * P + d];
        }
#pragma unroll
        for (int jj = 0; jj < KJ; ++jj) {
          kb[jj] = ks[(tx + 16 * jj) * P + d];
          vb[jj] = vs[(tx + 16 * jj) * P + d];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int jj = 0; jj < KJ; ++jj) {
            s[i][jj] = fmaf(a[i], kb[jj], s[i][jj]);
            dp[i][jj] = fmaf(g[i], vb[jj], dp[i][jj]);
          }
      }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q_off + q0 + ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj) {
        const int kc = k0 + tx + 16 * jj;
        const bool ok = kc < Sk && (!causal || qpos >= k_off + kc);
        const float p = ok ? expf(s[i][jj] * scale - lse_i[i]) : 0.f;
        dss[(ty + 16 * i) * PS + tx + 16 * jj] =
            p * (dp[i][jj] - delta_i[i]) * scale;
      }
    }
    __syncthreads();  // dss is whole; the last chunk's reads of ks are done
    load_tile<T, kChunk, KB>(ks, kh + d0, k0, Sk, rs);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < KB; ++kk) {
      float ds[RI], kv[C];
#pragma unroll
      for (int i = 0; i < RI; ++i) ds[i] = dss[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int c = 0; c < C; ++c) kv[c] = ks[kk * P + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(ds[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    T* out = dq + ((size_t)(b * Sq + row) * H + h) * D + d0;
#pragma unroll
    for (int c = 0; c < C; ++c) out[tx + 16 * c] = from_f32<T>(acc[i][c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_chunked_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             T* __restrict__ dk, T* __restrict__ dv, int H,
                             int Sq, int Sk, int D, int q_off, int k_off,
                             int causal, float scale) {
  constexpr int P = kChunk + 1;
  constexpr int C = kChunk / 16;
  constexpr int R = kBlock;
  constexpr int RI = R / 16;
  constexpr int KB = kBlock;
  constexpr int KJ = KB / 16;
  constexpr int PS = KB + 1;
  extern __shared__ float smem[];
  float* ks = smem;               // [R][P]  chunks of this block's keys
  float* vs = ks + R * P;         // [R][P]
  float* qs = vs + R * P;         // [KB][P] chunks of the q tile
  float* dos = qs + KB * P;       // [KB][P]
  float* pts = dos + KB * P;      // [R keys][PS]  p^T
  float* dsts = pts + R * PS;     // [R keys][PS]  ds^T
  float* lse_s = dsts + R * PS;   // [KB]
  float* delta_s = lse_s + KB;    // [KB]

  const int k0 = blockIdx.x * R;
  const int bh = blockIdx.y;
  const int d0 = blockIdx.z * kChunk;
  const int b = bh / H, h = bh % H;
  const int rs = H * D;
  const size_t qhead = ((size_t)b * Sq * H + h) * D;
  const size_t khead = ((size_t)b * Sk * H + h) * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float dk_acc[RI][C], dv_acc[RI][C];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int nq = (Sq + KB - 1) / KB;
  int first = 0;
  if (causal) {
    const long long need = (long long)k_off + k0 - q_off - (KB - 1);
    first = need <= 0 ? 0 : (int)((need + KB - 1) / KB);
  }

  for (int t = first; t < nq; ++t) {
    const int q0 = t * KB;
    float s[RI][KJ], dp[RI][KJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj) s[i][jj] = dp[i][jj] = 0.f;
    for (int dc = 0; dc < D; dc += kChunk) {
      __syncthreads();
      load_tile<T, kChunk, R>(ks, k + khead + dc, k0, Sk, rs);
      load_tile<T, kChunk, R>(vs, v + khead + dc, k0, Sk, rs);
      load_tile<T, kChunk, KB>(qs, q + qhead + dc, q0, Sq, rs);
      load_tile<T, kChunk, KB>(dos, dout + qhead + dc, q0, Sq, rs);
      if (dc == 0 && threadIdx.x < KB) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] =
            row < Sq ? lse[(size_t)bh * Sq + row] : __int_as_float(0x7f800000);
        delta_s[threadIdx.x] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
      }
      __syncthreads();
      // Transposed tiles: rows are keys (ty + 16*i), columns queries.
#pragma unroll 4
      for (int d = 0; d < kChunk; ++d) {
        float ka[RI], va[RI], qb[KJ], gb[KJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          ka[i] = ks[(ty + 16 * i) * P + d];
          va[i] = vs[(ty + 16 * i) * P + d];
        }
#pragma unroll
        for (int jj = 0; jj < KJ; ++jj) {
          qb[jj] = qs[(tx + 16 * jj) * P + d];
          gb[jj] = dos[(tx + 16 * jj) * P + d];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int jj = 0; jj < KJ; ++jj) {
            s[i][jj] = fmaf(ka[i], qb[jj], s[i][jj]);
            dp[i][jj] = fmaf(va[i], gb[jj], dp[i][jj]);
          }
      }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int kpos = k_off + k0 + ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj) {
        const int qc = tx + 16 * jj;
        const bool ok = q0 + qc < Sq && (!causal || q_off + q0 + qc >= kpos);
        const float p = ok ? expf(s[i][jj] * scale - lse_s[qc]) : 0.f;
        pts[(ty + 16 * i) * PS + qc] = p;
        dsts[(ty + 16 * i) * PS + qc] = p * (dp[i][jj] - delta_s[qc]) * scale;
      }
    }
    __syncthreads();  // p^T, ds^T whole; the last chunk's reads are done
    load_tile<T, kChunk, KB>(qs, q + qhead + d0, q0, Sq, rs);
    load_tile<T, kChunk, KB>(dos, dout + qhead + d0, q0, Sq, rs);
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < KB; ++qq) {
      float pt[RI], dst[RI], gv[C], qv[C];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        pt[i] = pts[(ty + 16 * i) * PS + qq];
        dst[i] = dsts[(ty + 16 * i) * PS + qq];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        gv[c] = dos[qq * P + tx + 16 * c];
        qv[c] = qs[qq * P + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dv_acc[i][c] = fmaf(pt[i], gv[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dst[i], qv[c], dk_acc[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= Sk) continue;
    const size_t off = ((size_t)(b * Sk + row) * H + h) * D + d0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dk[off + tx + 16 * c] = from_f32<T>(dk_acc[i][c]);
      dv[off + tx + 16 * c] = from_f32<T>(dv_acc[i][c]);
    }
  }
}

template <typename T>
cudaError_t run_dq_chunked(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int B, int H, int Sq,
                           int Sk, int D, int q_off, int k_off, int causal,
                           float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes(kChunk, 2, 2, 1, 0);
  static_assert(bytes <= kMaxSmem, "dq chunk tiles exceed shared memory");
  const dim3 grid((Sq + kBlock - 1) / kBlock, B * H, D / kChunk);
  return launch(flash_dq_chunked_kernel<T>, grid, bytes, stream, (const T*)q,
                (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
                (const float*)delta, (T*)dq, H, Sq, Sk, D, q_off, k_off,
                causal, scale);
}

template <typename T>
cudaError_t run_dkv_chunked(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int B,
                            int H, int Sq, int Sk, int D, int q_off,
                            int k_off, int causal, float scale,
                            cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes(kChunk, 2, 2, 2, 2 * kBlock);
  static_assert(bytes <= kMaxSmem, "dk/dv chunk tiles exceed shared memory");
  const dim3 grid((Sk + kBlock - 1) / kBlock, B * H, D / kChunk);
  return launch(flash_dkv_chunked_kernel<T>, grid, bytes, stream,
                (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, H,
                Sq, Sk, D, q_off, k_off, causal, scale);
}

template <typename T, int D>
cudaError_t run_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int B, int H, int Sq, int Sk, int q_off,
                   int k_off, int causal, float scale, cudaStream_t stream) {
  constexpr int R = owned_rows<D>();
  constexpr size_t bytes = smem_bytes(D, 2, 2, 1, 0, R, loop_rows<D>());
  static_assert(bytes <= kMaxSmem, "dq tiles exceed shared memory");
  const dim3 grid((Sq + R - 1) / R, B * H);
  return launch(flash_dq_kernel<T, D>, grid, bytes, stream, (const T*)q,
                (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
                (const float*)delta, (T*)dq, H, Sq, Sk, q_off, k_off, causal,
                scale);
}

template <typename T, int D>
cudaError_t run_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int B, int H, int Sq, int Sk,
                    int q_off, int k_off, int causal, float scale,
                    cudaStream_t stream) {
  constexpr int R = owned_rows<D>();
  constexpr int KB = loop_rows<D>();
  constexpr size_t bytes = smem_bytes(D, 2, 2, 2, 2 * KB, R, KB);
  static_assert(bytes <= kMaxSmem, "dk/dv tiles exceed shared memory");
  const dim3 grid((Sk + R - 1) / R, B * H);
  return launch(flash_dkv_kernel<T, D>, grid, bytes, stream, (const T*)q,
                (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
                (const float*)delta, (T*)dk, (T*)dv, H, Sq, Sk, q_off, k_off,
                causal, scale);
}

template <typename T>
cudaError_t dq_for_dim(int D, const void* q, const void* k, const void* v,
                       const void* g, const void* lse, const void* delta,
                       void* dq, int B, int H, int Sq, int Sk, int qo, int ko,
                       int causal, float sc, cudaStream_t st) {
  switch (D) {
    case 16: return run_dq<T, 16>(q, k, v, g, lse, delta, dq, B, H, Sq, Sk, qo, ko, causal, sc, st);
    case 32: return run_dq<T, 32>(q, k, v, g, lse, delta, dq, B, H, Sq, Sk, qo, ko, causal, sc, st);
    case 64: return run_dq<T, 64>(q, k, v, g, lse, delta, dq, B, H, Sq, Sk, qo, ko, causal, sc, st);
    case 96: return run_dq<T, 96>(q, k, v, g, lse, delta, dq, B, H, Sq, Sk, qo, ko, causal, sc, st);
    case 128: return run_dq<T, 128>(q, k, v, g, lse, delta, dq, B, H, Sq, Sk, qo, ko, causal, sc, st);
    case 256: return run_dq<T, 256>(q, k, v, g, lse, delta, dq, B, H, Sq, Sk, qo, ko, causal, sc, st);
    case 384: return run_dq<T, 384>(q, k, v, g, lse, delta, dq, B, H, Sq, Sk, qo, ko, causal, sc, st);
    case 512: return run_dq<T, 512>(q, k, v, g, lse, delta, dq, B, H, Sq, Sk, qo, ko, causal, sc, st);
    default:
      if (D > 512 && D % kChunk == 0)
        return run_dq_chunked<T>(q, k, v, g, lse, delta, dq, B, H, Sq, Sk, D,
                                 qo, ko, causal, sc, st);
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dkv_for_dim(int D, const void* q, const void* k, const void* v,
                        const void* g, const void* lse, const void* delta,
                        void* dk, void* dv, int B, int H, int Sq, int Sk,
                        int qo, int ko, int causal, float sc,
                        cudaStream_t st) {
  switch (D) {
    case 16: return run_dkv<T, 16>(q, k, v, g, lse, delta, dk, dv, B, H, Sq, Sk, qo, ko, causal, sc, st);
    case 32: return run_dkv<T, 32>(q, k, v, g, lse, delta, dk, dv, B, H, Sq, Sk, qo, ko, causal, sc, st);
    case 64: return run_dkv<T, 64>(q, k, v, g, lse, delta, dk, dv, B, H, Sq, Sk, qo, ko, causal, sc, st);
    case 96: return run_dkv<T, 96>(q, k, v, g, lse, delta, dk, dv, B, H, Sq, Sk, qo, ko, causal, sc, st);
    case 128: return run_dkv<T, 128>(q, k, v, g, lse, delta, dk, dv, B, H, Sq, Sk, qo, ko, causal, sc, st);
    case 256: return run_dkv<T, 256>(q, k, v, g, lse, delta, dk, dv, B, H, Sq, Sk, qo, ko, causal, sc, st);
    case 384: return run_dkv<T, 384>(q, k, v, g, lse, delta, dk, dv, B, H, Sq, Sk, qo, ko, causal, sc, st);
    case 512: return run_dkv<T, 512>(q, k, v, g, lse, delta, dk, dv, B, H, Sq, Sk, qo, ko, causal, sc, st);
    default:
      if (D > 512 && D % kChunk == 0)
        return run_dkv_chunked<T>(q, k, v, g, lse, delta, dk, dv, B, H, Sq,
                                  Sk, D, qo, ko, causal, sc, st);
      return cudaErrorInvalidValue;
  }
}

}  // namespace hvdt

extern "C" int hvdt_flash_dq(int dtype, const void* q, const void* k,
                             const void* v, const void* dout, const void* lse,
                             const void* delta, void* dq, int B, int H, int Sq,
                             int Sk, int D, int q_off, int k_off, int causal,
                             float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == hvdt::kFloat32)
    return hvdt::dq_for_dim<float>(D, q, k, v, dout, lse, delta, dq, B, H, Sq,
                                   Sk, q_off, k_off, causal, scale, st);
  if (dtype == hvdt::kBFloat16)
    return hvdt::dq_for_dim<__nv_bfloat16>(D, q, k, v, dout, lse, delta, dq, B,
                                           H, Sq, Sk, q_off, k_off, causal,
                                           scale, st);
  if (dtype == hvdt::kFloat16)
    return hvdt::dq_for_dim<__half>(D, q, k, v, dout, lse, delta, dq, B, H, Sq,
                                    Sk, q_off, k_off, causal, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" int hvdt_flash_dkv(int dtype, const void* q, const void* k,
                              const void* v, const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int B,
                              int H, int Sq, int Sk, int D, int q_off,
                              int k_off, int causal, float scale,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == hvdt::kFloat32)
    return hvdt::dkv_for_dim<float>(D, q, k, v, dout, lse, delta, dk, dv, B,
                                    H, Sq, Sk, q_off, k_off, causal, scale,
                                    st);
  if (dtype == hvdt::kBFloat16)
    return hvdt::dkv_for_dim<__nv_bfloat16>(D, q, k, v, dout, lse, delta, dk,
                                            dv, B, H, Sq, Sk, q_off, k_off,
                                            causal, scale, st);
  if (dtype == hvdt::kFloat16)
    return hvdt::dkv_for_dim<__half>(D, q, k, v, dout, lse, delta, dk, dv, B,
                                     H, Sq, Sk, q_off, k_off, causal, scale,
                                     st);
  return cudaErrorInvalidValue;
}
