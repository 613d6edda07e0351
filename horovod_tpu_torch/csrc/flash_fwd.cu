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
// flash_fwd_sm90.cu is the redesign that closes that gap (wgmma on bf16
// tiles fed by TMA) for bf16 and fp16 at head dims 33 to 512, and
// flash_fwd_stream_sm90.cu for 16-bit head dims past 512 and fp32 past 32
// (3xTF32); the dispatcher sends this kernel only D 16 and 32, and the
// card's checks run it beside the tensor-core kernels at every head dim
// (the wrapper zero-pads any other D to the next built one and passes
// the scale of the true D). At D = 256 its three [64][257]
// tiles and the score tile take 209 KB of shared memory, within
// the 227 KB a block may have, so the forward keeps its 64-row tiles
// there; at D 384 and 512 it owns 32 q rows and walks 32-key tiles (201
// KB at D 512); past D 512 it splits the head dim into 64-column chunks
// (flash_fwd_chunked_kernel; flash_common.cuh works the bytes out).
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
  constexpr int R = fwd_rows<D>();
  constexpr int KB = loop_rows<D>();
  constexpr int RI = R / 16;
  constexpr int KJ = KB / 16;
  constexpr int PS = KB + 1;
  constexpr int C = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;               // [R][P]
  float* ks = qs + R * P;         // [KB][P]
  float* vs = ks + KB * P;        // [KB][P]
  float* ps = vs + KB * P;        // [R][PS]

  const int q0 = blockIdx.x * R;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int rs = H * D;
  const T* qh = q + ((size_t)b * Sq * H + h) * D;
  const T* kh = k + ((size_t)b * Sk * H + h) * D;
  const T* vh = v + ((size_t)b * Sk * H + h) * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, D, R>(qs, qh, q0, Sq, rs);

  float acc[RI][C];
  float m_i[RI], l_i[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  int nk = (Sk + KB - 1) / KB;
  if (causal) {
    // Tile j is visible while k_off + KB*j <= q_off + q0 + R - 1.
    const long long reach = (long long)q_off + q0 + R - 1 - k_off;
    const int last = reach < 0 ? -1 : (int)(reach / KB);
    nk = min(nk, last + 1);
  }

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * KB;
    __syncthreads();  // the previous tile's products are done
    load_tile<T, D, KB>(ks, kh, k0, Sk, rs);
    load_tile<T, D, KB>(vs, vh, k0, Sk, rs);
    __syncthreads();

    float s[RI][KJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj) s[i][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[RI], bb[KJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = qs[(ty + 16 * i) * P + d];
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj) bb[jj] = ks[(tx + 16 * jj) * P + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int jj = 0; jj < KJ; ++jj) s[i][jj] = fmaf(a[i], bb[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q_off + q0 + ty + 16 * i;
      bool ok[KJ];
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj) {
        const int kc = k0 + tx + 16 * jj;
        ok[jj] = kc < Sk && (!causal || qpos >= k_off + kc);
        s[i][jj] = ok[jj] ? s[i][jj] * scale : kNegInf;
        mx = fmaxf(mx, s[i][jj]);
      }
      const float m_new = fmaxf(m_i[i], row_max(mx));
      const float corr = expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj) {
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
    for (int kk = 0; kk < KB; ++kk) {
      float p[RI], vv[C];
#pragma unroll
      for (int i = 0; i < RI; ++i) p[i] = ps[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = vs[kk * P + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
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
                    int q_off, int k_off, int causal, float scale,
                    cudaStream_t stream) {
  constexpr int R = fwd_rows<D>();
  constexpr int KB = loop_rows<D>();
  constexpr size_t bytes = smem_bytes(D, 2, 1, 1, 0, R, KB);
  static_assert(bytes <= kMaxSmem, "forward tiles exceed shared memory");
  const dim3 grid((Sq + R - 1) / R, B * H);
  return launch(flash_fwd_kernel<T, D>, grid, bytes, stream, (const T*)q,
                (const T*)k, (const T*)v, (T*)o, (float*)m, (float*)l, H, Sq,
                Sk, q_off, k_off, causal, scale);
}

// Past D 512: one block per (64-row q tile, batch*head, 64-column chunk of
// the head dim); the logits stream over D through chunk tiles, and the
// block accumulates only its chunk of o (flash_common.cuh, Tiling).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_chunked_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ o,
                             float* __restrict__ m_out,
                             float* __restrict__ l_out, int H, int Sq, int Sk,
                             int D, int q_off, int k_off, int causal,
                             float scale) {
  constexpr int P = kChunk + 1;
  constexpr int R = kBlock;
  constexpr int KB = kBlock;
  constexpr int RI = R / 16;
  constexpr int KJ = KB / 16;
  constexpr int PS = KB + 1;
  constexpr int C = kChunk / 16;
  extern __shared__ float smem[];
  float* qs = smem;               // [R][P]  a chunk of the q tile
  float* ks = qs + R * P;         // [KB][P] the same chunk of the keys
  float* vs = ks + KB * P;        // [KB][P] this block's chunk of the values
  float* ps = vs + KB * P;        // [R][PS]

  const int q0 = blockIdx.x * R;
  const int bh = blockIdx.y;
  const int d0 = blockIdx.z * kChunk;
  const int b = bh / H, h = bh % H;
  const int rs = H * D;
  const T* qh = q + ((size_t)b * Sq * H + h) * D;
  const T* kh = k + ((size_t)b * Sk * H + h) * D;
  const T* vh = v + ((size_t)b * Sk * H + h) * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[RI][C];
  float m_i[RI], l_i[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
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
    float s[RI][KJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj) s[i][jj] = 0.f;
    for (int dc = 0; dc < D; dc += kChunk) {
      __syncthreads();  // the previous chunk's (or tile's) reads are done
      load_tile<T, kChunk, R>(qs, qh + dc, q0, Sq, rs);
      load_tile<T, kChunk, KB>(ks, kh + dc, k0, Sk, rs);
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < kChunk; ++d) {
        float a[RI], bb[KJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) a[i] = qs[(ty + 16 * i) * P + d];
#pragma unroll
        for (int jj = 0; jj < KJ; ++jj) bb[jj] = ks[(tx + 16 * jj) * P + d];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int jj = 0; jj < KJ; ++jj)
            s[i][jj] = fmaf(a[i], bb[jj], s[i][jj]);
      }
    }
    load_tile<T, kChunk, KB>(vs, vh + d0, k0, Sk, rs);

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q_off + q0 + ty + 16 * i;
      bool ok[KJ];
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj) {
        const int kc = k0 + tx + 16 * jj;
        ok[jj] = kc < Sk && (!causal || qpos >= k_off + kc);
        s[i][jj] = ok[jj] ? s[i][jj] * scale : kNegInf;
        mx = fmaxf(mx, s[i][jj]);
      }
      const float m_new = fmaxf(m_i[i], row_max(mx));
      const float corr = expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj) {
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
    for (int kk = 0; kk < KB; ++kk) {
      float p[RI], vv[C];
#pragma unroll
      for (int i = 0; i < RI; ++i) p[i] = ps[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = vs[kk * P + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float inv = 1.f / (l_i[i] == 0.f ? 1.f : l_i[i]);
    T* orow = o + ((size_t)(b * Sq + row) * H + h) * D + d0;
#pragma unroll
    for (int c = 0; c < C; ++c) orow[tx + 16 * c] = from_f32<T>(acc[i][c] * inv);
    if (blockIdx.z == 0 && tx == 0) {
      m_out[(size_t)bh * Sq + row] = m_i[i];
      l_out[(size_t)bh * Sq + row] = l_i[i];
    }
  }
}

template <typename T>
cudaError_t run_fwd_chunked(const void* q, const void* k, const void* v,
                            void* o, void* m, void* l, int B, int H, int Sq,
                            int Sk, int D, int q_off, int k_off, int causal,
                            float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes(kChunk, 2, 1, 1, 0);
  static_assert(bytes <= kMaxSmem, "forward chunk tiles exceed shared memory");
  const dim3 grid((Sq + kBlock - 1) / kBlock, B * H, D / kChunk);
  return launch(flash_fwd_chunked_kernel<T>, grid, bytes, stream,
                (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)m,
                (float*)l, H, Sq, Sk, D, q_off, k_off, causal, scale);
}

template <typename T>
cudaError_t fwd_for_dim(int D, const void* q, const void* k, const void* v,
                        void* o, void* m, void* l, int B, int H, int Sq,
                        int Sk, int q_off, int k_off, int causal, float sc,
                        cudaStream_t st) {
  switch (D) {
    case 16: return run_fwd<T, 16>(q, k, v, o, m, l, B, H, Sq, Sk, q_off, k_off, causal, sc, st);
    case 32: return run_fwd<T, 32>(q, k, v, o, m, l, B, H, Sq, Sk, q_off, k_off, causal, sc, st);
    case 64: return run_fwd<T, 64>(q, k, v, o, m, l, B, H, Sq, Sk, q_off, k_off, causal, sc, st);
    case 96: return run_fwd<T, 96>(q, k, v, o, m, l, B, H, Sq, Sk, q_off, k_off, causal, sc, st);
    case 128: return run_fwd<T, 128>(q, k, v, o, m, l, B, H, Sq, Sk, q_off, k_off, causal, sc, st);
    case 256: return run_fwd<T, 256>(q, k, v, o, m, l, B, H, Sq, Sk, q_off, k_off, causal, sc, st);
    case 384: return run_fwd<T, 384>(q, k, v, o, m, l, B, H, Sq, Sk, q_off, k_off, causal, sc, st);
    case 512: return run_fwd<T, 512>(q, k, v, o, m, l, B, H, Sq, Sk, q_off, k_off, causal, sc, st);
    default:
      if (D > 512 && D % kChunk == 0)
        return run_fwd_chunked<T>(q, k, v, o, m, l, B, H, Sq, Sk, D, q_off,
                                  k_off, causal, sc, st);
      return cudaErrorInvalidValue;
  }
}

}  // namespace hvdt

extern "C" int hvdt_flash_fwd(int dtype, const void* q, const void* k,
                              const void* v, void* o, void* m, void* l, int B,
                              int H, int Sq, int Sk, int D, int q_off,
                              int k_off, int causal, float scale,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == hvdt::kFloat32)
    return hvdt::fwd_for_dim<float>(D, q, k, v, o, m, l, B, H, Sq, Sk, q_off,
                                    k_off, causal, scale, st);
  if (dtype == hvdt::kBFloat16)
    return hvdt::fwd_for_dim<__nv_bfloat16>(D, q, k, v, o, m, l, B, H, Sq, Sk,
                                            q_off, k_off, causal, scale, st);
  if (dtype == hvdt::kFloat16)
    return hvdt::fwd_for_dim<__half>(D, q, k, v, o, m, l, B, H, Sq, Sk, q_off,
                                     k_off, causal, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* hvdt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
