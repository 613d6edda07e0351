// Shared PTX wrappers of the Hopper flash-attention kernels
// (flash_fwd_sm90.cu, flash_fwd_stream_sm90.cu, flash_fwd_tf32_narrow_sm90.cu,
// flash_dq_sm90.cu, flash_dq_stream_sm90.cu, flash_dkv_sm90.cu,
// flash_dkv_stream_sm90.cu, flash_bwd_sm90.cu, flash_bwd_tf32_sm90.cu,
// flash_bwd_tf32_narrow_sm90.cu):
// TMA loads through a tensor map, mbarrier init / arrive / expect-tx /
// wait, wgmma descriptors, fence, commit and wait, setmaxnreg, the proxy
// fence and named barriers (for tiles that the consumers write themselves,
// and the forward's turns between its consumers),
// the host-side tensor-map encoders, and the tf32 kernels' pre-pass. The
// wrappers take bf16 or fp16 (`T`), and fp32 tiles fed to the tensor
// cores as tf32 (`wgmma_tf32_ss`, `wgmma_tf32_rs`).
//
// Shared-memory tiles are what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B,
// and every size below is in bytes, whatever the element: rows of 128
// bytes (64 bf16 or fp16, 32 fp32) in 8-row atoms of 1024 bytes, the
// 16-byte chunks of row r XOR-ed with r % 8. A [rows][D] tile is
// D * sizeof(T) / 128 such "regions" of [rows][128 bytes], one after the
// other; each region must start on a 1024-byte boundary. A wgmma k step
// reads 32 bytes of a row: k16 of a 16-bit type, k8 of tf32. wgmma reads
// the tiles through a matrix descriptor in the 128-byte swizzle mode:
//   K-major (the reduction dim contiguous): stride between 8-row atoms
//     (SBO) 1024 bytes; a k step advances the start address by 32 bytes
//     inside a region and moves to the next region every 4 steps.
//   MN-major (the output dim contiguous, wgmma's transpose bit, 16-bit
//     types only: tf32 takes both operands K-major): SBO is the 1024-byte
//     step to the next 8 rows of the reduction dim, LBO the step to the
//     next 64-wide column block (the next region); a 16-wide k step
//     advances 16 rows, 2048 bytes.
//
// Narrow rows (the 16-bit kernels at head dims 16 and 32, whose [rows][D]
// tiles are rows of 32 or 64 bytes): TMA writes them with the swizzle of
// the row's width (encode_bshd: CU_TENSOR_MAP_SWIZZLE_32B or _64B, box
// inner extent D), in 8-row atoms of 8 x the row's bytes (256 or 512), and wgmma reads
// them through descriptors of the same mode (desc_narrow<kRowBytes>). A
// whole tile is one region. K-major: SBO 8 x the row's bytes; a k16 step
// advances 32 bytes inside the row (D 32 has two, D 16 one). MN-major:
// the head dim is N and fits one swizzle atom, so LBO is never stepped
// over; SBO is again 8 rows, and a k16 step advances 16 rows (1024 bytes
// at D 32, 512 at D 16).
#pragma once

#include "flash_common.cuh"  // kNegInf

#include <cuda.h>  // CUtensorMap and its enums; the driver entry point is looked up at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace hvdt {
namespace sm90 {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier -------------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the other threads and to TMA.
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(smem_u32(bar))
      : "memory");
}

// Arrives and tells the barrier to expect `bytes` more of TMA traffic.
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ------------------------------------------------------------------

// One box of a 4-D tensor map at coordinates (c0 innermost .. c3) into
// shared memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- register reallocation between warpgroups ---------------------------

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- wgmma ----------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand starting at shared address
// `addr`; `lbo` is the byte step between 64-wide column blocks (used by
// MN-major operands only), SBO is the 1024-byte atom step.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Descriptor of an operand in a narrow row's swizzle (kRowBytes 32 or 64:
// the layout types 3 and 2 of wgmma's descriptor, 128 bytes being 1),
// with the 8-row atom step 8 x kRowBytes as SBO; `lbo` as for
// desc_sw128.
template <int kRowBytes>
__device__ __forceinline__ uint64_t desc_narrow(uint32_t addr, uint32_t lbo) {
  static_assert(kRowBytes == 32 || kRowBytes == 64, "narrow rows: 32 or 64 bytes");
  constexpr uint64_t kLayout = kRowBytes == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((8 * kRowBytes) >> 4) << 32) | (kLayout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins register values in place around the asynchronous products: the
// compiler may not move a read of an accumulator above the wait, or a
// write below the issue.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ---- element types --------------------------------------------------------

// The 16-bit tiles hold T, bf16 or fp16: both are 2 bytes, so every tile,
// region and swizzle above is the same for either; only the instruction's
// type, the tensor map's type and the conversions differ. fp32 tiles hold
// tf32 values (tf32_round) and take the tf32 instructions.
template <typename T>
constexpr bool kIsF16 = std::is_same<T, __half>::value;

// Two fp32 values rounded to T, packed as one 32-bit register (the lower
// one first): a register-A operand pair or two adjacent output elements.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsF16<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// Stores lo, hi rounded to T at p, p + 1 (p aligned to two elements).
template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi) {
  if constexpr (std::is_same<T, float>::value)
    *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
  else
    *reinterpret_cast<uint32_t*>(p) = pack2<T>(lo, hi);
}

// x rounded to tf32 (10 mantissa bits; to nearest, ties away from zero:
// half of the dropped 13 bits' range added to the magnitude, then the 13
// bits cleared), as a float whose low 13 bits are 0: the value a tf32
// product takes exactly. horovod_tpu_torch's plain version rounds with
// the same integer steps.
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// Makes this thread's ordinary shared-memory stores visible to the async
// proxy (wgmma's operand reads); then a barrier hands them to the readers.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `count` threads.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Arrives at named barrier `id` of `count` threads without waiting: the
// arriving threads count towards a phase that others wait for with
// named_bar_sync.
__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// D[64 x N] (+)= A[64 x 16] * B[16 x N], T (bf16 or fp16) in, fp32
// accumulators; the accumulator is overwritten when scale_d is 0.
//   wgmma_ss<N, T, TB, TA>: A and B from shared memory; A K-major (TA 0)
//             or MN-major (TA 1: an [K][64] tile whose rows are the
//             reduction dim, read through its transpose bit); B K-major
//             (TB 0) or MN-major (TB 1, wgmma's transpose bit).
//   wgmma_rs<N, T>: A from registers (four T pairs a thread, the layout of
//             the accumulator fragment), B from shared memory, MN-major.
// N is 16, 32, 64, 128, 192 or 256 (8 to 128 accumulator registers a
// thread).
// Accumulator fragment of thread t (warp w = t / 32, lane = t % 32):
// d[4j + 2i + e] is row 16w + lane / 4 + 8i, column 8j + 2 (lane % 4) + e.
#define HVDT_REGS_8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define HVDT_OUTS_8 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7])
#define HVDT_REGS_16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define HVDT_OUTS_16 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define HVDT_REGS_32 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define HVDT_OUTS_32 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
  "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31])
#define HVDT_REGS_64 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define HVDT_OUTS_64 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
  "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
  "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define HVDT_REGS_96 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define HVDT_OUTS_96 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
  "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
  "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), \
  "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), \
  "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
  "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
  "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
#define HVDT_REGS_128 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define HVDT_OUTS_128 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
  "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
  "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), \
  "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), \
  "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
  "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
  "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
  "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), \
  "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
  "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), \
  "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), \
  "+f"(d[126]), "+f"(d[127])

// ss: descriptors at %R and %R1, scale_d at %R2, the transpose bits of B
// at %R3 and of A at %R4; rs: A's registers at %R .. %R3, B's descriptor at %R4, scale_d
// at %R5 (R = N / 2 accumulator registers come first). The tf32 forms
// take no transpose bits.
#define HVDT_SS(N, R, R1, R2, R3, R4, TY)                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #R2 ", 0;\n"          \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "."   \
               TY " {" HVDT_REGS_##R "}, %" #R ", %" #R1                  \
               ", p, 1, 1, %" #R4 ", %" #R3 ";\n}\n"                      \
               : HVDT_OUTS_##R                                            \
               : "l"(da), "l"(db), "r"(scale_d), "n"(TB), "n"(TA))
#define HVDT_RS(N, R, R1, R2, R3, R4, R5, TY)                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #R5 ", 0;\n"          \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "."   \
               TY " {" HVDT_REGS_##R "}, {%" #R ", %" #R1 ", %" #R2       \
               ", %" #R3 "}, %" #R4 ", p, 1, 1, 1;\n}\n"                  \
               : HVDT_OUTS_##R                                            \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),     \
                 "r"(scale_d))
#define HVDT_SS_TF32(N, R, R1, R2)                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #R2 ", 0;\n"          \
               "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" \
               HVDT_REGS_##R "}, %" #R ", %" #R1 ", p, 1, 1;\n}\n"        \
               : HVDT_OUTS_##R                                            \
               : "l"(da), "l"(db), "r"(scale_d))
#define HVDT_RS_TF32(N, R, R1, R2, R3, R4, R5)                            \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #R5 ", 0;\n"          \
               "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" \
               HVDT_REGS_##R "}, {%" #R ", %" #R1 ", %" #R2 ", %" #R3      \
               "}, %" #R4 ", p, 1, 1;\n}\n"                                \
               : HVDT_OUTS_##R                                            \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),     \
                 "r"(scale_d))
#define HVDT_WGMMA_SHAPE(N, R, R1, R2, R3, R4, R5)                         \
  template <>                                                             \
  struct Wgmma<N> {                                                       \
    static __device__ __forceinline__ void tf32_ss(float (&d)[R],         \
                                                   uint64_t da,           \
                                                   uint64_t db,           \
                                                   int scale_d) {         \
      HVDT_SS_TF32(N, R, R1, R2);                                         \
    }                                                                     \
    static __device__ __forceinline__ void tf32_rs(float (&d)[R],         \
                                                   const uint32_t (&a)[4], \
                                                   uint64_t db,           \
                                                   int scale_d) {         \
      HVDT_RS_TF32(N, R, R1, R2, R3, R4, R5);                             \
    }                                                                     \
    template <typename T, int TB, int TA>                                 \
    static __device__ __forceinline__ void ss(float (&d)[R], uint64_t da, \
                                              uint64_t db, int scale_d) { \
      if constexpr (kIsF16<T>)                                            \
        HVDT_SS(N, R, R1, R2, R3, R4, "f16");                             \
      else                                                                \
        HVDT_SS(N, R, R1, R2, R3, R4, "bf16");                            \
    }                                                                     \
    template <typename T>                                                 \
    static __device__ __forceinline__ void rs(float (&d)[R],              \
                                              const uint32_t (&a)[4],     \
                                              uint64_t db, int scale_d) { \
      if constexpr (kIsF16<T>)                                            \
        HVDT_RS(N, R, R1, R2, R3, R4, R5, "f16");                         \
      else                                                                \
        HVDT_RS(N, R, R1, R2, R3, R4, R5, "bf16");                        \
    }                                                                     \
  };

template <int N>
struct Wgmma;
HVDT_WGMMA_SHAPE(16, 8, 9, 10, 11, 12, 13)
HVDT_WGMMA_SHAPE(32, 16, 17, 18, 19, 20, 21)
HVDT_WGMMA_SHAPE(64, 32, 33, 34, 35, 36, 37)
HVDT_WGMMA_SHAPE(128, 64, 65, 66, 67, 68, 69)
HVDT_WGMMA_SHAPE(192, 96, 97, 98, 99, 100, 101)
HVDT_WGMMA_SHAPE(256, 128, 129, 130, 131, 132, 133)
#undef HVDT_WGMMA_SHAPE
#undef HVDT_SS
#undef HVDT_RS
#undef HVDT_SS_TF32
#undef HVDT_RS_TF32

template <int N, typename T = __nv_bfloat16, int TB = 0, int TA = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  Wgmma<N>::template ss<T, TB, TA>(d, da, db, scale_d);
}
template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  Wgmma<N>::template rs<T>(d, a, db, scale_d);
}

// D[64 x N] (+)= A[64 x 8] * B[8 x N] in tf32 with fp32 accumulators, both
// operands K-major (tf32 has no transpose bit): A and B from shared
// memory, or A from registers (four tf32 values a thread: rows
// 16 w + lane / 4 (+ 8 for a1, a3), columns lane % 4 (+ 4 for a2, a3)).
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t da,
                                              uint64_t db, int scale_d) {
  Wgmma<N>::tf32_ss(d, da, db, scale_d);
}
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  Wgmma<N>::tf32_rs(d, a, db, scale_d);
}

// x split in registers for 3xTF32: hi = tf32(x) (as bits), and x becomes
// tf32(x - hi).
template <int R>
__device__ __forceinline__ void split_tf32(float (&x)[R], uint32_t (&hi)[R]) {
#pragma unroll
  for (int e = 0; e < R; ++e) {
    const float h = tf32_round(x[e]);
    hi[e] = __float_as_uint(h);
    x[e] = tf32_round(x[e] - h);
  }
}

// The narrow tf32 kernels (flash_fwd_tf32_narrow_sm90.cu,
// flash_bwd_tf32_narrow_sm90.cu): fp32 [rows][D] tiles of D 16 or 32,
// rows of kRowBytes = 64 or 128 bytes in the swizzle of that width (a k8
// step is 32 bytes of a row), and transposed [D][32 rows] regions of 128
// bytes.

// Descriptor of a K-major operand whose rows are kRowBytes (64 or 128)
// long, in the swizzle of that width.
template <int kRowBytes>
__device__ __forceinline__ uint64_t desc_rows(uint32_t addr) {
  if constexpr (kRowBytes == 128)
    return desc_sw128(addr, 16);
  else
    return desc_narrow<kRowBytes>(addr, 16);
}

// s = A B^T over D in 3xTF32 (A a [64][D] tile at a, a_lo; B an [N][D]
// tile at b, b_lo; hi and lo parts): lo.hi and hi.lo first, then hi.hi,
// one k8 step per 8 columns of D; issued and committed, not waited for. A
// consumer thread's fragment: s[e] is row 16 (t / 32) + lane / 4 + 8 ((e /
// 2) % 2), column 8 (e / 4) + 2 (lane % 4) + e % 2.
template <int D, int N>
__device__ __forceinline__ void tf32x3_scores(float (&s)[N / 2], uint32_t a,
                                              uint32_t a_lo, uint32_t b,
                                              uint32_t b_lo) {
  constexpr int kRB = D * 4;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    wgmma_tf32_ss<N>(s, desc_rows<kRB>(a_lo + 32 * kk),
                     desc_rows<kRB>(b + 32 * kk), kk > 0);
    wgmma_tf32_ss<N>(s, desc_rows<kRB>(a + 32 * kk),
                     desc_rows<kRB>(b_lo + 32 * kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    wgmma_tf32_ss<N>(s, desc_rows<kRB>(a + 32 * kk),
                     desc_rows<kRB>(b + 32 * kk), 1);
  wgmma_commit();
}

// out = X Y over K rows in 3xTF32: X the accumulator fragment of a [64][K]
// tile split into hi and lo (split_tf32; wgmma's register A operand), Y^T
// at y (hi) and y_lo, K / 32 regions of [D][32 rows] whose rows of every 8
// the pre-pass permuted (tf32_split_t), so that this thread's columns 2t,
// 2t + 1 of each 8 go in as A columns t, t + 4; lo.hi and hi.lo first, then
// hi.hi; waits for the products.
template <int D, int K>
__device__ __forceinline__ void tf32x3_reg_product(float (&out)[D / 2],
                                                   uint32_t (&hi)[K / 2],
                                                   float (&lo)[K / 2],
                                                   uint32_t y, uint32_t y_lo) {
  constexpr int kRegion = D * 128;
  fence_regs(out);
  fence_regs(hi);
  fence_regs(lo);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    const uint32_t ah[4] = {hi[4 * kk], hi[4 * kk + 2], hi[4 * kk + 1],
                            hi[4 * kk + 3]};
    const uint32_t al[4] = {
        __float_as_uint(lo[4 * kk]), __float_as_uint(lo[4 * kk + 2]),
        __float_as_uint(lo[4 * kk + 1]), __float_as_uint(lo[4 * kk + 3])};
    const uint32_t off = (kk / 4) * kRegion + (kk % 4) * 32;
    wgmma_tf32_rs<D>(out, al, desc_sw128(y + off, 16), kk > 0);
    wgmma_tf32_rs<D>(out, ah, desc_sw128(y_lo + off, 16), 1);
  }
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    const uint32_t ah[4] = {hi[4 * kk], hi[4 * kk + 2], hi[4 * kk + 1],
                            hi[4 * kk + 3]};
    const uint32_t off = (kk / 4) * kRegion + (kk % 4) * 32;
    wgmma_tf32_rs<D>(out, ah, desc_sw128(y + off, 16), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(out);
  fence_regs(hi);
  fence_regs(lo);
}

// The online softmax of the tf32 forwards (flash_fwd_stream_sm90.cu,
// flash_fwd_tf32_narrow_sm90.cu) for one kv tile (keys k0 ..) on a
// consumer thread's accumulator fragment s of S (rows qpos, qpos + 8 in
// global positions): scale, mask (only where `masked`: tiles that cross the
// diagonal or the ragged end), the row max by two quad shuffles, p = exp(x
// - m) in place of s (masked entries give exactly 0), l from the unrounded
// p (this thread's share of the row; the quad's shares are added at the
// end), and corr, the factor of the O accumulated so far.
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

// ---- host side ------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once at run time.
inline cudaError_t encode_fn(EncodeTiledFn* out) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  *out = encode;
  return cudaSuccess;
}

template <typename T>
constexpr CUtensorMapDataType kMapType =
    std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
    : kIsF16<T>                   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

// A 4-D tensor map with the 128-byte swizzle (or `swizzle`) over a
// contiguous tensor of T with dims `dims` (innermost first) and box
// `box`, whose innermost extent is one region row: 128 / sizeof(T)
// elements, or as many as the narrower swizzle spans. Every dim is a
// tensor edge: boxes read zeros past it and never straddle it.
template <typename T>
inline cudaError_t encode_tiled(
    CUtensorMap* map, const void* base, const cuuint64_t (&dims)[4],
    const cuuint32_t (&box)[4],
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiledFn encode;
  const cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t strides[3] = {
      dims[0] * sizeof(T), dims[0] * dims[1] * sizeof(T),
      dims[0] * dims[1] * dims[2] * sizeof(T)};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, kMapType<T>, 4, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A tensor map over a contiguous [B, S, H, D] tensor of T (dims D, H, S,
// B, innermost first), box (128 / sizeof(T), 1, box_rows, 1): one region
// of box_rows sequence rows. S is a tensor edge, so rows past S read as
// zeros and no box straddles two batches. A 16-bit row of 32 or 64 bytes
// (D 16 or 32) is one whole narrow region instead: box (D, 1, box_rows,
// 1) in the swizzle of the row's width, as desc_narrow reads it.
// `built` (default D) is the head dim of the kernel's build, whose boxes
// the map takes: a tensor of D < built columns (D * sizeof(T) a multiple
// of 16, TMA's stride unit; built past the narrow rows) is read in the
// build's 128-byte boxes, and D is a tensor edge too, so the columns from
// D on read as zeros, as a zero pad of the tensor to `built` would give.
template <typename T = __nv_bfloat16>
inline cudaError_t encode_bshd(CUtensorMap* map, const void* base, int B,
                               int S, int H, int D, int box_rows,
                               int built = 0) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const int row_bytes = (built > 0 ? built : D) * (int)sizeof(T);
  if (row_bytes < 128) {
    if (row_bytes != 32 && row_bytes != 64) return cudaErrorInvalidValue;
    const cuuint32_t box[4] = {(cuuint32_t)D, 1, (cuuint32_t)box_rows, 1};
    return encode_tiled<T>(map, base, dims, box,
                           row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B);
  }
  const cuuint32_t box[4] = {(cuuint32_t)(128 / sizeof(T)), 1,
                             (cuuint32_t)box_rows, 1};
  return encode_tiled<T>(map, base, dims, box);
}

// A tensor map over a contiguous [B, H, D, S] tensor of T (a transposed
// copy, S innermost), box (128 / sizeof(T), box_rows, 1, 1): one region
// of box_rows head-dim rows by 128 bytes of the sequence. Rows past D and
// columns past S read as zeros.
template <typename T>
inline cudaError_t encode_bhds(CUtensorMap* map, const void* base, int B,
                               int H, int D, int S, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)S, (cuuint64_t)D, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / sizeof(T)),
                             (cuuint32_t)box_rows, 1, 1};
  return encode_tiled<T>(map, base, dims, box);
}

// Sets the dynamic shared-memory limit and launches `kernel` on `threads`
// threads.
template <typename K, typename... Args>
inline cudaError_t launch_threads(K kernel, dim3 grid, int threads,
                                  size_t bytes, cudaStream_t stream,
                                  Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

// The same on 384 threads (one producer and two consumer warpgroups).
template <typename K, typename... Args>
inline cudaError_t launch_ws(K kernel, dim3 grid, size_t bytes,
                             cudaStream_t stream, Args... args) {
  return launch_threads(kernel, grid, 384, bytes, stream, args...);
}

// ---- the tf32 pre-pass ----------------------------------------------------
//
// The tf32 kernels (the forward in flash_fwd_stream_sm90.cu and
// flash_fwd_tf32_narrow_sm90.cu, dq and dk/dv in flash_bwd_tf32_sm90.cu and
// flash_bwd_tf32_narrow_sm90.cu) read each fp32 operand as two tf32 parts,
// hi = tf32(x) and lo = tf32(x - hi), written once per call by these
// kernels into scratch the wrapper allocates. tf32 wgmma takes both
// operands K-major, so a product that reduces over the sequence (P V,
// dS K, P^T dO, dS^T Q) reads its second factor transposed, [B, H, D, S
// rounded up], from tf32_split_t. The kernels live in an unnamed
// namespace: each file that includes this header has its own copy.
namespace {

// hi = tf32(x), lo = tf32(x - hi) over the float4s first, first + stride,
// ... below n4 (16-byte-aligned).
__device__ __forceinline__ void split_range(const float4* __restrict__ x,
                                            float4* __restrict__ hi,
                                            float4* __restrict__ lo,
                                            size_t first, size_t stride,
                                            size_t n4) {
  for (size_t i = first; i < n4; i += stride) {
    const float4 v = x[i];
    float4 h, l;
    h.x = tf32_round(v.x);
    h.y = tf32_round(v.y);
    h.z = tf32_round(v.z);
    h.w = tf32_round(v.w);
    l.x = tf32_round(v.x - h.x);
    l.y = tf32_round(v.y - h.y);
    l.z = tf32_round(v.z - h.z);
    l.w = tf32_round(v.w - h.w);
    hi[i] = h;
    lo[i] = l;
  }
}

// hi = tf32(x), lo = tf32(x - hi), four elements a step (n4 float4s,
// 16-byte-aligned).
__global__ void tf32_split(const float4* __restrict__ x,
                           float4* __restrict__ hi, float4* __restrict__ lo,
                           size_t n4) {
  split_range(x, hi, lo, (size_t)blockIdx.x * blockDim.x + threadIdx.x,
              (size_t)gridDim.x * blockDim.x, n4);
}

// X [B, S, H, D] -> X^T hi and lo [B, H, D, Sp] (Sp a multiple of 32, at
// least S), zero past S, the rows of every 8 positions stored in the order
// in which a tf32 wgmma's register A operand takes an accumulator
// fragment: position 8g + i holds row 8g + 2i, position 8g + 4 + i row
// 8g + 2i + 1 (i < 4). A thread's fragment holds columns 2t, 2t + 1 of
// each 8 where the A operand wants columns t, t + 4, so P or dS (and P^T,
// dS^T) go to the tensor cores without a shuffle, each value paired with
// its own row of X. One 32 x 32 tile, (b h, columns d0 .. d0 + 31 of D,
// rows s0 .. s0 + 31 of S), on 256 threads through `tile`; a D that is no
// multiple of 32 (the forward's D 16) leaves the last tile of a row fewer
// columns, and it reads and writes none past D.
__device__ __forceinline__ void split_t_tile(float (&tile)[32][33],
                                             const float* __restrict__ x,
                                             float* __restrict__ hi,
                                             float* __restrict__ lo, int S,
                                             int H, int D, int Sp, int bh,
                                             int d0, int s0) {
  const int b = bh / H, h = bh % H;
  const int cols = min(32, D - d0);
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += 8) {
    const int row = s0 + i;
    tile[i][tx] = row < S && tx < cols
                      ? x[(((size_t)b * S + row) * H + h) * D + d0 + tx]
                      : 0.f;
  }
  __syncthreads();
  const int e = tx % 8;
  const int row = 8 * (tx / 8) + (e < 4 ? 2 * e : 2 * (e - 4) + 1);
  for (int i = ty; i < cols; i += 8) {
    const float v = tile[row][i];
    const float vh = tf32_round(v);
    const size_t off = (((size_t)b * H + h) * D + d0 + i) * Sp + s0 + tx;
    hi[off] = vh;
    lo[off] = tf32_round(v - vh);
  }
}

// split_t_tile on a grid of (B H, D / 32 rounded up, Sp / 32).
__global__ void __launch_bounds__(256)
    tf32_split_t(const float* __restrict__ x, float* __restrict__ hi,
                 float* __restrict__ lo, int S, int H, int D, int Sp) {
  __shared__ float tile[32][33];
  split_t_tile(tile, x, hi, lo, S, H, D, Sp, blockIdx.x, blockIdx.y * 32,
               blockIdx.z * 32);
}

// The rows of a transposed plane: S rounded up to `multiple` (of 32).
inline int padded_keys(int S, int multiple = 32) {
  return (S + multiple - 1) / multiple * multiple;
}

// The forward's pre-pass planes in scratch order: Q hi, Q lo, K hi, K lo,
// V^T hi, V^T lo (V^T as [B, H, D, Sk rounded up to 32]).
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

// The forward's pre-pass in one launch of 256-thread blocks: blocks [0,
// qb) split Q, [qb, qb + kb) split K (each set striding over its tensor),
// and every later block one 32 x 32 tile of V^T (b h fastest, then the
// column block of D, then the row block of S). The same values as
// tf32_split and tf32_split_t in three launches, whose launch gaps took
// about as long as their bytes at the narrow head dims.
__global__ void __launch_bounds__(256)
    tf32_fwd_split_all(const float4* __restrict__ q,
                       const float4* __restrict__ k,
                       const float* __restrict__ v, Tf32Planes p,
                       size_t nq4, size_t nk4, int qb, int kb, int BH,
                       int H, int Sk, int D, int Skp) {
  __shared__ float tile[32][33];
  const int blk = blockIdx.x;
  if (blk < qb) {
    split_range(q, (float4*)p.qh, (float4*)p.ql,
                (size_t)blk * 256 + threadIdx.x, (size_t)qb * 256, nq4);
  } else if (blk < qb + kb) {
    split_range(k, (float4*)p.kh, (float4*)p.kl,
                (size_t)(blk - qb) * 256 + threadIdx.x, (size_t)kb * 256,
                nk4);
  } else {
    const int t = blk - qb - kb, db = (D + 31) / 32;
    split_t_tile(tile, v, p.vh, p.vl, Sk, H, D, Skp, t % BH,
                 (t / BH) % db * 32, t / BH / db * 32);
  }
}

// The tf32 forward's pre-pass (flash_fwd_stream_sm90.cu and
// flash_fwd_tf32_narrow_sm90.cu): q, k, v contiguous fp32 [B, S, H, D]
// with 16-byte-aligned bases, D 16 or a multiple of 32, into the six
// planes of tf32_planes, in one launch (tf32_fwd_split_all).
inline cudaError_t tf32_fwd_split(const void* q, const void* k,
                                  const void* v, void* scratch, int B, int H,
                                  int Sq, int Sk, int D, cudaStream_t st) {
  if (D <= 0 || (D % 32 && D != 16)) return cudaErrorInvalidValue;
  const size_t nq4 = (size_t)B * Sq * H * D / 4;
  const size_t nk4 = (size_t)B * Sk * H * D / 4;
  const int skp = padded_keys(Sk);
  // Blocks of the elementwise splits: 4 float4s a thread or more, at most
  // 8 blocks an SM a tensor.
  auto blocks = [](size_t n4) {
    return (int)std::min<size_t>(132 * 8, (n4 + 1023) / 1024);
  };
  const int qb = blocks(nq4), kb = blocks(nk4);
  const long long tiles = (long long)B * H * ((D + 31) / 32) * (skp / 32);
  tf32_fwd_split_all<<<(unsigned)(qb + kb + tiles), 256, 0, st>>>(
      (const float4*)q, (const float4*)k, (const float*)v,
      tf32_planes(scratch, B, H, Sq, Sk, D), nq4, nk4, qb, kb, B * H, H, Sk,
      D, skp);
  return cudaGetLastError();
}

// The backward's transposed planes: the sequence rounded up to 64.
constexpr int kTf32BwdSeqPad = 64;

// The backward's pre-pass planes in scratch order: q, do, k, v hi and lo
// in [B, S, H, D], then K^T hi and lo [B, H, D, Sk rounded up to 64], Q^T
// and dO^T hi and lo [B, H, D, Sq rounded up to 64].
struct Tf32BwdPlanes {
  float *q, *q_lo, *dout, *do_lo, *k, *k_lo, *v, *v_lo;
  float *kt, *kt_lo, *qt, *qt_lo, *dot, *dot_lo;
};
inline Tf32BwdPlanes tf32_bwd_planes(void* scratch, int B, int H, int Sq,
                                     int Sk, int D) {
  const size_t nq = (size_t)B * Sq * H * D, nk = (size_t)B * Sk * H * D;
  const size_t nkt = (size_t)B * H * D * padded_keys(Sk, kTf32BwdSeqPad);
  const size_t nqt = (size_t)B * H * D * padded_keys(Sq, kTf32BwdSeqPad);
  float* x = (float*)scratch;
  float* at[14];
  const size_t n[14] = {nq, nq, nq, nq, nk, nk, nk, nk,
                        nkt, nkt, nqt, nqt, nqt, nqt};
  for (int i = 0; i < 14; ++i) {
    at[i] = x;
    x += n[i];
  }
  return Tf32BwdPlanes{at[0], at[1], at[2],  at[3],  at[4],  at[5],  at[6],
                       at[7], at[8], at[9], at[10], at[11], at[12], at[13]};
}

// The backward's pre-pass in one launch of 256-thread blocks: blocks [0,
// qb) split q, [qb, 2 qb) do, [2 qb, 2 qb + kb) k and the next kb v (each
// set striding over its tensor); every later block one 32 x 32 tile of
// K^T, then of Q^T, then of dO^T (b h fastest, then the column block of D,
// then the row block of the sequence). The same values as four tf32_split
// and three tf32_split_t launches, whose launch gaps took about as long as
// their bytes at the narrow head dims.
__global__ void __launch_bounds__(256)
    tf32_bwd_split_all(const float4* __restrict__ q,
                       const float4* __restrict__ dout,
                       const float4* __restrict__ k,
                       const float4* __restrict__ v, Tf32BwdPlanes p,
                       size_t nq4, size_t nk4, int qb, int kb, int BH,
                       int H, int Sq, int Sk, int D, int Sqp, int Skp) {
  __shared__ float tile[32][33];
  const int blk = blockIdx.x;
  if (blk < 2 * qb) {
    const bool is_do = blk >= qb;
    split_range(is_do ? dout : q, (float4*)(is_do ? p.dout : p.q),
                (float4*)(is_do ? p.do_lo : p.q_lo),
                (size_t)(blk - (is_do ? qb : 0)) * 256 + threadIdx.x,
                (size_t)qb * 256, nq4);
    return;
  }
  if (blk < 2 * qb + 2 * kb) {
    const int j = blk - 2 * qb;
    const bool is_v = j >= kb;
    split_range(is_v ? v : k, (float4*)(is_v ? p.v : p.k),
                (float4*)(is_v ? p.v_lo : p.k_lo),
                (size_t)(j - (is_v ? kb : 0)) * 256 + threadIdx.x,
                (size_t)kb * 256, nk4);
    return;
  }
  const int db = (D + 31) / 32;
  int t = blk - 2 * qb - 2 * kb;
  const int kt_tiles = BH * db * (Skp / 32);
  if (t < kt_tiles) {
    split_t_tile(tile, (const float*)k, p.kt, p.kt_lo, Sk, H, D, Skp, t % BH,
                 (t / BH) % db * 32, t / BH / db * 32);
    return;
  }
  t -= kt_tiles;
  const int qt_tiles = BH * db * (Sqp / 32);
  const bool is_do = t >= qt_tiles;
  if (is_do) t -= qt_tiles;
  split_t_tile(tile, (const float*)(is_do ? dout : q), is_do ? p.dot : p.qt,
               is_do ? p.dot_lo : p.qt_lo, Sq, H, D, Sqp, t % BH,
               (t / BH) % db * 32, t / BH / db * 32);
}

// The tf32 backward's pre-pass (flash_bwd_tf32_sm90.cu and
// flash_bwd_tf32_narrow_sm90.cu read it): q, do contiguous fp32 [B, Sq,
// H, D], k, v [B, Sk, H, D], 16-byte-aligned bases, D 16 or a multiple of
// 32, into the 14 planes of tf32_bwd_planes, in one launch
// (tf32_bwd_split_all).
inline cudaError_t tf32_bwd_split(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  void* scratch, int B, int H, int Sq,
                                  int Sk, int D, cudaStream_t st) {
  if (D <= 0 || (D % 32 && D != 16)) return cudaErrorInvalidValue;
  const size_t nq4 = (size_t)B * Sq * H * D / 4;
  const size_t nk4 = (size_t)B * Sk * H * D / 4;
  const int sqp = padded_keys(Sq, kTf32BwdSeqPad);
  const int skp = padded_keys(Sk, kTf32BwdSeqPad);
  // Blocks of the elementwise splits: as tf32_fwd_split's.
  auto blocks = [](size_t n4) {
    return (int)std::min<size_t>(132 * 8, (n4 + 1023) / 1024);
  };
  const int qb = blocks(nq4), kb = blocks(nk4);
  const long long tiles =
      (long long)B * H * ((D + 31) / 32) * ((skp + 2 * sqp) / 32);
  tf32_bwd_split_all<<<(unsigned)(2 * qb + 2 * kb + tiles), 256, 0, st>>>(
      (const float4*)q, (const float4*)dout, (const float4*)k,
      (const float4*)v, tf32_bwd_planes(scratch, B, H, Sq, Sk, D), nq4, nk4,
      qb, kb, B * H, H, Sq, Sk, D, sqp, skp);
  return cudaGetLastError();
}

}  // namespace

}  // namespace sm90
}  // namespace hvdt
