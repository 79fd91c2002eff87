// Hopper (sm_90a) building blocks shared by the GRU kernels' tensor-core
// passes: mbarriers, TMA tile loads, wgmma on K-major bf16 operands in
// shared memory, and the host-side tensor-map encoder (a driver entry
// point fetched through the runtime, so the libraries link no libcuda).
//
// Operand layout. Every wgmma operand here is K-major with no swizzle: an
// R x K tile (R rows of M or N, K values, 32 by default) is 16-byte core
// matrices of 8 rows x 8 values; core matrix (r / 8, k / 8) starts at byte
// (r / 8) * sbo + (k / 8) * kLbo, sbo = K / 8 * kLbo, row r % 8 at 16 (r %
// 8) within it. The kernels write these tiles themselves (they split f32
// values into bf16 parts on the way), so the layout is theirs to choose.
#pragma once
#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

constexpr int kK = 32;              // K values a tile holds by default
constexpr uint32_t kLbo = 128;      // bytes between K-adjacent core matrices
// bytes between row-adjacent 8-row groups of a tile K deep
template <int K = kK>
constexpr uint32_t sbo = K / 8 * kLbo;
constexpr uint32_t kSbo = sbo<>;
// bytes of an R-row operand tile K deep
template <int K = kK>
__host__ __device__ constexpr int tile_bytes(int rows) { return rows * K * 2; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16;
}
// the byte offset of (r, k) in an operand tile K deep
template <int K = kK>
__device__ __forceinline__ uint32_t tile_offset(int r, int k) {
  return (r >> 3) * sbo<K> + (k >> 3) * kLbo + (r & 7) * 16 + (k & 7) * 2;
}
// the wgmma descriptor of the K-major, unswizzled operand at shared address
// `addr` (its first row, its first K value) whose 8-row groups lie
// `group_bytes` apart (sbo<K> for a tile K deep)
__device__ __forceinline__ uint64_t desc(uint32_t addr,
                                         uint32_t group_bytes = kSbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kLbo >> 4) << 16) |
         (static_cast<uint64_t>(group_bytes >> 4) << 32);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// the producer's arrive, announcing `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// spins until the phase of parity `parity` has completed; traps (a launch
// error the wrapper raises) after kHangNs instead of hanging the card
constexpr uint64_t kHangNs = 10000000000ull;
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  uint64_t start = 0;
  for (uint32_t n = 1;; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (n % 4096 == 0) {
      const uint64_t now = global_ns();
      if (start == 0) start = now;
      else if (now - start > kHangNs) __trap();
    }
  }
}

// a 3-D TMA tile load into shared memory, completing on `bar`; coordinates
// innermost first, out-of-bounds elements filled with zeros
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// a 1-D bulk copy (TMA's non-tensor form) of `bytes` (a multiple of 16,
// both addresses 16-byte aligned) into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// generic-proxy global writes of other CTAs (acquired) ordered before this
// thread's later async-proxy (bulk copy) reads, and its own writes before
// others' bulk copies
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}
__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void red_release_add(uint32_t* p, uint32_t v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}
// spins until *counter >= target (a grid-wide step barrier: every CTA adds
// 1 with release after its step's writes); traps after kHangNs
__device__ __forceinline__ void wait_counter(const uint32_t* counter,
                                             uint32_t target) {
  uint64_t start = 0;
  for (uint32_t n = 1; ld_acquire(counter) < target; ++n) {
    if (n % 1024 == 0) {
      const uint64_t now = global_ns();
      if (start == 0) start = now;
      else if (now - start > kHangNs) __trap();
    }
  }
}

// generic-proxy writes to shared memory, made visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// a named barrier over `threads` threads (id 0 is __syncthreads')
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// x = p[0] + p[1] + ... in bf16, each part rounded to nearest from what the
// earlier ones leave (exact subtractions); three parts hold an f32 whole
template <int P>
__device__ __forceinline__ void split(float x, __nv_bfloat16 (&p)[P]) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    p[i] = __float2bfloat16_rn(x);
    x -= __bfloat162float(p[i]);
  }
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], bf16 operands from shared memory
// (both K-major), f32 accumulators: 64 a thread
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}


// D[64 x 48] (+)= A[64 x 16] B[16 x 48], bf16 operands from shared memory
// (both K-major), f32 accumulators: 24 a thread
__device__ __forceinline__ void wgmma_n48(float (&d)[24], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}


// D[64 x 64] (+)= A[64 x 16] B[16 x 64], bf16 operands from shared memory
// (both K-major), f32 accumulators: 32 a thread
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// D[64 x 32] (+)= A[64 x 16] B[16 x 32], bf16 operands from shared memory
// (both K-major), f32 accumulators: 16 a thread
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}


}  // namespace tc

// Host: cuTensorMapEncodeTiled through the runtime's driver entry point.
namespace tc_host {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map of the row-major [d2, d1, d0] array at `base` (f32 or bf16) whose
// loads are boxes [1, b1, b0]; false where the driver refuses it (a row
// that is no multiple of 16 bytes).
inline bool map_3d(CUtensorMap* map, const void* base, bool bf16, int d0,
                   int d1, int d2, int b0, int b1, CUtensorMapSwizzle swz) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const size_t es = bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {d0 * es, static_cast<cuuint64_t>(d0) * d1 * es};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0),
                             static_cast<cuuint32_t>(b1), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  if (strides[0] % 16 || reinterpret_cast<uintptr_t>(base) % 16) return false;
  return fn(map,
            bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            3, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc_host
