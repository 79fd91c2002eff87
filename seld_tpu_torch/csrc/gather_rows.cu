// Row gather for the device-resident feed, for Hopper (sm_90a).
//
// Replaces the TPU kernels seld_tpu/ops/pallas/gather.py::_gather_lanes (a
// pipelined block copy per output row, scalar-prefetched ids) and
// seld_tpu/ops/pallas/gather.py::_gather_dma (HBM -> HBM row DMAs with
// copies in flight, over rows packed to the TPU's (8, 128) tiles). Both
// compute out[i] = x[ids[i]] along axis 0; the packing existed for the
// TPU's tiling, so one kernel serves both, for a contiguous x of any row
// geometry.
//
// Contract: one or two arrays, each x [N, row_bytes] with out [B,
// row_bytes] contiguous, and one ids [B] int32 on the card for both, every
// id in [0, N) of each array (the caller's contract; the kernel does not
// clamp, as XLA's gather would). The feed gathers a batch's features x
// and labels y with the same ids row, so it copies both in ONE launch:
// out_x[i] = x[ids[i]], out_y[i] = y[ids[i]].
//
// Design. blockIdx.y is the output row i: the block reads ids[i] once (the
// ids stay on the card: no scalar prefetch, no host round trip).
// blockIdx.x runs over the slices of x's row and then of y's; a slice is
// kThreads x kVecPerThread copy units, and each thread issues all its
// loads before its stores, keeping many loads in flight. Each array moves
// 16-byte vectors when its row byte count and both its pointers allow it,
// else single bytes, on its own.
//
// What bounds it: bytes. At B = 256 windows of [300, 64, 7] bf16 the x
// rows are 68.8 MB read and 68.8 MB written, the labels [60, 48] f32 2.9
// MB each way: 2 x (68.8 + 2.9) MB, 0.043 ms at 3.35 TB/s. The labels
// alone would take 1.8 us at that rate, far below the host's cost of a
// launch from Python, which is why x and y share one launch: a batch pays
// the host's per-call work once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;
constexpr long long kPerBlock = kThreads * kVecPerThread;  // copy units

struct Rows {
  const void* src;
  void* dst;
  long long units;  // row length in copy units: 16-byte vectors or bytes
  int vec;          // 1: 16-byte vectors, 0: bytes
  int blocks;       // slices per row
};

template <typename V>
__device__ __forceinline__ void copy_slice(const void* src_base,
                                           void* dst_base, long long units,
                                           long long src_row,
                                           long long dst_row, int slice) {
  const V* __restrict__ src = static_cast<const V*>(src_base) + src_row * units;
  V* __restrict__ dst = static_cast<V*>(dst_base) + dst_row * units;
  const long long base = slice * kPerBlock + threadIdx.x;
  V v[kVecPerThread];
#pragma unroll
  for (int k = 0; k < kVecPerThread; ++k) {
    const long long e = base + static_cast<long long>(k) * kThreads;
    if (e < units) v[k] = src[e];
  }
#pragma unroll
  for (int k = 0; k < kVecPerThread; ++k) {
    const long long e = base + static_cast<long long>(k) * kThreads;
    if (e < units) dst[e] = v[k];
  }
}

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(Rows x, Rows y, const int* __restrict__ ids) {
  const long long row = ids[blockIdx.y];
  const long long i = blockIdx.y;
  const bool second = static_cast<int>(blockIdx.x) >= x.blocks;
  const int slice = second ? blockIdx.x - x.blocks : blockIdx.x;
  const void* src = second ? y.src : x.src;
  void* dst = second ? y.dst : x.dst;
  const long long units = second ? y.units : x.units;
  if (second ? y.vec : x.vec)
    copy_slice<uint4>(src, dst, units, row, i, slice);
  else
    copy_slice<unsigned char>(src, dst, units, row, i, slice);
}

Rows make_rows(const void* src, void* dst, long long row_bytes) {
  Rows r{src, dst, 0, 0, 0};
  if (src == nullptr || row_bytes <= 0) return r;
  r.vec = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  r.units = r.vec ? row_bytes / 16 : row_bytes;
  r.blocks = static_cast<int>((r.units + kPerBlock - 1) / kPerBlock);
  return r;
}

}  // namespace

extern "C" {

// Gathers B rows of x and of y by one ids vector in one launch; a null y
// makes it the one-array gather out[i] = x[ids[i]]. Returns a cudaError_t
// (0 on success). B is at most 65535 (grid.y).
int seld_gather_batch(const void* ids, int B, const void* x, void* out_x,
                      long long row_bytes_x, const void* y, void* out_y,
                      long long row_bytes_y, void* stream) {
  const Rows a = make_rows(x, out_x, row_bytes_x);
  const Rows b = make_rows(y, out_y, row_bytes_y);
  const long long blocks = static_cast<long long>(a.blocks) + b.blocks;
  if (B == 0 || blocks == 0) return 0;
  if (B < 0 || B > 65535 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  gather_rows_kernel<<<dim3(static_cast<unsigned>(blocks), B), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      a, b, static_cast<const int*>(ids));
  return static_cast<int>(cudaGetLastError());
}

const char* seld_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
