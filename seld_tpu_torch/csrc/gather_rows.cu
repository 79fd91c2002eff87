// Row gather for the device-resident feed, for Hopper (sm_90a).
//
// Replaces the TPU kernels seld_tpu/ops/pallas/gather.py::_gather_lanes (a
// pipelined block copy per output row, scalar-prefetched ids) and
// seld_tpu/ops/pallas/gather.py::_gather_dma (HBM -> HBM row DMAs with copies in flight, over rows packed
// to the TPU's (8, 128) tiles). Both compute out[i] = x[ids[i]] along axis
// 0; the packing existed for the TPU's tiling, so one kernel serves both,
// for a contiguous x of any row geometry.
//
// Contract: x [N, row_bytes] and out [B, row_bytes] contiguous, ids [B]
// int32 on the card, every id in [0, N) (the caller's contract; the kernel
// does not clamp, as XLA's gather would).
//
// Design. Block (chunk, i) copies one slice of output row i: the ids stay
// on the card and each block reads its own id (no scalar prefetch, no
// host round trip). The row is split into slices of kThreads x kVecPerThread
// vectors, so a 268,800-byte feature row keeps nine blocks, and each thread
// issues all its loads before its stores, keeping many 16-byte loads in
// flight. The copy moves 16-byte vectors when the row's byte count and both
// pointers allow it, else single bytes.
//
// What bounds it: bytes. At B = 256 windows of [300, 64, 7] bf16 it reads
// and writes 68.8 MB each (0.041 ms at 3.35 TB/s); the labels [60, 48] f32
// add 2.9 MB each way.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ x, const int* __restrict__ ids,
                   V* __restrict__ out, long long row_vecs) {
  const long long row = ids[blockIdx.y];
  const V* src = x + row * row_vecs;
  V* dst = out + static_cast<long long>(blockIdx.y) * row_vecs;
  const long long base =
      static_cast<long long>(blockIdx.x) * kThreads * kVecPerThread +
      threadIdx.x;
  V v[kVecPerThread];
#pragma unroll
  for (int k = 0; k < kVecPerThread; ++k) {
    const long long e = base + static_cast<long long>(k) * kThreads;
    if (e < row_vecs) v[k] = src[e];
  }
#pragma unroll
  for (int k = 0; k < kVecPerThread; ++k) {
    const long long e = base + static_cast<long long>(k) * kThreads;
    if (e < row_vecs) dst[e] = v[k];
  }
}

template <typename V>
cudaError_t launch(const void* x, const int* ids, void* out, int B,
                   long long row_vecs, cudaStream_t stream) {
  const long long per_block = static_cast<long long>(kThreads) * kVecPerThread;
  const dim3 grid(static_cast<unsigned>((row_vecs + per_block - 1) / per_block),
                  B);
  gather_rows_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(x), ids, static_cast<V*>(out), row_vecs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). B is at most 65535 (grid.y).
int seld_gather_rows(const void* x, const void* ids, void* out, int B,
                     long long row_bytes, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const bool vec = row_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (B == 0 || row_bytes == 0) return 0;
  const auto* id = static_cast<const int*>(ids);
  cudaError_t err;
  if (vec)
    err = launch<uint4>(x, id, out, B, row_bytes / 16, st);
  else
    err = launch<unsigned char>(x, id, out, B, row_bytes, st);
  return static_cast<int>(err);
}

const char* seld_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
