// Fused FOA feature front-end for Hopper (sm_90a).
//
// Replaces the TPU kernels seld_tpu/ops/pallas/frontend.py::_frontend_kernel
// (launched by fused_foa_frontend) and ::_frontend_kernel_2d (launched by
// fused_foa_frontend_2d). The two differ only in how the TPU laid frames out
// for its (8, 128) tiles; one kernel computes their function for both.
//
// Contract, for a chunk of n equal-length 4-channel clips (ACN W, Y, Z, X):
//   wav   [n, 4, Lp] f32, already scaled and reflect-padded by n_fft / 2 on
//         each side (Lp = L + n_fft); frame k of channel c is
//         wav[clip, c, k * hop : k * hop + n_fft], k < T = 1 + (Lp - n_fft)
//         / hop
//   wcat  [n_fft, n_chunks * 64] f32: for bin chunk q, columns
//         q * 64 + j (j < 32) hold the windowed cos basis of bin q * 32 + j
//         and q * 64 + 32 + j the windowed sin basis; bins past n_fft / 2
//         are zero columns
//   fbank [n_chunks * 32, 64] f32, the mel filterbank with zero rows past
//         the last bin
//   -> mel [n, 4, T, 64] = |X|^2 projected on the filterbank (before dB),
//      iv  [n, 3, T, 64] = Re(conj(W) {X, Y, Z}) normalised over (x, y, z)
//          with an eps floor, projected on the filterbank.
// The zero columns and rows make the padded bins contribute exactly
// nothing (their IV is 0 / eps = 0).
//
// Design. What the TPU kernel kept out of device memory, this one keeps out
// too: the [T, 513] complex spectrum never leaves the block, and no frames
// tensor is written (a block reads its frames straight from the padded wav
// at offset k * hop, which saves 2.1x the wav's bytes). A block owns 16
// frames of one clip for all 4 channels (64 spectrum rows, row = c * 16 +
// t), because the intensity vectors couple the channels. It walks the bins
// in chunks of 32. For each chunk it forms re and im for its 64 rows by f32
// FMA against the bases, tiled through shared memory 32 samples at a time
// (a 64 x 64 x n_fft product, 4 x 4 outputs a thread); then the power and
// the three normalised IV components of those 32 bins; then it adds their
// projection on the chunk's 32 filterbank rows to the 112 x 64 outputs
// (64 mel rows, 48 IV rows), which each thread holds in registers (7 rows x
// 4 mels) until the end. Frames past T read zeros and are not written.
// Arithmetic is plain f32 (no TF32): the dB step amplifies relative error
// in quiet bins, and the IV normalisation amplifies it where energy is low.
//
// What bounds the function: bytes. One chunk of 8 clips of 60 s at 24 kHz
// reads 184 MB of padded wav and writes 43 MB of features, 0.068 ms at
// 3.35 TB/s. Its operations are a real FFT of 1024 points per frame and
// channel (2.5 N log2 N), the per-bin power and IV, and the filterbank's
// 999 non-zeros (at most 2 mels a bin): 3.3 GFLOP, 0.049 ms at 67 TFLOP/s.
// This kernel's algorithm does far more: the DFT as dense products, 96,032
// rows x 1024 x 513 x 2 products x 2 flops = 201.8 GFLOP, and the dense
// projections (96,032 + 72,024) x 513 x 64 x 2 = 11.0 GFLOP, so it cannot
// come within 3.2 ms of its own work. Reaching the bytes bound needs an FFT
// in shared memory and a sparse projection; this version is the simple one
// that holds the reference's values.
#include <cuda_runtime.h>

namespace {

constexpr int kTileT = 16;                    // frames per block
constexpr int kCh = 4;                        // FOA channels
constexpr int kRows = kCh * kTileT;           // spectrum rows per block
constexpr int kBins = 32;                     // bins per chunk
constexpr int kCols = 2 * kBins;              // re | im columns per chunk
constexpr int kK = 32;                        // samples per shared tile
constexpr int kMels = 64;
constexpr int kOutRows = kRows + 3 * kTileT;  // 64 mel rows + 48 IV rows
constexpr int kThreads = 256;
constexpr int kOutPerThread = kOutRows / 16;  // 7 output rows per thread

struct __align__(16) Smem {
  union {
    struct {
      float a[kK][kRows + 1];   // frames tile, transposed (odd stride)
      float b[kK][kCols];       // bases tile
    } ab;
    float spec[kRows][kCols + 1];  // the chunk's re | im, after the product
  } u;
  float p[kOutRows][kBins + 1];    // power rows, then IV rows
  float fb[kBins][kMels];          // the chunk's filterbank rows
};

__global__ void __launch_bounds__(kThreads)
foa_frontend_kernel(const float* __restrict__ wav,
                    const float* __restrict__ wcat,
                    const float* __restrict__ fbank, float* __restrict__ mel,
                    float* __restrict__ iv, int Lp, int T, int hop, int n_fft,
                    int n_chunks, float eps) {
  __shared__ Smem s;
  const int tid = threadIdx.x;
  const int tx = tid % 16;   // output columns 4 * tx .. 4 * tx + 3
  const int ty = tid / 16;   // spectrum rows 4 * ty .. ; output rows ty + 16 j
  const int clip = blockIdx.y;
  const int t0 = blockIdx.x * kTileT;
  const float* w = wav + static_cast<size_t>(clip) * kCh * Lp;
  const size_t wcols = static_cast<size_t>(n_chunks) * kCols;

  float out[kOutPerThread][4];
#pragma unroll
  for (int j = 0; j < kOutPerThread; ++j)
#pragma unroll
    for (int m = 0; m < 4; ++m) out[j][m] = 0.0f;

  for (int q = 0; q < n_chunks; ++q) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < n_fft; k0 += kK) {
      for (int e = tid; e < kRows * kK; e += kThreads) {
        const int r = e / kK, kk = e % kK;
        const int t = t0 + r % kTileT;
        float v = 0.0f;
        if (t < T)
          v = w[static_cast<size_t>(r / kTileT) * Lp +
                static_cast<size_t>(t) * hop + k0 + kk];
        s.u.ab.a[kk][r] = v;
      }
      for (int e = tid; e < kK * kCols; e += kThreads) {
        const int kk = e / kCols, col = e % kCols;
        s.u.ab.b[kk][col] =
            wcat[static_cast<size_t>(k0 + kk) * wcols + q * kCols + col];
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kK; ++kk) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = s.u.ab.a[kk][4 * ty + i];
        const float4 b = *reinterpret_cast<const float4*>(&s.u.ab.b[kk][4 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
          acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
          acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
          acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
        }
      }
      __syncthreads();
    }

    // the chunk's spectrum (over the tiles: every read of them is done)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s.u.spec[4 * ty + i][4 * tx + j] = acc[i][j];
    for (int e = tid; e < kBins * kMels; e += kThreads)
      s.fb[e / kMels][e % kMels] =
          fbank[static_cast<size_t>(q * kBins + e / kMels) * kMels + e % kMels];
    __syncthreads();

    for (int e = tid; e < kRows * kBins; e += kThreads) {
      const int r = e / kBins, k = e % kBins;
      const float re = s.u.spec[r][k], im = s.u.spec[r][kBins + k];
      s.p[r][k] = re * re + im * im;
    }
    for (int e = tid; e < kTileT * kBins; e += kThreads) {
      const int t = e / kBins, k = e % kBins;
      const float wr = s.u.spec[t][k], wi = s.u.spec[t][kBins + k];
      const float yr = s.u.spec[kTileT + t][k];
      const float yi = s.u.spec[kTileT + t][kBins + k];
      const float zr = s.u.spec[2 * kTileT + t][k];
      const float zi = s.u.spec[2 * kTileT + t][kBins + k];
      const float xr = s.u.spec[3 * kTileT + t][k];
      const float xi = s.u.spec[3 * kTileT + t][kBins + k];
      const float ivx = wr * xr + wi * xi;
      const float ivy = wr * yr + wi * yi;
      const float ivz = wr * zr + wi * zi;
      const float norm = fmaxf(sqrtf(ivx * ivx + ivy * ivy + ivz * ivz), eps);
      s.p[kRows + t][k] = ivx / norm;
      s.p[kRows + kTileT + t][k] = ivy / norm;
      s.p[kRows + 2 * kTileT + t][k] = ivz / norm;
    }
    __syncthreads();

#pragma unroll 4
    for (int k = 0; k < kBins; ++k) {
      const float4 f = *reinterpret_cast<const float4*>(&s.fb[k][4 * tx]);
#pragma unroll
      for (int j = 0; j < kOutPerThread; ++j) {
        const float pv = s.p[ty + 16 * j][k];
        out[j][0] = fmaf(pv, f.x, out[j][0]);
        out[j][1] = fmaf(pv, f.y, out[j][1]);
        out[j][2] = fmaf(pv, f.z, out[j][2]);
        out[j][3] = fmaf(pv, f.w, out[j][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kOutPerThread; ++j) {
    const int row = ty + 16 * j;
    const int t = t0 + row % kTileT;
    if (t >= T) continue;
    float* dst;
    if (row < kRows)
      dst = mel + ((static_cast<size_t>(clip) * kCh + row / kTileT) * T + t) *
                      kMels;
    else
      dst = iv + ((static_cast<size_t>(clip) * 3 + (row - kRows) / kTileT) *
                      T + t) * kMels;
    *reinterpret_cast<float4*>(dst + 4 * tx) =
        make_float4(out[j][0], out[j][1], out[j][2], out[j][3]);
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). n_fft must be a multiple of 32 and
// the filterbank 64 mels wide; all tensors contiguous.
int seld_foa_frontend(const void* wav, const void* wcat, const void* fbank,
                      void* mel, void* iv, int n, int Lp, int T, int hop,
                      int n_fft, int n_chunks, float eps, void* stream) {
  const dim3 grid((T + kTileT - 1) / kTileT, n);
  foa_frontend_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wav), static_cast<const float*>(wcat),
      static_cast<const float*>(fbank), static_cast<float*>(mel),
      static_cast<float*>(iv), Lp, T, hop, n_fft, n_chunks, eps);
  return static_cast<int>(cudaGetLastError());
}

const char* seld_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
