// Fused FOA feature front-end for Hopper (sm_90a).
//
// Replaces the TPU kernels seld_tpu/ops/pallas/frontend.py::_frontend_kernel
// (launched by fused_foa_frontend) and ::_frontend_kernel_2d (launched by
// fused_foa_frontend_2d). The two differ only in how the TPU laid frames out
// for its (8, 128) tiles; one kernel computes their function for both.
//
// Contract, for a chunk of n equal-length 4-channel clips (ACN W, Y, Z, X):
//   wav     [n, 4, Lp] f32, already scaled and reflect-padded by 512 on each
//           side (Lp = L + 1024); frame k of channel c is
//           wav[clip, c, k * hop : k * hop + 1024], k < T = 1 + (Lp - 1024)
//           / hop
//   window  [1024] f32, the periodic Hann window padded to 1024
//   tw      [832] complex f32 twiddles exp(-2 pi i m / N), built in float64
//           by seld_tpu_torch/ops/frontend.py::_twiddles: W_512^(j k1) at
//           j * 8 + k1, W_64^(b c) at 512 + b * 8 + c, W_1024^k at 576 + k
//   fb_idx  [129] int32: each mel's first bin, then the row pointers of
//   fb_w    [nnz] f32, the HTK filterbank as one contiguous run a mel
//   -> mel [n, 4, T, 64] = |X|^2 projected on the filterbank (before dB),
//      iv  [n, 3, T, 64] = Re(conj(W) {X, Y, Z}) normalised over (x, y, z)
//          with an eps floor, projected on the filterbank.
// An all-zero frame gives exactly 0 in both (its IV is 0 / eps).
//
// Design. A block owns kFrames consecutive frames of one clip for all 4
// channels (the IV couples the channels); 64 threads work on each channel's
// FFT. Per frame:
//   - each 1024-sample real frame is read straight from the padded wav (no
//     frames tensor; consecutive frames overlap by 544 samples and meet in
//     L1/L2) as the 512-point complex sequence z[n] = x[2n] + i x[2n+1],
//     the window applied on load; the next frame's samples are loaded while
//     this one is transformed;
//   - a 512-point complex FFT, radix 8 x 8 x 8: thread j holds 8 complex
//     values in registers for each pass (an 8-point DFT and one twiddle
//     multiply), and two shared-memory transposes join the passes. Their
//     rows are padded (72 and 9-word strides) so that every store and load
//     of a warp falls on 32 distinct banks;
//   - the real split step gives bins k and 512 - k from Z[k] and Z[512 - k]
//     (thread k < 256; thread 0 also bin 256), then the power of the four
//     channels and the three normalised IV components of those bins, into a
//     [7][513] row block of shared memory;
//   - every 2 frames, thread (frame, mel, power or IV rows) sums its mel's
//     run of bins (at most 2 mels a bin, 999 non-zeros in all at 64 mels)
//     in bin order and writes 64 consecutive mels of a row: coalesced.
// Arithmetic is plain f32 (no TF32, no tensor cores): the dB step amplifies
// relative error in quiet bins and the IV normalisation amplifies it where
// energy is low, so the function is held to f32 accuracy; and at ~20 flops
// a byte read it is no tensor-core problem anyway.
//
// What bounds it: bytes. One chunk of 8 clips of 60 s at 24 kHz reads 184 MB
// of padded wav and writes 43 MB of features, 0.068 ms at 3.35 TB/s. Its
// operations are a real FFT of 1024 points per frame and channel
// (2.5 N log2 N), the per-bin power and IV and the filterbank's 999
// non-zeros: 3.3 GFLOP, 0.049 ms at 67 TFLOP/s. Beyond both, the FFT moves
// each value through shared memory about seven times (two transposes, the
// natural-order spectrum read twice, the per-bin values): ~1.5 GB a chunk,
// some 0.05 ms at the card's shared-memory rate, and each frame costs
// three block barriers and a half. The previous design computed the DFT as
// dense f32 products against the bases (201.8 GFLOP a chunk, 13.7 ms).
#include <cuda_runtime.h>

namespace {

constexpr int kCh = 4;                 // FOA channels
constexpr int kFftThreads = 64;        // threads per channel's FFT
constexpr int kThreads = kCh * kFftThreads;
constexpr int kFrames = 4;             // frames per block
constexpr int kGroup = 2;              // frames per filterbank projection
constexpr int kN = 512;                // complex FFT length (n_fft / 2)
constexpr int kBins = kN + 1;          // real-DFT bins
constexpr int kMels = 64;
constexpr int kRow = 72;               // padded k1 row of a transpose buffer
constexpr int kPass = 8 * kRow;        // one channel's transpose buffer
constexpr int kValRow = 516;           // padded row of per-bin values
constexpr int kMaxNnz = 2 * kBins;     // each bin feeds at most 2 mels
constexpr int kTw2 = 512, kTw3 = 576;  // twiddle table sections
constexpr float kSqrtHalf = 0.707106781186547524f;

struct Smem {
  float a_re[kCh][kPass], a_im[kCh][kPass];  // pass 1 -> pass 2
  float b_re[kCh][kPass], b_im[kCh][kPass];  // pass 2 -> pass 3
  float z_re[kCh][kN], z_im[kCh][kN];        // the FFT's output, bin order
  float val[kGroup][7][kValRow];  // power W, Y, Z, X; IV x, y, z
  float fb_w[kMaxNnz];
  int fb_start[kMels];
  int fb_ptr[kMels + 1];
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 mul_mi(float2 a) {  // a * -i
  return make_float2(a.y, -a.x);
}
__device__ __forceinline__ float2 mul_w8(float2 a) {  // a * exp(-i pi / 4)
  return make_float2(kSqrtHalf * (a.x + a.y), kSqrtHalf * (a.y - a.x));
}
__device__ __forceinline__ float2 mul_w8_3(float2 a) {  // a * exp(-3i pi/4)
  return make_float2(kSqrtHalf * (a.y - a.x), -kSqrtHalf * (a.x + a.y));
}

// v <- its 8-point DFT (exp(-2 pi i n k / 8)), by radix-2 decimation in
// frequency: v[n] +- v[n + 4], then the two 4-point halves
__device__ __forceinline__ void dft8(float2 (&v)[8]) {
  const float2 a0 = cadd(v[0], v[4]), a4 = csub(v[0], v[4]);
  const float2 a1 = cadd(v[1], v[5]), a5 = mul_w8(csub(v[1], v[5]));
  const float2 a2 = cadd(v[2], v[6]), a6 = mul_mi(csub(v[2], v[6]));
  const float2 a3 = cadd(v[3], v[7]), a7 = mul_w8_3(csub(v[3], v[7]));
  const float2 b0 = cadd(a0, a2), b2 = csub(a0, a2);
  const float2 b1 = cadd(a1, a3), b3 = mul_mi(csub(a1, a3));
  const float2 b4 = cadd(a4, a6), b6 = csub(a4, a6);
  const float2 b5 = cadd(a5, a7), b7 = mul_mi(csub(a5, a7));
  v[0] = cadd(b0, b1);
  v[4] = csub(b0, b1);
  v[2] = cadd(b2, b3);
  v[6] = csub(b2, b3);
  v[1] = cadd(b4, b5);
  v[5] = csub(b4, b5);
  v[3] = cadd(b6, b7);
  v[7] = csub(b6, b7);
}

// z[64 n1 + j] of frame t, windowed, for n1 < 8; zeros past the last frame
__device__ __forceinline__ void load_frame(float2 (&v)[8],
                                           const float* __restrict__ w, int t,
                                           int T, int hop, int j,
                                           const float2 (&win)[8]) {
  if (t < T) {
    const float* f = w + static_cast<size_t>(t) * hop + 2 * j;
#pragma unroll
    for (int n1 = 0; n1 < 8; ++n1)
      v[n1] = make_float2(f[128 * n1] * win[n1].x,
                          f[128 * n1 + 1] * win[n1].y);
  } else {
#pragma unroll
    for (int n1 = 0; n1 < 8; ++n1) v[n1] = make_float2(0.0f, 0.0f);
  }
}

// power of the 4 channels and the normalised IV of one bin into val[.][k]
__device__ __forceinline__ void bin_values(float (&val)[7][kValRow], int k,
                                           const float2 (&x)[kCh],
                                           float eps) {
#pragma unroll
  for (int c = 0; c < kCh; ++c) val[c][k] = x[c].x * x[c].x + x[c].y * x[c].y;
  // ACN order W, Y, Z, X: IV x pairs W with X, y with Y, z with Z
  const float ivx = x[0].x * x[3].x + x[0].y * x[3].y;
  const float ivy = x[0].x * x[1].x + x[0].y * x[1].y;
  const float ivz = x[0].x * x[2].x + x[0].y * x[2].y;
  const float norm = fmaxf(sqrtf(ivx * ivx + ivy * ivy + ivz * ivz), eps);
  val[4][k] = ivx / norm;
  val[5][k] = ivy / norm;
  val[6][k] = ivz / norm;
}

__global__ void __launch_bounds__(kThreads, 2)
foa_frontend_kernel(const float* __restrict__ wav,
                    const float* __restrict__ window,
                    const float2* __restrict__ tw,
                    const int* __restrict__ fb_idx,
                    const float* __restrict__ fb_w, float* __restrict__ mel,
                    float* __restrict__ iv, int Lp, int T, int hop,
                    float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int ch = tid / kFftThreads;  // the channel of this thread's FFT
  const int j = tid % kFftThreads;
  const int hi = j / 8, lo = j % 8;  // pass 2: (k1, b); pass 3: (k1, c)
  const int clip = blockIdx.y;
  const int t0 = blockIdx.x * kFrames;
  const float* w = wav + (static_cast<size_t>(clip) * kCh + ch) * Lp;

  for (int i = tid; i < kMels; i += kThreads) s.fb_start[i] = fb_idx[i];
  for (int i = tid; i <= kMels; i += kThreads) s.fb_ptr[i] = fb_idx[kMels + i];
  const int nnz = fb_idx[2 * kMels];
  for (int i = tid; i < nnz; i += kThreads) s.fb_w[i] = fb_w[i];

  // this thread's constants for all frames: the window at its samples, the
  // twiddles of its passes, the split step's W_1024^tid
  float2 win[8], tw1[8], tw2[8];
#pragma unroll
  for (int n1 = 0; n1 < 8; ++n1) {
    const int n = 2 * (64 * n1 + j);
    win[n1] = make_float2(window[n], window[n + 1]);
    tw1[n1] = tw[j * 8 + n1];
    tw2[n1] = tw[kTw2 + lo * 8 + n1];
  }
  const float2 tw3 = tw[kTw3 + tid];
  const int km = (kN - tid) & (kN - 1);  // Z's mirror index, 0 for tid 0

  float2 v[8];
  load_frame(v, w, t0, T, hop, j, win);
  for (int f = 0; f < kFrames; ++f) {
    // pass 1: n = 64 n1 + j; the 8-point DFT over n1, times W_512^(j k1)
    dft8(v);
#pragma unroll
    for (int k1 = 0; k1 < 8; ++k1) {
      const float2 y = cmul(v[k1], tw1[k1]);
      s.a_re[ch][k1 * kRow + j] = y.x;
      s.a_im[ch][k1 * kRow + j] = y.y;
    }
    if (f + 1 < kFrames) load_frame(v, w, t0 + f + 1, T, hop, j, win);
    __syncthreads();

    // pass 2: thread (k1, b), the 64-point DFT's element n2 = 8 a + b; the
    // 8-point DFT over a, times W_64^(b c)
    float2 u[8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
      u[a] = make_float2(s.a_re[ch][hi * kRow + 8 * a + lo],
                         s.a_im[ch][hi * kRow + 8 * a + lo]);
    dft8(u);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float2 y = cmul(u[c], tw2[c]);
      s.b_re[ch][hi * kRow + 9 * c + lo] = y.x;
      s.b_im[ch][hi * kRow + 9 * c + lo] = y.y;
    }
    __syncthreads();

    // pass 3: thread (k1, c); the 8-point DFT over b gives Z[k1 + 8 c + 64 e]
#pragma unroll
    for (int b = 0; b < 8; ++b)
      u[b] = make_float2(s.b_re[ch][hi * kRow + 9 * lo + b],
                         s.b_im[ch][hi * kRow + 9 * lo + b]);
    dft8(u);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s.z_re[ch][hi + 8 * lo + 64 * e] = u[e].x;
      s.z_im[ch][hi + 8 * lo + 64 * e] = u[e].y;
    }
    __syncthreads();

    // split step, thread k = tid: with E = (Z[k] + conj Z[512 - k]) / 2 and
    // O = -i (Z[k] - conj Z[512 - k]) / 2, X[k] = E + W^k O and
    // X[512 - k] = conj(E - W^k O); for k = 0 those are bins 0 and 512
    float (&val)[7][kValRow] = s.val[f % kGroup];
    {
      float2 x[kCh], xm[kCh];
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        const float2 zk = make_float2(s.z_re[c][tid], s.z_im[c][tid]);
        const float2 zm = make_float2(s.z_re[c][km], s.z_im[c][km]);
        const float2 e = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
        const float2 o = make_float2(0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));
        const float2 wo = cmul(tw3, o);
        x[c] = cadd(e, wo);
        xm[c] = make_float2(e.x - wo.x, wo.y - e.y);
      }
      bin_values(val, tid, x, eps);
      bin_values(val, kN - tid, xm, eps);
      if (tid == 0) {  // X[256] = conj Z[256]
#pragma unroll
        for (int c = 0; c < kCh; ++c)
          x[c] = make_float2(s.z_re[c][kN / 2], -s.z_im[c][kN / 2]);
        bin_values(val, kN / 2, x, eps);
      }
    }

    if (f % kGroup == kGroup - 1) {
      __syncthreads();
      // thread (frame g, power or IV rows, mel m): its mel's run of bins
      const int g = tid / 128;
      const bool ivrows = (tid / 64) % 2 == 1;
      const int m = tid % 64;
      const int t = t0 + f - (kGroup - 1) + g;
      const int k0 = s.fb_start[m], p0 = s.fb_ptr[m], len = s.fb_ptr[m + 1] - p0;
      const float (&vg)[7][kValRow] = s.val[g];
      const int r0 = ivrows ? 4 : 0;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int i = 0; i < len; ++i) {
        const float wt = s.fb_w[p0 + i];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (r0 + r < 7) acc[r] = fmaf(wt, vg[r0 + r][k0 + i], acc[r]);
      }
      if (t < T) {
        if (ivrows) {
#pragma unroll
          for (int r = 0; r < 3; ++r)
            iv[((static_cast<size_t>(clip) * 3 + r) * T + t) * kMels + m] =
                acc[r];
        } else {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            mel[((static_cast<size_t>(clip) * kCh + r) * T + t) * kMels + m] =
                acc[r];
        }
      }
    }
  }
}

static_assert(kFrames % kGroup == 0, "a block's frames fill whole groups");
static_assert(kThreads == kGroup * 2 * kMels, "projection threads");
static_assert(kThreads == kN / 2, "split-step threads: bins k and 512 - k");

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). n_fft is 1024, the filterbank 64
// mels wide with at most 1026 non-zeros; all tensors contiguous.
int seld_foa_frontend(const void* wav, const void* window,
                      const void* twiddles, const void* fb_idx,
                      const void* fb_w, void* mel, void* iv, int n, int Lp,
                      int T, int hop, float eps, void* stream) {
  const int smem = static_cast<int>(sizeof(Smem));
  // once a device: the attribute persists, and a call being captured into
  // a CUDA graph then makes no call but the launch
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !configured[dev]) {
    err = cudaFuncSetAttribute(foa_frontend_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) configured[dev] = true;
  }
  const dim3 grid((T + kFrames - 1) / kFrames, n);
  foa_frontend_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wav), static_cast<const float*>(window),
      static_cast<const float2*>(twiddles), static_cast<const int*>(fb_idx),
      static_cast<const float*>(fb_w), static_cast<float*>(mel),
      static_cast<float*>(iv), Lp, T, hop, eps);
  return static_cast<int>(cudaGetLastError());
}

const char* seld_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
