// Keras reset_after GRU recurrence, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel seld_tpu/ops/pallas/gru.py::_fwd_kernel, launched
// by _gru_scan_fwd_impl. Same contract:
//   x_proj [D, T, B, 3U] (f32 or bf16; input projection incl. input bias,
//   gate order z|r|h), rec_kernel [D, U, 3U] f32, rec_bias [D, 3U] f32
//   -> hs [D, T, B, U] in x_proj's dtype, REAL-time indexed: direction 0
//   runs t ascending, direction 1 descending, and each state lands at its t.
//   All math is f32 whatever the storage dtype:
//     hp = h @ Rk + rb;  z = sig(xz + hz);  r = sig(xr + hr)
//     c  = tanh(xh + r * hh);  h' = z * h + (1 - z) * c
//
// Design. On the TPU a sequential grid axis over T carried h in VMEM from
// one grid step to the next. Blocks here run in parallel and in no order, so
// a loop over T inside one block takes that axis' place:
//   - grid = (D, ceil(B / kBt)); one block owns kBt batch rows of one
//     direction for all T steps, so h never leaves the SM;
//   - Rk[d] (U x 3U f32, 192 KB at U = 128) sits in dynamic shared memory,
//     loaded once per block; h is double-buffered in shared memory;
//   - thread j < 3U owns gate column j of h @ Rk for the block's rows; thread
//     u < U then owns unit u: it keeps h[:, u] in registers, applies the
//     gates and writes h' at the real t. A ragged last batch tile is masked;
//   - the step's x_proj loads are issued before the product so their
//     latency hides behind it.
//
// What bounds it: not bytes and not FLOPs. At SS5's serving shape (D = 2,
// U = 128, T = 60, B = 32) x_proj is 5.9 MB and the product 0.38 GFLOP,
// microseconds of the card's peak rates; the kernel's time is the serial
// chain of T dependent steps, each a shared-memory-bound U-deep dot product
// plus two block barriers. Only D * ceil(B / kBt) of the 132 SMs are busy
// (16 at B = 32). A later version can split U over a thread block cluster
// and run the step's product on the tensor cores (wgmma) to shorten each
// step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBt = 4;  // batch rows per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}
__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// blockDim.x == 3U; U % 4 == 0 (float4 reads of h).
template <typename T>
__global__ void gru_fwd_kernel(const T* __restrict__ xp,
                               const float* __restrict__ rk,
                               const float* __restrict__ rb,
                               T* __restrict__ hs, int steps, int batch,
                               int units) {
  extern __shared__ __align__(16) float smem[];
  const int U = units;
  const int K = 3 * units;
  float* h_s = smem;               // [2][kBt][U]
  float* hp_s = h_s + 2 * kBt * U;  // [kBt][K]
  float* rk_s = hp_s + kBt * K;     // [U][K]

  const int d = blockIdx.x;
  const int b0 = blockIdx.y * kBt;
  const int j = threadIdx.x;
  const int rows = min(kBt, batch - b0);

  const float* rk_d = rk + static_cast<size_t>(d) * U * K;
  for (int i = j; i < U * K; i += K) rk_s[i] = rk_d[i];
  for (int i = j; i < 2 * kBt * U; i += K) h_s[i] = 0.0f;
  const float bias = rb[static_cast<size_t>(d) * K + j];
  float h_reg[kBt];
#pragma unroll
  for (int b = 0; b < kBt; ++b) h_reg[b] = 0.0f;
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const int t = d == 0 ? s : steps - 1 - s;
    const size_t row0 =
        (static_cast<size_t>(d) * steps + t) * batch + b0;  // row (d, t, b0)
    const float* h_cur = h_s + (s & 1) * kBt * U;
    float* h_nxt = h_s + ((s & 1) ^ 1) * kBt * U;

    float xz[kBt], xr[kBt], xh[kBt];
#pragma unroll
    for (int b = 0; b < kBt; ++b) {
      xz[b] = xr[b] = xh[b] = 0.0f;
      if (j < U && b < rows) {
        const T* x = xp + (row0 + b) * K;
        xz[b] = to_f32(x[j]);
        xr[b] = to_f32(x[U + j]);
        xh[b] = to_f32(x[2 * U + j]);
      }
    }

    // hp[b][j] = h[b] . Rk[:, j] + rb[j]
    float acc[kBt];
#pragma unroll
    for (int b = 0; b < kBt; ++b) acc[b] = 0.0f;
    for (int k = 0; k < U; k += 4) {
      const float w0 = rk_s[(k + 0) * K + j];
      const float w1 = rk_s[(k + 1) * K + j];
      const float w2 = rk_s[(k + 2) * K + j];
      const float w3 = rk_s[(k + 3) * K + j];
#pragma unroll
      for (int b = 0; b < kBt; ++b) {
        const float4 h4 = *reinterpret_cast<const float4*>(h_cur + b * U + k);
        acc[b] = fmaf(h4.x, w0, acc[b]);
        acc[b] = fmaf(h4.y, w1, acc[b]);
        acc[b] = fmaf(h4.z, w2, acc[b]);
        acc[b] = fmaf(h4.w, w3, acc[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < kBt; ++b) hp_s[b * K + j] = acc[b] + bias;
    __syncthreads();

    if (j < U) {
#pragma unroll
      for (int b = 0; b < kBt; ++b) {
        if (b < rows) {
          const float* hp = hp_s + b * K;
          const float z = sigmoid(xz[b] + hp[j]);
          const float r = sigmoid(xr[b] + hp[U + j]);
          const float c = tanhf(xh[b] + r * hp[2 * U + j]);
          const float hn = z * h_reg[b] + (1.0f - z) * c;
          h_reg[b] = hn;
          h_nxt[b * U + j] = hn;
          store(hs + (row0 + b) * U + j, hn);
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* xp, const float* rk, const float* rb, void* hs,
                   int D, int T_steps, int B, int U, cudaStream_t stream) {
  const int K = 3 * U;
  const size_t smem =
      sizeof(float) * (2 * kBt * U + kBt * K + static_cast<size_t>(U) * K);
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(D, (B + kBt - 1) / kBt);
  gru_fwd_kernel<T><<<grid, K, smem, stream>>>(
      static_cast<const T*>(xp), rk, rb, static_cast<T*>(hs), T_steps, B, U);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the kernel asks for, so the wrapper can refuse a U that
// does not fit before it launches.
size_t seld_gru_fwd_smem_bytes(int U) {
  const size_t K = 3 * static_cast<size_t>(U);
  return sizeof(float) * (2 * kBt * U + kBt * K + U * K);
}

// Returns a cudaError_t (0 on success). is_bf16 selects the storage type of
// x_proj and hs.
int seld_gru_fwd(const void* xp, const void* rk, const void* rb, void* hs,
                 int D, int T_steps, int B, int U, int is_bf16,
                 void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* rkf = static_cast<const float*>(rk);
  const auto* rbf = static_cast<const float*>(rb);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(xp, rkf, rbf, hs, D, T_steps, B, U, st)
              : launch<float>(xp, rkf, rbf, hs, D, T_steps, B, U, st);
  return static_cast<int>(err);
}

const char* seld_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
