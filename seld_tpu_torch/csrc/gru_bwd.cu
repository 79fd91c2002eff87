// Keras reset_after GRU recurrence, backward through time, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel seld_tpu/ops/pallas/gru.py::_bwd_kernel, launched
// by _gru_scan_bwd_impl. Same contract:
//   x_proj [D, T, B, 3U], hs [D, T, B, U] and g = d loss / d hs [D, T, B, U]
//   (all f32 or all bf16), rec_kernel [D, U, 3U] f32, rec_bias [D, 3U] f32
//   -> dx_proj [D, T, B, 3U] in x_proj's dtype, dRk [D, U, 3U] f32,
//      dRb [D, 3U] f32.
// Each direction walks its scan in reverse (direction 0 t downwards,
// direction 1 t upwards). Per step, in f32 whatever the storage dtype:
//   h_prev = hs at the previous scan step (0 at the scan start)
//   hp = h_prev @ Rk + rb;  z, r, c = the forward's gates;  dh += g[t]
//   dz = dh (h_prev - c);  da_h = dh (1 - z)(1 - c^2);  dr = da_h * hh
//   da_z = dz z (1 - z);   da_r = dr r (1 - r)
//   dx_proj[t] = [da_z, da_r, da_h];  dhp = [da_z, da_r, da_h * r]
//   dh = dh z + dhp @ Rk^T;  dRk += h_prev^T dhp;  dRb += sum_b dhp
//
// Design. On the TPU, dh, dRk and dRb lived in VMEM across a sequential
// grid axis over T. Blocks here run in parallel and in no order, so:
//   1. gru_bwd_rec_kernel keeps the forward kernel's partition: grid =
//      (D, ceil(B / kBt)), one block owns kBt batch rows of one direction
//      and loops over all T in scan-reverse order with dh in registers. It
//      writes dx_proj and dhp (f32, a scratch buffer for pass 2).
//      Rk[d] sits in shared memory once per block with a row stride of
//      3U + 1 floats: the step's two products read it in both orientations
//      (thread j walks column j of Rk for h_prev @ Rk; thread (u, part) walks
//      row u for dhp @ Rk^T), and the odd stride puts both walks on 32
//      distinct banks per warp instead of one.
//   2. dRk is [U, 3U] f32 (192 KB at U = 128) and sums over every batch
//      tile, so it cannot sit in a block beside Rk, and f32 atomics would
//      make it nondeterministic. gru_bwd_reduce_kernel computes
//      dRk[d] = sum_{t,b} h_prev[d,t,b]^T dhp[d,t,b] (and dRb, the column
//      sums of dhp) as a tiled product over the T*B rows: each block owns a
//      32 x 32 output tile of one direction and one slice of the rows, so the
//      card is filled at B = 256; h_prev is read from hs at the shifted time
//      index, never materialised.
//   3. gru_bwd_finalize_kernel sums the slices' partials in a fixed order:
//      the result does not depend on block scheduling.
//
// What bounds it. At the training shape (D = 2, T = 60, B = 256, U = 128,
// bf16 storage) the three B x U x 3U products per step per direction are
// 9.1 GFLOP, 0.135 ms at the f32 rate outside the tensor cores (67 TFLOP/s),
// and the bytes (about 63 MB) 0.019 ms at 3.35 TB/s: operations-bound on
// paper. In practice pass 1 is latency-bound by 60 dependent steps, each two
// shared-memory dot products and four block barriers; only D * ceil(B / kBt)
// SMs work. Running the step's products on the tensor cores and splitting U
// over a thread block cluster is the route to a shorter step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBt = 4;      // batch rows per block in pass 1
constexpr int kTile = 32;   // dRk output tile edge in pass 2
constexpr int kChunk = 32;  // T*B rows staged per iteration in pass 2
constexpr int kReduceThreads = 256;
constexpr int kTargetBlocks = 528;  // about four waves of 132 SMs

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

// blockDim.x == 3U; U % 4 == 0 (float4 reads of h_prev).
template <typename T>
__global__ void gru_bwd_rec_kernel(const T* __restrict__ xp,
                                   const float* __restrict__ rk,
                                   const float* __restrict__ rb,
                                   const T* __restrict__ hs,
                                   const T* __restrict__ g,
                                   T* __restrict__ dxp,
                                   float* __restrict__ dhp, int steps,
                                   int batch, int units) {
  extern __shared__ __align__(16) float smem[];
  const int U = units;
  const int K = 3 * units;
  const int KP = K + 1;                 // padded row stride of Rk
  float* rk_s = smem;                   // [U][KP]
  float* h_s = rk_s + U * KP;           // [kBt][U]  (U * KP % 4 == 0)
  float* hp_s = h_s + kBt * U;          // [kBt][K]
  float* dhp_s = hp_s + kBt * K;        // [kBt][K]
  float* part_s = dhp_s + kBt * K;      // [3][kBt][U]

  const int d = blockIdx.x;
  const int b0 = blockIdx.y * kBt;
  const int tid = threadIdx.x;
  const int rows = min(kBt, batch - b0);

  const float* rk_d = rk + static_cast<size_t>(d) * U * K;
  for (int i = tid; i < U * K; i += K) rk_s[(i / K) * KP + i % K] = rk_d[i];
  const float bias = rb[static_cast<size_t>(d) * K + tid];
  float dh_reg[kBt];
#pragma unroll
  for (int b = 0; b < kBt; ++b) dh_reg[b] = 0.0f;
  __syncthreads();

  for (int p = steps - 1; p >= 0; --p) {
    const int t = d == 0 ? p : steps - 1 - p;
    const int tp = d == 0 ? p - 1 : steps - p;  // real t of scan step p - 1
    const size_t row0 = (static_cast<size_t>(d) * steps + t) * batch + b0;
    const size_t prow0 = (static_cast<size_t>(d) * steps + tp) * batch + b0;

    float xz[kBt], xr[kBt], xh[kBt], gg[kBt];
#pragma unroll
    for (int b = 0; b < kBt; ++b) {
      xz[b] = xr[b] = xh[b] = gg[b] = 0.0f;
      if (tid < U) {
        float hv = 0.0f;
        if (b < rows) {
          const T* x = xp + (row0 + b) * K;
          xz[b] = to_f32(x[tid]);
          xr[b] = to_f32(x[U + tid]);
          xh[b] = to_f32(x[2 * U + tid]);
          gg[b] = to_f32(g[(row0 + b) * U + tid]);
          if (p > 0) hv = to_f32(hs[(prow0 + b) * U + tid]);
        }
        h_s[b * U + tid] = hv;
      }
    }
    __syncthreads();

    // hp[b][j] = h_prev[b] . Rk[:, j] + rb[j]  (thread j, column j)
    float acc[kBt];
#pragma unroll
    for (int b = 0; b < kBt; ++b) acc[b] = 0.0f;
    for (int k = 0; k < U; k += 4) {
      const float w0 = rk_s[(k + 0) * KP + tid];
      const float w1 = rk_s[(k + 1) * KP + tid];
      const float w2 = rk_s[(k + 2) * KP + tid];
      const float w3 = rk_s[(k + 3) * KP + tid];
#pragma unroll
      for (int b = 0; b < kBt; ++b) {
        const float4 h4 = *reinterpret_cast<const float4*>(h_s + b * U + k);
        acc[b] = fmaf(h4.x, w0, acc[b]);
        acc[b] = fmaf(h4.y, w1, acc[b]);
        acc[b] = fmaf(h4.z, w2, acc[b]);
        acc[b] = fmaf(h4.w, w3, acc[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < kBt; ++b) hp_s[b * K + tid] = acc[b] + bias;
    __syncthreads();

    // gates and their derivatives (thread u < U, unit u)
    if (tid < U) {
#pragma unroll
      for (int b = 0; b < kBt; ++b) {
        float* ds = dhp_s + b * K;
        if (b < rows) {
          const float* hp = hp_s + b * K;
          const float h_prev = h_s[b * U + tid];
          const float z = sigmoid(xz[b] + hp[tid]);
          const float r = sigmoid(xr[b] + hp[U + tid]);
          const float hh = hp[2 * U + tid];
          const float c = tanhf(xh[b] + r * hh);
          const float dh = dh_reg[b] + gg[b];
          const float dz = dh * (h_prev - c);
          const float da_h = dh * (1.0f - z) * (1.0f - c * c);
          const float dr = da_h * hh;
          const float da_z = dz * z * (1.0f - z);
          const float da_r = dr * r * (1.0f - r);
          T* dx = dxp + (row0 + b) * K;
          store(dx + tid, da_z);
          store(dx + U + tid, da_r);
          store(dx + 2 * U + tid, da_h);
          float* dg = dhp + (row0 + b) * K;
          dg[tid] = da_z;
          dg[U + tid] = da_r;
          dg[2 * U + tid] = da_h * r;
          ds[tid] = da_z;
          ds[U + tid] = da_r;
          ds[2 * U + tid] = da_h * r;
          dh_reg[b] = dh * z;
        } else {
          ds[tid] = ds[U + tid] = ds[2 * U + tid] = 0.0f;
        }
      }
    }
    __syncthreads();

    // (dhp @ Rk^T)[b][u], split in three parts of U columns each so that
    // all 3U threads work: thread (u, part) walks row u of Rk
    {
      const int u = tid % U;
      const int part = tid / U;
      const float* rrow = rk_s + u * KP + part * U;
      const float* dp = dhp_s + part * U;
      float acc2[kBt];
#pragma unroll
      for (int b = 0; b < kBt; ++b) acc2[b] = 0.0f;
      for (int jj = 0; jj < U; ++jj) {
        const float w = rrow[jj];
#pragma unroll
        for (int b = 0; b < kBt; ++b) acc2[b] = fmaf(dp[b * K + jj], w, acc2[b]);
      }
#pragma unroll
      for (int b = 0; b < kBt; ++b) part_s[(part * kBt + b) * U + u] = acc2[b];
    }
    __syncthreads();

    if (tid < U) {
#pragma unroll
      for (int b = 0; b < kBt; ++b) {
        dh_reg[b] += part_s[(0 * kBt + b) * U + tid] +
                     part_s[(1 * kBt + b) * U + tid] +
                     part_s[(2 * kBt + b) * U + tid];
      }
    }
    // the next step rewrites h_s, hp_s, dhp_s and part_s only after a
    // barrier that every reader of this step has passed
  }
}

// part[s][d][u][j] = sum over rows n of slice s of h_prev[d, n, u] *
// dhp[d, n, j] for u < U; part[s][d][U][j] = sum of dhp[d, n, j].
// Row n = t * B + b; h_prev of (d, t, b) is hs[d, t - 1, b] for d = 0 and
// hs[d, t + 1, b] for d = 1, zero at the scan start.
template <typename T>
__global__ void gru_bwd_reduce_kernel(const T* __restrict__ hs,
                                      const float* __restrict__ dhp,
                                      float* __restrict__ part, int n_dirs,
                                      int steps, int batch, int units,
                                      int rows_per_slice) {
  __shared__ float a_s[kChunk][kTile];  // h_prev rows
  __shared__ float b_s[kChunk][kTile];  // dhp rows
  const int U = units;
  const int K = 3 * units;
  const int N = steps * batch;
  const int j0 = blockIdx.x * kTile;
  const int u0 = blockIdx.y * kTile;
  const int d = blockIdx.z % n_dirs;
  const int s = blockIdx.z / n_dirs;
  const int tid = threadIdx.x;
  const int tj = tid % kTile;
  const int tq = tid / kTile;  // 0..7: rows tq*4 .. tq*4+3 of the tile
  const int n_begin = s * rows_per_slice;
  const int n_end = min(N, n_begin + rows_per_slice);
  const bool with_bias = blockIdx.y == 0 && tq == 0;

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float bsum = 0.0f;
  const T* hs_d = hs + static_cast<size_t>(d) * N * U;
  const float* dhp_d = dhp + static_cast<size_t>(d) * N * K;
  for (int n0 = n_begin; n0 < n_end; n0 += kChunk) {
    for (int i = tid; i < kChunk * kTile; i += kReduceThreads) {
      const int r = i / kTile;
      const int c = i % kTile;
      const int n = n0 + r;
      float av = 0.0f, bv = 0.0f;
      if (n < n_end) {
        const int t = n / batch;
        const int b = n % batch;
        const int tp = d == 0 ? t - 1 : t + 1;
        if (tp >= 0 && tp < steps && u0 + c < U)
          av = to_f32(hs_d[(static_cast<size_t>(tp) * batch + b) * U + u0 + c]);
        if (j0 + c < K) bv = dhp_d[static_cast<size_t>(n) * K + j0 + c];
      }
      a_s[r][c] = av;
      b_s[r][c] = bv;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      const float bv = b_s[k][tj];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(a_s[k][tq * 4 + i], bv, acc[i]);
      if (with_bias) bsum += bv;
    }
    __syncthreads();
  }
  const int j = j0 + tj;
  if (j >= K) return;
  float* out = part + (static_cast<size_t>(s) * n_dirs + d) * (U + 1) * K;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = u0 + tq * 4 + i;
    if (u < U) out[static_cast<size_t>(u) * K + j] = acc[i];
  }
  if (with_bias) out[static_cast<size_t>(U) * K + j] = bsum;
}

__global__ void gru_bwd_finalize_kernel(const float* __restrict__ part,
                                        float* __restrict__ drk,
                                        float* __restrict__ drb, int slices,
                                        int n_dirs, int units) {
  const int U = units;
  const int K = 3 * units;
  const size_t per_dir = static_cast<size_t>(U + 1) * K;
  const size_t total = n_dirs * per_dir;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float sum = 0.0f;
  for (int s = 0; s < slices; ++s) sum += part[s * total + i];  // fixed order
  const size_t d = i / per_dir;
  const size_t rem = i % per_dir;
  const size_t u = rem / K;
  const size_t j = rem % K;
  if (u < static_cast<size_t>(U))
    drk[(d * U + u) * K + j] = sum;
  else
    drb[d * K + j] = sum;
}

size_t rec_smem_bytes(int U) {
  const size_t K = 3 * static_cast<size_t>(U);
  return sizeof(float) *
         (U * (K + 1) + kBt * U + 2 * kBt * K + 3 * kBt * U);
}

int tiles(int D, int U) {
  const int K = 3 * U;
  return D * ((U + kTile - 1) / kTile) * ((K + kTile - 1) / kTile);
}

int rows_per_slice(int N, int slices) {
  const int rows = (N + slices - 1) / slices;
  return (rows + kChunk - 1) / kChunk * kChunk;
}

// Row slices of the dRk reduction for N = T * B rows: enough blocks for
// about four waves, and at least four row chunks per slice.
int reduce_slices(int D, int N, int U) {
  const int want = (kTargetBlocks + tiles(D, U) - 1) / tiles(D, U);
  const int most = (N + 4 * kChunk - 1) / (4 * kChunk);
  const int s = want < most ? want : most;
  return s < 1 ? 1 : s;
}

// The workspace holds dhp [D, T * B, 3U] f32, then the reduction's
// partials [slices, D, U + 1, 3U] f32.
size_t dhp_floats(int D, int N, int U) {
  return static_cast<size_t>(D) * N * 3 * U;
}

size_t workspace_floats(int D, int N, int U) {
  return dhp_floats(D, N, U) + static_cast<size_t>(reduce_slices(D, N, U)) *
                                   D * (U + 1) * 3 * U;
}

template <typename T>
cudaError_t launch(const void* xp, const float* rk, const float* rb,
                   const void* hs, const void* g, void* dxp, float* workspace,
                   float* drk, float* drb, int D, int T_steps, int B, int U,
                   cudaStream_t stream) {
  const int K = 3 * U;
  const int N = T_steps * B;
  const int slices = reduce_slices(D, N, U);
  float* dhp = workspace;
  float* part = workspace + dhp_floats(D, N, U);
  const size_t smem = rec_smem_bytes(U);
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_rec_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  gru_bwd_rec_kernel<T><<<dim3(D, (B + kBt - 1) / kBt), K, smem, stream>>>(
      static_cast<const T*>(xp), rk, rb, static_cast<const T*>(hs),
      static_cast<const T*>(g), static_cast<T*>(dxp), dhp, T_steps, B, U);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid((K + kTile - 1) / kTile, (U + kTile - 1) / kTile,
                  D * slices);
  gru_bwd_reduce_kernel<T><<<grid, kReduceThreads, 0, stream>>>(
      static_cast<const T*>(hs), dhp, part, D, T_steps, B, U,
      rows_per_slice(N, slices));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t total = static_cast<size_t>(D) * (U + 1) * K;
  const unsigned fin_blocks = static_cast<unsigned>((total + 255) / 256);
  gru_bwd_finalize_kernel<<<fin_blocks, 256, 0, stream>>>(
      part, drk, drb, slices, D, U);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the recurrence kernel asks for, so the wrapper can refuse a
// U that does not fit before it launches.
size_t seld_gru_bwd_smem_bytes(int U) { return rec_smem_bytes(U); }

// Bytes of scratch one call needs (dhp and the dRk/dRb partials); the
// wrapper allocates them as one flat buffer, whose layout is this file's.
size_t seld_gru_bwd_workspace_bytes(int D, int T_steps, int B, int U) {
  return sizeof(float) * workspace_floats(D, T_steps * B, U);
}

// Returns a cudaError_t (0 on success). is_bf16 selects the storage type of
// x_proj, hs, g and dx_proj; rk, rb, drk and drb are f32, and workspace
// holds seld_gru_bwd_workspace_bytes(D, T_steps, B, U) bytes.
int seld_gru_bwd(const void* xp, const void* rk, const void* rb,
                 const void* hs, const void* g, void* dxp, void* workspace,
                 void* drk, void* drb, int D, int T_steps, int B, int U,
                 int is_bf16, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* rkf = static_cast<const float*>(rk);
  const auto* rbf = static_cast<const float*>(rb);
  auto* ws = static_cast<float*>(workspace);
  auto* drkf = static_cast<float*>(drk);
  auto* drbf = static_cast<float*>(drb);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(xp, rkf, rbf, hs, g, dxp, ws, drkf,
                                      drbf, D, T_steps, B, U, st)
              : launch<float>(xp, rkf, rbf, hs, g, dxp, ws, drkf, drbf, D,
                              T_steps, B, U, st);
  return static_cast<int>(err);
}

const char* seld_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
