// Fused stem backward, the one full-resolution pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel seld_tpu/ops/pallas/stem_bwd.py::_dy_kernel,
// launched by _dy_call. Same contract:
//   y [B, T, F, C] (the conv output plus bias, f32 or bf16, any strides),
//   dpooled [B, T/pt, F/pf, C] (f32 or bf16, any strides), params6 [6, C]
//   f32 rows (mean, inv = rsqrt(var + eps), gamma, beta, dgamma/n,
//   dbeta/n), affine [2, C] f32 (the forward's scale and shift, already
//   rounded to y's dtype)
//   -> dy like y, and per-block partial sums of dy for dbias.
// Per pooling window of one (b, c):
//   bno  = y * scale + shift in y's dtype, rounding after the product and
//          after the sum, exactly as the forward's eager PyTorch ops did:
//          the routing below compares against the window max, so any other
//          formula (or a fused multiply-add) would silently misroute
//   m    = max(bno);  eq = (bno == m) & (bno > 0);  cnt = sum(eq)
//   dyr  = eq * dpooled / max(cnt, 1)     (ties split by count)
//   xhat = (y - mean) * inv
//   dy   = inv * gamma * (dyr - dbeta/n - xhat * dgamma/n)
//
// Design. One thread owns one pooling window of one channel (pt x pf
// elements, at most kMaxWin) and holds it in registers: it reads every
// element before it writes any, so dy may overwrite y in place (the fused
// stem's backward does this: y is dead after this pass, and the JAX package
// aliases the two buffers too). Strides are arguments, so any layout is
// read where it lies, without a copy. The stem's y is the conv's output,
// which PyTorch keeps channels-last (the conv's input is a channels-last
// view of the [B, T, F, C] features), so C is the innermost dimension: the
// 32 lanes of a warp take 32 neighbouring channels of one window, and each
// window element is one 64-byte (bf16) or 128-byte (f32) row per warp. A
// block is 32 channels x 8 window rows, each row walking kWinPerThread
// windows; its dbias partial per channel is summed over the rows through
// shared memory in a fixed order and written per block, and the caller sums
// the partials (deterministic: no atomics).
//
// What bounds it: bytes. At B = 256 bf16 it reads y (314.6 MB) and dpooled
// (31.5 MB) and writes dy (314.6 MB): 660.6 MB, 0.197 ms at 3.35 TB/s; the
// arithmetic is a few operations per byte.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;        // channels per block (threadIdx.x)
constexpr int kRows = 8;          // window rows per block (threadIdx.y)
constexpr int kWinPerThread = 4;  // windows each row walks
constexpr int kWinPerBlock = kRows * kWinPerThread;
constexpr int kMaxWin = 16;       // pool window elements per thread

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// y * scale + shift with the storage type's rounding after each operation,
// and no contraction into a fused multiply-add.
__device__ __forceinline__ float affine(float y, float s, float sh, float) {
  return __fadd_rn(__fmul_rn(y, s), sh);
}
__device__ __forceinline__ float affine(float y, float s, float sh,
                                        __nv_bfloat16) {
  const float p = __bfloat162float(__float2bfloat16_rn(__fmul_rn(y, s)));
  return __bfloat162float(__float2bfloat16_rn(__fadd_rn(p, sh)));
}

// y and dy may be the same buffer: no __restrict__ on either.
// grid = (ceil(windows / kWinPerBlock), ceil(C / kLanes)), block =
// (kLanes, kRows); a window is one (b, pooled t, pooled f) position.
template <typename T, typename TP>
__global__ void stem_dy_kernel(const T* y, const TP* __restrict__ dp,
                               const float* __restrict__ params6,
                               const float* __restrict__ affine_sc, T* dy,
                               float* __restrict__ partial, int n_win, int C,
                               int TL, int FL, int pt, int pf, long long ysb,
                               long long yst, long long ysf, long long ysc,
                               long long dsb, long long dst, long long dsf,
                               long long dsc) {
  __shared__ float row_sums[kRows][kLanes];
  const int c = blockIdx.y * kLanes + threadIdx.x;

  float sum = 0.0f;
  if (c < C) {
    const float mean = params6[c];
    const float inv = params6[C + c];
    const float gamma = params6[2 * C + c];
    const float dgn = params6[4 * C + c];
    const float dbn = params6[5 * C + c];
    const float scale = affine_sc[c];
    const float shift = affine_sc[C + c];
    const float ig = inv * gamma;
    const int win = pt * pf;
    for (int k = 0; k < kWinPerThread; ++k) {
      const int w = blockIdx.x * kWinPerBlock + k * kRows + threadIdx.y;
      if (w >= n_win) break;
      const int b = w / (TL * FL);
      const int tl = (w / FL) % TL;
      const int fl = w % FL;
      const long long base = b * ysb + c * ysc +
                             static_cast<long long>(tl * pt) * yst +
                             static_cast<long long>(fl * pf) * ysf;

      float yv[kMaxWin];
      float bno[kMaxWin];
      float m = __int_as_float(0xff800000);  // -inf
#pragma unroll
      for (int i = 0; i < kMaxWin; ++i) {
        if (i < win) {
          yv[i] = load(y + base + (i / pf) * yst + (i % pf) * ysf);
          bno[i] = affine(yv[i], scale, shift, T());
          m = fmaxf(m, bno[i]);
        }
      }
      float cnt = 0.0f;
#pragma unroll
      for (int i = 0; i < kMaxWin; ++i)
        if (i < win && bno[i] == m && bno[i] > 0.0f) cnt += 1.0f;
      const float dpv = load(dp + b * dsb + tl * dst + fl * dsf + c * dsc);
      const float share = dpv / fmaxf(cnt, 1.0f);
#pragma unroll
      for (int i = 0; i < kMaxWin; ++i) {
        if (i < win) {
          const float dyr = (bno[i] == m && bno[i] > 0.0f) ? share : 0.0f;
          const float xhat = (yv[i] - mean) * inv;
          const float v = ig * (dyr - dbn - xhat * dgn);
          store(dy + base + (i / pf) * yst + (i % pf) * ysf, v);
          sum += v;
        }
      }
    }
  }

  // dbias partial of this block per channel: the rows, in a fixed order
  row_sums[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) s += row_sums[r][threadIdx.x];
    partial[static_cast<size_t>(blockIdx.x) * C + c] = s;
  }
}

template <typename T, typename TP>
cudaError_t launch(const void* y, const void* dp, const float* params6,
                   const float* affine_sc, void* dy, float* partial, int B,
                   int T_len, int F_len, int C, int pt, int pf,
                   const long long* ys, const long long* ds,
                   cudaStream_t stream) {
  const int TL = T_len / pt;
  const int FL = F_len / pf;
  const int n_win = B * TL * FL;
  const dim3 grid((n_win + kWinPerBlock - 1) / kWinPerBlock,
                  (C + kLanes - 1) / kLanes);
  stem_dy_kernel<T, TP><<<grid, dim3(kLanes, kRows), 0, stream>>>(
      static_cast<const T*>(y), static_cast<const TP*>(dp), params6,
      affine_sc, static_cast<T*>(dy), partial, n_win, C, TL, FL, pt, pf,
      ys[0], ys[1], ys[2], ys[3], ds[0], ds[1], ds[2], ds[3]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). Strides are in elements, in the
// [B, T, F, C] order of the public layout. partial is [ceil(B * windows per
// plane / 32), C] f32. dy may equal y.
int seld_stem_dy(const void* y, const void* dp, const void* params6,
                 const void* affine_sc, void* dy, void* partial, int B,
                 int T_len, int F_len, int C, int pt, int pf, int ysb,
                 int yst, int ysf, int ysc, int dsb, int dst, int dsf,
                 int dsc, int y_bf16, int dp_bf16, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const long long ys[4] = {ysb, yst, ysf, ysc};
  const long long ds[4] = {dsb, dst, dsf, dsc};
  const auto* p6 = static_cast<const float*>(params6);
  const auto* af = static_cast<const float*>(affine_sc);
  auto* part = static_cast<float*>(partial);
  cudaError_t err;
  if (y_bf16 && dp_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(y, dp, p6, af, dy, part, B,
                                               T_len, F_len, C, pt, pf, ys,
                                               ds, st);
  else if (y_bf16)
    err = launch<__nv_bfloat16, float>(y, dp, p6, af, dy, part, B, T_len,
                                       F_len, C, pt, pf, ys, ds, st);
  else if (dp_bf16)
    err = launch<float, __nv_bfloat16>(y, dp, p6, af, dy, part, B, T_len,
                                       F_len, C, pt, pf, ys, ds, st);
  else
    err = launch<float, float>(y, dp, p6, af, dy, part, B, T_len, F_len, C,
                               pt, pf, ys, ds, st);
  return static_cast<int>(err);
}

const char* seld_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
