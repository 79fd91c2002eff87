// Train-mode BatchNorm over the last axis, for Hopper (sm_90a): the batch
// statistics, the normalisation and their backward as four passes.
//
// Replaces no TPU kernel: the JAX package leaves train-mode BatchNorm to
// XLA, which fuses it into its neighbours (seld_tpu/models/layers.py's
// BatchNorm, seld_tpu/ops/stem.py's statistics). PyTorch runs the same
// formula as separate f32 passes (a copy of x in f32, two means, the
// square, the normalise, the cast back) and autograd's chain of passes
// behind them: at SELDnet's first BatchNorm, [256, 300, 64, 64] bf16,
// some 50 GB a training step. These four passes move what the formula
// must read and write, 5.0 GB there.
//
// Contract, on the [rows, C] view of a tensor whose last axis is C and
// which is contiguous (x in f32 or bf16; every sum and product in f32):
//   1. stats:       sums [2, C] = [sum x, sum x^2] over the rows.
//   2. apply:       mean = sums[0] / n, var = sums[1] / n - mean^2 (the
//                   reference's biased E[x^2] - E[x]^2), inv = rsqrt(var +
//                   eps), a = inv * scale per channel; y = (x - mean) * a
//                   + bias in y's dtype (the reference's form: no
//                   cancellation where |mean| is large against the
//                   spread); moments [3, C] = [mean, var, inv]. sums may
//                   be the global batch's (all-reduced by the caller), n
//                   the global count.
//   3. grad sums:   dsums [2, C] = [sum dy, sum dy * xhat], xhat = (x -
//                   mean) * inv recomputed from x.
//   4. grad apply:  dx = scale * inv * (dy - dsums[0] / n - xhat *
//                   dsums[1] / n) in x's dtype (dsums the global batch's).
// dscale = dsums[1] and dbias = dsums[0] are this rank's; the caller
// casts them.
//
// What bounds it: bytes. The passes read x, then x and write y, then read
// x and dy, then x and dy and write dx: eight traversals of x's size (5.03
// GB at SELDnet's first BatchNorm, 1.50 ms at 3.35 TB/s). The arithmetic is
// a few operations an element.
//
// Design.
//   - A thread owns one vector of N channels (16 bytes of x: 8 bf16 or 4
//     f32; N = 1 where C is not a multiple of that or a pointer is not
//     aligned) at a fixed column of the rows, and walks the rows in a
//     grid-stride loop, kUnroll rows a step, whose loads all go out before
//     the first is used. A block holds R = 256 / cv rows of cv columns (cv
//     = min(C / N, 256)); grid.y covers wider rows; a block step reads R * C
//     contiguous values. The grid has a block for every kUnroll block
//     steps of rows, up to kMaxPartials along the rows (then each thread
//     walks more), so a thread's channels and their per-channel constants
//     stay in registers for the whole pass; the plan reads the shape alone.
//   - The per-channel constants (mean, a, bias; xhat's mean and inv; dx's
//     factors) are formed once a thread from the [2, C] or [3, C] inputs,
//     so the statistics need no separate pass of small kernels.
//   - The reductions (passes 1 and 3) add in a fixed order, every product
//     and sum rounded on its own (no fused multiply-add): each thread its
//     rows in loop order, a block's row lanes in order through shared
//     memory into one partial row a block, and batch_norm_finalize_kernel
//     the partial rows per column, 32 lanes of rows in order, then a fixed
//     tree. No atomics: the sums do not depend on block scheduling, replays
//     of a captured step agree bit for bit, and the plain versions, which
//     add in this order, give the same sums.
//   - No pass allocates: the wrapper hands over every output and the
//     partial rows (blocks x 2C f32), and nothing synchronises, so
//     the passes run inside a captured CUDA graph.
//
// BatchNorm -> ReLU -> VALID max pool (windows [wt, wf] = strides, which
// divide T and F), train mode, on x [B, T, F, C] as three more passes
// beside pass 1 (the `batch_norm_pool_*` kernels). They stand for pass 2,
// ReLU, the pool's max, the max's backward (the cotangent split evenly
// over a window's tied maxima, PyTorch's amax backward), ReLU's backward
// and passes 3 and 4, which write and read four full-size tensors more:
//   2'. pool apply: y = (x - mean) * a + bias as pass 2 forms it, rounded
//       to y's dtype, r = relu(y); writes only the pooled p [B, T/wt,
//       F/wf, C] = the window's max of r, and count (one byte) = how many
//       of the window's r equal it; the moments as pass 2.
//   3'. pool grad sums: first a pooled element's share s = p > 0 ? dp /
//       count rounded to y's dtype : 0 (PyTorch's amax backward, then
//       ReLU's), then pass 3 with dy recomputed a row from x, the moments,
//       the parameters and the row's window: dy = y == p ? s : 0, bit for
//       bit the composed chain's dy.
//   4'. pool grad apply: pass 4 on that dy (s from 3').
// 3' and 4' walk pass 3 and 4's plan and rows, so their sums equal the
// composed chain's bit for bit. At SELDnet's first block, [256, 300, 64,
// 64] bf16 under [5, 4], the seven passes of the composed chain move 11.0
// GB a training step; pass 1 and these three 3.3 GB (x five times, the
// pooled tensors a few).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;      // a block of any pass
constexpr int kUnroll = 4;         // rows a thread has in flight
constexpr int kMaxPartials = 4096; // blocks (partial rows) along the rows
constexpr int kFinalRows = 32;     // finalize: row lanes a block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// The 16-byte word's values as f32.
__device__ __forceinline__ void unpack(const uint4& q, float* f, float) {
  f[0] = __uint_as_float(q.x);
  f[1] = __uint_as_float(q.y);
  f[2] = __uint_as_float(q.z);
  f[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack(const uint4& q, float* f, bf16) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
             << 16;
}
__device__ __forceinline__ uint4 pack(const float* f, bf16) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}

// N values of T at p as f32: whole 16-byte words where N * sizeof(T) is a
// multiple of 16 (p aligned to it), else one by one.
template <typename T, int N>
__device__ __forceinline__ void load(const T* __restrict__ p, float* f) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int w = 0; w < kBytes / 16; ++w)
      unpack(reinterpret_cast<const uint4*>(p)[w], f + w * kPer, T());
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f32(p[i]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store(T* __restrict__ p, const float* f) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int w = 0; w < kBytes / 16; ++w)
      reinterpret_cast<uint4*>(p)[w] = pack(f + w * kPer, T());
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = from_f32<T>(f[i]);
  }
}

__device__ __forceinline__ float param(const void* p, int bf, int c) {
  return bf ? __bfloat162float(static_cast<const bf16*>(p)[c])
            : static_cast<const float*>(p)[c];
}

// A thread's place: its column of N channels and its first row.
struct Place {
  int col;       // vector column, in [0, C / N) when live
  int row;       // the block's row lane, in [0, R)
  bool live;
};

__device__ __forceinline__ Place place(int nv, int cv, int R) {
  Place p;
  p.row = threadIdx.x / cv;
  p.col = blockIdx.y * cv + threadIdx.x % cv;
  p.live = p.row < R && p.col < nv;
  return p;
}

// The block's per-thread sums (K = 2 of N channels a thread) added over
// its row lanes in order, into the block's partial row:
// partial[blockIdx.x][k][c].
template <int N>
__device__ __forceinline__ void block_partial(const float (&acc)[2][N],
                                              int C, int cv, int R,
                                              float* __restrict__ partial) {
  constexpr int K = 2;
  __shared__ float red[kThreads * K * N];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < N; ++i) red[(threadIdx.x * K + k) * N + i] = acc[k][i];
  __syncthreads();
  const int width = cv * K * N;   // a row lane's values
  for (int j = threadIdx.x; j < width; j += kThreads) {
    const int col = blockIdx.y * cv + j / (K * N);
    const int k = j / N % K;
    const int c = col * N + j % N;
    if (c >= C) continue;
    float v = 0.0f;
    for (int r = 0; r < R; ++r) v = __fadd_rn(v, red[r * width + j]);
    partial[(static_cast<size_t>(blockIdx.x) * K + k) * C + c] = v;
  }
}

// Pass 1: [sum x, sum x^2] partials.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
batch_norm_stats_kernel(const T* __restrict__ x, long long rows, int C,
                        int cv, int R, float* __restrict__ partial) {
  const Place p = place(C / N, cv, R);
  float acc[2][N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[0][i] = acc[1][i] = 0.0f;
  if (p.live) {
    const long long step = static_cast<long long>(gridDim.x) * R;
    long long r = static_cast<long long>(blockIdx.x) * R + p.row;
    const T* base = x + p.col * N;
    for (; r + (kUnroll - 1) * step < rows; r += kUnroll * step) {
      float v[kUnroll][N];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        load<T, N>(base + (r + u * step) * C, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int i = 0; i < N; ++i) {
          acc[0][i] = __fadd_rn(acc[0][i], v[u][i]);
          acc[1][i] = __fadd_rn(acc[1][i], __fmul_rn(v[u][i], v[u][i]));
        }
    }
    for (; r < rows; r += step) {
      float v[N];
      load<T, N>(base + r * C, v);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        acc[0][i] = __fadd_rn(acc[0][i], v[i]);
        acc[1][i] = __fadd_rn(acc[1][i], __fmul_rn(v[i], v[i]));
      }
    }
  }
  block_partial<N>(acc, C, cv, R, partial);
}

// Pass 3: [sum dy, sum dy * xhat] partials.
template <typename T, typename TD, int N>
__global__ void __launch_bounds__(kThreads)
batch_norm_grad_sums_kernel(const T* __restrict__ x,
                            const TD* __restrict__ dy, long long rows, int C,
                            int cv, int R,
                            const float* __restrict__ moments,
                            float* __restrict__ partial) {
  const Place p = place(C / N, cv, R);
  float acc[2][N], mean[N], inv[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc[0][i] = acc[1][i] = 0.0f;
    mean[i] = inv[i] = 0.0f;
  }
  if (p.live) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      mean[i] = moments[p.col * N + i];
      inv[i] = moments[2 * C + p.col * N + i];
    }
    const long long step = static_cast<long long>(gridDim.x) * R;
    long long r = static_cast<long long>(blockIdx.x) * R + p.row;
    const T* xb = x + p.col * N;
    const TD* db = dy + p.col * N;
    for (; r + (kUnroll - 1) * step < rows; r += kUnroll * step) {
      float v[kUnroll][N], g[kUnroll][N];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        load<T, N>(xb + (r + u * step) * C, v[u]);
        load<TD, N>(db + (r + u * step) * C, g[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float xhat = __fmul_rn(__fsub_rn(v[u][i], mean[i]), inv[i]);
          acc[0][i] = __fadd_rn(acc[0][i], g[u][i]);
          acc[1][i] = __fadd_rn(acc[1][i], __fmul_rn(g[u][i], xhat));
        }
    }
    for (; r < rows; r += step) {
      float v[N], g[N];
      load<T, N>(xb + r * C, v);
      load<TD, N>(db + r * C, g);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float xhat = __fmul_rn(__fsub_rn(v[i], mean[i]), inv[i]);
        acc[0][i] = __fadd_rn(acc[0][i], g[i]);
        acc[1][i] = __fadd_rn(acc[1][i], __fmul_rn(g[i], xhat));
      }
    }
  }
  block_partial<N>(acc, C, cv, R, partial);
}

// out[j] = sum over the partial rows g of partial[g][j], j < width: row
// lanes take rows in order, then a fixed tree over the lanes.
__global__ void __launch_bounds__(32 * kFinalRows)
batch_norm_finalize_kernel(const float* __restrict__ partial, int rows,
                           int width, float* __restrict__ out) {
  __shared__ float s[kFinalRows][33];
  const int j = blockIdx.x * 32 + threadIdx.x;
  float v = 0.0f;
  if (j < width)
    for (int g = threadIdx.y; g < rows; g += kFinalRows)
      v = __fadd_rn(v, partial[static_cast<size_t>(g) * width + j]);
  s[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  for (int h = kFinalRows / 2; h > 0; h /= 2) {
    if (threadIdx.y < h)
      s[threadIdx.y][threadIdx.x] = __fadd_rn(s[threadIdx.y][threadIdx.x],
                                              s[threadIdx.y + h][threadIdx.x]);
    __syncthreads();
  }
  if (threadIdx.y == 0 && j < width) out[j] = s[0][threadIdx.x];
}

// Pass 2: y = (x - mean) * a + bias; block (0, *)'s first row lane writes
// moments.
template <typename T, typename TY, int N>
__global__ void __launch_bounds__(kThreads)
batch_norm_apply_kernel(const T* __restrict__ x, TY* __restrict__ y,
                        long long rows, int C, int cv, int R,
                        const float* __restrict__ sums,
                        const void* __restrict__ scale,
                        const void* __restrict__ bias, int p_bf16, float n,
                        float eps, float* __restrict__ moments) {
  const Place p = place(C / N, cv, R);
  if (!p.live) return;
  float m[N], a[N], b[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = p.col * N + i;
    const float mean = __fdiv_rn(sums[c], n);
    const float var = __fsub_rn(__fdiv_rn(sums[C + c], n),
                                __fmul_rn(mean, mean));
    const float inv = rsqrtf(__fadd_rn(var, eps));
    m[i] = mean;
    a[i] = __fmul_rn(inv, param(scale, p_bf16, c));
    b[i] = param(bias, p_bf16, c);
    if (blockIdx.x == 0 && p.row == 0) {
      moments[c] = mean;
      moments[C + c] = var;
      moments[2 * C + c] = inv;
    }
  }
  const long long step = static_cast<long long>(gridDim.x) * R;
  long long r = static_cast<long long>(blockIdx.x) * R + p.row;
  const T* xb = x + p.col * N;
  TY* yb = y + p.col * N;
  for (; r + (kUnroll - 1) * step < rows; r += kUnroll * step) {
    float v[kUnroll][N];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      load<T, N>(xb + (r + u * step) * C, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[u][i] = fmaf(v[u][i] - m[i], a[i], b[i]);
      store<TY, N>(yb + (r + u * step) * C, v[u]);
    }
  }
  for (; r < rows; r += step) {
    float v[N];
    load<T, N>(xb + r * C, v);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = fmaf(v[i] - m[i], a[i], b[i]);
    store<TY, N>(yb + r * C, v);
  }
}

// Pass 4: dx = k * (dy - c1 - xhat * c2), k = scale * inv, c1 = dsums[0]
// / n, c2 = dsums[1] / n.
template <typename T, typename TD, int N>
__global__ void __launch_bounds__(kThreads)
batch_norm_grad_apply_kernel(const T* __restrict__ x,
                             const TD* __restrict__ dy, T* __restrict__ dx,
                             long long rows, int C, int cv, int R,
                             const float* __restrict__ moments,
                             const void* __restrict__ scale, int p_bf16,
                             const float* __restrict__ dsums, float n) {
  const Place p = place(C / N, cv, R);
  if (!p.live) return;
  float mean[N], inv[N], k[N], c1[N], c2[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = p.col * N + i;
    mean[i] = moments[c];
    inv[i] = moments[2 * C + c];
    k[i] = param(scale, p_bf16, c) * inv[i];
    c1[i] = dsums[c] / n;
    c2[i] = dsums[C + c] / n;
  }
  const long long step = static_cast<long long>(gridDim.x) * R;
  long long r = static_cast<long long>(blockIdx.x) * R + p.row;
  const T* xb = x + p.col * N;
  const TD* db = dy + p.col * N;
  T* ob = dx + p.col * N;
  for (; r + (kUnroll - 1) * step < rows; r += kUnroll * step) {
    float v[kUnroll][N], g[kUnroll][N];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load<T, N>(xb + (r + u * step) * C, v[u]);
      load<TD, N>(db + (r + u * step) * C, g[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float xhat = (v[u][i] - mean[i]) * inv[i];
        v[u][i] = k[i] * (g[u][i] - c1[i] - xhat * c2[i]);
      }
      store<T, N>(ob + (r + u * step) * C, v[u]);
    }
  }
  for (; r < rows; r += step) {
    float v[N], g[N];
    load<T, N>(xb + r * C, v);
    load<TD, N>(db + r * C, g);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float xhat = (v[i] - mean[i]) * inv[i];
      v[i] = k[i] * (g[i] - c1[i] - xhat * c2[i]);
    }
    store<T, N>(ob + r * C, v);
  }
}

// ------------------------------------------ BatchNorm -> ReLU -> max pool

// n / d for 0 <= n < 2^31, d >= 1, by a high product and a shift.
struct Divisor {
  unsigned int d, m, s;
};

Divisor divisor(unsigned int d) {
  Divisor v;
  v.d = d;
  v.s = 0;
  while ((1ull << v.s) < d) ++v.s;
  v.m = static_cast<unsigned int>(
      ((1ull << 32) * ((1ull << v.s) - d)) / d + 1);
  return v;
}

__device__ __forceinline__ unsigned int divide(const Divisor& v,
                                               unsigned int n) {
  return (__umulhi(n, v.m) + n) >> v.s;
}

// The pool's geometry over the [rows, C] view of x [B, T, F, C]: x's F,
// the window [wt, wf] and the pooled F' = F / wf as divisors.
struct Window {
  int F, wt, wf;
  Divisor f, t, w, fp;   // F, wt, wf, F'
};

// The pooled row of x's row r: (r / F / wt) F' + (r mod F) / wf.
__device__ __forceinline__ unsigned int pooled_row(const Window& g,
                                                   unsigned int r) {
  const unsigned int line = divide(g.f, r);            // b T + t
  const unsigned int f = r - line * g.F;
  return divide(g.t, line) * g.fp.d + divide(g.w, f);
}

// y as pass 2 rounds it to TY, back in f32.
template <typename TY>
__device__ __forceinline__ float rounded(float v) {
  return to_f32(from_f32<TY>(v));
}

// N one-byte counts at p (aligned to N bytes) as f32, and back.
template <int N>
__device__ __forceinline__ void load_count(const uint8_t* __restrict__ p,
                                           float* f) {
  if constexpr (N == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i] = static_cast<float>((w.x >> (8 * i)) & 0xffu);
      f[4 + i] = static_cast<float>((w.y >> (8 * i)) & 0xffu);
    }
  } else if constexpr (N == 4) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = static_cast<float>((w >> (8 * i)) & 0xffu);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = static_cast<float>(p[i]);
  }
}

template <int N>
__device__ __forceinline__ void store_count(uint8_t* __restrict__ p,
                                            const float* f) {
  uint32_t w[(N + 3) / 4] = {};
#pragma unroll
  for (int i = 0; i < N; ++i)
    w[i / 4] |= static_cast<uint32_t>(f[i]) << (8 * (i % 4));
  if constexpr (N == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else if constexpr (N == 4) {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = static_cast<uint8_t>(f[i]);
  }
}

// The per-channel affine of pass 2 from the moments: mean, a = inv * scale,
// bias.
template <int N>
__device__ __forceinline__ void affine(const float* __restrict__ moments,
                                       const void* __restrict__ scale,
                                       const void* __restrict__ bias,
                                       int p_bf16, int C, int col, float* m,
                                       float* inv, float* a, float* b) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = col * N + i;
    m[i] = moments[c];
    inv[i] = moments[2 * C + c];
    a[i] = __fmul_rn(inv[i], param(scale, p_bf16, c));
    b[i] = param(bias, p_bf16, c);
  }
}

// A row's dy: y recomputed from the row's x values v; where it equals its
// window's maximum p, the window's share s (pass 3' first kernel), else
// 0.
template <typename TY, int N>
__device__ __forceinline__ void routed(const float* v, const float* m,
                                       const float* a, const float* b,
                                       const float* p, const float* s,
                                       float* dy) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    dy[i] = rounded<TY>(fmaf(v[i] - m[i], a[i], b[i])) == p[i] ? s[i] : 0.0f;
}

// The pooled operands of row r: p and the share s (TY).
template <typename TY, int N>
__device__ __forceinline__ void load_window(const TY* __restrict__ p,
                                            const TY* __restrict__ share,
                                            const Window& g, long long r,
                                            int C, int col, float* pv,
                                            float* sv) {
  const size_t at = static_cast<size_t>(
      pooled_row(g, static_cast<unsigned int>(r))) * C + col * N;
  load<TY, N>(p + at, pv);
  load<TY, N>(share + at, sv);
}

// Pass 2': a thread a pooled row and N channels; block (0, *)'s first row
// lane writes moments.
template <typename T, typename TY, int N>
__global__ void __launch_bounds__(kThreads)
batch_norm_pool_apply_kernel(const T* __restrict__ x, TY* __restrict__ p,
                             uint8_t* __restrict__ cnt, int pooled, int C,
                             int cv, int R, Window g,
                             const float* __restrict__ sums,
                             const void* __restrict__ scale,
                             const void* __restrict__ bias, int p_bf16,
                             float n, float eps,
                             float* __restrict__ moments) {
  const Place pl = place(C / N, cv, R);
  if (!pl.live) return;
  float m[N], a[N], b[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = pl.col * N + i;
    const float mean = __fdiv_rn(sums[c], n);
    const float var = __fsub_rn(__fdiv_rn(sums[C + c], n),
                                __fmul_rn(mean, mean));
    const float inv = rsqrtf(__fadd_rn(var, eps));
    m[i] = mean;
    a[i] = __fmul_rn(inv, param(scale, p_bf16, c));
    b[i] = param(bias, p_bf16, c);
    if (blockIdx.x == 0 && pl.row == 0) {
      moments[c] = mean;
      moments[C + c] = var;
      moments[2 * C + c] = inv;
    }
  }
  const long long q = static_cast<long long>(blockIdx.x) * R + pl.row;
  if (q >= pooled) return;
  const unsigned int line = divide(g.fp, static_cast<unsigned int>(q));
  const long long first =
      static_cast<long long>(line) * g.wt * g.F +
      static_cast<long long>(q - static_cast<long long>(line) * g.fp.d) *
          g.wf;
  const T* xb = x + first * C + pl.col * N;
  float mx[N], k[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mx[i] = -1.0f;   // below every ReLU output
    k[i] = 0.0f;
  }
  for (int i = 0; i < g.wt; ++i) {
    const T* rb = xb + static_cast<long long>(i) * g.F * C;
    int j = 0;
    for (; j + kUnroll <= g.wf; j += kUnroll) {
      float v[kUnroll][N];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) load<T, N>(rb + (j + u) * C, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int c = 0; c < N; ++c) {
          const float y = rounded<TY>(fmaf(v[u][c] - m[c], a[c], b[c]));
          const float r = y < 0.0f ? 0.0f : y;
          if (r > mx[c] || r != r) {
            mx[c] = r;
            k[c] = 1.0f;
          } else if (r == mx[c]) {
            k[c] += 1.0f;
          }
        }
    }
    for (; j < g.wf; ++j) {
      float v[N];
      load<T, N>(rb + j * C, v);
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const float y = rounded<TY>(fmaf(v[c] - m[c], a[c], b[c]));
        const float r = y < 0.0f ? 0.0f : y;
        if (r > mx[c] || r != r) {
          mx[c] = r;
          k[c] = 1.0f;
        } else if (r == mx[c]) {
          k[c] += 1.0f;
        }
      }
    }
  }
  const size_t at = static_cast<size_t>(q) * C + pl.col * N;
  store<TY, N>(p + at, mx);
  store_count<N>(cnt + at, k);
}

// Pass 3', first kernel: a pooled element's share, what amax's backward
// sends each of its window's tied maxima: dp / count rounded to TY where
// the maximum p > 0, else 0 (ReLU's backward); a thread N channels.
template <typename TY, int N>
__global__ void __launch_bounds__(kThreads)
batch_norm_pool_share_kernel(const TY* __restrict__ p,
                             const TY* __restrict__ dp,
                             const uint8_t* __restrict__ cnt,
                             long long vectors, TY* __restrict__ share) {
  const long long v = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (v >= vectors) return;
  float pv[N], dv[N], kv[N];
  load<TY, N>(p + v * N, pv);
  load<TY, N>(dp + v * N, dv);
  load_count<N>(cnt + v * N, kv);
#pragma unroll
  for (int i = 0; i < N; ++i)
    dv[i] = !(pv[i] > 0.0f) ? 0.0f
            : kv[i] == 1.0f ? dv[i]
                            : rounded<TY>(__fdiv_rn(dv[i], kv[i]));
  store<TY, N>(share + v * N, dv);
}

// Pass 3', second kernel: pass 3's walk and sums on the routed dy.
template <typename T, typename TY, int N>
__global__ void __launch_bounds__(kThreads)
batch_norm_pool_grad_sums_kernel(const T* __restrict__ x,
                                 const TY* __restrict__ p,
                                 const TY* __restrict__ share,
                                 long long rows, int C, int cv, int R,
                                 Window g, const float* __restrict__ moments,
                                 const void* __restrict__ scale,
                                 const void* __restrict__ bias, int p_bf16,
                                 float* __restrict__ partial) {
  const Place pl = place(C / N, cv, R);
  float acc[2][N], mean[N], inv[N], a[N], b[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[0][i] = acc[1][i] = 0.0f;
  if (pl.live) {
    affine<N>(moments, scale, bias, p_bf16, C, pl.col, mean, inv, a, b);
    const long long step = static_cast<long long>(gridDim.x) * R;
    long long r = static_cast<long long>(blockIdx.x) * R + pl.row;
    const T* xb = x + pl.col * N;
    for (; r + (kUnroll - 1) * step < rows; r += kUnroll * step) {
      float v[kUnroll][N], pv[kUnroll][N], sv[kUnroll][N];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        load<T, N>(xb + (r + u * step) * C, v[u]);
        load_window<TY, N>(p, share, g, r + u * step, C, pl.col, pv[u],
                           sv[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float dy[N];
        routed<TY, N>(v[u], mean, a, b, pv[u], sv[u], dy);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float xhat = __fmul_rn(__fsub_rn(v[u][i], mean[i]), inv[i]);
          acc[0][i] = __fadd_rn(acc[0][i], dy[i]);
          acc[1][i] = __fadd_rn(acc[1][i], __fmul_rn(dy[i], xhat));
        }
      }
    }
    for (; r < rows; r += step) {
      float v[N], pv[N], sv[N], dy[N];
      load<T, N>(xb + r * C, v);
      load_window<TY, N>(p, share, g, r, C, pl.col, pv, sv);
      routed<TY, N>(v, mean, a, b, pv, sv, dy);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float xhat = __fmul_rn(__fsub_rn(v[i], mean[i]), inv[i]);
        acc[0][i] = __fadd_rn(acc[0][i], dy[i]);
        acc[1][i] = __fadd_rn(acc[1][i], __fmul_rn(dy[i], xhat));
      }
    }
  }
  block_partial<N>(acc, C, cv, R, partial);
}

// Pass 4': pass 4's dx on the routed dy.
template <typename T, typename TY, int N>
__global__ void __launch_bounds__(kThreads)
batch_norm_pool_grad_apply_kernel(const T* __restrict__ x,
                                  const TY* __restrict__ p,
                                  const TY* __restrict__ share,
                                  T* __restrict__ dx, long long rows, int C,
                                  int cv, int R, Window g,
                                  const float* __restrict__ moments,
                                  const void* __restrict__ scale,
                                  const void* __restrict__ bias, int p_bf16,
                                  const float* __restrict__ dsums, float n) {
  const Place pl = place(C / N, cv, R);
  if (!pl.live) return;
  float mean[N], inv[N], a[N], b[N], k[N], c1[N], c2[N];
  affine<N>(moments, scale, bias, p_bf16, C, pl.col, mean, inv, a, b);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = pl.col * N + i;
    k[i] = param(scale, p_bf16, c) * inv[i];
    c1[i] = dsums[c] / n;
    c2[i] = dsums[C + c] / n;
  }
  const long long step = static_cast<long long>(gridDim.x) * R;
  long long r = static_cast<long long>(blockIdx.x) * R + pl.row;
  const T* xb = x + pl.col * N;
  T* ob = dx + pl.col * N;
  for (; r + (kUnroll - 1) * step < rows; r += kUnroll * step) {
    float v[kUnroll][N], pv[kUnroll][N], sv[kUnroll][N];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load<T, N>(xb + (r + u * step) * C, v[u]);
      load_window<TY, N>(p, share, g, r + u * step, C, pl.col, pv[u], sv[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float dy[N];
      routed<TY, N>(v[u], mean, a, b, pv[u], sv[u], dy);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float xhat = (v[u][i] - mean[i]) * inv[i];
        v[u][i] = k[i] * (dy[i] - c1[i] - xhat * c2[i]);
      }
      store<T, N>(ob + (r + u * step) * C, v[u]);
    }
  }
  for (; r < rows; r += step) {
    float v[N], pv[N], sv[N], dy[N];
    load<T, N>(xb + r * C, v);
    load_window<TY, N>(p, share, g, r, C, pl.col, pv, sv);
    routed<TY, N>(v, mean, a, b, pv, sv, dy);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float xhat = (v[i] - mean[i]) * inv[i];
      v[i] = k[i] * (dy[i] - c1[i] - xhat * c2[i]);
    }
    store<T, N>(ob + r * C, v);
  }
}

// The launch plan of a pass over [rows, C] at N channels a thread.
struct Plan {
  int cv, R;
  dim3 grid;
};

// kUnroll rows a thread a block step, at most kMaxPartials blocks along the
// rows: a plan of the shape alone, so the plain versions
// (ops/batch_norm.py) add the sums in the same order, bit for bit.
Plan plan(long long rows, int C, int N) {
  Plan p;
  const int nv = C / N;
  p.cv = nv < kThreads ? nv : kThreads;
  p.R = kThreads / p.cv;
  const long long per_block = static_cast<long long>(p.R) * kUnroll;
  long long gx = (rows + per_block - 1) / per_block;
  if (gx > kMaxPartials) gx = kMaxPartials;
  p.grid = dim3(static_cast<unsigned>(gx),
                static_cast<unsigned>((nv + p.cv - 1) / p.cv));
  return p;
}

// out [2, C] from partial [rows, 2, C].
cudaError_t finalize(const float* partial, int rows, int C, float* out,
                     cudaStream_t st) {
  const int width = 2 * C;
  batch_norm_finalize_kernel<<<(width + 31) / 32, dim3(32, kFinalRows), 0,
                               st>>>(partial, rows, width, out);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t stats(const void* x, long long rows, int C, int blocks,
                  float* partial, float* sums, cudaStream_t st) {
  const Plan p = plan(rows, C, N);
  if (static_cast<int>(p.grid.x) != blocks) return cudaErrorInvalidValue;
  batch_norm_stats_kernel<T, N><<<p.grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), rows, C, p.cv, p.R, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return finalize(partial, p.grid.x, C, sums, st);
}

template <typename T, typename TY, int N>
cudaError_t apply(const void* x, void* y, long long rows, int C,
                  const float* sums, const void* scale, const void* bias,
                  int p_bf16, float n, float eps, float* moments,
                  cudaStream_t st) {
  const Plan p = plan(rows, C, N);
  batch_norm_apply_kernel<T, TY, N><<<p.grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<TY*>(y), rows, C, p.cv, p.R, sums,
      scale, bias, p_bf16, n, eps, moments);
  return cudaGetLastError();
}

template <typename T, typename TD, int N>
cudaError_t grad_sums(const void* x, const void* dy, long long rows, int C,
                      int blocks, const float* moments, float* partial,
                      float* dsums, cudaStream_t st) {
  const Plan p = plan(rows, C, N);
  if (static_cast<int>(p.grid.x) != blocks) return cudaErrorInvalidValue;
  batch_norm_grad_sums_kernel<T, TD, N><<<p.grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const TD*>(dy), rows, C, p.cv,
      p.R, moments, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return finalize(partial, p.grid.x, C, dsums, st);
}

template <typename T, typename TD, int N>
cudaError_t grad_apply(const void* x, const void* dy, void* dx,
                       long long rows, int C, const float* moments,
                       const void* scale, int p_bf16, const float* dsums,
                       float n, cudaStream_t st) {
  const Plan p = plan(rows, C, N);
  batch_norm_grad_apply_kernel<T, TD, N><<<p.grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const TD*>(dy),
      static_cast<T*>(dx), rows, C, p.cv, p.R, moments, scale, p_bf16, dsums,
      n);
  return cudaGetLastError();
}

// Pass 2' has a thread a pooled row, no walk: pass 2's block shape, as
// many blocks as the pooled rows need.
template <typename T, typename TY, int N>
cudaError_t pool_apply(const void* x, void* p, void* cnt, long long rows,
                       int C, const Window& g, const float* sums,
                       const void* scale, const void* bias, int p_bf16,
                       float n, float eps, float* moments, cudaStream_t st) {
  const Plan pl = plan(rows, C, N);
  const long long pooled = rows / (static_cast<long long>(g.wt) * g.wf);
  const dim3 grid(static_cast<unsigned>((pooled + pl.R - 1) / pl.R),
                  pl.grid.y);
  batch_norm_pool_apply_kernel<T, TY, N><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<TY*>(p),
      static_cast<uint8_t*>(cnt), static_cast<int>(pooled), C, pl.cv, pl.R,
      g, sums, scale, bias, p_bf16, n, eps, moments);
  return cudaGetLastError();
}

template <typename T, typename TY, int N>
cudaError_t pool_grad_sums(const void* x, const void* p, const void* dp,
                           const void* cnt, void* share, long long rows,
                           int C, const Window& g, int blocks,
                           const float* moments, const void* scale,
                           const void* bias, int p_bf16, float* partial,
                           float* dsums, cudaStream_t st) {
  const Plan pl = plan(rows, C, N);
  if (static_cast<int>(pl.grid.x) != blocks) return cudaErrorInvalidValue;
  const long long vectors =
      rows / (static_cast<long long>(g.wt) * g.wf) * (C / N);
  batch_norm_pool_share_kernel<TY, N>
      <<<static_cast<unsigned>((vectors + kThreads - 1) / kThreads), kThreads,
         0, st>>>(static_cast<const TY*>(p), static_cast<const TY*>(dp),
                  static_cast<const uint8_t*>(cnt), vectors,
                  static_cast<TY*>(share));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  batch_norm_pool_grad_sums_kernel<T, TY, N><<<pl.grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const TY*>(p),
      static_cast<const TY*>(share), rows, C, pl.cv, pl.R, g, moments, scale,
      bias, p_bf16, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return finalize(partial, pl.grid.x, C, dsums, st);
}

template <typename T, typename TY, int N>
cudaError_t pool_grad_apply(const void* x, const void* p, const void* share,
                            void* dx, long long rows, int C, const Window& g,
                            const float* moments, const void* scale,
                            const void* bias, int p_bf16, const float* dsums,
                            float n, cudaStream_t st) {
  const Plan pl = plan(rows, C, N);
  batch_norm_pool_grad_apply_kernel<T, TY, N><<<pl.grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const TY*>(p),
      static_cast<const TY*>(share), static_cast<T*>(dx), rows, C, pl.cv,
      pl.R, g, moments, scale, bias, p_bf16, dsums, n);
  return cudaGetLastError();
}

// x's vector width on the 16-byte path: 16 bytes of x's dtype.
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

bool valid(long long rows, int C, int vec, int x_bf16) {
  if (rows < 1 || C < 1) return false;
  const int n = !vec ? 1 : x_bf16 ? kVec<bf16> : kVec<float>;
  return C % n == 0;
}

// The pooled passes' geometry: x [B, T, F, C] as rows = B T F rows under
// windows [wt, wf] that divide T and F, rows < 2^31 (the divisors' range),
// a count of at most 255 a window.
bool window_of(long long rows, int T, int F, int wt, int wf, Window* g) {
  if (T < 1 || F < 1 || wt < 1 || wf < 1 || T % wt || F % wf ||
      wt * wf > 255 || rows % (static_cast<long long>(T) * F) ||
      rows >= (1ll << 31))
    return false;
  g->F = F;
  g->wt = wt;
  g->wf = wf;
  g->f = divisor(F);
  g->t = divisor(wt);
  g->w = divisor(wf);
  g->fp = divisor(F / wf);
  return true;
}

// The pooled passes' (x, y, N) instantiations: fn(Types<T, TY, N>()).
template <typename T_, typename TY_, int N_>
struct Types {
  using T = T_;
  using TY = TY_;
  static constexpr int N = N_;
};

template <typename Fn>
cudaError_t by_types(int x_bf16, int y_bf16, int vec, Fn fn) {
  if (x_bf16 && y_bf16)
    return vec ? fn(Types<bf16, bf16, kVec<bf16>>())
               : fn(Types<bf16, bf16, 1>());
  if (x_bf16)
    return vec ? fn(Types<bf16, float, kVec<bf16>>())
               : fn(Types<bf16, float, 1>());
  if (!y_bf16)
    return vec ? fn(Types<float, float, kVec<float>>())
               : fn(Types<float, float, 1>());
  return cudaErrorInvalidValue;   // y = promote(x, scale): f32 for f32 x
}

}  // namespace

extern "C" {

// Every function returns a cudaError_t (0 on success). Tensors are the
// contiguous [rows, C] views; *_bf16 flags say bf16 (else f32); vec picks
// the 16-byte path (C a multiple of 8 bf16 or 4 f32 values, every pointer
// aligned to 16 bytes times its dtype's share, as the wrapper checks).
// blocks is the plan's blocks along the rows (the wrapper's mirror of
// `plan`, checked here); partial holds blocks x 2C f32.

int seld_batch_norm_stats(const void* x, int x_bf16, long long rows, int C,
                          int vec, int blocks, void* partial, void* sums,
                          void* stream) {
  if (!valid(rows, C, vec, x_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(partial);
  float* sp = static_cast<float*>(sums);
  cudaError_t err;
  if (x_bf16)
    err = vec ? stats<bf16, kVec<bf16>>(x, rows, C, blocks, pp, sp, st)
              : stats<bf16, 1>(x, rows, C, blocks, pp, sp, st);
  else
    err = vec ? stats<float, kVec<float>>(x, rows, C, blocks, pp, sp, st)
              : stats<float, 1>(x, rows, C, blocks, pp, sp, st);
  return static_cast<int>(err);
}

int seld_batch_norm_apply(const void* x, int x_bf16, void* y, int y_bf16,
                          long long rows, int C, int vec, const void* sums,
                          const void* scale, const void* bias, int p_bf16,
                          float n, float eps, void* moments, void* stream) {
  if (!valid(rows, C, vec, x_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(sums);
  float* mp = static_cast<float*>(moments);
  cudaError_t err;
#define SELD_BN_APPLY(T, TY)                                                 \
  (vec ? apply<T, TY, kVec<T>>(x, y, rows, C, sp, scale, bias,   \
                                           p_bf16, n, eps, mp, st)           \
       : apply<T, TY, 1>(x, y, rows, C, sp, scale, bias, p_bf16, n, eps, mp, \
                         st))
  if (x_bf16)
    err = y_bf16 ? SELD_BN_APPLY(bf16, bf16) : SELD_BN_APPLY(bf16, float);
  else if (!y_bf16)
    err = SELD_BN_APPLY(float, float);
  else
    err = cudaErrorInvalidValue;   // y = promote(x, scale): f32 for f32 x
#undef SELD_BN_APPLY
  return static_cast<int>(err);
}

int seld_batch_norm_grad_sums(const void* x, int x_bf16, const void* dy,
                              int dy_bf16, long long rows, int C, int vec,
                              int blocks, const void* moments, void* partial,
                              void* dsums, void* stream) {
  if (!valid(rows, C, vec, x_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const float* mp = static_cast<const float*>(moments);
  float* pp = static_cast<float*>(partial);
  float* dp = static_cast<float*>(dsums);
  cudaError_t err;
#define SELD_BN_GSUMS(T, TD)                                                  \
  (vec ? grad_sums<T, TD, kVec<T>>(x, dy, rows, C, blocks, mp, pp, dp,  \
                                    st)                                     \
       : grad_sums<T, TD, 1>(x, dy, rows, C, blocks, mp, pp, dp, st))
  if (x_bf16)
    err = dy_bf16 ? SELD_BN_GSUMS(bf16, bf16) : SELD_BN_GSUMS(bf16, float);
  else if (!dy_bf16)
    err = SELD_BN_GSUMS(float, float);
  else
    err = cudaErrorInvalidValue;   // dy is y's cotangent: f32 for f32 x
#undef SELD_BN_GSUMS
  return static_cast<int>(err);
}

int seld_batch_norm_grad_apply(const void* x, int x_bf16, const void* dy,
                               int dy_bf16, void* dx, long long rows, int C,
                               int vec, const void* moments,
                               const void* scale, int p_bf16,
                               const void* dsums, float n, void* stream) {
  if (!valid(rows, C, vec, x_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const float* mp = static_cast<const float*>(moments);
  const float* dp = static_cast<const float*>(dsums);
  cudaError_t err;
#define SELD_BN_GAPPLY(T, TD)                                                \
  (vec ? grad_apply<T, TD, kVec<T>>(x, dy, dx, rows, C, mp,      \
                                                scale, p_bf16, dp, n, st)    \
       : grad_apply<T, TD, 1>(x, dy, dx, rows, C, mp, scale, p_bf16, dp, n,  \
                              st))
  if (x_bf16)
    err = dy_bf16 ? SELD_BN_GAPPLY(bf16, bf16) : SELD_BN_GAPPLY(bf16, float);
  else if (!dy_bf16)
    err = SELD_BN_GAPPLY(float, float);
  else
    err = cudaErrorInvalidValue;   // dy is y's cotangent: f32 for f32 x
#undef SELD_BN_GAPPLY
  return static_cast<int>(err);
}

// The pooled passes: x the [rows, C] view of [B, T, F, C]; p, dp and
// share [rows / (wt wf), C] in y's dtype (p_bf16), count as many bytes;
// the parameters in par_bf16. Pass 3' writes share, pass 4' reads it. The
// rest as passes 2-4.

int seld_batch_norm_pool_apply(const void* x, int x_bf16, void* p,
                               int p_bf16, void* count, long long rows,
                               int C, int T, int F, int wt, int wf, int vec,
                               const void* sums, const void* scale,
                               const void* bias, int par_bf16, float n,
                               float eps, void* moments, void* stream) {
  Window g;
  if (!valid(rows, C, vec, x_bf16) || !window_of(rows, T, F, wt, wf, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_types(x_bf16, p_bf16, vec, [&](auto t) {
    using S = decltype(t);
    return pool_apply<typename S::T, typename S::TY, S::N>(
        x, p, count, rows, C, g, static_cast<const float*>(sums), scale,
        bias, par_bf16, n, eps, static_cast<float*>(moments), st);
  }));
}

int seld_batch_norm_pool_grad_sums(const void* x, int x_bf16, const void* p,
                                   const void* dp, int p_bf16,
                                   const void* count, void* share,
                                   long long rows, int C, int T, int F,
                                   int wt, int wf, int vec, int blocks,
                                   const void* moments, const void* scale,
                                   const void* bias, int par_bf16,
                                   void* partial, void* dsums, void* stream) {
  Window g;
  if (!valid(rows, C, vec, x_bf16) || !window_of(rows, T, F, wt, wf, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_types(x_bf16, p_bf16, vec, [&](auto t) {
    using S = decltype(t);
    return pool_grad_sums<typename S::T, typename S::TY, S::N>(
        x, p, dp, count, share, rows, C, g, blocks,
        static_cast<const float*>(moments), scale, bias, par_bf16,
        static_cast<float*>(partial), static_cast<float*>(dsums), st);
  }));
}

int seld_batch_norm_pool_grad_apply(const void* x, int x_bf16, const void* p,
                                    const void* share, int p_bf16, void* dx,
                                    long long rows, int C, int T, int F,
                                    int wt, int wf, int vec,
                                    const void* moments, const void* scale,
                                    const void* bias, int par_bf16,
                                    const void* dsums, float n,
                                    void* stream) {
  Window g;
  if (!valid(rows, C, vec, x_bf16) || !window_of(rows, T, F, wt, wf, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_types(x_bf16, p_bf16, vec, [&](auto t) {
    using S = decltype(t);
    return pool_grad_apply<typename S::T, typename S::TY, S::N>(
        x, p, share, dx, rows, C, g, static_cast<const float*>(moments),
        scale, bias, par_bf16, static_cast<const float*>(dsums), n, st);
  }));
}

const char* seld_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
