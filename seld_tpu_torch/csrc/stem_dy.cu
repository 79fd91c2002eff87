// Fused stem backward, the one full-resolution pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel seld_tpu/ops/pallas/stem_bwd.py::_dy_kernel,
// launched by _dy_call. Same contract:
//   y [B, T, F, C] (the conv output plus bias, f32 or bf16, any strides),
//   dpooled [B, T/pt, F/pf, C] (f32 or bf16, any strides), params6 [6, C]
//   f32 rows (mean, inv = rsqrt(var + eps), gamma, beta, dgamma/n,
//   dbeta/n)
//   -> dy like y (it may be y itself), and dbias [C] f32 = sum of dy.
// Per pooling window of one (b, c):
//   scale = bf(gamma * inv), shift = bf(beta - gamma * mean * inv), bf()
//           rounding to y's dtype: the forward's `bn_affine`
//   bno  = y * scale + shift in y's dtype, rounding after the product and
//          after the sum, exactly as the forward's eager PyTorch ops did:
//          the routing below compares against the window max, so any other
//          formula (or a fused multiply-add) would silently misroute
//   m    = max(bno);  eq = (bno == m) & (bno > 0);  cnt = sum(eq)
//   dyr  = eq * dpooled / max(cnt, 1)     (ties split by count)
//   xhat = (y - mean) * inv
//   dy   = inv * gamma * (dyr - dbeta/n - xhat * dgamma/n)
//
// What bounds it: bytes. At B = 256 bf16 it reads y (314.6 MB) and dpooled
// (31.5 MB) and writes dy (314.6 MB): 660.6 MB, 0.197 ms at 3.35 TB/s.
// The arithmetic is ~20 instructions an element, so at 157 M elements the
// card executes it in ~0.1 ms: instruction count, not only bytes, decides
// whether the pass reaches its bound, and the design keeps address
// arithmetic out of the per-element work.
//
// Design.
//   - Vector path (stem_dy_vec_kernel), where C is innermost and unit-stride
//     in y (and out), y is 16-byte aligned, every other stride is a whole
//     number of 16-byte vectors, C / V is a power of two up to 32 (V = 8
//     bf16 or 4 f32 channels a vector), and (pt, pf) is one of kVecWindows
//     (a template parameter: the stem's [5, 2] and conv_temporal's default
//     [5, 1]). A thread owns one (window, channel vector) item at a time:
//     pt * pf 16-byte loads (at C = 32 bf16 a warp covers 8 windows of 4
//     vectors: each load instruction moves 512 bytes in 64-byte runs, the
//     window's next pixel in F filling the gaps), all offsets in 32 bits.
//     Items go to threads in a grid-stride loop whose stride is a multiple
//     of C / V, so a thread's channels never change and it holds their
//     constants in registers; the loop runs two items at once: the next
//     item's loads go out before this item's stores (the windows are
//     disjoint, so dy may overwrite y).
//     In bf16 the affine is one mul.rn.bf16x2 and one add.rn.bf16x2 a
//     channel pair: each rounds once to bf16, which is what PyTorch's
//     f32 product or sum rounded to bf16 gives (a product of two bf16
//     values is exact in f32; a sum is exact in f32 or its rounding does
//     not reach bf16's). One pass keeps the running max and its count,
//     a second recomputes bno and writes dy. dpooled is read element by
//     element with its strides: the training step hands it over
//     channels-first.
//   - Generic path (stem_dy_any_kernel), every other window and layout: one
//     thread a window of one channel (32 channels x 8 windows a block, a
//     grid-stride loop over windows), a runtime window of any size walked
//     twice: the max and its count, then re-read, dy written. 64-bit
//     offsets, any strides.
//   - dbias, on both paths, in a fixed order: each thread sums its items in
//     loop order, a warp's lanes of one channel by a shuffle butterfly, a
//     block's warps in warp order into one partial row a block, and
//     stem_dy_finalize_kernel adds the rows per channel as a fixed tree.
//     No atomics: the result does not depend on block scheduling.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // a block of either path
constexpr int kMaxBlocks = 1056;  // 8 blocks a SM on 132 SMs; the grid
                                  // strides over the rest
struct Window {
  int pt, pf;
};
// mirrored by seld_tpu_torch/ops/stem_bwd.py::_VEC_WINDOWS
constexpr Window kVecWindows[] = {{5, 2}, {5, 1}};
constexpr int kNumVecWindows = sizeof(kVecWindows) / sizeof(kVecWindows[0]);
constexpr int kLanes = 32;                 // generic path: channels a block
constexpr int kRows = kThreads / kLanes;   // generic path: windows a step

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// y * scale + shift with the storage type's rounding after each operation,
// and no contraction into a fused multiply-add.
template <typename T>
__device__ __forceinline__ float affine(float y, float s, float sh) {
  return round_to(__fadd_rn(round_to(__fmul_rn(y, s), T()), sh), T());
}

// The forward's scale and shift (`bn_affine`), as f32 values of T
__device__ __forceinline__ void bn_affine(const float* __restrict__ p6,
                                          int C, int c, float& scale,
                                          float& shift, float t) {
  scale = __fmul_rn(p6[2 * C + c], p6[C + c]);
  shift = __fsub_rn(p6[3 * C + c],
                    __fmul_rn(__fmul_rn(p6[2 * C + c], p6[c]), p6[C + c]));
}
__device__ __forceinline__ void bn_affine(const float* __restrict__ p6,
                                          int C, int c, float& scale,
                                          float& shift, __nv_bfloat16 t) {
  bn_affine(p6, C, c, scale, shift, 0.0f);
  scale = round_to(scale, t);
  shift = round_to(shift, t);
}

// ---------------------------------------------------------------- vectors

// V channels of one pixel in one 16-byte register quad
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void unpack(const uint4& r,
                                                float (&v)[4]) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
  // bno of the 4 channels: f32 product and sum, no contraction
  static __device__ __forceinline__ void affine(const uint4& r,
                                                const uint4& sc,
                                                const uint4& sh,
                                                float (&out)[4]) {
    float y[4], s[4], h[4];
    unpack(r, y);
    unpack(sc, s);
    unpack(sh, h);
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = __fadd_rn(__fmul_rn(y[k], s[k]), h[k]);
  }
};

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf16x2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// the two bf16 of a word as f32: the low half is channel 2k, the high 2k+1
__device__ __forceinline__ void bf16x2_unpack(uint32_t w, float& lo,
                                              float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ void unpack(const uint4& r,
                                                float (&v)[8]) {
    bf16x2_unpack(r.x, v[0], v[1]);
    bf16x2_unpack(r.y, v[2], v[3]);
    bf16x2_unpack(r.z, v[4], v[5]);
    bf16x2_unpack(r.w, v[6], v[7]);
  }
  static __device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&p);
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[8]) {
    return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                      pack2(v[4], v[5]), pack2(v[6], v[7]));
  }
  // bno of the 8 channels: one rounding after the product, one after the
  // sum, two channels an instruction
  static __device__ __forceinline__ void affine(const uint4& r,
                                                const uint4& sc,
                                                const uint4& sh,
                                                float (&out)[8]) {
    uint4 b;
    b.x = bf16x2_add(bf16x2_mul(r.x, sc.x), sh.x);
    b.y = bf16x2_add(bf16x2_mul(r.y, sc.y), sh.y);
    b.z = bf16x2_add(bf16x2_mul(r.z, sc.z), sh.z);
    b.w = bf16x2_add(bf16x2_mul(r.w, sc.w), sh.w);
    unpack(b, out);
  }
};

// One item's data: its window of y as pt * pf vectors and its dpooled
template <int W, int V>
struct Item {
  uint4 y[W];
  float dp[V];
  int off;  // y offset of the window's first vector
};

template <typename T, typename TP, int PT, int PF>
struct VecPass {
  static constexpr int V = Vec<T>::V;
  static constexpr int W = PT * PF;
  int TL, FL, shift_nv;             // windows in T and F; log2(C / V)
  int ysb, yst, ysf;                // y strides (elements)
  int dsb, dst, dsf, dsc;           // dpooled strides (elements)

  __device__ __forceinline__ void load(Item<W, V>& it, const T* y,
                                       const TP* __restrict__ dp, int item,
                                       int cv) const {
    const int w = item >> shift_nv;
    const int fl = w % FL;
    const int r = w / FL;
    const int tl = r % TL;
    const int b = r / TL;
    it.off = b * ysb + tl * PT * yst + fl * PF * ysf + cv * V;
#pragma unroll
    for (int i = 0; i < PT; ++i)
#pragma unroll
      for (int j = 0; j < PF; ++j)
        it.y[i * PF + j] =
            *reinterpret_cast<const uint4*>(y + it.off + i * yst + j * ysf);
    const int doff = b * dsb + tl * dst + fl * dsf;
#pragma unroll
    for (int k = 0; k < V; ++k)
      it.dp[k] = to_f32(dp[doff + (cv * V + k) * dsc]);
  }

  // dy of the item's window, written over its place; adds dy to sum
  __device__ __forceinline__ void finish(const Item<W, V>& it, T* dy,
                                         const uint4& sc, const uint4& sh,
                                         const float (&mean)[V],
                                         const float (&inv)[V],
                                         const float (&ig)[V],
                                         const float (&dgn)[V],
                                         const float (&dbn)[V],
                                         float (&sum)[V]) const {
    float m[V], cnt[V], bno[V];
    Vec<T>::affine(it.y[0], sc, sh, m);
#pragma unroll
    for (int k = 0; k < V; ++k) cnt[k] = 1.0f;
#pragma unroll
    for (int e = 1; e < W; ++e) {
      Vec<T>::affine(it.y[e], sc, sh, bno);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        cnt[k] = bno[k] > m[k] ? 1.0f : cnt[k] + (bno[k] == m[k] ? 1.0f : 0.0f);
        m[k] = fmaxf(m[k], bno[k]);
      }
    }
    // a window whose maximum is not positive routes nothing: NaN equals
    // no bno
    float share[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      share[k] = it.dp[k] / cnt[k];
      m[k] = m[k] > 0.0f ? m[k] : __int_as_float(0x7fc00000);
    }
#pragma unroll
    for (int e = 0; e < W; ++e) {
      float yv[V], out[V];
      Vec<T>::affine(it.y[e], sc, sh, bno);
      Vec<T>::unpack(it.y[e], yv);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float dyr = bno[k] == m[k] ? share[k] : 0.0f;
        const float xhat = (yv[k] - mean[k]) * inv[k];
        out[k] = ig[k] * (dyr - dbn[k] - xhat * dgn[k]);
        sum[k] += out[k];
      }
      *reinterpret_cast<uint4*>(dy + it.off + (e / PF) * yst + (e % PF) * ysf) =
          Vec<T>::pack(out);
    }
  }
};

// Sums lanes holding the same channels (lanes equal mod nv) and a block's
// warps in warp order: partial[blockIdx.x][c]. sum holds V channels of
// vector cv.
template <int V>
__device__ __forceinline__ void block_partial(float (&sum)[V], int nv,
                                              int cv, int C,
                                              float* __restrict__ partial) {
  __shared__ float rows[kThreads / 32][kLanes * 8];  // C <= 256
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < V; ++k)
    for (int m = nv; m < 32; m *= 2)
      sum[k] += __shfl_xor_sync(0xffffffffu, sum[k], m);
  if (lane < nv) {
#pragma unroll
    for (int k = 0; k < V; ++k) rows[warp][cv * V + k] = sum[k];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += rows[w][c];
    partial[static_cast<size_t>(blockIdx.x) * C + c] = s;
  }
}

// y and dy may be the same buffer: no __restrict__ on either.
template <typename T, typename TP, int PT, int PF>
__global__ void __launch_bounds__(kThreads)
stem_dy_vec_kernel(const T* y, const TP* __restrict__ dp,
                   const float* __restrict__ params6, T* dy,
                   float* __restrict__ partial, int n_items, int C,
                   VecPass<T, TP, PT, PF> pass) {
  using P = VecPass<T, TP, PT, PF>;
  constexpr int V = P::V;
  constexpr int W = P::W;
  const int nv = 1 << pass.shift_nv;
  const int stride = gridDim.x * kThreads;  // a multiple of nv
  int item = blockIdx.x * kThreads + threadIdx.x;
  const int cv = item & (nv - 1);

  // this thread's channels cv V .. cv V + V, for the whole loop
  float mean[V], inv[V], ig[V], dgn[V], dbn[V], scf[V], shf[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = cv * V + k;
    mean[k] = params6[c];
    inv[k] = params6[C + c];
    ig[k] = inv[k] * params6[2 * C + c];
    dgn[k] = params6[4 * C + c];
    dbn[k] = params6[5 * C + c];
    bn_affine(params6, C, c, scf[k], shf[k], T());
  }
  const uint4 sc = Vec<T>::pack(scf);  // exact: the values are T's
  const uint4 sh = Vec<T>::pack(shf);
  float sum[V];
#pragma unroll
  for (int k = 0; k < V; ++k) sum[k] = 0.0f;

  // two items in flight: the next one's loads go out before this one's
  // stores
  Item<W, V> a, b;
  if (item < n_items) pass.load(a, y, dp, item, cv);
  while (item < n_items) {
    int next = item + stride;
    if (next < n_items) pass.load(b, y, dp, next, cv);
    pass.finish(a, dy, sc, sh, mean, inv, ig, dgn, dbn, sum);
    item = next;
    if (item >= n_items) break;
    next = item + stride;
    if (next < n_items) pass.load(a, y, dp, next, cv);
    pass.finish(b, dy, sc, sh, mean, inv, ig, dgn, dbn, sum);
    item = next;
  }
  block_partial<V>(sum, nv, cv, C, partial);
}

// ---------------------------------------------------------------- generic

// One thread a window of one channel; grid (blocks, ceil(C / 32)), block
// (32 channels, 8 windows), a grid-stride loop over windows.
template <typename T, typename TP>
__global__ void __launch_bounds__(kThreads)
stem_dy_any_kernel(const T* y, const TP* __restrict__ dp,
                   const float* __restrict__ params6, T* dy,
                   float* __restrict__ partial, int n_win, int C, int TL,
                   int FL, int pt, int pf, long long ysb, long long yst,
                   long long ysf, long long ysc, long long dsb,
                   long long dst, long long dsf, long long dsc) {
  __shared__ float row_sums[kRows][kLanes];
  const int c = blockIdx.y * kLanes + threadIdx.x;
  float sum = 0.0f;
  if (c < C) {
    const float mean = params6[c];
    const float inv = params6[C + c];
    const float ig = inv * params6[2 * C + c];
    const float dgn = params6[4 * C + c];
    const float dbn = params6[5 * C + c];
    float scale, shift;
    bn_affine(params6, C, c, scale, shift, T());
    for (int w = blockIdx.x * kRows + threadIdx.y; w < n_win;
         w += gridDim.x * kRows) {
      const int fl = w % FL;
      const int tl = (w / FL) % TL;
      const int b = w / (FL * TL);
      const T* yw = y + b * ysb + c * ysc + (tl * pt) * yst + (fl * pf) * ysf;
      T* dw = dy + b * ysb + c * ysc + (tl * pt) * yst + (fl * pf) * ysf;
      float m = __int_as_float(0xff800000);  // -inf
      float cnt = 0.0f;
      for (int i = 0; i < pt; ++i)
        for (int j = 0; j < pf; ++j) {
          const float v =
              affine<T>(to_f32(yw[i * yst + j * ysf]), scale, shift);
          cnt = v > m ? 1.0f : cnt + (v == m ? 1.0f : 0.0f);
          m = fmaxf(m, v);
        }
      const float share =
          to_f32(dp[b * dsb + tl * dst + fl * dsf + c * dsc]) / cnt;
      m = m > 0.0f ? m : __int_as_float(0x7fc00000);  // routes nothing
      for (int i = 0; i < pt; ++i)
        for (int j = 0; j < pf; ++j) {
          const float yv = to_f32(yw[i * yst + j * ysf]);
          const float dyr = affine<T>(yv, scale, shift) == m ? share : 0.0f;
          const float xhat = (yv - mean) * inv;
          const float v = ig * (dyr - dbn - xhat * dgn);
          store(dw + i * yst + j * ysf, v);
          sum += v;
        }
    }
  }
  // the block's windows of each channel, rows in a fixed order
  row_sums[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) s += row_sums[r][threadIdx.x];
    partial[static_cast<size_t>(blockIdx.x) * C + c] = s;
  }
}

// dbias[c] = the blocks' partial rows, added as a fixed tree: thread t
// sums rows t, t + 256, ... in order, then halves pairwise.
__global__ void __launch_bounds__(kThreads)
stem_dy_finalize_kernel(const float* __restrict__ partial,
                        float* __restrict__ dbias, int blocks, int C) {
  __shared__ float s[kThreads];
  const int c = blockIdx.x;
  float v = 0.0f;
  for (int r = threadIdx.x; r < blocks; r += kThreads)
    v += partial[static_cast<size_t>(r) * C + c];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h /= 2) {
    if (threadIdx.x < h) s[threadIdx.x] += s[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) dbias[c] = s[0];
}

struct Args {
  const void *y, *dp;
  const float* p6;
  void* dy;
  float *partial, *dbias;
  int B, T, F, C, pt, pf, blocks;
  int ys[4], ds[4];
};

template <typename T, typename TP, int PT, int PF>
cudaError_t launch_vec(const Args& a, cudaStream_t st) {
  constexpr int V = Vec<T>::V;
  VecPass<T, TP, PT, PF> pass;
  pass.TL = a.T / PT;
  pass.FL = a.F / PF;
  int shift = 0;
  while ((V << shift) < a.C) ++shift;
  pass.shift_nv = shift;
  pass.ysb = a.ys[0];
  pass.yst = a.ys[1];
  pass.ysf = a.ys[2];
  pass.dsb = a.ds[0];
  pass.dst = a.ds[1];
  pass.dsf = a.ds[2];
  pass.dsc = a.ds[3];
  const int n_items = a.B * pass.TL * pass.FL << shift;
  stem_dy_vec_kernel<T, TP, PT, PF><<<a.blocks, kThreads, 0, st>>>(
      static_cast<const T*>(a.y), static_cast<const TP*>(a.dp), a.p6,
      static_cast<T*>(a.dy), a.partial, n_items, a.C, pass);
  return cudaGetLastError();
}

template <typename T, typename TP>
cudaError_t launch(const Args& a, int path, cudaStream_t st) {
  cudaError_t err;
  if (path == 0) {
    const dim3 grid(a.blocks, (a.C + kLanes - 1) / kLanes);
    stem_dy_any_kernel<T, TP><<<grid, dim3(kLanes, kRows), 0, st>>>(
        static_cast<const T*>(a.y), static_cast<const TP*>(a.dp), a.p6,
        static_cast<T*>(a.dy), a.partial, a.B * (a.T / a.pt) * (a.F / a.pf),
        a.C, a.T / a.pt, a.F / a.pf, a.pt, a.pf, a.ys[0], a.ys[1], a.ys[2],
        a.ys[3], a.ds[0], a.ds[1], a.ds[2], a.ds[3]);
    err = cudaGetLastError();
  } else {
    // the vector path's layout, checked again here: a misaligned vector
    // load faults
    constexpr int V = Vec<T>::V;
    const int nv = a.C / V;
    const bool ok =
        a.C % V == 0 && nv >= 1 && nv <= 32 && (nv & (nv - 1)) == 0 &&
        a.ys[3] == 1 && a.ys[0] % V == 0 && a.ys[1] % V == 0 &&
        a.ys[2] % V == 0 && reinterpret_cast<uintptr_t>(a.y) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(a.dy) % 16 == 0;
    if (!ok) return cudaErrorInvalidValue;
    if (a.pt == 5 && a.pf == 2)
      err = launch_vec<T, TP, 5, 2>(a, st);
    else if (a.pt == 5 && a.pf == 1)
      err = launch_vec<T, TP, 5, 1>(a, st);
    else
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  stem_dy_finalize_kernel<<<a.C, kThreads, 0, st>>>(a.partial, a.dbias,
                                                   a.blocks, a.C);
  return cudaGetLastError();
}
static_assert(kNumVecWindows == 2, "launch() names every vector window");

}  // namespace

extern "C" {

// Writes kVecWindows as (pt, pf) pairs into out (room for `cap` ints) and
// returns the number of windows, so the wrapper's copy can be checked.
int seld_stem_dy_vec_windows(int* out, int cap) {
  for (int i = 0; i < kNumVecWindows && 2 * i + 1 < cap; ++i) {
    out[2 * i] = kVecWindows[i].pt;
    out[2 * i + 1] = kVecWindows[i].pf;
  }
  return kNumVecWindows;
}

// Returns a cudaError_t (0 on success). Strides are in elements, in the
// [B, T, F, C] order of the public layout. path: 0 generic, 1 vectors.
// partial holds
// blocks x C f32 (blocks from the wrapper's plan, at most kMaxBlocks);
// dbias C f32. dy may equal y.
int seld_stem_dy(const void* y, const void* dp, const void* params6,
                 void* dy, void* partial, void* dbias, int B, int T_len,
                 int F_len, int C, int pt, int pf, int ysb, int yst, int ysf,
                 int ysc, int dsb, int dst, int dsf, int dsc, int y_bf16,
                 int dp_bf16, int path, int blocks, void* stream) {
  if (blocks < 1 || blocks > kMaxBlocks || C < 1 || C > kLanes * 8 ||
      pt < 1 || pf < 1 || T_len % pt || F_len % pf)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = {y,  dp, static_cast<const float*>(params6), dy,
                  static_cast<float*>(partial), static_cast<float*>(dbias),
                  B, T_len, F_len, C, pt, pf, blocks, {ysb, yst, ysf, ysc},
                  {dsb, dst, dsf, dsc}};
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (y_bf16 && dp_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(a, path, st);
  else if (y_bf16)
    err = launch<__nv_bfloat16, float>(a, path, st);
  else if (dp_bf16)
    err = launch<float, __nv_bfloat16>(a, path, st);
  else
    err = launch<float, float>(a, path, st);
  return static_cast<int>(err);
}

const char* seld_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
