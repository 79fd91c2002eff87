// Keras reset_after GRU recurrence, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel seld_tpu/ops/pallas/gru.py::_fwd_kernel, launched
// by _gru_scan_fwd_impl. Same contract:
//   x_proj [D, T, B, 3U] (f32 or bf16; input projection incl. input bias,
//   gate order z|r|h), rec_kernel [D, U, 3U] f32, rec_bias [D, 3U] f32
//   -> hs [D, T, B, U] in x_proj's dtype, REAL-time indexed: direction 0
//   runs t ascending, direction 1 descending, and each state lands at its t.
//   All math is f32 whatever the storage dtype, the product h @ Rk too:
//     hp = h @ Rk + rb;  z = sig(xz + hz);  r = sig(xr + hr)
//     c  = tanh(xh + r * hh);  h' = z * h + (1 - z) * c
//
// Design. On the TPU a sequential grid axis over T carried h in VMEM. Here
// a thread block cluster walks all T steps of one (direction, tile of BT
// batch rows), and its C CTAs split the U units:
//   - CTA c owns units [c U/C, (c+1) U/C) and the z, r and h columns of Rk
//     for them (U x 3U/C f32: 48 KB at U = 128, C = 4), held in REGISTERS
//     for the whole loop. A unit's k-range is split over S neighbouring
//     lanes; lane l holds the 4-row chunks k = 4 (S i + l) + q, i < NI,
//     q < 4 (12 NI registers). Rk is read from device memory once;
//   - each step a lane reads h[b, k] for its chunks from its own CTA's
//     shared memory as float4 broadcasts (the S lanes of a unit read
//     neighbouring 16-byte words: one wavefront serves a warp) and sums
//     3 x BT partial products. A reduce-scatter over the S lanes (log2 S
//     shuffle rounds, each keeping half the rows) leaves each lane the
//     full sums of BT/S rows, and it applies the gates to them at once:
//     no block barrier inside the step;
//   - the new h goes to hs at its real t and, through distributed shared
//     memory (st.shared::cluster), into the next-h buffer of every CTA of
//     the cluster. h is double-buffered, so ONE cluster barrier a step
//     (arrive.release, wait.acquire) orders the exchange; the next step's
//     x_proj values are loaded between the arrive and the wait;
//   - a ragged last tile is masked; a block is a whole number of warps, and
//     the lanes of its padding units compute on zero weights and store
//     nothing.
// Four variants (S, NI, BT) take U % 4 == 0 up to 256 where a cluster
// size splits U evenly (kVariants), the streamed one (below) every
// U % 4 == 0 past 256; the plan, seld_tpu_torch/ops/gru.py::_fwd_plan,
// picks the variant and C.
// At small B the latency variant (4, 8, 4) spreads a tile of 4 rows over a
// cluster of 8 CTAs of 64 threads (B = 32: 128 CTAs); at large B the batch
// variant (4, 8, 8) packs a tile of 8 rows into 2 CTAs of 256 threads (B =
// 256: 128 CTAs, one a SM, 8 warps each to hide the FMA and shared-memory
// latency). The wide variant (4, 9, 8) takes U up to 144, and the widest
// (8, 8, 8) U up to 256: 8 lanes a unit keep 96 Rk values a lane, and at
// U = 256 a cluster of 8 CTAs of 256 threads.
//
// Past U = 256 the streamed variant (gru_fwd_stream_kernel) takes every
// U % 4 == 0: a CTA's slice of Rk (U x 3U/C f32, 221 KB at U = 384 on 8
// CTAs) fits neither the registers nor, beside h, the shared memory of one
// SM. So each step streams the slice from device memory (L2: both
// directions' Rk stay resident up to U ~ 1,400) and h goes through memory
// too:
//   - a cluster of C CTAs (the largest of 8, 4 dividing U) per (direction,
//     tile of kStreamBT rows); a thread owns one unit of its CTA for all
//     the tile's rows and all three gates (a CTA of more than
//     kStreamThreads units walks them in passes), and where a CTA has few
//     units, up to kStreamSplits groups of threads split each chunk's k
//     range and add their partial sums through shared memory;
//   - the previous step's f32 states are read from a double-buffered
//     workspace [2, D, B, U] (ld.global.cg: L2, never a stale L1 line), in
//     chunks of kStreamChunk k-values staged in shared memory, and each
//     thread reads its Rk column (coalesced over the units of a warp,
//     loaded a chunk of 4 k ahead of its FMAs);
//   - the new states go to the workspace and to hs; ONE cluster barrier a
//     step (arrive.release, wait.acquire) makes them visible to the
//     cluster's other CTAs before the next step reads them.
//
// What bounds it: the f32 FMAs of h @ Rk at 67 TFLOP/s (the reference
// multiplies in f32, so neither bf16 nor single-pass TF32 tensor-core
// products may stand in), then the per-step cluster barrier on the serial
// chain of T steps. At B = 256 each SM issues 8 x 192 x 128 FMAs a step,
// ~1,536 cycles of its f32 lanes; at small B a step is short and the
// exchange (DSMEM stores and the barrier) and the gates are most of it.
// The previous design kept all of Rk[d] (192 KB) in shared memory and
// streamed it through every step for 4 batch rows (~1,500 shared-memory
// wavefronts a step, two block barriers, 16 of 132 SMs busy at B = 32);
// here Rk never moves after its first load, and a step reads only h
// (BT x U f32) from shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Variant {
  int s;     // lanes that split one unit's k-range
  int ni;    // 4-row k chunks per lane
  int bt;    // batch rows per tile
  int maxt;  // most threads a block may have (__launch_bounds__)
};
// mirrored by seld_tpu_torch/ops/gru.py::_FWD_VARIANTS
constexpr Variant kVariants[] = {{4, 8, 8, 256}, {4, 8, 4, 256},
                                 {4, 9, 8, 256}, {8, 8, 8, 256}};
constexpr int kNumVariants = sizeof(kVariants) / sizeof(kVariants[0]);
constexpr int kMaxCluster = 8;    // the portable cluster size
// the streamed variant (U > 256), mirrored by ops/gru.py::_STREAM: batch
// rows per tile, most threads a block, h values staged a chunk
constexpr int kStreamBT = 16;
constexpr int kStreamThreads = 256;
constexpr int kStreamChunk = 128;
constexpr int kStreamSplits = 4;     // most groups splitting a chunk's k
// the groups' partial sums: (KS - 1) x 3 x BT x UW floats, largest at
// KS = 4, UW = 64
constexpr int kStreamPartials = 3 * 3 * kStreamBT * 64;
constexpr int kRegisterUnits = 256;  // the widest U of kVariants
constexpr int kGroup = 8;         // h rows read ahead of their FMAs

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}
// __expf and __fdividef keep ~2 ulp relative error; tanh through exp is
// exact at both tails (2 / inf = 0, 2 / 1 = 2) and within 1e-6 in between
__device__ __forceinline__ float sigmoid(float v) {
  return __fdividef(1.0f, 1.0f + __expf(-v));
}
__device__ __forceinline__ float tanh_fast(float v) {
  return 1.0f - __fdividef(2.0f, __expf(2.0f * v) + 1.0f);
}

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
// the shared::cluster address of a shared::cta address in CTA `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v)
               : "memory");
}
// ask L2 for the line of p ahead of its load
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// Adds up the partial sums of the S lanes of a unit and leaves lane l the
// totals of rows [l R, (l + 1) R), R = BT / S, in acc[g][0, R). Round by
// round (lane bit M from S / 2 down to 1; N rows in each half), a lane
// keeps the half of its rows that its bit selects and adds its partner's
// copy of that half.
template <int M, int N, int BT>
__device__ __forceinline__ void reduce_scatter(float (&acc)[3][BT],
                                               int lane) {
  if constexpr (M >= 1) {
    const bool upper = (lane & M) != 0;
#pragma unroll
    for (int g = 0; g < 3; ++g) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float send = upper ? acc[g][j] : acc[g][j + N];
        const float keep = upper ? acc[g][j + N] : acc[g][j];
        acc[g][j] = keep + __shfl_xor_sync(0xffffffffu, send, M);
      }
    }
    reduce_scatter<M / 2, N / 2, BT>(acc, lane);
  }
}

// x_proj of rows [first, first + R) of a tile for unit u, 0 where masked
template <int R, typename T>
__device__ __forceinline__ void load_x(float (&x)[3][R],
                                       const T* __restrict__ tile, int K,
                                       int U, int u, int first, int rows,
                                       bool live) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int b = first + j;
    const bool ok = live && b < rows;
#pragma unroll
    for (int g = 0; g < 3; ++g)
      x[g][j] = ok ? to_f32(tile[static_cast<size_t>(b) * K + g * U + u])
                   : 0.0f;
  }
}

template <int S, int NI, int BT, int MAXT, typename T>
__global__ void __launch_bounds__(MAXT)
gru_fwd_kernel(const T* __restrict__ xp, const float* __restrict__ rk,
               const float* __restrict__ rb, T* __restrict__ hs, int steps,
               int batch, int units, int cluster) {
  constexpr int KP = 4 * S * NI;  // k extent of an h row, zero from U on
  constexpr int R = BT / S;       // rows a lane finishes each step
  constexpr int G = BT < kGroup ? BT : kGroup;
  static_assert(BT % S == 0 && BT % G == 0, "BT splits over S and G");
  __shared__ __align__(16) float h_buf[2][BT][KP];

  const int U = units;
  const int K = 3 * units;
  const int uc = units / cluster;  // units of this CTA
  const int lane = threadIdx.x % S;
  const int uu = threadIdx.x / S;
  const bool live = uu < uc;       // not a padding unit
  const int u = static_cast<int>(cluster_ctarank()) * uc + uu;
  const int d = blockIdx.y;
  const int b0 = (blockIdx.x / cluster) * BT;
  const int rows = min(BT, batch - b0);
  const int first = lane * R;

  // this lane's slice of Rk[d], resident in registers for the whole loop
  float w[3][NI][4];
  const float* rk_d = rk + static_cast<size_t>(d) * U * K;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = 4 * (S * i + lane) + q;
      const bool ok = live && k < U;
#pragma unroll
      for (int g = 0; g < 3; ++g)
        w[g][i][q] = ok ? rk_d[static_cast<size_t>(k) * K + g * U + u] : 0.0f;
    }
  }
  float bias[3];
#pragma unroll
  for (int g = 0; g < 3; ++g)
    bias[g] = live ? rb[static_cast<size_t>(d) * K + g * U + u] : 0.0f;

  float* h_flat = &h_buf[0][0][0];
  for (int i = threadIdx.x; i < 2 * BT * KP; i += blockDim.x) h_flat[i] = 0.0f;
  const uint32_t h_local =
      static_cast<uint32_t>(__cvta_generic_to_shared(h_flat));
  uint32_t peer[kMaxCluster];  // h_buf of each CTA of the cluster
#pragma unroll
  for (int p = 0; p < kMaxCluster; ++p)
    peer[p] = p < cluster ? map_rank(h_local, p) : 0u;

  const size_t step_elems = static_cast<size_t>(batch) * K;  // one t
  const T* xp_d = xp + static_cast<size_t>(d) * steps * step_elems +
                  static_cast<size_t>(b0) * K;
  float h_reg[R];
#pragma unroll
  for (int j = 0; j < R; ++j) h_reg[j] = 0.0f;
  float x[3][R];
  load_x<R>(x, xp_d + (d == 0 ? 0 : steps - 1) * step_elems, K, U, u, first,
            rows, live);
  // every CTA's h_buf is zero before any peer writes into it
  cluster_arrive();
  cluster_wait();

  for (int s = 0; s < steps; ++s) {
    const int t = d == 0 ? s : steps - 1 - s;
    const float* hc = h_flat + (s & 1) * BT * KP;
    float acc[3][BT];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[g][b] = 0.0f;
    }
    // h rows in groups of G: a group's float4 reads are issued before its
    // 12 G independent FMA chains
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int k0 = 4 * (S * i + lane);
#pragma unroll
      for (int b0g = 0; b0g < BT; b0g += G) {
        float4 h4[G];
#pragma unroll
        for (int b = 0; b < G; ++b)
          h4[b] = *reinterpret_cast<const float4*>(hc + (b0g + b) * KP + k0);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int g = 0; g < 3; ++g) {
#pragma unroll
            for (int b = 0; b < G; ++b) {
              const float hq = q == 0 ? h4[b].x : q == 1 ? h4[b].y
                             : q == 2 ? h4[b].z : h4[b].w;
              acc[g][b0g + b] = fmaf(hq, w[g][i][q], acc[g][b0g + b]);
            }
          }
        }
      }
    }
    reduce_scatter<S / 2, BT / 2, BT>(acc, lane);

    const bool exchange = s + 1 < steps;
    const int nxt = (s & 1) ^ 1;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float z = sigmoid(x[0][j] + (acc[0][j] + bias[0]));
      const float r = sigmoid(x[1][j] + (acc[1][j] + bias[1]));
      const float c = tanh_fast(x[2][j] + r * (acc[2][j] + bias[2]));
      const float hn = z * h_reg[j] + (1.0f - z) * c;
      h_reg[j] = hn;
      if (live && exchange) {
        const uint32_t off = static_cast<uint32_t>(
            ((nxt * BT + first + j) * KP + u) * sizeof(float));
#pragma unroll
        for (int p = 0; p < kMaxCluster; ++p)
          if (p < cluster) st_cluster(peer[p] + off, hn);
      }
    }
    if (exchange) cluster_arrive();
    // while the barrier settles: this step's states to hs, the next x_proj
    T* hs_t = hs + ((static_cast<size_t>(d) * steps + t) * batch + b0) * U;
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (live && first + j < rows)
        store(hs_t + static_cast<size_t>(first + j) * U + u, h_reg[j]);
    if (exchange) {
      const int tn = d == 0 ? s + 1 : steps - 2 - s;
      load_x<R>(x, xp_d + tn * step_elems, K, U, u, first, rows, live);
      cluster_wait();
    }
  }
}

// The streamed variant; grid (tiles * C, D), clusters of C CTAs along x.
// hbuf [2, D, B, U] f32: the states of scan step s in buffer s & 1. The
// block is KS groups of UW threads (stream_split): thread (ks, l) owns
// CTA unit base + l, base = 0, UW, ..., and the ks-th of KS slices of
// each staged chunk of k; groups 1 .. KS-1 leave their partial sums in
// shared memory and group 0 adds them in group order and applies the gates.
template <typename T>
__global__ void __launch_bounds__(kStreamThreads)
gru_fwd_stream_kernel(const T* __restrict__ xp, const float* __restrict__ rk,
                      const float* __restrict__ rb, T* __restrict__ hs,
                      float* __restrict__ hbuf, int steps, int batch,
                      int units, int cluster, int splits) {
  constexpr int BT = kStreamBT, KC = kStreamChunk;
  __shared__ __align__(16) float h_s[BT][KC];
  __shared__ float part[kStreamPartials];  // [KS - 1][3][BT][UW]
  const int U = units;
  const int K = 3 * units;
  const int uc = units / cluster;
  const int uw = blockDim.x / splits;
  const int ks = threadIdx.x / uw, lane = threadIdx.x % uw;
  const int kslice = KC / splits;          // a multiple of 4
  const int rank = static_cast<int>(cluster_ctarank());
  const int d = blockIdx.y;
  const int b0 = (blockIdx.x / cluster) * BT;
  const int rows = min(BT, batch - b0);
  const size_t step_elems = static_cast<size_t>(batch) * K;
  const T* xp_d = xp + static_cast<size_t>(d) * steps * step_elems +
                  static_cast<size_t>(b0) * K;
  const float* rk_d = rk + static_cast<size_t>(d) * U * K;
  const float* rb_d = rb + static_cast<size_t>(d) * K;
  const size_t hb_stride = static_cast<size_t>(gridDim.y) * batch * U;
  float* hb_d = hbuf + (static_cast<size_t>(d) * batch + b0) * U;

  for (int s = 0; s < steps; ++s) {
    const int t = d == 0 ? s : steps - 1 - s;
    const float* hprev = hb_d + ((s + 1) & 1) * hb_stride;  // step s - 1
    float* hnext = hb_d + (s & 1) * hb_stride;
    T* hs_t = hs + ((static_cast<size_t>(d) * steps + t) * batch + b0) * U;
    const T* xp_t = xp_d + static_cast<size_t>(t) * step_elems;
    for (int base = 0; base < uc; base += uw) {
      const int uu = base + lane;
      const bool live = uu < uc;
      const int u = rank * uc + (live ? uu : 0);
      float acc[3][BT];
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int b = 0; b < BT; ++b) acc[g][b] = 0.0f;
      // the gates' x_proj rows into L2 while the product runs: each group
      // asks for its share of the rows
      for (int b = ks; live && b < rows; b += splits)
#pragma unroll
        for (int g = 0; g < 3; ++g)
          prefetch_l2(xp_t + static_cast<size_t>(b) * K + g * U + u);
      for (int k0 = 0; s > 0 && k0 < U; k0 += KC) {
        __syncthreads();                 // the previous chunk is consumed
        for (int i = threadIdx.x; i < BT * KC; i += blockDim.x) {
          const int b = i / KC, k = i % KC;
          h_s[b][k] = b < rows && k0 + k < U
                          ? __ldcg(hprev + static_cast<size_t>(b) * U + k0 + k)
                          : 0.0f;
        }
        __syncthreads();
        const int k_lo = ks * kslice;
        const int k_hi = min(k_lo + kslice, U - k0);
        if (!live || k_lo >= k_hi) continue;
        const float* col = rk_d + static_cast<size_t>(k0) * K + u;
        float w[3][4], wn[3][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int g = 0; g < 3; ++g)
            w[g][q] = __ldg(col + static_cast<size_t>(k_lo + q) * K + g * U);
        for (int k = k_lo; k < k_hi; k += 4) {
          const bool more = k + 4 < k_hi;
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int g = 0; g < 3; ++g)
              wn[g][q] = more ? __ldg(col + static_cast<size_t>(k + 4 + q) * K +
                                      g * U)
                              : 0.0f;
#pragma unroll
          for (int b = 0; b < BT; ++b) {
            const float4 h4 = *reinterpret_cast<const float4*>(&h_s[b][k]);
#pragma unroll
            for (int g = 0; g < 3; ++g) {
              acc[g][b] = fmaf(h4.x, w[g][0], acc[g][b]);
              acc[g][b] = fmaf(h4.y, w[g][1], acc[g][b]);
              acc[g][b] = fmaf(h4.z, w[g][2], acc[g][b]);
              acc[g][b] = fmaf(h4.w, w[g][3], acc[g][b]);
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int g = 0; g < 3; ++g) w[g][q] = wn[g][q];
        }
      }
      // the groups' partial sums, added by group 0 in group order
      if (ks > 0) {
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int b = 0; b < BT; ++b)
            part[(((ks - 1) * 3 + g) * BT + b) * uw + lane] = acc[g][b];
      }
      __syncthreads();
      if (ks == 0 && live) {
        for (int p = 1; p < splits; ++p)
#pragma unroll
          for (int g = 0; g < 3; ++g)
#pragma unroll
            for (int b = 0; b < BT; ++b)
              acc[g][b] += part[(((p - 1) * 3 + g) * BT + b) * uw + lane];
        const float bz = rb_d[u], br = rb_d[U + u], bh = rb_d[2 * U + u];
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          if (b >= rows) break;
          const T* x = xp_t + static_cast<size_t>(b) * K + u;
          const float h = s > 0
                              ? __ldcg(hprev + static_cast<size_t>(b) * U + u)
                              : 0.0f;
          const float z = sigmoid(to_f32(x[0]) + (acc[0][b] + bz));
          const float r = sigmoid(to_f32(x[U]) + (acc[1][b] + br));
          const float c = tanh_fast(to_f32(x[2 * U]) + r * (acc[2][b] + bh));
          const float hn = z * h + (1.0f - z) * c;
          hnext[static_cast<size_t>(b) * U + u] = hn;
          store(hs_t + static_cast<size_t>(b) * U + u, hn);
        }
      }
      __syncthreads();                   // part is read before it is reused
    }
    // the next step reads every CTA's states
    if (s + 1 < steps) {
      cluster_arrive();
      cluster_wait();
    }
  }
}

// the cluster size of the streamed variant: the largest of 8, 4 dividing U
int stream_cluster(int U) { return U % 8 == 0 ? 8 : 4; }

// The streamed variant's block: KS groups of UW threads, UW the CTA's units
// rounded up to whole warps (at most kStreamThreads), KS as many groups as
// fill kStreamThreads (at most kStreamSplits): returns KS, writes UW
int stream_split(int units_per_cta, int* uw) {
  const int w = (units_per_cta + 31) / 32 * 32;
  *uw = w < kStreamThreads ? w : kStreamThreads;
  const int ks = kStreamThreads / *uw;
  return ks < kStreamSplits ? ks : kStreamSplits;
}

template <typename T>
cudaError_t launch_stream(const void* xp, const float* rk, const float* rb,
                          void* hs, float* hbuf, int D, int T_steps, int B,
                          int U, int cluster, cudaStream_t stream) {
  if (U <= kRegisterUnits || U % 4 || cluster != stream_cluster(U) ||
      hbuf == nullptr)
    return cudaErrorInvalidValue;
  int uw;
  const int splits = stream_split(U / cluster, &uw);
  const int threads = uw * splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B + kStreamBT - 1) / kStreamBT * cluster, D, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, gru_fwd_stream_kernel<T>, static_cast<const T*>(xp), rk, rb,
      static_cast<T*>(hs), hbuf, T_steps, B, U, cluster, splits);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int V, typename T>
cudaError_t launch(const void* xp, const float* rk, const float* rb, void* hs,
                   int D, int T_steps, int B, int U, int cluster,
                   cudaStream_t stream) {
  constexpr Variant v = kVariants[V];
  if (cluster < 1 || cluster > kMaxCluster || U < 1 || U % cluster ||
      U > 4 * v.s * v.ni)
    return cudaErrorInvalidValue;
  const int threads = (U / cluster * v.s + 31) / 32 * 32;
  if (threads > v.maxt) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B + v.bt - 1) / v.bt * cluster, D, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, gru_fwd_kernel<v.s, v.ni, v.bt, v.maxt, T>, static_cast<const T*>(xp), rk,
      rb, static_cast<T*>(hs), T_steps, B, U, cluster);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int variant, const void* xp, const float* rk,
                     const float* rb, void* hs, float* ws, int D, int T_steps,
                     int B, int U, int cluster, cudaStream_t st) {
  switch (variant) {
    case kNumVariants:
      return launch_stream<T>(xp, rk, rb, hs, ws, D, T_steps, B, U, cluster,
                              st);
    case 0: return launch<0, T>(xp, rk, rb, hs, D, T_steps, B, U, cluster, st);
    case 1: return launch<1, T>(xp, rk, rb, hs, D, T_steps, B, U, cluster, st);
    case 2: return launch<2, T>(xp, rk, rb, hs, D, T_steps, B, U, cluster, st);
    case 3: return launch<3, T>(xp, rk, rb, hs, D, T_steps, B, U, cluster, st);
    default: return cudaErrorInvalidValue;
  }
}
static_assert(kNumVariants == 4, "dispatch() names every variant");

}  // namespace

extern "C" {

// Writes the variant table as (S, NI, BT, max threads) quadruples into out (room for `cap`
// ints) and returns the number of variants, so the wrapper's copy can be
// checked against it.
int seld_gru_fwd_variants(int* out, int cap) {
  for (int i = 0; i < kNumVariants && 4 * i + 3 < cap; ++i) {
    out[4 * i] = kVariants[i].s;
    out[4 * i + 1] = kVariants[i].ni;
    out[4 * i + 2] = kVariants[i].bt;
    out[4 * i + 3] = kVariants[i].maxt;
  }
  return kNumVariants;
}

// Writes the streamed variant's constants (kStreamBT, kStreamThreads,
// kStreamChunk, kStreamSplits) into out and returns their number
int seld_gru_fwd_stream_params(int* out, int cap) {
  if (cap < 4) return 0;
  out[0] = kStreamBT;
  out[1] = kStreamThreads;
  out[2] = kStreamChunk;
  out[3] = kStreamSplits;
  return 4;
}

// Bytes of scratch one call needs: the streamed variant's double-buffered
// f32 states (variant kNumVariants), none for the register variants.
size_t seld_gru_fwd_workspace_bytes(int D, int B, int U, int variant) {
  return variant == kNumVariants
             ? sizeof(float) * 2 * static_cast<size_t>(D) * B * U
             : 0;
}

// Returns a cudaError_t (0 on success). is_bf16 selects the storage type of
// x_proj and hs; variant and cluster come from the wrapper's plan (variant
// kNumVariants is the streamed one); workspace holds
// seld_gru_fwd_workspace_bytes(D, B, U, variant) bytes.
int seld_gru_fwd(const void* xp, const void* rk, const void* rb, void* hs,
                 void* workspace, int D, int T_steps, int B, int U,
                 int is_bf16, int variant, int cluster, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* rkf = static_cast<const float*>(rk);
  const auto* rbf = static_cast<const float*>(rb);
  auto* ws = static_cast<float*>(workspace);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(variant, xp, rkf, rbf, hs, ws, D,
                                        T_steps, B, U, cluster, st)
              : dispatch<float>(variant, xp, rkf, rbf, hs, ws, D, T_steps, B,
                                U, cluster, st);
  return static_cast<int>(err);
}

const char* seld_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
