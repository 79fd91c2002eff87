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
// size splits U evenly (kVariants), the two resident ones (below) every
// U % 4 == 0 in (256, 512], the streamed one every U % 4 == 0 past 256
// (the plan's past 512); the plan, seld_tpu_torch/ops/gru.py::_fwd_plan,
// picks the variant, C and, for a resident variant, BT.
// At small B the latency variant (4, 8, 4) spreads a tile of 4 rows over a
// cluster of 8 CTAs of 64 threads (B = 32: 128 CTAs); at large B the batch
// variant (4, 8, 8) packs a tile of 8 rows into 2 CTAs of 256 threads (B =
// 256: 128 CTAs, one a SM, 8 warps each to hide the FMA and shared-memory
// latency). The wide variant (4, 9, 8) takes U up to 144, and the widest
// (8, 8, 8) U up to 256: 8 lanes a unit keep 96 Rk values a lane, and at
// U = 256 a cluster of 8 CTAs of 256 threads.
//
// From U = 260 to 512 the resident variants (gru_fwd_res_kernel, also a
// replacement of _fwd_kernel) keep a CTA's slice of Rk on chip for all T
// steps. The slice (U x 3 ucw f32, 216 KiB at U = 384 on 8 CTAs) fits
// neither the registers nor the shared memory alone, so it is split: a
// lane holds its chunks i < NR in registers and the NS others in shared
// memory, read each pass as float4 (a warp's reads are contiguous). Beside
// them each CTA keeps the double-buffered h rows of the tile, replicated
// ([2, BT, 4 S (NR + NS)] f32), and, as the register variants, the new h
// goes to every CTA of the cluster through st.shared::cluster with ONE
// cluster barrier a step. Tiles are of BT <= 40 rows, walked in passes of
// RP rows (a reduce-scatter over the S lanes leaves lane l one row a pass)
// so that the accumulators fit beside the held Rk.
//   Why this layout: the streamed step at U = 384, B = 256, bf16 took
// 59.4 us; without Rk's loads 42.3, without the h staging 46.8, without
// the cluster barrier 60.2 (python -m seld_tpu_torch.gru_probe, H100 SXM):
// the Rk reads and h's round trip through L2 were the cost, the barrier
// was not. The card runs at most 15 one-CTA-a-SM clusters of 8 and 7 of
// 16 at once (cudaOccupancyMaxActiveClusters), and every cluster walks all
// T steps, so a second wave doubles the time: at B = 256 tiles of 40 rows
// make 14 clusters, one wave at U <= 384 (C = 8, 216 KiB of Rk a CTA: 126
// KiB in registers, 90 in shared memory beside 120 of h), two at U <= 512
// (C = 16, a non-portable size: 192 KiB of Rk, 132 in registers, 60 in
// shared memory beside 160 of h). At U = 512, one wave would need 3 tiles
// of 86 rows: 344 KiB of replicated h rows. A CTA owns ucw = 4 ceil(U /
// 4C) units (the last CTAs fewer, or none), so every U % 4 == 0 splits.
//   What bounds it on the card: a lane uses each h value it reads from
// shared memory for 3 FMAs (its unit's three gates), and shared memory
// hands out 32 lane-words a clock, so the h reads allow 3 of the SM's 4
// FMA instructions a clock. Measured at U = 384, B = 256 (gru_probe
// --kernel resident): 21.1 us a step, 12.8 without the h reads, 19.4
// without the exchange or without the shared-memory Rk chunks, 20.4
// without the barrier; the FMAs alone need 9.8. A lane holding two units
// would halve the h reads, but its Rk share then needs more registers than
// a thread may have beside its accumulators.
//
// Past U = 512 with Rk handed over in bf16 (as the training step does) the
// grid-resident variant (gru_fwd_grid_kernel, its note below) holds Rk on
// the whole card, one CTA a SM, and multiplies on the tensor cores.
// The streamed variant (gru_fwd_stream_kernel) takes every U % 4 == 0 past
// 256 and is the plan's past 512 otherwise: a CTA's slice of Rk (U x 3U/C f32, 221 KB
// at U = 384 on 8 CTAs) fits neither the registers nor, beside h, the
// shared memory of one SM. So each step streams the slice from device
// memory (L2: both
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
// What bounds every variant: the f32 FMAs of h @ Rk at 67 TFLOP/s (the
// reference multiplies in f32, so neither bf16 nor single-pass TF32
// tensor-core products may stand in), then the per-step cluster barrier on
// the serial chain of T steps. The resident variants meet the first by
// reading Rk from registers and shared memory only, and the second by one
// barrier a step whose exchange is the new h alone. In the register
// variants at U = 128, B = 256 each SM issues 8 x 192 x 128 FMAs a step,
// ~1,536 cycles of its f32 lanes; at small B a step is short and the
// exchange (DSMEM stores and the barrier) and the gates are most of it.
// Their previous design kept all of Rk[d] (192 KB) in shared memory and
// streamed it through every step for 4 batch rows (~1,500 shared-memory
// wavefronts a step, two block barriers, 16 of 132 SMs busy at B = 32);
// here Rk never moves after its first load, and a step reads only h
// (BT x U f32) from shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc.cuh"

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

struct Resident {
  int c;   // CTAs a cluster (16: a non-portable size)
  int s;   // lanes that split one unit's k-range
  int nr;  // 4-row k chunks a lane holds in registers
  int ns;  // ... and in shared memory
  int bt;  // most batch rows a tile
  int rp;  // rows a pass
};
// the resident variants (U in (256, kResidentUnits]), mirrored by
// seld_tpu_torch/ops/gru.py::_FWD_RESIDENT: variant i takes U <= 4 s (nr +
// ns), each CTA ucw = 4 ceil(U / 4c) units (the last ones fewer)
constexpr Resident kResident[] = {{8, 8, 7, 5, 40, 8}, {16, 8, 11, 5, 40, 8}};
constexpr int kNumResident = sizeof(kResident) / sizeof(kResident[0]);
constexpr int kResidentUnits = 512;  // the widest U of kResident
__host__ __device__ constexpr int res_units(const Resident& v) {
  return 4 * v.s * (v.nr + v.ns);
}
__host__ __device__ constexpr int res_threads(const Resident& v) {
  return res_units(v) / v.c * v.s;
}
static_assert(res_units(kResident[kNumResident - 1]) == kResidentUnits,
              "kResidentUnits is the last variant's widest U");
// a CTA's units: a multiple of 4, so that C of them cover U
int res_cta_units(int U, int c) { return 4 * ((U + 4 * c - 1) / (4 * c)); }

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

// acc[g][b] += sum over q of a[b][q] w[g][q] for the RP rows of a pass: one
// 4-row k chunk of this lane; a points at the chunk in the pass's first h
// row, the rows `stride` floats apart; G rows' float4 reads are issued before
// their 12 G FMAs
template <int RP, int G>
__device__ __forceinline__ void fma_chunk(float (&acc)[3][RP],
                                          const float* a, int stride,
                                          const float (&w)[3][4]) {
#pragma unroll
  for (int b0 = 0; b0 < RP; b0 += G) {
    float4 h4[G];
#pragma unroll
    for (int b = 0; b < G; ++b)
      h4[b] = *reinterpret_cast<const float4*>(a + (b0 + b) * stride);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
#pragma unroll
        for (int b = 0; b < G; ++b) {
          const float hq = q == 0 ? h4[b].x : q == 1 ? h4[b].y
                         : q == 2 ? h4[b].z : h4[b].w;
          acc[g][b0 + b] = fmaf(hq, w[g][q], acc[g][b0 + b]);
        }
      }
    }
  }
}

// The resident variant V; grid (tiles * C, D), clusters of C CTAs along x,
// dynamic shared memory res_fwd_smem(V, blockDim.x, bt). CTA `rank` owns
// units [rank ucw, rank ucw + ucw) below U; thread tid is lane tid % S of
// CTA unit tid / S. Its Rk chunks i < NR live in registers, the NS others in
// shared memory as w_s[i - NR][g][tid] (float4 over q: a warp's reads are
// 512 contiguous bytes). A step walks the tile's rows in passes of RP:
// products, a reduce-scatter that leaves lane l row l RP / S + j, the gates
// and the exchange of that row's new state.
template <int C, int S, int NR, int NS, int RP, int MAXT, typename T>
__global__ void __launch_bounds__(MAXT, 1)
gru_fwd_res_kernel(const T* __restrict__ xp, const float* __restrict__ rk,
                   const float* __restrict__ rb, T* __restrict__ hs,
                   int steps, int batch, int units, int ucw, int bt) {
  constexpr int KP = 4 * S * (NR + NS);  // k extent of an h row, 0 from U on
  constexpr int R = RP / S;         // rows a lane finishes a pass
  constexpr int G = RP < 4 ? RP : 4;
  static_assert(RP % S == 0 && RP % G == 0, "a pass splits over S lanes");
  extern __shared__ __align__(16) float smem[];
  const int nt = blockDim.x;
  float4* w_s = reinterpret_cast<float4*>(smem);  // [NS][3][nt]
  float* h_flat = smem + 4 * NS * 3 * nt;         // [2][bt][KP]

  const int U = units;
  const int K = 3 * units;
  const int tid = threadIdx.x;
  const int lane = tid % S, uu = tid / S;
  const int rank = static_cast<int>(cluster_ctarank());
  const int uc = max(0, min(ucw, U - rank * ucw));  // units of this CTA
  const bool live = uu < uc;  // not a padding unit
  const int u = rank * ucw + uu;
  const int d = blockIdx.y;
  const int b0 = (blockIdx.x / C) * bt;
  const int rows = min(bt, batch - b0);
  const int passes = (rows + RP - 1) / RP;

  // this lane's slice of Rk[d], on chip for the whole loop
  const float* rk_d = rk + static_cast<size_t>(d) * U * K;
  auto weight = [&](int i, int q, int g) {
    const int k = 4 * (S * i + lane) + q;
    return live && k < U ? rk_d[static_cast<size_t>(k) * K + g * U + u]
                         : 0.0f;
  };
  float w[NR][3][4];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int g = 0; g < 3; ++g) w[i][g][q] = weight(i, q, g);
  for (int i = 0; i < NS; ++i)
    for (int g = 0; g < 3; ++g)
      w_s[(i * 3 + g) * nt + tid] =
          make_float4(weight(NR + i, 0, g), weight(NR + i, 1, g),
                      weight(NR + i, 2, g), weight(NR + i, 3, g));
  float bias[3];
#pragma unroll
  for (int g = 0; g < 3; ++g)
    bias[g] = live ? rb[static_cast<size_t>(d) * K + g * U + u] : 0.0f;
  for (int i = tid; i < 2 * bt * KP; i += nt) h_flat[i] = 0.0f;
  const uint32_t h_local =
      static_cast<uint32_t>(__cvta_generic_to_shared(h_flat));

  const size_t step_elems = static_cast<size_t>(batch) * K;  // one t
  const T* xp_d = xp + static_cast<size_t>(d) * steps * step_elems +
                  static_cast<size_t>(b0) * K;
  // every CTA's h buffers are zero before any peer writes into them
  cluster_arrive();
  cluster_wait();

  for (int s = 0; s < steps; ++s) {
    const int t = d == 0 ? s : steps - 1 - s;
    const float* hc = h_flat + (s & 1) * bt * KP;
    const bool exchange = s + 1 < steps;
    const int nxt = (s & 1) ^ 1;
    const T* xp_t = xp_d + static_cast<size_t>(t) * step_elems;
    T* hs_t = hs + ((static_cast<size_t>(d) * steps + t) * batch + b0) * U;
    for (int p = 0; p < passes; ++p) {
      const int first = p * RP + lane * R;
      // the gates' x_proj values, read while the products run
      float x[3][R];
      load_x<R>(x, xp_t, K, U, u, first, rows, live);
      float acc[3][RP];
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int b = 0; b < RP; ++b) acc[g][b] = 0.0f;
      const float* hrow = hc + p * RP * KP;
#pragma unroll
      for (int i = 0; i < NR; ++i)
        fma_chunk<RP, G>(acc, hrow + 4 * (S * i + lane), KP, w[i]);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        float ws[3][4];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const float4 f = w_s[(i * 3 + g) * nt + tid];
          ws[g][0] = f.x;
          ws[g][1] = f.y;
          ws[g][2] = f.z;
          ws[g][3] = f.w;
        }
        fma_chunk<RP, G>(acc, hrow + 4 * (S * (NR + i) + lane), KP, ws);
      }
      reduce_scatter<S / 2, RP / 2, RP>(acc, lane);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int row = first + j;
        // the previous state: every CTA's buffer holds every unit's
        const float h = hc[row * KP + u];
        const float z = sigmoid(x[0][j] + (acc[0][j] + bias[0]));
        const float r = sigmoid(x[1][j] + (acc[1][j] + bias[1]));
        const float c = tanh_fast(x[2][j] + r * (acc[2][j] + bias[2]));
        const float hn = z * h + (1.0f - z) * c;
        if (live && row < rows)
          store(hs_t + static_cast<size_t>(row) * U + u, hn);
        if (live && exchange) {
          const uint32_t off = static_cast<uint32_t>(
              ((nxt * bt + row) * KP + u) * sizeof(float));
#pragma unroll
          for (int peer = 0; peer < C; ++peer)
            st_cluster(map_rank(h_local + off, peer), hn);
        }
      }
    }
    if (exchange) {
      cluster_arrive();
      cluster_wait();
    }
  }
}

// The grid-resident forward (past U = 512, Rk in bf16): one CTA a SM
// holds the Rk columns of kGridUnits units (all three gates: 48 columns, U
// rows, 96 KB at U = 1024) in shared memory for all T steps; the D x U /
// kGridUnits CTAs are launched cooperatively (all resident or no launch).
// CTA c of direction d owns units [u0, u0 + 16), u0 = 16 c. A step:
//   - warp 8 waits until every CTA of the direction has published the
//     previous state (a counter a direction, release / acquire at GPU
//     scope), then streams it from the exchange buffer in 32-deep K chunks
//     (TMA bulk copies, a ring of `stages` stages): the state as HP =
//     kGridParts bf16 parts, each chunk [Bp rows][32] already in the wgmma
//     operand layout (tc::tile_offset), Bp = B rounded up to 64;
//   - two consumer warpgroups multiply each chunk with the CTA's Rk tiles
//     (m64n48k16 wgmma, warpgroup w the row blocks w and w + 2), each
//     chunk's partial sum added to the step's in f32;
//   - the epilogue is the gate math, thread-local: the 48 columns are z, r
//     and h of the same 16 units, so a thread holds all three gates of its
//     (row, unit) states, and it keeps those states' h in registers across
//     the steps; it writes hs and the new state's parts into the other
//     exchange slot, and the CTA adds 1 to its direction's counter.
// Two exchange slots suffice: a CTA writes slot t % 2 only after every CTA
// has published step t - 1, which each did after reading slot t % 2.
// Accuracy: the state h is f32 (kept so across the steps whatever the
// storage type), as in the TPU kernel's h @ Rk. Three bf16 parts hold it
// exactly (each part rounds what the earlier ones leave), so with Rk exact
// in bf16 the product is f32's up to summation order. Two parts would keep
// h to within 2^-18 of itself (each rounding leaves at most 2^-9 of what
// it rounds) at two thirds of the exchange's bytes.
// What bounds it: every CTA reads the whole state each step (HP x B x U x
// 2 bytes: 1.5 MB at U = 1024, B = 256), 192 MB a step from L2 over the
// card; the products are 2 HP B U 48 operations a CTA.
constexpr int kGridUnits = 16;
constexpr int kGridConsumers = 256;
constexpr int kGridThreads = kGridConsumers + 32;
constexpr int kGridRows = 256;       // the most batch rows (4 row blocks)
constexpr int kGridParts = 3;        // bf16 parts of the state: f32 whole
constexpr int kGridRkTile = tc::tile_bytes(3 * kGridUnits);  // a K chunk

// hx: [2 slots][D][HP][U / 32 chunks][Bp x 32 tile] bf16; counter: [D],
// zero at launch
template <typename T, int HP>
__global__ void __launch_bounds__(kGridThreads, 1)
gru_fwd_grid_kernel(const T* __restrict__ xp,
                    const __nv_bfloat16* __restrict__ rk,
                    const float* __restrict__ rb, T* __restrict__ hs,
                    __nv_bfloat16* __restrict__ hx,
                    uint32_t* __restrict__ counter, int n_dirs, int T_steps,
                    int B, int U, int stages) {
  extern __shared__ uint8_t smem_raw[];
  const int cpd = U / kGridUnits;
  const int d = blockIdx.x / cpd, u0 = blockIdx.x % cpd * kGridUnits;
  const int K3 = 3 * U, Bp = (B + 63) / 64 * 64, nch = U / tc::kK;
  const int chunk = tc::tile_bytes(Bp);  // one part of one K chunk
  uint8_t* rks = tc::align_1024(smem_raw);  // [nch][48 x 32 tile]
  uint8_t* ring = rks + nch * kGridRkTile;  // [stages][HP][chunk]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * HP * chunk);
  uint64_t* empty = full + stages;
  const size_t slot = static_cast<size_t>(n_dirs) * HP * nch * chunk;
  const int tid = threadIdx.x;

  // Rk's 48 columns of the CTA, row n = 16 g + j <- Rk[d][k][g U + u0 + j]
  for (int e = tid; e < U * 6; e += kGridThreads) {
    const int k = e / 6, g = e % 6 / 2, half = e % 2;
    const uint4 v = *reinterpret_cast<const uint4*>(
        rk + (static_cast<size_t>(d) * U + k) * K3 + g * U + u0 + 8 * half);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint8_t* tile = rks + k / tc::kK * kGridRkTile;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = 16 * g + 8 * half + i;
      *reinterpret_cast<uint16_t*>(tile + tc::tile_offset(n, k % tc::kK)) =
          static_cast<uint16_t>(w[i / 2] >> (16 * (i % 2)));
    }
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], kGridConsumers);
    }
    tc::fence_mbar_init();
  }
  tc::fence_proxy_async();  // the Rk tiles, for wgmma
  __syncthreads();

  if (tid >= kGridConsumers) {  // the producer warp: one lane issues
    if (tid == kGridConsumers) {
      int g = 0;
      for (int p = 1; p < T_steps; ++p) {
        tc::wait_counter(&counter[d], static_cast<uint32_t>(cpd * p));
        tc::fence_proxy_async_global();
        const uint8_t* src = reinterpret_cast<const uint8_t*>(hx) +
                             ((p - 1) & 1) * slot +
                             static_cast<size_t>(d) * HP * nch * chunk;
        for (int kc = 0; kc < nch; ++kc, ++g) {
          const int s = g % stages;
          tc::mbar_wait(&empty[s], ((g / stages) & 1) ^ 1);
          tc::mbar_expect_tx(&full[s], HP * chunk);
#pragma unroll
          for (int a = 0; a < HP; ++a)
            tc::bulk_load(ring + (s * HP + a) * chunk,
                          src + (static_cast<size_t>(a) * nch + kc) * chunk,
                          chunk, &full[s]);
        }
      }
    }
    return;
  }

  // this thread's states: row blocks mb = wg + 2 q (below Bp / 64); in
  // each, rows 16 warp + lane / 4 (+ 8 h) and units 8 i + 2 (lane % 4) + e
  // of the CTA's 16: z, r and h are accumulator n8 blocks i, i + 2, i + 4
  const int wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
  const int blocks = Bp / 64;
  float h[2][2][2][2] = {};  // [q][i][h][e]
  int g = 0;
  for (int p = 0; p < T_steps; ++p) {
    const int t = d == 0 ? p : T_steps - 1 - p;
    // x_proj of the states, loaded before the product
    float x[2][3][2][2][2];  // [q][gate][i][h][e]
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int mb = wg + 2 * q;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = 64 * mb + 16 * warp + lane / 4 + 8 * hh;
          const int u = u0 + 8 * i + 2 * (lane % 4);
#pragma unroll
          for (int gt = 0; gt < 3; ++gt) {
            float v0 = 0.0f, v1 = 0.0f;
            if (mb < blocks && row < B) {
              const T* src = xp + ((static_cast<size_t>(d) * T_steps + t) *
                                       B + row) * K3 + gt * U + u;
              v0 = to_f32(src[0]);
              v1 = to_f32(src[1]);
            }
            x[q][gt][i][hh][0] = v0;
            x[q][gt][i][hh][1] = v1;
          }
        }
    }
    float acc[2][24] = {};
    if (p > 0) {
      for (int kc = 0; kc < nch; ++kc, ++g) {
        const int s = g % stages;
        tc::mbar_wait(&full[s], (g / stages) & 1);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int mb = wg + 2 * q;
          if (mb >= blocks) continue;
          float part[24];
          tc::wgmma_fence();
          int accumulate = 0;
#pragma unroll
          for (int a = HP - 1; a >= 0; --a)
#pragma unroll
            for (int kk = 0; kk < tc::kK / 16; ++kk) {
              tc::wgmma_n48(
                  part,
                  tc::desc(tc::smem_u32(ring + (s * HP + a) * chunk) +
                           mb * 8 * tc::kSbo + kk * 2 * tc::kLbo),
                  tc::desc(tc::smem_u32(rks + kc * kGridRkTile) +
                           kk * 2 * tc::kLbo),
                  accumulate);
              accumulate = 1;
            }
          tc::wgmma_commit();
          tc::wgmma_wait<0>();
#pragma unroll
          for (int e = 0; e < 24; ++e) acc[q][e] += part[e];
        }
        tc::mbar_arrive(&empty[s]);
      }
    }
    // the gates; the new state into hs and, as HP bf16 parts, into slot
    // p % 2 of the exchange buffer (rows past B hold 0)
    uint8_t* dst = reinterpret_cast<uint8_t*>(hx) + (p & 1) * slot +
                   static_cast<size_t>(d) * HP * nch * chunk;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int mb = wg + 2 * q;
      if (mb >= blocks) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = 64 * mb + 16 * warp + lane / 4 + 8 * hh;
          const int u = u0 + 8 * i + 2 * (lane % 4);
          float hn[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float* bias = rb + static_cast<size_t>(d) * K3 + u + e;
            const float hz = acc[q][4 * i + 2 * hh + e] + bias[0];
            const float hr = acc[q][4 * (i + 2) + 2 * hh + e] + bias[U];
            const float hc = acc[q][4 * (i + 4) + 2 * hh + e] + bias[2 * U];
            const float z = sigmoid(x[q][0][i][hh][e] + hz);
            const float r = sigmoid(x[q][1][i][hh][e] + hr);
            const float c = tanh_fast(x[q][2][i][hh][e] + r * hc);
            hn[e] = row < B ? z * h[q][i][hh][e] + (1.0f - z) * c : 0.0f;
            h[q][i][hh][e] = hn[e];
          }
          if (row < B) {
            T* out = hs + ((static_cast<size_t>(d) * T_steps + t) * B + row) *
                              U + u;
            store(out, hn[0]);
            store(out + 1, hn[1]);
          }
          float rest[2] = {hn[0], hn[1]};
#pragma unroll
          for (int a = 0; a < HP; ++a) {
            const __nv_bfloat16 p0 = __float2bfloat16_rn(rest[0]);
            const __nv_bfloat16 p1 = __float2bfloat16_rn(rest[1]);
            rest[0] -= __bfloat162float(p0);
            rest[1] -= __bfloat162float(p1);
            *reinterpret_cast<uint32_t*>(
                dst + (static_cast<size_t>(a) * nch + u / tc::kK) * chunk +
                tc::tile_offset(row, u % tc::kK)) = tc::pack2(p0, p1);
          }
        }
    }
    // publish the step: every consumer's writes, then one release
    tc::fence_proxy_async_global();
    tc::named_sync(1, kGridConsumers);
    if (tid == 0) {
      __threadfence();
      tc::red_release_add(&counter[d], 1);
    }
  }
}

// the cluster size of the streamed variant: the largest of 8, 4 dividing U
int stream_cluster(int U) { return U % 8 == 0 ? 8 : 4; }

// Dynamic shared memory of resident variant V for blocks of `threads`
// threads and tiles of bt rows: its Rk chunks, then the double-buffered h
// rows.
size_t res_fwd_smem(int V, int threads, int bt) {
  const Resident& v = kResident[V];
  return sizeof(float) * (static_cast<size_t>(4) * 3 * v.ns * threads +
                          static_cast<size_t>(2) * bt * res_units(v));
}

// The launch configuration of resident variant V (clusters of C CTAs of
// ucw S threads, grid (tiles * C, D)); false where the variant does not
// take U or bt.
bool res_config(int V, int D, int B, int U, int cluster, int bt,
                cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const Resident& v = kResident[V];
  const int ucw = res_cta_units(U, v.c);
  if (U <= kRegisterUnits || U % 4 || cluster != v.c ||
      ucw * v.c > res_units(v) || bt < 8 || bt > v.bt || bt % 8 || B < 1)
    return false;
  *cfg = {};
  cfg->gridDim = dim3((B + bt - 1) / bt * v.c, D, 1);
  cfg->blockDim = dim3(ucw * v.s, 1, 1);
  cfg->dynamicSmemBytes = res_fwd_smem(V, ucw * v.s, bt);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = v.c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return true;
}

// variant V's kernel for storage type T
template <int V, typename T>
auto res_kernel() {
  constexpr Resident v = kResident[V];
  return gru_fwd_res_kernel<v.c, v.s, v.nr, v.ns, v.rp, res_threads(v), T>;
}

// Opens variant V's kernel to its shared memory and cluster size.
template <int V, typename T>
cudaError_t res_attributes(const cudaLaunchConfig_t& cfg) {
  constexpr Resident v = kResident[V];
  auto* kern = res_kernel<V, T>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(cfg.dynamicSmemBytes));
  if (err == cudaSuccess && v.c > kMaxCluster)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

template <int V, typename T>
cudaError_t launch_res(const void* xp, const float* rk, const float* rb,
                       void* hs, int D, int T_steps, int B, int U,
                       int cluster, int bt, cudaStream_t stream) {
  constexpr Resident v = kResident[V];
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  if (!res_config(V, D, B, U, cluster, bt, &cfg, attr))
    return cudaErrorInvalidValue;
  cfg.stream = stream;
  cudaError_t err = res_attributes<V, T>(cfg);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, res_kernel<V, T>(),
                           static_cast<const T*>(xp), rk, rb,
                           static_cast<T*>(hs), T_steps, B, U,
                           res_cta_units(U, v.c), bt);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters of variant V at this launch, into *out
template <int V>
cudaError_t res_max_clusters(int D, int B, int U, int bt, int* out) {
  constexpr Resident v = kResident[V];
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  if (!res_config(V, D, B, U, v.c, bt, &cfg, attr))
    return cudaErrorInvalidValue;
  cudaError_t err = res_attributes<V, float>(cfg);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(out, res_kernel<V, float>(), &cfg);
}

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

// the grid-resident forward (plan index kGridVariant): kGridParts bf16
// parts of the state, rows padded to a multiple of 64, its exchange buffer
constexpr int kGridVariant = kNumVariants + kNumResident + 1;
constexpr int kSms = 132;  // H100 SXM
int grid_bp(int B) { return (B + 63) / 64 * 64; }
size_t grid_bytes(int D, int B, int U, int parts) {
  return 256 + static_cast<size_t>(2) * D * parts * (U / tc::kK) *
                   tc::tile_bytes(grid_bp(B));
}
bool grid_takes(int D, int B, int U) {
  return U > kResidentUnits && U % (2 * kGridUnits) == 0 && B >= 1 &&
         B <= kGridRows && D * U / kGridUnits <= kSms;
}
// the ring's stages that fit beside the Rk tiles (2 to 4; 0 if fewer)
int grid_stages(int B, int U, int parts) {
  const size_t fixed = 1024 + static_cast<size_t>(U / tc::kK) * kGridRkTile;
  const size_t stage = parts * tc::tile_bytes(grid_bp(B)) + 16;
  if (fixed + 2 * stage > 232448) return 0;
  const size_t n = (232448 - fixed) / stage;
  return n > 4 ? 4 : static_cast<int>(n);
}
size_t grid_smem(int B, int U, int parts, int stages) {
  return 1024 + static_cast<size_t>(U / tc::kK) * kGridRkTile +
         static_cast<size_t>(stages) * (parts * tc::tile_bytes(grid_bp(B)) + 16);
}

// The grid-resident forward: cooperative, after checking that every CTA
// fits at once (else cudaErrorCooperativeLaunchTooLarge: never a launch
// that could wait forever); the counters are zeroed first.
template <typename T, int HP>
cudaError_t grid_config(int D, int B, int U, cudaLaunchConfig_t* cfg,
                        int* per_sm) {
  if (!grid_takes(D, B, U)) return cudaErrorInvalidValue;
  const int stages = grid_stages(B, U, HP);
  if (stages < 2) return cudaErrorInvalidValue;
  *cfg = {};
  cfg->gridDim = dim3(D * U / kGridUnits, 1, 1);
  cfg->blockDim = dim3(kGridThreads, 1, 1);
  cfg->dynamicSmemBytes = grid_smem(B, U, HP, stages);
  auto* kern = gru_fwd_grid_kernel<T, HP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(cfg->dynamicSmemBytes));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kern, kGridThreads, cfg->dynamicSmemBytes);
}

template <typename T, int HP>
cudaError_t launch_grid(const void* xp, const void* rk16, const float* rb,
                        void* hs, void* ws, int D, int T_steps, int B, int U,
                        cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = grid_config<T, HP>(D, B, U, &cfg, &per_sm);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm * sms < static_cast<int>(cfg.gridDim.x) || ws == nullptr)
    return cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.stream = stream;
  auto* counter = static_cast<uint32_t*>(ws);
  err = cudaMemsetAsync(counter, 0, 256, stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(
      &cfg, gru_fwd_grid_kernel<T, HP>, static_cast<const T*>(xp),
      static_cast<const __nv_bfloat16*>(rk16), rb, static_cast<T*>(hs),
      reinterpret_cast<__nv_bfloat16*>(static_cast<uint8_t*>(ws) + 256),
      counter, D, T_steps, B, U, grid_stages(B, U, HP));
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int variant, const void* xp, const float* rk,
                     const float* rb, void* hs, float* ws, int D, int T_steps,
                     int B, int U, int cluster, int bt, const void* rk16,
                     cudaStream_t st) {
  switch (variant) {
    case kGridVariant:
      return launch_grid<T, kGridParts>(xp, rk16, rb, hs, ws, D,
                                                    T_steps, B, U, st);
    case kNumVariants:
      return launch_stream<T>(xp, rk, rb, hs, ws, D, T_steps, B, U, cluster,
                              st);
    case kNumVariants + 1:
      return launch_res<0, T>(xp, rk, rb, hs, D, T_steps, B, U, cluster, bt,
                              st);
    case kNumVariants + 2:
      return launch_res<1, T>(xp, rk, rb, hs, D, T_steps, B, U, cluster, bt,
                              st);
    case 0: return launch<0, T>(xp, rk, rb, hs, D, T_steps, B, U, cluster, st);
    case 1: return launch<1, T>(xp, rk, rb, hs, D, T_steps, B, U, cluster, st);
    case 2: return launch<2, T>(xp, rk, rb, hs, D, T_steps, B, U, cluster, st);
    case 3: return launch<3, T>(xp, rk, rb, hs, D, T_steps, B, U, cluster, st);
    default: return cudaErrorInvalidValue;
  }
}
static_assert(kNumVariants == 4 && kNumResident == 2 && kGridVariant == 7,
              "dispatch() names every variant");

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

// Writes the resident variants' table as (C, S, NR, NS, BT, RP) sextuples
// and kResidentUnits after them into out; returns the number of variants
int seld_gru_fwd_resident(int* out, int cap) {
  if (cap < 6 * kNumResident + 1) return 0;
  for (int i = 0; i < kNumResident; ++i) {
    const Resident& v = kResident[i];
    const int row[6] = {v.c, v.s, v.nr, v.ns, v.bt, v.rp};
    for (int j = 0; j < 6; ++j) out[6 * i + j] = row[j];
  }
  out[6 * kNumResident] = kResidentUnits;
  return kNumResident;
}

// cudaOccupancyMaxActiveClusters of resident variant `variant` (plan index
// kNumVariants + 1 + i) at D, B, U and tiles of bt rows, into *out; returns
// a cudaError_t
int seld_gru_fwd_max_clusters(int D, int B, int U, int variant, int bt,
                              int* out) {
  cudaError_t err = cudaErrorInvalidValue;
  if (variant == kNumVariants + 1)
    err = res_max_clusters<0>(D, B, U, bt, out);
  else if (variant == kNumVariants + 2)
    err = res_max_clusters<1>(D, B, U, bt, out);
  return static_cast<int>(err);
}

// Bytes of scratch one call needs: the streamed variant's double-buffered
// f32 states (variant kNumVariants), the grid-resident one's counters and
// exchange slots (kGridVariant), none for the others.
size_t seld_gru_fwd_workspace_bytes(int D, int B, int U, int variant) {
  if (variant == kGridVariant) return grid_bytes(D, B, U, kGridParts);
  return variant == kNumVariants
             ? sizeof(float) * 2 * static_cast<size_t>(D) * B * U
             : 0;
}

// Writes the grid-resident forward's constants (kGridUnits, kGridThreads,
// kGridRows, kGridParts, its plan index) into out; returns their number
int seld_gru_fwd_grid(int* out, int cap) {
  if (cap < 5) return 0;
  out[0] = kGridUnits;
  out[1] = kGridThreads;
  out[2] = kGridRows;
  out[3] = kGridParts;
  out[4] = kGridVariant;
  return 5;
}

// cudaOccupancyMaxActiveBlocksPerMultiprocessor of the grid-resident
// forward at D, B, U, into *out; returns a cudaError_t
int seld_gru_fwd_grid_blocks(int D, int B, int U, int is_bf16, int* out) {
  cudaLaunchConfig_t cfg;
  return static_cast<int>(
      is_bf16 ? grid_config<__nv_bfloat16, kGridParts>(D, B, U, &cfg, out)
              : grid_config<float, kGridParts>(D, B, U, &cfg, out));
}

// Returns a cudaError_t (0 on success). is_bf16 selects the storage type of
// x_proj and hs; variant, cluster and bt (the resident variants' tile rows)
// come from the wrapper's plan (variant kNumVariants is the streamed one,
// kNumVariants + 1 + i resident variant i, kGridVariant the grid-resident
// one, which reads rk16, Rk in bf16, instead of rk); workspace holds
// seld_gru_fwd_workspace_bytes(D, B, U, variant) bytes.
int seld_gru_fwd(const void* xp, const void* rk, const void* rb, void* hs,
                 void* workspace, int D, int T_steps, int B, int U,
                 int is_bf16, int variant, int cluster, int bt,
                 const void* rk16, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* rkf = static_cast<const float*>(rk);
  const auto* rbf = static_cast<const float*>(rb);
  auto* ws = static_cast<float*>(workspace);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(variant, xp, rkf, rbf, hs, ws, D,
                                        T_steps, B, U, cluster, bt, rk16, st)
              : dispatch<float>(variant, xp, rkf, rbf, hs, ws, D, T_steps, B,
                                U, cluster, bt, rk16, st);
  return static_cast<int>(err);
}

const char* seld_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
