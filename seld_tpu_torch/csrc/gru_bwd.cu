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
// Design. On the TPU dh, dRk and dRb lived in VMEM across a sequential grid
// axis over T, and each step recomputed hp. Here three kernels and a sum:
//   1. hp: h_prev is known for every step from hs, so hp for all T is one
//      parallel [T B, U] x [U, 3U] product per direction, into the
//      workspace, on the tensor cores (gru_bwd_hp_tc_kernel: TMA,
//      wgmma, f32 operands as bf16 parts; its note below). TMA loads rows
//      of a multiple of 16 bytes: the wrapper hands hs and Rk over as they
//      come where theirs are, else as f32 copies (bf16 with U % 8 == 4).
//   2. gru_bwd_rec_kernel: the serial part, with ONE product a step,
//      dh_prev = dh z + dhp @ Rk^T, on the forward kernel's partition: a
//      thread block cluster per (direction, tile of BT batch rows), whose C
//      CTAs split the U units. CTA c owns units [c U/C, (c+1) U/C):
//        - it holds Rk's rows for its units (U/C x 3U f32) in REGISTERS for
//          all T steps: a group of S lanes owns NU units, and lane l the
//          k-chunks 4 (S i + l) + q of each gate's third of the rows;
//        - a step: each lane finishes NU BT / S consecutive (unit, row)
//          states: dh = carry + g, then dx_proj and dhp, which are linear in
//          dh with coefficients formed off the chain (from x_proj, hp and
//          h_prev loaded two steps ahead); dhp goes through distributed
//          shared memory into the double-buffered dhp rows of every CTA of
//          the cluster; ONE cluster barrier, whose arrive comes before the
//          step's global stores (dx_proj, dhp over hp for pass 3) so that
//          its release waits on the exchange alone; then the product of the
//          full dhp rows with the CTA's Rk rows (a float4 of dhp read from
//          shared memory feeds 4 NU FMAs) and a reduce-scatter over the S
//          lanes that leaves each lane the sums of its own states;
//        - no block barrier inside the step. dRb's sums over T stay in
//          registers and are added over a tile's rows at the end.
//      `_bwd_plan` in seld_tpu_torch/ops/gru.py picks the variant (kVariants)
//      and C, as `_fwd_plan` does for the forward. The widest variant
//      (16, 4, 8, 2) takes U up to 256: 96 Rk values a lane, and at U = 256
//      a cluster of 8 CTAs of 256 threads whose double-buffered dhp rows
//      fill the 48 KB of static shared memory.
//      From U = 260 to 512 the resident recurrence (gru_bwd_res_kernel)
//      keeps a CTA's slice of Rk on chip for all T steps, split between
//      registers and shared memory as in the forward's resident variants
//      (csrc/gru_fwd.cu). Replicating dhp as the register variants do would
//      take 2 x BT x 3U f32 a CTA (288 KiB at BT = 32, U = 384), so the
//      product is split by dhp instead of by output unit: CTA `rank` owns
//      units [rank ucw, rank ucw + ucw), forms their states and their dhp
//      (dloc, [BT, 3 ucw] in its own shared memory: no exchange), and
//      multiplies that dhp by the matching columns of Rk^T for EVERY output
//      unit, Rk[u'][g U + rank ucw + unit] (3 ucw x C ucw f32, the same
//      216 KiB as the forward's slice at U = 384). Its partial sums go to
//      each unit's owner through st.shared::cluster.v4 into slots [2, C,
//      BT, ucw] (double-buffered: one cluster barrier a step), and the owner
//      adds the C partial sums in rank order: the exchange is BT x U values
//      a CTA a step, as the forward's. A lane group of S lanes owns 4
//      output units and splits the CTA's k' = g ucw + unit; a pass of RP
//      rows ends in a reduce-scatter over the S lanes. A thread finishes
//      the states of one unit in rows tid / ucw + 8 i; their next step's
//      loads are issued between the barrier's arrive and its wait. At
//      B = 256 tiles of 40 rows make 14 clusters: one wave at U <= 384 (C =
//      8, 144 KiB of Rk in registers and 72 in shared memory beside 120 of
//      slots and 22 of dloc), two at U <= 512 (C = 16: 144 + 48, beside 160
//      and 15); the card runs at most 15 clusters of 8 and 7 of 16 at once.
//      The streamed recurrence (gru_bwd_stream_kernel) takes every U % 4 ==
//      0 past 256 and is the plan's past 512: a CTA's Rk rows fit no
//      register file, so each step reads them from device memory (L2) as
//      Rk^T [D, 3U, U]
//      (gru_bwd_transpose_kernel, once a call; coalesced over a warp's
//      units). A thread of CTA c owns one of its units for all kStreamBT
//      rows of the tile; its carry (dh z, then + dhp @ Rk^T) lives in a
//      workspace [D, B, U] f32 and its dRb sums in the per-tile buffer;
//      up to kStreamSplits groups of threads split the product's j range
//      and add their partial sums through shared memory.
//      dhp goes through the workspace (written over hp, as above) and ONE
//      cluster barrier a step orders it; the product then reads the full
//      dhp rows in chunks staged in shared memory (ld.global.cg).
//      Past U = 512 with Rk in bf16 the grid-resident recurrence
//      (gru_bwd_grid_kernel; its note below) holds Rk on the whole card.
//   3. dRk[d] = sum over the T B rows of h_prev^T dhp, as pass 1's product
//      (gru_bwd_drk_tc_kernel) over fixed slices
//      of the rows, no float atomics; gru_bwd_finalize_kernel adds the
//      slices (dRk) and the tiles (dRb) in a fixed order, so the result
//      does not depend on block scheduling.
//
// What bounds it. Pass 2 of every variant: the f32 FMAs of dhp @ Rk^T at
// 67 TFLOP/s, then the per-step cluster barrier on the chain of T steps;
// the resident recurrence reads Rk from registers and shared memory only
// and exchanges the partial sums alone, once a step.
// At the training shape (D = 2, T = 60, B = 256, U = 128,
// bf16 storage) the three B x U x 3U products per step and direction are
// 9.06 GFLOP, 0.135 ms at the f32 rate outside the tensor cores (67
// TFLOP/s); the reference multiplies in f32, so a single bf16 or TF32
// tensor-core product may stand in only where both operands are exact in
// bf16: the tensor-core passes split each f32 operand into three bf16
// parts (1, 3 or 6 products at 989 TFLOP/s). Bytes (about 63 MB, plus the
// f32 workspace hp/dhp written and read twice, 47 MB) are a few hundredths
// of a ms. Pass 2 is a chain of T steps, each a third of the FMAs on 128
// SMs plus one cluster barrier. The previous design kept Rk[d] in shared
// memory, did both products of a step on the serial chain (h_prev @ Rk and
// dhp @ Rk^T) with four block barriers a step, and reduced dRk with 4
// outputs a thread (1.02 ms).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc.cuh"

namespace {

struct Variant {
  int s;     // lanes that split one unit group's k-range
  int ni;    // 4-wide k chunks per lane and gate
  int bt;    // batch rows per tile
  int nu;    // units per lane group
  int maxt;  // most threads a block may have (__launch_bounds__)
};
// mirrored by seld_tpu_torch/ops/gru.py::_BWD_VARIANTS; variant v takes
// U <= 4 s ni
constexpr Variant kVariants[] = {{16, 2, 8, 4, 256}, {16, 2, 4, 4, 256},
                                 {8, 5, 8, 2, 256}, {16, 4, 8, 2, 256}};
constexpr int kNumVariants = sizeof(kVariants) / sizeof(kVariants[0]);
constexpr int kMaxCluster = 8;
// Rk values a lane holds (NU x 3 x NI x 4): with its partial sums, dhp reads
// and coefficients it stays within the 255 registers a thread may have
constexpr int kMaxWeights = 128;
constexpr bool weights_fit(int i) {
  return i == kNumVariants ||
         (kVariants[i].nu * 3 * kVariants[i].ni * 4 <= kMaxWeights &&
          weights_fit(i + 1));
}
static_assert(weights_fit(0), "a variant holds more Rk than registers allow");

// the streamed recurrence (U > 256), mirrored by ops/gru.py::_STREAM:
// batch rows per tile, most threads a block, dhp values staged a chunk
constexpr int kStreamBT = 16;
constexpr int kStreamThreads = 256;
constexpr int kStreamChunk = 128;
constexpr int kStreamSplits = 4;     // most groups splitting a chunk's j
// the groups' partial sums: (KS - 1) x BT x UW floats, largest at KS = 4,
// UW = 64
constexpr int kStreamPartials = 3 * kStreamBT * 64;
constexpr int kRegisterUnits = 256;  // the widest U of kVariants

struct Resident {
  int c;   // CTAs a cluster (16: a non-portable size)
  int s;   // lanes that split a group's k' range (the CTA's dhp)
  int nr;  // 4-wide k' chunks a lane holds in registers
  int ns;  // ... and in shared memory
  int bt;  // most batch rows a tile
  int rp;  // rows a pass
};
// the resident recurrence (U in (256, kResidentUnits]), mirrored by
// seld_tpu_torch/ops/gru.py::_BWD_RESIDENT: a lane group owns 4 output
// units, each CTA ucw = 4 ceil(U / 4c) units of dhp; variant i takes
// 3 ucw <= 4 s (nr + ns)
constexpr Resident kResident[] = {{8, 4, 6, 3, 40, 4}, {16, 2, 9, 3, 40, 4}};
constexpr int kNumResident = sizeof(kResident) / sizeof(kResident[0]);
constexpr int kResidentUnits = 512;  // the widest U of kResident
constexpr int kGroupUnits = 4;       // output units of a lane group
__host__ __device__ constexpr int res_k(const Resident& v) {
  return 4 * v.s * (v.nr + v.ns);  // k' extent of a dhp row, 3 ucw <= it
}
__host__ __device__ constexpr int res_threads(const Resident& v) {
  return res_k(v) / 3 * v.c / kGroupUnits * v.s;
}
static_assert(res_k(kResident[kNumResident - 1]) / 3 *
                      kResident[kNumResident - 1].c ==
                  kResidentUnits,
              "kResidentUnits is the last variant's widest U");
// a CTA's units: a multiple of 4, so that C of them cover U
int res_cta_units(int U, int c) { return 4 * ((U + 4 * c - 1) / (4 * c)); }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// __expf and __fdividef keep ~2 ulp relative error, as in the forward
// kernel; tanh through exp is exact at both tails
__device__ __forceinline__ float sigmoid(float v) {
  return __fdividef(1.0f, 1.0f + __expf(-v));
}
__device__ __forceinline__ float tanh_fast(float v) {
  return 1.0f - __fdividef(2.0f, __expf(2.0f * v) + 1.0f);
}

// R consecutive values (R = 1 or 2; a pair is 8-byte aligned in f32 and
// 4-byte aligned in bf16: U % 4 == 0 and the first unit is even)
template <int R>
__device__ __forceinline__ void load_run(const float* p, float (&v)[R]) {
  if constexpr (R == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = *p;
  }
}
template <int R>
__device__ __forceinline__ void load_run(const __nv_bfloat16* p,
                                         float (&v)[R]) {
  if constexpr (R == 2) {
    const float2 x =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}
template <int R>
__device__ __forceinline__ void store_run(float* p, const float (&v)[R]) {
  if constexpr (R == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *p = v[0];
}
// rounded to nearest even, as torch's cast
template <int R>
__device__ __forceinline__ void store_run(__nv_bfloat16* p,
                                          const float (&v)[R]) {
  if constexpr (R == 2)
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  else
    *p = __float2bfloat16(v[0]);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // rounded to nearest even, as torch's cast
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
template <int R>
__device__ __forceinline__ void st_cluster_run(uint32_t addr,
                                               const float (&v)[R]) {
  if constexpr (R == 2)
    asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};" ::"r"(addr),
                 "f"(v[0]), "f"(v[1])
                 : "memory");
  else
    asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v[0])
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

// Adds up the partial sums of the S lanes of a group and leaves lane l the
// totals of entries [l E/S, (l + 1) E/S) in acc[0, E/S). Round by round
// (lane bit M from S / 2 down to 1; N entries in each half), a lane keeps
// the half of its entries that its bit selects and adds its partner's copy.
template <int M, int N, int E>
__device__ __forceinline__ void reduce_scatter(float (&acc)[E], int lane) {
  if constexpr (M >= 1) {
    const bool upper = (lane & M) != 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float send = upper ? acc[j] : acc[j + N];
      const float keep = upper ? acc[j + N] : acc[j];
      acc[j] = keep + __shfl_xor_sync(0xffffffffu, send, M);
    }
    reduce_scatter<M / 2, N / 2, E>(acc, lane);
  }
}

// What the states of one step need from memory (x_proj's gates, hp's
// gates, h_prev, g), loaded a step before their coefficients are formed
template <int R>
struct Raw {
  float x[3][R], h[3][R], h_prev[R], g[R];
};
// ... and their update gate and the coefficients that make dx_proj and dhp
// linear in dh: dx_proj = dh [az, ar, ah], dhp = dh [az, ar, ahr]
template <int R>
struct Coef {
  float z[R], az[R], ar[R], ah[R], ahr[R], g[R];
};

template <int R>
__device__ __forceinline__ void coefficients(const Raw<R>& w, Coef<R>& cf) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const float z = sigmoid(w.x[0][j] + w.h[0][j]);
    const float r = sigmoid(w.x[1][j] + w.h[1][j]);
    const float hh = w.h[2][j];
    const float c = tanh_fast(w.x[2][j] + r * hh);
    cf.z[j] = z;
    cf.ah[j] = (1.0f - z) * (1.0f - c * c);
    cf.az[j] = (w.h_prev[j] - c) * z * (1.0f - z);
    cf.ar[j] = cf.ah[j] * hh * r * (1.0f - r);
    cf.ahr[j] = cf.ah[j] * r;
    cf.g[j] = w.g[j];
  }
}

// Pass 2; grid (tiles * C, D), clusters of C CTAs along x. hp_dhp holds hp
// [D, T, B, 3U] on entry and dhp on exit (a lane reads its states' hp two
// steps before it writes their dhp there); dbias [D, tiles, 3U] gets each
// tile's dhp summed over T (in step order) and its rows (in a fixed
// butterfly over the lanes of a group).
template <int S, int NI, int BT, int NU, int MAXT, typename T>
__global__ void __launch_bounds__(MAXT)
gru_bwd_rec_kernel(const T* __restrict__ xp, const float* __restrict__ rk,
                   const T* __restrict__ hs, const T* __restrict__ g,
                   T* __restrict__ dxp, float* __restrict__ hp_dhp,
                   float* __restrict__ dbias, int steps, int batch,
                   int units, int cluster) {
  constexpr int KP = 4 * S * NI;  // k extent of a gate's dhp row, 0 from U
  constexpr int E = NU * BT;      // partial sums a lane carries
  constexpr int R = E / S;        // states a lane finishes each step
  static_assert(E % S == 0 && NU % R == 0,
                "a lane finishes R consecutive units of one row");
  __shared__ __align__(16) float dbuf[2][BT][3][KP];

  const int U = units;
  const int K = 3 * units;
  const int uc = units / cluster;  // units of this CTA
  const int lane = threadIdx.x % S;
  const int grp = threadIdx.x / S;
  const bool live = grp * NU < uc;  // not a padding group
  const int ubase = static_cast<int>(cluster_ctarank()) * uc + grp * NU;
  const int d = blockIdx.y;
  const int b0 = (blockIdx.x / cluster) * BT;
  const int rows = min(BT, batch - b0);

  // this lane's slice of Rk[d]'s rows ubase .. ubase + NU, for all T steps
  float w[NU][3][NI][4];
  const float* rk_d = rk + static_cast<size_t>(d) * U * K;
#pragma unroll
  for (int v = 0; v < NU; ++v)
#pragma unroll
    for (int gt = 0; gt < 3; ++gt)
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = 4 * (S * i + lane) + q;
          w[v][gt][i][q] =
              live && k < U
                  ? rk_d[static_cast<size_t>(ubase + v) * K + gt * U + k]
                  : 0.0f;
        }

  float* dflat = &dbuf[0][0][0][0];
  for (int i = threadIdx.x; i < 2 * BT * 3 * KP; i += blockDim.x)
    dflat[i] = 0.0f;
  const uint32_t d_local =
      static_cast<uint32_t>(__cvta_generic_to_shared(dflat));
  uint32_t peer[kMaxCluster];  // dbuf of each CTA of the cluster
#pragma unroll
  for (int p = 0; p < kMaxCluster; ++p)
    peer[p] = p < cluster ? map_rank(d_local, p) : 0u;

  // partial sums are ordered e = b NU + v, so lane l finishes entries
  // [l R, (l + 1) R): units u0 .. u0 + R of row sb of the tile
  const int sb = lane * R / NU;
  const int u0 = ubase + lane * R % NU;
  const bool ok = live && sb < rows;
  const size_t bstride = static_cast<size_t>(batch);
  auto row_of = [&](int s) {  // x_proj / workspace row of step s
    const int t = d == 0 ? steps - 1 - s : s;
    return (static_cast<size_t>(d) * steps + t) * bstride + b0 + sb;
  };
  auto fetch = [&](Raw<R>& raw, int s) {
    if (!ok || s >= steps) return;
    const size_t row = row_of(s);
#pragma unroll
    for (int gt = 0; gt < 3; ++gt) {
      load_run<R>(xp + row * K + gt * U + u0, raw.x[gt]);
      load_run<R>(hp_dhp + row * K + gt * U + u0, raw.h[gt]);
    }
    load_run<R>(g + row * U + u0, raw.g);
    if (s + 1 < steps) {
      load_run<R>(hs + (d == 0 ? row - bstride : row + bstride) * U + u0,
                  raw.h_prev);
    } else {  // the scan start
#pragma unroll
      for (int j = 0; j < R; ++j) raw.h_prev[j] = 0.0f;
    }
  };

  Raw<R> raw = {};
  Coef<R> cf;
  fetch(raw, 0);
  coefficients(raw, cf);
  fetch(raw, 1);
  float carry[R], bsum[3][R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    carry[j] = 0.0f;
    bsum[0][j] = bsum[1][j] = bsum[2][j] = 0.0f;
  }
  // every CTA's dbuf is zero before any peer writes into it
  cluster_arrive();
  cluster_wait();

  for (int s = 0; s < steps; ++s) {
    const bool exchange = s + 1 < steps;
    const int buf = s & 1;
    float dh[R], zdh[R];
    float dx[3][R], dhp[3][R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      dh[j] = carry[j] + cf.g[j];
      zdh[j] = dh[j] * cf.z[j];
      dx[0][j] = dhp[0][j] = dh[j] * cf.az[j];
      dx[1][j] = dhp[1][j] = dh[j] * cf.ar[j];
      dx[2][j] = dh[j] * cf.ah[j];
      dhp[2][j] = dh[j] * cf.ahr[j];
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) bsum[gt][j] += dhp[gt][j];
    }
    if (ok && exchange) {
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) {
        const uint32_t off = static_cast<uint32_t>(
            (((buf * BT + sb) * 3 + gt) * KP + u0) * sizeof(float));
#pragma unroll
        for (int p = 0; p < kMaxCluster; ++p)
          if (p < cluster) st_cluster_run<R>(peer[p] + off, dhp[gt]);
      }
    }
    if (exchange) cluster_arrive();
    // after the arrive: its release orders the exchange, not these stores
    if (ok) {
      const size_t row = row_of(s);
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) {
        store_run<R>(dxp + row * K + gt * U + u0, dx[gt]);
        store_run<R>(hp_dhp + row * K + gt * U + u0, dhp[gt]);
      }
    }
    if (!exchange) break;
    // while peers arrive: the next step's coefficients from what was
    // loaded a step ago, and the loads for the step after
    coefficients(raw, cf);
    fetch(raw, s + 2);
    cluster_wait();

    // dh_prev partials: the full dhp rows against this lane's Rk slice
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.0f;
    const float* cur = dflat + buf * BT * 3 * KP;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int k0 = 4 * (S * i + lane);
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) {
        float4 d4[BT];
#pragma unroll
        for (int b = 0; b < BT; ++b)
          d4[b] = *reinterpret_cast<const float4*>(cur + (b * 3 + gt) * KP +
                                                   k0);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int b = 0; b < BT; ++b) {
            const float dv = q == 0 ? d4[b].x : q == 1 ? d4[b].y
                           : q == 2 ? d4[b].z : d4[b].w;
#pragma unroll
            for (int v = 0; v < NU; ++v)
              acc[b * NU + v] = fmaf(dv, w[v][gt][i][q], acc[b * NU + v]);
          }
        }
      }
    }
    reduce_scatter<S / 2, E / 2, E>(acc, lane);
#pragma unroll
    for (int j = 0; j < R; ++j) carry[j] = zdh[j] + acc[j];
  }
  // the lanes of a group that hold the same units differ in their row bits
#pragma unroll
  for (int gt = 0; gt < 3; ++gt)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float v = ok ? bsum[gt][j] : 0.0f;
#pragma unroll
      for (int m = NU / R; m < S; m *= 2) v += __shfl_xor_sync(0xffffffffu, v, m);
      bsum[gt][j] = v;
    }
  if (live && lane < NU / R) {
    float* out = dbias + (static_cast<size_t>(d) * gridDim.x / cluster +
                          blockIdx.x / cluster) * K;
#pragma unroll
    for (int gt = 0; gt < 3; ++gt) store_run<R>(out + gt * U + u0, bsum[gt]);
  }
}

// Rk^T for the streamed recurrence: rkt[d][j][u] = rk[d][u][j]
__global__ void gru_bwd_transpose_kernel(const float* __restrict__ rk,
                                         float* __restrict__ rkt, int n_dirs,
                                         int units) {
  const int U = units, K = 3 * units;
  const size_t n = static_cast<size_t>(n_dirs) * U * K;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t d = i / (static_cast<size_t>(U) * K);
    const size_t r = i % (static_cast<size_t>(U) * K);
    const size_t j = r / U, u = r % U;  // output order: coalesced writes
    rkt[i] = rk[(d * U + u) * K + j];
  }
}

// Pass 2, streamed; grid (tiles * C, D), clusters of C CTAs along x. As
// gru_bwd_rec_kernel: hp_dhp holds hp on entry and dhp on exit, dbias
// [D, tiles, 3U] gets each tile's dhp summed over T (in step order) and its
// rows (in row order); carry [D, B, U] is scratch. The block is KS groups
// of UW threads (stream_split): group 0's thread l forms the states of CTA
// unit base + l, and in the product thread (ks, l) takes the ks-th of KS
// slices of each staged chunk of j; groups 1 .. KS-1 leave their partial
// sums in shared memory and group 0 adds them in group order.
template <typename T>
__global__ void __launch_bounds__(kStreamThreads)
gru_bwd_stream_kernel(const T* __restrict__ xp, const float* __restrict__ rkt,
                      const T* __restrict__ hs, const T* __restrict__ g,
                      T* __restrict__ dxp, float* __restrict__ hp_dhp,
                      float* __restrict__ dbias, float* __restrict__ carry,
                      int steps, int batch, int units, int cluster,
                      int splits) {
  constexpr int BT = kStreamBT, KC = kStreamChunk;
  __shared__ __align__(16) float d_s[BT][KC];
  __shared__ float part[kStreamPartials];  // [KS - 1][BT][UW]
  const int U = units;
  const int K = 3 * units;
  const int uc = units / cluster;
  const int uw = blockDim.x / splits;
  const int ks = threadIdx.x / uw, lane = threadIdx.x % uw;
  const int jslice = KC / splits;          // a multiple of 4
  const int rank = static_cast<int>(cluster_ctarank());
  const int d = blockIdx.y;
  const int tile = blockIdx.x / cluster;
  const int b0 = tile * BT;
  const int rows = min(BT, batch - b0);
  const float* rkt_d = rkt + static_cast<size_t>(d) * K * U;
  float* db = dbias + (static_cast<size_t>(d) * (gridDim.x / cluster) + tile) * K;
  float* cr = carry + (static_cast<size_t>(d) * batch + b0) * U;
  const size_t bstride = static_cast<size_t>(batch);

  for (int s = 0; s < steps; ++s) {
    const int t = d == 0 ? steps - 1 - s : s;
    const size_t row0 = (static_cast<size_t>(d) * steps + t) * bstride + b0;
    // this step's states: dh, dx_proj, dhp, the carry's dh z and dRb's sums
    for (int base = 0; ks == 0 && base < uc; base += uw) {
      const int uu = base + lane;
      if (uu >= uc) continue;
      const int u = rank * uc + uu;
      float bs[3];
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) bs[gt] = s > 0 ? db[gt * U + u] : 0.0f;
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        if (b >= rows) break;
        const size_t row = row0 + b;
        float x[3], h[3];
#pragma unroll
        for (int gt = 0; gt < 3; ++gt) {
          x[gt] = to_f32(xp[row * K + gt * U + u]);
          h[gt] = hp_dhp[row * K + gt * U + u];
        }
        const float h_prev =
            s + 1 < steps
                ? to_f32(hs[(d == 0 ? row - bstride : row + bstride) * U + u])
                : 0.0f;
        const float z = sigmoid(x[0] + h[0]);
        const float r = sigmoid(x[1] + h[1]);
        const float c = tanh_fast(x[2] + r * h[2]);
        const float ah = (1.0f - z) * (1.0f - c * c);
        const float dh = (s > 0 ? cr[b * U + u] : 0.0f) +
                         to_f32(g[row * U + u]);
        const float dz = dh * (h_prev - c) * z * (1.0f - z);
        const float dr = dh * ah * h[2] * r * (1.0f - r);
        const float dhh = dh * ah;
        const float dhp[3] = {dz, dr, dhh * r};
        const float dx[3] = {dz, dr, dhh};
#pragma unroll
        for (int gt = 0; gt < 3; ++gt) {
          const float one[1] = {dx[gt]};
          store_run<1>(dxp + row * K + gt * U + u, one);
          hp_dhp[row * K + gt * U + u] = dhp[gt];
          bs[gt] += dhp[gt];
        }
        cr[b * U + u] = dh * z;
      }
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) db[gt * U + u] = bs[gt];
    }
    if (s + 1 == steps) break;
    // every CTA's dhp of this step is written before any CTA reads it
    cluster_arrive();
    cluster_wait();
    // carry += dhp @ Rk^T for this CTA's units
    for (int base = 0; base < uc; base += uw) {
      const int uu = base + lane;
      const bool live = uu < uc;
      const int u = rank * uc + (live ? uu : 0);
      float acc[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[b] = 0.0f;
      // the next step's rows into L2 while the product runs (x_proj, hp,
      // g, h_prev): each group asks for its share of the rows
      const int tn = d == 0 ? t - 1 : t + 1;
      const size_t next0 = (static_cast<size_t>(d) * steps + tn) * bstride + b0;
      for (int b = ks; live && b < rows; b += splits) {
        const size_t row = next0 + b;
#pragma unroll
        for (int gt = 0; gt < 3; ++gt) {
          prefetch_l2(xp + row * K + gt * U + u);
          prefetch_l2(hp_dhp + row * K + gt * U + u);
        }
        prefetch_l2(g + row * U + u);
        if (s + 2 < steps)
          prefetch_l2(hs + (d == 0 ? row - bstride : row + bstride) * U + u);
      }
      for (int j0 = 0; j0 < K; j0 += KC) {
        __syncthreads();                 // the previous chunk is consumed
        for (int i = threadIdx.x; i < BT * KC; i += blockDim.x) {
          const int b = i / KC, j = i % KC;
          d_s[b][j] = b < rows && j0 + j < K
                          ? __ldcg(hp_dhp + (row0 + b) * K + j0 + j)
                          : 0.0f;
        }
        __syncthreads();
        const int j_lo = ks * jslice;
        const int j_hi = min(j_lo + jslice, K - j0);
        if (!live || j_lo >= j_hi) continue;
        const float* col = rkt_d + static_cast<size_t>(j0) * U + u;
        float w[4], wn[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          w[q] = __ldg(col + static_cast<size_t>(j_lo + q) * U);
        for (int j = j_lo; j < j_hi; j += 4) {
          const bool more = j + 4 < j_hi;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            wn[q] = more ? __ldg(col + static_cast<size_t>(j + 4 + q) * U)
                         : 0.0f;
#pragma unroll
          for (int b = 0; b < BT; ++b) {
            const float4 d4 = *reinterpret_cast<const float4*>(&d_s[b][j]);
            acc[b] = fmaf(d4.x, w[0], acc[b]);
            acc[b] = fmaf(d4.y, w[1], acc[b]);
            acc[b] = fmaf(d4.z, w[2], acc[b]);
            acc[b] = fmaf(d4.w, w[3], acc[b]);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) w[q] = wn[q];
        }
      }
      if (ks > 0) {
#pragma unroll
        for (int b = 0; b < BT; ++b)
          part[((ks - 1) * BT + b) * uw + lane] = acc[b];
      }
      __syncthreads();
      if (ks == 0 && live) {
        for (int p = 1; p < splits; ++p)
#pragma unroll
          for (int b = 0; b < BT; ++b)
            acc[b] += part[((p - 1) * BT + b) * uw + lane];
#pragma unroll
        for (int b = 0; b < BT; ++b)
          if (b < rows) cr[b * U + u] += acc[b];
      }
      __syncthreads();                   // part is read before it is reused
    }
  }
}

__device__ __forceinline__ void st_cluster_v4(uint32_t addr, float a, float b,
                                              float c, float d) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// acc[o][b] += sum over q of a[b][q] w[o][q] for the RP rows of a pass: one
// 4-wide k' chunk of this lane; a points at the chunk in the pass's first
// dhp row, the rows `stride` floats apart
template <int NO, int RP>
__device__ __forceinline__ void fma_chunk(float (&acc)[NO][RP],
                                          const float* a, int stride,
                                          const float (&w)[NO][4]) {
  float4 a4[RP];
#pragma unroll
  for (int b = 0; b < RP; ++b)
    a4[b] = *reinterpret_cast<const float4*>(a + b * stride);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int o = 0; o < NO; ++o) {
#pragma unroll
      for (int b = 0; b < RP; ++b) {
        const float aq = q == 0 ? a4[b].x : q == 1 ? a4[b].y
                       : q == 2 ? a4[b].z : a4[b].w;
        acc[o][b] = fmaf(aq, w[o][q], acc[o][b]);
      }
    }
  }
}

// Adds up the partial sums of the S lanes of a group and leaves lane l the
// totals of rows [l RP / S, (l + 1) RP / S) of every output in acc[o][0, ..).
// Round by round (lane bit M from S / 2 down to 1; N rows in each half), a
// lane keeps the half of its rows that its bit selects and adds its
// partner's copy of that half.
template <int M, int N, int NO, int RP>
__device__ __forceinline__ void reduce_rows(float (&acc)[NO][RP], int lane) {
  if constexpr (M >= 1) {
    const bool upper = (lane & M) != 0;
#pragma unroll
    for (int o = 0; o < NO; ++o) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float send = upper ? acc[o][j] : acc[o][j + N];
        const float keep = upper ? acc[o][j + N] : acc[o][j];
        acc[o][j] = keep + __shfl_xor_sync(0xffffffffu, send, M);
      }
    }
    reduce_rows<M / 2, N / 2, NO, RP>(acc, lane);
  }
}

// One state's loads: x_proj's and hp's gates, h_prev and g
struct RawState {
  float x[3], h[3], h_prev, g;
};

// Pass 2, resident; grid (tiles * C, D), clusters of C CTAs along x, blocks
// of 8 ucw threads, dynamic shared memory res_bwd_smem(V, blockDim.x, ucw,
// bt). As gru_bwd_rec_kernel: hp_dhp holds hp on entry and dhp on exit,
// dbias [D, tiles, 3U] gets each tile's dhp summed over T (in step order),
// over a thread's rows (in order) and over the threads of a unit (in
// order). CTA `rank` owns units [rank ucw, rank ucw + ucw) below U:
//   - thread tid finishes the states of unit tid % ucw in rows tid / ucw +
//     8 i: dh = z dh' + (the C CTAs' partial sums, in rank order) + g, then
//     dx_proj and dhp; dhp also into dloc[b][g ucw + unit], the CTA's dhp
//     rows (k' = g ucw + unit);
//   - in the product, lane l of group tid / S holds Rk[u'][g U + rank ucw +
//     unit] for its 4 output units u' (of all C ucw) and its k' chunks, NR
//     in registers and NS in shared memory as w_s[i - NR][o][tid]; a pass of
//     RP rows: the partial sums over the CTA's k', a reduce-scatter over the
//     S lanes, and each lane's rows, 4 units at a time, into the slots of
//     the units' owner: slots[buf][rank][row][unit] (st.shared::cluster.v4);
//   - ONE cluster barrier a step orders the slots (double-buffered); the
//     next step's loads are issued between its arrive and its wait.
template <int C, int S, int NR, int NS, int RP, int NST, int MAXT,
          typename T>
__global__ void __launch_bounds__(MAXT, 1)
gru_bwd_res_kernel(const T* __restrict__ xp, const float* __restrict__ rk,
                   const T* __restrict__ hs, const T* __restrict__ g,
                   T* __restrict__ dxp, float* __restrict__ hp_dhp,
                   float* __restrict__ dbias, int steps, int batch,
                   int units, int ucw, int bt) {
  constexpr int NO = kGroupUnits;
  constexpr int KPB = 4 * S * (NR + NS);  // k' extent of a dhp row
  constexpr int R = RP / S;               // rows a lane finishes a pass
  static_assert(C * S == 32, "8 ucw threads: 8 rows of states at a time");
  static_assert(RP % S == 0, "a pass splits over S lanes");
  extern __shared__ __align__(16) float smem[];
  const int nt = blockDim.x;                          // 8 ucw
  float4* w_s = reinterpret_cast<float4*>(smem);      // [NS][NO][nt]
  float* slots = smem + 4 * NS * NO * nt;             // [2][C][bt][ucw]
  float* dloc = slots + 2 * C * bt * ucw;             // [bt][KPB]

  const int U = units;
  const int K = 3 * units;
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster_ctarank());
  const int uc = max(0, min(ucw, U - rank * ucw));  // units of this CTA
  const int d = blockIdx.y;
  const int tile = blockIdx.x / C;
  const int b0 = tile * bt;
  const int rows = min(bt, batch - b0);
  const int passes = (rows + RP - 1) / RP;

  // the product: group tid / S owns output units uo0 .. uo0 + 3
  const int lane = tid % S;
  const int uo0 = NO * (tid / S);
  const float* rk_d = rk + static_cast<size_t>(d) * U * K;
  auto weight = [&](int i, int q, int o) {
    const int kk = 4 * (S * i + lane) + q;
    const int gt = kk / ucw, uk = kk % ucw;
    return gt < 3 && uk < uc && uo0 + o < U
               ? rk_d[static_cast<size_t>(uo0 + o) * K + gt * U +
                      rank * ucw + uk]
               : 0.0f;
  };
  float w[NR][NO][4];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int o = 0; o < NO; ++o)
#pragma unroll
      for (int q = 0; q < 4; ++q) w[i][o][q] = weight(i, q, o);
  for (int i = 0; i < NS; ++i)
    for (int o = 0; o < NO; ++o)
      w_s[(i * NO + o) * nt + tid] =
          make_float4(weight(NR + i, 0, o), weight(NR + i, 1, o),
                      weight(NR + i, 2, o), weight(NR + i, 3, o));
  for (int i = tid; i < bt * KPB; i += nt) dloc[i] = 0.0f;
  const uint32_t slots_local =
      static_cast<uint32_t>(__cvta_generic_to_shared(slots));
  // where this group's sums go: the owner of its units, their first unit
  const int owner = uo0 / ucw, oslot = uo0 % ucw;
  const bool sends = uo0 < U;

  // the states: unit uu of rows brow + 8 i
  const int uu = tid % ucw, brow = tid / ucw;
  const int u = rank * ucw + uu;
  const bool live = uu < uc;
  const size_t bstride = static_cast<size_t>(batch);
  auto row_of = [&](int s, int b) {  // x_proj / workspace row of step s
    const int t = d == 0 ? steps - 1 - s : s;
    return (static_cast<size_t>(d) * steps + t) * bstride + b0 + b;
  };
  RawState raw[NST];
  auto fetch = [&](int s) {
#pragma unroll
    for (int i = 0; i < NST; ++i) {
      const int b = brow + 8 * i;
      if (!live || b >= rows) continue;
      const size_t row = row_of(s, b);
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) {
        raw[i].x[gt] = to_f32(xp[row * K + gt * U + u]);
        raw[i].h[gt] = hp_dhp[row * K + gt * U + u];
      }
      raw[i].g = to_f32(g[row * U + u]);
      raw[i].h_prev =
          s + 1 < steps
              ? to_f32(hs[(d == 0 ? row - bstride : row + bstride) * U + u])
              : 0.0f;  // the scan start
    }
  };
  float zdh[NST], bsum[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < NST; ++i) zdh[i] = 0.0f;
  fetch(0);
  // every CTA's dloc is zero, and every CTA runs, before any slot is written
  cluster_arrive();
  cluster_wait();

  for (int s = 0; s < steps; ++s) {
    // this step's states, from the previous step's slots
    const float* in = slots + ((s + 1) & 1) * C * bt * ucw;
#pragma unroll
    for (int i = 0; i < NST; ++i) {
      const int b = brow + 8 * i;
      if (b >= bt) break;
      const bool ok = live && b < rows;
      float dhp[3] = {0.0f, 0.0f, 0.0f};
      if (ok) {
        float sum = 0.0f;
        for (int c = 0; s > 0 && c < C; ++c) sum += in[(c * bt + b) * ucw + uu];
        const RawState& w8 = raw[i];
        const float z = sigmoid(w8.x[0] + w8.h[0]);
        const float r = sigmoid(w8.x[1] + w8.h[1]);
        const float hh = w8.h[2];
        const float c = tanh_fast(w8.x[2] + r * hh);
        const float ah = (1.0f - z) * (1.0f - c * c);
        const float az = (w8.h_prev - c) * z * (1.0f - z);
        const float ar = ah * hh * r * (1.0f - r);
        const float dh = (zdh[i] + sum) + w8.g;
        const float dx[3] = {dh * az, dh * ar, dh * ah};
        dhp[0] = dx[0];
        dhp[1] = dx[1];
        dhp[2] = dh * (ah * r);
        zdh[i] = dh * z;
        const size_t row = row_of(s, b);
#pragma unroll
        for (int gt = 0; gt < 3; ++gt) {
          const float one[1] = {dx[gt]};
          store_run<1>(dxp + row * K + gt * U + u, one);
          hp_dhp[row * K + gt * U + u] = dhp[gt];
          bsum[gt] += dhp[gt];
        }
      }
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) dloc[b * KPB + gt * ucw + uu] = dhp[gt];
    }
    __syncthreads();  // dloc holds this step's dhp
    if (s + 1 == steps) break;
    const int buf = s & 1;
    for (int p = 0; p < passes; ++p) {
      float acc[NO][RP];
#pragma unroll
      for (int o = 0; o < NO; ++o)
#pragma unroll
        for (int b = 0; b < RP; ++b) acc[o][b] = 0.0f;
      const float* arow = dloc + p * RP * KPB;
#pragma unroll
      for (int i = 0; i < NR; ++i)
        fma_chunk<NO, RP>(acc, arow + 4 * (S * i + lane), KPB, w[i]);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        float ws[NO][4];
#pragma unroll
        for (int o = 0; o < NO; ++o) {
          const float4 f = w_s[(i * NO + o) * nt + tid];
          ws[o][0] = f.x;
          ws[o][1] = f.y;
          ws[o][2] = f.z;
          ws[o][3] = f.w;
        }
        fma_chunk<NO, RP>(acc, arow + 4 * (S * (NR + i) + lane), KPB, ws);
      }
      reduce_rows<S / 2, RP / 2, NO, RP>(acc, lane);
      if (sends) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int row = p * RP + lane * R + j;
          const uint32_t off = static_cast<uint32_t>(
              (((buf * C + rank) * bt + row) * ucw + oslot) * sizeof(float));
          st_cluster_v4(map_rank(slots_local + off, owner), acc[0][j],
                        acc[1][j], acc[2][j], acc[3][j]);
        }
      }
    }
    cluster_arrive();
    fetch(s + 1);  // the next step's loads while peers arrive
    cluster_wait();
  }
  // this tile's dRb: each thread's sums, then the 8 threads of a unit in
  // order (dloc is free: the last step runs no product)
  float* part = dloc;  // [8][3][ucw]
#pragma unroll
  for (int gt = 0; gt < 3; ++gt) part[(brow * 3 + gt) * ucw + uu] = bsum[gt];
  __syncthreads();
  if (brow == 0 && live) {
    float* out = dbias + (static_cast<size_t>(d) * (gridDim.x / C) + tile) * K;
#pragma unroll
    for (int gt = 0; gt < 3; ++gt) {
      float sum = 0.0f;
      for (int m = 0; m < 8; ++m) sum += part[(m * 3 + gt) * ucw + uu];
      out[gt * U + u] = sum;
    }
  }
}

// Passes 1 and 3 on the tensor cores (tc_pass; the kernels
// gru_bwd_hp_tc_kernel and gru_bwd_drk_tc_kernel): C[M, N] = sum_k A[m, k]
// B[k, n] over
// 128 x 128 output tiles, each CTA walking tiles blockIdx.x, + gridDim.x,
// ... (persistent: the producer loads the next tile's first chunks while
// the consumers store the last one's). MODE 0 is pass 1, hp = h_prev @ Rk
// + rb (A = h_prev rows [N, U], B = Rk [U, 3U]); MODE 1 is pass 3, the
// partial dRk of a slice of rows, h_prev^T @ dhp (A = h_prev^T [U, rows],
// B = dhp [rows, 3U]). Per 32-deep chunk of K:
//   - warp 8 (the producer) loads A's and B's raw tiles by TMA into a ring
//     of kTcStages stages (full / empty mbarriers); h_prev's shift by one
//     scan step is the row coordinate of the box (n - B for direction 0,
//     n + B for 1) and the scan start's zero row is TMA's out-of-bounds
//     fill;
//   - the two consumer warpgroups split each raw f32 value into bf16 parts
//     (tc::split; a bf16 value is one part) and write them as K-major
//     operand tiles (csrc/tc.cuh), double-buffered, then multiply: warp-
//     group w takes rows [64 w, 64 w + 64) of the tile, m64n128k16 wgmma
//     over the part pairs (a, b) with a + b < 3, smallest first, into a
//     fresh accumulator that is then added to the tile's sum in f32 with
//     round-to-nearest (the tensor cores' own additions truncate, so each
//     chunk's partial sum is added once, in the f32 pipe);
//   - the converting of chunk i + 1 runs while chunk i's wgmmas do.
// Accuracy: three bf16 parts hold an f32 exactly (each part rounds what the
// earlier ones leave: 8 bits of it); the pairs dropped (a + b >= 3) add up
// to at most 3 x 2^-24 of each product; so either pass is an f32 product
// up to summation order, and a pass whose operands are both bf16 (hp on the
// bf16 training path, Rk handed over in bf16) is one product exact up to
// summation order. Cost: 1, 3 or 6 products (bf16 x bf16, one side f32,
// both f32) at 989 TFLOP/s.
constexpr int kTcRows = 128;       // output tile rows (M) and columns (N)
constexpr int kTcConsumers = 256;  // two warpgroups
constexpr int kTcThreads = kTcConsumers + 32;
constexpr int kTcSms = 132;        // H100 SXM: one persistent CTA a SM
constexpr int kTcSlice = 64;       // a slice of pass 3: whole 64-row chunks

template <typename T>
struct Parts {
  static constexpr int n = 3;
};
template <>
struct Parts<__nv_bfloat16> {
  static constexpr int n = 1;
};

// A pass's chunk depth and ring: 64-deep chunks where A is bf16 (hs in
// bf16 storage: its raw rows are 128 bytes, one TMA box with the 128-byte
// swizzle) in a ring of 3 stages, or of 2 where a side is f32 (so that two
// double-buffered operand sets fit); 32-deep chunks (f32 rows of 128 bytes)
// in a ring of 3 where A is f32.
template <typename TA, typename TB>
struct TcShape {
  static constexpr int k = sizeof(TA) == 2 ? 64 : 32;
  static constexpr int stages = k == 64 && sizeof(TB) == 4 ? 2 : 3;
  static constexpr int tile = tc::tile_bytes<k>(kTcRows);  // an operand
  static constexpr uint32_t sbo = tc::sbo<k>;              // tile, its groups
  static constexpr int raw_a = kTcRows * k * static_cast<int>(sizeof(TA));
  static constexpr int ring = kTcRows * k *
                              static_cast<int>(sizeof(TA) + sizeof(TB));
  static constexpr int operand = (Parts<TA>::n + Parts<TB>::n) * tile;
  // dynamic shared memory: the 1024-byte alignment slack, two operand
  // buffers, the ring and its barriers
  static constexpr size_t smem = 1024 + 2 * operand + stages * ring +
                                 2 * stages * 8;
};
static_assert(TcShape<__nv_bfloat16, float>::smem <= 232448 &&
                  TcShape<float, float>::smem <= 232448,
              "a tensor-core pass needs more shared memory than a block has");

struct TcTile {
  int d, sl, m0, j0, k0, nk;
};

// tile `tile` of MODE's grid: j tiles fastest, then m tiles, then
// (direction, slice); nk chunks of depth K
template <int MODE, int K>
__device__ __forceinline__ TcTile tc_tile(int tile, int n_dirs, int N, int U,
                                          int rows_per_slice) {
  const int nj = (3 * U + kTcRows - 1) / kTcRows;
  const int nm = ((MODE == 0 ? N : U) + kTcRows - 1) / kTcRows;
  TcTile t;
  t.j0 = tile % nj * kTcRows;
  int rest = tile / nj;
  t.m0 = rest % nm * kTcRows;
  rest /= nm;
  if (MODE == 0) {
    t.d = rest;
    t.sl = 0;
    t.k0 = 0;
    t.nk = (U + K - 1) / K;
  } else {
    t.d = rest % n_dirs;
    t.sl = rest / n_dirs;
    t.k0 = t.sl * rows_per_slice;
    const int end = min(N, t.k0 + rows_per_slice);
    t.nk = end > t.k0 ? (end - t.k0 + K - 1) / K : 0;
  }
  return t;
}

__device__ __forceinline__ void store8(uint8_t* dst,
                                       const __nv_bfloat16 (&h)[8]) {
  using tc::pack2;
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack2(h[0], h[1]), pack2(h[2], h[3]), pack2(h[4], h[5]),
                 pack2(h[6], h[7]));
}

// 8 consecutive K values of row r, split into P parts, into the P operand
// tiles (of depth K) at `tiles`
template <int P, int K>
__device__ __forceinline__ void put8(uint8_t* tiles, int r, int kc,
                                     const float (&v)[8]) {
  __nv_bfloat16 h[P][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    __nv_bfloat16 p[P];
    tc::split<P>(v[i], p);
#pragma unroll
    for (int q = 0; q < P; ++q) h[q][i] = p[q];
  }
#pragma unroll
  for (int q = 0; q < P; ++q)
    store8(tiles + q * tc::tile_bytes<K>(kTcRows) +
               tc::tile_offset<K>(r, 8 * kc),
           h[q]);
}

// A raw tile [kTcRows rows][K values], K innermost: rows of 128 bytes (K =
// 32 f32 or 64 bf16) as TMA's 128-byte swizzle left them (16-byte chunk c
// of row r at c ^ (r % 8)), into the operand tiles. A task is 8 values of
// a row; the 8 lanes that share a store write one row group's 128 bytes.
template <typename T, int K>
__device__ __forceinline__ void convert_rows(const uint8_t* raw, uint8_t* tiles,
                                             int tid) {
  constexpr int P = Parts<T>::n, C = K / 8;  // 8-value chunks a row
#pragma unroll
  for (int rep = 0; rep < kTcRows * C / kTcConsumers; ++rep) {
    const int q = tid + kTcConsumers * rep;
    const int r = q / (8 * C) * 8 + q % 8, kc = q / 8 % C;
    const uint8_t* row = raw + r * 128;
    if constexpr (P == 1) {
      const uint4 x =
          *reinterpret_cast<const uint4*>(row + ((kc ^ (r & 7)) << 4));
      *reinterpret_cast<uint4*>(tiles + tc::tile_offset<K>(r, 8 * kc)) = x;
    } else {
      const float4 x0 = *reinterpret_cast<const float4*>(
          row + (((2 * kc) ^ (r & 7)) << 4));
      const float4 x1 = *reinterpret_cast<const float4*>(
          row + (((2 * kc + 1) ^ (r & 7)) << 4));
      const float v[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      put8<P, K>(tiles, r, kc, v);
    }
  }
}

// A raw tile [K values][kTcRows rows], rows innermost (unswizzled), into
// the operand tiles: a lane takes one row, a warp reads 32 consecutive rows
template <typename T, int K>
__device__ __forceinline__ void convert_cols(const uint8_t* raw_bytes,
                                             uint8_t* tiles, int tid) {
  constexpr int P = Parts<T>::n;
  const T* raw = reinterpret_cast<const T*>(raw_bytes);
#pragma unroll
  for (int rep = 0; rep < kTcRows * K / 8 / kTcConsumers; ++rep) {
    const int q = tid + kTcConsumers * rep;
    const int r = q % kTcRows, kc = q / kTcRows;
    if constexpr (P == 1) {
      __nv_bfloat16 h[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) h[i] = raw[(8 * kc + i) * kTcRows + r];
      store8(tiles + tc::tile_offset<K>(r, 8 * kc), h);
    } else {
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = to_f32(raw[(8 * kc + i) * kTcRows + r]);
      put8<P, K>(tiles, r, kc, v);
    }
  }
}

template <int MODE, typename TA, typename TB>
__device__ __forceinline__ void tc_pass(const CUtensorMap& map_a,
                                        const CUtensorMap& map_b,
                                        const float* __restrict__ rb,
                                        float* __restrict__ out, int n_dirs,
                                        int steps, int batch, int units,
                                        int slices, int rows_per_slice) {
  using S = TcShape<TA, TB>;
  constexpr int PA = Parts<TA>::n, PB = Parts<TB>::n;
  constexpr int P = PA > PB ? PA : PB;
  constexpr int K = S::k, kStages = S::stages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ob = tc::align_1024(smem_raw);  // [2][PA + PB][S::tile]
  uint8_t* ring = ob + 2 * S::operand;     // [kStages][A raw, B raw]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * S::ring);
  uint64_t* empty = full + kStages;

  const int U = units, K3 = 3 * units, N = steps * batch;
  const int nj = (K3 + kTcRows - 1) / kTcRows;
  const int nm = ((MODE == 0 ? N : U) + kTcRows - 1) / kTcRows;
  const int n_tiles = nj * nm * n_dirs * (MODE == 0 ? 1 : slices);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], kTcConsumers);
    }
    tc::fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kTcConsumers) {  // the producer warp: one lane issues
    if (tid == kTcConsumers) {
      int g = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const TcTile t =
            tc_tile<MODE, K>(tile, n_dirs, N, U, rows_per_slice);
        const int shift = t.d == 0 ? -batch : batch;  // h_prev's row
        for (int i = 0; i < t.nk; ++i, ++g) {
          const int s = g % kStages;
          tc::mbar_wait(&empty[s], ((g / kStages) & 1) ^ 1);
          tc::mbar_expect_tx(&full[s], S::ring);
          uint8_t* raw = ring + s * S::ring;
          if (MODE == 0) {
            tc::tma_load_3d(raw, &map_a, &full[s], K * i, t.m0 + shift, t.d);
            tc::tma_load_3d(raw + S::raw_a, &map_b, &full[s], t.j0, K * i,
                            t.d);
          } else {
            const int row = t.k0 + K * i;
            tc::tma_load_3d(raw, &map_a, &full[s], t.m0, row + shift, t.d);
            tc::tma_load_3d(raw + S::raw_a, &map_b, &full[s], t.j0, row,
                            t.d);
          }
        }
      }
    }
    return;
  }

  const int wg = tid / 128, lane = tid % 32, warp = tid % 128 / 32;
  int g = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const TcTile t = tc_tile<MODE, K>(tile, n_dirs, N, U, rows_per_slice);
    float acc[64], part[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
    // chunk i of this tile: raw stage -> operand buffer i & 1
    auto load = [&](int i) {
      const int s = (g + i) % kStages;
      tc::mbar_wait(&full[s], ((g + i) / kStages) & 1);
      const uint8_t* raw = ring + s * S::ring;
      uint8_t* o = ob + (i & 1) * S::operand;
      if (MODE == 0)
        convert_rows<TA, K>(raw, o, tid);
      else
        convert_cols<TA, K>(raw, o, tid);
      convert_cols<TB, K>(raw + S::raw_a, o + PA * S::tile, tid);
      tc::mbar_arrive(&empty[s]);
      tc::fence_proxy_async();
    };
    if (t.nk > 0) {
      load(0);
      tc::named_sync(1, kTcConsumers);
    }
    for (int i = 0; i < t.nk; ++i) {
      const uint32_t o = tc::smem_u32(ob + (i & 1) * S::operand);
      const uint32_t a0 = o + wg * (64 / 8) * S::sbo;
      const uint32_t b0 = o + PA * S::tile;
      tc::wgmma_fence();
      int accumulate = 0;  // the chunk's first product overwrites `part`
#pragma unroll
      for (int kk = 0; kk < K / 16; ++kk) {
#pragma unroll
        for (int sum = P - 1; sum >= 0; --sum) {
#pragma unroll
          for (int a = 0; a <= sum; ++a) {
            const int b = sum - a;
            if (a >= PA || b >= PB) continue;
            tc::wgmma_n128(
                part,
                tc::desc(a0 + a * S::tile + kk * 2 * tc::kLbo, S::sbo),
                tc::desc(b0 + b * S::tile + kk * 2 * tc::kLbo, S::sbo),
                accumulate);
            accumulate = 1;
          }
        }
      }
      tc::wgmma_commit();
      if (i + 1 < t.nk) load(i + 1);
      tc::wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] += part[e];
      tc::named_sync(1, kTcConsumers);
    }
    g += t.nk;

    // the accumulator fragment: n8 block i, rows 16 warp + lane / 4 (+ 8),
    // columns 8 i + 2 (lane % 4) (+ 1)
    const int row0 = t.m0 + 64 * wg + 16 * warp + lane / 4;
    const int limit = MODE == 0 ? N : U;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = t.j0 + 8 * i + 2 * (lane % 4);
      if (col >= K3) continue;  // K3 is even: col + 1 < K3 too
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= limit) continue;
        float2 v = make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
        size_t at;
        if (MODE == 0) {
          const float* bias = rb + static_cast<size_t>(t.d) * K3 + col;
          v.x += bias[0];
          v.y += bias[1];
          at = (static_cast<size_t>(t.d) * N + row) * K3 + col;
        } else {
          at = ((static_cast<size_t>(t.sl) * n_dirs + t.d) * U + row) * K3 +
               col;
        }
        *reinterpret_cast<float2*>(out + at) = v;
      }
    }
  }
}

// pass 1 (hp) and pass 3 (dRk's slice partials) on the tensor cores: the
// two modes of tc_pass, named apart for the profiler
template <typename TA, typename TB>
__global__ void __launch_bounds__(kTcThreads, 1)
gru_bwd_hp_tc_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const float* __restrict__ rb, float* __restrict__ out,
                     int n_dirs, int steps, int batch, int units, int slices,
                     int rows_per_slice) {
  tc_pass<0, TA, TB>(map_a, map_b, rb, out, n_dirs, steps, batch, units,
                     slices, rows_per_slice);
}
template <typename TA, typename TB>
__global__ void __launch_bounds__(kTcThreads, 1)
gru_bwd_drk_tc_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b,
                      const float* __restrict__ rb, float* __restrict__ out,
                      int n_dirs, int steps, int batch, int units, int slices,
                      int rows_per_slice) {
  tc_pass<1, TA, TB>(map_a, map_b, rb, out, n_dirs, steps, batch, units,
                     slices, rows_per_slice);
}

// The grid-resident recurrence (past U = 512, Rk in bf16), between the
// tensor-core passes 1 and 3. Each step's product is dh_prev[:, u] =
// dh z + sum over the 3U columns k of dhp[:, k] Rk[u, k]. Groups of
// kGridSplit CTAs: group (d, q) owns units [64 q, 64 q + 64) and its CTA r
// the K range [r Kq, r Kq + Kq), Kq = 3U / kGridSplit, holding
// Rk[d][64 q + m][r Kq + k] (96 KB at U = 1024) in shared memory for all T
// steps; D U / 16 CTAs (128 at U = 1024, D = 2), launched cooperatively. A
// step (scan positions T - 1 down to 0):
//   - the gates: thread (unit j = tid % 64, rows of block tid / 64 of the
//     CTA's Bp / kGridSplit rows) forms dh = carry + g, dx_proj and dhp of
//     its states from x_proj, hp (pass 1) and h_prev, writes dhp over hp
//     (for pass 3) and, as three bf16 parts, into exchange slot p % 2 in
//     the wgmma operand layout; the CTA adds 1 to its direction's counter;
//   - the product: once every CTA of the direction has published, warp 8
//     streams dhp's parts of the CTA's K range (TMA bulk copies, a ring of
//     `stages`) and the two consumer warpgroups form the partial sums
//     P[m, b] = sum over the range of Rk[m, k] dhp[b, k] (wgmma, M = the 64
//     units, N = 64 batch rows at a time: A = the Rk tile, B = the dhp
//     chunk, K-major both; warpgroup w the batch half [w Bp / 2, ...)),
//     each chunk's partial sum added in f32;
//   - the sum over the group: each CTA writes its partial sums to slot
//     p % 2 of the group's buffer in L2 and adds 1 to the group's counter;
//     once all kGridSplit have, the owner of each row (rank b / (Bp / 4))
//     adds the kGridSplit partial sums in rank order: carry = dh z + that.
// (Thread block clusters would sum through distributed shared memory, but
// the H100 holds only 30 one-CTA-a-SM clusters of 4, 120 CTAs, short of the
// 128 at U = 1024.) dRb's sums stay in registers (3 a thread) and go to
// kGridTiles per-tile sums at the end, which gru_bwd_finalize_kernel adds
// in order. Nothing is added in an order that depends on scheduling.
// What bounds it: every CTA reads a quarter of dhp's three parts each step
// (3 B 3U / 4 x 2 bytes: 1.1 MB at U = 1024, B = 256), 144 MB a step from
// L2 over the card; the products are 2 x 3 B 64 Kq operations a CTA.
constexpr int kGridSplit = 4;     // CTAs of a group: the K ranges
constexpr int kGridUnits = 64;    // units of a group: the wgmma M
constexpr int kGridConsumers = 256;
constexpr int kGridThreads = kGridConsumers + 32;
constexpr int kGridParts = 3;     // bf16 parts of dhp: f32 whole
constexpr int kGridTiles = 16;    // dRb's per-tile sums: (rank, row block)
constexpr int kGridRows = 256;    // the most batch rows
constexpr int kGridN = 64;        // batch rows a wgmma (N)

template <int N>
__device__ __forceinline__ void wgmma_nb(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 64)
    tc::wgmma_n64(d, da, db, accumulate);
  else
    tc::wgmma_n32(d, da, db, accumulate);
}

// NB = Bp / 2, a warpgroup's batch rows. xb: [2 slots][D][3 parts]
// [3U / 32 chunks][Bp x 32 tile] bf16; part: [2 slots][D][U / 64 groups]
// [kGridSplit][Bp][64] f32; counter: [D] steps, then [D][groups] group
// sums, zero at launch.
template <typename T, int NB>
__global__ void __launch_bounds__(kGridThreads, 1)
gru_bwd_grid_kernel(const T* __restrict__ xp,
                    const __nv_bfloat16* __restrict__ rk,
                    const T* __restrict__ hs, const T* __restrict__ g,
                    T* __restrict__ dxp, float* __restrict__ hp_dhp,
                    float* __restrict__ dbias, __nv_bfloat16* __restrict__ xb,
                    float* __restrict__ psum, uint32_t* __restrict__ counter,
                    int n_dirs, int T_steps, int B, int U, int stages) {
  constexpr int Bp = 2 * NB, RB = Bp / kGridSplit;  // rows a rank owns
  constexpr int kRows = RB / 4;                     // ... a thread
  constexpr int P = kGridParts;
  constexpr int NS = NB < kGridN ? NB : kGridN;     // rows a wgmma
  constexpr int kSub = NB / NS;
  extern __shared__ uint8_t smem_raw[];
  const int K3 = 3 * U, N = T_steps * B, nch = K3 / tc::kK;
  const int nq = nch / kGridSplit;            // K chunks a CTA
  const int groups = U / kGridUnits;
  const int group = blockIdx.x / kGridSplit;  // d groups + q
  const int d = group / groups, u0 = group % groups * kGridUnits;
  const int r = blockIdx.x % kGridSplit;
  const int nct = groups * kGridSplit;        // CTAs a direction
  const int chunk = tc::tile_bytes(Bp);
  constexpr int kRkTile = tc::tile_bytes(kGridUnits);
  uint8_t* rks = tc::align_1024(smem_raw);    // [nq][64 x 32 tile]
  uint8_t* ring = rks + nq * kRkTile;         // [stages][P][chunk]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * P * chunk);
  uint64_t* empty = full + stages;
  const size_t slot = static_cast<size_t>(n_dirs) * P * nch * chunk;
  const size_t pslot = static_cast<size_t>(n_dirs) * groups * kGridSplit *
                       Bp * kGridUnits;
  float* pgroup = psum + static_cast<size_t>(group) * kGridSplit * Bp *
                             kGridUnits;
  uint32_t* gcount = counter + n_dirs + group;
  const int tid = threadIdx.x;

  // Rk[d][u0 + m][r Kq + k] -> tile k / 32 of rks, (m, k % 32)
  for (int e = tid; e < kGridUnits * nq * 4; e += kGridThreads) {
    const int m = e / (nq * 4), k = e % (nq * 4) * 8;  // 8 k values
    const uint4 v = *reinterpret_cast<const uint4*>(
        rk + (static_cast<size_t>(d) * U + u0 + m) * K3 +
        r * nq * tc::kK + k);
    *reinterpret_cast<uint4*>(rks + k / tc::kK * kRkTile +
                              tc::tile_offset(m, k % tc::kK)) = v;
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], kGridConsumers);
    }
    tc::fence_mbar_init();
  }
  tc::fence_proxy_async();
  __syncthreads();

  if (tid >= kGridConsumers) {  // the producer warp: one lane issues
    if (tid == kGridConsumers) {
      int gs = 0;
      for (int p = T_steps - 1; p > 0; --p) {
        tc::wait_counter(&counter[d],
                         static_cast<uint32_t>(nct * (T_steps - p)));
        tc::fence_proxy_async_global();
        const uint8_t* src = reinterpret_cast<const uint8_t*>(xb) +
                             (p & 1) * slot +
                             static_cast<size_t>(d) * P * nch * chunk;
        for (int kc = r * nq; kc < (r + 1) * nq; ++kc, ++gs) {
          const int s = gs % stages;
          tc::mbar_wait(&empty[s], ((gs / stages) & 1) ^ 1);
          tc::mbar_expect_tx(&full[s], P * chunk);
#pragma unroll
          for (int a = 0; a < P; ++a)
            tc::bulk_load(ring + (s * P + a) * chunk,
                          src + (static_cast<size_t>(a) * nch + kc) * chunk,
                          chunk, &full[s]);
        }
      }
    }
    return;
  }

  const int j = tid % kGridUnits, rs = tid / kGridUnits;
  const int u = u0 + j;
  const int wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
  float carry[kRows], dhz[kRows];
  float db[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < kRows; ++i) carry[i] = 0.0f;
  int gs = 0;
  for (int p = T_steps - 1; p >= 0; --p) {
    const int t = d == 0 ? p : T_steps - 1 - p;
    const int tp = d == 0 ? p - 1 : T_steps - p;  // h_prev's real time
    uint8_t* dst = reinterpret_cast<uint8_t*>(xb) + (p & 1) * slot +
                   static_cast<size_t>(d) * P * nch * chunk;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int b = r * RB + rs * kRows + i;
      float dhp[3] = {0.0f, 0.0f, 0.0f};
      dhz[i] = 0.0f;
      if (b < B) {
        const size_t row = static_cast<size_t>(d) * N + t * B + b;
        const float dh = carry[i] + to_f32(g[row * U + u]);
        const float hprev =
            p > 0 ? to_f32(hs[(static_cast<size_t>(d) * N + tp * B + b) * U +
                              u])
                  : 0.0f;
        const T* x = xp + row * K3 + u;
        float* hp = hp_dhp + row * K3 + u;
        const float z = sigmoid(to_f32(x[0]) + hp[0]);
        const float rr = sigmoid(to_f32(x[U]) + hp[U]);
        const float hh = hp[2 * U];
        const float c = tanh_fast(to_f32(x[2 * U]) + rr * hh);
        const float da_h = dh * (1.0f - z) * (1.0f - c * c);
        const float da_z = dh * (hprev - c) * z * (1.0f - z);
        const float da_r = da_h * hh * rr * (1.0f - rr);
        T* dx = dxp + row * K3 + u;
        store1(dx, da_z);
        store1(dx + U, da_r);
        store1(dx + 2 * U, da_h);
        dhp[0] = da_z;
        dhp[1] = da_r;
        dhp[2] = da_h * rr;
        hp[0] = dhp[0];
        hp[U] = dhp[1];
        hp[2 * U] = dhp[2];
        dhz[i] = dh * z;
      }
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) {
        db[gt] += dhp[gt];
        const int col = gt * U + u;
        uint8_t* at = dst + (col / tc::kK) * static_cast<size_t>(chunk) +
                      tc::tile_offset(b, col % tc::kK);
        float rest = dhp[gt];
#pragma unroll
        for (int a = 0; a < P; ++a) {
          const __nv_bfloat16 part = __float2bfloat16_rn(rest);
          rest -= __bfloat162float(part);
          *reinterpret_cast<__nv_bfloat16*>(
              at + static_cast<size_t>(a) * nch * chunk) = part;
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
    if (p == 0) break;

    // position p - 1's gate inputs into L2 while the product runs: a lane
    // of each warp a row, the warp's 32 units
    if (lane < kRows) {
      const int tn = d == 0 ? p - 1 : T_steps - p;
      const int b = r * RB + rs * kRows + lane;
      if (b < B) {
        const size_t row = static_cast<size_t>(d) * N + tn * B + b;
        const int u32 = u0 + warp % 2 * 32;
#pragma unroll
        for (int gt = 0; gt < 3; ++gt) {
          prefetch_l2(xp + row * K3 + gt * U + u32);
          prefetch_l2(hp_dhp + row * K3 + gt * U + u32);
        }
        prefetch_l2(g + row * U + u32);
      }
    }
    // the product for position p - 1's carry, NS batch rows a wgmma
    float acc[kSub][NS / 2];
#pragma unroll
    for (int sb = 0; sb < kSub; ++sb)
#pragma unroll
      for (int e = 0; e < NS / 2; ++e) acc[sb][e] = 0.0f;
    for (int kc = 0; kc < nq; ++kc, ++gs) {
      const int s = gs % stages;
      tc::mbar_wait(&full[s], (gs / stages) & 1);
#pragma unroll
      for (int sb = 0; sb < kSub; ++sb) {
        float part[NS / 2];
        tc::wgmma_fence();
        int accumulate = 0;
#pragma unroll
        for (int a = P - 1; a >= 0; --a)
#pragma unroll
          for (int kk = 0; kk < tc::kK / 16; ++kk) {
            wgmma_nb<NS>(part,
                         tc::desc(tc::smem_u32(rks + kc * kRkTile) +
                                  kk * 2 * tc::kLbo),
                         tc::desc(tc::smem_u32(ring + (s * P + a) * chunk) +
                                  (wg * NB + sb * NS) / 8 * tc::kSbo +
                                  kk * 2 * tc::kLbo),
                         accumulate);
            accumulate = 1;
          }
        tc::wgmma_commit();
        tc::wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < NS / 2; ++e) acc[sb][e] += part[e];
      }
      tc::mbar_arrive(&empty[s]);
    }
    // the group's sum: fragment (unit m = 16 warp + lane / 4 + 8 h, row
    // b = wg NB + sb NS + 8 i + 2 (lane % 4) + e) to pgroup[slot][r][b][m]
    float* mine = pgroup + (p & 1) * pslot +
                  static_cast<size_t>(r) * Bp * kGridUnits;
#pragma unroll
    for (int sb = 0; sb < kSub; ++sb)
#pragma unroll
      for (int i = 0; i < NS / 8; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = 16 * warp + lane / 4 + 8 * hh;
            const int b = wg * NB + sb * NS + 8 * i + 2 * (lane % 4) + e;
            __stcg(mine + b * kGridUnits + m, acc[sb][4 * i + 2 * hh + e]);
          }
    tc::named_sync(1, kGridConsumers);
    if (tid == 0) {
      __threadfence();
      tc::red_release_add(gcount, 1);
      tc::wait_counter(gcount,
                       static_cast<uint32_t>(kGridSplit * (T_steps - p)));
      __threadfence();
    }
    tc::named_sync(1, kGridConsumers);
    const float* sums = pgroup + (p & 1) * pslot;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int b = r * RB + rs * kRows + i;
      float back = 0.0f;
#pragma unroll
      for (int o = 0; o < kGridSplit; ++o)
        back += __ldcg(sums + (static_cast<size_t>(o) * Bp + b) * kGridUnits +
                       j);
      carry[i] = dhz[i] + back;
    }
  }
  // dRb's per-tile sums: tile (rank, row block) of the direction
#pragma unroll
  for (int gt = 0; gt < 3; ++gt)
    dbias[(static_cast<size_t>(d) * kGridTiles + r * 4 + rs) * K3 + gt * U +
          u] = db[gt];
}

// dRk: pass 3's slices added in slice order; dRb: the recurrence's
// per-tile sums added in tile order. Neither depends on block scheduling.
__global__ void gru_bwd_finalize_kernel(const float* __restrict__ part,
                                        const float* __restrict__ dbias,
                                        float* __restrict__ drk,
                                        float* __restrict__ drb, int slices,
                                        int n_dirs, int n_tiles, int units) {
  const int K = 3 * units;
  const size_t n_drk = static_cast<size_t>(n_dirs) * units * K;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float sum = 0.0f;
  if (i < n_drk) {
    for (int sl = 0; sl < slices; ++sl) sum += part[sl * n_drk + i];
    drk[i] = sum;
  } else if (i < n_drk + static_cast<size_t>(n_dirs) * K) {
    const size_t d = (i - n_drk) / K, j = (i - n_drk) % K;
    for (int tl = 0; tl < n_tiles; ++tl)
      sum += dbias[(d * n_tiles + tl) * K + j];
    drb[d * K + j] = sum;
  }
}

// pass 3's output tiles: D x U / 128 x 3U / 128
int tiles(int D, int U) {
  const int K = 3 * U;
  return D * ((U + kTcRows - 1) / kTcRows) * ((K + kTcRows - 1) / kTcRows);
}

// Row slices of pass 3 for N = T * B rows: about kTcSms tiles in all (one
// persistent CTA a SM), at least four kTcSlice-row chunks a slice
int tc_slices(int D, int N, int U) {
  const int want = (kTcSms + tiles(D, U) - 1) / tiles(D, U);
  const int most = (N + 4 * kTcSlice - 1) / (4 * kTcSlice);
  const int s = want < most ? want : most;
  return s < 1 ? 1 : s;
}

// rows a slice: whole kTcSlice-row chunks (whole chunks of either pass)
int rows_per_slice(int N, int slices) {
  const int rows = (N + slices - 1) / slices;
  return (rows + kTcSlice - 1) / kTcSlice * kTcSlice;
}

// The workspace holds hp, then dhp, [D, T * B, 3U] f32; the per-tile dRb
// sums [D, tiles <= B, 3U]; pass 3's partials [slices, D, U, 3U].
size_t hp_floats(int D, int N, int U) {
  return static_cast<size_t>(D) * N * 3 * U;
}

// ... and, past U = 256 (the streamed recurrence), the carry [D, B, U] and
// Rk^T [D, 3U, U]
size_t stream_floats(int D, int B, int U) {
  return U > kRegisterUnits
             ? static_cast<size_t>(D) * B * U + static_cast<size_t>(D) * 3 * U * U
             : 0;
}

// the grid-resident recurrence (plan index kGridVariant): batch rows padded
// to a wgmma block, 64, 128 or 256
constexpr int kGridVariant = kNumVariants + kNumResident + 1;
int grid_bp(int B) { return B <= 64 ? 64 : B <= 128 ? 128 : 256; }
// ... its counters (the first kGridCounters floats), two slots of dhp's
// parts, two slots of the groups' partial sums
constexpr int kGridCounters = 1024;
size_t grid_xb_floats(int D, int B, int U) {
  return static_cast<size_t>(2) * D * kGridParts * (3 * U / tc::kK) *
         tc::tile_bytes(grid_bp(B)) / sizeof(float);
}
size_t grid_floats(int D, int B, int U) {
  if (U <= kResidentUnits) return 0;
  return kGridCounters + grid_xb_floats(D, B, U) +
         static_cast<size_t>(2) * D * U * kGridSplit * grid_bp(B);
}
// whether the plan takes (D, B, U): U % 128 == 0 (whole 32-deep chunks in
// each of the 4 K ranges), B <= 256, one CTA a SM for D U / 16 CTAs
bool grid_takes(int D, int B, int U) {
  return U > kResidentUnits && U % (kGridUnits * 2) == 0 && B >= 1 &&
         B <= kGridRows && D * U / (kGridUnits / kGridSplit) <= kTcSms;
}
// the ring's stages that fit beside the Rk tiles: 2 to 4, 0 if none
int grid_stages(int B, int U) {
  const size_t fixed = 1024 + static_cast<size_t>(3 * U / tc::kK / kGridSplit) *
                                  tc::tile_bytes(kGridUnits);
  const size_t stage = kGridParts * tc::tile_bytes(grid_bp(B)) + 16;
  if (fixed + 2 * stage > 232448) return 0;
  const size_t n = (232448 - fixed) / stage;
  return n > 4 ? 4 : static_cast<int>(n);
}
size_t grid_smem(int B, int U, int stages) {
  return 1024 +
         static_cast<size_t>(3 * U / tc::kK / kGridSplit) *
             tc::tile_bytes(kGridUnits) +
         static_cast<size_t>(stages) *
             (kGridParts * tc::tile_bytes(grid_bp(B)) + 16);
}

// dRb's per-tile sums: up to B tiles, kGridTiles for the grid plan
size_t dbias_floats(int D, int B, int U) {
  return hp_floats(D, B > kGridTiles ? B : kGridTiles, U);
}

size_t workspace_floats(int D, int T_steps, int B, int U) {
  const int N = T_steps * B;
  const size_t streamed = stream_floats(D, B, U), grid = grid_floats(D, B, U);
  return hp_floats(D, N, U) + dbias_floats(D, B, U) +
         static_cast<size_t>(tc_slices(D, N, U)) * D * U * 3 * U +
         (streamed > grid ? streamed : grid);
}

// The grid-resident recurrence with NB = Bp / 2: launched cooperatively,
// after checking that every CTA fits at once (else
// cudaErrorCooperativeLaunchTooLarge: never a launch that could wait
// forever); the counters are zeroed first.
template <typename T, int NB>
cudaError_t grid_config(int D, int B, int U, cudaLaunchConfig_t* cfg,
                        int* per_sm) {
  if (!grid_takes(D, B, U) || grid_bp(B) != 2 * NB) return cudaErrorInvalidValue;
  const int stages = grid_stages(B, U);
  if (stages < 2) return cudaErrorInvalidValue;
  auto* kern = gru_bwd_grid_kernel<T, NB>;
  *cfg = {};
  cfg->gridDim = dim3(D * U / (kGridUnits / kGridSplit), 1, 1);
  cfg->blockDim = dim3(kGridThreads, 1, 1);
  cfg->dynamicSmemBytes = grid_smem(B, U, stages);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(cfg->dynamicSmemBytes));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kern, kGridThreads, cfg->dynamicSmemBytes);
}

template <typename T, int NB>
cudaError_t launch_grid_nb(const void* xp, const void* rk16, const void* hs,
                           const void* g, void* dxp, float* hp_dhp,
                           float* dbias, float* grid_ws, int D, int T_steps,
                           int B, int U, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = grid_config<T, NB>(D, B, U, &cfg, &per_sm);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm * sms < static_cast<int>(cfg.gridDim.x))
    return cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.stream = stream;
  auto* counter = reinterpret_cast<uint32_t*>(grid_ws);
  err = cudaMemsetAsync(counter, 0, kGridCounters * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  float* xb = grid_ws + kGridCounters;
  err = cudaLaunchKernelEx(
      &cfg, gru_bwd_grid_kernel<T, NB>, static_cast<const T*>(xp),
      static_cast<const __nv_bfloat16*>(rk16), static_cast<const T*>(hs),
      static_cast<const T*>(g), static_cast<T*>(dxp), hp_dhp, dbias,
      reinterpret_cast<__nv_bfloat16*>(xb), xb + grid_xb_floats(D, B, U),
      counter, D, T_steps, B, U, grid_stages(B, U));
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t launch_grid(const void* xp, const void* rk16, const void* hs,
                        const void* g, void* dxp, float* hp_dhp, float* dbias,
                        float* grid_ws, int D, int T_steps, int B, int U,
                        cudaStream_t stream) {
  switch (grid_bp(B)) {
    case 64: return launch_grid_nb<T, 32>(xp, rk16, hs, g, dxp, hp_dhp,
                                          dbias, grid_ws, D, T_steps, B, U,
                                          stream);
    case 128: return launch_grid_nb<T, 64>(xp, rk16, hs, g, dxp, hp_dhp,
                                           dbias, grid_ws, D, T_steps, B, U,
                                           stream);
    default: return launch_grid_nb<T, 128>(xp, rk16, hs, g, dxp, hp_dhp,
                                           dbias, grid_ws, D, T_steps, B, U,
                                           stream);
  }
}

// One tensor-core pass (MODE 0: hp into `out`; 1: dRk's slice partials):
// its two tensor maps, then as many persistent CTAs as the card holds, at
// most one a tile. A and B as tc_pass's note says: MODE 0 a = hs,
// b = Rk; MODE 1 a = hs, b = dhp.
template <int MODE, typename TA, typename TB>
cudaError_t launch_tc(const void* a, const void* b, const float* rb,
                      float* out, int D, int T_steps, int B, int U,
                      int slices, cudaStream_t stream) {
  const int N = T_steps * B, K3 = 3 * U;
  constexpr bool a16 = sizeof(TA) == 2, b16 = sizeof(TB) == 2;
  constexpr int K = TcShape<TA, TB>::k;
  CUtensorMap ma, mb;
  bool ok;
  if (MODE == 0)
    ok = tc_host::map_3d(&ma, a, a16, U, N, D, K, kTcRows,
                         CU_TENSOR_MAP_SWIZZLE_128B) &&
         tc_host::map_3d(&mb, b, b16, K3, U, D, kTcRows, K,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
  else
    ok = tc_host::map_3d(&ma, a, a16, U, N, D, kTcRows, K,
                         CU_TENSOR_MAP_SWIZZLE_NONE) &&
         tc_host::map_3d(&mb, b, b16, K3, N, D, kTcRows, K,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return cudaErrorInvalidValue;
  auto* kern = MODE == 0 ? gru_bwd_hp_tc_kernel<TA, TB>
                         : gru_bwd_drk_tc_kernel<TA, TB>;
  constexpr size_t smem = TcShape<TA, TB>::smem;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int nj = (K3 + kTcRows - 1) / kTcRows;
  const int nm = ((MODE == 0 ? N : U) + kTcRows - 1) / kTcRows;
  const int n_tiles = nj * nm * D * (MODE == 0 ? 1 : slices);
  const int grid = n_tiles < kTcSms ? n_tiles : kTcSms;
  kern<<<grid, kTcThreads, smem, stream>>>(
      ma, mb, rb, out, D, T_steps, B, U, slices,
      rows_per_slice(N, slices));
  return cudaGetLastError();
}

// passes 1 and 3 on the tensor cores, for hs and Rk as the wrapper hands
// them over (each in bf16 or f32)
cudaError_t launch_tc_hp(const void* hs, int hs_bf16, const void* rk,
                         int rk_bf16, const float* rb, float* hp, int D,
                         int T_steps, int B, int U, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if (hs_bf16)
    return rk_bf16 ? launch_tc<0, bf16, bf16>(hs, rk, rb, hp, D, T_steps, B,
                                              U, 1, stream)
                   : launch_tc<0, bf16, float>(hs, rk, rb, hp, D, T_steps, B,
                                               U, 1, stream);
  return rk_bf16 ? launch_tc<0, float, bf16>(hs, rk, rb, hp, D, T_steps, B, U,
                                             1, stream)
                 : launch_tc<0, float, float>(hs, rk, rb, hp, D, T_steps, B,
                                              U, 1, stream);
}
cudaError_t launch_tc_drk(const void* hs, int hs_bf16, const float* dhp,
                          float* part, int D, int T_steps, int B, int U,
                          int slices, cudaStream_t stream) {
  return hs_bf16 ? launch_tc<1, __nv_bfloat16, float>(hs, dhp, nullptr, part,
                                                      D, T_steps, B, U,
                                                      slices, stream)
                 : launch_tc<1, float, float>(hs, dhp, nullptr, part, D,
                                              T_steps, B, U, slices, stream);
}

// the cluster size of the streamed recurrence: the largest of 8, 4 dividing U
int stream_cluster(int U) { return U % 8 == 0 ? 8 : 4; }

// The streamed recurrence's block: KS groups of UW threads, UW the CTA's
// units rounded up to whole warps (at most kStreamThreads), KS as many
// groups as fill kStreamThreads (at most kStreamSplits): returns KS, writes
// UW
int stream_split(int units_per_cta, int* uw) {
  const int w = (units_per_cta + 31) / 32 * 32;
  *uw = w < kStreamThreads ? w : kStreamThreads;
  const int ks = kStreamThreads / *uw;
  return ks < kStreamSplits ? ks : kStreamSplits;
}

template <typename T>
cudaError_t launch_stream(const void* xp, const float* rk, const void* hs,
                          const void* g, void* dxp, float* hp_dhp,
                          float* dbias, float* carry, float* rkt, int D,
                          int T_steps, int B, int U, int cluster,
                          cudaStream_t stream) {
  if (U <= kRegisterUnits || U % 4 || cluster != stream_cluster(U))
    return cudaErrorInvalidValue;
  const size_t n = static_cast<size_t>(D) * 3 * U * U;
  gru_bwd_transpose_kernel<<<static_cast<unsigned>(
                                 n / 256 < 4096 ? (n + 255) / 256 : 4096),
                             256, 0, stream>>>(rk, rkt, D, U);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
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
  err = cudaLaunchKernelEx(
      &cfg, gru_bwd_stream_kernel<T>, static_cast<const T*>(xp),
      static_cast<const float*>(rkt), static_cast<const T*>(hs),
      static_cast<const T*>(g), static_cast<T*>(dxp), hp_dhp, dbias, carry,
      T_steps, B, U, cluster, splits);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int V, typename T>
cudaError_t launch_rec(const void* xp, const float* rk, const void* hs,
                       const void* g, void* dxp, float* hp_dhp, float* dbias,
                       int D, int T_steps, int B, int U, int cluster,
                       cudaStream_t stream) {
  constexpr Variant v = kVariants[V];
  if (cluster < 1 || cluster > kMaxCluster || U < 1 || U % cluster ||
      (U / cluster) % v.nu || U > 4 * v.s * v.ni)
    return cudaErrorInvalidValue;
  const int threads = (U / cluster / v.nu * v.s + 31) / 32 * 32;
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
      &cfg, gru_bwd_rec_kernel<v.s, v.ni, v.bt, v.nu, v.maxt, T>,
      static_cast<const T*>(xp), rk, static_cast<const T*>(hs),
      static_cast<const T*>(g), static_cast<T*>(dxp), hp_dhp, dbias, T_steps,
      B, U, cluster);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rec(int variant, const void* xp, const float* rk,
                         const void* hs, const void* g, void* dxp,
                         float* hp_dhp, float* dbias, int D, int T_steps,
                         int B, int U, int cluster, cudaStream_t st) {
  switch (variant) {
    case 0: return launch_rec<0, T>(xp, rk, hs, g, dxp, hp_dhp, dbias, D,
                                    T_steps, B, U, cluster, st);
    case 1: return launch_rec<1, T>(xp, rk, hs, g, dxp, hp_dhp, dbias, D,
                                    T_steps, B, U, cluster, st);
    case 2: return launch_rec<2, T>(xp, rk, hs, g, dxp, hp_dhp, dbias, D,
                                    T_steps, B, U, cluster, st);
    case 3: return launch_rec<3, T>(xp, rk, hs, g, dxp, hp_dhp, dbias, D,
                                    T_steps, B, U, cluster, st);
    default: return cudaErrorInvalidValue;
  }
}
static_assert(kNumVariants == 4, "dispatch_rec() names every variant");

// Dynamic shared memory of resident variant V for blocks of `threads`
// threads, CTAs of ucw units and tiles of bt rows: its Rk chunks, the
// double-buffered slots, the dhp rows.
size_t res_bwd_smem(int V, int threads, int ucw, int bt) {
  const Resident& v = kResident[V];
  return sizeof(float) *
         (static_cast<size_t>(4) * kGroupUnits * v.ns * threads +
          static_cast<size_t>(2) * v.c * bt * ucw +
          static_cast<size_t>(bt) * res_k(v));
}

// The launch configuration of resident variant V (clusters of C CTAs of
// 8 ucw threads, grid (tiles * C, D)); false where it does not take U or bt.
bool res_config(int V, int D, int B, int U, int cluster, int bt,
                cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const Resident& v = kResident[V];
  const int ucw = res_cta_units(U, v.c);
  if (U <= kRegisterUnits || U % 4 || cluster != v.c ||
      3 * ucw > res_k(v) || bt < 8 || bt > v.bt || bt % 8 || B < 1)
    return false;
  const int threads = v.c * ucw / kGroupUnits * v.s;
  *cfg = {};
  cfg->gridDim = dim3((B + bt - 1) / bt * v.c, D, 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = res_bwd_smem(V, threads, ucw, bt);
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
  return gru_bwd_res_kernel<v.c, v.s, v.nr, v.ns, v.rp, v.bt / 8,
                            res_threads(v), T>;
}

// Opens variant V's kernel to its shared memory and cluster size.
template <int V, typename T>
cudaError_t res_attributes(const cudaLaunchConfig_t& cfg) {
  auto* kern = res_kernel<V, T>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(cfg.dynamicSmemBytes));
  if (err == cudaSuccess && kResident[V].c > kMaxCluster)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

template <int V, typename T>
cudaError_t launch_res(const void* xp, const float* rk, const void* hs,
                       const void* g, void* dxp, float* hp_dhp, float* dbias,
                       int D, int T_steps, int B, int U, int cluster, int bt,
                       cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  if (!res_config(V, D, B, U, cluster, bt, &cfg, attr))
    return cudaErrorInvalidValue;
  cfg.stream = stream;
  cudaError_t err = res_attributes<V, T>(cfg);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, res_kernel<V, T>(),
                           static_cast<const T*>(xp), rk,
                           static_cast<const T*>(hs),
                           static_cast<const T*>(g), static_cast<T*>(dxp),
                           hp_dhp, dbias, T_steps, B, U,
                           res_cta_units(U, kResident[V].c), bt);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters of variant V at this launch, into *out
template <int V>
cudaError_t res_max_clusters(int D, int B, int U, int bt, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  if (!res_config(V, D, B, U, kResident[V].c, bt, &cfg, attr))
    return cudaErrorInvalidValue;
  cudaError_t err = res_attributes<V, float>(cfg);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(out, res_kernel<V, float>(), &cfg);
}
static_assert(kNumResident == 2, "launch() names every resident variant");

template <typename T>
cudaError_t launch(const void* xp, const float* rk, const float* rb,
                   const void* hs, const void* g, void* dxp, float* workspace,
                   float* drk, float* drb, int D, int T_steps, int B, int U,
                   int variant, int cluster, int res_bt, const void* rk_pass,
                   int rk_pass_bf16, const void* hs_pass, int hs_pass_bf16,
                   cudaStream_t stream) {
  const int N = T_steps * B;
  float* hp_dhp = workspace;
  float* dbias = hp_dhp + hp_floats(D, N, U);
  float* part = dbias + dbias_floats(D, B, U);
  const bool streamed = variant == kNumVariants;
  const bool grid = variant == kGridVariant;
  const bool resident = variant > kNumVariants && !grid;
  if ((streamed || resident || grid) != (U > kRegisterUnits) ||
      variant > kGridVariant || (grid && !rk_pass_bf16))
    return cudaErrorInvalidValue;

  cudaError_t err = launch_tc_hp(hs_pass, hs_pass_bf16, rk_pass,
                                 rk_pass_bf16, rb, hp_dhp, D, T_steps, B, U,
                                 stream);
  if (err != cudaSuccess) return err;

  const int slices = tc_slices(D, N, U);
  float* extra = part + static_cast<size_t>(slices) * D * U * 3 * U;
  if (grid) {
    err = launch_grid<T>(xp, rk_pass, hs, g, dxp, hp_dhp, dbias, extra, D,
                         T_steps, B, U, stream);
  } else if (resident) {
    err = variant == kNumVariants + 1
              ? launch_res<0, T>(xp, rk, hs, g, dxp, hp_dhp, dbias, D,
                                 T_steps, B, U, cluster, res_bt, stream)
              : launch_res<1, T>(xp, rk, hs, g, dxp, hp_dhp, dbias, D,
                                 T_steps, B, U, cluster, res_bt, stream);
  } else if (streamed) {
    err = launch_stream<T>(xp, rk, hs, g, dxp, hp_dhp, dbias, extra,
                           extra + static_cast<size_t>(D) * B * U, D, T_steps,
                           B, U, cluster, stream);
  } else {
    err = dispatch_rec<T>(variant, xp, rk, hs, g, dxp, hp_dhp, dbias, D,
                          T_steps, B, U, cluster, stream);
  }
  if (err != cudaSuccess) return err;
  // a valid variant: it launched; dRb's per-tile sums it left
  const int bt = resident ? res_bt
                 : streamed ? kStreamBT
                 : grid     ? 1
                            : kVariants[variant].bt;
  const int n_tiles = grid ? kGridTiles : (B + bt - 1) / bt;

  err = launch_tc_drk(hs_pass, hs_pass_bf16, hp_dhp, part, D, T_steps, B, U,
                      slices, stream);
  if (err != cudaSuccess) return err;

  const size_t total = static_cast<size_t>(D) * (U + 1) * 3 * U;
  const unsigned fin_blocks = static_cast<unsigned>((total + 255) / 256);
  gru_bwd_finalize_kernel<<<fin_blocks, 256, 0, stream>>>(
      part, dbias, drk, drb, slices, D, n_tiles, U);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Writes the variant table as (S, NI, BT, NU, max threads) quintuples into
// out (room for `cap` ints) and returns the number of variants, so the
// wrapper's copy can be checked against it.
int seld_gru_bwd_variants(int* out, int cap) {
  for (int i = 0; i < kNumVariants && 5 * i + 4 < cap; ++i) {
    out[5 * i] = kVariants[i].s;
    out[5 * i + 1] = kVariants[i].ni;
    out[5 * i + 2] = kVariants[i].bt;
    out[5 * i + 3] = kVariants[i].nu;
    out[5 * i + 4] = kVariants[i].maxt;
  }
  return kNumVariants;
}

// Writes the streamed recurrence's constants (kStreamBT, kStreamThreads,
// kStreamChunk, kStreamSplits) into out and returns their number
int seld_gru_bwd_stream_params(int* out, int cap) {
  if (cap < 4) return 0;
  out[0] = kStreamBT;
  out[1] = kStreamThreads;
  out[2] = kStreamChunk;
  out[3] = kStreamSplits;
  return 4;
}

// Writes the resident recurrence's table as (C, S, NR, NS, BT, RP)
// sextuples and kResidentUnits after them into out; returns the number of
// variants
int seld_gru_bwd_resident(int* out, int cap) {
  if (cap < 6 * kNumResident + 1) return 0;
  for (int i = 0; i < kNumResident; ++i) {
    const Resident& v = kResident[i];
    const int row[6] = {v.c, v.s, v.nr, v.ns, v.bt, v.rp};
    for (int j = 0; j < 6; ++j) out[6 * i + j] = row[j];
  }
  out[6 * kNumResident] = kResidentUnits;
  return kNumResident;
}

// cudaOccupancyMaxActiveClusters of the resident recurrence `variant` (plan
// index kNumVariants + 1 + i) at D, B, U and tiles of bt rows, into *out;
// returns a cudaError_t
int seld_gru_bwd_max_clusters(int D, int B, int U, int variant, int bt,
                              int* out) {
  cudaError_t err = cudaErrorInvalidValue;
  if (variant == kNumVariants + 1)
    err = res_max_clusters<0>(D, B, U, bt, out);
  else if (variant == kNumVariants + 2)
    err = res_max_clusters<1>(D, B, U, bt, out);
  return static_cast<int>(err);
}

// Writes the grid-resident recurrence's constants (kGridSplit, kGridUnits,
// kGridThreads, kGridParts, kGridTiles, kGridRows) and its plan index into
// out; returns their number
int seld_gru_bwd_grid(int* out, int cap) {
  if (cap < 7) return 0;
  const int row[7] = {kGridSplit, kGridUnits, kGridThreads, kGridParts,
                      kGridTiles, kGridRows, kGridVariant};
  for (int i = 0; i < 7; ++i) out[i] = row[i];
  return 7;
}

// cudaOccupancyMaxActiveBlocksPerMultiprocessor of the grid-resident
// recurrence at D, B, U, into *out; returns a cudaError_t
int seld_gru_bwd_grid_blocks(int D, int B, int U, int* out) {
  cudaLaunchConfig_t cfg;
  switch (grid_bp(B)) {
    case 64: return static_cast<int>(grid_config<float, 32>(D, B, U, &cfg, out));
    case 128: return static_cast<int>(grid_config<float, 64>(D, B, U, &cfg, out));
    default: return static_cast<int>(grid_config<float, 128>(D, B, U, &cfg, out));
  }
}

// Bytes of scratch one call needs (hp/dhp and pass 3's partials); the
// wrapper allocates them as one flat buffer, whose layout is this file's.
size_t seld_gru_bwd_workspace_bytes(int D, int T_steps, int B, int U) {
  return sizeof(float) * workspace_floats(D, T_steps, B, U);
}

// Returns a cudaError_t (0 on success). is_bf16 selects the storage type of
// x_proj, hs, g and dx_proj; rk, rb, drk and drb are f32. Passes 1 and 3
// (the tensor cores) read hs_pass and pass 1 rk_pass, hs and Rk as the
// caller holds them or f32 copies (bf16 where hs_pass_bf16 / rk_pass_bf16),
// each with rows of a multiple of 16 bytes, as TMA loads them; variant
// kGridVariant, the grid-resident recurrence, reads rk_pass too, in bf16.
// workspace holds seld_gru_bwd_workspace_bytes(D, T_steps, B, U) bytes;
// variant, cluster and bt (the resident recurrence's tile rows) come from
// the wrapper's plan (variant kNumVariants is the streamed recurrence,
// kNumVariants + 1 + i resident variant i; both only past U = 256).
int seld_gru_bwd(const void* xp, const void* rk, const void* rb,
                 const void* hs, const void* g, void* dxp, void* workspace,
                 void* drk, void* drb, int D, int T_steps, int B, int U,
                 int is_bf16, int variant, int cluster, int bt,
                 const void* rk_pass, int rk_pass_bf16, const void* hs_pass,
                 int hs_pass_bf16, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* rkf = static_cast<const float*>(rk);
  const auto* rbf = static_cast<const float*>(rb);
  auto* ws = static_cast<float*>(workspace);
  auto* drkf = static_cast<float*>(drk);
  auto* drbf = static_cast<float*>(drb);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(xp, rkf, rbf, hs, g, dxp, ws, drkf,
                                      drbf, D, T_steps, B, U, variant,
                                      cluster, bt, rk_pass, rk_pass_bf16,
                                      hs_pass, hs_pass_bf16, st)
              : launch<float>(xp, rkf, rbf, hs, g, dxp, ws, drkf, drbf, D,
                              T_steps, B, U, variant, cluster, bt, rk_pass,
                              rk_pass_bf16, hs_pass, hs_pass_bf16, st);
  return static_cast<int>(err);
}

const char* seld_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
