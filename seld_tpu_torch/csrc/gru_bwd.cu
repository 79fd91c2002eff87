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
//   1. gru_bwd_hp_kernel: h_prev is known for every step from hs, so hp for
//      all T is one parallel [T B, U] x [U, 3U] f32 product per direction
//      (128 x 128 output tiles, 8 x 8 a thread, 16-deep chunks loaded into
//      registers while the previous chunk is multiplied), into the
//      workspace.
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
//   3. gru_bwd_drk_kernel: dRk[d] = sum over the T B rows of h_prev^T dhp,
//      as pass 1's tile product over fixed slices of the rows, no float
//      atomics; gru_bwd_finalize_kernel adds the slices (dRk) and the tiles
//      (dRb) in a fixed order, so the result does not depend on block
//      scheduling.
//
// What bounds it. Pass 2 of every variant: the f32 FMAs of dhp @ Rk^T at
// 67 TFLOP/s, then the per-step cluster barrier on the chain of T steps;
// the resident recurrence reads Rk from registers and shared memory only
// and exchanges the partial sums alone, once a step.
// At the training shape (D = 2, T = 60, B = 256, U = 128,
// bf16 storage) the three B x U x 3U products per step and direction are
// 9.06 GFLOP, 0.135 ms at the f32 rate outside the tensor cores (67
// TFLOP/s); the reference multiplies in f32, so neither bf16 nor one-pass
// TF32 tensor-core products may stand in. Bytes (about 63 MB, plus the f32
// workspace hp/dhp written and read twice, 47 MB) are a few hundredths of a
// ms. Passes 1 and 3 are parallel f32 tile products (each float loaded from
// shared memory feeds 4 FMAs, so shared-memory reads pace them with the
// FMAs); pass 2 is a chain of T steps, each a third of the FMAs on 128 SMs
// plus one cluster barrier. The previous design kept Rk[d] in shared
// memory, did both products of a step on the serial chain (h_prev @ Rk and
// dhp @ Rk^T) with four block barriers a step, and reduced dRk with 4
// outputs a thread (1.02 ms).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// passes 1 and 3: 128 x 128 output tiles, 16-deep k chunks, 8 x 8 a thread
constexpr int kTile = 128;
constexpr int kDepth = 16;
constexpr int kGemmThreads = 256;
constexpr int kTargetBlocks = 264;  // two blocks on each of 132 SMs

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

// h_prev of row n = t B + b of direction d is hs at the previous scan step:
// row n - B for d = 0, n + B for d = 1; -1 at the scan start
__device__ __forceinline__ int prev_row(int n, int d, int batch, int N) {
  return d == 0 ? (n >= batch ? n - batch : -1)
                : (n + batch < N ? n + batch : -1);
}

// The 8 x 8 outputs of thread (ty, tx) of a 128 x 128 tile: rows
// {4 ty + i, 64 + 4 ty + i}, columns {4 tx + j, 64 + 4 tx + j}; a[k][row]
// and b[k][col] hold a 16-deep chunk of the two operands.
__device__ __forceinline__ void tile_fma(float (&acc)[8][8],
                                         const float (&a)[kDepth][kTile],
                                         const float (&b)[kDepth][kTile],
                                         int ty, int tx) {
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(&a[k][4 * ty]);
    const float4 a1 = *reinterpret_cast<const float4*>(&a[k][64 + 4 * ty]);
    const float4 b0 = *reinterpret_cast<const float4*>(&b[k][4 * tx]);
    const float4 b1 = *reinterpret_cast<const float4*>(&b[k][64 + 4 * tx]);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ int tile_row(int ty, int i) {
  return i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4;
}

// (ty, tx) of thread tid: a warp covers 4 ty x 8 tx, so its float4 reads
// of a chunk row are 4 and 8 distinct words (one wavefront each)
__device__ __forceinline__ void thread_tile(int tid, int& ty, int& tx) {
  const int warp = tid / 32, lane = tid % 32;
  ty = warp / 2 * 4 + lane / 8;
  tx = warp % 2 * 8 + lane % 8;
}

// A 128 x 128 tile product over `chunks` 16-deep chunks, double-buffered:
// chunk c + 1 is loaded into registers while chunk c is multiplied, so one
// barrier a chunk. load_a(c, r) and load_b(c, r) give this thread's 8
// elements (row tid / 128 + 2 i, column tid % 128, i < 8) of chunk c of
// a[k][row] and b[k][col].
template <class LoadA, class LoadB>
__device__ __forceinline__ void tile_product(float (&acc)[8][8], int chunks,
                                             LoadA load_a, LoadB load_b) {
  __shared__ __align__(16) float a_s[2][kDepth][kTile];
  __shared__ __align__(16) float b_s[2][kDepth][kTile];
  const int tid = threadIdx.x;
  int ty, tx;
  thread_tile(tid, ty, tx);
  const int r0 = tid / kTile, c = tid % kTile;
  float ra[8], rb[8];
  load_a(0, ra);
  load_b(0, rb);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a_s[0][r0 + 2 * i][c] = ra[i];
    b_s[0][r0 + 2 * i][c] = rb[i];
  }
  __syncthreads();
  for (int ch = 0; ch < chunks; ++ch) {
    const bool more = ch + 1 < chunks;
    if (more) {
      load_a(ch + 1, ra);
      load_b(ch + 1, rb);
    }
    tile_fma(acc, a_s[ch & 1], b_s[ch & 1], ty, tx);
    if (more) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        a_s[(ch + 1) & 1][r0 + 2 * i][c] = ra[i];
        b_s[(ch + 1) & 1][r0 + 2 * i][c] = rb[i];
      }
    }
    __syncthreads();
  }
}

// Pass 1: hp[d, n, :] = h_prev[d, n, :] @ Rk[d] + rb[d] for the N = T B
// rows; grid (ceil(3U / 128), ceil(N / 128), D). Thread tid loads row
// n0 + tid % 128 of h_prev (its k-th element for k = tid / 128 + 2 i).
template <typename T>
__global__ void __launch_bounds__(kGemmThreads, 2)
gru_bwd_hp_kernel(const T* __restrict__ hs, const float* __restrict__ rk,
                  const float* __restrict__ rb, float* __restrict__ hp,
                  int steps, int batch, int units) {
  const int U = units, K = 3 * units, N = steps * batch;
  const int j0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int d = blockIdx.z;
  const int tid = threadIdx.x;
  int ty, tx;
  thread_tile(tid, ty, tx);
  const int r0 = tid / kTile, c = tid % kTile;
  const int n = n0 + c;
  const int p = n < N ? prev_row(n, d, batch, N) : -1;
  const T* h_row = hs + (static_cast<size_t>(d) * N + (p < 0 ? 0 : p)) * U;
  const float* rk_d = rk + static_cast<size_t>(d) * U * K;

  float acc[8][8] = {};
  tile_product(
      acc, (U + kDepth - 1) / kDepth,
      [&](int ch, float (&r)[8]) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int k = ch * kDepth + r0 + 2 * i;
          r[i] = p >= 0 && k < U ? to_f32(h_row[k]) : 0.0f;
        }
      },
      [&](int ch, float (&r)[8]) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int k = ch * kDepth + r0 + 2 * i;
          r[i] = k < U && j0 + c < K
                     ? rk_d[static_cast<size_t>(k) * K + j0 + c]
                     : 0.0f;
        }
      });
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = n0 + tile_row(ty, i);
    if (row >= N) continue;
    float* out = hp + (static_cast<size_t>(d) * N + row) * K;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + 64 * h + 4 * tx;  // K % 4 == 0: all 4 or none
      if (j >= K) continue;
      const float* bias = rb + static_cast<size_t>(d) * K + j;
      *reinterpret_cast<float4*>(out + j) =
          make_float4(acc[i][4 * h] + bias[0], acc[i][4 * h + 1] + bias[1],
                      acc[i][4 * h + 2] + bias[2], acc[i][4 * h + 3] + bias[3]);
    }
  }
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

// Pass 3: part[sl][d][u][j] = sum over rows n of slice sl of h_prev[d, n, u]
// dhp[d, n, j]; grid (ceil(3U / 128), ceil(U / 128), D * slices). Thread
// tid loads column tid % 128 of rows tid / 128 + 2 i of each chunk.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads, 2)
gru_bwd_drk_kernel(const T* __restrict__ hs, const float* __restrict__ dhp,
                   float* __restrict__ part, int n_dirs, int steps, int batch,
                   int units, int rows_per_slice) {
  const int U = units, K = 3 * units, N = steps * batch;
  const int j0 = blockIdx.x * kTile, u0 = blockIdx.y * kTile;
  const int d = blockIdx.z % n_dirs, sl = blockIdx.z / n_dirs;
  const int tid = threadIdx.x;
  int ty, tx;
  thread_tile(tid, ty, tx);
  const int r0 = tid / kTile, c = tid % kTile;
  const int n_begin = sl * rows_per_slice;
  const int n_end = min(N, n_begin + rows_per_slice);
  const T* hs_d = hs + static_cast<size_t>(d) * N * U;
  const float* dhp_d = dhp + static_cast<size_t>(d) * N * K;

  float acc[8][8] = {};
  tile_product(
      acc, (n_end - n_begin + kDepth - 1) / kDepth,
      [&](int ch, float (&r)[8]) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int n = n_begin + ch * kDepth + r0 + 2 * i;
          const int p = n < n_end ? prev_row(n, d, batch, N) : -1;
          r[i] = p >= 0 && u0 + c < U
                     ? to_f32(hs_d[static_cast<size_t>(p) * U + u0 + c])
                     : 0.0f;
        }
      },
      [&](int ch, float (&r)[8]) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int n = n_begin + ch * kDepth + r0 + 2 * i;
          r[i] = n < n_end && j0 + c < K
                     ? dhp_d[static_cast<size_t>(n) * K + j0 + c]
                     : 0.0f;
        }
      });
  float* out = part + (static_cast<size_t>(sl) * n_dirs + d) * U * K;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = j0 + 64 * h + 4 * tx;
    if (j >= K) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int u = u0 + tile_row(ty, i);
      if (u < U)
        *reinterpret_cast<float4*>(out + static_cast<size_t>(u) * K + j) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    }
  }
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

int tiles(int D, int U) {
  const int K = 3 * U;
  return D * ((U + kTile - 1) / kTile) * ((K + kTile - 1) / kTile);
}

// Row slices of pass 3 for N = T * B rows: about kTargetBlocks blocks, and
// at least four 16-row chunks a slice.
int reduce_slices(int D, int N, int U) {
  const int want = (kTargetBlocks + tiles(D, U) - 1) / tiles(D, U);
  const int most = (N + 4 * kDepth - 1) / (4 * kDepth);
  const int s = want < most ? want : most;
  return s < 1 ? 1 : s;
}

int rows_per_slice(int N, int slices) {
  const int rows = (N + slices - 1) / slices;
  return (rows + kDepth - 1) / kDepth * kDepth;
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

size_t workspace_floats(int D, int T_steps, int B, int U) {
  const int N = T_steps * B;
  return hp_floats(D, N, U) + hp_floats(D, B, U) +
         static_cast<size_t>(reduce_slices(D, N, U)) * D * U * 3 * U +
         stream_floats(D, B, U);
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
                   int variant, int cluster, int res_bt,
                   cudaStream_t stream) {
  const int K = 3 * U;
  const int N = T_steps * B;
  float* hp_dhp = workspace;
  float* dbias = hp_dhp + hp_floats(D, N, U);
  float* part = dbias + hp_floats(D, B, U);
  const bool streamed = variant == kNumVariants;
  const bool resident = variant > kNumVariants;
  if ((streamed || resident) != (U > kRegisterUnits) ||
      variant > kNumVariants + kNumResident)
    return cudaErrorInvalidValue;

  gru_bwd_hp_kernel<T><<<dim3((K + kTile - 1) / kTile, (N + kTile - 1) / kTile,
                              D),
                         kGemmThreads, 0, stream>>>(
      static_cast<const T*>(hs), rk, rb, hp_dhp, T_steps, B, U);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int slices = reduce_slices(D, N, U);
  if (resident) {
    err = variant == kNumVariants + 1
              ? launch_res<0, T>(xp, rk, hs, g, dxp, hp_dhp, dbias, D,
                                 T_steps, B, U, cluster, res_bt, stream)
              : launch_res<1, T>(xp, rk, hs, g, dxp, hp_dhp, dbias, D,
                                 T_steps, B, U, cluster, res_bt, stream);
  } else if (streamed) {
    float* carry = part + static_cast<size_t>(slices) * D * U * K;
    err = launch_stream<T>(xp, rk, hs, g, dxp, hp_dhp, dbias, carry,
                           carry + static_cast<size_t>(D) * B * U, D, T_steps,
                           B, U, cluster, stream);
  } else {
    err = dispatch_rec<T>(variant, xp, rk, hs, g, dxp, hp_dhp, dbias, D,
                          T_steps, B, U, cluster, stream);
  }
  if (err != cudaSuccess) return err;
  // a valid variant: it launched
  const int bt = resident ? res_bt
                 : streamed ? kStreamBT : kVariants[variant].bt;

  const dim3 grid((K + kTile - 1) / kTile, (U + kTile - 1) / kTile,
                  D * slices);
  gru_bwd_drk_kernel<T><<<grid, kGemmThreads, 0, stream>>>(
      static_cast<const T*>(hs), hp_dhp, part, D, T_steps, B, U,
      rows_per_slice(N, slices));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t total = static_cast<size_t>(D) * (U + 1) * K;
  const unsigned fin_blocks = static_cast<unsigned>((total + 255) / 256);
  gru_bwd_finalize_kernel<<<fin_blocks, 256, 0, stream>>>(
      part, dbias, drk, drb, slices, D, (B + bt - 1) / bt, U);
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

// Bytes of scratch one call needs (hp/dhp and pass 3's partials); the
// wrapper allocates them as one flat buffer, whose layout is this file's.
size_t seld_gru_bwd_workspace_bytes(int D, int T_steps, int B, int U) {
  return sizeof(float) * workspace_floats(D, T_steps, B, U);
}

// Returns a cudaError_t (0 on success). is_bf16 selects the storage type of
// x_proj, hs, g and dx_proj; rk, rb, drk and drb are f32; workspace holds
// seld_gru_bwd_workspace_bytes(D, T_steps, B, U) bytes; variant, cluster
// and bt (the resident recurrence's tile rows) come from the wrapper's plan
// (variant kNumVariants is the streamed recurrence, kNumVariants + 1 + i
// resident variant i; both only past U = 256).
int seld_gru_bwd(const void* xp, const void* rk, const void* rb,
                 const void* hs, const void* g, void* dxp, void* workspace,
                 void* drk, void* drb, int D, int T_steps, int B, int U,
                 int is_bf16, int variant, int cluster, int bt,
                 void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* rkf = static_cast<const float*>(rk);
  const auto* rbf = static_cast<const float*>(rb);
  auto* ws = static_cast<float*>(workspace);
  auto* drkf = static_cast<float*>(drk);
  auto* drbf = static_cast<float*>(drb);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(xp, rkf, rbf, hs, g, dxp, ws, drkf,
                                      drbf, D, T_steps, B, U, variant,
                                      cluster, bt, st)
              : launch<float>(xp, rkf, rbf, hs, g, dxp, ws, drkf, drbf, D,
                              T_steps, B, U, variant, cluster, bt, st);
  return static_cast<int>(err);
}

const char* seld_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
