// Row-wise minimum squared distance with AABB pruning (kernel K1).
//
// Replaces seevcn_tpu/ops/pallas/min_dist.py:_make_kernel_diff_pruned.
// For each query row a_i: min over support rows b_j of
// ((ax-bx)^2 + (ay-by)^2) + (az-bz)^2, skipping every support block whose
// box lies farther than r from the row. Rows that no box is near read 1e18.
// Exact where the true minimum is <= r^2 and never below the truth
// elsewhere. Invalid support rows never win and never widen a box.
//
// What bounds it on an H100: FP32 CUDA-core arithmetic, 9 operations (3 sub,
// 3 mul, 2 add, 1 min) for each query-support pair that has to be looked at,
// which at the SEE frame's replacement inputs is a few million pairs; the
// bytes (N*12 + M*12 read, N*4 written) are negligible. So the real limits
// are keeping the 132 SMs busy and not sweeping pairs that cannot matter.
//
// What the design does about that. The route is one call from the host
// (a launch costs the host more than most of these kernels cost the card),
// which makes one memset and five launches on one stream:
//   1. k1_support_prepare, one 1024-thread block per 1024-row support tile:
//      writes the support as float4 (x, y, z, 0) with invalid and padding
//      rows at 1e9, the box of each 32-row sub-tile over its valid rows, and
//      the box of each tile (an empty one is (+inf, -inf)).
//   2-4. a stable counting sort of the query rows by key, so that the rows
//      near one car sit next to each other:
//      2. k1_query_keys, one thread a row in blocks of 256 rows: each row's
//         key, the index of the first tile whose box lies within r of it, or
//         the tile count ("none") where there is no such tile; a block radix
//         sort (CUB's block-level primitive) gives each row its rank among
//         the block's rows of the same key, and the block's count of each
//         key goes to a (key, block) table;
//      3. k1_offsets, one block: the exclusive scan of that table, key-major,
//         which is each (key, block)'s first place in the order;
//      4. k1_scatter, one thread a row: perm[place + rank] = row.
//      It gives the order torch.argsort(keys, stable=True) gives.
//   5. k1_sweep, one block of K1_WARPS warps per 32 ordered rows: every
//      warp holds the same 32 rows, one a lane, and takes every K1_WARPS-th
//      sub-tile. For each tile, then each of its sub-tiles if the tile
//      passes, every lane tests its own row against the box and a
//      __ballot_sync sweeps the sub-tile if any lane needs it, so the branch
//      is uniform across the warp. Rows near one car sweep that car's
//      sub-tiles and skip the rest; a block whose rows are all "none" sweeps
//      nothing. The warps' minima meet in shared memory and each result is
//      written straight to the row's original position. The rows that have
//      a key fill only a few hundred groups, so one warp a group would leave
//      the card latency-bound on a fraction of its SMs; 16 warps a group put
//      about 32 warps on each SM.
//      A sub-tile is read as 32 float4 broadcast loads from a per-warp copy
//      in shared memory, which measured faster than the same loads straight
//      from L1/L2 (PERF.md).
// Products and sums are rounded separately (no FMA contraction), in the
// order of the plain PyTorch version, so every swept pair gives the plain
// version's value bit for bit; the box tests round the same way, so a box's
// gap never exceeds the distance to any point inside it.
#include <cuda_runtime.h>

#include <algorithm>

#include <cub/block/block_discontinuity.cuh>
#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int TS = 1024;   // support rows per tile (K1, K3)
constexpr int SUB = 32;    // K1: support rows per sub-tile (one box each)
constexpr int K1_WARPS = 16;  // K1: warps per sweep block, sharing its 32 rows
constexpr int KEY_THREADS = 256;  // K1's sort: threads per block
constexpr int KEY_ITEMS = 1;      // K1's sort: rows per thread
constexpr int KEY_ROWS = KEY_THREADS * KEY_ITEMS;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInit = 1e18f;
constexpr float kFar = 1e9f;

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// squared gap between a point and a box [min xyz, max xyz], rounded in the
// order of min_dist.py:box_gap2
__device__ __forceinline__ float box_gap2(float ax, float ay, float az,
                                          const float* __restrict__ box) {
  const float p[3] = {ax, ay, az};
  float gap2 = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float g = fmaxf(fmaxf(__fsub_rn(__ldg(box + c), p[c]),
                                __fsub_rn(p[c], __ldg(box + 3 + c))), 0.f);
    gap2 = __fadd_rn(gap2, __fmul_rn(g, g));
  }
  return gap2;
}

__device__ __forceinline__ float diff_sqdist(float ax, float ay, float az, float4 s) {
  const float dx = __fsub_rn(ax, s.x);
  const float dy = __fsub_rn(ay, s.y);
  const float dz = __fsub_rn(az, s.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__global__ void __launch_bounds__(TS)
k1_support_prepare(const float* __restrict__ b, const unsigned char* __restrict__ valid,
                   int m, float4* __restrict__ b4, float* __restrict__ sub_box,
                   float* __restrict__ tile_box) {
  __shared__ float part[6][TS / SUB];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const long long j = static_cast<long long>(blockIdx.x) * TS + tid;
  const bool ok = j < m && (valid == nullptr || valid[j]);
  const float x = ok ? b[3 * j + 0] : kFar;
  const float y = ok ? b[3 * j + 1] : kFar;
  const float z = ok ? b[3 * j + 2] : kFar;
  const long long s = j / SUB;
  const bool has_sub = s < (static_cast<long long>(m) + SUB - 1) / SUB;
  if (has_sub) b4[j] = make_float4(x, y, z, 0.f);  // padded to whole sub-tiles

  const float inf = __int_as_float(0x7f800000);
  float v[6] = {ok ? x : inf, ok ? y : inf, ok ? z : inf,
                ok ? x : -inf, ok ? y : -inf, ok ? z : -inf};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    v[c] = warp_min(v[c]);
    v[3 + c] = warp_max(v[3 + c]);
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      if (has_sub) sub_box[6 * s + c] = v[c];
      part[c][w] = v[c];
    }
  }
  __syncthreads();
  if (tid < 6) {
    float r = part[tid][0];
    for (int k = 1; k < TS / SUB; ++k)
      r = tid < 3 ? fminf(r, part[tid][k]) : fmaxf(r, part[tid][k]);
    tile_box[6 * blockIdx.x + tid] = r;
  }
}

struct NotEqual {
  __device__ bool operator()(unsigned x, unsigned y) const { return x != y; }
};

struct MaxOp {
  __device__ int operator()(int x, int y) const { return x > y ? x : y; }
};

__global__ void __launch_bounds__(KEY_THREADS)
k1_query_keys(const float* __restrict__ a, const float* __restrict__ tile_box, int n,
              int tiles, float r2, int nblk, int* __restrict__ keys,
              int* __restrict__ rank, int* __restrict__ hist) {
  using Sort = cub::BlockRadixSort<unsigned, KEY_THREADS, KEY_ITEMS, int>;
  using Disc = cub::BlockDiscontinuity<unsigned, KEY_THREADS>;
  using Scan = cub::BlockScan<int, KEY_THREADS>;
  __shared__ union {
    typename Sort::TempStorage sort;
    typename Disc::TempStorage disc;
    typename Scan::TempStorage scan;
  } tmp;

  const long long base = static_cast<long long>(blockIdx.x) * KEY_ROWS;
  unsigned k[KEY_ITEMS];
  int local[KEY_ITEMS];
#pragma unroll
  for (int q = 0; q < KEY_ITEMS; ++q) {
    local[q] = threadIdx.x * KEY_ITEMS + q;
    const long long i = base + local[q];
    int key = tiles + 1;  // past the end: sorts last, counted nowhere
    if (i < n) {
      const float ax = a[3 * i + 0], ay = a[3 * i + 1], az = a[3 * i + 2];
      key = tiles;
      for (int t = 0; t < tiles; ++t) {
        if (box_gap2(ax, ay, az, tile_box + 6 * t) <= r2) {
          key = t;
          break;
        }
      }
      keys[i] = key;
    }
    k[q] = static_cast<unsigned>(key);
  }
  // stable within the block: the rows keep their order among equal keys
  Sort(tmp.sort).Sort(k, local, 0, 32 - __clz(tiles + 1));
  __syncthreads();
  int head[KEY_ITEMS], tail[KEY_ITEMS];
  Disc(tmp.disc).FlagHeadsAndTails(head, tail, k, NotEqual());
  __syncthreads();
  int first[KEY_ITEMS];  // the sorted place of each key's first row
#pragma unroll
  for (int q = 0; q < KEY_ITEMS; ++q)
    first[q] = head[q] ? static_cast<int>(threadIdx.x) * KEY_ITEMS + q : 0;
  Scan(tmp.scan).InclusiveScan(first, first, MaxOp());
#pragma unroll
  for (int q = 0; q < KEY_ITEMS; ++q) {
    if (k[q] > static_cast<unsigned>(tiles)) continue;
    const int r = static_cast<int>(threadIdx.x) * KEY_ITEMS + q - first[q];
    rank[base + local[q]] = r;
    if (tail[q]) hist[static_cast<long long>(k[q]) * nblk + blockIdx.x] = r + 1;
  }
}

__global__ void __launch_bounds__(1024) k1_offsets(int* __restrict__ hist, int len) {
  using Scan = cub::BlockScan<int, 1024>;
  __shared__ typename Scan::TempStorage tmp;
  int carry = 0;
  for (int base = 0; base < len; base += 1024) {
    const int j = base + threadIdx.x;
    int x = j < len ? hist[j] : 0, before, total;
    Scan(tmp).ExclusiveSum(x, before, total);
    if (j < len) hist[j] = carry + before;
    carry += total;
    __syncthreads();
  }
}

__global__ void k1_scatter(const int* __restrict__ keys, const int* __restrict__ rank,
                           const int* __restrict__ offsets, int n, int nblk,
                           int* __restrict__ perm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  perm[offsets[static_cast<long long>(keys[i]) * nblk + i / KEY_ROWS] + rank[i]] = i;
}

__global__ void __launch_bounds__(32 * K1_WARPS)
k1_sweep(const float* __restrict__ a, const float4* __restrict__ b4,
         const float* __restrict__ sub_box, const float* __restrict__ tile_box,
         const int* __restrict__ keys, const int* __restrict__ perm, int n,
         int m, float r2, float* __restrict__ out) {
  __shared__ float4 sb[K1_WARPS][SUB];
  __shared__ float part[K1_WARPS][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long slot = static_cast<long long>(blockIdx.x) * 32 + lane;
  const bool real = slot < n;
  const long long i = real ? perm[slot] : 0;  // the row in its original place
  const int tiles = (m + TS - 1) / TS;
  const int nsub = (m + SUB - 1) / SUB;
  const int key = real ? keys[i] : tiles;
  const bool live = key < tiles;
  const float ax = live ? a[3 * i + 0] : 0.f;
  const float ay = live ? a[3 * i + 1] : 0.f;
  const float az = live ? a[3 * i + 2] : 0.f;

  // no tile before the warp's smallest key is near any of its rows
  const int first = __reduce_min_sync(kFull, key);
  float best0 = kInit, best1 = kInit;
  for (int t = first; t < tiles; ++t) {
    const bool near_t = live && box_gap2(ax, ay, az, tile_box + 6 * t) <= r2;
    if (!__ballot_sync(kFull, near_t)) continue;
    const int s_end = min(nsub, (t + 1) * (TS / SUB));
    for (int s = t * (TS / SUB) + w; s < s_end; s += K1_WARPS) {
      const bool near_s = near_t && box_gap2(ax, ay, az, sub_box + 6 * s) <= r2;
      if (!__ballot_sync(kFull, near_s)) continue;
      __syncwarp();  // the previous sub-tile's readers are done
      sb[w][lane] = __ldg(b4 + static_cast<long long>(s) * SUB + lane);
      __syncwarp();
#pragma unroll
      for (int k = 0; k < SUB; k += 2) {
        best0 = fminf(best0, diff_sqdist(ax, ay, az, sb[w][k]));
        best1 = fminf(best1, diff_sqdist(ax, ay, az, sb[w][k + 1]));
      }
    }
  }
  part[w][lane] = fminf(best0, best1);
  __syncthreads();
  if (w == 0 && real) {
    float best = part[0][lane];
#pragma unroll
    for (int k = 1; k < K1_WARPS; ++k) best = fminf(best, part[k][lane]);
    out[i] = live ? best : kInit;
  }
}

// Row-wise minimum squared distance, exact difference form, no pruning
// (kernel K2).
//
// Replaces seevcn_tpu/ops/pallas/min_dist.py:_kernel_diff. For each query
// row a_i: min over all support rows b_j of ((ax-bx)^2 + (ay-by)^2) +
// (az-bz)^2, each product and sum rounded on its own (no FMA), in that
// order, so the result is min_sqdist_plain's bit for bit. The wrapper has
// already pushed invalid support rows to 1e9, so they never win unless no
// row is valid, where the row reads about 3e18, as the TPU kernel's does.
//
// What bounds it on an H100: instruction issue. A pair costs 8 FP32
// instructions that may not be fused (3 sub, 3 mul, 2 add) and a share of a
// min and of a shared-memory load; each of the 132 x 4 schedulers issues one
// warp-instruction a clock. The bytes (12 per row read, 4 per query
// written) are negligible.
//
// What the design does about that. Two launches from one host call:
//   1. k2_prepare writes the support as float4 (x, y, z, 0), padded to whole
//      K2_TILE-row tiles with copies of the last row, and sets every output
//      to +inf's bits. A copy of a row never changes a min; a padding row at
//      1e9, as the TPU wrapper pads, would read 0 for a query row at 1e9.
//   2. k2_sweep. Each thread keeps K2_ROWS = 8 query rows in registers, so
//      one 16-byte broadcast load from shared memory feeds 8 pairs. Every
//      distance is >= +0 (or +inf), so its bits order as a signed int, and
//      __vimin3_s32 takes the min of two pairs in one step, exactly: ptxas
//      makes it one VIMNMX3, which issues in one slot among the FP32
//      instructions, as an FMNMX does. The work is cut into units of
//      (K2_GROUP query rows, one support tile); the grid holds as many
//      blocks as the card runs at once, and each block sweeps a contiguous
//      run of units, the runs within one unit of each other, so the SMs get
//      even shares of the pairs in one wave. A block's minima go to the
//      output by atomicMin on the bits when its run leaves a row group: a
//      min is order-free, so every run gives the same bits. Each tile is one
//      contiguous 8 KB cp.async copy, double-buffered.
//   At N = 150,000, M = 32,768: 147 row groups x 64 tiles = 9,408 units on
//   132 SMs x 9 blocks of 128 threads (56 registers a thread leave room for
//   9), 7 or 8 units a block. The inner loop issues 557 instructions for 64
//   pairs a thread (320 FADD, 192 FMUL, 32 VIMNMX3, 8 LDS.128, 5 of loop
//   control): 8.70 slots per 32 pairs, a floor of 1.279 ms at 1980 MHz.
//   Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
//   limit: 1.39 ms a call back to back at 1980 MHz, 92% of that floor and
//   48% of the 9-operations-a-pair bound (0.6603 ms); the design before it
//   took 1.90 ms on the same card. A fixed grid of (row group) x (8-tile
//   chunk), 1,176 blocks that each flush once and need no occupancy query,
//   measured 0.5% slower in the same call, so the one wave stays.
constexpr int K2_THREADS = 128;
constexpr int K2_ROWS = 8;
constexpr int K2_GROUP = K2_THREADS * K2_ROWS;  // query rows of a unit
constexpr int K2_TILE = 512;                    // support rows of a unit
constexpr int kInfBits = 0x7f800000;

__global__ void k2_prepare(const float* __restrict__ b, int m, int m_pad, int n,
                           float4* __restrict__ b4, int* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < m_pad) {
    const long long s = min(j, m - 1);
    b4[j] = make_float4(b[3 * s + 0], b[3 * s + 1], b[3 * s + 2], 0.f);
  }
  if (j < n) out[j] = kInfBits;
}

// K2, K3: one tile of ROWS float4 rows into shared memory by a block of
// THREADS threads with cp.async, as one commit group
template <int THREADS, int ROWS>
__device__ __forceinline__ void copy_tile(float4* dst, const float4* src) {
#pragma unroll
  for (int k = threadIdx.x; k < ROWS; k += THREADS) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + k));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src + k));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(K2_THREADS)
k2_sweep(const float* __restrict__ a, const float4* __restrict__ b4, int n, int tiles,
         long long units, int* __restrict__ out) {
  __shared__ __align__(16) float4 sb[2][K2_TILE];

  const long long per = units / gridDim.x, extra = units % gridDim.x;
  const long long u0 = blockIdx.x * per + min(static_cast<long long>(blockIdx.x), extra);
  const long long u1 = u0 + per + (blockIdx.x < extra ? 1 : 0);
  float ax[K2_ROWS], ay[K2_ROWS], az[K2_ROWS];
  int best[K2_ROWS];
  auto load_rows = [&](long long g) {
#pragma unroll
    for (int r = 0; r < K2_ROWS; ++r) {
      const long long i = g * K2_GROUP + r * K2_THREADS + threadIdx.x;
      const bool real = i < n;
      ax[r] = real ? a[3 * i + 0] : 0.f;
      ay[r] = real ? a[3 * i + 1] : 0.f;
      az[r] = real ? a[3 * i + 2] : 0.f;
      best[r] = kInfBits;
    }
  };
  auto flush_rows = [&](long long g) {
#pragma unroll
    for (int r = 0; r < K2_ROWS; ++r) {
      const long long i = g * K2_GROUP + r * K2_THREADS + threadIdx.x;
      if (i < n) atomicMin(out + i, best[r]);
    }
  };

  long long group = u0 / tiles;
  load_rows(group);
  copy_tile<K2_THREADS, K2_TILE>(sb[0], b4 + (u0 % tiles) * K2_TILE);
  for (long long u = u0; u < u1; ++u) {
    const int buf = static_cast<int>((u - u0) & 1);
    if (u + 1 < u1) {
      // buffer buf ^ 1 was last read in the previous unit, which ended in a barrier
      copy_tile<K2_THREADS, K2_TILE>(sb[buf ^ 1], b4 + ((u + 1) % tiles) * K2_TILE);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // unit u's tile has landed for every thread
    if (u / tiles != group) {
      flush_rows(group);
      group = u / tiles;
      load_rows(group);
    }
    const float4* tile = sb[buf];
#pragma unroll 4
    for (int k = 0; k < K2_TILE; k += 2) {
      const float4 s0 = tile[k], s1 = tile[k + 1];
#pragma unroll
      for (int r = 0; r < K2_ROWS; ++r)
        best[r] = __vimin3_s32(best[r],
                               __float_as_int(diff_sqdist(ax[r], ay[r], az[r], s0)),
                               __float_as_int(diff_sqdist(ax[r], ay[r], az[r], s1)));
    }
    __syncthreads();  // every thread is done with this tile before it is overwritten
  }
  flush_rows(group);
}

// Row-wise minimum squared distance, Gram form (kernel K3).
//
// Replaces seevcn_tpu/ops/pallas/min_dist.py:_kernel_gram. For each query
// row: min over support rows of max(|a|^2 - 2 a.b + |b|^2, 0). The wrapper
// has centred both sets on the mean of the valid support rows and pushed the
// invalid rows to 1e9, as the TPU wrapper does.
//
// What bounds it on an H100: FP32 issue slots on the CUDA cores, N*M pairs.
// The depth-3 product stays in FP32 on the CUDA cores: TF32 tensor cores
// would round the cross term to 10 bits of mantissa, which the cancellation
// at lidar ranges does not survive. The bytes are negligible.
//
// What the design does about that: the function is rewritten as
// max(|a|^2 + min_j e_j, 0) with e_j = |b_j|^2 - 2 a.b_j. Adding |a|^2 and
// clamping at 0 are monotone under round-to-nearest, so they commute with
// the min and are done once per row after the sweep. Two launches:
//   1. k3_support_prepare writes the support as float4 (x, y, z, |b|^2),
//      padded to whole tiles with rows at 1e9, so a tile is one contiguous
//      16 KB copy and |b|^2 is computed once per support row, not once per
//      block.
//   2. min_sqdist_gram_kernel: each thread keeps (-2ax, -2ay, -2az) of
//      K3_ROWS query rows in registers, and a pair costs 3 FFMA
//      (e = fma(-2az, bz, fma(-2ay, by, fma(-2ax, bx, |b|^2)))) and one min,
//      one 16-byte broadcast load from shared memory feeding K3_ROWS pairs.
//      The next tile is copied into a second shared buffer with cp.async
//      while this one is swept. Blocks of 64 threads (256 rows) give 586
//      blocks at N = 150,000, which spread over the 132 SMs within 11% of
//      even.
// The kernel fuses the multiply-adds, so it agrees with
// min_sqdist_gram_plain (the same e, separately rounded) to the reference's
// Gram tolerance, not bit for bit.
constexpr int K3_THREADS = 64;
constexpr int K3_ROWS = 4;

__global__ void k3_support_prepare(const float* __restrict__ b, int m, int m_pad,
                                   float4* __restrict__ b4) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m_pad) return;
  const float bx = j < m ? b[3 * j + 0] : kFar;
  const float by = j < m ? b[3 * j + 1] : kFar;
  const float bz = j < m ? b[3 * j + 2] : kFar;
  const float b2 = __fadd_rn(__fadd_rn(__fmul_rn(bx, bx), __fmul_rn(by, by)),
                             __fmul_rn(bz, bz));
  b4[j] = make_float4(bx, by, bz, b2);
}

__global__ void __launch_bounds__(K3_THREADS)
min_sqdist_gram_kernel(const float* __restrict__ a, const float4* __restrict__ b4,
                       int n, int tiles, float* __restrict__ out) {
  __shared__ __align__(16) float4 sb[2][TS];

  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * K3_THREADS * K3_ROWS + tid;
  float nx[K3_ROWS], ny[K3_ROWS], nz[K3_ROWS], best[K3_ROWS];
#pragma unroll
  for (int r = 0; r < K3_ROWS; ++r) {
    const long long i = row0 + r * K3_THREADS;
    const bool real = i < n;
    nx[r] = real ? -2.f * a[3 * i + 0] : 0.f;  // exact: a power-of-two scale
    ny[r] = real ? -2.f * a[3 * i + 1] : 0.f;
    nz[r] = real ? -2.f * a[3 * i + 2] : 0.f;
    best[r] = __int_as_float(0x7f800000);
  }

  copy_tile<K3_THREADS, TS>(sb[0], b4);
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      // buffer (t + 1) & 1 was last read in step t - 1, which ended in a barrier
      copy_tile<K3_THREADS, TS>(sb[(t + 1) & 1], b4 + static_cast<long long>(t + 1) * TS);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // tile t has landed for every thread
    const float4* tile = sb[t & 1];
#pragma unroll 8
    for (int k = 0; k < TS; ++k) {
      const float4 s = tile[k];
#pragma unroll
      for (int r = 0; r < K3_ROWS; ++r)
        best[r] = fminf(best[r], fmaf(nz[r], s.z, fmaf(ny[r], s.y, fmaf(nx[r], s.x, s.w))));
    }
    __syncthreads();  // every thread is done with tile t before it is overwritten
  }
#pragma unroll
  for (int r = 0; r < K3_ROWS; ++r) {
    const long long i = row0 + r * K3_THREADS;
    if (i < n) {
      const float ax = a[3 * i + 0], ay = a[3 * i + 1], az = a[3 * i + 2];
      const float a2 = __fadd_rn(__fadd_rn(__fmul_rn(ax, ax), __fmul_rn(ay, ay)),
                                 __fmul_rn(az, az));
      out[i] = fmaxf(__fadd_rn(a2, best[r]), 0.f);
    }
  }
}

}  // namespace

// K2: a (n, 3), b (m, 3) with m >= 1, scratch b4 (ceil(m / 512) * 512, 4),
// out (n,): contiguous f32 on the current device. Two launches on `stream`;
// returns the first error.
extern "C" int min_sqdist_diff(const float* a, const float* b, int n, int m, float* b4,
                               float* out, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (m + K2_TILE - 1) / K2_TILE;
  float4* s4 = reinterpret_cast<float4*>(b4);
  int* bits = reinterpret_cast<int*>(out);
  const int len = std::max(n, tiles * K2_TILE);
  k2_prepare<<<(len + 255) / 256, 256, 0, st>>>(b, m, tiles * K2_TILE, n, s4, bits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k2_sweep, K2_THREADS, 0)) !=
          cudaSuccess)
    return static_cast<int>(e);
  const long long units = static_cast<long long>((n + K2_GROUP - 1) / K2_GROUP) * tiles;
  const long long blocks = std::min(units, static_cast<long long>(sms) * std::max(per_sm, 1));
  k2_sweep<<<static_cast<unsigned>(blocks), K2_THREADS, 0, st>>>(a, s4, n, tiles, units, bits);
  return static_cast<int>(cudaGetLastError());
}

// K3: a (n, 3), b (m, 3) with m >= 1, scratch b4 (ceil(m / 1024) * 1024, 4),
// out (n,): contiguous f32 on the current device. Two launches on `stream`;
// returns the first launch error.
extern "C" int min_sqdist_gram(const float* a, const float* b, int n, int m,
                               float* b4, float* out, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (m + TS - 1) / TS;
  float4* s4 = reinterpret_cast<float4*>(b4);
  k3_support_prepare<<<(tiles * TS + 255) / 256, 256, 0, st>>>(b, m, tiles * TS, s4);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows = K3_THREADS * K3_ROWS;
  const unsigned blocks = static_cast<unsigned>((n + rows - 1) / rows);
  min_sqdist_gram_kernel<<<blocks, K3_THREADS, 0, st>>>(a, s4, n, tiles, out);
  return static_cast<int>(cudaGetLastError());
}

// K1: a (n, 3), b (m, 3), valid (m,) bytes or null, out (n,); scratch that
// the wrapper lays out: b4 (ceil(m / 32) * 32, 4) and sub_box (ceil(m / 32),
// 6), tile_box (ceil(m / 1024), 6) f32; keys, rank, perm (n,) and hist
// ((ceil(m / 1024) + 1) * ceil(n / 1024),) int32. All contiguous on the
// current device. Returns the first launch error.
extern "C" int min_sqdist_pruned(const float* a, const float* b,
                                 const unsigned char* valid, int n, int m, float r2,
                                 float* b4, float* sub_box, float* tile_box,
                                 int* keys, int* rank, int* hist, int* perm, float* out,
                                 void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (m + TS - 1) / TS;
  const int nblk = (n + KEY_ROWS - 1) / KEY_ROWS;
  const int len = (tiles + 1) * nblk;
  cudaError_t e = cudaMemsetAsync(hist, 0, sizeof(int) * static_cast<size_t>(len), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (tiles > 0) {
    k1_support_prepare<<<tiles, TS, 0, st>>>(b, valid, m, reinterpret_cast<float4*>(b4),
                                             sub_box, tile_box);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  k1_query_keys<<<nblk, KEY_THREADS, 0, st>>>(a, tile_box, n, tiles, r2, nblk, keys, rank,
                                              hist);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  k1_offsets<<<1, 1024, 0, st>>>(hist, len);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  k1_scatter<<<(n + 255) / 256, 256, 0, st>>>(keys, rank, hist, n, nblk, perm);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = static_cast<unsigned>((n + 31) / 32);
  k1_sweep<<<blocks, 32 * K1_WARPS, 0, st>>>(a, reinterpret_cast<const float4*>(b4),
                                             sub_box, tile_box, keys, perm, n, m, r2, out);
  return static_cast<int>(cudaGetLastError());
}
