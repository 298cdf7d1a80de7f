// Row-wise minimum squared distance with AABB tile pruning (kernel K1).
//
// Replaces seevcn_tpu/ops/pallas/min_dist.py:_make_kernel_diff_pruned.
// For each query row a_i: min over support rows b_j of
// ((ax-bx)^2 + (ay-by)^2) + (az-bz)^2, skipping every support tile whose
// AABB lies farther than r from the query tile's AABB. Rows whose every
// tile was skipped read 1e18. Exact where the true minimum is <= r^2 and
// never below the truth elsewhere.
//
// What bounds it on an H100: FP32 CUDA-core arithmetic, about 9 operations
// (3 sub, 3 mul, 2 add, 1 min) for each query-support pair left unpruned.
// The bytes are negligible: N*12 + M*12 read and N*4 written.
//
// What the design does about that: the TPU kernel carried its running
// minimum from one grid step to the next along the sequential support axis;
// here one block owns one query tile and loops over the support tiles
// itself, so the minimum stays in a register for the whole sweep and the
// output is written once. The pruning test runs once per (query tile,
// support tile) pair and is uniform across the block, so a pruned tile costs
// no load and no arithmetic. An unpruned tile is staged once in shared
// memory (coalesced loads) and every thread reads each support point as a
// broadcast, which leaves the FP32 pipes as the limit. The products and sums
// are rounded separately (no FMA contraction), in the order of the plain
// PyTorch version, so the two agree bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int TQ = 128;    // query rows per block, one per thread
constexpr int TS = 1024;   // support rows per shared-memory tile
constexpr float kInit = 1e18f;

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(TQ)
min_sqdist_pruned_kernel(const float* __restrict__ a, const float* __restrict__ b,
                         const float* __restrict__ bbox, int n, int m, float r2,
                         float* __restrict__ out) {
  __shared__ float sb[TS * 3];
  __shared__ float part[6][TQ / 32];
  __shared__ float abox[6];

  const int tid = threadIdx.x;
  const long long i = static_cast<long long>(blockIdx.x) * TQ + tid;
  const bool real = i < n;
  const float ax = real ? a[3 * i + 0] : 0.f;
  const float ay = real ? a[3 * i + 1] : 0.f;
  const float az = real ? a[3 * i + 2] : 0.f;

  // the query tile's AABB over its real rows: padding never widens it
  const float inf = __int_as_float(0x7f800000);
  float v[6] = {real ? ax : inf, real ? ay : inf, real ? az : inf,
                real ? ax : -inf, real ? ay : -inf, real ? az : -inf};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    v[c] = warp_min(v[c]);
    v[3 + c] = warp_max(v[3 + c]);
  }
  if ((tid & 31) == 0) {
#pragma unroll
    for (int c = 0; c < 6; ++c) part[c][tid >> 5] = v[c];
  }
  __syncthreads();
  if (tid < 6) {
    float r = part[tid][0];
    for (int w = 1; w < TQ / 32; ++w)
      r = tid < 3 ? fminf(r, part[tid][w]) : fmaxf(r, part[tid][w]);
    abox[tid] = r;
  }
  __syncthreads();

  float best = kInit;
  const int tiles = (m + TS - 1) / TS;
  for (int t = 0; t < tiles; ++t) {
    const float* bb = bbox + 6 * t;
    float gap2 = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float g = fmaxf(fmaxf(abox[c] - bb[3 + c], bb[c] - abox[3 + c]), 0.f);
      gap2 = __fadd_rn(gap2, __fmul_rn(g, g));
    }
    if (!(gap2 <= r2)) continue;  // same value in every thread: uniform branch

    const long long base = static_cast<long long>(t) * TS;
    const int cnt = min(TS, static_cast<int>(m - base));
    __syncthreads();  // the previous tile's readers are done
    for (int k = tid; k < 3 * cnt; k += TQ) sb[k] = b[3 * base + k];
    __syncthreads();
    if (real) {
      for (int k = 0; k < cnt; ++k) {
        const float dx = __fsub_rn(ax, sb[3 * k + 0]);
        const float dy = __fsub_rn(ay, sb[3 * k + 1]);
        const float dz = __fsub_rn(az, sb[3 * k + 2]);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        best = fminf(best, d);
      }
    }
  }
  if (real) out[i] = best;
}

// Row-wise minimum squared distance, exact difference form, no pruning
// (kernel K2).
//
// Replaces seevcn_tpu/ops/pallas/min_dist.py:_kernel_diff. For each query
// row a_i: min over all support rows b_j of ((ax-bx)^2 + (ay-by)^2) +
// (az-bz)^2. The wrapper has already pushed invalid support rows to 1e9, so
// they never win unless no row is valid, where the row reads about 3e18, as
// the TPU kernel's does.
//
// What bounds it on an H100: FP32 CUDA-core arithmetic, 9 operations (3 sub,
// 3 mul, 2 add, 1 min) for every query-support pair, N*M pairs in all; the
// bytes (12 per row read, 4 per query written) are negligible.
//
// What the design does about that: as in K1, one block owns a query tile and
// sweeps every support tile itself (the TPU kernel carried the running
// minimum across its sequential support axis; CUDA blocks run in no order),
// so the minimum stays in a register. Each support tile is staged once in
// shared memory as float4 (x, y, z, 0), so one 16-byte broadcast load feeds
// the 9 operations of a pair. Products and sums are rounded separately (no
// FMA), in the order of the plain PyTorch version, so the two agree bit for
// bit.
__global__ void __launch_bounds__(TQ)
min_sqdist_diff_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       int n, int m, float* __restrict__ out) {
  __shared__ float4 sb[TS];

  const int tid = threadIdx.x;
  const long long i = static_cast<long long>(blockIdx.x) * TQ + tid;
  const bool real = i < n;
  const float ax = real ? a[3 * i + 0] : 0.f;
  const float ay = real ? a[3 * i + 1] : 0.f;
  const float az = real ? a[3 * i + 2] : 0.f;

  float best = __int_as_float(0x7f800000);
  for (long long base = 0; base < m; base += TS) {
    const int cnt = min(TS, static_cast<int>(m - base));
    __syncthreads();  // the previous tile's readers are done
    for (int k = tid; k < cnt; k += TQ) {
      const float* p = b + 3 * (base + k);
      sb[k] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < cnt; ++k) {
      const float4 s = sb[k];
      const float dx = __fsub_rn(ax, s.x);
      const float dy = __fsub_rn(ay, s.y);
      const float dz = __fsub_rn(az, s.z);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      best = fminf(best, d);
    }
  }
  if (real) out[i] = best;
}

// Row-wise minimum squared distance, Gram form (kernel K3).
//
// Replaces seevcn_tpu/ops/pallas/min_dist.py:_kernel_gram. For each query
// row: min over support rows of max(|a|^2 - 2 a.b + |b|^2, 0). The wrapper
// has centred both sets on the mean of the valid support rows and pushed the
// invalid rows to 1e9, as the TPU wrapper does.
//
// What bounds it on an H100: FP32 CUDA-core arithmetic, 10 operations a pair
// (3 mul and 2 add for a.b, the doubling, 1 sub, 1 add, 1 max, 1 min); bytes
// are negligible, as for K2. The depth-3 product is done on the FP32 cores:
// TF32 tensor cores would round the cross term to 10 bits of mantissa,
// which the cancellation at lidar ranges does not survive, and a K = 3
// product cannot fill them anyway.
//
// What the design does about that: the loop of K2, with |b|^2 computed once
// per support row while the tile is staged (float4 (x, y, z, |b|^2)) and
// |a|^2 once per thread, so a pair costs one 16-byte broadcast load and the
// 10 operations. Rounding is explicit, in the plain version's order, so the
// kernel and min_sqdist_gram_plain agree bit for bit.
__global__ void __launch_bounds__(TQ)
min_sqdist_gram_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       int n, int m, float* __restrict__ out) {
  __shared__ float4 sb[TS];

  const int tid = threadIdx.x;
  const long long i = static_cast<long long>(blockIdx.x) * TQ + tid;
  const bool real = i < n;
  const float ax = real ? a[3 * i + 0] : 0.f;
  const float ay = real ? a[3 * i + 1] : 0.f;
  const float az = real ? a[3 * i + 2] : 0.f;
  const float a2 = __fadd_rn(__fadd_rn(__fmul_rn(ax, ax), __fmul_rn(ay, ay)),
                             __fmul_rn(az, az));

  float best = __int_as_float(0x7f800000);
  for (long long base = 0; base < m; base += TS) {
    const int cnt = min(TS, static_cast<int>(m - base));
    __syncthreads();
    for (int k = tid; k < cnt; k += TQ) {
      const float* p = b + 3 * (base + k);
      const float bx = p[0], by = p[1], bz = p[2];
      const float b2 = __fadd_rn(__fadd_rn(__fmul_rn(bx, bx), __fmul_rn(by, by)),
                                 __fmul_rn(bz, bz));
      sb[k] = make_float4(bx, by, bz, b2);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < cnt; ++k) {
      const float4 s = sb[k];
      const float ab = __fadd_rn(__fadd_rn(__fmul_rn(ax, s.x), __fmul_rn(ay, s.y)),
                                 __fmul_rn(az, s.z));
      const float d = __fadd_rn(__fsub_rn(a2, __fmul_rn(2.f, ab)), s.w);
      best = fminf(best, fmaxf(d, 0.f));
    }
  }
  if (real) out[i] = best;
}

}  // namespace

// a (n, 3), b (m, 3) with m >= 1, out (n,): contiguous f32 on the current
// device. Launch on `stream`, allocate nothing, return cudaGetLastError().
extern "C" int min_sqdist_diff(const float* a, const float* b, int n, int m,
                               float* out, void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + TQ - 1) / TQ);
  min_sqdist_diff_kernel<<<blocks, TQ, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, n, m, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int min_sqdist_gram(const float* a, const float* b, int n, int m,
                               float* out, void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + TQ - 1) / TQ);
  min_sqdist_gram_kernel<<<blocks, TQ, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, n, m, out);
  return static_cast<int>(cudaGetLastError());
}

// a (n, 3), b (m, 3), bbox (ceil(m / TS), 6) [min xyz, max xyz] per support
// tile, out (n,): all contiguous f32 on the current device. Launches on
// `stream`, allocates nothing, and returns cudaGetLastError() after the launch.
extern "C" int min_sqdist_pruned(const float* a, const float* b, const float* bbox,
                                 int n, int m, float r2, float* out, void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + TQ - 1) / TQ);
  min_sqdist_pruned_kernel<<<blocks, TQ, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, bbox, n, m, r2, out);
  return static_cast<int>(cudaGetLastError());
}
