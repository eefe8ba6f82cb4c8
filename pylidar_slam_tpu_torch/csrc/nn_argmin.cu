// Exact brute-force 1-NN with a streaming (min, argmin) (kernel B2).
//
// Replaces pylidar_slam_tpu/ops/pallas/nn_kernel.py::nn_argmin_pallas, but
// follows the XLA path the JAX package runs off the TPU
// (ops/icp3d.py::brute_force_nn): the squared distance is the direct
// difference dx*dx + dy*dy + dz*dz, summed left to right, where the Pallas
// body expands ||m||^2 - 2 q.m + ||q||^2 on the MXU and rounds differently.
//
// For each of M queries: the index and squared distance of the nearest
// valid model point among V.  Invalid rows never win, the lowest index wins
// ties (the lexicographic minimum of (distance, index)), and a map with no
// valid row gives +inf and index 0.  M and V take any size.  Non-finite
// coordinates are outside the contract: the plain version's torch.min
// propagates a NaN distance, the fminf below drops it.
//
// What bounds it: the surfel champion compares M = 16,384 queries with
// V = 122,880 map points per pass, 2.0e9 pairs of 8 float32 operations
// (3 subtractions, 3 products, 2 adds) against ~2 MB of traffic: 1.6e10 FLOP
// is 0.24 ms at 67 TFLOP/s, the bytes 0.6 us at 3.35 TB/s, so it is
// compute-bound.  Compiled with --fmad=false so every product and sum rounds
// as the plain PyTorch version's separate kernels do; those 8 instructions
// each take an issue slot, which caps the kernel at half the FLOP roofline
// (0.48 ms on an H100 at 1.98 GHz).  The design spends as little as it can
// beside them:
//
//  * Register-blocked queries.  Each thread holds kQ queries, so one
//    shared-memory broadcast of a model point serves kQ pairs.
//  * A two-level argmin.  Within a sub-tile of kSub model points only the
//    minimum distance is kept (one fminf per pair, exact: it returns one of
//    its inputs).  After the sub-tile, a strict < against the running best
//    records the sub-tile's number.  The merge takes the splits in
//    ascending order with a strict <, which gives the first sub-tile at the
//    least distance, and scans that one sub-tile again for the first point
//    whose distance equals the best bit for bit (the same expression under
//    --fmad=false).  That is the lexicographic minimum of (distance, index)
//    that a strict < over ascending indices gives: a later sub-tile with an
//    equal minimum never wins, an all-+inf sub-tile never wins.
//  * Staging without branches, overlapped with compute.  A pre-pass writes
//    the model once per call as float4 (x, y, z, 0), with invalid rows and
//    the padding to a whole tile set to +inf (which never wins a strict <).
//    Tiles then stream into a double-buffered ring in shared memory by
//    cp.async, so the inner loop has no validity test and the next tile's
//    load overlaps this tile's compute.
//  * A grid that fills the card.  16,384 queries make only 16 blocks of
//    kQ * kThreads queries, so V is split over a second grid dimension into
//    ranges of whole tiles that differ by at most one tile.  The split
//    count balances the tiles each SM runs (nn_argmin_splits).  Each split
//    writes a partial (distance, sub-tile), so the result does not depend
//    on the split count.
//
// No atomics: two runs are bit-identical.  `active` (a device bool, or null
// for always) lets the caller skip a pass without a host sync: when it is
// false the pre-pass and every block of the partial pass return at once and
// the merge writes index 0 and +inf.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

// 8 queries per thread, 32-point sub-tiles and a 16-point unroll: on an
// H100 at the champion's shapes, the other combinations of 2-8 queries,
// 16-64 points and 8-32 unrolled that were tried ran at about the same
// speed or slower.
constexpr int kThreads = 128;
constexpr int kQ = 8;                         // queries per thread
constexpr int kBlockQueries = kThreads * kQ;
constexpr int kTile = 256;                    // model points per shared-memory stage
constexpr int kSub = 32;                      // model points per sub-tile of the argmin
constexpr int kUnroll = 16;                   // inner-loop unroll over a sub-tile
constexpr int kMinBlocksPerSm = 4;

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz, float4 c) {
  const float ex = qx - c.x, ey = qy - c.y, ez = qz - c.z;
  return ex * ex + ey * ey + ez * ez;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// The model as float4 rows, invalid rows and the padding up to `padded`
// rows set to +inf.
__global__ void __launch_bounds__(kThreads)
nn_pack_model(const float* __restrict__ model, const uint8_t* __restrict__ valid,
              const uint8_t* __restrict__ active, int v, int padded,
              float4* __restrict__ packed) {
  if (active != nullptr && *active == 0) return;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= padded) return;
  float4 p = make_float4(INFINITY, INFINITY, INFINITY, 0.0f);
  if (j < v && valid[j]) p = make_float4(model[3 * j], model[3 * j + 1], model[3 * j + 2], 0.0f);
  packed[j] = p;
}

__global__ void __launch_bounds__(kThreads)
nn_argmin_partials(const float* __restrict__ queries,
                   const float4* __restrict__ packed,
                   const uint8_t* __restrict__ active, int m, int tiles,
                   float* __restrict__ part_d, int* __restrict__ part_i) {
  if (active != nullptr && *active == 0) return;
  __shared__ __align__(16) float4 ring[2][kTile];
  // split s takes tiles [s * tiles / splits, (s + 1) * tiles / splits)
  const int split = blockIdx.y, splits = gridDim.y;
  const int t_begin = static_cast<int>(static_cast<long>(split) * tiles / splits);
  const int t_end = static_cast<int>(static_cast<long>(split + 1) * tiles / splits);
  const int q0 = blockIdx.x * kBlockQueries + threadIdx.x;

  float qx[kQ], qy[kQ], qz[kQ], best[kQ];
  int best_sub[kQ];
#pragma unroll
  for (int a = 0; a < kQ; ++a) {
    const int qi = q0 + a * kThreads;
    qx[a] = qy[a] = qz[a] = 0.0f;
    if (qi < m) {
      qx[a] = queries[3 * qi];
      qy[a] = queries[3 * qi + 1];
      qz[a] = queries[3 * qi + 2];
    }
    best[a] = INFINITY;
    best_sub[a] = -1;
  }

  auto stage = [&](int buf, int t) {
    const float4* src = packed + static_cast<size_t>(t) * kTile;
    for (int k = threadIdx.x; k < kTile; k += kThreads) cp_async16(&ring[buf][k], src + k);
    cp_async_commit();
  };
  if (t_begin < t_end) stage(0, t_begin);
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      stage(buf ^ 1, t + 1);  // the next tile streams in behind this one
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t has landed for every thread
    const float4* tile = ring[buf];
#pragma unroll 1
    for (int s = 0; s < kTile / kSub; ++s) {
      float sub[kQ];
#pragma unroll
      for (int a = 0; a < kQ; ++a) sub[a] = INFINITY;
#pragma unroll kUnroll
      for (int k = 0; k < kSub; ++k) {
        const float4 c = tile[s * kSub + k];
#pragma unroll
        for (int a = 0; a < kQ; ++a) sub[a] = fminf(sub[a], sq_dist(qx[a], qy[a], qz[a], c));
      }
      const int sub_id = t * (kTile / kSub) + s;
#pragma unroll
      for (int a = 0; a < kQ; ++a) {
        if (sub[a] < best[a]) {
          best[a] = sub[a];
          best_sub[a] = sub_id;
        }
      }
    }
    __syncthreads();  // every thread is done with `buf` before it is refilled
  }

#pragma unroll
  for (int a = 0; a < kQ; ++a) {
    const int qi = q0 + a * kThreads;
    if (qi >= m) continue;
    part_d[split * m + qi] = best[a];
    part_i[split * m + qi] = best_sub[a];
  }
}

// One thread per query: the splits in ascending index order with a strict
// <, which gives the first sub-tile at the least distance; then the first
// point of that sub-tile at exactly that distance.
__global__ void __launch_bounds__(kThreads)
nn_argmin_merge(const float* __restrict__ queries, const float4* __restrict__ packed,
                const float* __restrict__ part_d, const int* __restrict__ part_i,
                const uint8_t* __restrict__ active, int m, int splits,
                int* __restrict__ idx, float* __restrict__ sq) {
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  if (qi >= m) return;
  float best = INFINITY;
  int best_sub = -1;
  if (active == nullptr || *active != 0) {
    for (int s = 0; s < splits; ++s) {
      const float d = part_d[s * m + qi];
      if (d < best) {
        best = d;
        best_sub = part_i[s * m + qi];
      }
    }
  }
  int best_i = 0;
  if (best_sub >= 0) {
    const float qx = queries[3 * qi], qy = queries[3 * qi + 1], qz = queries[3 * qi + 2];
    const float4* sub = packed + static_cast<size_t>(best_sub) * kSub;
    float4 c[kSub];  // every load in flight before the first test
#pragma unroll
    for (int k = 0; k < kSub; ++k) c[k] = __ldg(sub + k);
#pragma unroll
    for (int k = kSub - 1; k >= 0; --k) {
      if (sq_dist(qx, qy, qz, c[k]) == best) best_i = best_sub * kSub + k;
    }
  }
  idx[qi] = best_i;
  sq[qi] = best;
}

int tiles_of(int v) { return std::max(1, (v + kTile - 1) / kTile); }

}  // namespace

extern "C" {

// Rows of the packed float4 model scratch for V model points (a whole
// number of tiles, at least one).
int nn_argmin_padded_rows(int v) { return tiles_of(v) * kTile; }

// Number of V splits for M queries and V model points on the current
// device (>= 1).  The pass is issue-bound, so an SM takes as long as the
// tiles of all the blocks it runs: with `splits` splits of `per` tiles,
// the busiest of the card's SMs runs ceil(qblocks * splits / SMs) blocks
// of `per` tiles.  Each split also costs a write and a read of m partials
// in the merge, about m / 1000 thousandths of a block-tile.  Counts that
// leave fewer than kMinBlocksPerSm blocks per SM are skipped (where V
// allows more).  The count of least cost wins, the smallest on a tie.  The partial buffers hold
// splits * m entries each.
int nn_argmin_splits(int m, int v) {
  const int qblocks = std::max(1, (m + kBlockQueries - 1) / kBlockQueries);
  int dev = 0, sms = 1;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    cudaGetLastError();
    sms = 1;
  }
  const int tiles = tiles_of(v);
  int best_splits = 1;
  long best_cost = -1;
  for (int splits = 1; splits <= tiles; ++splits) {
    if (splits < tiles && static_cast<long>(qblocks) * splits <
                              static_cast<long>(kMinBlocksPerSm) * sms) {
      continue;  // too few warps per SM to keep its issue slots busy
    }
    const long per = (tiles + splits - 1) / splits;  // the longest split
    const long rounds = (static_cast<long>(qblocks) * splits + sms - 1) / sms;
    const long cost = rounds * per * 1000 + static_cast<long>(splits) * m / 1000;
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best_splits = splits;
    }
  }
  return best_splits;
}

// Launches the pre-pass, the partial pass and the merge on `stream`;
// returns the cudaError_t of the launches (0 = success).  Device pointers:
// queries (m, 3) float32, model (v, 3) float32, valid (v,) uint8, active one
// uint8 or null, packed nn_argmin_padded_rows(v) float4, part_d / part_i
// splits * m float32 / int32, idx (m,) int32, sq (m,) float32.  m >= 1.
int nn_argmin_launch(const void* queries, const void* model, const void* valid,
                     const void* active, int m, int v, int splits, void* packed,
                     void* part_d, void* part_i, void* idx, void* sq,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* act = static_cast<const uint8_t*>(active);
  const int tiles = tiles_of(v);
  const int padded = tiles * kTile;
  nn_pack_model<<<(padded + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(model), static_cast<const uint8_t*>(valid), act, v,
      padded, static_cast<float4*>(packed));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int qblocks = (m + kBlockQueries - 1) / kBlockQueries;
  nn_argmin_partials<<<dim3(qblocks, splits), kThreads, 0, s>>>(
      static_cast<const float*>(queries), static_cast<const float4*>(packed), act, m,
      tiles, static_cast<float*>(part_d), static_cast<int*>(part_i));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nn_argmin_merge<<<(m + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(queries), static_cast<const float4*>(packed),
      static_cast<const float*>(part_d), static_cast<const int*>(part_i), act, m,
      splits, static_cast<int*>(idx), static_cast<float*>(sq));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
