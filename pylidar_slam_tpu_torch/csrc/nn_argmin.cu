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
// ties (a strict < while the index ascends), and a map with no valid row
// gives +inf and index 0.  M and V take any size.
//
// What bounds it: the surfel champion compares 16,384 queries with 122,880
// map points per pass, 2.0e9 pairs of ~12 instructions each (a shared-memory
// broadcast load, 3 subtractions, 3 products, 2 adds, a compare and two
// selects) and only ~2 MB of traffic, so it is bound by FP32 issue, not by
// memory.  The design is the simple one: one query per thread, its running
// (min, argmin) in registers, model tiles of 256 points staged through
// shared memory (invalid rows and the ragged edge staged as +inf, which
// never wins a strict <).  16,384 queries make only 64 blocks of 256, fewer
// than the card's 132 SMs, so V is also split over a second grid dimension;
// each split writes a partial (d, i), and a second launch merges the splits
// in ascending index order with a strict <, so ties keep the lower index
// and the result does not depend on the split count.  No atomics: two runs
// are bit-identical.  Compiled with --fmad=false so every product and sum
// rounds as the plain PyTorch version's separate kernels do.
//
// `active` (a device bool, or null for always) lets the caller skip a pass
// without a host sync: when it is false every block of the first launch
// returns at once and the merge writes index 0 and +inf.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;
// Enough blocks for about one full wave at 8 resident blocks per SM.
constexpr int kTargetBlocks = 1024;

__global__ void __launch_bounds__(kThreads)
nn_argmin_partials(const float* __restrict__ queries,
                   const float* __restrict__ model,
                   const uint8_t* __restrict__ valid,
                   const uint8_t* __restrict__ active, int m, int v,
                   int per_split, float* __restrict__ part_d,
                   int* __restrict__ part_i) {
  if (active != nullptr && *active == 0) return;
  __shared__ float4 tile[kTile];
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const int split = blockIdx.y;
  const int begin = split * per_split;
  const int end = min(v, begin + per_split);

  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (qi < m) {
    qx = queries[3 * qi];
    qy = queries[3 * qi + 1];
    qz = queries[3 * qi + 2];
  }
  float best = INFINITY;
  int best_i = 0;
  for (int t0 = begin; t0 < end; t0 += kTile) {
    __syncthreads();  // every thread is done with the previous tile
    const int j = t0 + threadIdx.x;
    float4 p = make_float4(INFINITY, INFINITY, INFINITY, 0.0f);
    if (j < end && valid[j]) {
      p = make_float4(model[3 * j], model[3 * j + 1], model[3 * j + 2], 0.0f);
    }
    tile[threadIdx.x] = p;
    __syncthreads();
#pragma unroll 16
    for (int k = 0; k < kTile; ++k) {
      const float4 c = tile[k];
      const float ex = qx - c.x, ey = qy - c.y, ez = qz - c.z;
      const float d = ex * ex + ey * ey + ez * ez;
      if (d < best) {
        best = d;
        best_i = t0 + k;
      }
    }
  }
  if (qi < m) {
    part_d[split * m + qi] = best;
    part_i[split * m + qi] = best_i;
  }
}

// One thread per query: the splits in ascending index order, strict <.
__global__ void __launch_bounds__(kThreads)
nn_argmin_merge(const float* __restrict__ part_d,
                const int* __restrict__ part_i,
                const uint8_t* __restrict__ active, int m, int splits,
                int* __restrict__ idx, float* __restrict__ sq) {
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  if (qi >= m) return;
  float best = INFINITY;
  int best_i = 0;
  if (active == nullptr || *active != 0) {
    for (int s = 0; s < splits; ++s) {
      const float d = part_d[s * m + qi];
      if (d < best) {
        best = d;
        best_i = part_i[s * m + qi];
      }
    }
  }
  idx[qi] = best_i;
  sq[qi] = best;
}

int per_split_of(int v, int splits) {
  const int per = (v + splits - 1) / splits;
  return std::max(kTile, (per + kTile - 1) / kTile * kTile);
}

}  // namespace

extern "C" {

// Number of V splits for M queries and V model points (>= 1); the partial
// buffers hold splits * m entries each.
int nn_argmin_splits(int m, int v) {
  const int qblocks = std::max(1, (m + kThreads - 1) / kThreads);
  const int want = (kTargetBlocks + qblocks - 1) / qblocks;
  const int tiles = std::max(1, (v + kTile - 1) / kTile);
  return std::max(1, std::min(want, tiles));
}

// Launches both passes on `stream`; returns the cudaError_t of the launches
// (0 = success).  Device pointers: queries (m, 3) float32, model (v, 3)
// float32, valid (v,) uint8, active one uint8 or null, part_d / part_i
// splits * m float32 / int32, idx (m,) int32, sq (m,) float32.  m >= 1.
int nn_argmin_launch(const void* queries, const void* model, const void* valid,
                     const void* active, int m, int v, int splits,
                     void* part_d, void* part_i, void* idx, void* sq,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int qblocks = (m + kThreads - 1) / kThreads;
  const uint8_t* act = static_cast<const uint8_t*>(active);
  nn_argmin_partials<<<dim3(qblocks, splits), kThreads, 0, s>>>(
      static_cast<const float*>(queries), static_cast<const float*>(model),
      static_cast<const uint8_t*>(valid), act, m, v, per_split_of(v, splits),
      static_cast<float*>(part_d), static_cast<int*>(part_i));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nn_argmin_merge<<<qblocks, kThreads, 0, s>>>(
      static_cast<const float*>(part_d), static_cast<const int*>(part_i), act,
      m, splits, static_cast<int*>(idx), static_cast<float*>(sq));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
